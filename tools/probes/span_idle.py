"""Device-idle time a request by the port's own spans, for one traced run of
a benchmark cell.

    python3 tools/probes/span_idle.py --workload c100k-384.hnsw --seed 7 \
        [--seconds 30] [--out span_idle.jsonl]

from the root of a checkout, on the H100 machine. The run is
``python3 -m portbench.run --trace 1``'s (same set-up, window under
``torch.profiler``, judge); the probe prints its result line with three
keys more: ``idle_ms`` (device-idle ms a request by the innermost
``muninn_tpu_torch.tracing`` span the host was in; ``request`` is the rest
of the benchmark's request span, ``harness`` the time between requests),
``covered`` (the share of the device-idle time inside ``index.search`` and
inside ``index.search_device`` that a child span holds) and ``spans`` (the
count of each span a request).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import program  # noqa: E402
from portbench.run import Bench, run_cell  # noqa: E402


def covered(idle: dict, total: dict, name: str) -> float | None:
    """The share of the idle time inside ``name`` spans that lies in their
    children."""
    return 1.0 - idle[name] / total[name] if total.get(name) else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    run = run_cell(Bench(), args.workload, args.seed, args.seconds, True, t0=T0)
    line = run.line(True)
    spans = program.placed(run)
    if spans is None:
        print("span_idle: the program's spans could not be placed", file=sys.stderr)
        return 1
    n = len(run.trace.requests)
    idle = program.idle_by_span(run, spans)
    busy = run.trace.busy
    total: dict[str, float] = {}
    counts: dict[str, int] = {}
    for s in spans:
        idle_in = (s.end - s.start) - busy.within(s.start, s.end)
        total[s.name] = total.get(s.name, 0.0) + idle_in
        counts[s.name] = counts.get(s.name, 0) + 1
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    out = {"workload": args.workload, "seed": args.seed, **line,
           "idle_ms": {k: v / n / 1e3 for k, v in ranked},
           "covered": {k: covered(idle, total, k)
                       for k in ("index.search", "index.search_device")},
           "spans": {k: v / n for k, v in counts.items()}}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
