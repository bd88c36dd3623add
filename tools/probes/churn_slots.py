"""Slots, packed table and beam engine of the port under the benchmark's
steady churn, for one run of a cell whose engine writes.

    python3 tools/probes/churn_slots.py --seed 7 [--workload c100k-384.churn]
        [--seconds 30] [--trace] [--root DIR] [--out FILE]

on the H100 machine. ``--root`` is the checkout whose ``portbench/`` and
port are imported (default: this one), so that another commit's port can be
run with this checkout's benchmark files laid over it. The run is
``python3 -m portbench.run --trace 0``'s (set-up, window, judge). The probe
prints its result line with one key more, ``probe``: the store's
``capacity``, ``high_watermark`` and live rows and whether the packed
neighbour table was there, before and after the window; the window's beam
steps by engine (``kernel`` or ``eager``, counted at each call of
``ops.beam_step.step_engine`` times the steps of that beam);
``beam_step`` launches; and the packed rows re-gathered a request. With
``--trace`` the window runs under ``torch.profiler`` (``--trace 1``'s line)
and ``probe`` also holds ``split``: the device-busy and device-idle ms a
request inside the program's ``index.delete`` (and apart: its
``hnsw.repair`` spans and the rest of the delete), ``index.insert`` and
``index.search`` spans, and in the rest of the window.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()


_TOP = ("index.delete", "index.insert", "index.search")  # requests of their own


def split(run) -> dict:
    """Device-busy and device-idle ms a request inside the window's write
    and search spans, the delete's ``hnsw.repair`` and the rest of the
    delete apart, and outside them."""
    from portbench.program_writes import window_spans

    busy, (lo, hi) = run.trace.busy, run.trace.window
    spans = window_spans(run, "index.search") or []
    base_ns = None
    out = {}
    for name in (*_TOP, "hnsw.repair"):
        found = window_spans(run, name) or []
        if found and base_ns is None:
            base_ns = _base_ns(run, spans)
        b = i = 0.0
        for s in found:
            a, e = (s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3
            b += busy.within(a, e)
            i += (e - a) - busy.within(a, e)
        out[name] = {"busy_ms": b, "idle_ms": i}
    n = len(run.trace.requests)
    rest_busy = run.trace.busy_us - sum(out[k]["busy_ms"] for k in _TOP)
    rest_idle = (hi - lo) - run.trace.busy_us - sum(out[k]["idle_ms"] for k in _TOP)
    # hnsw.repair lies inside index.delete: the delete's other work apart
    out["index.delete.other"] = {m: out["index.delete"][m] - out["hnsw.repair"][m]
                                 for m in ("busy_ms", "idle_ms")}
    out["rest"] = {"busy_ms": rest_busy, "idle_ms": rest_idle}
    return {k: {m: u / n / 1e3 for m, u in v.items()} for k, v in out.items()}


def _base_ns(run, searches) -> float:
    """The unix ns of the trace's clock's zero, from a placed search."""
    from portbench.program import placed

    first = next(s for s in placed(run) if s.name == "index.search")
    raw = next(s for s in searches if s.id == first.id)
    return raw.start_ns - first.start * 1e3


def probe(run, seconds: float, t0: float, trace: bool = False) -> dict:
    """Set up ``run``, measure, free, judge; its result line with
    ``probe``."""
    from muninn_tpu_torch import tracing
    from muninn_tpu_torch.index import hnsw as hnsw_mod

    steps = {"kernel": 0, "eager": 0, "beams": 0, "last": None}
    engine_of, host_read = hnsw_mod.step_engine, hnsw_mod.host_read

    def counted(*a, **kw):
        steps["beams"] += 1
        steps["last"] = engine_of(*a, **kw)
        return steps["last"]

    def read(site, t):
        out = host_read(site, t)
        if site == "hnsw_beam" and out:
            steps[steps["last"]] += 1  # one step entered on that engine
        return out
    hnsw_mod.step_engine, hnsw_mod.host_read = counted, read
    repacked = {"rows": 0}
    repack = getattr(hnsw_mod.HnswIndex, "_repack_rows", None)
    if repack is not None:
        def counted_repack(self, rows):
            repacked["rows"] += int(rows.shape[0])
            return repack(self, rows)
        hnsw_mod.HnswIndex._repack_rows = counted_repack

    def store() -> dict:
        st, ix = run.index.store, run.index
        return {"capacity": st.capacity, "high_watermark": st.high_watermark,
                "live": len(st), "packed": ix._packed is not None}

    run.setup(t0)
    before = store()
    steps.update(kernel=0, eager=0, beams=0)
    repacked["rows"] = 0
    launches = tracing.LAUNCHES.get("beam_step", 0)
    run.window(seconds, trace)
    out = {"before": before, "after": store(),
           "steps": {k: steps[k] for k in ("kernel", "eager", "beams")},
           "beam_step_launches": tracing.LAUNCHES.get("beam_step", 0) - launches,
           "repacked_rows_per_req": (repacked["rows"] / run.attempted
                                     if repack is not None else None)}
    if trace:
        out["split"] = split(run)
    run.close()
    run.judge()
    line = run.line(trace)
    line.pop("breakdown", None)
    line["probe"] = out
    line["states"] = run.states
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="c100k-384.churn")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from portbench.run import Bench, Run

    bench = Bench(root)
    line = probe(Run(bench, bench.cell(args.workload), args.seed, "cuda"),
                 args.seconds, T0, args.trace)
    line["root"] = str(root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    line["card"] = smi.stdout.strip()
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
