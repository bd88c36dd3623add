"""Where the time of the port's graph analytics goes, on one CUDA card, and
where the host engine and the device fixpoints cross over.

    python3 tools/probes/graph_probe.py [--out PATH]

Uses ``chip_smoke.py``'s phase 17 pieces:

- ``graph_size`` at graph_scale's sizes A (1M nodes, 10M edges) and B (10M
  nodes, 100M edges): build, PageRank, components, BFS (and at A a
  shortest path) on the card, each held against the host C++ engine;
- per operation at A and at B, under ``torch.profiler``: the device's busy
  ms, the host wall ms of the same call and the five kernels with the most
  device time (the idle share is 1 - busy / wall);
- ``graph_route_times`` (host engine against device per operation, median
  of 3 after a warm call, and ``auto``'s pick) at 5k, 50k, 250k, 1M and 5M
  edges (mean degree 5), the crossover the routing constants come from.

With ``--out``, writes the whole record there as JSON. Every line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUTE_SIZES = ((1_000, 5_000), (10_000, 50_000), (50_000, 250_000),
               (200_000, 1_000_000), (1_000_000, 5_000_000))


def profile_op(fn) -> dict:
    """Busy device ms, host wall ms and the top kernels of one call."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    _, wall = cs.timed_s(fn)
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    kind = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == kind)
    busy, last = 0.0, float("-inf")
    for s, t in spans:
        busy += max(0.0, t - max(s, last))
        last = max(last, t)
    top = sorted(((e.key, e.device_time_total / 1e3)
                  for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "top_kernels_ms": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the record here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 2
    from muninn_tpu_torch.graph import Graph

    card = cs.card_line()
    print(card, flush=True)
    out: dict = {"card": card}
    cs.graph_size(cs.GRAPH_ENVELOPE[0], seed=1, host_pagerank=True)  # warm-up
    for name, n in cs.GRAPH_SIZES:
        t0 = time.perf_counter()
        out[name] = cs.graph_size(n, seed=17 + n, host_pagerank=name == "A")
        print(f"{name} ({card}): {json.dumps(out[name])}"
              f" [{time.perf_counter() - t0:.1f} s]", flush=True)

    for name, n in cs.GRAPH_SIZES:
        src, dst = cs.device_edges(n, n * cs.GRAPH_DEGREE, seed=17 + n)
        g = Graph.from_device_edges(src, dst, num_nodes=n)
        g.csr("forward"), g.csr("reverse")
        t = int(dst[-1])
        ops = {
            "pagerank": lambda: g.pagerank(backend="device", as_array=True),
            "components": lambda: g.connected_components(backend="device",
                                                         as_array=True),
            "bfs": lambda: g.bfs(0, backend="device", as_array=True),
            "shortest_path": lambda: g.shortest_path(0, t, weighted=False,
                                                     backend="device"),
            "csr_build": lambda: Graph.from_device_edges(
                src, dst, num_nodes=n).csr("forward"),
        }
        prof = out[f"profile_{name}"] = {}
        for op, fn in ops.items():
            fn()
            r = prof[op] = profile_op(fn)
            print(f"{name} {op} ({card}): wall {r['wall_ms']:.3f} ms, busy"
                  f" {r['busy_ms']:.3f} ms, top {r['top_kernels_ms']}",
                  flush=True)
        del g, src, dst, ops
        torch.cuda.empty_cache()

    out["route"] = {}
    for n, e in ROUTE_SIZES:
        r = out["route"][f"{n}x{e}"] = cs.graph_route_times(n, e, seed=11)
        for op, v in r.items():
            print(f"route {n:,} x {e:,} {op} ({card}): host"
                  f" {v['host_s'] * 1e3:.3f} ms, device"
                  f" {v['device_s'] * 1e3:.3f} ms, auto ->"
                  f" {'host' if v['auto_host'] else 'device'}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
