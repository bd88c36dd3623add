"""Where the time of the port's graph analytics goes, on one CUDA card, and
where the host engine and the device fixpoints cross over.

    python3 tools/probes/graph_probe.py [--out PATH] [--analytics]

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

With ``--analytics``, instead the rest of the graph layer (phase 18):

- host engine against device per analytic and size, the crossovers and
  per-unit host costs ``graph/routing.py`` takes: 64-source betweenness
  (weighted and not) and Leiden from 1k x 5k to 1M x 5M edges, all-source
  closeness (unweighted to 10k x 50k, weighted to 2k x 10k), at mean
  degree 5 with weights uniform in [0.1, 5.0); the host engine is not run
  where its estimate passes ``HOST_LIMIT_S``;
- ``chip_smoke.graph_analytics_phase`` (phase 18 at BASELINE.json
  configs[4]);
- under ``torch.profiler``, at phase 18's weighted A: 64-source
  betweenness, Leiden, the selector's ``3+0+3`` and a ``GraphCache``
  incremental rebuild of 5,000 inserts and 5,000 deletes.

With ``--out``, writes the whole record there as JSON. Every line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUTE_SIZES = ((1_000, 5_000), (10_000, 50_000), (50_000, 250_000),
               (200_000, 1_000_000), (1_000_000, 5_000_000))
# the analytics' calibration sizes, mean degree 5, and the host engine's
# time limit per call by the routing's current estimate
BRANDES_SIZES = ((1_000, 5_000), (10_000, 50_000), (100_000, 500_000),
                 (1_000_000, 5_000_000))
CLOSENESS_SIZES = {False: ((1_000, 5_000), (3_000, 15_000), (10_000, 50_000)),
                   True: ((500, 2_500), (1_000, 5_000), (2_000, 10_000))}
LEIDEN_SIZES = BRANDES_SIZES
HOST_LIMIT_S = 30.0


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


def calibrate(op: str, n: int, e: int, weighted: bool, card: str) -> dict:
    """Host engine against device for one analytic on a weighted
    ``from_edges`` graph of ``n`` nodes and ``e`` edges (mean degree 5) on
    the card: the median of 3 calls after a warm call where the host's
    estimate is under a second, else one call after a warm device call; the
    host's per-unit cost (seconds per source x both-direction edge, or per
    both-direction edge for Leiden)."""
    from muninn_tpu_torch.graph import Graph
    from muninn_tpu_torch.graph import centrality as ctr
    from muninn_tpu_torch.graph import routing

    src, dst, w = (t.cpu().numpy()
                   for t in cs.weighted_device_edges(n, e, seed=5))
    g = Graph.from_edges(src, dst, w)
    n = g.num_nodes
    call, units, estimate = {
        "betweenness": (
            lambda b: g.betweenness(weighted=weighted,
                                    sample_sources=cs.BC_SOURCES,
                                    backend=b, as_array=True),
            min(n, cs.BC_SOURCES) * 2 * e,
            ctr.brandes_host_seconds(min(n, cs.BC_SOURCES), 2 * e, weighted)),
        "closeness": (
            lambda b: g.closeness(weighted=weighted, backend=b,
                                  as_array=True),
            n * 2 * e, ctr.closeness_host_seconds(n, 2 * e, weighted)),
        "leiden": (
            lambda b: g.leiden(seed=0, backend=b, as_array=True),
            2 * e, routing.COST_LEIDEN_EDGE * 2 * e),
    }[op]
    r = {"op": op, "nodes": n, "edges": e, "weighted": weighted,
         "units": units, "host_estimate_s": estimate}
    reps = 3 if estimate < 1.0 else 1
    for backend in ("device", "host"):
        if backend == "host" and estimate > HOST_LIMIT_S:
            r["host_s"] = None
            continue
        if backend == "device" or reps > 1:
            call(backend)
        r[f"{backend}_s"] = statistics.median(
            cs.timed_s(lambda: call(backend))[1] for _ in range(reps))
    if r["host_s"] is not None:
        r["host_cost_per_unit_s"] = r["host_s"] / units
    print(f"calibrate {op} weighted={weighted} {n:,} x {e:,} ({card}):"
          f" host {r['host_s']} s, device {r['device_s']:.6f} s,"
          f" host per unit {r.get('host_cost_per_unit_s')}", flush=True)
    return r


def analytics(card: str) -> dict:
    """The ``--analytics`` record (see the module docstring)."""
    from muninn_tpu_torch import GraphCache, select
    from muninn_tpu_torch.graph import Graph

    out: dict = {"card": card, "calibration": []}
    for weighted in (True, False):
        for n, e in BRANDES_SIZES:
            out["calibration"].append(
                calibrate("betweenness", n, e, weighted, card))
        for n, e in CLOSENESS_SIZES[weighted]:
            out["calibration"].append(
                calibrate("closeness", n, e, weighted, card))
    for n, e in LEIDEN_SIZES:
        out["calibration"].append(calibrate("leiden", n, e, True, card))

    t0 = time.perf_counter()
    out["phase18"] = cs.graph_analytics_phase()
    print(f"phase 18 ({card}): {json.dumps(out['phase18'])}"
          f" [{time.perf_counter() - t0:.1f} s]", flush=True)

    n = cs.GRAPH_SIZES[0][1]
    e = n * cs.GRAPH_DEGREE
    src, dst, w = cs.weighted_device_edges(n, e, seed=18)
    g = Graph.from_device_edges(src, dst, num_nodes=n, weights=w)
    hs, hd, hw = (t.cpu().numpy() for t in (src, dst, w))
    del src, dst, w
    gc = GraphCache.from_edges(hs, hd, hw)
    cg = gc.graph()
    cg.csr("forward"), cg.csr("reverse")
    r = np.random.default_rng(18)
    ids = gc.nodes.ids

    def churn():
        a, b = r.integers(0, len(ids), (2, cs.CACHE_CHURN))
        gc.add_edges([ids[i] for i in a], [ids[i] for i in b])
        kill = r.choice(gc.num_edges, cs.CACHE_CHURN, replace=False)
        gc.remove_edges([ids[i] for i in gc._src[kill]],
                        [ids[i] for i in gc._dst[kill]])
        gc.incremental_rebuild()

    ops = {
        "betweenness": lambda: g.betweenness(
            weighted=True, sample_sources=cs.BC_SOURCES, seed=0,
            backend="device", as_array=True),
        "leiden": lambda: g.leiden(seed=0, backend="device", as_array=True),
        "select": lambda: select(g, cs.SELECTOR),
        "incremental_rebuild": churn,
    }
    prof = out["profile_A"] = {}
    for op, fn in ops.items():
        fn()
        res = prof[op] = profile_op(fn)
        print(f"A {op} ({card}): wall {res['wall_ms']:.3f} ms, busy"
              f" {res['busy_ms']:.3f} ms, top {res['top_kernels_ms']}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the record here as JSON")
    ap.add_argument("--analytics", action="store_true",
                    help="the rest of the graph layer (phase 18) instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 2
    from muninn_tpu_torch.graph import Graph

    card = cs.card_line()
    print(card, flush=True)
    if args.analytics:
        out = analytics(card)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(out, indent=1))
        return 0
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
