"""Host-vs-device routing for graph analytics.

The port's copy of ``muninn_tpu.graph.routing``. ``backend='auto'`` sends
each operation to whichever engine is faster at the workload's size: the
host engine (single-thread C++, ``native/src/muninn_graph.cpp``) or the
device fixpoints. Callers pass the operation's estimated HOST time in
seconds (a per-unit host cost below times the work) and the operation's
ceiling: the host takes the operation while its estimate is at most the
ceiling. On small graphs the device's fixed cost (a dozen launches and one
host read a sweep, about 2-3 ms an operation; about 9 ms for PageRank's
20 iterations) loses to the host's whole run; past the crossover the
device wins by one to three orders of magnitude.

Every constant is the H100 machine's own, measured on an NVIDIA H100 80GB
HBM3 at a 700 W power limit: the per-unit host costs by ``chip_smoke.py``
phase 17 and ``tools/probes/graph_probe.py`` at 1M nodes x 10M edges, the
ceilings from the host-against-device times of both at 5k to 5M edges.
Setting ``MUNINN_HOST_GRAPH_SECONDS`` makes its value every operation's
ceiling.
"""

from __future__ import annotations

import os

from muninn_tpu_torch import native

_ENV_CEILING = os.environ.get("MUNINN_HOST_GRAPH_SECONDS")


def _ceiling(measured: float) -> float:
    return measured if _ENV_CEILING is None else float(_ENV_CEILING)


# per-unit host costs (seconds), one thread, at 1M nodes x 10M edges: the
# median of three runs on the NVIDIA H100 80GB HBM3 machine (700 W), whose
# host times moved by up to 2x between runs (BFS 0.132-0.208 s, components
# 0.087-0.170 s, 20 PageRank iterations 1.54-3.34 s, Dijkstra with parents
# 1.26-1.98 s)
COST_BFS_EDGE = 20.5e-9
COST_COMPONENTS_EDGE = 16.8e-9
COST_PAGERANK_EDGE_ITER = 11.8e-9
COST_SSSP_EDGE = 185e-9

# ceilings: each operation's host estimate at the edge count where the
# device catches up (host ms against device ms, NVIDIA H100 80GB HBM3,
# 700 W, at mean degree 5):
# - BFS: 0.79-1.10 against 1.89-3.08 at 50k edges, 6.90 against 4.31 at
#   250k: near 120k edges;
HOST_SECONDS_BFS = _ceiling(COST_BFS_EDGE * 120_000)
# - components: 0.41-0.68 against 1.70-2.30 at 50k, a tie (3.97, 3.99) at
#   250k, 13.9 against 6.1 at 1M: near 250k;
HOST_SECONDS_COMPONENTS = _ceiling(COST_COMPONENTS_EDGE * 250_000)
# - PageRank, 20 iterations: 5.72-6.42 against 8.87-9.51 at 50k, 48.3
#   against 14.4 at 250k: near 70k;
HOST_SECONDS_PAGERANK = _ceiling(COST_PAGERANK_EDGE_ITER * 20 * 70_000)
# - shortest path: 0.27 against 2.03 at 5k, 3.10-3.30 against 2.25-2.44
#   at 50k: near 35k. The ceiling sits at 55k instead, keeping the
#   reference's largest published graph (10k nodes, 50k edges) on the
#   host, within 1 ms of the device;
HOST_SECONDS_SSSP = _ceiling(COST_SSSP_EDGE * 55_000)
# - an operation without a crossover of its own: BFS's.
HOST_GRAPH_SECONDS = HOST_SECONDS_BFS


def use_host(backend: str, host_seconds: float,
             ceiling: float | None = None) -> bool:
    """True when `backend` + estimated `host_seconds` route to the
    native host kernels. backend: 'auto' | 'host' | 'device'.
    ``ceiling`` is the operation's crossover (``HOST_GRAPH_SECONDS`` when
    None)."""
    if backend == "host":
        if not native.graph_available():
            raise RuntimeError("native graph kernels unavailable")
        return True
    if backend == "device":
        return False
    if backend != "auto":
        raise ValueError(f"backend must be auto|host|device, got {backend!r}")
    lim = HOST_GRAPH_SECONDS if ceiling is None else ceiling
    return host_seconds <= lim and native.graph_available()
