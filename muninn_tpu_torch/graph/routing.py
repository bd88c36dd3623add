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
HBM3 at a 700 W power limit: the traversal and PageRank costs by
``chip_smoke.py`` phase 17 and ``tools/probes/graph_probe.py`` at 1M nodes
x 10M edges, their ceilings from the host-against-device times of both at
5k to 5M edges; centrality's and Leiden's by ``graph_probe.py
--analytics`` and phase 18, node2vec's by ``tools/probes/node2vec_probe.py``,
as their comments say.
Setting ``MUNINN_HOST_GRAPH_SECONDS`` makes its value every graph
operation's ceiling; node2vec's is ``MUNINN_HOST_N2V_SECONDS``, as in JAX.
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

# centrality and communities (``tools/probes/graph_probe.py --analytics``
# and ``chip_smoke.py`` phase 18, NVIDIA H100 80GB HBM3, 700 W; mean degree
# 5, weights uniform in [0.1, 5.0); one run each). Brandes and closeness
# cost per source x both-direction edge, Leiden per both-direction edge; a
# host cost grows with the graph (cache misses), so each is taken at the
# largest size measured, and each ceiling is that cost times the work where
# the device catches up:
# - Brandes, 64 sources: weighted 63, 69 and 172 ns at 1k, 10k and 100k
#   nodes (285 at 1M x 10M with 4 sources and the host's dedupe);
#   unweighted 6.8, 8.4, 24.6 and 30.9 ns at 1k, 10k, 100k and 1M nodes
COST_BRANDES_SRC_EDGE = 172e-9
COST_BRANDES_SRC_EDGE_UNWEIGHTED = 30.9e-9
# - Brandes' crossover: unweighted 4.4 ms host against 13.0 device at 1k x
#   5k (640k source-edges), 54 against 17.6 at 10k x 50k: near 1.7M; the
#   weighted host already loses at 1k x 5k (40 against 24 ms), which this
#   ceiling puts near 300k source-edges;
HOST_SECONDS_BRANDES = _ceiling(COST_BRANDES_SRC_EDGE_UNWEIGHTED * 1_700_000)
# - closeness, all sources: unweighted 0.62, 0.65 and 0.67 ns at 1k, 3k and
#   10k nodes; weighted 34, 35 and 40 ns at 500, 1k and 2k nodes
COST_CLOSENESS_SRC_EDGE = 40e-9
COST_CLOSENESS_SRC_EDGE_UNWEIGHTED = 0.67e-9
# - closeness' crossover: unweighted 6.2 ms host against 10.6 device at 1k
#   x 5k (10M source-edges), 58.5 against 32.4 at 3k x 15k: near 22M; the
#   weighted host already loses at 500 x 2.5k (86 against 9.6 ms);
HOST_SECONDS_CLOSENESS = _ceiling(
    COST_CLOSENESS_SRC_EDGE_UNWEIGHTED * 22_000_000)
# - Leiden, whole: 0.36, 0.66, 1.40 and 1.84 us a both-direction edge at
#   1k, 10k, 100k and 1M nodes (x 5 edges a node), 1.94 at 1M x 10M
COST_LEIDEN_EDGE = 1.94e-6
# - Leiden's crossover: 66 ms host against 370 device at 10k x 50k (100k
#   both-direction edges), 1.40 s against 0.44 at 100k x 500k: near 320k.
HOST_SECONDS_LEIDEN = _ceiling(COST_LEIDEN_EDGE * 320_000)

# node2vec (``tools/probes/node2vec_probe.py``, NVIDIA H100 80GB HBM3,
# 700 W, one run; ``chip_smoke.py`` phase 19 repeats two points) at the
# node2vec treatment's settings (Erdos-Renyi at mean degree 5, dim 32, 2
# walks of 20 a node, 1 epoch, walker batches of 1,024; 76,800 units a
# node): the host trainer's cost per (pair x dim) unit of
# ``models.node2vec.host_estimate_s`` was 0.66, 1.30, 1.00, 0.75, 1.07,
# 1.38, 1.34 and 1.70 ns at 500, 1k, 2k, 4k, 8k, 16k, 32k and 64k nodes,
# taken at the largest
COST_SGNS_PAIR_DIM = 1.70e-9
# - the crossover, host against device ms: 25 against 78 at 500 nodes, 100
#   against 78 at 1k, 153 against 125 at 2k, 230 against 239 at 4k, 654
#   against 528 at 8k, 8,361 against 4,331 at 64k: within 25% of each
#   other from 1k to 4k, the device ahead from 8k. The ceiling sits at 4k
#   nodes, keeping the treatment's own points (up to 2k, the reference's
#   envelope) on the host engine, whose runs repeat to the bit.
#   ``MUNINN_HOST_N2V_SECONDS`` overrides it, as in JAX.
HOST_N2V_SECONDS = float(os.environ.get(
    "MUNINN_HOST_N2V_SECONDS", COST_SGNS_PAIR_DIM * 76_800 * 4_000))


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
