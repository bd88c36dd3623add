"""Traversal fixpoints: BFS, multi-source distances, components, paths.

The port's copy of ``muninn_tpu.graph.traversal`` (the reference's
per-step SQL neighbour lookups and hash-set visited tracking,
``src/graph_tvf.c:230-416,472-753,1204-1360``): frontier expansion is an
edge-parallel reduction over the CSR arrays, the visited set is the
distance array itself, and weighted paths use synchronous Bellman-Ford
relaxation instead of a lazy-deletion Dijkstra heap (same results).

All fixpoints consume a **pull CSR** — in-edges sorted by target node:
``roff [V+1]`` offsets, ``esrc [E_pad]`` source endpoint per edge
(pads = V), optional ``w``. Per-node reductions are segment ops
(``ops.segments``): a ``scatter_reduce_`` min into each row's slot, over
the ``offsets[V]`` edges the rows hold (the padding sliced off). For
direction ``d`` the pull CSR is the OPPOSITE direction's CSR (its rows are
the pull targets, its ``dst`` the source endpoints).

Each fixpoint runs one sweep per step on the tensors' device and reads one
host boolean per sweep to decide whether to go on, through
``tracing.host_read``; ``HOST_SYNCS`` (the registry's dict) counts those
reads per fixpoint (``centrality``'s sigma and delta sweeps and
``community``'s local-moving sweeps count theirs here too). (The JAX
package splits its loops into blocks of a few sweeps per dispatch, and
edges into chunks above 2**25, for limits of its TPU worker; the results
are the same.)
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.ops.segments import seg_ids, seg_min_by_ids
from muninn_tpu_torch.tracing import (  # noqa: F401
    HOST_SYNCS,
    host_read,
    reset_host_syncs,
)

INT_INF = 2**30


def bfs_pull(
    roff: torch.Tensor,     # [V+1] pull-CSR offsets
    esrc: torch.Tensor,     # [E_pad] in-edge source endpoints (pads = V)
    start: int,
    num_nodes: int,
    max_depth: int,
    n_passes: int = 24,     # the JAX contract's; unused (exact segment min)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-source BFS. Returns (depth int32[V] — INT_INF if unreached,
    parent int32[V] — -1 for root/unreached).

    Parent choice is the minimum-index active predecessor, which is
    deterministic (the reference's parent is SQL-iteration-order
    dependent; determinism here is a feature, not a parity break).
    """
    ids = seg_ids(roff)
    es = esrc[:ids.shape[0]]  # the rows' edges, padding sliced off
    depth = torch.full((num_nodes,), INT_INF, dtype=torch.int32,
                       device=roff.device)
    depth[int(start)] = 0
    parent = torch.full_like(depth, -1)
    d = 0
    while d < max_depth:
        active = depth.index_select(0, es) == d                 # [E]
        cand = torch.where(active, es, INT_INF)
        best_pred = seg_min_by_ids(cand, ids, num_nodes, INT_INF)
        reach = (best_pred < INT_INF) & (depth >= INT_INF)
        depth = torch.where(reach, d + 1, depth)
        parent = torch.where(reach, best_pred, parent)
        d += 1
        if not host_read("bfs", reach.any()):
            break
    return depth, parent


def seeded_bfs_depths_pull(
    roff: torch.Tensor,
    esrc: torch.Tensor,
    init: torch.Tensor,     # int32 [V]; INT_INF = not a seed
    num_nodes: int,
    max_iters: int = 0,
    n_passes: int = 24,
) -> torch.Tensor:
    """Multi-source BFS from *seeded* integer depths: returns
    ``d[u] = min_v (init[v] + hops(v, u))`` over all seeds v. One device
    fixpoint replaces a per-seed BFS launch loop — used by the selector's
    closure atoms where the reference walks each descendant's ancestor set
    separately (``src/graph_selector_eval.c:153-232``)."""
    if max_iters <= 0:
        max_iters = num_nodes
    ids = seg_ids(roff)
    es = esrc[:ids.shape[0]]  # the rows' edges, padding sliced off
    dist = init.to(torch.int32)
    for _ in range(max_iters):
        ds = dist.index_select(0, es)
        relax = torch.where(ds < INT_INF, ds + 1, INT_INF)       # [E]
        new = torch.minimum(
            dist, seg_min_by_ids(relax, ids, num_nodes, INT_INF))
        changed = (new < dist).any()
        dist = new
        if not host_read("seeded_bfs", changed):
            break
    return dist


def multi_source_distances_pull(
    roff: torch.Tensor,
    esrc: torch.Tensor,
    w: torch.Tensor,        # [E_pad] f32
    sources: torch.Tensor,  # [S] int32
    num_nodes: int,
    max_iters: int = 0,
    n_passes: int = 24,
) -> torch.Tensor:
    """Batched SSSP distances [S, V] via synchronous Bellman-Ford
    (non-negative weights), in ``w``'s dtype. Replaces the reference's
    per-source BFS/Dijkstra engines (``src/graph_centrality.c:261-379``)."""
    if max_iters <= 0:
        max_iters = num_nodes
    ids = seg_ids(roff)
    es = esrc[:ids.shape[0]]  # the rows' edges, padding sliced off
    sources = torch.as_tensor(sources, device=roff.device).long()
    dist = torch.full((sources.shape[0], num_nodes), torch.inf,
                      dtype=w.dtype, device=roff.device)
    dist[torch.arange(sources.shape[0], device=roff.device), sources] = 0.0
    for _ in range(max_iters):
        relax = dist.index_select(1, es) + w[None, :es.shape[0]]  # [S, E]
        new = torch.minimum(
            dist, seg_min_by_ids(relax, ids, num_nodes, torch.inf))
        changed = (new < dist).any()
        dist = new
        if not host_read("multi_source", changed):
            break
    return dist


def _label_sweep(comp: torch.Tensor, nbr_min) -> tuple[torch.Tensor, torch.Tensor]:
    """One min-label sweep (``nbr_min(comp)``: each node's smallest
    neighbour label) and two pointer jumps; returns (labels, changed)."""
    new = torch.minimum(comp, nbr_min(comp))
    # pointer jumping: follow labels two hops
    new = torch.minimum(new, new.index_select(0, new))
    new = torch.minimum(new, new.index_select(0, new))
    return new, (new < comp).any()


def _nbr_min_fn(offsets: torch.Tensor, dst: torch.Tensor, num_nodes: int):
    """comp -> each node's smallest label over its CSR row."""
    ids = seg_ids(offsets)
    ds = dst[:ids.shape[0]]

    def nbr_min(comp):
        return seg_min_by_ids(comp.index_select(0, ds), ids, num_nodes,
                              INT_INF)

    return nbr_min


def connected_components_pull(
    offsets: torch.Tensor,  # [V+1] 'both'-CSR offsets
    dst: torch.Tensor,      # [E_pad] neighbour per edge (pads = V)
    num_nodes: int,
    n_passes: int = 24,
) -> torch.Tensor:
    """Connected components by min-label propagation + pointer jumping
    (converges in ~O(log V) sweeps; the reference uses union-find with
    path halving, ``src/graph_tvf.c:1204-1360``). Pass the 'both'
    direction CSR (undirected: its own rows ARE each node's neighbourhood).
    Labels are each component's minimum node index."""
    nbr_min = _nbr_min_fn(offsets, dst, num_nodes)
    comp = torch.arange(num_nodes, dtype=torch.int32, device=offsets.device)
    while True:
        comp, changed = _label_sweep(comp, nbr_min)
        if not host_read("components", changed):
            return comp


def connected_components_2csr(
    foff: torch.Tensor,     # [V+1] forward CSR offsets
    fdst: torch.Tensor,     # [E_pad] out-neighbours (pads = V)
    roff: torch.Tensor,     # [V+1] reverse CSR offsets
    rdst: torch.Tensor,     # [E_pad] in-neighbours (pads = V)
    num_nodes: int,
    n_passes_f: int = 24,
    n_passes_r: int = 24,
) -> torch.Tensor:
    """:func:`connected_components_pull` over the fwd+rev CSR pair instead
    of the merged 'both' CSR: each node's undirected neighbourhood minimum
    is ``min(out-row min, in-row min)`` — the same fixpoint, with half the
    resident edge memory of the merged CSR."""
    fwd_min = _nbr_min_fn(foff, fdst, num_nodes)
    rev_min = _nbr_min_fn(roff, rdst, num_nodes)
    comp = torch.arange(num_nodes, dtype=torch.int32, device=foff.device)
    while True:
        comp, changed = _label_sweep(
            comp, lambda c: torch.minimum(fwd_min(c), rev_min(c)))
        if not host_read("components", changed):
            return comp


def sssp_with_parents_pull(
    roff: torch.Tensor,
    esrc: torch.Tensor,
    w: torch.Tensor,
    start: int,
    num_nodes: int,
    max_iters: int = 0,
    n_passes: int = 24,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-source shortest path with parent pointers (weighted,
    non-negative). Bellman-Ford; parents chosen as the min-index
    predecessor achieving the optimal distance."""
    if max_iters <= 0:
        max_iters = num_nodes
    start = int(start)
    ids = seg_ids(roff)
    es = esrc[:ids.shape[0]]  # the rows' edges, padding sliced off
    w = w[:es.shape[0]]
    dist = torch.full((num_nodes,), torch.inf, device=roff.device)
    dist[start] = 0.0
    for _ in range(max_iters):
        relax = dist.index_select(0, es) + w
        new = torch.minimum(
            dist, seg_min_by_ids(relax, ids, num_nodes, torch.inf))
        changed = (new < dist).any()
        dist = new
        if not host_read("sssp", changed):
            break
    # tight edges: dist[esrc] + w == dist[v] (epsilon like the reference's
    # tie detection, src/graph_centrality.c:212-214); v = each edge's pull
    # target = its row's node id
    dv = dist.index_select(0, ids)
    tight = (dist.index_select(0, es) + w - dv).abs() <= (
        1e-9 * torch.clamp(dv.abs(), min=1.0))
    pred = torch.where(tight & torch.isfinite(dv), es, INT_INF)
    parent = seg_min_by_ids(pred, ids, num_nodes, INT_INF)
    not_start = torch.arange(num_nodes, device=roff.device) != start
    parent = torch.where((parent < INT_INF) & not_start, parent, -1)
    return dist, parent


def dfs_host(
    offsets: np.ndarray,
    targets: np.ndarray,
    start: int,
    max_depth: int,
) -> list[tuple[int, int, int]]:
    """Depth-first traversal order (node, depth, parent) on host.

    DFS order is inherently sequential (a stack); it is an enumeration,
    not a compute kernel, so it stays on host over the CSR arrays —
    mirroring the reference's output contract
    (``src/graph_tvf.c:230-416``) with neighbour ties broken by index
    order.
    """
    visited = set()
    out: list[tuple[int, int, int]] = []
    stack = [(int(start), 0, -1)]
    while stack:
        node, depth, parent = stack.pop()
        if node in visited:
            continue
        visited.add(node)
        out.append((node, depth, parent))
        if depth >= max_depth:
            continue
        nbrs = targets[offsets[node] : offsets[node + 1]]
        # push reversed so lowest-index neighbour is visited first
        for nxt in nbrs[::-1]:
            if int(nxt) not in visited:
                stack.append((int(nxt), depth + 1, node))
    return out


def reconstruct_path(parent: np.ndarray, start: int, end: int) -> list[int]:
    """Walk parent pointers end -> start. Returns [] if unreachable."""
    if start == end:
        return [start]
    path = [end]
    cur = end
    for _ in range(len(parent) + 1):
        cur = int(parent[cur])
        if cur < 0:
            return []
        path.append(cur)
        if cur == start:
            return path[::-1]
    return []
