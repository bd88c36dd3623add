"""Centrality: degree, closeness, Brandes node/edge betweenness.

The port's copy of ``muninn_tpu.graph.centrality`` (a re-design of the
reference's ``src/graph_centrality.c``, which runs one sequential SSSP per
source with predecessor lists and a backward stack). Sources are *batched*:
distances by synchronous Bellman-Ford [S, V], path counts (sigma) and
dependencies (delta) as Jacobi fixpoints over the tight-edge DAG, all
edge-parallel segment ops:

    sigma[v] = sum_{tight (u,v)} sigma[u],  sigma[source] = 1
    delta[u] = sum_{tight (u,v)} sigma[u]/sigma[v] * (1 + delta[v])

Each Jacobi sweep advances one DAG level, so both converge in
(shortest-path-depth) sweeps, the batched analogue of the reference's
ordered stack replay (``src/graph_centrality.c:393-512``). Each sweep is
one step of a Python loop over torch ops with one host read of its "go on"
flag (``traversal.HOST_SYNCS["brandes"]``).

Distances are float64 here, where JAX's are float32: a float64 sum of
float32 weights is the exact path length, as in the host engine's
all-double Dijkstra, so the tight-edge DAG (an exact tie test) is the host
engine's. In float32, two paths whose lengths differ by less than a
rounding merge or swap: at 20k nodes x 200k weighted edges that moved 10
nodes' counts by one path against the host engine, which sampling scales
by N/S. Sigma and delta stay float32, as in JAX.

Every source stops on its own: a row takes a sweep's result while it is
still moving and keeps it once its own change is at most 1e-6, which is
JAX's test for a batch of one source. Per-source sums go into one float64
accumulator source by source, in source order. So a result does not depend
on the batch size, which the port sets from the card's free memory
(:func:`source_batch`; JAX caps it by a fixed HBM budget).

Approximation: sqrt(N) source sampling above ``auto_approx_threshold``
(default 50000), scaled by N/S — the reference's switch
(``src/graph_centrality.c:417-434``); the sample is numpy's
``default_rng(seed)``, so both packages take the same sources.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import native
from muninn_tpu_torch.graph import core, routing
from muninn_tpu_torch.graph import traversal as trv
from muninn_tpu_torch.graph.routing import use_host
from muninn_tpu_torch.index.store import resolve_device
from muninn_tpu_torch.ops.segments import n_passes_for, seg_sum

DEFAULT_APPROX_THRESHOLD = 50000

# device bytes a batched source holds at its peak, per edge and per node:
# building a tight mask gathers two float64 distances an edge and forms
# their float64 difference and bound (about 40 bytes an edge); a sweep
# holds the two masks, the ratio, a gathered operand, a product and its
# float64 prefix (about 22); dist (float64), sigma, delta and a sweep's
# result take about 24 bytes a node; both with room to spare
_SOURCE_EDGE_BYTES = 56
_SOURCE_NODE_BYTES = 32
# the share of the card's free memory a batch may take, and the budget on
# the CPU
_FREE_SHARE = 0.5
_CPU_BUDGET = 1 << 30


def source_batch(batch: int, e: int, n: int, device: torch.device) -> int:
    """The sources to run at once: at most ``batch``, and as many as fit
    ``_FREE_SHARE`` of the card's free memory (``_CPU_BUDGET`` on the
    CPU) at ``_SOURCE_EDGE_BYTES`` an edge and ``_SOURCE_NODE_BYTES`` a
    node each. Free memory counts what PyTorch's allocator holds unused."""
    per_source = max(e, 1) * _SOURCE_EDGE_BYTES + n * _SOURCE_NODE_BYTES
    if device.type == "cuda":
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        budget = int((torch.cuda.mem_get_info(device)[0] + cached)
                     * _FREE_SHARE)
    else:
        budget = _CPU_BUDGET
    return max(1, min(batch, budget // per_source))


def _node_of(offsets: torch.Tensor, e_pad: int, num_nodes: int) -> torch.Tensor:
    """Node id per CSR position (the segment each edge belongs to)."""
    pos = torch.arange(e_pad, dtype=torch.int32, device=offsets.device)
    node = torch.searchsorted(offsets, pos, right=True, out_int32=True) - 1
    return node.clamp_(max=num_nodes - 1)


def _tight(du: torch.Tensor, wv: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Tight-edge DAG: strictly increasing distance (positive weights); JAX's
    ``tight`` test, in the operands' dtype."""
    gap = (du + wv).sub_(dv).abs_()
    return (torch.isfinite(du) & (gap <= 1e-9 * dv.abs().clamp_(min=1.0))
            & (wv > 0))


def _fixpoint(step, init: torch.Tensor, max_iters: int) -> torch.Tensor:
    """Jacobi sweeps ``x <- step(x)`` per source row: a row takes each
    sweep's result while its previous change was above 1e-6, then keeps its
    value (JAX's while_loop for a single source); at most ``max_iters``
    sweeps, one host read each."""
    x = init
    live = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(max_iters):
        new = step(x)
        moved = ((new - x).abs() > 1e-6).any(dim=1)
        x = torch.where(live[:, None], new, x)
        live &= moved
        if not trv.host_read("brandes", live.any()):
            break
    return x


def _brandes_batch(
    foff: torch.Tensor,    # [V+1] forward CSR offsets
    fdst: torch.Tensor,    # [E_pad] forward targets (pads = V)
    fw: torch.Tensor,      # [E_pad] weights (pads = 0)
    roff: torch.Tensor,    # [V+1] reverse (pull) CSR offsets
    resrc: torch.Tensor,   # [E_pad] in-edge source endpoints (pads = V)
    rw: torch.Tensor,      # [E_pad]
    sources: torch.Tensor,  # [S]
    num_nodes: int,
    max_iters: int = 0,
    want_edge: bool = False,
    n_passes: int = 24,
    node_acc: torch.Tensor | None = None,
    edge_acc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch of Brandes sources over SORTED edge arrays; every
    per-node reduction is a segment sum (``ops.segments``), no scatters.
    Returns (node_cb f64 [V], edge_cb [E_pad] aligned to the
    forward-sorted order; zeros if not wanted), summed over the batch: each
    source's row added in turn to ``node_acc`` / ``edge_acc`` (float64,
    made here when None), which the caller carries across batches."""
    dev = foff.device
    s_count = sources.shape[0]
    e_pad = fdst.shape[0]
    e = int(foff[-1])  # the rows' edges; the padding takes no part
    if max_iters <= 0:
        # shortest-path hop depth bounds every fixpoint here; the cap keeps
        # a non-converging loop (fp noise at extreme scale) from running
        # num_nodes sweeps (JAX's cap: it changes results only there)
        max_iters = min(num_nodes, 1024)
    sources = torch.as_tensor(sources, device=dev).long()
    if node_acc is None:
        node_acc = torch.zeros(num_nodes, dtype=torch.float64, device=dev)
    if want_edge and edge_acc is None:
        edge_acc = torch.zeros(e_pad, dtype=torch.float64, device=dev)

    # float64 distances: exact path lengths (see the module docstring)
    dist = trv.multi_source_distances_pull(
        roff, resrc, rw.double(), sources, num_nodes, max_iters, n_passes)

    fsrc = _node_of(foff, e, num_nodes)      # fwd edge source node
    rtgt = _node_of(roff, e, num_nodes)      # rev edge target node
    fd, rs = fdst[:e], resrc[:e]
    fwe, rwe = fw[None, :e].double(), rw[None, :e].double()
    tight_f = _tight(dist.index_select(1, fsrc), fwe,
                     dist.index_select(1, fd))               # [S, E]
    tight_r = _tight(dist.index_select(1, rs), rwe,
                     dist.index_select(1, rtgt))             # [S, E]
    del dist

    rows = torch.arange(s_count, device=dev)
    # sigma fixpoint: per-node sums over IN-edges = reverse segments
    base = torch.zeros(s_count, num_nodes, device=dev)
    base[rows, sources] = 1.0
    sigma = _fixpoint(
        lambda s: base + seg_sum(
            torch.where(tight_r, s.index_select(1, rs), 0.0), roff),
        base, max_iters)
    del tight_r

    # delta fixpoint: per-node sums over OUT-edges = forward segments
    safe_sigma = sigma.clamp(min=1e-30)
    ratio = torch.where(tight_f, sigma.index_select(1, fsrc)
                        / safe_sigma.index_select(1, fd), 0.0)
    del tight_f, safe_sigma, sigma
    delta = _fixpoint(
        lambda d: seg_sum(ratio * (1.0 + d.index_select(1, fd)), foff),
        torch.zeros(s_count, num_nodes, device=dev), max_iters)

    if want_edge:
        edge = ratio * (1.0 + delta.index_select(1, fd))     # [S, E]
        for r in range(s_count):
            edge_acc[:e] += edge[r]
        del edge
    # CB excludes the source itself (delta[s, s] contribution)
    delta[rows, sources] = 0.0
    for r in range(s_count):
        node_acc += delta[r]
    edge_cb = (edge_acc if want_edge
               else torch.zeros(e_pad, dtype=torch.float32, device=dev))
    return node_acc, edge_cb


def dedupe_parallel_edges(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse parallel (src,dst) duplicates keeping the min weight.
    Path *counting* (sigma) must see a simple graph — parallel edges
    would multiply shortest-path counts. Host form (numpy), as in JAX;
    the result is sorted by (src, dst)."""
    if len(src) == 0:  # edgeless graph: run[-1] below would IndexError
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    key = src.astype(np.int64) * num_nodes + dst
    order = np.argsort(key, kind="stable")
    ks, ws = key[order], w[order]
    head = np.concatenate([[True], ks[1:] != ks[:-1]])
    run = np.cumsum(head) - 1
    wmin = np.full(run[-1] + 1, np.inf, np.float32)
    np.minimum.at(wmin, run, ws)
    uk = ks[head]
    return (
        (uk // num_nodes).astype(np.int32),
        (uk % num_nodes).astype(np.int32),
        wmin.astype(np.float32),
    )


def dedupe_parallel_edges_device(
    src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, num_nodes: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dedupe_parallel_edges` on the tensors' device: one stable
    sort of the (src, dst) keys, the minimum weight of each run by an
    ``amin`` scatter (exact in any order). The same arrays."""
    dev = src.device
    if src.numel() == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev))
    ks, order = torch.sort(src.long() * num_nodes + dst.long(), stable=True)
    ws = w.float().index_select(0, order)
    del order
    head = torch.ones_like(ks, dtype=torch.bool)
    head[1:] = ks[1:] != ks[:-1]
    run = torch.cumsum(head, 0) - 1
    uk = ks[head]
    wmin = torch.full((uk.shape[0],), torch.inf, device=dev)
    wmin.scatter_reduce_(0, run, ws, "amin")
    return (uk // num_nodes).int(), (uk % num_nodes).int(), wmin


def _on_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device, dtype)


def _device_of(src) -> torch.device:
    """Where the device engine runs: the edges' own device (a tensor's),
    else the card."""
    return resolve_device(src.device if isinstance(src, torch.Tensor)
                          else "cuda")


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def n_sources(n: int, sample_sources: int | None,
              auto_approx_threshold: int) -> int:
    """How many sources Brandes runs: every node, ``sample_sources``, or
    sqrt(N) above ``auto_approx_threshold``."""
    if sample_sources is None and n > auto_approx_threshold:
        sample_sources = int(np.ceil(np.sqrt(n)))
    return n if sample_sources is None else min(n, sample_sources)


def _sources(n: int, sample_sources: int | None, auto_approx_threshold: int,
             seed: int) -> tuple[np.ndarray, float]:
    """(source ids int32, scale): every node, or a sample without
    replacement from ``default_rng(seed)`` scaled by N/S."""
    s = n_sources(n, sample_sources, auto_approx_threshold)
    if s < n:
        picked = np.random.default_rng(seed).choice(n, size=s, replace=False)
        return picked.astype(np.int32), n / float(s)
    return np.arange(n, dtype=np.int32), 1.0


def brandes_host_seconds(n_sources: int, e: int, weighted_alg: bool) -> float:
    """The host engine's estimated time for Brandes (routing's per-unit
    cost times sources x edges)."""
    cost = (routing.COST_BRANDES_SRC_EDGE if weighted_alg
            else routing.COST_BRANDES_SRC_EDGE_UNWEIGHTED)
    return cost * n_sources * max(e, 1)


def betweenness(
    src,
    dst,
    w,
    num_nodes: int,
    *,
    undirected: bool = False,
    normalized: bool = False,
    want_edge: bool = False,
    sample_sources: int | None = None,
    auto_approx_threshold: int = DEFAULT_APPROX_THRESHOLD,
    batch: int = 64,
    seed: int = 0,
    backend: str = "auto",
    weighted_alg: bool = True,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Brandes betweenness over all (or sampled) sources.

    ``src``, ``dst``, ``w``: a simple graph (use
    :func:`dedupe_parallel_edges`), as numpy arrays or tensors; the device
    engine runs on the tensors' device (numpy arrays: the card). ``undirected``: pass the 'both'-direction COO and set True —
    path counts are halved like the reference (:478-487). Normalization is
    (N-1)(N-2) [/2 undirected] (:490-499).

    ``backend``/``weighted_alg``: small source x edge workloads route to
    the native sequential Brandes (``muninn_graph.cpp``) — see
    ``graph.routing``; ``weighted_alg=False`` lets the host use plain BFS
    instead of Dijkstra when all weights are 1.

    Precision: path counts (sigma) are f32 on both engines' unweighted
    paths — exact up to 2^24 paths, rounded beyond. The per-source sums of
    the device engine are float64."""
    n = num_nodes
    e = len(src)
    if n < 2:
        return (np.zeros(n, np.float32),
                np.zeros(e, np.float32) if want_edge else None)
    all_sources, scale = _sources(n, sample_sources, auto_approx_threshold,
                                  seed)
    if use_host(backend, brandes_host_seconds(len(all_sources), e,
                                              weighted_alg),
                routing.HOST_SECONDS_BRANDES):
        node_cb, edge_raw = native.graph_brandes(
            _np(src), _np(dst), _np(w), n, all_sources,
            weighted=weighted_alg, want_edge=want_edge,
        )
        return _betweenness_post(
            node_cb.copy(), edge_raw.copy() if want_edge else None, n, e,
            scale, undirected, normalized, want_edge,
        )

    dev = _device_of(src)
    node_cb = torch.zeros(n, dtype=torch.float64, device=dev)
    edge_cb = (torch.zeros(e, dtype=torch.float64, device=dev)
               if want_edge else None)
    if e:
        foff, fdst, fw, roff, resrc, rw, max_deg = _sorted_pair(
            _on_device(src, torch.int32, dev), _on_device(dst, torch.int32, dev),
            _on_device(w, torch.float32, dev), n)
        npass = n_passes_for(max_deg)
        b = source_batch(batch, e, n, dev)
        srcs = torch.from_numpy(all_sources).to(dev)
        for i in range(0, len(all_sources), b):
            _brandes_batch(foff, fdst, fw, roff, resrc, rw, srcs[i:i + b], n,
                           want_edge=want_edge, n_passes=npass,
                           node_acc=node_cb, edge_acc=edge_cb)
    return _betweenness_post(
        node_cb.cpu().numpy(), edge_cb.cpu().numpy() if want_edge else None,
        n, e, scale, undirected, normalized, want_edge,
    )


def _sorted_pair(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 n: int):
    """Forward + reverse (pull) CSR arrays of a COO, on its device, by two
    stable sorts (``core._sort_csr``: the host counting sort's order), plus
    the max segment length. The forward order equals the input order when
    the input is already src-sorted (:func:`dedupe_parallel_edges`' is),
    which keeps edge_cb aligned. Unpadded: the fixpoints read only the
    rows' edges."""
    foff, fdst, fw = core._sort_csr(src, dst, w, n)
    roff, resrc, rw = core._sort_csr(dst, src, w, n)
    max_deg = max(1, int((foff[1:] - foff[:-1]).max()),
                  int((roff[1:] - roff[:-1]).max()))
    return foff, fdst, fw, roff, resrc, rw, max_deg


def _betweenness_post(
    node_cb, edge_cb, n, e, scale, undirected, normalized, want_edge,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Shared sampling-scale / undirected-halving / normalization tail
    applied to raw Brandes sums from either engine."""
    node_cb *= scale
    if want_edge:
        edge_cb *= scale
    if undirected:
        node_cb /= 2.0
        if want_edge:
            edge_cb /= 2.0
    if normalized:
        denom = (n - 1) * (n - 2)
        if undirected:
            denom /= 2.0
        if denom > 0:
            node_cb /= denom
        edenom = n * (n - 1)
        if undirected:
            edenom /= 2.0
        if want_edge and edenom > 0:
            edge_cb /= edenom
    return node_cb.astype(np.float32), (
        edge_cb.astype(np.float32) if want_edge else None
    )


def closeness_host_seconds(n: int, e: int, weighted_alg: bool) -> float:
    """The host engine's estimated time for all-source closeness."""
    cost = (routing.COST_CLOSENESS_SRC_EDGE if weighted_alg
            else routing.COST_CLOSENESS_SRC_EDGE_UNWEIGHTED)
    return cost * n * max(e, 1)


def closeness(
    src,
    dst,
    w,
    num_nodes: int,
    *,
    normalized: bool = True,
    batch: int = 256,
    backend: str = "auto",
    weighted_alg: bool = True,
) -> np.ndarray:
    """Closeness centrality: per-source SSSP sums
    (``src/graph_centrality.c:1404-1434``). ``normalized`` applies the
    Wasserman-Faust reachable/(N-1) correction. Pass the COO oriented so
    that edges point *toward* the measured node (reverse direction) for
    the standard definition on directed graphs. Arrays as in
    :func:`betweenness`; a source's distance sum is float64."""
    n = num_nodes
    e = len(src)
    if use_host(backend, closeness_host_seconds(n, e, weighted_alg),
                routing.HOST_SECONDS_CLOSENESS):
        return native.graph_closeness(
            _np(src), _np(dst), _np(w), n, weighted=weighted_alg,
            normalized=normalized,
        )
    dev = _device_of(src)
    # pull CSR: distances relax src -> dst, so pull over dst-sorted rows
    roff, resrc, rw = core._sort_csr(
        _on_device(dst, torch.int32, dev), _on_device(src, torch.int32, dev),
        _on_device(w, torch.float32, dev), n)
    out = torch.zeros(n, dtype=torch.float32, device=dev)
    b = source_batch(batch, e, n, dev)
    for i in range(0, n, b):
        chunk = torch.arange(i, min(i + b, n), device=dev)
        dist = trv.multi_source_distances_pull(roff, resrc, rw, chunk, n)
        dist[torch.arange(chunk.shape[0], device=dev), chunk] = torch.inf
        finite = torch.isfinite(dist)
        r = finite.sum(dim=1)                        # reachable (excl self)
        sd = torch.where(finite, dist, 0.0).sum(dim=1, dtype=torch.float64)
        c = torch.where(sd > 0, r / sd.clamp(min=1e-30), 0.0)
        if normalized and n > 1:
            c = c * (r / (n - 1))
        out[chunk] = c.float()
    return out.cpu().numpy()


def degree_centrality(
    src,
    dst,
    w,
    num_nodes: int,
    *,
    direction: str = "both",
    weighted: bool = False,
    normalized: bool = False,
) -> np.ndarray:
    """Degree (in/out/total), optionally weighted and /(N-1)-normalized
    (``src/graph_centrality.c:667-680``). ``direction``: 'forward' =
    out-degree, 'reverse' = in-degree, 'both' = total. Sums in float64 on
    the arrays' device (numpy arrays: the CPU)."""
    s, d = torch.as_tensor(src).long(), torch.as_tensor(dst).long()
    vals = (torch.as_tensor(w).to(s.device, torch.float64) if weighted
            else torch.ones(s.shape[0], dtype=torch.float64, device=s.device))
    out = torch.zeros(num_nodes, dtype=torch.float64, device=s.device)
    if direction in ("forward", "both"):
        out.index_add_(0, s, vals)
    if direction in ("reverse", "both"):
        out.index_add_(0, d, vals)
    if normalized and num_nodes > 1:
        out /= num_nodes - 1
    return out.float().cpu().numpy()
