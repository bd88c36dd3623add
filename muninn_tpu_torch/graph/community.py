"""Leiden community detection as edge-parallel synchronous local moving.

The port's copy of ``muninn_tpu.graph.community`` (a re-design of the
reference's ``src/graph_community.c``, Traag et al. 2019, which moves nodes
one at a time with an O(deg^2) ``weight_to_community`` rescan). A *sweep*
evaluates every node's best move at once:

1. sort edge keys (src, comm[dst]) -> run-length segments give W(v, C)
   for every candidate community C in one pass,
2. per-candidate modularity gain
   (W(v,C) - W(v, comm[v]))/m + gamma * k_v * (Sigma_old - k_v -
   Sigma_C) / (2 m^2)        — the reference's formula (:150-231),
3. segment-max picks each node's best move; a random half of the nodes
   (seeded) applies it — synchronous moving with subset damping to avoid
   the classic two-coloring oscillation; if the damping suppressed every
   move, the single best one applies.

Refinement restricts moves to stay inside the phase-1 communities,
starting from singletons (:238-312). Aggregation contracts refined
communities into super-nodes and the loop repeats, max 100 rounds
(:336-429).

Everything runs in torch on the edges' device, aggregation and modularity
included (host numpy in JAX). Sums are float64, rounded once where JAX
keeps float32: ``W(v, C)`` and ``W(v, comm[v])`` are windows of one
float64 prefix over the sorted edges (``ops.segments.seg_sum``), and the
degree sums ``k`` and ``Sigma_tot`` float64 ``index_add_``s. A float64 sum
of float32 values is exact, so the same whatever the order of its
additions, while its values span at most 2**53 of the smallest one's ulp
(weights of at least 2**-4 summing to under 2**26); within that, one seed
gives the same labels on every run on one device. The damping subset comes
from a ``torch.Generator`` on that device, seeded from the same numpy draw
as JAX's PRNG key, so labels differ from JAX's while the quality does not.
Each sweep reads one host flag (``traversal.HOST_SYNCS["leiden"]``).
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import native
from muninn_tpu_torch.graph import routing
from muninn_tpu_torch.graph import traversal as trv
from muninn_tpu_torch.graph.routing import use_host
from muninn_tpu_torch.index.store import resolve_device
from muninn_tpu_torch.ops.segments import seg_sum

_NO_TARGET = 2**30


def _sum_by(idx: torch.Tensor, vals: torch.Tensor, num_segments: int) -> torch.Tensor:
    """float64 sums of ``vals`` by segment id ``idx``."""
    out = torch.zeros(num_segments, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, idx.long(), vals.double())


def _offsets(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR offsets [num_segments + 1] of an ascending id array."""
    return torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, device=sorted_ids.device))


def _best_moves(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    comm: torch.Tensor,        # [V] int32 current communities
    k: torch.Tensor,           # [V] f32 weighted degrees
    sigma_tot: torch.Tensor,   # [V] f32 community degree sums (by comm id)
    m,                         # f32 total edge weight (undirected m)
    gamma,                     # f32 resolution
    restrict: torch.Tensor,    # [V] int32 — moves allowed only within equal labels
    num_nodes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-node best (gain, target community). Returns (gain[V] f32,
    target[V] int32)."""
    dev = src.device
    e = src.shape[0]
    m = torch.as_tensor(m, dtype=torch.float32, device=dev)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    src_l, dst_l = src.long(), dst.long()
    cd = comm.index_select(0, dst_l).long()
    # candidate edges must respect the refinement restriction
    allowed = restrict.index_select(0, src_l) == restrict.index_select(0, dst_l)
    # one stable sort by (src, cd) — JAX's two stable passes. Disallowed
    # edges get a sentinel community so they never share a run with
    # allowed edges.
    key, order = torch.sort(
        src_l * (num_nodes + 1) + torch.where(allowed, cd, num_nodes),
        stable=True)
    src_s = src_l.index_select(0, order)
    cd_s = key - src_s * (num_nodes + 1)
    allowed_s = allowed.index_select(0, order)
    w_s = torch.where(allowed_s, w.index_select(0, order), 0.0)
    own_s = (allowed_s & (comm.index_select(0, src_s) == cd_s)
             & (src_s != dst_l.index_select(0, order)))
    del order, cd, allowed

    newrun = torch.ones(e, dtype=torch.bool, device=dev)
    newrun[1:] = key[1:] != key[:-1]
    del key
    run_id = torch.cumsum(newrun, 0) - 1                       # [E]
    # W(v, C) of each edge's (src, target-community) run: the runs are
    # contiguous, so each is a window of one f64 prefix
    w_vc = seg_sum(w_s, _offsets(run_id, e)).index_select(0, run_id)
    # per-node weight to its own community (self-loops excluded)
    w_own = seg_sum(torch.where(own_s, w_s, 0.0), _offsets(src_s, num_nodes))
    del run_id, own_s, w_s

    # per-run gain of moving src_run -> cd_run
    cd_c = cd_s.clamp(max=num_nodes - 1)      # the sentinel's gather
    kv = k.index_select(0, src_s)
    comm_src = comm.index_select(0, src_s)
    sig_old = sigma_tot.index_select(0, comm_src)
    sig_new = sigma_tot.index_select(0, cd_c)
    stay = cd_s == comm_src
    gain = (w_vc - w_own.index_select(0, src_s)) / m + gamma * kv * (
        sig_old - kv - sig_new
    ) / (2.0 * m * m)
    # only the first edge of each run carries the run's gain
    valid = newrun & ~stay & allowed_s
    gain = torch.where(valid, gain, -torch.inf)

    best_gain = torch.full((num_nodes,), -torch.inf, device=dev)
    best_gain.scatter_reduce_(0, src_s, gain, "amax")
    best_gain = torch.where(torch.isfinite(best_gain), best_gain, -torch.inf)
    # tie-break: smallest target community id achieving best gain
    achieves = valid & (gain >= best_gain.index_select(0, src_s) - 1e-12)
    tgt = torch.where(achieves, cd_s, _NO_TARGET)
    best_tgt = torch.full((num_nodes,), _NO_TARGET, dtype=torch.int64,
                          device=dev)
    best_tgt.scatter_reduce_(0, src_s, tgt, "amin")
    best_tgt = torch.where(best_tgt < _NO_TARGET, best_tgt, comm.long())
    return best_gain, best_tgt.int()


def _local_moving(
    src, dst, w, comm, k, m, gamma, restrict, num_nodes,
    rng: np.random.Generator, max_sweeps: int = 30,
) -> torch.Tensor:
    """Run synchronous local-moving sweeps until no positive-gain moves
    (at most ``max_sweeps``); one host read a sweep. The damping subset
    comes from a generator on the edges' device, seeded by one draw of
    ``rng`` (JAX's PRNG key draw)."""
    dev = src.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**31 - 1)))
    comm = torch.as_tensor(comm, device=dev).int()
    restrict = torch.as_tensor(restrict, device=dev).int()
    m = torch.tensor(m, dtype=torch.float32, device=dev)
    gamma = torch.tensor(gamma, dtype=torch.float32, device=dev)
    for _ in range(max_sweeps):
        sigma_tot = _sum_by(comm, k, num_nodes).float()
        gain, tgt = _best_moves(src, dst, w, comm, k, sigma_tot, m, gamma,
                                restrict, num_nodes)
        movable = gain > 1e-12
        subset = torch.rand(num_nodes, generator=gen, device=dev) < 0.5
        apply = movable & subset
        # ensure progress: if damping suppressed every move, apply the
        # single best one
        fallback = torch.zeros_like(movable)
        fallback[torch.argmax(torch.where(movable, gain, -torch.inf))] = True
        apply = torch.where(apply.any(), apply, fallback & movable)
        comm = torch.where(apply, tgt, comm)
        if not trv.host_read("leiden", movable.any()):
            break
    return comm


def _renumber(labels) -> torch.Tensor:
    """Labels renumbered 0..c-1 in ascending order of the old label
    (``np.unique``'s inverse), int32."""
    labels = torch.as_tensor(labels)
    return torch.unique(labels, return_inverse=True)[1].int()


def _aggregate(
    src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contract communities into super-nodes; merge parallel edges (their
    weights summed in float64, rounded once). Sorted by (src, dst)."""
    src, dst, w, labels = (torch.as_tensor(a) for a in (src, dst, w, labels))
    dev = src.device
    labels = labels.to(dev).long()
    nc = int(labels.max()) + 1 if labels.numel() else 0
    key = labels.index_select(0, src.long()) * nc + labels.index_select(
        0, dst.long())
    key_s, order = torch.sort(key, stable=True)
    e = key_s.shape[0]
    head = torch.ones(e, dtype=torch.bool, device=dev)
    head[1:] = key_s[1:] != key_s[:-1]
    run = torch.cumsum(head, 0) - 1
    uk = key_s[head]
    w_agg = seg_sum(w.float().index_select(0, order),
                    _offsets(run, e))[:uk.shape[0]]
    return (uk // nc).int(), (uk % nc).int(), w_agg


def modularity(src, dst, w, labels, gamma: float = 1.0) -> float:
    """Q over an undirected both-direction COO (each edge twice):
    Q = sum_c [ Sigma_in_c / 2m  -  gamma (Sigma_tot_c / 2m)^2 ]
    (reference per-community Q, ``src/graph_community.c:109-142``). Sums in
    float64 on the arrays' device (numpy arrays: the CPU)."""
    src, dst, w = (torch.as_tensor(a) for a in (src, dst, w))
    labels = torch.as_tensor(labels).to(src.device).long()
    two_m = float(w.sum(dtype=torch.float64))
    if two_m <= 0:
        return 0.0
    ls = labels.index_select(0, src.long())
    ld = labels.index_select(0, dst.long())
    intra = float(torch.where(ls == ld, w, 0.0).sum(dtype=torch.float64))
    k = _sum_by(ls, w, int(labels.max()) + 1)
    return intra / two_m - gamma * float(((k / two_m) ** 2).sum())


def leiden(
    src,
    dst,
    w,
    num_nodes: int,
    *,
    resolution: float = 1.0,
    max_rounds: int = 100,
    seed: int = 0,
    backend: str = "auto",
) -> tuple[np.ndarray, float]:
    """Full Leiden loop. Inputs are the undirected 'both' COO (each edge in
    both orientations) as numpy arrays or tensors; the device engine runs on
    the tensors' device (numpy arrays: the card). Returns (labels int32[V],
    modularity).

    Small graphs route to the native sequential Leiden (``muninn_graph.cpp``
    — queue-based local moving, the ``src/graph_community.c`` structure) by
    ``graph.routing``'s measured crossover."""
    e = len(src)
    if use_host(backend, routing.COST_LEIDEN_EDGE * max(e, 1),
                routing.HOST_SECONDS_LEIDEN):
        return native.graph_leiden(
            *(a.cpu().numpy() if isinstance(a, torch.Tensor) else a
              for a in (src, dst, w)),
            num_nodes, resolution, max_rounds, seed)

    dev = resolve_device(src.device if isinstance(src, torch.Tensor)
                         else "cuda")
    s = torch.as_tensor(src).to(dev, torch.int32)
    d = torch.as_tensor(dst).to(dev, torch.int32)
    ww = torch.as_tensor(w).to(dev, torch.float32)
    rng = np.random.default_rng(seed)
    labels = torch.arange(num_nodes, dtype=torch.int32, device=dev)
    cur_s, cur_d, cur_w, cur_n = s, d, ww, num_nodes
    node_map = labels  # original node -> super node
    # initial partition for phase-1 local moving; after aggregation this
    # becomes the phase-1 partition projected onto the refined super-nodes
    # (Traag 2019: the aggregate graph is initialized with the NON-refined
    # partition, not singletons)
    init_comm = labels

    prev_q = -np.inf
    for _ in range(max_rounds):
        k = _sum_by(cur_s, cur_w, cur_n).float()
        m = float(cur_w.sum(dtype=torch.float64)) / 2.0
        if m <= 0:
            break
        singletons = torch.arange(cur_n, dtype=torch.int32, device=dev)
        # phase 1: local moving from current (meta-)partition
        comm = _renumber(_local_moving(
            cur_s, cur_d, cur_w, init_comm, k, m, resolution,
            torch.zeros_like(singletons), cur_n, rng))
        # phase 2: refinement — singletons, moves restricted to phase-1
        # communities (src/graph_community.c:238-312)
        refined = _renumber(_local_moving(
            cur_s, cur_d, cur_w, singletons, k, m, resolution, comm, cur_n,
            rng))
        # fallback if refinement fragments more than phase 1 helps
        # (reference fallback, :376-408)
        nc = int(refined.max()) + 1
        use = refined
        if nc > int(comm.max()) + 1:
            use, nc = comm, int(comm.max()) + 1

        full_labels = use.index_select(0, node_map.long())
        q = modularity(s, d, ww, full_labels, resolution)
        if q <= prev_q + 1e-9:
            break
        prev_q = q
        labels = full_labels
        if nc == cur_n:
            break
        # aggregate on the refined partition; next round starts from the
        # phase-1 partition projected onto super-nodes (every member of a
        # refined community shares one phase-1 community — refinement is
        # restricted — so every write to a slot writes the same value)
        init_comm = torch.empty(nc, dtype=torch.int32, device=dev)
        init_comm[use.long()] = comm
        cur_s, cur_d, cur_w = _aggregate(cur_s, cur_d, cur_w, use)
        node_map = full_labels
        cur_n = nc

    q = prev_q if np.isfinite(prev_q) else modularity(s, d, ww, labels,
                                                      resolution)
    return _renumber(labels).cpu().numpy(), q
