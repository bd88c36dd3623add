"""PageRank as edge-parallel SpMV power iteration.

The port's copy of ``muninn_tpu.graph.pagerank``. Reference:
``src/graph_tvf.c:1631-1717,1820-1828`` — power iteration with
dangling-node redistribution, damping 0.85, 20 iterations by default:

    rank' = (1 - d) / n + d * (pulled + dangling / n)

where ``pulled[v]`` sums ``rank[u] * share(u -> v)`` over v's in-edges and
``share = w / out_degree[u]`` (``1 / out_degree[u]`` unweighted). Ranks
are float32, as in the JAX package; the per-node sums and the dangling
mass are accumulated in float64 (``ops.segments.seg_sum``), which keeps
each rank within about one f32 rounding of the host engine's all-double
iteration at any graph size. The iterations queue on the device with no
host read until the result is downloaded.
"""

from __future__ import annotations

import torch

from muninn_tpu_torch.ops.segments import seg_sum


def _step(rank: torch.Tensor, pulled: torch.Tensor, dangling: torch.Tensor,
          damping: float) -> torch.Tensor:
    n = rank.shape[0]
    mass = torch.where(dangling, rank, 0.0).sum(dtype=torch.float64)
    return ((1.0 - damping) / n + damping * (pulled + mass / n)).float()


def pagerank_device(
    src: torch.Tensor,         # [E] int32
    dst: torch.Tensor,         # [E] int32
    w: torch.Tensor,           # [E] f32
    out_degree: torch.Tensor,  # [V] f32 (weighted out-degree if weighted)
    num_nodes: int,
    damping: float = 0.85,
    iterations: int = 20,
    weighted: bool = False,
) -> torch.Tensor:
    """Returns rank f32[V], summing to 1: the scatter form over an
    unsorted COO (the per-node sums by ``index_add_`` in float64)."""
    n = num_nodes
    rank = torch.full((n,), 1.0 / n, device=src.device)
    dangling = out_degree <= 0.0
    safe_deg = out_degree.clamp(min=1e-30)
    # per-edge share of the source's rank
    share = ((w if weighted else 1.0) / safe_deg.index_select(0, src))
    idx = dst.long()
    for _ in range(iterations):
        contrib = rank.index_select(0, src) * share               # [E]
        pulled = torch.zeros(n, dtype=torch.float64, device=src.device)
        pulled.index_add_(0, idx, contrib.double())
        rank = _step(rank, pulled, dangling, damping)
    return rank


def _share_sorted(
    tgt_src: torch.Tensor,     # [E_pad] int32 (pads >= num_nodes)
    w: torch.Tensor,           # [E_pad] f32, or a dummy when not weighted
    out_degree: torch.Tensor,  # [V] f32
    num_nodes: int,
    weighted: bool,
) -> torch.Tensor:
    """Loop-invariant per-edge share ``w_e / out_degree[src_e]``
    ([E_pad] f32, pads 0), built once for all iterations."""
    n = num_nodes
    safe_deg = out_degree.clamp(min=1e-30)
    valid = tgt_src < n                                        # pads = V
    s_idx = tgt_src.clamp(max=n - 1)
    return torch.where(
        valid, (w if weighted else 1.0) / safe_deg.index_select(0, s_idx), 0.0
    )


def pagerank_sorted(
    roff: torch.Tensor,        # [V+1] int32 offsets of the TARGET-sorted CSR
    tgt_src: torch.Tensor,     # [E_pad] int32 source node per target-sorted edge
    w: torch.Tensor,           # [E_pad] f32 (pads 0)
    out_degree: torch.Tensor,  # [V] f32
    num_nodes: int,
    damping: float = 0.85,
    iterations: int = 20,
    weighted: bool = False,
) -> torch.Tensor:
    """PageRank pull over a target-sorted CSR with no scatter: with edges
    sorted by pull target, per-node sums are window sums of one prefix,
    ``pulled[v] = S[roff[v+1]] - S[roff[v]]`` (``seg_sum``). Unweighted
    callers may pass a dummy ``w`` (it is never read)."""
    e = int(roff[-1])  # the rows' edges; the padding takes no part
    share = _share_sorted(tgt_src[:e], w[:e] if weighted else w, out_degree,
                          num_nodes, weighted)
    s_idx = tgt_src[:e]
    dangling = out_degree <= 0.0
    rank = torch.full((num_nodes,), 1.0 / num_nodes, device=roff.device)
    for _ in range(iterations):
        contrib = rank.index_select(0, s_idx) * share              # [E]
        pulled = seg_sum(contrib.double(), roff)
        rank = _step(rank, pulled, dangling, damping)
    return rank
