"""The reference put in the program's place one precision down: the exact
top-k with every operand rounded to TF32 (10 mantissa bits, to nearest
even) and float32 sums, as a TF32 tensor core computes it, and the TF32
distances returned. The step that would tempt a later PR: TF32 for the
float32 search or rescore that the cells state."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import blocked_topk


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def distances(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """``[U, M]`` float32 distances from TF32 products of ``q [U, d]`` and
    ``x [M, d]``; norms in float32 from the unrounded rows."""
    if metric == "cosine":
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp(min=1e-30)
    dots = tf32(q) @ tf32(x).T
    if metric == "cosine":
        return 1.0 - dots / torch.linalg.vector_norm(x, dim=1).clamp(min=1e-30)[None, :]
    if metric == "inner_product":
        return -dots
    return (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * dots


def answer(run, q: np.ndarray, x: torch.Tensor):
    """``(rows [U, k] int64, dists [U, k] float32)`` for queries ``q``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the rounding is ours
    try:
        rows, dists = [], []
        for s in range(0, len(q), 2048):
            qb = torch.from_numpy(q[s : s + 2048]).to(x.device)
            d, i = blocked_topk(qb, x, run.k,
                                lambda a, b: distances(a, b, run.p["metric"]))
            rows.append(i.cpu().numpy())
            dists.append(d.cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return np.concatenate(rows), np.concatenate(dists)
