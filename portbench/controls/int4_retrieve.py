"""``int8_rescored`` one precision down, in the reference: rows and queries
(cosine: unit-normalised first) quantized to int4 with one scale per row
(``max|v| / 7``, values in [-7, 7]), the top-``rescore_r`` rows by the
int4 dot times each row's scale, then an exact float32 rescore keeps k."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import blocked_topk


def quantize4(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = v.abs().amax(1).clamp(min=1e-30) / 7.0
    return torch.round(v / scale[:, None]).clamp(-7, 7), scale


def answer(run, q: np.ndarray, x: torch.Tensor):
    metric, r, k = run.p["metric"], int(run.p["rescore_r"]), run.k
    unit = (lambda v: v / torch.linalg.vector_norm(v, dim=1, keepdim=True)) \
        if metric == "cosine" else (lambda v: v)

    def int4_rank(qi, rows):  # integer dots: exact in float32
        xi, xsc = quantize4(unit(rows))
        return -(qi @ xi.T) * xsc[None, :]

    rows, dists = [], []
    for s in range(0, len(q), 2048):
        qb = unit(torch.from_numpy(q[s : s + 2048]).to(x.device))
        _, cand_i = blocked_topk(quantize4(qb)[0], x, r, int4_rank)
        cand = x[cand_i]
        dots = torch.einsum("ud,urd->ur", qb, cand)
        if metric == "cosine":
            d = 1.0 - dots / torch.linalg.vector_norm(cand, dim=2).clamp(min=1e-30)
        elif metric == "inner_product":
            d = -dots
        else:
            d = ((qb[:, None, :] - cand) ** 2).sum(2)
        d, pos = torch.topk(d, k, dim=1, largest=False)
        rows.append(torch.gather(cand_i, 1, pos).cpu().numpy())
        dists.append(d.cpu().numpy())
    return np.concatenate(rows), np.concatenate(dists)
