"""Batched distances, the PyTorch port of ``muninn_tpu/ops/distance.py``.

Distance semantics are the reference's (smaller = more similar):

- ``l2``:            squared Euclidean (no sqrt)
- ``cosine``:        1 - cos(a, b)   (0 identical, 2 opposite)
- ``inner_product``: -dot(a, b)

All products here are exact float32: on the card TF32 is switched off
for each one (``exact_f32_dots``).
"""

from __future__ import annotations

import enum

import torch

_EPS_NORM = 1e-30  # denominator guard, as in muninn_tpu/ops/distance.py


class Metric(enum.Enum):
    L2 = "l2"
    COSINE = "cosine"
    INNER_PRODUCT = "inner_product"


def parse_metric(name: str | Metric) -> Metric:
    """Parse a metric name. Raises ValueError on invalid input."""
    if isinstance(name, Metric):
        return name
    try:
        return Metric(name)
    except ValueError:
        raise ValueError(
            f"invalid metric {name!r}: expected one of "
            f"{[m.value for m in Metric]}"
        ) from None


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, f32 accumulation."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def exact_f32_dots(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``q @ c.T`` in full float32. On the card this sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for the product (so
    that no caller's setting can turn the reference into a TF32 product)
    and restores the caller's setting afterwards."""
    if not q.is_cuda:
        return q @ c.T
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return q @ c.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def pairwise_distances(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    metric: Metric | str = Metric.L2,
) -> torch.Tensor:
    """All-pairs distances ``[B, N]`` between queries ``[B, d]`` and corpus
    ``[N, d]``, exact float32."""
    metric = parse_metric(metric)
    q = queries.float()
    c = corpus.float()
    dots = exact_f32_dots(q, c)
    if metric is Metric.INNER_PRODUCT:
        return -dots
    if metric is Metric.L2:
        qn = squared_norms(q)[:, None]
        cn = squared_norms(c)[None, :]
        # clamp: exact-match pairs can go slightly negative in f32
        return torch.clamp(qn + cn - 2.0 * dots, min=0.0)
    qn = torch.sqrt(squared_norms(q))[:, None]
    cn = torch.sqrt(squared_norms(c))[None, :]
    denom = qn * cn
    sim = torch.where(
        denom < _EPS_NORM,
        torch.zeros_like(dots),
        dots / torch.clamp(denom, min=_EPS_NORM),
    )
    return 1.0 - sim
