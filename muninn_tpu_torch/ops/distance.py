"""Batched distances, the PyTorch port of ``muninn_tpu/ops/distance.py``.

Distance semantics are the reference's (smaller = more similar):

- ``l2``:            squared Euclidean (no sqrt)
- ``cosine``:        1 - cos(a, b)   (0 identical, 2 opposite)
- ``inner_product``: -dot(a, b)

All products here are exact float32: on the card TF32 is switched off
for each one (``exact_f32_dots``).
"""

from __future__ import annotations

import contextlib
import enum

import torch

_EPS_NORM = 1e-30  # denominator guard, as in muninn_tpu/ops/distance.py


class Metric(enum.Enum):
    L2 = "l2"
    COSINE = "cosine"
    INNER_PRODUCT = "inner_product"


# the metric as the CUDA kernels (csrc/*.cu) take it
METRIC_CODE = {Metric.L2: 0, Metric.COSINE: 1, Metric.INNER_PRODUCT: 2}


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


@contextlib.contextmanager
def _no_tf32(on_cuda: bool):
    """Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` for the block
    when ``on_cuda`` (so that no caller's setting can turn a reference
    product into a TF32 one) and restores the caller's setting after."""
    if not on_cuda:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def exact_f32_dots(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``q @ c.T`` in full float32, TF32 off on the card."""
    with _no_tf32(q.is_cuda):
        return q @ c.T


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (last axis) divided by their L2 norm, guarded by
    ``_EPS_NORM``: ``v / max(|v|, 1e-30)`` as the JAX package writes it."""
    return x / torch.clamp(torch.sqrt(squared_norms(x))[..., None],
                           min=_EPS_NORM)


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows (last axis) divided by ``max(|row|, eps)``
    (``muninn_tpu/ops/distance.py:144-148``)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def quantize_rows_int8(
    v: torch.Tensor, normalize: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization, the contract of
    ``muninn_tpu/ops/distance.py`` ``quantize_rows_int8``: one scale
    ``s = max|row| / 127`` per row (last axis; leading axes pass through)
    and values ``clip(round(v / max(s, 1e-30)), -127, 127)``, rounded half
    to even. ``normalize=True`` L2-normalises the rows first. Returns
    ``(int8 rows, f32 scales [leading axes])``."""
    v = v.float()
    if normalize:
        v = unit_rows(v)
    sc = torch.amax(v.abs(), dim=-1) / 127.0
    vi = torch.clamp(torch.round(v / torch.clamp(sc[..., None], min=_EPS_NORM)),
                     -127, 127).to(torch.int8)
    return vi, sc


def int8_dots(qi: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """``qi @ ci.T`` of int8 rows as f32, exactly as int32 sums rounded once
    to f32. Each product is at most 127^2, so up to d = 1040 every partial
    sum is an integer below 2^24, exact in f32 in any order (TF32 off);
    above that the sums are taken in float64."""
    if qi.shape[-1] <= 1040:
        return exact_f32_dots(qi.float(), ci.float())
    return (qi.double() @ ci.double().T).float()


def batched_f32_dots(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``[B, d]`` x ``[B, C, d]`` -> ``[B, C]`` dots in full float32, TF32
    off on the card."""
    with _no_tf32(q.is_cuda):
        return torch.bmm(c, q[:, :, None])[..., 0]


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


def gathered_distances(
    queries: torch.Tensor,
    candidate_vectors: torch.Tensor,
    metric: Metric | str = Metric.L2,
) -> torch.Tensor:
    """Per-query candidate distances ``[B, C]`` for queries ``[B, d]``
    against per-query gathered candidates ``[B, C, d]`` (any float dtype,
    computed in exact float32), as ``gathered_distances`` in
    ``muninn_tpu/ops/distance.py``: l2 clamped at 0, cosine with the
    ``_EPS_NORM`` guard."""
    metric = parse_metric(metric)
    q = queries.float()
    c = candidate_vectors.float()
    dots = batched_f32_dots(q, c)
    if metric is Metric.INNER_PRODUCT:
        return -dots
    if metric is Metric.L2:
        qn = squared_norms(q)[:, None]
        return torch.clamp(qn + squared_norms(c) - 2.0 * dots, min=0.0)
    denom = torch.sqrt(squared_norms(q))[:, None] * torch.sqrt(squared_norms(c))
    sim = torch.where(
        denom < _EPS_NORM,
        torch.zeros_like(dots),
        dots / torch.clamp(denom, min=_EPS_NORM),
    )
    return 1.0 - sim
