"""Smallest-k over a corpus: a hand-written CUDA kernel and its plain
PyTorch version.

Port of ``muninn_tpu/ops/pallas_flat.py`` ``flat_topk`` in its float forms:
``precision="highest"`` (exact f32 operands) and ``"default"`` /
``"bfloat16"`` (operands rounded to bf16, products summed in f32: what one
bf16 MXU pass computes on the TPU). The kernel (``csrc/flat_topk.cu``)
replaces ``_flat_topk_kernel``'s float branch; the plain version
``flat_topk_plain`` mirrors ``_xla_topk``.

``flat_topk`` picks the path by the tensors' device: CPU tensors go to the
plain version, CUDA tensors to the kernel. On a CUDA tensor there is no
fallback: no ``nvcc``, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.distance import (
    _EPS_NORM,
    Metric,
    exact_f32_dots,
    parse_metric,
    squared_norms,
)
from muninn_tpu_torch.ops.topk import masked_topk, merge_topk

MAX_K = 1024  # the kernel's largest k; csrc/flat_topk.cu kMaxK
_CHUNK = 65536  # corpus rows per product in the plain version: [B, _CHUNK] peak
_MODE = {Metric.L2: 0, Metric.COSINE: 1, Metric.INNER_PRODUCT: 2}
_INF = float("inf")


def bf16_operands(precision: str) -> bool:
    """Whether ``precision`` ranks by bf16-rounded operands: False for
    "highest", True for "default" and "bfloat16". On the TPU "default" is
    one bf16 MXU pass over f32 inputs and "bfloat16" casts the inputs to
    bf16 before the same pass, so the two give the same numbers."""
    if precision == "highest":
        return False
    if precision in ("default", "bfloat16"):
        return True
    if precision == "int8":
        raise NotImplementedError(
            "precision='int8' is not ported yet (see ROADMAP.md, queue 1,"
            " and queue 2, row 2)"
        )
    raise ValueError(
        "precision must be 'highest', 'default', 'bfloat16' or 'int8', got"
        f" {precision!r}"
    )


def _penalty_row(
    corpus: torch.Tensor, metric: Metric, corpus_valid: torch.Tensor | None
) -> torch.Tensor:
    """``[N]`` f32 added to every distance: the corpus sqnorm for l2, 0
    for cosine and inner product, ``+inf`` on masked rows."""
    n = corpus.shape[0]
    if metric is Metric.L2:
        base = squared_norms(corpus)
    else:
        base = torch.zeros(n, dtype=torch.float32, device=corpus.device)
    if corpus_valid is None:
        return base
    return torch.where(
        corpus_valid.to(torch.bool), base, torch.full_like(base, _INF)
    )


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=_EPS_NORM)


def _inv_norms(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(torch.linalg.norm(x, dim=1), min=_EPS_NORM)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def flat_topk_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    metric: Metric | str = Metric.L2,
    corpus_valid: torch.Tensor | None = None,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, as ``_xla_topk``
    (``pallas_flat.py:192-238``) computes it: f32 products, the same
    penalty row, and a top-k merge, here over corpus chunks of ``_CHUNK``
    rows with ``masked_topk`` and ``merge_topk`` as ``FlatIndex``'s
    ``_xla_chunked_topk`` (``index/flat.py``) merges them. Returns
    ``(dists [B, k] f32, ids [B, k] int32)`` sorted ascending, ``(inf, -1)``
    where fewer than k rows are live.

    ``precision="default"``/``"bfloat16"``: the unit query and the raw
    corpus row are rounded to bf16 and multiplied in exact f32, cosine
    scales by 1/|c| of the f32 row, as the kernel does."""
    metric = parse_metric(metric)
    bf16 = bf16_operands(precision)
    q = queries.float()
    c = corpus.float()
    cs = None
    if metric is Metric.COSINE:
        # pre-normalise so the cosine distance is 1 - dot; the bf16 mode
        # rounds the raw corpus row and folds 1/|c| in after the product
        q = _unit_rows(q)
        if bf16:
            cs = _inv_norms(c)
        else:
            c = _unit_rows(c)
    cp = _penalty_row(c, metric, corpus_valid)
    qn = squared_norms(q)[:, None]
    b, n = q.shape[0], c.shape[0]
    bd = torch.full((b, k), _INF, dtype=torch.float32, device=q.device)
    bi = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    qo = _bf16_round(q) if bf16 else q
    for lo in range(0, n, _CHUNK):
        cc = c[lo : lo + _CHUNK]
        dots = exact_f32_dots(qo, _bf16_round(cc) if bf16 else cc)
        if cs is not None:
            dots = dots * cs[None, lo : lo + _CHUNK]
        cpc = cp[None, lo : lo + _CHUNK]
        if metric is Metric.L2:
            tile = (qn - 2.0 * dots) + cpc
        elif metric is Metric.COSINE:
            tile = (1.0 - dots) + cpc
        else:
            tile = cpc - dots
        ids = torch.arange(lo, lo + tile.shape[1], dtype=torch.int32,
                           device=q.device)
        td, ti = masked_topk(tile, k, ids=ids)  # masked rows: (inf, -1)
        bd, bi = merge_topk(bd, bi, td, ti)
    return bd, bi


_LIB: ctypes.CDLL | None = None  # the bound library, loaded at first launch


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("flat_topk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flat_topk_f32.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
        lib.flat_topk_f32.restype = i32
        lib.flat_topk_splits.argtypes = [i32] * 5
        lib.flat_topk_splits.restype = i32
        lib.flat_topk_max_k.argtypes = []
        lib.flat_topk_max_k.restype = i32
        lib.flat_topk_error_string.argtypes = [i32]
        lib.flat_topk_error_string.restype = ctypes.c_char_p
        if lib.flat_topk_max_k() != MAX_K:
            raise RuntimeError(
                f"csrc/flat_topk.cu serves k <= {lib.flat_topk_max_k()},"
                f" but flat_topk.MAX_K is {MAX_K}"
            )
        _LIB = lib
    return _LIB


def flat_topk_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    metric: Metric | str = Metric.L2,
    corpus_valid: torch.Tensor | None = None,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused distance + top-k kernel. CUDA tensors only; raises
    on anything else, and on a failed build or launch."""
    metric = parse_metric(metric)
    bf16 = bf16_operands(precision)
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k={k}: the flat_topk CUDA kernel serves 1 <= k <= {MAX_K}"
        )
    # the kernel reads the corpus in place; converting it here would copy
    # the whole corpus on every search
    if corpus.dtype != torch.float32 or not corpus.is_contiguous():
        raise ValueError(
            "flat_topk_cuda takes a contiguous float32 corpus, got"
            f" {corpus.dtype}{'' if corpus.is_contiguous() else ', strided'}"
        )
    if not (queries.is_cuda and corpus.is_cuda):
        raise ValueError(
            "flat_topk_cuda takes CUDA tensors, got queries on"
            f" {queries.device} and corpus on {corpus.device}"
        )
    if queries.device != corpus.device:
        raise ValueError(
            f"queries on {queries.device} but corpus on {corpus.device}"
        )
    b, d = queries.shape
    n, dc = corpus.shape
    if dc != d:
        raise ValueError(f"query dim {d} != corpus dim {dc}")
    if corpus_valid is not None and tuple(corpus_valid.shape) != (n,):
        raise ValueError(
            f"corpus_valid has shape {tuple(corpus_valid.shape)}, want ({n},)"
        )
    dev = queries.device
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    c = corpus
    q = queries.float()
    if metric is Metric.COSINE:
        q = _unit_rows(q)
        cs = _inv_norms(c)
    else:
        cs = torch.empty(0, dtype=torch.float32, device=dev)
    q = q.contiguous()
    qn = squared_norms(q).contiguous()
    cp = _penalty_row(c, metric, corpus_valid).contiguous()
    cs = cs.contiguous()

    lib = _library()
    splits = lib.flat_topk_splits(b, n, k, int(bf16), dev.index)
    if splits < 1:
        raise RuntimeError(
            f"flat_topk: querying {dev} failed: CUDA error {-splits}"
            f" ({lib.flat_topk_error_string(-splits).decode()})"
        )
    out_d = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flat_topk_f32(
        q.data_ptr(), c.data_ptr(), qn.data_ptr(), cp.data_ptr(),
        cs.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        b, n, d, k, _MODE[metric], int(bf16), splits, dev.index, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flat_topk kernel launch failed: CUDA error {rc}"
            f" ({lib.flat_topk_error_string(rc).decode()})"
        )
    _build.LAUNCHES["flat_topk"] += 1
    if splits == 1:
        return out_d[0], out_i[0]
    # merge the per-split sorted partials: [B, S*k] -> [B, k]
    pd = out_d.permute(1, 0, 2).reshape(b, splits * k)
    pi = out_i.permute(1, 0, 2).reshape(b, splits * k)
    md, pos = torch.topk(pd, k, dim=1, largest=False)
    return md, torch.gather(pi, 1, pos)


def flat_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    metric: Metric | str = Metric.L2,
    corpus_valid: torch.Tensor | None = None,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k over the corpus. Returns ``(dists [B,k] f32,
    ids [B,k] int32)`` sorted ascending; invalid or masked slots are
    ``(inf, -1)``.

    ``corpus_valid``: optional bool ``[N]``; False rows never appear in
    results. ``precision``: "highest" (exact f32), "default" or
    "bfloat16" (bf16-rounded operands, f32 sums); "int8" is not ported.

    CPU tensors run ``flat_topk_plain``; CUDA tensors run the kernel, which
    serves ``k <= MAX_K``.
    """
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return flat_topk_plain(
            queries, corpus, k, metric=metric, corpus_valid=corpus_valid,
            precision=precision,
        )
    return flat_topk_cuda(
        queries, corpus, k, metric=metric, corpus_valid=corpus_valid,
        precision=precision,
    )
