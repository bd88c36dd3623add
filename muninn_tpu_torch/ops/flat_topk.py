"""Smallest-k over a corpus: a hand-written CUDA kernel and its plain
PyTorch version.

Port of ``muninn_tpu/ops/pallas_flat.py``:

- ``flat_topk`` in its float forms, ``precision="highest"`` (exact f32
  operands) and ``"default"`` / ``"bfloat16"`` (operands rounded to bf16,
  products summed in f32: what one bf16 MXU pass computes on the TPU);
- its int8 form: ``flat_topk_int8`` over an int8-stored corpus, and
  ``flat_topk(precision="int8")``, which quantizes both sides per call;
- the two-tier searches on top of it, ``flat_topk_int8_rescored`` and
  ``flat_topk_proj_rescored`` (an int8 retrieve of ``r`` candidates, then an
  exact f32 rescore), and ``proj_basis``.

Two kernels replace the branches of ``_flat_topk_kernel``, each with the
top-k beside its accumulators: the f32 ``highest`` mode runs on CUDA cores
(``csrc/flat_topk.cu``, its tiling chosen by ``f32_plan``), the bf16 and
int8 modes on the tensor cores (``csrc/flat_topk_mma.cu``, ``mma_plan``).
The plain versions ``flat_topk_plain`` and ``flat_topk_int8_plain`` mirror
``_xla_topk``.

The wrappers pick the path by the tensors' device: CPU tensors go to the
plain version, CUDA tensors to the kernel. On a CUDA tensor there is no
fallback: no ``nvcc``, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.distance import (
    _EPS_NORM,
    METRIC_CODE,
    Metric,
    exact_f32_dots,
    gathered_distances,
    int8_dots,
    parse_metric,
    quantize_rows_int8,
    squared_norms,
    unit_rows,
)
from muninn_tpu_torch.ops.topk import masked_topk, merge_topk, sorted_topk_unique

MAX_K = 1024  # the kernels' largest k; kMaxK in both sources
_CHUNK = 65536  # corpus rows per product in the plain version: [B, _CHUNK] peak
_OP_F32, _OP_BF16, _OP_INT8 = 0, 1, 2  # operand modes; 1, 2: flat_topk_mma.cu
_INF = float("inf")

# csrc/flat_topk_mma.cu's geometry: bytes of K per pipeline stage (64 bf16 or
# 128 int8), corpus rows per tile, columns between candidate-region checks,
# the most stages, and the dynamic shared memory a block may use (H100).
MMA_CHUNK_BYTES = 128
MMA_TILE_ROWS = 128
MMA_CHECK = 16
MMA_MAX_STAGES = 6
SMEM_LIMIT = 232448

# csrc/flat_topk.cu's geometry: corpus rows per tile, features per stage and
# the words of one staged row (the features and 4 words of pad), the query
# tiles it is built for, and its ring depths.
F32_TILE_ROWS = 256
F32_ROW_WORDS = 32 + 4
F32_QUERY_TILES = (128, 64, 32, 16, 8)
F32_MIN_STAGES, F32_MAX_STAGES = 2, 4


def f32_check_cols(tq: int) -> int:
    """Columns a query row can gain in one of the f32 kernel's checks: the
    lanes of a warp that share its rows (16 when a warp owns two or more
    query rows, else 32)."""
    return 16 if tq >= 16 else 32


def f32_plan(k: int, b: int) -> tuple[int, int, int]:
    """The f32 kernel's tiling for ``k`` and ``b`` queries: ``(tq, w,
    stages)``.

    ``w``, the per-query buffer (top-k, then candidates), is the least power
    of two holding k plus one check's columns; ``tq``, the queries per
    block, is the largest of 128, 64, 32, 16 and 8 that is not above b's
    power of two (a small batch multiplies no empty query rows) and whose
    buffers leave room for a ring of 3 stages, else of ``F32_MIN_STAGES``
    (at k near 1,024); ``stages``: as many as fit, at most
    ``F32_MAX_STAGES``. A stage holds 32 features of any d, so the plan does
    not depend on d."""
    _check_k(k)
    most = max(F32_QUERY_TILES[-1], 1 << (max(b, 1) - 1).bit_length())
    for least in (3, F32_MIN_STAGES):
        for tq in F32_QUERY_TILES:
            if tq > most:
                continue
            w = 1 << (k + f32_check_cols(tq) - 1).bit_length()
            room = SMEM_LIMIT - f32_smem_bytes(tq, w, 0)
            stages = min(F32_MAX_STAGES, max(room, 0) // _f32_stage_bytes(tq))
            if stages >= least:
                return tq, w, stages
    raise ValueError(f"no f32 plan fits k={k}")


def _f32_stage_bytes(tq: int) -> int:
    """One ring stage: 32 features of the query tile and the corpus tile,
    and a tile's penalty and cosine scale rows."""
    return (tq + F32_TILE_ROWS) * F32_ROW_WORDS * 4 + 2 * F32_TILE_ROWS * 4


def f32_smem_bytes(tq: int, w: int, stages: int) -> int:
    """Dynamic shared memory of one f32 block (``smem_bytes`` in the
    source): the ring, the per-query buffers ``[tq, w]`` of (f32, int32),
    counts and thresholds."""
    return stages * _f32_stage_bytes(tq) + tq * w * 8 + tq * 8


def mma_plan(k: int, d: int, op: int) -> tuple[int, int, int, int]:
    """The tensor-core kernel's tiling for ``k`` and ``d`` features of
    operand mode ``op``: ``(tq, w, stages, a_chunks)``.

    ``w``, the per-query buffer (top-k, then candidates), is the power of
    two holding k plus one check's ``MMA_CHECK`` columns; ``tq``, the
    queries per block, is 128 (two consumer warpgroups) down to 8 (one,
    its other rows idle), so the buffers take 64 KB (128 KB at k > 1008).
    The query tile stays resident in shared memory (``a_chunks``, its
    128-byte chunks of K) where that leaves a ring of at least 3 stages;
    otherwise it streams through the ring beside the corpus (``a_chunks``
    0), which serves any d. ``stages``: as many as fit, at most 6."""
    _check_k(k)
    w = 1 << (k + MMA_CHECK - 1).bit_length()
    tq = max(8, min(128, 8192 // w))
    nc = 2 if tq == 128 else 1
    n_chunks = -(-d * (2 if op == _OP_BF16 else 1) // MMA_CHUNK_BYTES)
    for a_chunks, least in ((n_chunks, 3), (0, 2)):
        room = SMEM_LIMIT - mma_smem_bytes(tq, w, 0, a_chunks)
        stages = min(MMA_MAX_STAGES,
                     max(room, 0) // _mma_stage_bytes(nc, a_chunks == 0))
        if stages >= least:
            return tq, w, stages, a_chunks
    raise ValueError(f"no tensor-core plan fits k={k}, d={d}")


def _mma_stage_bytes(nc: int, streamed: bool) -> int:
    """One ring stage: the queries' chunk ``[64 nc, 128 B]`` when they
    stream, the corpus chunk ``[128, 128 B]``, the tile's penalty and scale
    rows."""
    rows = (64 * nc if streamed else 0) + MMA_TILE_ROWS
    return rows * MMA_CHUNK_BYTES + 2 * MMA_TILE_ROWS * 4


def mma_smem_bytes(tq: int, w: int, stages: int, a_chunks: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source):
    the resident query chunks, the ring, its barriers, the per-query
    buffers ``[tq, w]`` of (f32, int32), counts and thresholds, each
    consumer warpgroup's copy of a tile's penalty and scale, and 1 KB to
    align the ring."""
    nc = 2 if tq == 128 else 1
    return (a_chunks * 64 * nc * MMA_CHUNK_BYTES
            + stages * _mma_stage_bytes(nc, a_chunks == 0)
            + 128 + tq * w * 8 + tq * 8 + nc * 1024 + 1024)


def mma_rows(x: torch.Tensor, op: int) -> torch.Tensor:
    """Rows as the tensor-core kernel reads them: ``[n, d]`` f32 rounded to
    bf16 (round to nearest even), or int8 as given, zero-padded to whole
    ``MMA_CHUNK_BYTES`` of K, so every stage is one aligned copy; a zero
    adds nothing to a dot. The queries always take this form; in the bf16
    mode the corpus too, once per call (an int8 corpus is read in place)."""
    dtype = torch.bfloat16 if op == _OP_BF16 else torch.int8
    per = MMA_CHUNK_BYTES // (2 if op == _OP_BF16 else 1)
    n, d = x.shape
    out = torch.zeros((n, -(-d // per) * per), dtype=dtype, device=x.device)
    out[:, :d] = x.to(dtype)
    return out


def bf16_operands(precision: str) -> bool:
    """Whether ``precision`` ranks by bf16-rounded operands: False for
    "highest", True for "default" and "bfloat16". On the TPU "default" is
    one bf16 MXU pass over f32 inputs and "bfloat16" casts the inputs to
    bf16 before the same pass, so the two give the same numbers."""
    if precision == "highest":
        return False
    if precision in ("default", "bfloat16"):
        return True
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
    scales by 1/|c| of the f32 row, as the kernel does. ``"int8"``: both
    sides quantized per call, then ``flat_topk_int8_plain``."""
    metric = parse_metric(metric)
    if precision == "int8":
        return flat_topk_int8_plain(
            queries, *_quantized_corpus(corpus, metric), k, metric=metric,
            corpus_valid=corpus_valid,
        )
    bf16 = bf16_operands(precision)
    q = queries.float()
    c = corpus.float()
    cs = None
    if metric is Metric.COSINE:
        # pre-normalise so the cosine distance is 1 - dot; the bf16 mode
        # rounds the raw corpus row and folds 1/|c| in after the product
        q = unit_rows(q)
        if bf16:
            cs = _inv_norms(c)
        else:
            c = unit_rows(c)
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


_LIB: ctypes.CDLL | None = None  # csrc/flat_topk.cu, loaded at first launch
_MMA_LIB: ctypes.CDLL | None = None  # csrc/flat_topk_mma.cu


def _library() -> ctypes.CDLL:
    """The f32 kernel's library (``highest``)."""
    global _LIB
    if _LIB is None:
        lib = _build.library("flat_topk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flat_topk_launch.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
        lib.flat_topk_launch.restype = i32
        lib.flat_topk_splits.argtypes = [i32] * 7
        lib.flat_topk_splits.restype = i32
        lib.flat_topk_smem_bytes.argtypes = [i32] * 3
        lib.flat_topk_smem_bytes.restype = ctypes.c_longlong
        _bind_common(lib, "flat_topk")
        _check_smem(lib.flat_topk_smem_bytes, f32_smem_bytes, "flat_topk",
                    [f32_plan(k, 8192) for k in (1, 10, 33, 100, 1009, MAX_K)]
                    + [f32_plan(10, b) for b in (1, 9, 33, 64)])
        _LIB = lib
    return _LIB


def _mma_library() -> ctypes.CDLL:
    """The tensor-core kernel's library (bf16 and int8 operands)."""
    global _MMA_LIB
    if _MMA_LIB is None:
        lib = _build.library("flat_topk_mma")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flat_topk_mma_launch.argtypes = [ptr] * 7 + [i32] * 12 + [ptr]
        lib.flat_topk_mma_launch.restype = i32
        lib.flat_topk_mma_splits.argtypes = [i32] * 10
        lib.flat_topk_mma_splits.restype = i32
        lib.flat_topk_mma_smem_bytes.argtypes = [i32] * 4
        lib.flat_topk_mma_smem_bytes.restype = ctypes.c_longlong
        _bind_common(lib, "flat_topk_mma")
        _check_smem(lib.flat_topk_mma_smem_bytes, mma_smem_bytes, "flat_topk_mma",
                    [mma_plan(k, d, _OP_BF16) for k, d in (
                        (1, 100), (16, 768), (33, 384), (100, 768), (MAX_K, 384))])
        _MMA_LIB = lib
    return _MMA_LIB


def _check_smem(in_source, in_python, prefix: str, plans) -> None:
    """The source's shared-memory count of each plan must be Python's."""
    for plan in plans:
        if in_source(*plan) != in_python(*plan):
            raise RuntimeError(
                f"csrc/{prefix}.cu asks {in_source(*plan)} bytes of shared"
                f" memory for plan {plan}, flat_topk.py counts {in_python(*plan)}"
            )


def _bind_common(lib: ctypes.CDLL, prefix: str) -> None:
    max_k = getattr(lib, f"{prefix}_max_k")
    max_k.argtypes = []
    max_k.restype = ctypes.c_int
    err = getattr(lib, f"{prefix}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    if max_k() != MAX_K:
        raise RuntimeError(
            f"csrc/{prefix}.cu serves k <= {max_k()}, but flat_topk.MAX_K is"
            f" {MAX_K}"
        )


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
    on anything else, and on a failed build or launch. ``"int8"`` quantizes
    both sides per call, then runs ``flat_topk_int8_cuda``."""
    metric = parse_metric(metric)
    if precision == "int8":
        _check_cuda(queries, corpus, "flat_topk_cuda")
        return flat_topk_int8_cuda(
            queries, *_quantized_corpus(corpus, metric), k, metric=metric,
            corpus_valid=corpus_valid,
        )
    bf16 = bf16_operands(precision)
    _check_k(k)
    # the f32 kernel reads the corpus in place (the bf16 mode makes one
    # padded bf16 copy per call); converting it here would copy it again
    if corpus.dtype != torch.float32 or not corpus.is_contiguous():
        raise ValueError(
            "flat_topk_cuda takes a contiguous float32 corpus, got"
            f" {corpus.dtype}{'' if corpus.is_contiguous() else ', strided'}"
        )
    _check_cuda(queries, corpus, "flat_topk_cuda")
    b, n = _check_shapes(queries, corpus, corpus_valid)
    dev = queries.device
    if b == 0:
        return _empty(k, dev)
    c = corpus
    q = queries.float()
    if metric is Metric.COSINE:
        q = unit_rows(q)
        cs = _inv_norms(c)
    else:
        cs = torch.empty(0, dtype=torch.float32, device=dev)
    q = q.contiguous()
    qn = squared_norms(q).contiguous()
    cp = _penalty_row(c, metric, corpus_valid).contiguous()
    cs = cs.contiguous()

    if bf16:
        return _launch(mma_rows(q, _OP_BF16), mma_rows(c, _OP_BF16), qn, cp,
                       cs, k, METRIC_CODE[metric], _OP_BF16, "flat_topk")
    return _launch(q, c, qn, cp, cs, k, METRIC_CODE[metric], _OP_F32,
                   "flat_topk")


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k={k}: the flat_topk CUDA kernel serves 1 <= k <= {MAX_K}"
        )


def _check_cuda(queries: torch.Tensor, corpus: torch.Tensor,
                name: str) -> None:
    if not (queries.is_cuda and corpus.is_cuda):
        raise ValueError(
            f"{name} takes CUDA tensors, got queries on"
            f" {queries.device} and corpus on {corpus.device}"
        )
    if queries.device != corpus.device:
        raise ValueError(
            f"queries on {queries.device} but corpus on {corpus.device}"
        )


def _check_shapes(queries: torch.Tensor, corpus: torch.Tensor,
                  corpus_valid: torch.Tensor | None) -> tuple[int, int]:
    b, d = queries.shape
    n, dc = corpus.shape
    if dc != d:
        raise ValueError(f"query dim {d} != corpus dim {dc}")
    if corpus_valid is not None and tuple(corpus_valid.shape) != (n,):
        raise ValueError(
            f"corpus_valid has shape {tuple(corpus_valid.shape)}, want ({n},)"
        )
    return b, n


def _empty(k: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((0, k), dtype=torch.float32, device=dev),
            torch.empty((0, k), dtype=torch.int32, device=dev))


def _launch(q, c, qn, cp, cs, k: int, mode: int, op: int, name: str):
    """One launch of the kernel of operand mode ``op`` over contiguous CUDA
    operands (``[B, d]`` and ``[N, d]`` f32 for ``highest``; else as
    ``mma_rows`` pads them, or an int8 corpus as stored), then the merge of
    the per-split partials by their kernel values. Counts the launch under
    ``LAUNCHES[name]``, and a tensor-core launch also under
    ``LAUNCHES["flat_topk_mma"]``."""
    b = q.shape[0]
    n, d = c.shape
    dev = q.device
    if op == _OP_F32:
        lib, prefix = _library(), "flat_topk"
        plan = f32_plan(k, b)
        splits = lib.flat_topk_splits(b, n, k, *plan, dev.index)
    else:
        lib, prefix = _mma_library(), "flat_topk_mma"
        plan = (op, *mma_plan(k, d, op))
        splits = lib.flat_topk_mma_splits(b, n, d, k, *plan, dev.index)
    if splits < 1:
        raise RuntimeError(
            f"{prefix}: querying {dev} failed: CUDA error {-splits}"
            f" ({getattr(lib, f'{prefix}_error_string')(-splits).decode()})"
        )
    out_d = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, f"{prefix}_launch")(
        q.data_ptr(), c.data_ptr(), qn.data_ptr(), cp.data_ptr(),
        cs.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        b, n, d, k, mode, *plan, splits, dev.index, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{prefix} kernel launch failed: CUDA error {rc}"
            f" ({getattr(lib, f'{prefix}_error_string')(rc).decode()})"
        )
    _build.LAUNCHES[name] += 1
    if op != _OP_F32:
        _build.LAUNCHES["flat_topk_mma"] += 1
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
    "bfloat16" (bf16-rounded operands, f32 sums), or "int8" (both sides
    quantized per call, ``flat_topk_int8``'s distances; cosine and inner
    product only).

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


# ───────────────────────── int8 ─────────────────────────


def _quantized_corpus(corpus: torch.Tensor, metric: Metric):
    """The corpus as ``flat_topk(precision="int8")`` quantizes it per call
    (``pallas_flat.py:302-311``): cosine rows normalised first."""
    if metric is Metric.L2:
        raise ValueError("precision='int8' supports cosine/inner_product")
    return quantize_rows_int8(corpus, normalize=metric is Metric.COSINE)


def _int8_queries(queries: torch.Tensor, metric: Metric):
    """Unit queries for cosine, then per-row int8: ``(qi int8 [B, d],
    qs f32 [B])``, as ``flat_topk_int8`` prepares them (``:416-422``)."""
    if metric is Metric.L2:
        raise ValueError("int8 storage supports cosine/inner_product")
    q = queries.float()
    if metric is Metric.COSINE:
        q = unit_rows(q)
    return quantize_rows_int8(q)


def _int8_penalty(n: int, corpus_valid: torch.Tensor | None,
                  device: torch.device) -> torch.Tensor:
    cp = torch.zeros(n, dtype=torch.float32, device=device)
    if corpus_valid is None:
        return cp
    return torch.where(corpus_valid.to(torch.bool), cp, _INF)


def _int8_emit(sd: torch.Tensor, si: torch.Tensor, qs: torch.Tensor,
               metric: Metric) -> tuple[torch.Tensor, torch.Tensor]:
    """Rescale the k rank-only survivors to distances, ``base + qs * sd``
    with base 1 for cosine and 0 for inner product (``pallas_flat.py:171-
    179``). A masked slot is decided from ``sd`` before the rescale: an
    all-zero query has ``qs = 0``, and ``0 * inf`` would be NaN."""
    base = 1.0 if metric is Metric.COSINE else 0.0
    masked = torch.isinf(sd)
    vals = base + qs[:, None] * sd
    return (torch.where(masked, _INF, vals),
            torch.where(masked, -1, si))


def flat_topk_int8_plain(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    corpus_scale: torch.Tensor,
    k: int,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernel's arithmetic in plain PyTorch, as ``_xla_topk``'s int8
    branch computes it (``pallas_flat.py:204-211``, ``:231-237``): exact
    integer dots (``int8_dots``), the rank-only tile ``cp - f32(dot) * cs``
    (each step rounded), ``masked_topk``/``merge_topk`` over ``_CHUNK``-row
    chunks, then ``_int8_emit``. Returns ``(dists [B, k] f32, ids [B, k]
    int32)`` sorted ascending, ``(inf, -1)`` where fewer than k rows are
    live."""
    metric = parse_metric(metric)
    qi, qs = _int8_queries(queries, metric)
    cs = corpus_scale.float()
    n = corpus_i8.shape[0]
    cp = _int8_penalty(n, corpus_valid, qi.device)
    b = qi.shape[0]
    bd = torch.full((b, k), _INF, dtype=torch.float32, device=qi.device)
    bi = torch.full((b, k), -1, dtype=torch.int32, device=qi.device)
    for lo in range(0, n, _CHUNK):
        dots = int8_dots(qi, corpus_i8[lo : lo + _CHUNK])
        tile = cp[None, lo : lo + _CHUNK] - dots * cs[None, lo : lo + _CHUNK]
        ids = torch.arange(lo, lo + tile.shape[1], dtype=torch.int32,
                           device=qi.device)
        td, ti = masked_topk(tile, k, ids=ids)
        bd, bi = merge_topk(bd, bi, td, ti)
    return _int8_emit(bd, bi, qs, metric)


def flat_topk_int8_cuda(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    corpus_scale: torch.Tensor,
    k: int,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel in its int8 mode. CUDA tensors only: a contiguous
    int8 corpus and its f32 scales, read in place. Raises on anything else,
    and on a failed build or launch."""
    metric = parse_metric(metric)
    _check_k(k)
    if corpus_i8.dtype != torch.int8 or not corpus_i8.is_contiguous():
        raise ValueError(
            "flat_topk_int8_cuda takes a contiguous int8 corpus, got"
            f" {corpus_i8.dtype}{'' if corpus_i8.is_contiguous() else ', strided'}"
        )
    _check_cuda(queries, corpus_i8, "flat_topk_int8_cuda")
    b, n = _check_shapes(queries, corpus_i8, corpus_valid)
    if tuple(corpus_scale.shape) != (n,):
        raise ValueError(
            f"corpus_scale has shape {tuple(corpus_scale.shape)}, want ({n},)"
        )
    qi, qs = _int8_queries(queries, metric)
    if b == 0:
        return _empty(k, qi.device)
    cp = _int8_penalty(n, corpus_valid, qi.device)
    cs = corpus_scale.float().contiguous()
    unused_qn = torch.empty(0, dtype=torch.float32, device=qi.device)
    sd, si = _launch(mma_rows(qi, _OP_INT8), corpus_i8, unused_qn, cp, cs,
                     k, METRIC_CODE[metric], _OP_INT8, "flat_topk_int8")
    return _int8_emit(sd, si, qs, metric)


def flat_topk_int8(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    corpus_scale: torch.Tensor,
    k: int,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k over an int8-stored corpus (``pallas_flat.py:389``):
    queries ``[B, d]`` f32, quantized per call (cosine: normalised first);
    ``corpus_i8 [N, d]`` int8 rows with per-row f32 scales ``corpus_scale``
    (for cosine, rows normalised before quantization, as
    ``quantize_rows_int8(..., normalize=True)`` does). Cosine and inner
    product only; distances are quantized-dot approximations. Returns
    ``(dists [B, k] f32, ids [B, k] int32)`` ascending, ``(inf, -1)`` on
    empty slots.

    CPU tensors run ``flat_topk_int8_plain``; CUDA tensors run the kernel,
    which serves ``k <= MAX_K``."""
    fn = flat_topk_int8_plain
    if not (queries.device.type == "cpu" and corpus_i8.device.type == "cpu"):
        fn = flat_topk_int8_cuda
    return fn(queries, corpus_i8, corpus_scale, k, metric=metric,
              corpus_valid=corpus_valid)


def rescore(queries: torch.Tensor, corpus: torch.Tensor, cand: torch.Tensor,
            k: int, metric: Metric | str) -> tuple[torch.Tensor, torch.Tensor]:
    """The rescored searches' second tier (``pallas_flat.py:525-528``):
    exact f32 distances of each (cosine: unit) query's candidates ``cand
    [B, r]`` (-1: none) against ``corpus``, then the unique top-k."""
    metric = parse_metric(metric)
    q = queries.float()
    if metric is Metric.COSINE:
        q = unit_rows(q)
    d = gathered_distances(q, corpus[cand.clamp(min=0).long()], metric)
    d = torch.where(cand >= 0, d, _INF)
    return sorted_topk_unique(d, cand, k)


def int8_candidates(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    corpus_scale: torch.Tensor,
    r: int,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """``int8_rescored``'s first tier: the ``flat_topk_int8`` top-``r``
    slots ``[B, r]`` int32, sorted by the int8 ranking."""
    return flat_topk_int8(queries, corpus_i8, corpus_scale, r, metric=metric,
                          corpus_valid=corpus_valid)[1]


def flat_topk_int8_rescored(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_i8: torch.Tensor,
    corpus_scale: torch.Tensor,
    k: int,
    r: int = 64,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-tier search (``pallas_flat.py:493``): ``flat_topk_int8``
    retrieves the top-``r`` candidates from the int8 shadow, an exact f32
    rescore against ``corpus`` picks the final ``k``."""
    cand = int8_candidates(queries, corpus_i8, corpus_scale, r, metric=metric,
                           corpus_valid=corpus_valid)
    return rescore(queries, corpus, cand, k, metric)


def proj_basis(corpus: torch.Tensor, dp: int, chunk: int = 65536) -> torch.Tensor:
    """Top-``dp`` uncentred principal directions of ``corpus`` as a
    ``[d, dp]`` f32 matrix, leading first (``pallas_flat.py:531``): the
    second-moment matrix summed over corpus chunks in exact f32, then
    ``torch.linalg.eigh``. Columns are eigenvectors up to sign."""
    n, d = corpus.shape
    if not 0 < dp <= d:
        raise ValueError(f"proj dim {dp} must be in (0, {d}]")
    m = torch.zeros((d, d), dtype=torch.float32, device=corpus.device)
    for lo in range(0, n, chunk):
        xc = corpus[lo : lo + chunk].float()
        m += exact_f32_dots(xc.T.contiguous(), xc.T.contiguous())
    _, vecs = torch.linalg.eigh(m)  # ascending eigenvalues
    return vecs[:, -dp:].flip(1).contiguous()


def proj_candidates(
    queries: torch.Tensor,
    proj: torch.Tensor,
    proj_i8: torch.Tensor,
    proj_scale: torch.Tensor,
    r: int,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """``proj_rescored``'s first tier: the (cosine: unit) queries projected
    by ``proj [d, dp]``, then the ``flat_topk_int8`` top-``r`` of the int8
    projected rows ``proj_i8 [N, dp]`` by inner product: slots ``[B, r]``
    int32. Cosine and inner product only."""
    metric = parse_metric(metric)
    if metric is Metric.L2:
        raise ValueError("proj_rescored supports cosine/inner_product")
    q = queries.float()
    if metric is Metric.COSINE:
        q = unit_rows(q)
    qp = exact_f32_dots(q, proj.T.contiguous())
    return flat_topk_int8(qp, proj_i8, proj_scale, r,
                          metric=Metric.INNER_PRODUCT,
                          corpus_valid=corpus_valid)[1]


def flat_topk_proj_rescored(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    proj: torch.Tensor,
    proj_i8: torch.Tensor,
    proj_scale: torch.Tensor,
    k: int,
    r: int = 32,
    *,
    metric: Metric | str = Metric.COSINE,
    corpus_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-tier search through a projection (``pallas_flat.py:564``):
    ``proj_candidates`` retrieves ``r`` candidates, and an exact f32
    rescore against ``corpus`` picks the final ``k``."""
    cand = proj_candidates(queries, proj, proj_i8, proj_scale, r,
                           metric=metric, corpus_valid=corpus_valid)
    return rescore(queries, corpus, cand, k, metric)
