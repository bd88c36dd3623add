"""Gather + dots, and gather + distances + per-pick top-m, for the HNSW beam:
hand-written CUDA kernels and their plain PyTorch versions.

Ports of ``muninn_tpu/ops/pallas_beam.py``:

- ``gather_block_dots``: for each (query, pick) read one contiguous
  ``[R0, d]`` block of the packed neighbour table and emit the query's dot
  with every row and the row's squared norm; the metric epilogue stays with
  the caller (``index/hnsw.py``). Replaces ``_beam_dots_kernel``. The plain
  version ``gather_block_dots_plain`` gathers the blocks and reduces them
  with exact f32 products, as JAX's packed, not fused branch does
  (``hnsw.py:375-384``). Blocks are f32, bf16 or int8; int8 blocks (HNSW
  int8 guidance) are multiplied as stored, and the caller scales the
  results by each neighbour's dequantization scale.
- ``gather_block_topm``: the same gather, with the metric epilogue
  (``packed_distances``), an additive penalty and a per-pick top-m in the
  kernel, so only ``m`` (distance, local index) pairs per pick leave it.
  Replaces ``_beam_topm_kernel``. f32 and bf16 blocks only, as JAX's caller
  never passes int8 ones (``hnsw.py:225-227``).

Both kernels live in ``csrc/beam_dots.cu`` (the top-m one is a mode of the
same gather). Each public function picks the path by the tensors' device:
CPU tensors go to the plain version, CUDA tensors to the kernel. On a CUDA
tensor there is no fallback: no ``nvcc``, a failed build or a refused
launch raises. The TPU kernels' alignment limits (``d % 128``, ``R0 %``
sublanes) do not apply: the CUDA kernels take any ``d`` and ``R0``.
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.distance import (
    _EPS_NORM,
    METRIC_CODE,
    Metric,
    batched_f32_dots,
    parse_metric,
    squared_norms,
)

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
BIG = 3.0e38  # the top-m kernel's mask value; >= BIG/2 is masked-out padding


def _check(queries: torch.Tensor, idx: torch.Tensor,
           packed: torch.Tensor) -> None:
    if queries.ndim != 2 or idx.ndim != 2 or packed.ndim != 3:
        raise ValueError(
            "gather_block_dots takes queries [B, d], idx [B, E] and packed"
            f" [cap, R0, d], got {tuple(queries.shape)}, {tuple(idx.shape)}"
            f" and {tuple(packed.shape)}"
        )
    if packed.shape[2] != queries.shape[1]:
        raise ValueError(
            f"packed dim {packed.shape[2]} != query dim {queries.shape[1]}"
        )
    if idx.shape[0] != queries.shape[0]:
        raise ValueError(
            f"idx has {idx.shape[0]} rows for {queries.shape[0]} queries"
        )


def gather_block_dots_plain(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``dots[b, j] = <queries[b], packed[idx[b, j // R0]][j % R0]>`` and
    ``cn2[b, j]`` that row's squared norm, both ``[B, E*R0]`` f32 from
    exact f32 products of the stored values; lanes of a dead pick
    (``idx < 0``) are exactly 0."""
    _check(queries, idx, packed)
    b, e = idx.shape
    r0 = packed.shape[1]
    idx = idx.long()
    blocks = packed[idx.clamp(min=0)].float().reshape(b, e * r0, -1)
    dots = batched_f32_dots(queries.float(), blocks)
    cn2 = squared_norms(blocks)
    live = (idx >= 0).repeat_interleave(r0, dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=dots.device)
    return torch.where(live, dots, zero), torch.where(live, cn2, zero)


def packed_distances(dots: torch.Tensor, cn2: torch.Tensor, qn2: torch.Tensor,
                     metric: Metric) -> torch.Tensor:
    """The metric over ``gather_block_dots``' (dots, cn2) and the queries'
    squared norms ``qn2 [B, 1]``, the same math as ``gathered_distances``
    on the gathered rows (``hnsw.py:246-257``, ``pallas_beam.py:262-275``):
    l2 ``max(qn2 + cn2 - 2 dots, 0)``; cosine ``1 - dots / max(|q||c|,
    1e-30)`` with similarity 0 below the guard; inner product ``-dots``.
    The kernels repeat these steps with one rounding each."""
    if metric is Metric.INNER_PRODUCT:
        return -dots
    if metric is Metric.L2:
        return torch.clamp(qn2 + cn2 - 2.0 * dots, min=0.0)
    denom = torch.sqrt(qn2) * torch.sqrt(cn2)
    sim = torch.where(denom < _EPS_NORM, torch.zeros_like(dots),
                      dots / torch.clamp(denom, min=_EPS_NORM))
    return 1.0 - sim


def _check_topm(queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor,
                penalty: torch.Tensor, m: int) -> None:
    _check(queries, idx, packed)
    b, e = idx.shape
    r0 = packed.shape[1]
    if tuple(penalty.shape) != (b, e * r0):
        raise ValueError(
            f"penalty has shape {tuple(penalty.shape)}, want {(b, e * r0)}"
        )
    if not 0 < m <= r0:
        raise ValueError(f"m={m} must be in (0, R0={r0}]")
    if packed.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"gather_block_topm takes f32 or bf16 blocks, got {packed.dtype}"
        )


def gather_block_topm_plain(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor,
    penalty: torch.Tensor, metric: Metric | str = Metric.COSINE, m: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per pick, the ``m`` smallest of ``packed_distances + penalty`` over
    its ``R0`` rows: ``(dists [B, E, m] f32 ascending, local [B, E, m]
    int32)``. Selection is the TPU kernel's (``pallas_beam.py:276-288``):
    ``m`` rounds of min, lowest-index argmin, set the chosen entry to
    ``BIG``; entries at or above ``BIG/2`` are masked-out padding, whose
    local indices may repeat. A dead pick (``idx < 0``) gives ``(BIG, 0)``.
    """
    metric = parse_metric(metric)
    _check_topm(queries, idx, packed, penalty, m)
    b, e = idx.shape
    r0 = packed.shape[1]
    qf = queries.float()
    dots, cn2 = gather_block_dots_plain(qf, idx, packed)
    dist = packed_distances(dots, cn2, squared_norms(qf)[:, None], metric)
    dist = (dist + penalty.float()).reshape(b, e, r0)
    iota = torch.arange(r0, device=dist.device)
    big = torch.full((), BIG, dtype=torch.float32, device=dist.device)
    ds, ls = [], []
    for _ in range(m):
        mn = dist.amin(dim=2, keepdim=True)
        loc = torch.where(dist == mn, iota, r0).amin(dim=2, keepdim=True)
        ds.append(mn)
        ls.append(loc)
        dist = torch.where(iota == loc, big, dist)
    dead = (idx < 0)[:, :, None]
    md = torch.where(dead, big, torch.cat(ds, dim=2))
    ml = torch.where(dead, 0, torch.cat(ls, dim=2)).to(torch.int32)
    return md, ml


_LIB: ctypes.CDLL | None = None  # the bound library, loaded at first launch


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("beam_dots")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.beam_dots.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.beam_dots.restype = i32
        lib.beam_topm.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
        lib.beam_topm.restype = i32
        lib.beam_dots_error_string.argtypes = [i32]
        lib.beam_dots_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_cuda(fn: str, tensors: dict[str, torch.Tensor]) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on the device
    of the first; return that device."""
    first, dev = next((name, t.device) for name, t in tensors.items())
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{fn} takes CUDA tensors, got {name} on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device} but {first} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} takes a contiguous {name}")
    return dev


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {rc}"
            f" ({_library().beam_dots_error_string(rc).decode()})"
        )


def gather_block_dots_cuda(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the gather + dots kernel. Takes contiguous CUDA tensors on one
    card: queries f32, idx int32 with every live pick below ``cap``, packed
    f32, bf16 or int8. Raises on anything else, and on a failed build or
    launch.
    A pick at or above ``cap`` reads nothing and writes NaN."""
    _check(queries, idx, packed)
    dev = check_cuda("gather_block_dots_cuda",
                      {"queries": queries, "idx": idx, "packed": packed})
    if queries.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(
            "gather_block_dots_cuda takes f32 queries and int32 idx, got"
            f" {queries.dtype} and {idx.dtype}"
        )
    if packed.dtype not in _DTYPE:
        raise ValueError(
            "gather_block_dots_cuda takes f32, bf16 or int8 packed, got"
            f" {packed.dtype}"
        )
    b, e = idx.shape
    cap, r0, d = packed.shape
    dots = torch.empty((b, e * r0), dtype=torch.float32, device=dev)
    cn2 = torch.empty((b, e * r0), dtype=torch.float32, device=dev)
    if b == 0 or e == 0 or r0 == 0:
        return dots, cn2
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.beam_dots(
        queries.data_ptr(), idx.data_ptr(), packed.data_ptr(),
        dots.data_ptr(), cn2.data_ptr(),
        b, e, r0, d, cap, _DTYPE[packed.dtype], dev.index, stream,
    )
    _raise_on(rc, "beam_dots")
    _build.LAUNCHES["beam_dots_int8" if packed.dtype == torch.int8
                    else "beam_dots"] += 1
    return dots, cn2


def gather_block_dots(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pick block dots and row squared norms, ``[B, E*R0]`` f32 each
    (see ``gather_block_dots_plain``). ``idx`` -1 marks a dead pick: its
    block is not read and its lanes are 0.

    CPU tensors run ``gather_block_dots_plain``; CUDA tensors run the
    kernel."""
    if all(t.device.type == "cpu" for t in (queries, idx, packed)):
        return gather_block_dots_plain(queries, idx, packed)
    return gather_block_dots_cuda(queries, idx, packed)


def gather_block_topm_cuda(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor,
    penalty: torch.Tensor, metric: Metric | str = Metric.COSINE, m: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the gather + distances + top-m kernel. Takes contiguous CUDA
    tensors on one card: queries f32, idx int32 with every live pick below
    ``cap``, packed f32 or bf16, penalty f32. Raises on anything else, and
    on a failed build or launch. The kernel keeps a pick's ``R0`` distances
    in shared memory beside the query, so ``4 * (d + E*R0)`` bytes must fit
    a block (227 KB). A pick at or above ``cap`` reads nothing and writes
    NaN at local index 0."""
    metric = parse_metric(metric)
    _check_topm(queries, idx, packed, penalty, m)
    dev = check_cuda("gather_block_topm_cuda",
                      {"queries": queries, "idx": idx, "packed": packed,
                       "penalty": penalty})
    if (queries.dtype != torch.float32 or idx.dtype != torch.int32
            or penalty.dtype != torch.float32):
        raise ValueError(
            "gather_block_topm_cuda takes f32 queries and penalty and int32"
            f" idx, got {queries.dtype}, {penalty.dtype} and {idx.dtype}"
        )
    b, e = idx.shape
    cap, r0, d = packed.shape
    md = torch.empty((b, e, m), dtype=torch.float32, device=dev)
    ml = torch.empty((b, e, m), dtype=torch.int32, device=dev)
    if b == 0 or e == 0:
        return md, ml
    qn2 = squared_norms(queries)  # the plain version's, so both agree on it
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.beam_topm(
        queries.data_ptr(), qn2.data_ptr(), idx.data_ptr(), packed.data_ptr(),
        penalty.data_ptr(), md.data_ptr(), ml.data_ptr(),
        b, e, r0, d, cap, m, _DTYPE[packed.dtype], METRIC_CODE[metric], dev.index,
        stream,
    )
    _raise_on(rc, "beam_topm")
    _build.LAUNCHES["beam_topm"] += 1
    return md, ml


def gather_block_topm(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor,
    penalty: torch.Tensor, metric: Metric | str = Metric.COSINE, m: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gather + metric epilogue + additive ``penalty [B, E*R0]`` (+BIG
    drops a candidate) + per-pick top-m: ``(dists [B, E, m] ascending,
    local [B, E, m] int32)`` (see ``gather_block_topm_plain``). ``idx`` -1
    marks a dead pick: its block is not read and it gives ``(BIG, 0)``.

    CPU tensors run ``gather_block_topm_plain``; CUDA tensors run the
    kernel."""
    if all(t.device.type == "cpu" for t in (queries, idx, packed, penalty)):
        return gather_block_topm_plain(queries, idx, packed, penalty, metric, m)
    return gather_block_topm_cuda(queries, idx, packed, penalty, metric, m)
