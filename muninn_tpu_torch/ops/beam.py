"""Gather + dots for the HNSW beam: a hand-written CUDA kernel and its plain
PyTorch version.

Port of ``muninn_tpu/ops/pallas_beam.py`` ``gather_block_dots``. For each
(query, pick) it reads one contiguous ``[R0, d]`` block of the packed
neighbour table and emits the query's dot with every row and the row's
squared norm; the metric epilogue stays with the caller
(``index/hnsw.py``). The kernel (``csrc/beam_dots.cu``) replaces
``_beam_dots_kernel``; the plain version ``gather_block_dots_plain``
gathers the blocks and reduces them with exact f32 products, as JAX's
packed, not fused branch does (``hnsw.py:375-384``). Blocks are f32, bf16
or int8; int8 blocks (HNSW int8 guidance) are multiplied as stored, and the
caller scales the results by each neighbour's dequantization scale.

``gather_block_dots`` picks the path by the tensors' device: CPU tensors
go to the plain version, CUDA tensors to the kernel. On a CUDA tensor there
is no fallback: no ``nvcc``, a failed build or a refused launch raises.
The TPU kernel's alignment limits (``d % 128``, ``R0 %`` sublanes) do not
apply: the CUDA kernel takes any ``d`` and ``R0``.
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.distance import batched_f32_dots, squared_norms

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


_LIB: ctypes.CDLL | None = None  # the bound library, loaded at first launch


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("beam_dots")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.beam_dots.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.beam_dots.restype = i32
        lib.beam_dots_error_string.argtypes = [i32]
        lib.beam_dots_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def gather_block_dots_cuda(
    queries: torch.Tensor, idx: torch.Tensor, packed: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the gather + dots kernel. Takes contiguous CUDA tensors on one
    card: queries f32, idx int32 with every live pick below ``cap``, packed
    f32, bf16 or int8. Raises on anything else, and on a failed build or
    launch.
    A pick at or above ``cap`` reads nothing and writes NaN."""
    _check(queries, idx, packed)
    tensors = {"queries": queries, "idx": idx, "packed": packed}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"gather_block_dots_cuda takes CUDA tensors, got {name} on"
                f" {t.device}"
            )
        if t.device != queries.device:
            raise ValueError(
                f"{name} on {t.device} but queries on {queries.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"gather_block_dots_cuda takes a contiguous {name}")
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
    dev = queries.device
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
    if rc != 0:
        raise RuntimeError(
            f"beam_dots kernel launch failed: CUDA error {rc}"
            f" ({lib.beam_dots_error_string(rc).decode()})"
        )
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
