"""Row gather ``table[idx]``: a hand-written CUDA kernel and its plain
PyTorch version.

Port of ``muninn_tpu/ops/pallas_gather.py`` ``gather_rows``, the TPU's
pipelined per-row DMA gather. As in the JAX package no production path
calls it: it is the yardstick question of whether a hand-written gather
beats the library's, here ``torch.index_select``. The kernel
(``csrc/gather_rows.cu``) takes any ``M`` and any row width (no row block,
no tile padding) for f32, bf16 and int8 tables and is bitwise equal to the
plain version.

``gather_rows`` picks the path by the tensors' device: CPU tensors go to
``gather_rows_plain``, CUDA tensors to the kernel, which raises instead of
falling back.
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.beam import check_cuda

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(
            "gather_rows takes table [N, d] and idx [M], got"
            f" {tuple(table.shape)} and {tuple(idx.shape)}"
        )
    if table.dtype not in _DTYPES:
        raise ValueError(
            f"gather_rows takes an f32, bf16 or int8 table, got {table.dtype}"
        )


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, ``[M, d]`` of the table's type. Raises ``IndexError``
    on an index outside ``[0, N)`` (where plain indexing would wrap a
    negative one)."""
    _check(table, idx)
    idx = idx.long()
    if idx.numel() and bool((idx.min() < 0) | (idx.max() >= table.shape[0])):
        raise IndexError(f"gather_rows: an index outside [0, {table.shape[0]})")
    return table[idx]


_LIB: ctypes.CDLL | None = None  # the bound library, loaded at first launch


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("gather_rows")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gather_rows.argtypes = [ptr] * 3 + [ctypes.c_longlong] + [i32] * 4 + [ptr]
        lib.gather_rows.restype = i32
        lib.gather_rows_error_string.argtypes = [i32]
        lib.gather_rows_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the row-gather kernel. Takes a contiguous CUDA table (f32,
    bf16 or int8) and int32 idx on one card; raises on anything else, and
    on a failed build or launch. An index outside ``[0, N)`` reads nothing
    and fills its output row with 0xFF bytes (NaN for f32 and bf16, -1 for
    int8)."""
    _check(table, idx)
    dev = check_cuda("gather_rows_cuda", {"table": table, "idx": idx})
    if idx.dtype != torch.int32:
        raise ValueError(f"gather_rows_cuda takes int32 idx, got {idx.dtype}")
    n, d = table.shape
    out = torch.empty((idx.shape[0], d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         idx.shape[0], n, d, table.element_size(), dev.index,
                         stream)
    if rc != 0:
        raise RuntimeError(
            f"gather_rows kernel launch failed: CUDA error {rc}"
            f" ({lib.gather_rows_error_string(rc).decode()})"
        )
    _build.LAUNCHES["gather_rows"] += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]``, ``[M, d]`` of the table's type, for ``idx`` in
    ``[0, N)``. CPU tensors run ``gather_rows_plain``; CUDA tensors run the
    kernel."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return gather_rows_cuda(table, idx)
