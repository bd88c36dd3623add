"""The repair of an HNSW delete wave in one launch of a hand-written CUDA
kernel, and the gate that picks it.

``index/hnsw.py``'s ``_repair_rows`` is the plain version: in eager torch,
chunk by chunk, each affected row drops its edges to deleted slots and
merges in its ``kk`` closest rows of the repair pool (``flat_topk`` at
``highest``, the row itself masked, ``merge_topk``). ``delete_repair_cuda``
does the same for every affected row of a wave in one launch of
``csrc/delete_repair.cu``, bit for bit on the card where the row norms
round alike (see ``delete_repair_cuda``), reading the affected rows, the
pool and their counts where ``index/hnsw.py``'s ``_delete_lists`` left them
on the card, so the wave makes no host read. ``repair_engine`` says which of
the two a wave takes.
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.beam import check_cuda
from muninn_tpu_torch.ops.distance import (
    METRIC_CODE,
    Metric,
    parse_metric,
    squared_norms,
    unit_rows,
)
from muninn_tpu_torch.ops.flat_topk import (
    F32_MAX_STAGES,
    F32_MIN_STAGES,
    F32_QUERY_TILES,
    F32_ROW_WORDS,
    F32_TILE_ROWS,
    SMEM_LIMIT,
    _check_smem,
    _inv_norms,
    _penalty_row,
    f32_check_cols,
)

MAX_KK = 64  # the kernel's largest kk (kMaxK): a table of at most 63 edges a row
MAX_MERGE = 128  # edges plus candidates a row merges (kMerge)

_LIB: ctypes.CDLL | None = None


def repair_engine(vectors: torch.Tensor, kk: int) -> str:
    """``"kernel"`` where ``delete_repair_cuda`` repairs a wave: a CUDA
    float32 store with ``kk`` within ``MAX_KK``; ``"eager"`` otherwise (the
    CPU, another store type, wider rows). Reads only the store's device and
    type and ``kk``."""
    if vectors.device.type != "cuda" or vectors.dtype != torch.float32:
        return "eager"
    return "kernel" if 1 <= kk <= MAX_KK else "eager"


def repair_plan(kk: int) -> tuple[int, int, int]:
    """The kernel's tiling for ``kk``: ``(tq, w, stages)``, as
    ``flat_topk.f32_plan`` chooses it for a large batch, over stages that
    hold no penalty row: the largest tile of affected rows whose top-kk
    buffers (``w``, the least power of two holding kk plus one check's
    columns) leave a ring of 3 stages, else of 2; as many stages as fit, at
    most 4."""
    for least in (3, F32_MIN_STAGES):
        for tq in F32_QUERY_TILES:
            w = 1 << (kk + f32_check_cols(tq) - 1).bit_length()
            room = SMEM_LIMIT - repair_smem_bytes(tq, w, 0)
            stages = min(F32_MAX_STAGES, room // _stage_bytes(tq))
            if stages >= least:
                return tq, w, stages
    raise ValueError(f"no repair plan fits kk={kk}")


def _stage_bytes(tq: int) -> int:
    """One ring stage: 32 features of the tile's rows and of a pool tile."""
    return (tq + F32_TILE_ROWS) * F32_ROW_WORDS * 4


def repair_smem_bytes(tq: int, w: int, stages: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source):
    the ring, the per-row buffers ``[tq, w]`` of (f32, int32), counts and
    thresholds."""
    return stages * _stage_bytes(tq) + tq * w * 8 + tq * 8


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("delete_repair")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.delete_repair_launch.argtypes = [ptr] * 11 + [i32] * 11 + [ptr]
        lib.delete_repair_launch.restype = i32
        lib.delete_repair_error_string.argtypes = [i32]
        lib.delete_repair_error_string.restype = ctypes.c_char_p
        lib.delete_repair_smem_bytes.argtypes = [i32] * 3
        lib.delete_repair_smem_bytes.restype = ctypes.c_longlong
        for fn in (lib.delete_repair_max_k, lib.delete_repair_max_merge):
            fn.argtypes = []
            fn.restype = i32
        if (lib.delete_repair_max_k(), lib.delete_repair_max_merge()) != (
                MAX_KK, MAX_MERGE):
            raise RuntimeError(
                f"csrc/delete_repair.cu serves kk <= {lib.delete_repair_max_k()}"
                f" and merges {lib.delete_repair_max_merge()} entries a row, but"
                f" delete_repair.py says {MAX_KK} and {MAX_MERGE}"
            )
        _check_smem(lib.delete_repair_smem_bytes, repair_smem_bytes,
                    "delete_repair",
                    [repair_plan(k) for k in (1, 9, 17, 33, 48, 49, MAX_KK)])
        _LIB = lib
    return _LIB


def delete_repair_cuda(
    vectors: torch.Tensor,     # [H, d] f32: every affected row's slot below H
    aff: torch.Tensor,         # [A] int64 affected slots, ascending, -1 after
    pool: torch.Tensor,        # [P] int64 pool slots, ascending, -1 after
    counts: torch.Tensor,      # [2] int64: affected rows, pool rows
    dead: torch.Tensor,        # [cap] bool: the deleted slots
    neighbors0: torch.Tensor,  # [cap, M] int32, repaired in place
    dists0: torch.Tensor,      # [cap, M] f32, repaired in place
    kk: int,
    metric: Metric | str,
    keep_if_empty: bool,
) -> None:
    """Launch the repair kernel over one delete wave: each of the first
    ``counts[0]`` slots of ``aff`` drops its edges to ``dead`` slots and
    merges in its ``kk`` closest of the first ``counts[1]`` rows of
    ``pool`` (itself excluded), closest ``M`` kept, in place, as
    ``_repair_rows`` does. With an empty pool the rows drop their dead edges
    and keep the rest, or with ``keep_if_empty`` keep every edge.

    The pool's rows are gathered once, with the penalty row and cosine
    scales of ``flat_topk``'s ``highest`` mode; the affected rows are read
    by slot from ``vectors`` (for cosine from its unit rows). The distances
    are those of ``flat_topk``'s kernel bit for bit where the row norms,
    which torch reduces, round alike: torch picks its reduction's block
    width from the number of rows below 16 rows of more than 32 features,
    so a chunk of fewer rows in the plain version may round a norm
    otherwise.

    Raises on ``kk`` outside ``[1, MAX_KK]``, more than ``MAX_MERGE`` edges
    and candidates a row, a store that is not float32, tensors that are not
    contiguous CUDA tensors on one card or of other types or shapes, and on
    a failed build or launch."""
    metric = parse_metric(metric)
    cap, m = neighbors0.shape
    if not 1 <= kk <= MAX_KK or m + kk > MAX_MERGE:
        raise ValueError(
            f"delete_repair_cuda takes 1 <= kk <= {MAX_KK} and at most"
            f" {MAX_MERGE} edges and candidates a row, got kk={kk}, {m} edges"
        )
    if vectors.dtype != torch.float32 or vectors.ndim != 2:
        raise ValueError(
            f"delete_repair_cuda takes a [rows, d] float32 store, got"
            f" {vectors.dtype} {tuple(vectors.shape)}"
        )
    dev = check_cuda("delete_repair_cuda", {
        "vectors": vectors, "aff": aff, "pool": pool, "counts": counts,
        "dead": dead, "neighbors0": neighbors0, "dists0": dists0})
    want = {"aff": (aff, torch.int64, 1), "pool": (pool, torch.int64, 1),
            "counts": (counts, torch.int64, 1), "dead": (dead, torch.bool, 1),
            "neighbors0": (neighbors0, torch.int32, 2),
            "dists0": (dists0, torch.float32, 2)}
    for name, (t, dtype, ndim) in want.items():
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"delete_repair_cuda takes {ndim}-d {dtype} {name},"
                             f" got {t.ndim}-d {t.dtype}")
    if (tuple(counts.shape) != (2,) or tuple(dead.shape) != (cap,)
            or dists0.shape != neighbors0.shape):
        raise ValueError(
            f"counts {tuple(counts.shape)}, dead {tuple(dead.shape)} and dists0"
            f" {tuple(dists0.shape)} do not fit neighbors0 {(cap, m)}"
        )
    a, p = aff.shape[0], pool.shape[0]
    if a == 0:
        return
    d = vectors.shape[1]
    pv = vectors[pool.clamp(min=0)]
    empty = torch.empty(0, dtype=torch.float32, device=dev)
    q, qn, cs = vectors, empty, empty
    if metric is Metric.COSINE:
        q = unit_rows(vectors)
        cs = _inv_norms(pv)
    elif metric is Metric.L2:
        qn = squared_norms(vectors)
    cp = _penalty_row(pv, metric, None)
    tq, w, stages = repair_plan(kk)
    lib = _library()
    rc = lib.delete_repair_launch(
        q.data_ptr(), qn.data_ptr(), aff.data_ptr(), pool.data_ptr(),
        counts.data_ptr(), pv.data_ptr(), cp.data_ptr(), cs.data_ptr(),
        dead.data_ptr(), neighbors0.data_ptr(), dists0.data_ptr(),
        a, p, d, kk, m, METRIC_CODE[metric], int(keep_if_empty), tq, w, stages,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"delete_repair kernel launch failed: CUDA error {rc}"
            f" ({lib.delete_repair_error_string(rc).decode()})"
        )
    _build.LAUNCHES["delete_repair"] += 1
