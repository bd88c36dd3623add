"""The whole HNSW level-0 beam in one kernel: a hand-written CUDA kernel and
its plain PyTorch version.

Port of ``muninn_tpu/ops/pallas_beam_loop.py``. ``beam_loop`` runs the
complete ef-bounded best-first search of the reference
(``src/hnsw_algo.c:347-448``) from a given initial beam: each step picks
the best ``e = min(expand, ef)`` unexpanded entries (ties to the lower beam
position), reads their neighbour rows, drops candidates already in the beam
or repeated earlier in the step, scores the rest against the picks' packed
``[R0, d]`` bf16 blocks and merges with one top-``ef`` over
``[beam | candidates]`` (ties to the lower position), with fill-aware
patience counted in expansions. Its steps are those of ``_beam_loop_kernel``
and of the fused branch of ``_beam_search_level0``
(``muninn_tpu/index/hnsw.py:271-416``), op for op.

The TPU kernel carries each neighbour id inside its vector block as three
bf16 byte lanes (``pack_wide``), because a TPU DMA index must be a scalar
known before the copy. A GPU thread reads ``neighbors0`` itself, so the
kernel (``csrc/beam_loop.cu``) takes the packed ``[cap, R0, d]`` bf16 table
of the fused path and ``neighbors0 [cap, R0]`` int32; ``split_id_bytes``
and ``pack_wide`` are kept with JAX's layout as part of the package's
surface. ``pick_xfer`` names how the TPU kernel moves its picks into scalar
memory ("dma" or "scalar"); the GPU has no such step, so both values give
the same results and any other raises, as in JAX.

``beam_loop`` picks the path by the tensors' device: CPU tensors go to
``beam_loop_plain``, CUDA tensors to the kernel, which raises instead of
falling back (no ``nvcc``, a failed build, a refused launch, or ``ef`` or
``E * R0`` over the limits that shared memory sets: ``MAX_EF``,
``MAX_CANDIDATES``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.beam import (
    check_cuda,
    gather_block_dots_plain,
    packed_distances,
)
from muninn_tpu_torch.ops.distance import (
    METRIC_CODE,
    Metric,
    parse_metric,
    squared_norms,
)
from muninn_tpu_torch.ops.topk import smallest_k

ID_LANES = 128  # pack_wide's lanes after d: three id bytes, then zeros
PICK_XFERS = ("dma", "scalar")
# The kernel holds one query's beam twice (old and new), its E*R0
# candidates, its E picks, a hash of the step's ids and, where it fits, the
# query in shared memory (``_smem_bytes``); at the limits the block takes
# 192,640 bytes without the query, so every d is served.
MAX_EF = 1024
MAX_CANDIDATES = 4096
_SMEM_BYTES = 232448  # an H100 block's shared memory
_SCRATCH_WORDS = 32   # kScratchWords in csrc/beam_phases.cuh
_INF = float("inf")


def split_id_bytes(slots) -> np.ndarray:
    """Byte-split ``slots`` (int, -1 = invalid) into three bf16-exact small
    integers of ``slots + 1`` (so -1 encodes as all-zero bytes). Returns
    float32 ``[..., 3]``, high byte first."""
    v = np.asarray(slots, np.int64) + 1
    if np.any(v < 0) or np.any(v >= 1 << 24):
        raise ValueError("slot ids must be in [-1, 2^24 - 1)")
    out = np.empty(v.shape + (3,), np.float32)
    out[..., 0] = (v >> 16) & 0xFF
    out[..., 1] = (v >> 8) & 0xFF
    out[..., 2] = v & 0xFF
    return out


def pack_wide(vecs16: torch.Tensor, neighbors0: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's packed-with-ids table ``[cap, R0, d + 128]`` bf16:
    lanes ``[0, d)`` hold the neighbour rows of ``vecs16``, lanes
    ``d..d+2`` the byte-split neighbour id (``split_id_bytes``), the rest
    zero."""
    nb = torch.as_tensor(neighbors0, dtype=torch.int32, device=vecs16.device)
    cap, r0 = nb.shape
    blocks = vecs16[nb.clamp(min=0).long()].bfloat16()
    v = nb + 1  # -1 encodes as all-zero bytes
    idb = torch.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF],
                      dim=2).bfloat16()
    pad = torch.zeros((cap, r0, ID_LANES - 3), dtype=torch.bfloat16,
                      device=vecs16.device)
    return torch.cat([blocks, idb, pad], dim=2)


def _check(queries, init_d, init_i, packed, neighbors0, ef: int, expand: int,
           patience: int, max_iters: int,
           pick_xfer: str) -> tuple[int, int, int]:
    """Validate the shapes and knobs; return ``(e, patience, max_iters)``
    with the defaults filled in (``patience = max(ef // 4, 10)``,
    ``max_iters = 2 * (ef // e + 1) + patience // e + 8``)."""
    if queries.ndim != 2 or packed.ndim != 3 or neighbors0.ndim != 2:
        raise ValueError(
            "beam_loop takes queries [B, d], packed [cap, R0, d] and"
            f" neighbors0 [cap, R0], got {tuple(queries.shape)},"
            f" {tuple(packed.shape)} and {tuple(neighbors0.shape)}"
        )
    b, d = queries.shape
    if packed.shape[2] != d:
        raise ValueError(f"packed dim {packed.shape[2]} != query dim {d}")
    if tuple(neighbors0.shape) != tuple(packed.shape[:2]):
        raise ValueError(
            f"neighbors0 has shape {tuple(neighbors0.shape)}, packed"
            f" {tuple(packed.shape)}"
        )
    if ef < 1 or expand < 1:
        raise ValueError(f"ef={ef} and expand={expand} must be >= 1")
    if tuple(init_d.shape) != (b, ef) or tuple(init_i.shape) != (b, ef):
        raise ValueError("init beam shape mismatch")
    if pick_xfer not in PICK_XFERS:
        raise ValueError(f"unknown pick_xfer {pick_xfer!r}")
    e = min(expand, ef)
    if patience <= 0:
        patience = max(ef // 4, 10)  # counted in expansions, src/hnsw_algo.c:368
    if max_iters <= 0:
        max_iters = 2 * (ef // e + 1) + patience // e + 8
    return e, patience, max_iters


def beam_loop_plain(
    queries: torch.Tensor, init_d: torch.Tensor, init_i: torch.Tensor,
    packed: torch.Tensor, neighbors0: torch.Tensor,
    metric: Metric | str = Metric.COSINE, ef: int = 24, expand: int = 4,
    patience: int = 0, max_iters: int = 0, pick_xfer: str = "dma",
) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """``beam_loop`` in eager torch over ``gather_block_dots_plain``.
    Returns ``(beam_d [B, ef], beam_i [B, ef] int32, expansions, fresh)``:
    the picks expanded and the candidates that survived the dedup (whose
    rows a reader must load), summed over the batch."""
    metric = parse_metric(metric)
    e, patience, max_iters = _check(queries, init_d, init_i, packed, neighbors0,
                                    ef, expand, patience, max_iters, pick_xfer)
    b = queries.shape[0]
    r0 = packed.shape[1]
    c = e * r0
    dev = queries.device
    qf = queries.float()
    qn2 = squared_norms(qf)[:, None]
    beam_d, beam_i = init_d.float(), init_i.to(torch.int32)
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    stall = torch.zeros(b, dtype=torch.int64, device=dev)
    earlier = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
    expansions = torch.zeros((), dtype=torch.int64, device=dev)
    fresh = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(max_iters):
        cand = torch.where(expanded | (beam_i < 0), _INF, beam_d)
        pick_d, pick = smallest_k(cand, e)
        pick_valid = pick_d < _INF
        live = pick_valid.any(dim=1) & (stall < patience)
        # a query that is not live never changes again, and after the first
        # merge its beam is sorted, so stopping here gives what running all
        # max_iters steps would
        if it > 0 and not bool(live.any()):
            break
        do = pick_valid & live[:, None]
        expanded = expanded | torch.zeros_like(expanded).scatter(1, pick, do)
        pick_i = torch.where(do, torch.gather(beam_i, 1, pick), -1)
        nbrs = neighbors0[pick_i.clamp(min=0).long()].reshape(b, c)
        nbrs = torch.where(do.repeat_interleave(r0, dim=1), nbrs, -1)
        # dedup by equality: candidates already in the beam, and repeats of
        # an earlier candidate of this step (the first occurrence stays)
        beam_cmp = torch.where(beam_i < 0, -2, beam_i)
        bad = (nbrs < 0) | (nbrs[:, :, None] == beam_cmp[:, None, :]).any(dim=2)
        bad |= ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
        dots, cn2 = gather_block_dots_plain(qf, pick_i, packed)
        nd = torch.where(bad, _INF, packed_distances(dots, cn2, qn2, metric))
        nbrs = torch.where(bad, -1, nbrs)
        expansions += do.sum()
        fresh += (~bad).sum()
        # merge: one top-ef over [beam | candidates]
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_i = torch.cat([beam_i, nbrs], dim=1)
        cat_f = torch.cat([expanded, torch.zeros_like(bad)], dim=1)
        new_d, pos = smallest_k(cat_d, ef)
        new_i = torch.gather(cat_i, 1, pos)
        new_f = torch.gather(cat_f, 1, pos)
        new_i = torch.where(torch.isinf(new_d), -1, new_i)
        new_f = new_f & (new_i >= 0)
        # an expansion improves when the beam's tail tightens or the beam
        # is still filling (src/hnsw_algo.c:368-392)
        improved = (new_d[:, ef - 1] < beam_d[:, ef - 1]) | (
            (new_i >= 0).sum(dim=1) > (beam_i >= 0).sum(dim=1)
        )
        stall = torch.where(
            live, torch.where(improved, 0, stall + do.sum(dim=1)), stall
        )
        beam_d, beam_i, expanded = new_d, new_i, new_f
    return beam_d, beam_i, int(expansions), int(fresh)


def _smem_words(dq: int, ef: int, e: int, c: int, h: int) -> int:
    """``smem_words`` of csrc/beam_phases.cuh: the query ``dq``, two beams of
    ``ef`` (distance, slot, flag), ``c`` candidates (id, kept (pick, row),
    contender distance and position, sorted distance and id), ``e`` pick
    slots, ``h`` hash slots (key, value), scratch; 4 bytes each."""
    return dq + 6 * ef + 6 * c + e + 2 * h + _SCRATCH_WORDS


def _plan(d: int, ef: int, e: int, r0: int) -> tuple[int, bool, int]:
    """``plan`` of csrc/beam_phases.cuh: ``(hash slots, query in shared
    memory, bytes)``. The hash has the power of two at or above ``2 (ef +
    E*R0)`` slots, halved while the block does not fit and half still hold
    ``ef + E*R0``; the query goes to shared memory where it fits beside the
    rest, else the kernel reads it from device memory."""
    c = e * r0
    h = 4
    while h < 2 * (ef + c):
        h *= 2
    while 4 * _smem_words(0, ef, e, c, h) > _SMEM_BYTES and h // 2 >= ef + c:
        h //= 2
    with_q = 4 * _smem_words(-(-d // 4) * 4, ef, e, c, h)
    if with_q <= _SMEM_BYTES:
        return h, True, with_q
    return h, False, 4 * _smem_words(0, ef, e, c, h)


def _smem_bytes(d: int, ef: int, e: int, r0: int) -> int:
    """Shared memory of one kernel block (``_plan``)."""
    return _plan(d, ef, e, r0)[2]


_LIB: ctypes.CDLL | None = None  # the bound library, loaded at first launch


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launcher's C signature on a loaded library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.beam_loop.argtypes = [ptr] * 8 + [i32] * 10 + [ptr]
    lib.beam_loop.restype = i32
    lib.beam_loop_error_string.argtypes = [i32]
    lib.beam_loop_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _bind(_build.library("beam_loop"))
        lib.beam_loop_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.beam_loop_smem_bytes.restype = ctypes.c_longlong
        # the source's count against this module's, at the bench shape, the
        # limits, and shapes whose query moves out of shared memory
        for shape in ((384, 24, 8, 32), (37, 5, 3, 12), (1024, MAX_EF, 128, 32),
                      (40000, MAX_EF, 128, 32), (58000, 24, 8, 32), (1, 1, 1, 1)):
            if lib.beam_loop_smem_bytes(*shape) != _smem_bytes(*shape):
                raise RuntimeError(
                    f"csrc/beam_loop.cu asks {lib.beam_loop_smem_bytes(*shape)}"
                    f" bytes of shared memory at (d, ef, E, R0) = {shape},"
                    f" beam_loop.py counts {_smem_bytes(*shape)}"
                )
        _LIB = lib
    return _LIB


def beam_loop_cuda(
    queries: torch.Tensor, init_d: torch.Tensor, init_i: torch.Tensor,
    packed: torch.Tensor, neighbors0: torch.Tensor,
    metric: Metric | str = Metric.COSINE, ef: int = 24, expand: int = 4,
    patience: int = 0, max_iters: int = 0, pick_xfer: str = "dma",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the whole-beam kernel. Takes contiguous CUDA tensors on one
    card: queries and init_d f32, init_i and neighbors0 int32, packed bf16,
    every slot of the beam and of ``neighbors0`` below ``cap``. Raises on
    anything else, on ``ef > MAX_EF``, ``E * R0 > MAX_CANDIDATES`` or a
    block's shared memory exceeded, and on a failed build or launch."""
    metric = parse_metric(metric)
    e, patience, max_iters = _check(queries, init_d, init_i, packed, neighbors0,
                                    ef, expand, patience, max_iters, pick_xfer)
    b, d = queries.shape
    cap, r0, _ = packed.shape
    smem = _smem_bytes(d, ef, e, r0)
    if ef > MAX_EF or e * r0 > MAX_CANDIDATES or smem > _SMEM_BYTES:
        raise ValueError(
            f"beam_loop_cuda takes ef <= {MAX_EF} and E*R0 <="
            f" {MAX_CANDIDATES} within {_SMEM_BYTES} bytes of shared memory,"
            f" got ef={ef}, E*R0={e * r0}, {smem} bytes"
        )
    dev = check_cuda("beam_loop_cuda", {
        "queries": queries, "init_d": init_d, "init_i": init_i,
        "packed": packed, "neighbors0": neighbors0})
    if (queries.dtype != torch.float32 or init_d.dtype != torch.float32
            or init_i.dtype != torch.int32 or neighbors0.dtype != torch.int32
            or packed.dtype != torch.bfloat16):
        raise ValueError(
            "beam_loop_cuda takes f32 queries and init_d, int32 init_i and"
            " neighbors0 and bf16 packed, got"
            f" {queries.dtype}, {init_d.dtype}, {init_i.dtype},"
            f" {neighbors0.dtype} and {packed.dtype}"
        )
    out_d = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    qn2 = squared_norms(queries)  # the plain version's, so both agree on it
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.beam_loop(
        queries.data_ptr(), qn2.data_ptr(), init_d.data_ptr(),
        init_i.data_ptr(), packed.data_ptr(), neighbors0.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(),
        b, d, r0, cap, ef, e, patience, max_iters, METRIC_CODE[metric], dev.index,
        stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"beam_loop kernel launch failed: CUDA error {rc}"
            f" ({lib.beam_loop_error_string(rc).decode()})"
        )
    _build.LAUNCHES["beam_loop"] += 1
    return out_d, out_i


def beam_loop(
    queries: torch.Tensor, init_d: torch.Tensor, init_i: torch.Tensor,
    packed: torch.Tensor, neighbors0: torch.Tensor,
    metric: Metric | str = Metric.COSINE, ef: int = 24, expand: int = 4,
    patience: int = 0, max_iters: int = 0, pick_xfer: str = "dma",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the whole level-0 beam from ``(init_d, init_i) [B, ef]`` (entry
    distances, +inf padded; entry slots, -1 padded) over ``packed [cap, R0,
    d]`` blocks and their ids ``neighbors0 [cap, R0]``. Returns ``(beam_d
    [B, ef] f32, beam_i [B, ef] int32)`` ascending, scored from the packed
    rows; the caller rescores in exact f32.

    CPU tensors run ``beam_loop_plain``; CUDA tensors run the kernel."""
    args = (queries, init_d, init_i, packed, neighbors0)
    if all(t.device.type == "cpu" for t in args):
        return beam_loop_plain(*args, metric, ef, expand, patience, max_iters,
                               pick_xfer)[:2]
    return beam_loop_cuda(*args, metric, ef, expand, patience, max_iters,
                          pick_xfer)
