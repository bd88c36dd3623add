"""One step of the fused HNSW level-0 beam: a hand-written CUDA kernel and
its plain PyTorch version.

A step of ``index/hnsw.py``'s ``_beam_search_level0`` (the port of the
fused branch of ``muninn_tpu/index/hnsw.py`` ``_beam_search_level0``,
``:271-416``): expand the best ``E`` unexpanded entries of each query's
beam, drop the neighbours already in the beam or repeated earlier in the
step, score the rest and merge one top-``ef``, with fill-aware patience.

- ``beam_step_plain``: the step in eager torch, every engine's: scoring
  from the picks' packed blocks through ``gather_block_dots`` (int8 blocks
  scaled by ``pscales``), per-pick top-m through ``gather_block_topm``
  (``topm > 0``), or from rows of ``vectors``. On the card it launches
  about 85 kernels a step, two of them quadratic compares.
- ``beam_step_cuda``: the whole step over packed bf16 or int8 blocks (the
  tables ``HnswIndex`` packs) in one launch of ``csrc/beam_step.cu``, which
  replaces JAX's ``_beam_dots_kernel`` and the XLA glue around it. It
  updates the beam in
  place, bit for bit as ``beam_step_plain`` on the card, and ORs the
  next step's go-on condition (``go_on``) into a flag, so the host reads
  one flag a step and launches nothing else.
- ``step_engine``: which of the two a beam takes, from what its inputs
  show (device, packed table, ``topm``, shapes): the kernel wherever it
  takes the step, the eager step elsewhere; ``HnswIndex._choose_route``
  asks it. One algorithm, one result.

``beam_step`` picks by the tensors' device: CPU tensors go to the plain
version, CUDA tensors to the kernel, which raises instead of falling back
(no ``nvcc``, a failed build, a refused launch, or ``ef`` or ``E * R0``
above the shared-memory limits ``MAX_EF`` and ``MAX_CANDIDATES``, which
the kernel shares with ``beam_loop``).
"""

from __future__ import annotations

import ctypes

import torch

from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.beam import (
    _DTYPE,
    BIG,
    check_cuda,
    gather_block_dots,
    gather_block_topm,
    packed_distances,
)
from muninn_tpu_torch.ops.beam_loop import (
    _SMEM_BYTES,
    MAX_CANDIDATES,
    MAX_EF,
    _smem_bytes,
)
from muninn_tpu_torch.ops.distance import (
    METRIC_CODE,
    Metric,
    gathered_distances,
    parse_metric,
)
from muninn_tpu_torch.ops.topk import smallest_k

_INF = float("inf")
_BLOCKS = (torch.bfloat16, torch.int8)  # the kernel's packed tables


def fetch_rows(vectors: torch.Tensor, scales: torch.Tensor | None,
               idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``vectors``, dequantized by ``scales`` when given
    (int8 guidance rows)."""
    v = vectors[idx]
    if scales is not None:
        v = v.float() * scales[idx][..., None]
    return v


def go_on(beam_i: torch.Tensor, expanded: torch.Tensor, stall: torch.Tensor,
          patience: int) -> torch.Tensor:
    """Whether the beam takes another step: some query has an unexpanded
    entry with a slot and is within its patience (0-d bool)."""
    has_unexpanded = ((~expanded) & (beam_i >= 0)).any(dim=1)
    return (has_unexpanded & (stall < patience)).any()


def _fits(d: int, ef: int, e: int, r0: int) -> bool:
    """Whether a step at (d, ef, E, R0) fits the kernel's plan: ``ef`` and
    ``E * R0`` within ``MAX_EF`` and ``MAX_CANDIDATES``, and the block's
    shared memory within ``_SMEM_BYTES``."""
    return (ef <= MAX_EF and e * r0 <= MAX_CANDIDATES
            and _smem_bytes(d, ef, e, r0) <= _SMEM_BYTES)


def step_engine(device: torch.device, packed: torch.Tensor | None, topm: int,
                ef: int, expand: int) -> str:
    """``"kernel"`` where ``beam_step_cuda`` takes a beam's steps: a CUDA
    beam scored from a packed bf16 or int8 table without top-m, with
    ``ef`` and ``E * R0`` (``E = min(expand, ef)``) within the kernel's
    shared memory; ``"eager"`` otherwise (the CPU, the row path, top-m,
    anything above the limits). Reads only the device, ``packed``'s shape
    and dtype, ``topm``, ``ef`` and ``expand``."""
    if device.type != "cuda" or packed is None or topm > 0:
        return "eager"
    if packed.ndim != 3 or packed.dtype not in _BLOCKS:
        return "eager"
    _, r0, d = packed.shape
    return "kernel" if _fits(d, ef, min(expand, ef), r0) else "eager"


def beam_step_plain(
    qf: torch.Tensor,           # [B, d] f32
    qn2: torch.Tensor,          # [B, 1] f32, the queries' squared norms
    beam_d: torch.Tensor,       # [B, ef] f32
    beam_i: torch.Tensor,       # [B, ef] int32, -1 = empty
    expanded: torch.Tensor,     # [B, ef] bool
    stall: torch.Tensor,        # [B] int64
    neighbors0: torch.Tensor,   # [cap, R0] int32
    metric: Metric | str,
    expand: int,                # E, at most ef
    patience: int,
    *,
    packed: torch.Tensor | None = None,   # [cap, R0, d] neighbour blocks
    pscales: torch.Tensor | None = None,  # [cap, R0] dequant (int8 packed)
    dedup: bool = True,
    topm: int = 0,
    vectors: torch.Tensor | None = None,  # [cap, d]: the row path
    scales: torch.Tensor | None = None,   # [cap] dequant (int8 vectors)
    earlier: torch.Tensor | None = None,  # [C, C] strictly lower triangle
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of ``_beam_search_level0`` in eager torch: the best
    ``expand`` unexpanded entries of each query expanded (ties to the lower
    position), their neighbours that are not in the beam nor (``dedup``)
    repeated earlier in the step scored from ``packed`` blocks
    (``gather_block_dots``; ``topm > 0`` over f32 or bf16 blocks:
    ``gather_block_topm`` with the beam's candidates penalised by +BIG) or
    from rows of ``vectors``, one top-``ef`` over ``[beam | candidates]``
    (ties to the lower position), and the fill-aware stall update. Returns
    the new ``(beam_d, beam_i, expanded, stall)``. ``earlier`` may carry the
    ``[C, C]`` mask from one step to the next."""
    metric = parse_metric(metric)
    b, ef = beam_i.shape
    dev = qf.device
    r0 = neighbors0.shape[1]
    use_topm = packed is not None and topm > 0 and pscales is None
    c = expand * (topm if use_topm else r0)
    if earlier is None:
        earlier = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)

    # the best `expand` unexpanded entries of each query
    cand_d = torch.where(expanded | (beam_i < 0), _INF, beam_d)
    pick_d, pick = smallest_k(cand_d, expand)
    pick_i = torch.gather(beam_i, 1, pick)
    pick_valid = pick_d < _INF
    live = pick_valid.any(dim=1) & (stall < patience)
    do = pick_valid & live[:, None]
    expanded = expanded | torch.zeros_like(expanded).scatter(
        1, pick, do)
    # dead picks ride as -1: the kernels skip their blocks
    live_picks = torch.where(do, pick_i, -1)

    nbrs = neighbors0[pick_i.clamp(min=0).long()].reshape(
        b, expand * r0)
    nbrs = torch.where(do.repeat_interleave(r0, dim=1), nbrs, -1)
    # dedup by equality: drop candidates already in the beam and
    # repeats within this step (the first occurrence stays)
    beam_cmp = torch.where(beam_i < 0, -2, beam_i)
    in_beam = (nbrs[:, :, None] == beam_cmp[:, None, :]).any(dim=2)

    if use_topm:
        pen = torch.where(in_beam | (nbrs < 0), BIG, 0.0)
        md, ml = gather_block_topm(qf, live_picks, packed, pen,
                                   metric, topm)
        nd = md.reshape(b, c)
        sel = torch.gather(nbrs.reshape(b, expand, r0), 2, ml.long())
        nbrs = torch.where(nd < 1.0e38, sel.reshape(b, c), -1)
        drop = torch.zeros((b, c), dtype=torch.bool, device=dev)
    else:
        drop = in_beam
        if packed is not None:
            dots, cn2 = gather_block_dots(qf, live_picks, packed)
            if pscales is not None:
                ps = pscales[pick_i.clamp(min=0).long()].reshape(
                    b, c)
                dots = dots * ps
                cn2 = cn2 * ps * ps
            nd = packed_distances(dots, cn2, qn2, metric)
        else:
            nd = gathered_distances(
                qf, fetch_rows(vectors, scales, nbrs.clamp(min=0).long()),
                metric)
    if dedup:
        drop = drop | ((nbrs[:, :, None] == nbrs[:, None, :])
                       & earlier).any(dim=2)
    nbrs = torch.where(drop, -1, nbrs)
    nd = torch.where(nbrs >= 0, nd, _INF)

    # merge: one top-ef over [beam | fresh candidates]
    cat_d = torch.cat([beam_d, nd], dim=1)
    cat_i = torch.cat([beam_i, nbrs], dim=1)
    cat_f = torch.cat(
        [expanded, torch.zeros_like(nbrs, dtype=torch.bool)], dim=1)
    new_d, pos = smallest_k(cat_d, ef)
    new_i = torch.gather(cat_i, 1, pos)
    new_f = torch.gather(cat_f, 1, pos)
    new_i = torch.where(torch.isinf(new_d), -1, new_i)
    new_f = new_f & (new_i >= 0)
    # an expansion improves when the beam's tail tightens or the
    # beam is still filling (src/hnsw_algo.c:368-392)
    improved = (new_d[:, ef - 1] < beam_d[:, ef - 1]) | (
        (new_i >= 0).sum(dim=1) > (beam_i >= 0).sum(dim=1)
    )
    stall = torch.where(
        live, torch.where(improved, 0, stall + do.sum(dim=1)), stall
    )
    return new_d, new_i, new_f, stall


def _check(qf, qn2, beam_d, beam_i, expanded, stall, neighbors0, packed,
           pscales, flag, expand: int) -> None:
    """The kernel's shapes and types; raises ValueError on anything else."""
    if qf.ndim != 2 or beam_d.ndim != 2 or neighbors0.ndim != 2 or packed.ndim != 3:
        raise ValueError(
            "beam_step takes queries [B, d], a beam [B, ef], neighbors0"
            f" [cap, R0] and packed [cap, R0, d], got {tuple(qf.shape)},"
            f" {tuple(beam_d.shape)}, {tuple(neighbors0.shape)} and"
            f" {tuple(packed.shape)}"
        )
    b, d = qf.shape
    ef = beam_d.shape[1]
    if packed.shape[2] != d:
        raise ValueError(f"packed dim {packed.shape[2]} != query dim {d}")
    if tuple(neighbors0.shape) != tuple(packed.shape[:2]):
        raise ValueError(
            f"neighbors0 has shape {tuple(neighbors0.shape)}, packed"
            f" {tuple(packed.shape)}"
        )
    if (beam_d.shape[0] != b or tuple(beam_i.shape) != (b, ef)
            or tuple(expanded.shape) != (b, ef) or tuple(stall.shape) != (b,)
            or qn2.numel() != b):
        raise ValueError("beam state shape mismatch")
    if pscales is not None and tuple(pscales.shape) != tuple(packed.shape[:2]):
        raise ValueError(
            f"pscales has shape {tuple(pscales.shape)}, packed"
            f" {tuple(packed.shape)}"
        )
    if flag is not None and flag.numel() != 1:
        raise ValueError(f"flag has {flag.numel()} elements, want 1")
    if not 1 <= expand <= ef:
        raise ValueError(f"expand={expand} must be in [1, ef={ef}]")
    want = ((qf, torch.float32, "queries"), (qn2, torch.float32, "qn2"),
            (beam_d, torch.float32, "beam_d"), (beam_i, torch.int32, "beam_i"),
            (expanded, torch.bool, "expanded"), (stall, torch.int64, "stall"),
            (neighbors0, torch.int32, "neighbors0"))
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise ValueError(f"beam_step takes {dtype} {name}, got {t.dtype}")
    if packed.dtype not in _BLOCKS:
        raise ValueError(f"beam_step takes bf16 or int8 packed, got {packed.dtype}")
    if pscales is not None and pscales.dtype != torch.float32:
        raise ValueError(f"beam_step takes f32 pscales, got {pscales.dtype}")
    if flag is not None and flag.dtype != torch.int32:
        raise ValueError(f"beam_step takes an int32 flag, got {flag.dtype}")


_LIB: ctypes.CDLL | None = None  # the bound library, loaded at first launch


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("beam_step")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.beam_step.argtypes = [ptr] * 10 + [i32] * 11 + [ptr]
        lib.beam_step.restype = i32
        lib.beam_step_error_string.argtypes = [i32]
        lib.beam_step_error_string.restype = ctypes.c_char_p
        lib.beam_step_smem_bytes.argtypes = [i32] * 4
        lib.beam_step_smem_bytes.restype = ctypes.c_longlong
        # the source's plan against beam_loop.py's count (one layout)
        for shape in ((384, 64, 8, 32), (37, 5, 3, 12), (1024, MAX_EF, 128, 32),
                      (58000, 24, 8, 32), (1, 1, 1, 1)):
            if lib.beam_step_smem_bytes(*shape) != _smem_bytes(*shape):
                raise RuntimeError(
                    f"csrc/beam_step.cu asks {lib.beam_step_smem_bytes(*shape)}"
                    f" bytes of shared memory at (d, ef, E, R0) = {shape},"
                    f" beam_loop.py counts {_smem_bytes(*shape)}"
                )
        _LIB = lib
    return _LIB


def beam_step_cuda(
    qf: torch.Tensor, qn2: torch.Tensor, beam_d: torch.Tensor,
    beam_i: torch.Tensor, expanded: torch.Tensor, stall: torch.Tensor,
    neighbors0: torch.Tensor, packed: torch.Tensor, metric: Metric | str,
    expand: int, patience: int, *, pscales: torch.Tensor | None = None,
    dedup: bool = True, flag: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the step kernel. Takes contiguous CUDA tensors on one card:
    queries, qn2 ([B] or [B, 1]) and beam_d f32, beam_i and neighbors0
    int32, expanded bool, stall int64, packed bf16 or int8, pscales
    f32 or None, flag a one-element int32 tensor or None; every slot of the
    beam and of ``neighbors0`` below ``cap``. Updates the beam in place and
    returns ``(beam_d, beam_i, expanded, stall)``; ORs 1 into ``flag``
    where some query goes on (``go_on`` of the new beam). Raises on
    anything else, on ``ef > MAX_EF``, ``E * R0 > MAX_CANDIDATES`` or a
    block's shared memory exceeded, and on a failed build or launch."""
    metric = parse_metric(metric)
    _check(qf, qn2, beam_d, beam_i, expanded, stall, neighbors0, packed,
           pscales, flag, expand)
    b, d = qf.shape
    ef = beam_d.shape[1]
    cap, r0, _ = packed.shape
    if not _fits(d, ef, expand, r0):
        raise ValueError(
            f"beam_step_cuda takes ef <= {MAX_EF} and E*R0 <="
            f" {MAX_CANDIDATES} within {_SMEM_BYTES} bytes of shared memory,"
            f" got ef={ef}, E*R0={expand * r0},"
            f" {_smem_bytes(d, ef, expand, r0)} bytes"
        )
    if patience < 1:
        raise ValueError(f"patience={patience} must be >= 1")
    tensors = {"queries": qf, "qn2": qn2, "beam_d": beam_d, "beam_i": beam_i,
               "expanded": expanded, "stall": stall, "neighbors0": neighbors0,
               "packed": packed}
    if pscales is not None:
        tensors["pscales"] = pscales
    if flag is not None:
        tensors["flag"] = flag
    dev = check_cuda("beam_step_cuda", tensors)
    if b == 0:
        return beam_d, beam_i, expanded, stall
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.beam_step(
        qf.data_ptr(), qn2.data_ptr(), beam_d.data_ptr(), beam_i.data_ptr(),
        expanded.data_ptr(), stall.data_ptr(), packed.data_ptr(),
        None if pscales is None else pscales.data_ptr(),
        neighbors0.data_ptr(), None if flag is None else flag.data_ptr(),
        b, d, r0, cap, ef, expand, patience, METRIC_CODE[metric], int(dedup),
        _DTYPE[packed.dtype], dev.index, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"beam_step kernel launch failed: CUDA error {rc}"
            f" ({lib.beam_step_error_string(rc).decode()})"
        )
    _build.LAUNCHES["beam_step"] += 1
    return beam_d, beam_i, expanded, stall


def beam_step(
    qf: torch.Tensor, qn2: torch.Tensor, beam_d: torch.Tensor,
    beam_i: torch.Tensor, expanded: torch.Tensor, stall: torch.Tensor,
    neighbors0: torch.Tensor, packed: torch.Tensor, metric: Metric | str,
    expand: int, patience: int, *, pscales: torch.Tensor | None = None,
    dedup: bool = True, flag: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam step scored from ``packed`` blocks (see
    ``beam_step_plain``), returning the new ``(beam_d, beam_i, expanded,
    stall)`` and OR-ing the new beam's ``go_on`` into ``flag`` when given.

    CPU tensors run ``beam_step_plain``; CUDA tensors run the kernel, which
    updates the beam in place. The search calls ``beam_step_cuda`` only on
    a CUDA beam and ``beam_step_plain`` on every other (``step_engine``),
    so the CPU branch is reached only by tests that drive the kernel's flag
    protocol on the CPU."""
    args = (qf, qn2, beam_d, beam_i, expanded, stall, neighbors0, packed)
    if all(t.device.type == "cpu" for t in args):
        out = beam_step_plain(qf, qn2.reshape(-1, 1), beam_d, beam_i, expanded,
                              stall, neighbors0, metric, expand, patience,
                              packed=packed, pscales=pscales, dedup=dedup)
        if flag is not None:
            flag.bitwise_or_(go_on(out[1], out[2], out[3], patience).to(flag.dtype))
        return out
    return beam_step_cuda(qf, qn2, beam_d, beam_i, expanded, stall, neighbors0,
                          packed, metric, expand, patience, pscales=pscales,
                          dedup=dedup, flag=flag)
