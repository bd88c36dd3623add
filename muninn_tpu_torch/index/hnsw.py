"""HNSW approximate nearest-neighbour index, the PyTorch port of
``muninn_tpu/index/hnsw.py``: its bulk build and its search paths.

- Storage as in the JAX package: dense slots in a ``VectorStore``, the
  level-0 graph as ``int32 [cap, 2M]`` neighbour and ``f32 [cap, 2M]`` edge
  distance tables (-1 / inf pad), upper levels in a compact
  ``int32 [cap_hi, 8, M]`` table addressed through ``hi_index [cap]``.
  Levels, the id map and the promoted pool are host numpy, drawn with the
  same ``np.random.default_rng(seed)`` calls in the same order, so they
  equal the JAX package's bit for bit.
- Bulk build (insert of at least ``4 * wave_size`` rows into an empty
  index): the level-0 graph is the exact kNN graph, swept in chunks of
  8,192 rows with ``flat_topk`` at ``build_precision``, symmetrised by one
  reverse-append pass and pruned back to ``2M`` by distance; upper levels
  are wired exactly, closest ``M`` within each level's population.
- Search: exact routing over the promoted pool (``flat_topk`` at
  ``precision="default"``), a level-0 beam guided by bf16 vectors, or by
  int8 ones with one scale per row (``search_quant = "int8"``), whose
  expansions read packed ``[R0, d]`` neighbour blocks through
  ``ops.beam.gather_block_dots``, then an exact f32 rescore of the beam.
  Below ``exact_small_n`` stored rows search is exact ``flat_topk``. Two
  other beam engines over the same packed bf16 table: ``beam_topm > 0``
  keeps each pick's best candidates in ``ops.beam.gather_block_topm``, and
  ``beam_whole`` runs the whole beam in one ``ops.beam_loop.beam_loop``
  kernel per query. ``search_degree`` searches only the first columns of
  each neighbour row, in every engine.

PyTorch runs eagerly: the beam's ``lax.while_loop`` is a Python loop of at
most ``max_iters`` steps that reads ``live.any()`` once per step. The JAX
package's ``.at[...].set(..., mode="drop")`` has no PyTorch counterpart (an
out-of-range index is a device-side assert on CUDA), so every scatter
here masks its out-of-range indices out first.

Not ported yet (see ROADMAP.md, queue 1): insert waves into a non-empty
index, delete and repair, MN-RU prunes, and greedy descent on a graph
without promoted nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from muninn_tpu_torch.index.store import VectorStore
from muninn_tpu_torch.ops.beam import (
    BIG,
    gather_block_dots,
    gather_block_topm,
    packed_distances,
)
from muninn_tpu_torch.ops.beam_loop import beam_loop
from muninn_tpu_torch.ops.distance import (
    Metric,
    gathered_distances,
    pairwise_distances,
    parse_metric,
    quantize_rows_int8,
    squared_norms,
)
from muninn_tpu_torch.ops.flat_topk import flat_topk
from muninn_tpu_torch.ops.topk import masked_topk, smallest_k, sorted_topk_unique

HNSW_MAX_LEVELS = 32  # the reference's cap, src/hnsw_algo.h:14
_SWEEP_ROWS = 8192    # rows per chunk of the bulk kNN sweep and the prune
_INF = float("inf")
SEARCH_QUANTS = ("bf16", "int8")  # the beam's guidance rows


def _pow2_pad(members: np.ndarray) -> np.ndarray:
    """``members`` -1-padded to a power of two of at least 64."""
    size = 1 << int(np.ceil(np.log2(max(len(members), 64))))
    return np.pad(members, (0, size - len(members)), constant_values=-1)


# ───────────────────────── search ─────────────────────────


def _beam_search_level0(
    queries: torch.Tensor,      # [B, d]
    entry: torch.Tensor,        # [B] or [B, R] int32 slots, -1 = none
    vectors: torch.Tensor,      # [cap, d] f32 / bf16 / int8: entries, row path
    neighbors0: torch.Tensor,   # [cap, R0] int32
    metric: Metric,
    ef: int,
    expand: int = 4,
    max_iters: int = 0,
    patience: int = 0,
    packed: torch.Tensor | None = None,  # [cap, R0, d] neighbour blocks
    dedup: bool = True,
    scales: torch.Tensor | None = None,   # [cap] f32 dequant (int8 vectors)
    pscales: torch.Tensor | None = None,  # [cap, R0] dequant (int8 packed)
    topm: int = 0,                        # > 0: per-pick top-m in the kernel
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ef-bounded beam search at level 0 (``hnsw.py:172-421``).

    The beam is one distance-sorted array of width ``ef`` per query with
    an expanded flag. Each step expands the best ``expand`` unexpanded
    entries, drops neighbours already in the beam or repeated within the
    step, scores the rest and merges with one top-``ef``; picks and merge
    break ties to the lower position, as ``lax.top_k`` does. It stops when
    no query has an unexpanded entry within its patience (``max(ef/4, 10)``
    non-improving expansions by default), or after ``max_iters`` steps.

    With ``packed``, candidates are scored from the picks' packed blocks
    through ``gather_block_dots`` (the kernel on CUDA, its plain version
    on the CPU); without, from rows of ``vectors``. int8 guidance
    (``hnsw.py:235-240``, ``:369-373``): rows of int8 ``vectors`` are
    dequantized by ``scales`` after the gather, and the dots and squared
    norms of int8 blocks are scaled by each neighbour's ``pscales`` entry
    (``dots * ps``, ``cn2 * ps * ps``) before the metric epilogue. With
    ``topm > 0`` over f32 or bf16 blocks (``hnsw.py:298-348``), the
    candidates in the beam get a +BIG penalty and ``gather_block_topm``
    keeps each pick's ``topm`` best, so the same-step dedup and the merge
    run over ``E * topm`` candidates; ``topm == R0`` gives the dots path's
    beam. Returns ``(beam_dists [B, ef], beam_slots [B, ef] int32)``,
    ascending."""
    b = queries.shape[0]
    dev = queries.device
    r0 = neighbors0.shape[1]
    expand = min(expand, ef)
    if patience <= 0:
        patience = max(ef // 4, 10)  # counted in expansions
    if max_iters <= 0:
        max_iters = 2 * (ef // expand + 1) + patience // expand + 8
    use_topm = packed is not None and topm > 0 and pscales is None

    qf = queries.float()
    qn2 = squared_norms(qf)[:, None]

    def fetch(idx):
        v = vectors[idx]
        if scales is not None:
            v = v.float() * scales[idx][..., None]
        return v

    if entry.ndim == 1:
        entry = entry[:, None]
    r_ent = entry.shape[1]
    e_d = gathered_distances(qf, fetch(entry.clamp(min=0).long()), metric)
    beam_d = torch.full((b, ef), _INF, device=dev)
    beam_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_d[:, :r_ent] = torch.where(entry >= 0, e_d, _INF)
    beam_i[:, :r_ent] = entry
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    stall = torch.zeros(b, dtype=torch.int64, device=dev)
    c = expand * (topm if use_topm else r0)
    earlier = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)

    for _ in range(max_iters):
        has_unexpanded = ((~expanded) & (beam_i >= 0)).any(dim=1)
        if not bool((has_unexpanded & (stall < patience)).any()):
            break
        # the best `expand` unexpanded entries of each query
        cand_d = torch.where(expanded | (beam_i < 0), _INF, beam_d)
        pick_d, pick = smallest_k(cand_d, expand)
        pick_i = torch.gather(beam_i, 1, pick)
        pick_valid = pick_d < _INF
        live = pick_valid.any(dim=1) & (stall < patience)
        do = pick_valid & live[:, None]
        expanded = expanded | torch.zeros_like(expanded).scatter(1, pick, do)
        # dead picks ride as -1: the kernels skip their blocks
        live_picks = torch.where(do, pick_i, -1)

        nbrs = neighbors0[pick_i.clamp(min=0).long()].reshape(b, expand * r0)
        nbrs = torch.where(do.repeat_interleave(r0, dim=1), nbrs, -1)
        # dedup by equality: drop candidates already in the beam and
        # repeats within this step (the first occurrence stays)
        beam_cmp = torch.where(beam_i < 0, -2, beam_i)
        in_beam = (nbrs[:, :, None] == beam_cmp[:, None, :]).any(dim=2)

        if use_topm:
            pen = torch.where(in_beam | (nbrs < 0), BIG, 0.0)
            md, ml = gather_block_topm(qf, live_picks, packed, pen, metric, topm)
            nd = md.reshape(b, c)
            sel = torch.gather(nbrs.reshape(b, expand, r0), 2, ml.long())
            nbrs = torch.where(nd < 1.0e38, sel.reshape(b, c), -1)
            drop = torch.zeros((b, c), dtype=torch.bool, device=dev)
        else:
            drop = in_beam
            if packed is not None:
                dots, cn2 = gather_block_dots(qf, live_picks, packed)
                if pscales is not None:
                    ps = pscales[pick_i.clamp(min=0).long()].reshape(b, c)
                    dots = dots * ps
                    cn2 = cn2 * ps * ps
                nd = packed_distances(dots, cn2, qn2, metric)
            else:
                nd = gathered_distances(qf, fetch(nbrs.clamp(min=0).long()),
                                        metric)
        if dedup:
            drop = drop | ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
        nbrs = torch.where(drop, -1, nbrs)
        nd = torch.where(nbrs >= 0, nd, _INF)

        # merge: one top-ef over [beam | fresh candidates]
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_i = torch.cat([beam_i, nbrs], dim=1)
        cat_f = torch.cat([expanded, torch.zeros_like(nbrs, dtype=torch.bool)],
                          dim=1)
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
    return beam_d, beam_i


def _route(q: torch.Tensor, pool: torch.Tensor, pv: torch.Tensor,
           metric: Metric, r: int) -> torch.Tensor:
    """Exact routing: the ``r`` nearest promoted slots of each query
    (``flat_topk`` at ``precision="default"`` over the pooled rows), -1
    where the pool has fewer."""
    _, sel = flat_topk(q, pv, r, metric=metric, precision="default",
                       corpus_valid=pool >= 0)
    return torch.where(sel >= 0, pool[sel.clamp(min=0).long()], -1)


def _rescore_topk(q: torch.Tensor, vectors: torch.Tensor, valid: torch.Tensor,
                  beam_i: torch.Tensor, metric: Metric, k: int):
    """Soft-delete filter, exact f32 rescore of the beam's rows, top-k: the
    bf16 (or int8) beam decides which rows, the f32 store their
    distances."""
    ok = (beam_i >= 0) & valid[beam_i.clamp(min=0).long()]
    beam_i = torch.where(ok, beam_i, -1)
    d = gathered_distances(q, vectors[beam_i.clamp(min=0).long()], metric)
    return sorted_topk_unique(torch.where(ok, d, _INF), beam_i, k)


def _search_topk_fused(
    q: torch.Tensor,           # [B, d] f32
    pool: torch.Tensor,        # [Mp] promoted slots, -1 pad
    pv: torch.Tensor,          # [Mp, d] pooled f32 vectors
    vectors: torch.Tensor,     # [cap, d] f32 store
    v16: torch.Tensor,         # [cap, d] bf16 / int8 shadow for the beam
    neighbors0: torch.Tensor,  # [cap, R0]
    valid: torch.Tensor,       # [cap] bool
    metric: Metric,
    k: int,
    ef: int,
    expand: int,
    r: int,
    patience: int = 0,
    packed: torch.Tensor | None = None,
    dedup: bool = True,
    max_iters: int = 0,
    scales: torch.Tensor | None = None,
    pscales: torch.Tensor | None = None,
    topm: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The query path (``hnsw.py:429-473``): routing over the promoted pool,
    bf16 or int8 beam, soft-delete filter, exact f32 rescore, top-k."""
    entries = _route(q, pool, pv, metric, r)
    _, beam_i = _beam_search_level0(
        q, entries, v16, neighbors0, metric, ef, expand,
        max_iters=max_iters, patience=patience, packed=packed, dedup=dedup,
        scales=scales, pscales=pscales, topm=topm,
    )
    return _rescore_topk(q, vectors, valid, beam_i, metric, k)


def _search_topk_whole(
    q: torch.Tensor,           # [B, d] f32
    pool: torch.Tensor,        # [Mp] promoted slots, -1 pad
    pv: torch.Tensor,          # [Mp, d] pooled f32 vectors
    vectors: torch.Tensor,     # [cap, d] f32 store
    v16: torch.Tensor,         # [cap, d] bf16 shadow (entry scoring)
    packed: torch.Tensor,      # [cap, R0, d] bf16 neighbour blocks
    neighbors0: torch.Tensor,  # [cap, R0] int32, the blocks' ids
    valid: torch.Tensor,       # [cap] bool
    metric: Metric,
    k: int,
    ef: int,
    expand: int,
    r: int,
    patience: int = 0,
    max_iters: int = 0,
    pick_xfer: str = "dma",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole-beam query path (``hnsw.py:481-527``): routing, entry
    distances from the bf16 shadow, the whole level-0 beam in one
    ``beam_loop`` kernel, then ``_search_topk_fused``'s filter, rescore and
    top-k."""
    entries = _route(q, pool, pv, metric, r)
    e_d = gathered_distances(q, v16[entries.clamp(min=0).long()].float(), metric)
    b, dev = q.shape[0], q.device
    init_d = torch.full((b, ef), _INF, device=dev)
    init_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    init_d[:, : entries.shape[1]] = torch.where(entries >= 0, e_d, _INF)
    init_i[:, : entries.shape[1]] = entries
    _, beam_i = beam_loop(q, init_d, init_i, packed, neighbors0, metric, ef,
                          expand, patience, max_iters, pick_xfer)
    return _rescore_topk(q, vectors, valid, beam_i, metric, k)


# ───────────────────────── bulk build ─────────────────────────


def _drop_self_matches(dd, ii, base: int, m0: int):
    """Drop each row's self-match from its kNN list: stable-sort the self
    column to the back, keep the first ``m0``."""
    self_id = base + torch.arange(ii.shape[0], device=ii.device)[:, None]
    self_col = (ii == self_id).to(torch.int8)
    order = torch.sort(self_col, dim=1, stable=True).indices[:, :m0]
    return torch.gather(ii, 1, order), torch.gather(dd, 1, order)


def _grouped_bounded_append(tgt_raw, src, dd, cap: int, a_max: int):
    """Group edges by target and keep the first ``a_max`` per target (sort,
    rank within the run, one flat scatter). Returns ``[cap, a_max]``
    appended ids (-1 pad) and distances (inf pad). Invalid targets sort to
    the back as ``cap``, so the sorted keys stay monotone."""
    tgt = torch.where(tgt_raw >= 0, tgt_raw.long(), cap)
    order = torch.sort(tgt, stable=True).indices
    tgt_s = tgt[order]
    first = torch.searchsorted(tgt_s, tgt_s, side="left")
    pos = torch.arange(tgt_s.shape[0], device=tgt_s.device) - first
    keep = (tgt_s < cap) & (pos < a_max)
    flat = tgt_s[keep] * a_max + pos[keep]
    dev = tgt_s.device
    append_i = torch.full((cap * a_max,), -1, dtype=torch.int32, device=dev)
    append_d = torch.full((cap * a_max,), _INF, device=dev)
    append_i[flat] = src[order][keep]
    append_d[flat] = dd[order][keep]
    return append_i.reshape(cap, a_max), append_d.reshape(cap, a_max)


def _prune_rows(neighbors0, dists0, append_i, append_d, aff, m_max: int):
    """Merge the appended reverse edges into rows ``aff`` and keep the
    closest ``m_max``, in place (``_prune_rows_impl`` without the MN-RU
    tiebreak, the branch a bulk build takes)."""
    cat_i = torch.cat([neighbors0[aff], append_i[aff]], dim=1)
    cat_d = torch.cat([dists0[aff], append_d[aff]], dim=1)
    new_d, new_i = sorted_topk_unique(cat_d, cat_i, m_max)
    neighbors0[aff] = new_i
    dists0[aff] = torch.where(new_i >= 0, new_d, _INF)


def _upper_select(vectors, members, pool, m: int, metric: Metric):
    """Exact closest-``m`` of each member within the level pool (-1 pads
    and self-matches masked). Returns ``[P, m]`` int32 slots."""
    mv = vectors[members.long()]
    pv = vectors[pool.clamp(min=0).long()]
    dd = pairwise_distances(mv, pv, metric)
    mask = (pool >= 0)[None, :] & (members[:, None] != pool[None, :])
    _, sel = masked_topk(dd, m, mask=mask, ids=pool[None, :])
    return sel


def _hi_reverse_wire(hi_neighbors, hi_index, vectors, o_arr, s_arr,
                     lvl: int, m: int, metric: Metric) -> None:
    """Upper-level reverse wiring, in place: each owner ``o_arr[e]`` gains
    ``s_arr[e]`` (bounded appends grouped by the owner's hi row), then its
    row is pruned to the closest ``m`` with distances recomputed from the
    owner's vector (upper levels store no edge distances). Entries with an
    owner outside the hi table or a -1 neighbour are dropped."""
    h = hi_neighbors.shape[0]
    dev = hi_neighbors.device
    o = o_arr.long()
    ho = torch.where(o >= 0, hi_index[o.clamp(min=0)].long(), -1)
    valid = (ho >= 0) & (s_arr >= 0)
    hom = torch.where(valid, ho, h)
    order = torch.sort(hom, stable=True).indices
    ho_s = hom[order]
    first = torch.searchsorted(ho_s, ho_s, side="left")
    pos = torch.arange(ho_s.shape[0], device=dev) - first
    keep = (ho_s < h) & (pos < m)
    appends = torch.full((h * m,), -1, dtype=torch.int32, device=dev)
    appends[ho_s[keep] * m + pos[keep]] = s_arr[order][keep]
    appends = appends.reshape(h, m)
    # one prune per owner: the first entry of each valid group
    lead = (ho_s < h) & (pos == 0)
    rows_h = ho_s[lead]
    owners = o[order][lead]
    cand = torch.cat([hi_neighbors[rows_h, lvl], appends[rows_h]], dim=1)
    dd = gathered_distances(vectors[owners], vectors[cand.clamp(min=0).long()],
                            metric)
    dd = torch.where(cand >= 0, dd, _INF)
    _, new_rows = sorted_topk_unique(dd, cand, m)
    hi_neighbors[rows_h, lvl] = new_rows


# ───────────────────────── index class ─────────────────────────


@dataclass
class HnswParams:
    """The reference's create-time knobs (``src/hnsw_vtab.c:80-134``)."""

    dim: int
    metric: Metric = Metric.L2
    m: int = 16
    ef_construction: int = 200


class HnswIndex:
    """HNSW approximate nearest-neighbour index on ``device``.

    ``insert(ids, vectors)`` into an empty index builds the graph in bulk;
    ``search(queries, k, ef_search)`` with ``ef_search`` defaulting to
    ``2 * k`` (``src/hnsw_vtab.c:586-619``). Knobs of this path, as in the
    JAX package: ``expand``, ``wave_size``, ``route_entries``,
    ``build_precision``, ``search_quant`` ("bf16" or "int8" beam
    guidance), ``beam_patience``, ``beam_max_iters``, ``beam_dedup``,
    ``search_degree``, ``beam_topm``, ``beam_whole``, ``beam_pick_xfer``,
    ``pack_budget_bytes``, ``exact_small_n``. ``device`` is the card unless
    ``device="cpu"``.
    """

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        m: int = 16,
        ef_construction: int = 200,
        *,
        capacity: int = 2048,
        seed: int = 42,
        expand: int = 4,
        wave_size: int = 1024,
        device: str | torch.device = "cuda",
    ):
        if m < 2:
            raise ValueError("m must be >= 2")
        self.params = HnswParams(int(dim), parse_metric(metric), int(m),
                                 int(ef_construction))
        self.store = VectorStore(dim, capacity, device=device)
        self.device = self.store.device
        self.m = int(m)
        self.m0 = 2 * int(m)  # M_max0 = 2*M, src/hnsw_algo.c:188
        self.ef_construction = int(ef_construction)
        self.expand = int(expand)
        self.wave_size = int(wave_size)
        self._rng = np.random.default_rng(seed)  # level sampling
        self.level_mult = 1.0 / np.log(m)

        cap = self.store.capacity
        self.neighbors0 = torch.full((cap, self.m0), -1, dtype=torch.int32,
                                     device=self.device)
        self.dists0 = torch.full((cap, self.m0), _INF, device=self.device)
        self.levels = np.full((cap,), -1, np.int32)
        self.hi_levels_width = 8  # levels 1..8 stored; P(level > 8) ~ M^-8
        hi_cap = max(cap // max(self.m // 2, 2), 64)
        self.hi_index = torch.full((cap,), -1, dtype=torch.int32,
                                   device=self.device)
        self._hi_index_np = np.full((cap,), -1, np.int32)
        self.hi_neighbors = torch.full(
            (hi_cap, self.hi_levels_width, self.m), -1, dtype=torch.int32,
            device=self.device,
        )
        self._hi_count = 0
        self.entry_point = -1  # slot, not external id
        self.max_level = -1
        self.route_entries = 8  # beam seeds from the exact router
        self.build_precision = "default"  # the bulk kNN sweep's flat_topk
        # beam guidance: "bf16" rows, or "int8" rows with one scale per row
        # (a quarter of the f32 bytes); the exact rescore stays f32
        self.search_quant = "bf16"
        self.beam_patience = 0    # 0: the reference's max(ef/4, 10)
        self.beam_max_iters = 0   # 0: ceil(ef/expand) + 1; < 0: converge
        self.beam_dedup = True
        # search over only the first search_degree neighbours of each row
        # (rows are distance-sorted): None, or >= 2M, reads them all
        self.search_degree: int | None = None
        self._sd_cache: tuple | None = None
        # > 0: each pick keeps its beam_topm best candidates in the top-m
        # kernel (ops.beam.gather_block_topm), so the dedup and merge run
        # over expand * beam_topm candidates; bf16 guidance with a packed
        # table only, capped at the (sliced) R0, where it is the dots path
        self.beam_topm = 0
        # the whole level-0 beam in one kernel (ops.beam_loop): False, True
        # (on a CUDA index) or "force" (on any device); bf16 guidance only,
        # otherwise the fused path runs
        self.beam_whole: bool | str = False
        # the TPU kernel's pick transfer, "dma" or "scalar": kept for parity,
        # the same results either way
        self.beam_pick_xfer = "dma"
        # the packed [cap, R0, d] bf16 (or int8, with [cap, R0] scales)
        # neighbour table: built at the first search after a bulk build on
        # a CUDA device when it fits the budget; on the CPU only through
        # pack_neighbors()
        self.pack_budget_bytes = 4 << 30
        # at or below this many stored rows, search is exact flat_topk
        self.exact_small_n = 8192
        self._pool_cache: torch.Tensor | None = None
        self._pool_dirty = True
        self._packed: torch.Tensor | None = None
        self._packed_scales: torch.Tensor | None = None
        self._packed_quant = "bf16"  # the guidance the packed table holds
        self._packed_auto = True
        self._v16: torch.Tensor | None = None
        self._v8: tuple[torch.Tensor, torch.Tensor] | None = None
        self._pool_vecs_cache: torch.Tensor | None = None

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def metric(self) -> Metric:
        return self.params.metric

    def __len__(self) -> int:
        return len(self.store)

    # ── capacity and levels ──

    def _sync_capacity(self) -> None:
        cap = self.store.capacity
        old = self.neighbors0.shape[0]
        if cap == old:
            return
        grow = cap - old
        self.neighbors0 = torch.nn.functional.pad(
            self.neighbors0, (0, 0, 0, grow), value=-1)
        self.dists0 = torch.nn.functional.pad(
            self.dists0, (0, 0, 0, grow), value=_INF)
        self.levels = np.pad(self.levels, (0, grow), constant_values=-1)
        self.hi_index = torch.nn.functional.pad(self.hi_index, (0, grow),
                                                value=-1)
        self._hi_index_np = np.pad(self._hi_index_np, (0, grow),
                                   constant_values=-1)
        need_hi = max(cap // max(self.m // 2, 2), 64)
        self._grow_hi(need_hi)

    def _grow_hi(self, rows: int) -> None:
        have = self.hi_neighbors.shape[0]
        if rows > have:
            self.hi_neighbors = torch.nn.functional.pad(
                self.hi_neighbors, (0, 0, 0, 0, 0, rows - have), value=-1)

    def _sample_levels(self, n: int) -> np.ndarray:
        """Geometric levels ``floor(-ln(U) / ln(M))``, capped
        (``random_level``, src/hnsw_algo.c:240-248)."""
        u = np.maximum(self._rng.random(n), 1e-10)
        lv = np.floor(-np.log(u) * self.level_mult).astype(np.int32)
        return np.minimum(lv, HNSW_MAX_LEVELS - 1)

    # ── search ──

    def search_device(self, queries, k: int = 10,
                      ef_search: int | None = None):
        """Top-k with the results left on the index's device, in slot space:
        ``(dists f32 [B, k], slots int32 [B, k])`` tensors
        (``self.store.ids_of`` maps them to external ids)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if ef_search is None:
            ef_search = 2 * k
        ef = max(ef_search, k)
        b = q.shape[0]
        if self.entry_point < 0:
            return (torch.full((b, k), _INF, device=self.device),
                    torch.full((b, k), -1, dtype=torch.int32,
                               device=self.device))
        hw = self.store.high_watermark
        if hw <= self.exact_small_n:
            return flat_topk(
                q, self.store.vectors[:hw], k, metric=self.metric,
                corpus_valid=self.store.valid[:hw], precision="highest",
            )
        pool = self._routing_pool()
        if pool is None:
            raise NotImplementedError(
                "search of a graph without promoted nodes (greedy descent"
                " from the entry point) is not ported yet (see ROADMAP.md,"
                " queue 1)"
            )
        return self._search_topk_chunked(q, k, ef)

    def search(self, queries, k: int = 10, ef_search: int | None = None):
        """Batched KNN. Returns ``(ids int64 [B, k], dists f32 [B, k])``
        numpy arrays, ascending; empty slots are (-1, inf). A single query
        gives 1-D arrays."""
        single = np.ndim(queries) == 1
        d, slots = self.search_device(queries, k, ef_search)
        ids = self.store.ids_of(slots.cpu().numpy())
        d = d.cpu().numpy()
        return (ids[0], d[0]) if single else (ids, d)

    def _int8_guidance(self) -> bool:
        """Whether the beam is guided by int8 rows; a ``search_quant``
        outside ``SEARCH_QUANTS`` raises."""
        if self.search_quant not in SEARCH_QUANTS:
            raise ValueError(
                f"search_quant must be one of {SEARCH_QUANTS}, got"
                f" {self.search_quant!r}"
            )
        return self.search_quant == "int8"

    def _search_topk_chunked(self, q: torch.Tensor, k: int, ef: int):
        int8 = self._int8_guidance()
        pool = self._routing_pool()
        pv = self._pool_vecs(pool)
        r = min(self.route_entries, ef)
        if self.beam_max_iters == 0:
            mi = -(-ef // max(self.expand, 1)) + 1  # about ef expansions
        elif self.beam_max_iters < 0:
            mi = 0                                  # to convergence
        else:
            mi = self.beam_max_iters

        # the whole-beam path (hnsw.py:820-845), checked before the fused
        # path's table is built; it reads the same packed bf16 table
        whole = self.beam_whole == "force" or (
            bool(self.beam_whole) and self.device.type == "cuda")
        if whole and not int8:
            packed = self._maybe_packed(force=self.beam_whole == "force")
            if packed is not None:
                nbrs0, packed, _ = self._search_tables(packed, None)
                v16 = self._vecs16()

                def one_whole(qc):
                    return _search_topk_whole(
                        qc, pool, pv, self.store.vectors, v16, packed, nbrs0,
                        self.store.valid, self.metric, k, ef, self.expand, r,
                        self.beam_patience, mi, self.beam_pick_xfer,
                    )

                return self._run_chunked(q, one_whole)

        scales = None
        if int8:
            v16, scales = self._vecs8()
        else:
            v16 = self._vecs16()
        packed = self._maybe_packed()
        pscales = self._packed_scales if packed is not None else None
        nbrs0, packed, pscales = self._search_tables(packed, pscales)
        # the top-m kernel takes f32/bf16 blocks (hnsw.py:889-890)
        topm = (max(0, min(self.beam_topm, nbrs0.shape[1]))
                if packed is not None and pscales is None else 0)

        def one(qc):
            return _search_topk_fused(
                qc, pool, pv, self.store.vectors, v16, nbrs0,
                self.store.valid, self.metric, k, ef, self.expand, r,
                self.beam_patience, packed, self.beam_dedup, mi, scales,
                pscales, topm,
            )

        return self._run_chunked(q, one)

    def _search_tables(self, packed: torch.Tensor | None,
                       pscales: torch.Tensor | None):
        """``(neighbors0, packed, pscales)`` as the beam reads them: their
        first ``search_degree`` columns when that is below ``2M``
        (``hnsw.py:850-869``). The slices are copied once and cached, keyed
        on the knob and the identity of the source tables, which the cache
        keeps alive so that the identity stays sound; every mutation of the
        graph goes through ``_invalidate_search_caches``, which drops it."""
        sd = self.search_degree
        if not sd or sd >= self.m0:
            return self.neighbors0, packed, pscales
        c = self._sd_cache
        if not (c is not None and c[0] == sd and c[1] is self.neighbors0
                and c[2] is packed and c[3] is pscales):
            def cut(t):
                return None if t is None else t[:, :sd].contiguous()

            self._sd_cache = c = (sd, self.neighbors0, packed, pscales,
                                  cut(self.neighbors0), cut(packed),
                                  cut(pscales))
        return c[4], c[5], c[6]

    def _run_chunked(self, q: torch.Tensor, one):
        """Run ``one`` over query chunks of balanced, 256-aligned size, at
        most ``2**29 / capacity`` (1,024 to 8,192) queries each."""
        b = q.shape[0]
        chunk = int(max(1024, min(8192, (1 << 29) // max(self.store.capacity, 1))))
        if b <= chunk:
            return one(q)
        n_chunks = -(-b // chunk)
        chunk = -(-(-(-b // n_chunks)) // 256) * 256
        qp = torch.nn.functional.pad(q, (0, 0, 0, n_chunks * chunk - b))
        parts = [one(qp[s : s + chunk]) for s in range(0, qp.shape[0], chunk)]
        return (torch.cat([p[0] for p in parts])[:b],
                torch.cat([p[1] for p in parts])[:b])

    def _vecs16(self) -> torch.Tensor:
        if self._v16 is None:
            self._v16 = self.store.vectors.bfloat16()
        return self._v16

    def _vecs8(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The int8 guidance shadow: rows quantized as stored (not
        normalised), one f32 scale per row (``hnsw.py:979-982``)."""
        if self._v8 is None:
            self._v8 = quantize_rows_int8(self.store.vectors)
        return self._v8

    def _pool_vecs(self, pool: torch.Tensor) -> torch.Tensor:
        if self._pool_vecs_cache is None:
            self._pool_vecs_cache = self.store.vectors[pool.clamp(min=0).long()]
        return self._pool_vecs_cache

    def _invalidate_search_caches(self) -> None:
        self._v16 = None
        self._v8 = None
        self._pool_vecs_cache = None
        self._packed = None
        self._packed_scales = None
        self._sd_cache = None
        self._packed_auto = False  # a bulk build turns it back on

    def pack_neighbors(self) -> None:
        """(Re)build the packed neighbour table for the current
        ``search_quant``, on any device, and turn packing back on."""
        self._packed_auto = True
        self._packed = None
        self._packed_scales = None
        self._sd_cache = None
        self._maybe_packed(force=True)

    def _maybe_packed(self, force: bool = False) -> torch.Tensor | None:
        """The packed ``[cap, R0, d]`` table of the beam's guidance,
        ``v16[neighbors0]`` (bf16), or ``v8[neighbors0]`` (int8) with the
        neighbours' scales in ``_packed_scales [cap, R0]``; rebuilt when
        ``search_quant`` changed (``hnsw.py:1007-1032``). Built on a CUDA
        device when packing is on, on the CPU only when ``force``d; None
        over ``pack_budget_bytes``."""
        int8 = self._int8_guidance()
        if self._packed is not None and self._packed_quant == self.search_quant:
            return self._packed
        if self._packed is None and not (self._packed_auto or force):
            return None
        need = self.store.capacity * self.m0 * self.dim * (1 if int8 else 2)
        if need > self.pack_budget_bytes:
            return None
        if self.device.type == "cpu" and not force:
            return None  # CPU: keep the row path exercised
        # one gather of the whole table, not one per row
        nb = self.neighbors0.clamp(min=0).long()
        if int8:
            vi, sc = self._vecs8()
            self._packed, self._packed_scales = vi[nb], sc[nb]
        else:
            self._packed, self._packed_scales = self._vecs16()[nb], None
        self._packed_quant = self.search_quant
        return self._packed

    def _routing_pool(self) -> torch.Tensor | None:
        """Promoted (level >= 1) slots, -1-padded to a power of two; None
        while the graph has no promoted node."""
        if self._pool_dirty:
            members = np.nonzero(self.levels >= 1)[0].astype(np.int32)
            self._pool_cache = (
                None if len(members) == 0
                else torch.as_tensor(_pow2_pad(members), device=self.device)
            )
            self._pool_vecs_cache = None
            self._pool_dirty = False
        return self._pool_cache

    # ── insert ──

    def insert(self, ids, vectors) -> None:
        """Insert into an empty index of at least ``4 * wave_size`` rows:
        builds the level-0 graph as the exact kNN graph (one chunked
        ``flat_topk`` sweep of the corpus against itself), symmetrised and
        pruned, and wires the upper levels exactly."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(self) != 0 or len(ids) < 4 * self.wave_size:
            raise NotImplementedError(
                "only the bulk build is ported (an insert of at least"
                f" 4 * wave_size = {4 * self.wave_size} rows into an empty"
                " index); insert waves are not ported yet (see ROADMAP.md,"
                " queue 1)"
            )
        self._invalidate_search_caches()
        self._bulk_build(ids, vectors)

    def _bulk_build(self, ids: np.ndarray, vectors) -> None:
        n = len(ids)
        slots = self.store.add(ids, vectors)
        self._sync_capacity()
        levels = self._sample_levels(n)
        self.levels[slots] = levels
        self.entry_point = int(slots[int(np.argmax(levels))])
        self.max_level = int(levels.max())

        promoted = np.nonzero(levels >= 1)[0]
        if len(promoted):
            hi_rows = np.arange(self._hi_count, self._hi_count + len(promoted),
                                dtype=np.int32)
            self._hi_count += len(promoted)
            if self._hi_count > self.hi_neighbors.shape[0]:
                self._grow_hi(2 * self._hi_count)
            self.hi_index[torch.as_tensor(slots[promoted], dtype=torch.long,
                                          device=self.device)] = (
                torch.as_tensor(hi_rows, device=self.device))
            self._hi_index_np[slots[promoted]] = hi_rows
            self._pool_dirty = True

        # exact kNN rows: the corpus against itself, +1 for the self-match
        corpus = self.store.vectors[: self.store.high_watermark]
        base = int(slots[0])  # bulk slots are contiguous
        chunks_i, chunks_d = [], []
        for s in range(0, n, _SWEEP_ROWS):
            e = min(s + _SWEEP_ROWS, n)
            dd, ii = flat_topk(
                corpus[base + s : base + e], corpus, self.m0 + 1,
                metric=self.metric, precision=self.build_precision,
            )
            ci, cd = _drop_self_matches(dd, ii, base + s, self.m0)
            chunks_i.append(ci)
            chunks_d.append(cd)
        self._finish_bulk(slots, promoted, levels, torch.cat(chunks_i),
                          torch.cat(chunks_d))

    def _finish_bulk(self, slots, promoted, levels, rows_i, rows_d) -> None:
        """Forward wiring, one reverse-append pass, the prune sweep, upper
        levels."""
        slots_t = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.neighbors0[slots_t] = rows_i
        self.dists0[slots_t] = rows_d
        append_i, append_d = _grouped_bounded_append(
            rows_i.reshape(-1),
            slots_t.to(torch.int32).repeat_interleave(self.m0),
            rows_d.reshape(-1), self.neighbors0.shape[0], self.m0,
        )
        for s in range(0, len(slots), _SWEEP_ROWS):
            _prune_rows(self.neighbors0, self.dists0, append_i, append_d,
                        slots_t[s : s + _SWEEP_ROWS], self.m0)
        if len(promoted):
            self._wire_upper_levels(slots, levels, promoted)
        self._packed_auto = True  # a bulk build is a settled graph

    def _wire_upper_levels(self, slots, levels, promoted) -> None:
        """Wire the promoted nodes at each level 1..their level: exact
        closest-M among all nodes of that level, then a reverse append and
        closest-M prune (``hnsw.py:1330-1399``)."""
        top = int(levels[promoted].max())
        for lv in range(1, min(top, self.hi_levels_width) + 1):
            members = slots[levels >= lv].astype(np.int32)
            pool = np.nonzero(self.levels >= lv)[0].astype(np.int32)
            if len(members) == 0 or len(pool) <= 1:
                continue
            pool_t = torch.as_tensor(_pow2_pad(pool), device=self.device)
            # bound the [P, pool] distance block
            mchunk = max(256, min(4096, (1 << 26) // len(pool)))
            o_parts, s_parts = [], []
            for s0 in range(0, len(members), mchunk):
                wm = members[s0 : s0 + mchunk]
                sel = _upper_select(
                    self.store.vectors,
                    torch.as_tensor(wm, device=self.device), pool_t, self.m,
                    self.metric,
                )
                rows = self._hi_index_np[wm]
                keep = rows >= 0
                self.hi_neighbors[
                    torch.as_tensor(rows[keep], dtype=torch.long,
                                    device=self.device), lv - 1
                ] = sel[torch.as_tensor(keep, device=self.device)]
                o_parts.append(sel.cpu().numpy().reshape(-1))
                s_parts.append(np.repeat(wm, self.m))
            # reverse edges: each chosen o gains the member s
            o_list = np.concatenate(o_parts)
            s_list = np.concatenate(s_parts)
            ok = (o_list >= 0) & (s_list >= 0)
            o_list = np.where(ok, o_list, -1).astype(np.int32)
            s_list = np.where(ok, s_list, -1).astype(np.int32)
            # bound the prune's [E, 2m, d] gather
            echunk = max(4096, min(65536, (1 << 28) // (self.dim * 2 * self.m)))
            for s0 in range(0, len(o_list), echunk):
                _hi_reverse_wire(
                    self.hi_neighbors, self.hi_index, self.store.vectors,
                    torch.as_tensor(o_list[s0 : s0 + echunk], device=self.device),
                    torch.as_tensor(s_list[s0 : s0 + echunk], device=self.device),
                    lv - 1, self.m, self.metric,
                )
