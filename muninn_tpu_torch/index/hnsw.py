"""HNSW approximate nearest-neighbour index, the PyTorch port of
``muninn_tpu/index/hnsw.py``: bulk build, insert waves, delete with
repair, and every search route.

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
- Insert waves (every other insert, ``wave_size`` rows at a time): the
  wave's candidates are one ``flat_topk`` over the pre-wave live rows at
  ``build_precision`` (``insert_mode = "exact"``), or an f32 level-0 beam
  at ``ef_construction`` (``"beam"``), merged with the wave's own closest
  rows; the closest ``2M`` are wired forward, then reverse, and the rows
  that gained edges are pruned by (distance ascending, mutual-neighbour
  count descending), the MN-RU rule (``mn_ru``). Upper levels of a wave's
  promoted nodes are queued and wired exactly by ``_flush_hi_wiring``.
- Delete: soft delete, then every live row that pointed at a deleted slot
  drops those edges and refills from the deleted nodes' former
  neighbourhoods (``flat_topk`` at ``highest``; on a CUDA f32 store one
  ``ops.delete_repair`` kernel launch a wave, over lists that stay on the
  card); the entry point is rescanned when it died.
- Slots: with ``reuse_slots`` (the default) a wave takes the slots and
  upper-level rows that deletes freed, lowest first, before new ones, so
  that steady churn keeps the capacity; the JAX package never reuses a
  slot (``reuse_slots=False`` keeps its slot numbers). A write keeps the
  search's bf16 / int8 shadows and packed table: it patches the shadow
  rows it wrote and marks in a device mask every row whose neighbours
  changed, and the next search re-gathers those rows alone.
- Search: exact routing over the promoted pool (``flat_topk`` at
  ``precision="default"``), a level-0 beam guided by bf16 vectors, or by
  int8 ones with one scale per row (``search_quant = "int8"``), whose
  expansions read packed ``[R0, d]`` neighbour blocks through
  ``ops.beam.gather_block_dots``, then an exact f32 rescore of the beam. On
  the card each step of that beam is one ``ops.beam_step`` kernel launch
  wherever ``ops.beam_step.step_engine`` admits its inputs.
  Below ``exact_small_n`` stored rows search is exact ``flat_topk``. Two
  other beam engines over the same packed bf16 table: ``beam_topm > 0``
  keeps each pick's best candidates in ``ops.beam.gather_block_topm``, and
  ``beam_whole`` runs the whole beam in one ``ops.beam_loop.beam_loop``
  kernel per query. ``search_degree`` searches only the first columns of
  each neighbour row, in every engine. A graph without promoted nodes
  starts its beam at the entry point, and ``search_bf16 = False`` routes
  and searches in f32 (``_search_slots``).

PyTorch runs eagerly: the beam's ``lax.while_loop`` is a Python loop of at
most ``max_iters`` steps that reads one go-on flag back per step. The JAX
package's ``.at[...].set(..., mode="drop")`` has no PyTorch counterpart (an
out-of-range index is a device-side assert on CUDA), so every scatter
here masks its out-of-range indices out first, and the JAX package's
padding of waves, deletes and pools to compiled shapes is left out where
it changes no result.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from muninn_tpu_torch.index.flat import _query_tensor, _search_ids
from muninn_tpu_torch.index.store import VectorStore
from muninn_tpu_torch.ops.beam_loop import beam_loop
from muninn_tpu_torch.ops.beam_step import (
    beam_step,
    beam_step_plain,
    fetch_rows,
    go_on,
    step_engine,
)
from muninn_tpu_torch.ops.delete_repair import delete_repair_cuda, repair_engine
from muninn_tpu_torch.ops.distance import (
    Metric,
    gathered_distances,
    pairwise_distances,
    parse_metric,
    quantize_rows_int8,
    squared_norms,
)
from muninn_tpu_torch.ops.flat_topk import flat_topk
from muninn_tpu_torch.ops.topk import (
    _dedup_ids,
    masked_topk,
    merge_topk,
    smallest_k,
    sorted_topk_unique,
)
from muninn_tpu_torch.tracing import host_read, request, span

HNSW_MAX_LEVELS = 32  # the reference's cap, src/hnsw_algo.h:14
_SWEEP_ROWS = 8192    # rows per chunk of the bulk kNN sweep and the prune
_PRUNE_ROWS = 4096    # rows per chunk of an MN-RU prune: [rows, 4M * 2M] reads
_REPAIR_ROWS = 4096   # affected rows per call of a delete's eager repair
_INF = float("inf")
SEARCH_QUANTS = ("bf16", "int8")  # the beam's guidance rows
INSERT_MODES = ("exact", "beam")  # a wave's candidate source


def _pow2_pad(members: np.ndarray) -> np.ndarray:
    """``members`` -1-padded to a power of two of at least 64."""
    size = 1 << int(np.ceil(np.log2(max(len(members), 64))))
    return np.pad(members, (0, size - len(members)), constant_values=-1)


# ───────────────────────── search ─────────────────────────


def _greedy_descent(
    queries: torch.Tensor,         # [B, d]
    entry: torch.Tensor,           # [B] int32 starting slots
    level_of_query: torch.Tensor,  # [B] int32: descend while level > this
    vectors: torch.Tensor,         # [cap, d]
    hi_index: torch.Tensor,        # [cap] int32 -> row of hi_neighbors, -1
    hi_neighbors: torch.Tensor,    # [cap_hi, L, M] int32
    cur_max_level: int,
    metric: Metric,
    max_steps: int = 64,
) -> torch.Tensor:
    """Greedy 1-beam descent through the upper levels, batched over queries
    (``hnsw.py:75-144``, ``greedy_search_layer`` of src/hnsw_algo.c:257-282
    from the top level down). Eight levels from ``cur_max_level`` down; at
    each, a query above its ``level_of_query`` moves to its closest
    neighbour while that improves, at most ``max_steps`` steps a level for
    the batch. Returns the slots the descent ends on. Neither package's
    search calls it (exact routing over the promoted pool replaces it)."""
    b = queries.shape[0]
    width = hi_neighbors.shape[1]
    cur = entry.clone()
    for lvl_from_top in range(8):
        level = cur_max_level - lvl_from_top
        active = level > level_of_query
        lvl_row = min(max(level - 1, 0), width - 1)
        cur_d = gathered_distances(queries, vectors[cur.clamp(min=0).long()][:, None],
                                   metric)[:, 0]
        cur_d = torch.where(cur >= 0, cur_d, _INF)
        improved = torch.ones(b, dtype=torch.bool, device=queries.device)
        it = 0
        while bool(improved.any()) and it < max_steps:
            rows = hi_index[cur.clamp(min=0).long()]
            nbrs = hi_neighbors[rows.clamp(min=0).long(), lvl_row]
            nbrs = torch.where((rows >= 0)[:, None], nbrs, -1)
            nd = gathered_distances(queries, vectors[nbrs.clamp(min=0).long()], metric)
            nd = torch.where(nbrs >= 0, nd, _INF)
            best_d, best = smallest_k(nd, 1)
            best_i = torch.gather(nbrs, 1, best)[:, 0]
            improved = (best_d[:, 0] < cur_d) & active
            cur = torch.where(improved, best_i, cur)
            cur_d = torch.where(improved, best_d[:, 0], cur_d)
            it += 1
    return cur


def _route_entries(q: torch.Tensor, vectors: torch.Tensor, pool: torch.Tensor,
                   metric: Metric, r: int) -> torch.Tensor:
    """Exact f32 routing (``hnsw.py:148-164``): the ``r`` nearest promoted
    slots of each query by ``pairwise_distances`` over the pooled rows, -1
    where the pool has fewer."""
    dd = pairwise_distances(q, vectors[pool.clamp(min=0).long()], metric)
    _, sel = masked_topk(dd, r, mask=(pool >= 0)[None, :], ids=pool[None, :])
    return sel


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

    A step is ``ops.beam_step.beam_step_plain``, or, where
    ``step_engine`` admits the inputs (a CUDA beam over a packed table,
    ``topm == 0``, ``ef`` and ``E * R0`` within the kernel's limits), one
    ``beam_step`` kernel launch with the same results, which ORs the next
    step's go-on flag into a device flag; the ``hnsw.beam`` span's
    ``engine`` attribute says which ("kernel" or "eager"). With ``packed``,
    candidates are scored from the picks' packed blocks through
    ``gather_block_dots`` (the kernel on CUDA, its plain version on the
    CPU); without, from rows of ``vectors``. int8 guidance
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
    with span("hnsw.beam", rows=queries.shape[0]) as beam:
        b = queries.shape[0]
        dev = queries.device
        r0 = neighbors0.shape[1]
        expand = min(expand, ef)
        if patience <= 0:
            patience = max(ef // 4, 10)  # counted in expansions
        if max_iters <= 0:
            max_iters = 2 * (ef // expand + 1) + patience // expand + 8
        engine = step_engine(dev, packed, topm, ef, expand)
        beam.set(engine=engine)

        qf = queries.float().contiguous()
        qn2 = squared_norms(qf)[:, None]

        if entry.ndim == 1:
            entry = entry[:, None]
        r_ent = entry.shape[1]
        e_d = gathered_distances(
            qf, fetch_rows(vectors, scales, entry.clamp(min=0).long()), metric)
        beam_d = torch.full((b, ef), _INF, device=dev)
        beam_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
        beam_d[:, :r_ent] = torch.where(entry >= 0, e_d, _INF)
        beam_i[:, :r_ent] = entry
        expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
        stall = torch.zeros(b, dtype=torch.int64, device=dev)
        if engine == "kernel":
            # one go-on flag a step, zeroed once: each step's launch ORs in
            # the next step's, so the host reads a flag and launches nothing
            # else
            flags = torch.zeros(max_iters + 1, dtype=torch.int32, device=dev)
            flags[0] = go_on(beam_i, expanded, stall, patience)
        else:
            use_topm = packed is not None and topm > 0 and pscales is None
            c = expand * (topm if use_topm else r0)
            earlier = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)

        steps = 0  # loop iterations entered, each one host read
        for step in range(max_iters):
            with span("hnsw.beam_step", step=step):
                flag = (flags[step] if engine == "kernel"
                        else go_on(beam_i, expanded, stall, patience))
                steps += 1
                with span("hnsw.step_read"):
                    go = host_read("hnsw_beam", flag)
                if not go:
                    break
                if engine == "kernel":
                    beam_d, beam_i, expanded, stall = beam_step(
                        qf, qn2, beam_d, beam_i, expanded, stall, neighbors0,
                        packed, metric, expand, patience, pscales=pscales,
                        dedup=dedup, flag=flags[step + 1 : step + 2])
                else:
                    beam_d, beam_i, expanded, stall = beam_step_plain(
                        qf, qn2, beam_d, beam_i, expanded, stall, neighbors0,
                        metric, expand, patience, packed=packed,
                        pscales=pscales, dedup=dedup, topm=topm,
                        vectors=vectors, scales=scales, earlier=earlier)
        beam.set(steps=steps)
    return beam_d, beam_i


def _route(q: torch.Tensor, pool: torch.Tensor, pv: torch.Tensor,
           metric: Metric, r: int) -> torch.Tensor:
    """Exact routing: the ``r`` nearest promoted slots of each query
    (``flat_topk`` at ``precision="default"`` over the pooled rows), -1
    where the pool has fewer."""
    with span("hnsw.route", rows=q.shape[0]):
        _, sel = flat_topk(q, pv, r, metric=metric, precision="default",
                           corpus_valid=pool >= 0)
        return torch.where(sel >= 0, pool[sel.clamp(min=0).long()], -1)


def _rescore_topk(q: torch.Tensor, vectors: torch.Tensor, valid: torch.Tensor,
                  beam_i: torch.Tensor, metric: Metric, k: int):
    """Soft-delete filter, exact f32 rescore of the beam's rows, top-k: the
    bf16 (or int8) beam decides which rows, the f32 store their
    distances."""
    with span("hnsw.rescore", rows=q.shape[0]):
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
    with span("hnsw.beam_whole", rows=b):
        _, beam_i = beam_loop(q, init_d, init_i, packed, neighbors0, metric,
                              ef, expand, patience, max_iters, pick_xfer)
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


def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Positions that sort each row by ``major``, then ``minor``, equal
    pairs in order of position: ``jnp.lexsort((minor, major))`` as two
    stable sorts, the minor key first."""
    order = torch.sort(minor, dim=1, stable=True).indices
    by_major = torch.sort(torch.gather(major, 1, order), dim=1, stable=True).indices
    return torch.gather(order, 1, by_major)


def _mutual_counts(cat_i: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``mn[a, c]``: how many entries of candidate ``cat_i[a, c]``'s row of
    ``table`` are among row ``a``'s own candidates, -1 for a -1 candidate
    (``count_mutual_neighbors``, src/hnsw_algo.c:460-475). Each entry is
    looked up by a binary search of the row's sorted candidate list, so the
    work is ``[A, C * R0]``, not JAX's fused ``[A, C, R0, C]`` compare."""
    a, c = cat_i.shape
    cand_rows = table[cat_i.clamp(min=0).long()].reshape(a, -1)
    srt = torch.sort(cat_i, dim=1).values
    pos = torch.searchsorted(srt, cand_rows).clamp(max=c - 1)
    member = (torch.gather(srt, 1, pos) == cand_rows) & (cand_rows >= 0)
    mn = member.reshape(a, c, -1).sum(dim=2)
    return torch.where(cat_i >= 0, mn, -1)


def _mn_ru_select(cat_d, cat_i, table, m_max: int):
    """The MN-RU prune of rows of candidates (``hnsw.py:1684-1699``): drop
    repeated ids (the closest copy stays), then keep the first ``m_max`` by
    distance ascending, mutual-neighbour count in ``table`` descending. A
    count depends on the candidate's id and the row's set of ids alone, so
    it is taken after the repeats are dropped."""
    sd, si = _dedup_ids(cat_d, cat_i)
    order = _lexsort(-_mutual_counts(si, table), sd)[:, :m_max]
    return torch.gather(sd, 1, order), torch.gather(si, 1, order)


def _prune_rows(neighbors0, dists0, append_i, append_d, aff, m_max: int,
                mn_tiebreak: bool = False) -> None:
    """Merge the appended reverse edges into the distinct rows ``aff`` and
    keep ``m_max`` of each, in place, in chunks (``_prune_rows_impl``,
    ``hnsw.py:1646-1703``): the closest, or with ``mn_tiebreak`` the MN-RU
    rule (src/hnsw_algo.c:593-646), where equal distances keep the
    candidate sharing more neighbours with the row's candidate list. Every
    chunk counts those neighbours in the table as it was before the first
    chunk wrote, as JAX's one functional update does."""
    table = neighbors0.clone() if mn_tiebreak else None
    step = _PRUNE_ROWS if mn_tiebreak else _SWEEP_ROWS
    for s in range(0, aff.shape[0], step):
        rows = aff[s : s + step]
        cat_i = torch.cat([neighbors0[rows], append_i[rows]], dim=1)
        cat_d = torch.cat([dists0[rows], append_d[rows]], dim=1)
        if mn_tiebreak:
            new_d, new_i = _mn_ru_select(cat_d, cat_i, table, m_max)
        else:
            new_d, new_i = sorted_topk_unique(cat_d, cat_i, m_max)
        neighbors0[rows] = new_i
        dists0[rows] = torch.where(new_i >= 0, new_d, _INF)


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


# ───────────────────────── delete ─────────────────────────


def _delete_lists(nb: torch.Tensor, slots: torch.Tensor, dead: torch.Tensor,
                  m0: int):
    """A delete wave's lists, made on ``nb``'s device with no host read
    (the sets of ``hnsw.py:1442-1452``): the ``[cap]`` mask of the live rows
    that point at a deleted slot; those rows, ascending, -1-padded to ``cap``;
    the repair pool, the deleted rows' neighbours that are live, ascending,
    -1-padded to ``min(cap, len(slots) * m0)``; and their two counts (int64
    ``[2]``). ``slots``: the wave's deleted slots (int64), ``dead``: them as
    a ``[cap]`` mask."""
    cap = nb.shape[0]
    refs = ((nb >= 0) & dead[nb.clamp(min=0).long()]).any(dim=1) & ~dead
    held = nb[slots].reshape(-1).long()
    in_pool = torch.zeros(cap + 1, dtype=torch.bool, device=nb.device)
    # -1 lands past the table
    in_pool.index_fill_(0, torch.where(held >= 0, held, cap), True)
    in_pool = in_pool[:cap] & ~dead
    aff = torch.nonzero_static(refs, size=cap, fill_value=-1)[:, 0]
    pool = torch.nonzero_static(in_pool, size=min(cap, len(slots) * m0),
                                fill_value=-1)[:, 0]
    return refs, aff, pool, torch.stack((refs.sum(), in_pool.sum()))


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

    The reference's vtab surface (``src/hnsw_vtab.c``): ``insert(ids,
    vectors)`` (a bulk build into an empty index, insert waves otherwise),
    ``delete(ids)``, and ``search(queries, k, ef_search)`` with
    ``ef_search`` defaulting to ``2 * k`` (``:586-619``). Knobs, as in the
    JAX package: ``expand``, ``wave_size``, ``mn_ru``, ``insert_mode``
    ("exact" or "beam"), ``route_entries``, ``build_precision``,
    ``search_bf16``, ``search_quant`` ("bf16" or "int8" beam guidance),
    ``beam_patience``, ``beam_max_iters``, ``beam_dedup``,
    ``search_degree``, ``beam_topm``, ``beam_whole``, ``beam_pick_xfer``,
    ``pack_budget_bytes``, ``exact_small_n``; ``seed_rng(seed)`` resets the
    level sampling. ``reuse_slots`` (default True) lets waves take the slots
    that deletes freed; False keeps the JAX package's slot numbers. ``device``
    is the card unless ``device="cpu"``.
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
        mn_ru: bool = True,
        device: str | torch.device = "cuda",
        reuse_slots: bool = True,
    ):
        if m < 2:
            raise ValueError("m must be >= 2")
        self.params = HnswParams(int(dim), parse_metric(metric), int(m),
                                 int(ef_construction))
        self.store = VectorStore(dim, capacity, device=device,
                                 reuse_slots=reuse_slots)
        self.device = self.store.device
        self.m = int(m)
        self.m0 = 2 * int(m)  # M_max0 = 2*M, src/hnsw_algo.c:188
        self.ef_construction = int(ef_construction)
        self.expand = int(expand)
        self.wave_size = int(wave_size)
        # MN-RU tiebreak in the prunes of insert waves (arXiv:2407.07871);
        # a bulk build prunes by distance alone
        self.mn_ru = bool(mn_ru)
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
        # upper-level rows freed by deletes, ascending (with reuse_slots)
        self._hi_free = np.zeros(0, np.int32)
        # promotions of insert waves, (slots, levels), wired into the upper
        # levels by _flush_hi_wiring
        self._hi_pending: list[tuple[np.ndarray, np.ndarray]] = []
        self.entry_point = -1  # slot, not external id
        self.max_level = -1
        self.route_entries = 8  # beam seeds from the exact router
        # the flat_topk precision of the bulk kNN sweep and of exact waves
        self.build_precision = "default"
        # a wave's candidates: "exact", one flat_topk over the pre-wave live
        # rows; "beam", an f32 level-0 beam at ef_construction
        self.insert_mode = "exact"
        # route with flat_topk and guide the beam by the search_quant shadow
        # (True), or route and search in f32 (False, _search_slots). True on
        # every device; the JAX package defaults to it on a TPU only
        self.search_bf16 = True
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
        # neighbour table: built whole at the first search on a CUDA device
        # when it fits the budget (on the CPU only through pack_neighbors()),
        # then kept through writes, its changed rows re-gathered
        self.pack_budget_bytes = 4 << 30
        # at or below this many stored rows, search is exact flat_topk
        self.exact_small_n = 8192
        self._pool_cache: torch.Tensor | None = None
        self._pool_dirty = True
        self._packed: torch.Tensor | None = None
        self._packed_scales: torch.Tensor | None = None
        self._packed_quant = "bf16"  # the guidance the packed table holds
        # rows of the packed table that writes changed ([cap] bool on the
        # device), and their slots once a write ended: the next search
        # re-gathers them
        self._dirty: torch.Tensor | None = None
        self._dirty_rows: torch.Tensor | None = None
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

    def seed_rng(self, seed: int) -> None:
        """Reset the level-sampling generator (the reference's
        ``hnsw_seed_rng``, src/hnsw_algo.c:222-224)."""
        self._rng = np.random.default_rng(seed)

    # ── capacity and levels ──

    def _sync_capacity(self) -> None:
        cap = self.store.capacity
        old = self.neighbors0.shape[0]
        if cap == old:
            return
        self._drop_search_tables()  # built again whole at the next search
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

    def _alloc_hi(self, n: int) -> np.ndarray:
        """``n`` upper-level rows: freed ones first, lowest first (with
        ``reuse_slots``), then new ones from ``_hi_count``."""
        take = self._hi_free[:n] if self.store.reuse_slots else self._hi_free[:0]
        self._hi_free = self._hi_free[len(take):]
        fresh = np.arange(self._hi_count, self._hi_count + n - len(take),
                          dtype=np.int32)
        self._hi_count += len(fresh)
        return np.concatenate([take, fresh])

    def _reset_hi_free(self) -> None:
        """Rebuild the free upper-level rows: those below ``_hi_count`` that
        no slot holds (none without ``reuse_slots``)."""
        used = self._hi_index_np[self._hi_index_np >= 0]
        self._hi_free = (np.setdiff1d(np.arange(self._hi_count, dtype=np.int32), used)
                         if self.store.reuse_slots else np.zeros(0, np.int32))

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
        with span("index.search_device"):
            q = _query_tensor(queries, self.dim, self.device)
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
            if self.search_bf16 and self._routing_pool() is not None:
                return self._search_topk_chunked(q, k, ef)
            beam_d, beam_i = self._search_slots_chunked(q, ef)
            ok = (beam_i >= 0) & self.store.valid[beam_i.clamp(min=0).long()]
            return sorted_topk_unique(torch.where(ok, beam_d, _INF),
                                      torch.where(ok, beam_i, -1), k)

    def search(self, queries, k: int = 10, ef_search: int | None = None):
        """Batched KNN. Returns ``(ids int64 [B, k], dists f32 [B, k])``
        numpy arrays, ascending; empty slots are (-1, inf). A single query
        gives 1-D arrays."""
        return _search_ids(self, queries, k, ef_search)

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
        keeps alive so that the identity stays sound; every write drops it
        (``_after_write``), since a patch in place keeps the identity."""
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
            with span("hnsw.chunk", rows=b):
                return one(q)
        n_chunks = -(-b // chunk)
        chunk = -(-(-(-b // n_chunks)) // 256) * 256
        qp = torch.nn.functional.pad(q, (0, 0, 0, n_chunks * chunk - b))
        parts = []
        for s in range(0, qp.shape[0], chunk):
            with span("hnsw.chunk", rows=chunk):
                parts.append(one(qp[s : s + chunk]))
        return (torch.cat([p[0] for p in parts])[:b],
                torch.cat([p[1] for p in parts])[:b])

    def _search_slots_chunked(self, q: torch.Tensor, ef: int):
        """``_search_slots`` over query chunks of at most ``2**28 /
        capacity`` (256 to 4,096) queries, which bound the beam's gathers
        (``hnsw.py:914-931``; every query's beam is its own, so the chunks
        need no padding)."""
        chunk = int(max(256, min(4096, (1 << 28) // max(self.store.capacity, 1))))
        parts = [self._search_slots(q[s : s + chunk], ef)
                 for s in range(0, q.shape[0], chunk)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def _search_slots(self, q: torch.Tensor, ef: int):
        """Routing and a level-0 beam without the fused query path
        (``hnsw.py:933-972``), for the searches ``search_device`` sends here:
        the entry point seeds the beam while no node is promoted, else the
        pool routes by exact f32 distances (``search_bf16`` is False then).
        With ``search_bf16`` the beam runs over the bf16 rows and its rows
        are rescored in f32; without, it runs over the f32 rows. Returns
        slot-space beams ``(dists, slots)``, ascending."""
        pool = self._routing_pool()
        if pool is None:
            entries = torch.full((q.shape[0], 1), self.entry_point,
                                 dtype=torch.int32, device=self.device)
        else:
            entries = _route_entries(q, self.store.vectors, pool, self.metric,
                                     min(self.route_entries, ef))
        if not self.search_bf16:
            return _beam_search_level0(q, entries, self.store.vectors,
                                       self.neighbors0, self.metric, ef,
                                       self.expand)
        _, beam_i = _beam_search_level0(q, entries, self._vecs16(),
                                        self.neighbors0, self.metric, ef,
                                        self.expand)
        d = gathered_distances(q, self.store.vectors[beam_i.clamp(min=0).long()],
                               self.metric)
        d, order = torch.sort(torch.where(beam_i >= 0, d, _INF), dim=1, stable=True)
        return d, torch.gather(beam_i, 1, order)

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

    def _drop_search_tables(self) -> None:
        """Drop every search cache: the shadows, the packed table and its
        dirty rows (a bulk build, a change of capacity)."""
        self._v16 = None
        self._v8 = None
        self._packed = None
        self._packed_scales = None
        self._dirty = None
        self._dirty_rows = None
        self._after_write()

    def _after_write(self) -> None:
        """What any write drops: the routing pool's rows and the
        ``search_degree`` slices, whose keys a patch in place keeps."""
        self._pool_vecs_cache = None
        self._sd_cache = None

    def _patch_shadows(self, slots: torch.Tensor, rows: torch.Tensor) -> None:
        """Write the guidance shadows' rows of ``slots`` from their new f32
        ``rows``, as a whole conversion of the store would give them."""
        if self._v16 is not None:
            self._v16[slots] = rows.bfloat16()
        if self._v8 is not None:
            self._v8[0][slots], self._v8[1][slots] = quantize_rows_int8(rows)

    def _mark_dirty(self, rows: torch.Tensor) -> None:
        """Mark rows (device slots, or a ``[cap]`` mask) whose neighbours
        changed, for the next search to re-gather from a kept packed table;
        no host read."""
        if self._packed is None:
            return  # the next pack is whole
        if self._dirty is None:
            self._dirty = torch.zeros(self.neighbors0.shape[0], dtype=torch.bool,
                                      device=self.device)
        if rows.dtype == torch.bool:
            self._dirty |= rows
        else:
            self._dirty[rows] = True

    def _settle_dirty(self) -> None:
        """At the end of a write: the marked rows as slots, for the next
        search's re-gather."""
        if self._dirty is not None and self._packed is not None:
            self._dirty_rows = self._dirty.nonzero().squeeze(1)

    def pack_neighbors(self) -> None:
        """(Re)build the packed neighbour table whole for the current
        ``search_quant``, on any device."""
        self._packed = None
        self._packed_scales = None
        self._sd_cache = None
        self._maybe_packed(force=True)

    def _maybe_packed(self, force: bool = False) -> torch.Tensor | None:
        """The packed ``[cap, R0, d]`` table of the beam's guidance,
        ``v16[neighbors0]`` (bf16), or ``v8[neighbors0]`` (int8) with the
        neighbours' scales in ``_packed_scales [cap, R0]`` (``-1`` gathers
        slot 0, as the clamp does). Built whole on a CUDA device, on the CPU
        only when ``force``d, None over ``pack_budget_bytes``; rebuilt whole
        when ``search_quant`` changed (``hnsw.py:1007-1032``). A kept table
        first re-gathers the rows that writes marked (``hnsw.repack``)."""
        int8 = self._int8_guidance()
        if self._packed is not None and self._packed_quant == self.search_quant:
            if self._dirty_rows is not None:
                self._repack_rows(self._dirty_rows)
            return self._packed
        need = self.store.capacity * self.m0 * self.dim * (1 if int8 else 2)
        if need > self.pack_budget_bytes:
            return None
        if self.device.type == "cpu" and not force:
            return None  # CPU: keep the row path exercised
        with span("hnsw.repack", rows=self.neighbors0.shape[0], whole=1):
            # one gather of the whole table, not one per row
            nb = self.neighbors0.clamp(min=0).long()
            if int8:
                vi, sc = self._vecs8()
                self._packed, self._packed_scales = vi[nb], sc[nb]
            else:
                self._packed, self._packed_scales = self._vecs16()[nb], None
        self._packed_quant = self.search_quant
        self._dirty = self._dirty_rows = None
        return self._packed

    def _repack_rows(self, rows: torch.Tensor) -> None:
        """Re-gather the packed rows ``rows`` from the shadow the table was
        built from, and clear the marks."""
        with span("hnsw.repack", rows=rows.shape[0], whole=0):
            nb = self.neighbors0[rows].clamp(min=0).long()
            if self._packed_quant == "int8":
                vi, sc = self._vecs8()
                self._packed[rows], self._packed_scales[rows] = vi[nb], sc[nb]
            else:
                self._packed[rows] = self._vecs16()[nb]
            self._dirty.zero_()
        self._dirty_rows = None
        self._sd_cache = None

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
        """Batched insert (``hnsw.py:1070-1093``). Into an empty index, a
        batch of at least ``4 * wave_size`` rows is built in bulk: the
        level-0 graph is the exact kNN graph (one chunked ``flat_topk``
        sweep of the corpus against itself), symmetrised and pruned, and the
        upper levels are wired exactly. Any other insert runs in waves of
        ``wave_size`` rows (``_insert_wave``). An ``insert_mode`` outside
        ``INSERT_MODES`` raises ``ValueError`` before anything changes; an id
        already stored or repeated raises it as its bulk batch or wave is
        registered, the waves before it staying inserted, as in JAX. The
        ``index.insert`` span records the slots' state when it ends."""
        if self.insert_mode not in INSERT_MODES:
            raise ValueError(f"insert_mode must be one of {INSERT_MODES}, got"
                             f" {self.insert_mode!r}")
        ids = np.asarray(ids, np.int64).reshape(-1)
        with request("index.insert", rows=len(ids)) as sp:
            vecs = torch.as_tensor(vectors, dtype=torch.float32)
            vecs = vecs.reshape(len(ids), self.dim).to(self.device)
            try:
                if len(self) == 0 and len(ids) >= 4 * self.wave_size:
                    self._bulk_build(ids, vecs)
                else:
                    for s in range(0, len(ids), self.wave_size):
                        wave = ids[s : s + self.wave_size]
                        with span("hnsw.wave", rows=len(wave)):
                            self._insert_wave(wave, vecs[s : s + self.wave_size])
            finally:
                self._settle_dirty()
                sp.set(**self._slot_state())

    def _slot_state(self) -> dict:
        st = self.store
        return {"high_watermark": st.high_watermark, "live": len(st),
                "capacity": st.capacity}

    def _bulk_build(self, ids: np.ndarray, vectors) -> None:
        n = len(ids)
        self._drop_search_tables()  # a new graph: packed whole when searched
        slots = self.store.add(ids, vectors)
        self._sync_capacity()
        levels = self._sample_levels(n)
        self.levels[slots] = levels
        self.entry_point = int(slots[int(np.argmax(levels))])
        self.max_level = int(levels.max())

        promoted = np.nonzero(levels >= 1)[0]
        if len(promoted):
            hi_rows = self._alloc_hi(len(promoted))
            if self._hi_count > self.hi_neighbors.shape[0]:
                self._grow_hi(2 * self._hi_count)
            self.hi_index[torch.as_tensor(slots[promoted], dtype=torch.long,
                                          device=self.device)] = (
                torch.as_tensor(hi_rows, device=self.device))
            self._hi_index_np[slots[promoted]] = hi_rows
            self._pool_dirty = True

        # exact kNN rows: the corpus against itself, +1 for the self-match
        corpus = self.store.vectors[: self.store.high_watermark]
        # an index emptied by deletes keeps its dead rows below the batch
        # (without reuse_slots): masked, unlike JAX's sweep (hnsw.py:1170),
        # which wires them in
        valid = self.store.valid[: self.store.high_watermark]
        # bulk slots are contiguous: appended, or with reuse_slots every
        # slot of the empty index from 0 on
        base = int(slots[0])
        chunks_i, chunks_d = [], []
        for s in range(0, n, _SWEEP_ROWS):
            e = min(s + _SWEEP_ROWS, n)
            dd, ii = flat_topk(
                corpus[base + s : base + e], corpus, self.m0 + 1,
                metric=self.metric, corpus_valid=valid,
                precision=self.build_precision,
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

    def _insert_wave(self, ids: np.ndarray, vecs: torch.Tensor) -> None:
        """One insertion wave (``hnsw.py:1227-1301``): slots, levels and the
        promotion queue on the host, the level-0 wiring in
        ``_wire_wave``, then the entry point: the highest level wins
        (src/hnsw_algo.c:660-663). Promoted nodes join the routing pool at
        once and the upper levels at the next ``_flush_hi_wiring``. Room is
        reserved for the wave padded to a power of two of at least 64 rows,
        as the JAX package pads it, so both keep the same capacity; with
        ``reuse_slots`` the wave takes freed slots first and reserves room
        only for the rows it appends."""
        w = len(ids)
        first = self.entry_point < 0
        bucket = 1 << int(np.ceil(np.log2(max(w, 64))))
        pool = None  # the beam's pre-wave routing pool: the entry point while none
        if self.insert_mode == "beam":
            pool = None if first else self._routing_pool()
            if pool is None:
                p = np.full(64, -1, np.int32)
                if not first:
                    p[0] = self.entry_point
                pool = torch.as_tensor(p, device=self.device)

        slots = self.store.register(ids, reserve_extra=bucket - w)
        self._sync_capacity()
        levels = self._sample_levels(w)
        self.levels[slots] = levels
        promoted = np.nonzero(levels >= 1)[0]
        if len(promoted):
            hi_rows = self._alloc_hi(len(promoted))
            self._hi_index_np[slots[promoted]] = hi_rows
            self._hi_pending.append((slots[promoted].astype(np.int32),
                                     levels[promoted].astype(np.int32)))
            self._pool_dirty = True

        slots_t = torch.as_tensor(slots, device=self.device)
        self._wire_wave(vecs, slots_t, pool, min(self.m0, max(bucket - 1, 1)))
        if slots[0] == 0:
            # a -1 entry gathers slot 0's row into the packed table
            self._mark_dirty((self.neighbors0 < 0).any(dim=1))
        top = int(np.argmax(levels))
        if first or int(levels[top]) > self.max_level:
            self.max_level = int(levels[top])
            self.entry_point = int(slots[top])

    def _wire_wave(self, qv: torch.Tensor, slots: torch.Tensor,
                   pool: torch.Tensor | None, kk: int) -> None:
        """The level-0 work of a wave, in place (``_insert_wave_fused``,
        ``hnsw.py:1717-1836``), for rows ``qv`` at ``slots`` (int32, on the
        device): write the rows; candidates from the pre-wave graph (live
        rows only, so never a wave row or a deleted one), merged with each
        row's ``kk`` closest wave rows; the closest ``2M`` wired forward;
        the reverse edges appended to their targets, up to ``2M`` each;
        those targets pruned back to ``2M`` (MN-RU with ``mn_ru``). The
        shadows' rows are patched, and the rows whose neighbours changed
        marked for the packed table."""
        w, m0 = qv.shape[0], self.m0
        st = self.store
        hw = st.high_watermark
        at = slots.long()
        st.vectors[at] = qv
        self._patch_shadows(at, qv)
        if self.insert_mode == "exact":
            # the live rows up to the new high watermark: never an empty
            # corpus, and the wave's own rows are still invalid
            cand_d, cand_i = flat_topk(
                qv, st.vectors[:hw], m0, metric=self.metric,
                corpus_valid=st.valid[:hw], precision=self.build_precision,
            )
        else:  # "beam"
            ef = max(self.ef_construction, m0 + 1)
            entries = _route_entries(qv, st.vectors, pool, self.metric,
                                     min(self.route_entries, ef))
            cand_d, cand_i = _beam_search_level0(
                qv, entries, st.vectors, self.neighbors0, self.metric, ef,
                self.expand)
            # routed through, never selected: deleted rows
            ok = (cand_i >= 0) & st.valid[cand_i.clamp(min=0).long()]
            cand_d = torch.where(ok, cand_d, _INF)
            cand_i = torch.where(ok, cand_i, -1)
        st.valid[at] = True

        # the wave's rows among themselves (the sequential reference links
        # them by inserting one at a time)
        intra = pairwise_distances(qv, qv, self.metric)
        not_self = ~torch.eye(w, dtype=torch.bool, device=self.device)
        id_, ii = masked_topk(intra, kk, mask=not_self, ids=slots[None, :])
        cand_d, cand_i = merge_topk(cand_d, cand_i, id_, ii)
        sel_d, sel_i = sorted_topk_unique(cand_d, cand_i, m0)
        sel_d = torch.where(sel_i >= 0, sel_d, _INF)
        self.neighbors0[at] = sel_i
        self.dists0[at] = sel_d

        tgt = sel_i.reshape(-1)
        append_i, append_d = _grouped_bounded_append(
            tgt, slots.repeat_interleave(m0), sel_d.reshape(-1),
            self.neighbors0.shape[0], m0)
        # each target once: JAX prunes duplicates to the same row
        aff = torch.unique(tgt[tgt >= 0]).long()
        with span("hnsw.prune", rows=aff.shape[0]):
            _prune_rows(self.neighbors0, self.dists0, append_i, append_d, aff,
                        m0, mn_tiebreak=self.mn_ru)
        self._mark_dirty(at)
        self._mark_dirty(aff)
        self._after_write()

    def _flush_hi_wiring(self) -> None:
        """Wire every queued promotion into the upper levels in one exact
        pass (``hnsw.py:1303-1328``); nodes deleted since they were queued
        are dropped. Deferral changes nothing: upper levels are wired
        exactly over each level's whole population. Called before an
        export (``index.convert.hnsw_index_to_numpy``)."""
        if not self._hi_pending:
            return
        slots = np.concatenate([sl for sl, _ in self._hi_pending])
        levels = np.concatenate([lv for _, lv in self._hi_pending])
        self._hi_pending = []
        alive = self.levels[slots] >= 1
        slots, levels = slots[alive], levels[alive]
        if len(slots) == 0:
            return
        if self._hi_count > self.hi_neighbors.shape[0]:
            self._grow_hi(2 * self._hi_count)
        self.hi_index[torch.as_tensor(slots, dtype=torch.long, device=self.device)] = (
            torch.as_tensor(self._hi_index_np[slots], device=self.device))
        self._wire_upper_levels(slots, levels, np.arange(len(slots)))

    # ── delete ──

    def delete(self, ids) -> None:
        """Soft delete with repair (``hnsw.py:1403-1481``; the reference's
        ``hnsw_delete``, src/hnsw_algo.c:706-802), in waves of at most
        ``wave_size`` ids. Every live row that points at a deleted slot
        drops those edges and refills, closest first, from the union of the
        deleted nodes' former neighbourhoods (``flat_topk`` at "highest"),
        so no live edge points at a tombstone; the deleted rows are cleared,
        upper-level edges to them scrubbed, their queued promotions dropped,
        and the entry point rescanned if it died. An unknown id raises
        ``KeyError`` before its wave changes anything (earlier waves stay
        deleted, as in JAX). With ``reuse_slots`` the freed slots and
        upper-level rows go to the free lists."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with request("index.delete", rows=len(ids)) as sp:
            try:
                for s in range(0, len(ids), self.wave_size):
                    self._delete_wave(ids[s : s + self.wave_size])
            finally:
                self._settle_dirty()
                sp.set(**self._slot_state())

    def _delete_wave(self, ids: np.ndarray) -> None:
        slots = self.store.unregister(ids)
        # the device's part first, with no host read: mark, list the rows
        # pointing at a deleted slot and the former neighbourhoods, repair,
        # clear the deleted rows and scrub the upper levels; the host's
        # bookkeeping below runs while the card works (``index_fill_``: a
        # CUDA ``t[idx] = scalar`` copies the scalar from the host and waits
        # for the card)
        dev = self.device
        slots_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
        self.store.valid.index_fill_(0, slots_t, False)
        dmask = torch.zeros(self.neighbors0.shape[0], dtype=torch.bool, device=dev)
        dmask.index_fill_(0, slots_t, True)
        refs, aff, pool, counts = _delete_lists(self.neighbors0, slots_t, dmask,
                                                self.m0)
        self._repair(aff, pool, counts, dmask)
        self.neighbors0.index_fill_(0, slots_t, -1)
        self.dists0.index_fill_(0, slots_t, _INF)
        hn = self.hi_neighbors
        self.hi_neighbors = torch.where(
            (hn >= 0) & dmask[hn.clamp(min=0).long()], -1, hn)
        self.hi_index.index_fill_(0, slots_t, -1)
        self._mark_dirty(refs)
        self._mark_dirty(dmask)
        self._after_write()

        self.levels[slots] = -1
        hi_rows = self._hi_index_np[slots]
        hi_rows = hi_rows[hi_rows >= 0]
        self._hi_index_np[slots] = -1
        if self._hi_pending:
            self._hi_pending = [(sl[~np.isin(sl, slots)], lv[~np.isin(sl, slots)])
                                for sl, lv in self._hi_pending]
        self._pool_dirty = True
        if self.store.reuse_slots and len(hi_rows):
            # rows queued but never wired may lie past the table
            held = hi_rows[hi_rows < self.hi_neighbors.shape[0]]
            self.hi_neighbors.index_fill_(
                0, torch.as_tensor(held, dtype=torch.long, device=dev), -1)
            self._hi_free = np.union1d(self._hi_free, hi_rows).astype(np.int32)
        if self.entry_point in set(slots.tolist()):
            self._rescan_entry_point()

    def _repair(self, aff: torch.Tensor, pool: torch.Tensor,
                counts: torch.Tensor, dmask: torch.Tensor) -> None:
        """A delete wave's repair over ``_delete_lists``' affected rows and
        pool: every affected row drops its edges to deleted slots and
        refills from its ``m0 + 1`` closest pool rows (``_repair_rows``);
        with an empty pool it only drops them where slots are taken again.
        Where ``repair_engine`` admits the store, one ``delete_repair``
        launch over the lists as they lie on the device, with no host read;
        else the eager chunks, after one counted read of the two counts.
        The ``hnsw.repair`` span names the engine."""
        st = self.store
        engine = repair_engine(st.vectors, self.m0 + 1)
        with span("hnsw.repair", engine=engine) as sp:
            if engine == "kernel":
                # k is m0 + 1 at any pool size: JAX pads the pool to at
                # least 64 rows, and the gate admits m0 + 1 <= 64
                delete_repair_cuda(st.vectors[: st.high_watermark], aff, pool,
                                   counts, dmask, self.neighbors0, self.dists0,
                                   self.m0 + 1, self.metric,
                                   keep_if_empty=not st.reuse_slots)
                return
            n_aff, n_pool = (int(n) for n in host_read("hnsw_delete_counts", counts))
            sp.set(rows=n_aff)
            aff, pool = aff[:n_aff], pool[:n_pool]
            if n_aff and n_pool:
                # JAX pads the pool to a power of two of at least 64, which
                # sets k
                kk = min(self.m0 + 1, 1 << max(n_pool - 1, 63).bit_length())
                pv = st.vectors[pool]
                for s in range(0, n_aff, _REPAIR_ROWS):
                    self._repair_rows(aff[s : s + _REPAIR_ROWS], pool, pv,
                                      dmask, kk)
            elif n_aff and st.reuse_slots:
                # nothing to refill from; a slot that is taken again must
                # not keep edges from before
                self._drop_dead_edges(aff, dmask)

    def _drop_dead_edges(self, aff: torch.Tensor, dmask: torch.Tensor) -> None:
        """Rows ``aff`` drop their edges to deleted slots, the rest kept in
        order, in place."""
        rows_i = self.neighbors0[aff]
        dead = (rows_i >= 0) & dmask[rows_i.clamp(min=0).long()]
        d, i = sorted_topk_unique(torch.where(dead, _INF, self.dists0[aff]),
                                  torch.where(dead, -1, rows_i), self.m0)
        self.neighbors0[aff] = i
        self.dists0[aff] = torch.where(i >= 0, d, _INF)

    def _repair_rows(self, aff: torch.Tensor, pool: torch.Tensor,
                     pv: torch.Tensor, dmask: torch.Tensor, kk: int) -> None:
        """Rows ``aff`` drop their edges to deleted slots and merge in their
        ``kk`` closest rows of the repair pool (``_delete_repair_rows``,
        ``hnsw.py:1860-1896``), in place."""
        rows_i = self.neighbors0[aff]
        rows_d = self.dists0[aff]
        dead = (rows_i >= 0) & dmask[rows_i.clamp(min=0).long()]
        rows_i = torch.where(dead, -1, rows_i)
        rows_d = torch.where(dead, _INF, rows_d)
        cd, ci = flat_topk(self.store.vectors[aff], pv, kk, metric=self.metric,
                           precision="highest")
        cand = torch.where(ci >= 0, pool[ci.clamp(min=0).long()], -1)
        self_m = cand == aff[:, None]
        cd = torch.where(self_m, _INF, cd)
        cand = torch.where(self_m, -1, cand).to(torch.int32)
        rd, ri = merge_topk(rows_d, rows_i, cd, cand)
        self.neighbors0[aff] = ri
        self.dists0[aff] = rd

    def _rescan_entry_point(self) -> None:
        """The live node of the highest level, first by slot
        (src/hnsw_algo.c:790-802); none when the index is empty."""
        live = np.nonzero(host_read("hnsw_entry_rescan", self.store.valid))[0]
        if len(live) == 0:
            self.entry_point = -1
            self.max_level = -1
            return
        best = int(np.argmax(self.levels[live]))
        self.entry_point = int(live[best])
        self.max_level = int(self.levels[live[best]])
