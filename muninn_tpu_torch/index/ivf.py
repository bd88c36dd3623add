"""Balanced IVF-flat index, the PyTorch port of ``muninn_tpu/index/ivf.py``.

Rows live in a ``VectorStore``; the index packs them into ``nlist``
clusters of exactly ``cluster_size`` (S) slots, stored contiguously as
``[nlist_pad, S, d]`` blocks (bf16, or int8 with one f32 scale per row), so
that a probe reads whole clusters. A query picks its ``nprobe`` nearest
centroids, scores every member of those clusters, keeps the best
``rescore_r`` and ranks them again by exact f32 distance to the stored rows.

- Build (``rebuild``, or the first ``insert`` that brings the index to 16
  clusters of rows): Lloyd's k-means on a uniform sample of
  ``train_sample`` live rows from ``ncl`` distinct seed rows, drawn with a
  ``torch.Generator`` seeded from ``seed``; then ``assign_rounds`` rounds of
  a capacity-constrained greedy assignment over each row's 16 nearest
  centroids (host numpy, ``_balanced_assign``), block packing, and a refit
  of the centroids to the blocks' means.
- Churn: ``insert`` after the build places rows in their nearest cluster
  with a free slot, writing the blocks in place; rows that fit nowhere wait
  in a pending region that every search scans exactly, and a rebuild runs
  when it exceeds a tenth of the rows. ``delete`` flips the validity mask;
  dead cluster slots are skipped at search and reclaimed by ``rebuild``.
- Search, ``_ivf_search``. On a CUDA index (``use_kernels``) the probe
  selection is ``ops.flat_topk.flat_topk(precision="default")`` over the
  centroids (the tensor-core kernel) and the block scoring
  ``ops.beam.gather_block_dots`` over the blocks (the ``beam_dots``
  kernel), the JAX package's fused route. A CPU index takes the JAX
  package's other route: exact f32 probe distances and a gather of the
  probed blocks. Setting ``use_kernels`` on a CPU index runs the fused
  route through the kernels' plain versions.

The JAX package pads query batches and pending slots to power-of-two or
1,024 buckets to bound its compiles; PyTorch runs eagerly, so the port
leaves the padding out (the results are the same) and keeps only the
chunking that bounds transients. Two faults of the reference are not
copied: the non-fused route's query chunk is sized at 4 bytes an element,
since that route computes in f32 (the JAX package sizes it at the blocks'
itemsize, ``ivf.py:796-800``), and the block packing chunks by ``pc``, the
multiple ``rebuild`` pads the slots to, where the JAX package assumes that
``cluster_size`` divides 131,072 (``ivf.py:201``, ``:223``).
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.index.flat import _query_tensor, _search_ids
from muninn_tpu_torch.index.store import VectorStore
from muninn_tpu_torch.ops.beam import gather_block_dots, packed_distances
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
    smallest_k,
    smallest_k_select,
    sorted_topk_unique,
)
from muninn_tpu_torch.tracing import span

_INF = float("inf")
QUANTS = ("bf16", "int8")
_PACK_ROWS = 131_072      # block rows per packing chunk: ~400 MB of f32 at d=768
_CLUSTER_CHUNK = 1024     # clusters per chunk of the block means
_DIST_ELEMS = 1 << 26     # distance entries per chunk of the k-means steps
_QUERY_CHUNK = 8192       # queries per fused search call
_GATHER_BYTES = int(1.5e9)  # the non-fused route's [B, p*S, d] f32 gather
_EXACT_ELEMS = 1 << 28    # distance entries per chunk of an exact region scan


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ───────────────────────── k-means ─────────────────────────


def _row_chunk(ncl: int) -> int:
    """Rows per chunk of a ``[rows, ncl]`` distance step."""
    return max(1, _DIST_ELEMS // max(ncl, 1))


def _sample_rows(live: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` distinct entries of ``live``, uniformly without replacement
    (the JAX package draws them by Gumbel top-k, ``ivf.py:96-98``,
    ``:591-594``)."""
    perm = torch.randperm(live.shape[0], generator=gen, device=gen.device)
    return live[perm[:n].to(live.device)]


def _lloyd(v: torch.Tensor, cent: torch.Tensor, iters: int,
           metric: Metric) -> torch.Tensor:
    """``iters`` Lloyd steps over the rows ``v [n, d]`` from ``cent [ncl,
    d]`` (``ivf.py:104-127``): each row joins its nearest centroid (lowest
    index on a tie), each centroid moves to the f32 sum of its rows rounded
    to bf16, over their count; an empty cluster keeps its centroid. The JAX
    package sums by a one-hot bf16 matmul; ``index_add_`` adds the same
    terms in another order."""
    ncl, d = cent.shape
    chunk = _row_chunk(ncl)
    for _ in range(iters):
        sums = torch.zeros((ncl, d), dtype=torch.float32, device=v.device)
        counts = torch.zeros((ncl,), dtype=torch.float32, device=v.device)
        for lo in range(0, v.shape[0], chunk):
            vc = v[lo:lo + chunk]
            am = torch.argmin(pairwise_distances(vc, cent, metric), dim=1)
            sums.index_add_(0, am, vc.bfloat16().float())
            counts += torch.bincount(am, minlength=ncl).float()
        newc = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, newc, cent)
    return cent


def _kmeans(v: torch.Tensor, ncl: int, iters: int, metric: Metric,
            gen: torch.Generator) -> torch.Tensor:
    """Centroids ``[ncl, d]`` f32 of the rows ``v``: ``ncl`` distinct rows
    drawn by ``gen``, then ``_lloyd``."""
    if ncl > v.shape[0]:
        raise ValueError(f"nlist={ncl} exceeds the {v.shape[0]} training rows")
    seeds = _sample_rows(torch.arange(v.shape[0], device=v.device), ncl, gen)
    return _lloyd(v, v[seeds].float(), iters, metric)


def _topc_centroids(vectors: torch.Tensor, rows: torch.Tensor,
                    cent: torch.Tensor, c: int,
                    metric: Metric) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``c`` nearest centroids of each stored row ``vectors[rows]``,
    nearest first, equal distances in centroid order (``ivf.py:132-149``):
    ``(dists [n, c] f32, ids [n, c] int64)``."""
    n = rows.shape[0]
    dists = torch.empty((n, c), dtype=torch.float32, device=cent.device)
    ids = torch.empty((n, c), dtype=torch.int64, device=cent.device)
    chunk = _row_chunk(cent.shape[0])
    for lo in range(0, n, chunk):
        dd = pairwise_distances(vectors[rows[lo:lo + chunk]], cent, metric)
        dists[lo:lo + chunk], ids[lo:lo + chunk] = smallest_k_select(dd, c)
    return dists, ids


# ───────────────────────── host assignment ─────────────────────────


def _balanced_assign(top_cl: np.ndarray, top_d: np.ndarray, fill: np.ndarray,
                     s: int) -> np.ndarray:
    """Capacity-constrained greedy assignment (``ivf.py:152-192``): round c
    tries each row's c-th nearest cluster, and within a cluster the closest
    rows take the free slots. Rows still unplaced after the C rounds go to
    any cluster with space; -1 marks a row that fits nowhere. ``fill``
    (the clusters' occupancy) is updated in place."""
    n, c_max = top_cl.shape
    ncl = fill.shape[0]
    assigned = np.full(n, -1, np.int64)
    for c in range(c_max):
        todo = np.flatnonzero(assigned < 0)
        if todo.size == 0:
            break
        cl = top_cl[todo, c].astype(np.int64)
        d = top_d[todo, c]
        order = np.lexsort((d, cl))                    # by cluster, then d
        cl_s = cl[order]
        boundaries = np.flatnonzero(np.r_[True, cl_s[1:] != cl_s[:-1]])
        run_start = np.repeat(boundaries, np.diff(np.r_[boundaries, cl_s.size]))
        rank = np.arange(cl_s.size) - run_start
        ok = rank < (s - fill[cl_s])
        take = order[ok]
        assigned[todo[take]] = cl[take]
        fill += np.bincount(cl[take], minlength=ncl).astype(fill.dtype)
    todo = np.flatnonzero(assigned < 0)
    if todo.size:
        space = (s - fill).clip(min=0)
        free_slots = np.repeat(np.arange(ncl), space)
        m = min(todo.size, free_slots.size)
        assigned[todo[:m]] = free_slots[:m]
        fill += np.bincount(assigned[todo[:m]], minlength=ncl).astype(fill.dtype)
    return assigned


def _ranks_within(assigned: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Position of each row within its assigned cluster, after the
    cluster's ``base`` occupied slots, in input order (``ivf.py:324-336``)."""
    n = assigned.shape[0]
    order = np.lexsort((np.arange(n), assigned))
    cl_s = assigned[order]
    boundaries = np.flatnonzero(np.r_[True, cl_s[1:] != cl_s[:-1]])
    run_start = np.repeat(boundaries, np.diff(np.r_[boundaries, n]))
    rank = np.arange(n) - run_start
    out = np.empty(n, np.int64)
    out[order] = rank + base[cl_s]
    return out


# ───────────────────────── block packing ─────────────────────────


def _pack_blocks(vectors: torch.Tensor, flat_slots: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Block rows ``[m, d]`` bf16: ``vectors[flat_slots]`` rounded to bf16,
    zero where the slot is -1, gathered ``chunk`` rows at a time so the f32
    transient stays bounded (``ivf.py:195-210``)."""
    m = flat_slots.shape[0]
    out = torch.zeros((m, vectors.shape[1]), dtype=torch.bfloat16,
                      device=vectors.device)
    for lo in range(0, m, chunk):
        sl = flat_slots[lo:lo + chunk].long()
        rows = vectors[sl.clamp(min=0)].float().bfloat16()
        out[lo:lo + chunk] = torch.where((sl >= 0)[:, None], rows, 0)
    return out


def _pack_blocks_int8(vectors: torch.Tensor, flat_slots: torch.Tensor,
                      chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_pack_blocks`` for int8 blocks (``ivf.py:213-237``): each gathered
    chunk is quantized per row at once, so no bf16 copy of the blocks
    exists. Returns ``(int8 rows [m, d], f32 scales [m])``, 0 on -1 slots."""
    m = flat_slots.shape[0]
    q = torch.zeros((m, vectors.shape[1]), dtype=torch.int8,
                    device=vectors.device)
    sc = torch.zeros((m,), dtype=torch.float32, device=vectors.device)
    for lo in range(0, m, chunk):
        sl = flat_slots[lo:lo + chunk].long()
        qv, s = quantize_rows_int8(vectors[sl.clamp(min=0)])
        ok = sl >= 0
        q[lo:lo + chunk] = torch.where(ok[:, None], qv, 0)
        sc[lo:lo + chunk] = torch.where(ok, s, 0.0)
    return q, sc


def _quantize_blocks(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of packed ``[ncl, S, d]`` blocks, a chunk
    of clusters at a time (``ivf.py:283-307``): ``(int8 blocks, f32 scales
    [ncl, S])``."""
    ncl, s, _ = blocks.shape
    q = torch.empty(blocks.shape, dtype=torch.int8, device=blocks.device)
    sc = torch.empty((ncl, s), dtype=torch.float32, device=blocks.device)
    for lo in range(0, ncl, _CLUSTER_CHUNK):
        q[lo:lo + _CLUSTER_CHUNK], sc[lo:lo + _CLUSTER_CHUNK] = (
            quantize_rows_int8(blocks[lo:lo + _CLUSTER_CHUNK]))
    return q, sc


def _block_means(blocks: torch.Tensor, member_slots: torch.Tensor,
                 fallback: torch.Tensor,
                 scales: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of each block's live members in f32, ``fallback [ncl, d]`` for
    an empty block (``ivf.py:310-321``), a chunk of clusters at a time. With
    int8 ``blocks``, each row is weighted by its ``scales`` entry rounded to
    bf16, as the JAX package's bf16 contraction does (``ivf.py:240-280``)."""
    ncl, _, d = blocks.shape
    out = torch.empty((ncl, d), dtype=torch.float32, device=blocks.device)
    for lo in range(0, ncl, _CLUSTER_CHUNK):
        hi = min(lo + _CLUSTER_CHUNK, ncl)
        mask = member_slots[lo:hi] >= 0
        w = mask.float()
        if scales is not None:
            w = torch.where(mask, scales[lo:hi], 0.0).bfloat16().float()
        sums = (blocks[lo:hi].float() * w[:, :, None]).sum(dim=1)
        cnt = mask.sum(dim=1, dtype=torch.float32)[:, None]
        out[lo:hi] = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0),
                                 fallback[lo:hi])
    return out


# ───────────────────────── query path ─────────────────────────


def _ivf_search(
    q: torch.Tensor,             # [B, d] f32
    centroids: torch.Tensor,     # [ncl, d] f32
    blocks: torch.Tensor,        # [ncl_pad, S, d] bf16 / int8
    member_slots: torch.Tensor,  # [ncl_pad, S] int32 store slots, -1 pad
    vectors: torch.Tensor,       # [cap, d] store rows (exact rescore)
    valid: torch.Tensor,         # [cap] bool
    metric: Metric,
    k: int,
    p: int,
    r: int,
    fused: bool,
    scales: torch.Tensor | None = None,  # [ncl_pad, S] f32 (int8 blocks)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe selection, block scoring, top-r, exact f32 rescore, top-k
    (``ivf.py:345-421``): ``(dists [B, k] f32, slots [B, k] int32)``
    ascending, ``(inf, -1)`` padded. int8 blocks are scaled after the
    products (dots by the row's scale, squared norms by its square)."""
    b, d = q.shape
    s = blocks.shape[1]
    qf = q.float()

    # 1) the p nearest centroids (phantom pad clusters are never probed)
    if fused:
        _, probe = flat_topk(qf, centroids, p, metric=metric,
                             precision="default")
    else:
        _, probe = smallest_k(pairwise_distances(qf, centroids, metric), p)
    probe = probe.clamp(min=0).to(torch.int32)
    pl = probe.long()

    # 2) every member of the probed clusters
    mslots = member_slots[pl].reshape(b, p * s).long()
    if fused:
        dots, cn2 = gather_block_dots(qf, probe, blocks)
        if scales is not None:
            ps = scales[pl].reshape(b, p * s)
            dots = dots * ps
            cn2 = cn2 * ps * ps
        dist = packed_distances(dots, cn2, squared_norms(qf)[:, None], metric)
    else:
        mv = blocks[pl].reshape(b, p * s, d)
        if scales is not None:
            mv = mv.float() * scales[pl].reshape(b, p * s)[:, :, None]
        dist = gathered_distances(qf, mv, metric)
    ok = (mslots >= 0) & valid[mslots.clamp(min=0)]
    dist = torch.where(ok, dist, _INF)

    # 3) top-r candidates (clusters are disjoint: no slot twice)
    top, pos = smallest_k(dist, r)
    cand = torch.gather(mslots, 1, pos)
    cand = torch.where(torch.isinf(top), -1, cand)

    # 4) the exact f32 rescore decides the ranking
    dr = gathered_distances(qf, vectors[cand.clamp(min=0)], metric)
    dr = torch.where(cand >= 0, dr, _INF)
    return sorted_topk_unique(dr, cand.to(torch.int32), k)


def _exact_slots_topk(q: torch.Tensor, sl: torch.Tensor, vectors: torch.Tensor,
                      valid: torch.Tensor, metric: Metric,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``q`` over the stored rows ``sl`` (``ivf.py:867-881``),
    dead rows skipped: ``(dists [B, k], slots [B, k] int32)``."""
    dd = pairwise_distances(q, vectors[sl], metric)
    dd = torch.where(valid[sl][None, :], dd, _INF)
    top, pos = smallest_k_select(dd, min(k, sl.shape[0]))
    cand = torch.where(torch.isinf(top), -1, sl[pos]).to(torch.int32)
    short = k - cand.shape[1]
    if short > 0:
        top = torch.nn.functional.pad(top, (0, short), value=_INF)
        cand = torch.nn.functional.pad(cand, (0, short), value=-1)
    return top, cand


def _merge_two(d1, i1, d2, i2, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The best ``k`` of two result sets (``ivf.py:885-888``)."""
    return sorted_topk_unique(torch.cat([d1, d2], dim=1),
                              torch.cat([i1, i2], dim=1), k)


# ───────────────────────── index ─────────────────────────


class IvfIndex:
    """Balanced IVF-flat ANN index on ``device`` (the card unless
    ``device="cpu"``): insert, delete and search by external int64 id.

    Parameters, as in the JAX package: ``cluster_size`` (S, rows per
    block), ``nprobe`` (clusters scored per query; also a search argument),
    ``rescore_r`` (candidates rescored in f32), ``slack`` (spare cluster
    capacity at a build), ``kmeans_iters``, ``assign_rounds`` (balanced
    assignment rounds; round 2 on assigns against the refit means),
    ``train_sample`` (rows k-means trains on), ``seed`` (the build's
    generator), ``quant`` ("bf16" or "int8" blocks) and ``store_dtype``
    (``torch.float32`` or ``torch.bfloat16``, the rescore's rows)."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.COSINE,
        *,
        cluster_size: int = 128,
        nprobe: int = 8,
        rescore_r: int = 32,
        slack: float = 1.2,
        kmeans_iters: int = 10,
        assign_rounds: int = 2,
        train_sample: int = 262_144,
        seed: int = 0,
        capacity: int = 1024,
        quant: str = "bf16",
        store_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        if quant not in QUANTS:
            raise ValueError(f"unknown quant {quant!r}")
        if store_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"store_dtype must be float32 or bfloat16, got {store_dtype}")
        self.metric = parse_metric(metric)
        self.store = VectorStore(dim, capacity, device=device, dtype=store_dtype)
        self.device = self.store.device
        self.cluster_size = int(cluster_size)
        self.nprobe = int(nprobe)
        self.rescore_r = int(rescore_r)
        self.slack = float(slack)
        self.kmeans_iters = int(kmeans_iters)
        self.assign_rounds = int(assign_rounds)
        self.train_sample = int(train_sample)
        self.seed = int(seed)
        self.quant = quant
        # the fused route (probe and block kernels), the JAX package's
        # use_pallas: on by default where the kernels run, the card
        self.use_kernels = self.device.type == "cuda"
        # built state, None until the first build
        self.centroids: torch.Tensor | None = None     # [ncl, d] f32
        self.blocks: torch.Tensor | None = None        # [ncl_pad, S, d]
        self.block_scales: torch.Tensor | None = None  # [ncl_pad, S] (int8)
        self.member_slots: torch.Tensor | None = None  # [ncl_pad, S] int32
        self._fill: np.ndarray | None = None           # [ncl] occupancy
        self._pending: list[np.ndarray] = []           # slots in no cluster
        self._pending_count = 0

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def nlist(self) -> int:
        return 0 if self.centroids is None else self.centroids.shape[0]

    def __len__(self) -> int:
        return len(self.store)

    def seed_rng(self, seed: int) -> None:
        """Reseed the build's randomness (the reference's
        ``hnsw_seed_rng``, ``src/hnsw_algo.c:222-224``)."""
        self.seed = int(seed)

    def _fused_ok(self) -> bool:
        """Whether search takes the fused route. The CUDA kernels take any
        d and S, so the JAX package's alignment gate (``ivf.py:518-525``)
        has no counterpart."""
        return self.use_kernels

    # ── build ──

    def load_rows(self, ids, vectors) -> np.ndarray:
        """Append rows without ``insert``'s build trigger, for a caller that
        trains centroids itself and then calls ``rebuild(centroids=...)``.
        The rows are searched exactly, in the pending region, until then."""
        slots = self.store.add(np.asarray(ids, np.int64), vectors)
        self._pending.append(slots.astype(np.int32))
        self._pending_count += slots.size
        return slots

    def rebuild(self, *, nlist: int | None = None, centroids=None) -> None:
        """Train centroids on the live rows and pack every live row (pending
        ones included; deleted slots dropped) into balanced cluster blocks.

        ``centroids``: trained ``[ncl, d]`` centroids, which skip k-means;
        the assignment, packing and refit run as usual, so the index ends
        with the blocks' means."""
        hw = self.store.high_watermark
        live = np.flatnonzero(self.store.valid[:hw].cpu().numpy())
        n = live.shape[0]
        if n == 0:
            self.centroids = self.blocks = self.block_scales = None
            self.member_slots = self._fill = None
            self._pending, self._pending_count = [], 0
            return
        s, dim, dev = self.cluster_size, self.dim, self.device
        if centroids is not None:
            ncl = int(centroids.shape[0])
            if nlist is not None and nlist != ncl:
                raise ValueError(
                    f"nlist={nlist} conflicts with centroids.shape[0]={ncl}")
            if ncl * s < n:
                raise ValueError(
                    f"{ncl} externally-trained clusters x {s} slots cannot"
                    f" hold {n} live rows")
            cent = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
        else:
            ncl = nlist or max(int(np.ceil(n * self.slack / s)), 1)
        v = self.store.vectors
        live_t = torch.as_tensor(live, device=dev)

        # 1) centroids: k-means on a uniform sample of the live rows
        if centroids is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            rows = (_sample_rows(live_t, self.train_sample, gen)
                    if n > self.train_sample else live_t)
            cent = _kmeans(v[rows], ncl, self.kmeans_iters, self.metric, gen)

        # 2) balanced assignment rounds (``ivf.py:608-619``): top-C clusters
        # a row, the host's capacity-constrained assignment, packing, and
        # the refit of the centroids to the blocks' means. The block rows
        # are padded to a multiple of pc: phantom clusters, never probed
        c = min(16, ncl)
        m = ncl * s
        pc = max(s, (_PACK_ROWS // s) * s)
        mpad = _round_up(m, pc) if m >= pc else m
        ncl_pad = mpad // s
        self.blocks = blocks = scales = None  # free the old build first
        for _ in range(max(self.assign_rounds, 1)):
            td, tc = _topc_centroids(v, live_t, cent, c, self.metric)
            fill = np.zeros(ncl, np.int64)
            assigned = _balanced_assign(tc.cpu().numpy(), td.cpu().numpy(),
                                        fill, s)
            placed = assigned >= 0
            pos = assigned[placed] * s + _ranks_within(
                assigned[placed], np.zeros(ncl, np.int64))
            flat_slots = np.full(mpad, -1, np.int32)
            flat_slots[pos] = live[placed]
            blocks = scales = None
            fs = torch.as_tensor(flat_slots, device=dev)
            member_slots = fs.reshape(ncl_pad, s)
            cent_pad = torch.cat([cent, torch.zeros(
                (ncl_pad - ncl, dim), dtype=torch.float32, device=dev)])
            if self.quant == "int8":
                blocks, scales = _pack_blocks_int8(v, fs, pc)
                blocks = blocks.reshape(ncl_pad, s, dim)
                scales = scales.reshape(ncl_pad, s)
            else:
                blocks = _pack_blocks(v, fs, pc).reshape(ncl_pad, s, dim)
            cent = _block_means(blocks, member_slots, cent_pad, scales)[:ncl]
        self.blocks = blocks
        self.block_scales = scales
        self.member_slots = member_slots
        self.centroids = cent.contiguous()
        self._fill = fill
        self._pending = [live[~placed].astype(np.int32)] if (~placed).any() else []
        self._pending_count = int((~placed).sum())

    # ── churn ──

    def insert(self, ids, vectors) -> None:
        """Append rows. Before the first build they wait in the pending
        region, and the insert that brings the index to 16 clusters of rows
        builds it. After, each row takes a free slot of its nearest cluster
        with room (greedy, written in place), else the pending region; a
        rebuild runs when pending passes a tenth of the rows."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        slots = self.store.add(ids, vectors)
        if self.centroids is None:
            if len(self.store) >= 16 * self.cluster_size:
                self.rebuild()
            else:
                self._pending.append(slots.astype(np.int32))
                self._pending_count += slots.size
            return
        s, ncl, dev = self.cluster_size, self.nlist, self.device
        slots_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
        td, tc = _topc_centroids(self.store.vectors, slots_t, self.centroids,
                                 min(16, ncl), self.metric)
        assigned = _balanced_assign(tc.cpu().numpy(), td.cpu().numpy(),
                                    self._fill, s)
        placed = assigned >= 0
        if placed.any():
            # ranks after the slots the clusters held before this batch
            base = self._fill - np.bincount(assigned[placed], minlength=ncl)
            pos = torch.as_tensor(
                assigned[placed] * s + _ranks_within(assigned[placed], base),
                device=dev)
            pslots = slots_t[torch.as_tensor(placed, device=dev)]
            frows = self.store.vectors[pslots].float()
            if self.quant == "int8":
                rows, sc = quantize_rows_int8(frows)
                self.block_scales.view(-1)[pos] = sc
            else:
                rows = frows.bfloat16()
            self.blocks.view(-1, self.dim)[pos] = rows
            self.member_slots.view(-1)[pos] = pslots.to(torch.int32)
        if (~placed).any():
            self._pending.append(slots[~placed].astype(np.int32))
            self._pending_count += int((~placed).sum())
        if self._pending_count > max(len(self.store) // 10, 4 * s):
            self.rebuild()

    def delete(self, ids) -> None:
        """Soft delete: flips the validity mask; the rows' cluster slots are
        skipped at search and reclaimed by ``rebuild``."""
        self.store.remove(np.asarray(ids, np.int64))

    # ── search ──

    def _pending_slots(self) -> np.ndarray:
        if not self._pending:
            return np.zeros((0,), np.int32)
        if len(self._pending) > 1:
            self._pending = [np.concatenate(self._pending)]
        return self._pending[0]

    def _query_chunk(self, p: int) -> int:
        """Queries per ``_ivf_search`` call. The fused route streams blocks;
        the other gathers a ``[B, p*S, d]`` f32 view of them, so its chunk
        keeps that view near ``_GATHER_BYTES``, at 4 bytes an element
        whatever the blocks' type."""
        if self._fused_ok():
            return _QUERY_CHUNK
        per_q = p * self.cluster_size * self.dim * 4
        return max(256, min(_QUERY_CHUNK, _GATHER_BYTES // max(per_q, 1)))

    def search_device(self, queries, k: int = 10, nprobe: int | None = None):
        """Top-k with the results left on the index's device, in slot space:
        ``(dists f32 [B, k], slots int32 [B, k])``, ascending, ``(inf, -1)``
        padded."""
        with span("index.search_device"):
            q = _query_tensor(queries, self.dim, self.device)
            if self.centroids is None:  # unbuilt: exact scan of every row
                hw = max(self.store.high_watermark, 1)
                return self._exact_region(
                    q, torch.arange(hw, device=self.device), k)
            p = min(nprobe or self.nprobe, self.nlist)
            r = min(max(self.rescore_r, k), p * self.cluster_size)
            qb = self._query_chunk(p)
            parts = [
                _ivf_search(q[lo:lo + qb], self.centroids, self.blocks,
                            self.member_slots, self.store.vectors,
                            self.store.valid, self.metric, k, p, r,
                            self._fused_ok(), scales=self.block_scales)
                for lo in range(0, q.shape[0], qb)
            ]
            d = torch.cat([x[0] for x in parts])
            slots = torch.cat([x[1] for x in parts])
            pend = self._pending_slots()
            if pend.size:
                pend = torch.as_tensor(pend, dtype=torch.long,
                                       device=self.device)
                pd, ps = self._exact_region(q, pend, k)
                d, slots = _merge_two(d, slots, pd, ps, k)
            return d, slots

    def search(self, queries, k: int = 10, nprobe: int | None = None):
        """Batched ANN: ``(ids int64 [B, k], dists f32 [B, k])`` ascending,
        ``(-1, inf)`` padded, exact f32 distances; a single query gives 1-D
        arrays. ``nprobe`` overrides the constructor's."""
        return _search_ids(self, queries, k, nprobe)

    def _exact_region(self, q: torch.Tensor, slots: torch.Tensor, k: int):
        """Exact top-k over the stored rows ``slots`` (the pending region,
        or every row of an unbuilt index), in query chunks that keep the
        ``[chunk, len(slots)]`` distances near ``_EXACT_ELEMS`` entries."""
        b = q.shape[0]
        chunk = int(max(256, min(b, _EXACT_ELEMS // max(slots.shape[0], 1))))
        parts = [
            _exact_slots_topk(q[lo:lo + chunk], slots, self.store.vectors,
                              self.store.valid, self.metric, k)
            for lo in range(0, b, chunk)
        ]
        return torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])
