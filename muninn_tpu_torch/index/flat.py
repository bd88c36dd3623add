"""Brute-force KNN indexes, the PyTorch port of ``muninn_tpu/index/flat.py``.

- ``FlatIndex`` at ``precision="highest"`` (exact), ``"default"`` /
  ``"bfloat16"`` (bf16-rounded operands, f32 sums), and the two-tier modes
  ``"int8_rescored"`` (an int8 shadow of the store retrieves
  ``rescore_r`` candidates, an exact f32 rescore picks k) and
  ``"proj_rescored"`` (the same over int8 rows projected onto a
  ``proj_dim``-d uncentred PCA basis);
- ``QuantizedFlatIndex``: int8 storage with one scale per row, a quarter
  of the f32 store's bytes; its distances are quantized-dot
  approximations.

Search runs ``ops.flat_topk`` over the store's live prefix: on a CUDA
device the hand-written kernel, on the CPU its plain version, which is also
the counterpart of ``_xla_chunked_topk`` (a chunked exact top-k merged with
``masked_topk`` and ``merge_topk``).
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.index.store import VectorStore
from muninn_tpu_torch.ops.distance import (
    Metric,
    exact_f32_dots,
    parse_metric,
    quantize_rows_int8,
    unit_rows,
)
from muninn_tpu_torch.ops.flat_topk import (
    flat_topk,
    flat_topk_int8,
    int8_candidates,
    proj_basis,
    proj_candidates,
    rescore,
)
from muninn_tpu_torch.tracing import host_read, request, span

PRECISIONS = ("highest", "default", "bfloat16", "int8_rescored",
              "proj_rescored")
_RESCORED = ("int8_rescored", "proj_rescored")


def pick_rescore_r(
    true_ids: np.ndarray,
    cand_sorted: np.ndarray,
    ladder: tuple[int, ...],
    target_recall: float,
) -> tuple[int, dict[int, float]]:
    """The smallest retrieve-``r`` of ``ladder`` whose candidate prefix
    holds the exact top-k (``true_ids [B, k]``, -1 pad) at
    ``target_recall`` (``muninn_tpu/index/flat.py:39-72``). The int8
    candidates come back sorted, so the top-r for every smaller r is a
    prefix of one ``cand_sorted [B, r_max]`` retrieval, and containment is
    the rescored recall. Returns ``(r, {r: recall})``; the ladder's largest
    r when none reaches the target."""
    true_ids = np.asarray(true_ids)
    cand_sorted = np.asarray(cand_sorted)
    r_max = cand_sorted.shape[1]
    n_true = np.maximum((true_ids >= 0).sum(axis=1), 1)
    # hit_rank[b, j]: position of true id j among the candidates, r_max if
    # absent; contained at r iff hit_rank < r
    eq = true_ids[:, :, None] == cand_sorted[:, None, :]
    hit_rank = np.where(eq.any(axis=2), eq.argmax(axis=2), r_max)
    hit_rank = np.where(true_ids >= 0, hit_rank, r_max)
    curve = {}
    for r in sorted(set(int(r) for r in ladder if r <= r_max)):
        curve[r] = float(np.mean((hit_rank < r).sum(axis=1) / n_true))
    for r, rec in curve.items():
        if rec >= target_recall:
            return r, curve
    return max(curve), curve


def _query_tensor(queries, dim: int, device: torch.device) -> torch.Tensor:
    """The queries as an f32 ``[B, d]`` tensor on ``device`` (a copy to the
    card from host memory)."""
    with span("index.upload") as sp:
        q = torch.as_tensor(queries, dtype=torch.float32, device=device)
        sp.set(bytes=q.numel() * 4)
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[1] != dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {dim}")
    return q


def _search_ids(index, queries, k: int, *args):
    """``search`` of every index (``args`` go to its ``search_device``):
    external ids and distances as numpy, a single query as 1-D arrays; one
    request of the span tree."""
    single = np.ndim(queries) == 1
    with request("index.search", queries=1 if single else len(queries)):
        d, slots = index.search_device(queries, k, *args)
        with span("index.download") as sp:
            slots = host_read("download", slots)
            d = host_read("download", d)
            sp.set(bytes=slots.nbytes + d.nbytes)
        ids = index.store.ids_of(slots)
    if single:
        return ids[0], d[0]
    return ids, d


class FlatIndex:
    """Exact KNN over a vector store on ``device`` (the card unless
    ``device="cpu"``): insert and delete by external int64 id, batched
    search."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        capacity: int = 1024,
        device: str | torch.device = "cuda",
        precision: str = "highest",
        proj_dim: int = 128,
    ):
        self.metric = parse_metric(metric)
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}"
            )
        self.precision = precision
        self.rescore_r = 32 if precision == "proj_rescored" else 16
        self.proj_dim = int(proj_dim)
        self.tune_report: dict[int, float] = {}
        self.store = VectorStore(dim, capacity, device=device)
        self.device = self.store.device
        self._i8 = None    # (values, scales) shadow of int8_rescored
        self._proj = None  # (W, values, scales) shadow of proj_rescored

    @property
    def dim(self) -> int:
        return self.store.dim

    def __len__(self) -> int:
        return len(self.store)

    def insert(self, ids, vectors) -> None:
        self.store.add(np.asarray(ids, np.int64), vectors)
        self._i8 = None
        self._proj = None

    def delete(self, ids) -> None:
        # the shadows stay: a delete only flips the validity mask, which
        # search passes beside them
        self.store.remove(np.asarray(ids, np.int64))

    def _live(self):
        hw = max(self.store.high_watermark, 1)
        return hw, self.store.vectors[:hw], self.store.valid[:hw]

    def _ensure_i8(self, corpus: torch.Tensor, hw: int):
        """Build (or refresh) the int8 shadow of ``int8_rescored``."""
        if self._i8 is None or self._i8[0].shape[0] != hw:
            self._i8 = quantize_rows_int8(
                corpus, normalize=self.metric is Metric.COSINE
            )
        return self._i8

    def _unit_if_cosine(self, x: torch.Tensor) -> torch.Tensor:
        return unit_rows(x) if self.metric is Metric.COSINE else x

    def set_proj_basis(self, w) -> None:
        """Build the ``proj_rescored`` shadow over the current rows with the
        basis ``w [d, dp]`` instead of one computed from the corpus. An
        insert drops it, as it drops a computed one."""
        _, corpus, _ = self._live()
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.array(w, np.float32))  # the index's own copy
        w = w.to(self.device, torch.float32)
        if w.ndim != 2 or w.shape[0] != self.dim:
            raise ValueError(
                f"proj basis has shape {tuple(w.shape)}, want ({self.dim}, dp)"
            )
        v = self._unit_if_cosine(corpus)
        vi, sc = quantize_rows_int8(exact_f32_dots(v, w.T.contiguous()))
        self._proj = (w.contiguous(), vi, sc)

    def _ensure_proj(self, corpus: torch.Tensor, hw: int):
        """Build (or refresh) the projected int8 shadow of ``proj_rescored``:
        the uncentred PCA basis of the (cosine: unit) rows, the rows
        projected onto it and quantized with one scale per row."""
        if self._proj is None or self._proj[1].shape[0] != hw:
            w = proj_basis(self._unit_if_cosine(corpus),
                           min(self.proj_dim, self.dim))
            self.set_proj_basis(w)
        return self._proj

    def _retrieve(self, q: torch.Tensor, corpus, valid, hw: int, r: int):
        """The rescored modes' int8 retrieve, for search and tuning alike:
        candidates ``[B, r]`` int32, sorted by the int8 ranking."""
        if self.precision == "proj_rescored":
            w, vi, sc = self._ensure_proj(corpus, hw)
            return proj_candidates(q, w, vi, sc, r, metric=self.metric,
                                   corpus_valid=valid)
        vi, sc = self._ensure_i8(corpus, hw)
        return int8_candidates(q, vi, sc, r, metric=self.metric,
                               corpus_valid=valid)

    def tune_rescore_r(
        self,
        queries=None,
        k: int = 10,
        *,
        target_recall: float = 0.99,
        ladder: tuple[int, ...] = (8, 12, 16, 24, 32, 48, 64),
        sample: int = 512,
        seed: int = 0,
    ) -> int:
        """Pick the rescored modes' retrieve width for this corpus
        (``muninn_tpu/index/flat.py:195-273``): one retrieval of the
        ladder's largest r gives the recall of every ladder r against the
        exact top-k (``flat_topk(precision="highest")``); the smallest r
        reaching ``target_recall`` wins. Sets ``rescore_r`` and
        ``tune_report`` ({r: recall}); returns r.

        ``queries=None`` samples up to ``sample`` live rows with
        ``np.random.default_rng(seed)``, adds 0.05 Gaussian noise and
        normalises them, as the JAX package does."""
        if self.precision not in _RESCORED:
            raise ValueError(
                "tune_rescore_r applies to precision='int8_rescored'"
                " or 'proj_rescored'"
            )
        hw, corpus, valid = self._live()
        if queries is None:
            live = np.flatnonzero(valid.cpu().numpy())
            if len(live) == 0:
                raise ValueError("tune_rescore_r on an empty index")
            rng = np.random.default_rng(seed)
            pick = rng.choice(live, size=min(sample, len(live)), replace=False)
            q = corpus[torch.as_tensor(pick, device=self.device)].cpu().numpy()
            q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
            q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
            queries = q
        q = _query_tensor(queries, self.dim, self.device)
        r_max = max(max(ladder), k)
        cand = self._retrieve(q, corpus, valid, hw, r_max)
        _, true_slots = flat_topk(q, corpus, k, metric=self.metric,
                                  corpus_valid=valid, precision="highest")
        ladder_k = tuple(r for r in ladder if r >= k) or (r_max,)
        r, curve = pick_rescore_r(true_slots.cpu().numpy(),
                                  cand.cpu().numpy(), ladder_k, target_recall)
        self.rescore_r = int(r)
        self.tune_report = curve
        return int(r)

    def search_device(self, queries, k: int = 10):
        """Top-k with the results left on the index's device.

        Returns ``(dists f32 [B, k], slots int32 [B, k])`` tensors in slot
        space (``self.store.ids_of`` maps them to external ids)."""
        with span("index.search_device"):
            q = _query_tensor(queries, self.dim, self.device)
            hw, corpus, valid = self._live()
            if self.precision in _RESCORED:
                if self.metric is Metric.L2:
                    raise ValueError(
                        f"{self.precision} supports cosine/inner_product"
                    )
                r = max(self.rescore_r, k)
                with span("ops.int8_retrieve", rows=hw, r=r):
                    cand = self._retrieve(q, corpus, valid, hw, r)
                with span("ops.rescore", rows=q.shape[0], k=k):
                    return rescore(q, corpus, cand, k, self.metric)
            with span("ops.flat_topk", rows=hw, k=k):
                return flat_topk(q, corpus, k, metric=self.metric,
                                 corpus_valid=valid, precision=self.precision)

    def search(self, queries, k: int = 10):
        """Batched KNN. queries [B, d] (or [d]); returns
        ``(ids int64 [B, k], dists f32 [B, k])`` numpy arrays, ascending;
        empty slots are (-1, inf). A single query gives 1-D arrays."""
        return _search_ids(self, queries, k)


class QuantizedFlatIndex:
    """Exact scan over int8-quantized storage (``muninn_tpu/index/flat.py:
    329-407``): a quarter of the f32 store's bytes, cosine or inner product.
    Rows are (cosine: normalised, then) quantized with one f32 scale per row
    at insert; queries are quantized per call. Returned distances are
    quantized-dot approximations; ``FlatIndex(precision="int8_rescored")``
    adds an exact rescore."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.COSINE,
        *,
        capacity: int = 1024,
        device: str | torch.device = "cuda",
    ):
        self.metric = parse_metric(metric)
        if self.metric is Metric.L2:
            raise ValueError("QuantizedFlatIndex supports cosine/inner_product")
        self.store = VectorStore(dim, capacity, device=device,
                                 dtype=torch.int8)
        self.device = self.store.device

    @property
    def dim(self) -> int:
        return self.store.dim

    def __len__(self) -> int:
        return len(self.store)

    def insert(self, ids, vectors) -> None:
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        v = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        vi, sc = quantize_rows_int8(v.reshape(len(ids), self.dim),
                                    normalize=self.metric is Metric.COSINE)
        slots = self.store.add(ids, vi)
        lo = int(slots[0])  # slots are contiguous
        self.store.scales[lo : lo + len(slots)] = sc

    def delete(self, ids) -> None:
        self.store.remove(np.asarray(ids, np.int64))

    def search_device(self, queries, k: int = 10):
        """Top-k left on the device in slot space, as
        ``FlatIndex.search_device``."""
        with span("index.search_device"):
            q = _query_tensor(queries, self.dim, self.device)
            hw = max(self.store.high_watermark, 1)
            return flat_topk_int8(
                q, self.store.vectors[:hw], self.store.scales[:hw], k,
                metric=self.metric, corpus_valid=self.store.valid[:hw],
            )

    def search(self, queries, k: int = 10):
        """Batched KNN; the result contract of ``FlatIndex.search``."""
        return _search_ids(self, queries, k)
