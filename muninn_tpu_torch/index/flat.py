"""Brute-force KNN index, the PyTorch port of ``muninn_tpu/index/flat.py``
``FlatIndex`` at ``precision="highest"`` (exact) and ``"default"`` /
``"bfloat16"`` (bf16-rounded operands, f32 sums).

Search runs ``ops.flat_topk.flat_topk`` over the store's live prefix: on a
CUDA device that is the hand-written kernel, on the CPU its plain version
``flat_topk_plain``, which is also the counterpart of ``_xla_chunked_topk``
(a chunked exact top-k merged with ``masked_topk`` and ``merge_topk``).
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.index.store import VectorStore
from muninn_tpu_torch.ops.distance import Metric, parse_metric
from muninn_tpu_torch.ops.flat_topk import flat_topk

# precisions of muninn_tpu's FlatIndex that this package has not ported yet
_NOT_PORTED = ("int8_rescored", "proj_rescored")
_PORTED = ("highest", "default", "bfloat16")


class FlatIndex:
    """Exact KNN over a vector store on ``device``: insert and delete by
    external int64 id, batched search."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        capacity: int = 1024,
        device: str | torch.device = "cpu",
        precision: str = "highest",
    ):
        self.metric = parse_metric(metric)
        if precision in _NOT_PORTED:
            raise NotImplementedError(
                f"precision={precision!r} is not ported yet: only"
                f" {', '.join(_PORTED)} are (see ROADMAP.md, queue 1)"
            )
        if precision not in _PORTED:
            raise ValueError(
                f"precision must be one of {_PORTED}, got {precision!r}"
            )
        self.precision = precision
        self.device = torch.device(device)
        self.store = VectorStore(dim, capacity, device=self.device)

    @property
    def dim(self) -> int:
        return self.store.dim

    def __len__(self) -> int:
        return len(self.store)

    def insert(self, ids, vectors) -> None:
        self.store.add(np.asarray(ids, np.int64), vectors)

    def delete(self, ids) -> None:
        self.store.remove(np.asarray(ids, np.int64))

    def search_device(self, queries, k: int = 10):
        """Exact top-k with the results left on the index's device.

        Returns ``(dists f32 [B, k], slots int32 [B, k])`` tensors in slot
        space (``self.store.ids_of`` maps them to external ids)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        hw = max(self.store.high_watermark, 1)
        return flat_topk(
            q, self.store.vectors[:hw], k, metric=self.metric,
            corpus_valid=self.store.valid[:hw], precision=self.precision,
        )

    def search(self, queries, k: int = 10):
        """Batched exact KNN. queries [B, d] (or [d]); returns
        ``(ids int64 [B, k], dists f32 [B, k])`` numpy arrays, ascending;
        empty slots are (-1, inf). A single query gives 1-D arrays."""
        single = np.ndim(queries) == 1
        d, slots = self.search_device(queries, k)
        ids = self.store.ids_of(slots.cpu().numpy())
        d = d.cpu().numpy()
        if single:
            return ids[0], d[0]
        return ids, d
