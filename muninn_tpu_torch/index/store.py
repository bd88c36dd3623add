"""Vector store with external-id mapping, the PyTorch port of
``muninn_tpu/index/store.py``.

A padded ``[cap, d]`` tensor (``float32``; ``bfloat16``, whose rows are
written rounded to nearest even and read back with ``.float()``; or
``int8`` with one f32 scale per row in ``scales``) and a validity mask on
the index's device, with the int64 external-id <-> int32 slot map kept on the
host. Appends and deletes update the device tensors in place (slice and
index assignment); capacity grows by doubling, rounded to
``pad_multiple``. With ``reuse_slots`` a store takes freed slots again,
lowest first, before it appends at its high watermark, so that steady churn
keeps its capacity; without (the default, and the JAX package's only way)
slots are never reused.

The device defaults to the card, ``"cuda"``; the CPU is used only when a
caller passes ``device="cpu"``. Without a card the default raises rather
than falling back.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.tracing import span


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable card
    raises, with the way to ask for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available. Indexes"
            " and graphs run on the card by default; pass device='cpu' to"
            " run on the CPU"
        )
    return dev


class VectorStore:
    """Append-oriented vector storage. Slots are dense int32; external ids
    are arbitrary int64."""

    def __init__(self, dim: int, capacity: int = 1024, pad_multiple: int = 1024,
                 *, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, reuse_slots: bool = False):
        if dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(
                f"store dtype must be float32, bfloat16 or int8, got {dtype}")
        self.dim = int(dim)
        self.pad_multiple = int(pad_multiple)
        self.device = resolve_device(device)
        self.dtype = dtype
        capacity = _round_up(max(int(capacity), pad_multiple), pad_multiple)
        self.vectors = torch.zeros((capacity, self.dim), dtype=dtype,
                                   device=self.device)
        # per-row dequantization scales: int8 storage always carries them
        self.scales = (torch.zeros((capacity,), dtype=torch.float32,
                                   device=self.device)
                       if dtype == torch.int8 else None)
        self.valid = torch.zeros((capacity,), dtype=torch.bool,
                                 device=self.device)
        self._slot_of: dict[int, int] = {}
        self._id_of = np.full((capacity,), -1, np.int64)
        self._count = 0          # live rows
        self._high = 0           # first never-used slot
        self.reuse_slots = bool(reuse_slots)
        # freed slots below _high, ascending, taken first by register
        self._free = np.zeros(0, np.int32)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    def __len__(self) -> int:
        return self._count

    @property
    def high_watermark(self) -> int:
        return self._high

    def _grow(self, need: int) -> None:
        cap = self.capacity
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        new_cap = _round_up(new_cap, self.pad_multiple)
        vectors = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                              device=self.device)
        vectors[:cap] = self.vectors
        valid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
        valid[:cap] = self.valid
        self.vectors, self.valid = vectors, valid
        if self.scales is not None:
            self.scales = torch.nn.functional.pad(self.scales,
                                                  (0, new_cap - cap))
        self._id_of = np.pad(self._id_of, (0, new_cap - cap), constant_values=-1)

    def reserve(self, n: int) -> None:
        if self._high + n > self.capacity:
            self._grow(self._high + n)

    def _check_new(self, ids: np.ndarray) -> list[int]:
        id_list = ids.tolist()
        dups = self._slot_of.keys() & set(id_list)
        if dups:
            raise ValueError(f"duplicate id {next(iter(dups))}")
        if len(set(id_list)) != len(id_list):
            raise ValueError("duplicate id within batch")
        return id_list

    def register(self, ids: np.ndarray, reserve_extra: int = 0) -> np.ndarray:
        """Host-only bookkeeping of an append: assigns slots (freed ones
        first, lowest first, with ``reuse_slots``; then contiguous slots from
        the high watermark) and records the id mapping without device writes
        (the caller writes the rows and validity itself). Reserves room for
        the appended rows and ``reserve_extra`` more. Returns the slots,
        ascending."""
        ids = np.asarray(ids, np.int64)
        id_list = self._check_new(ids)
        n = len(id_list)
        with span("store.register", rows=n) as sp:
            cap = self.capacity
            reused = self._free[:n] if self.reuse_slots else self._free[:0]
            fresh = n - len(reused)
            self.reserve(fresh + reserve_extra)
            slots = np.concatenate(
                [reused, np.arange(self._high, self._high + fresh, dtype=np.int32)])
            self._free = self._free[len(reused):]
            self._slot_of.update(zip(id_list, slots.tolist()))
            self._id_of[slots] = ids
            self._high += fresh
            self._count += n
            sp.set(reused=len(reused), grew=int(self.capacity != cap),
                   high_watermark=self._high, live=self._count)
        return slots

    def add(self, ids: np.ndarray, vectors) -> np.ndarray:
        """Append a batch. ``ids`` int64 [n]; returns the assigned slots,
        int32 [n]. Duplicate ids raise ValueError."""
        ids = np.asarray(ids, np.int64)
        vecs = torch.as_tensor(vectors, dtype=self.dtype)
        vecs = vecs.reshape(len(ids), self.dim)
        slots = self.register(ids)
        if len(slots):
            lo, hi = int(slots[0]), int(slots[-1]) + 1
            # contiguous slots: one in-place slice write per tensor
            at = (slice(lo, hi) if hi - lo == len(slots) else
                  torch.as_tensor(slots, dtype=torch.long, device=self.device))
            self.vectors[at] = vecs.to(self.device)
            self.valid[at] = True
        return slots

    def unregister(self, ids: np.ndarray) -> np.ndarray:
        """Host-only bookkeeping of a soft delete: drops the id mapping and
        returns the freed slots without touching the validity mask; with
        ``reuse_slots`` they join the free list."""
        ids = np.asarray(ids, np.int64)
        slots = np.array([self._slot_of[int(i)] for i in ids], np.int32)
        for i in ids.tolist():
            del self._slot_of[i]
        self._id_of[slots] = -1
        self._count -= len(slots)
        if self.reuse_slots:
            self._free = np.union1d(self._free, slots).astype(np.int32)
        return slots

    def remove(self, ids: np.ndarray) -> np.ndarray:
        """Soft-delete by external id. Returns the freed slots (int32).
        Unknown ids raise KeyError, before anything changes."""
        slots = self.unregister(ids)
        if len(slots):
            self.valid[torch.as_tensor(slots, dtype=torch.long,
                                       device=self.device)] = False
        return slots

    def restore(self, vectors: np.ndarray, id_of: np.ndarray,
                scales: np.ndarray | None = None) -> None:
        """Replace the contents with ``vectors [hw, d]`` (and, in an int8
        store, ``scales [hw]``) and ``id_of [hw]`` (-1 on free
        slots): the slot map, live count, validity and high watermark are
        rebuilt from ``id_of``."""
        vectors = torch.tensor(np.asarray(vectors), dtype=self.dtype)
        id_of = np.asarray(id_of, np.int64)
        hw = id_of.shape[0]
        if tuple(vectors.shape) != (hw, self.dim):
            raise ValueError(
                f"vectors have shape {tuple(vectors.shape)}, want"
                f" ({hw}, {self.dim})"
            )
        if (scales is None) != (self.scales is None):
            raise ValueError("scales are given exactly for an int8 store")
        if scales is not None:
            scales = torch.as_tensor(np.asarray(scales, np.float32))
            if tuple(scales.shape) != (hw,):
                raise ValueError(
                    f"scales have shape {tuple(scales.shape)}, want ({hw},)"
                )
        live = np.flatnonzero(id_of >= 0)
        if len(np.unique(id_of[live])) != len(live):
            raise ValueError("duplicate id in id_of")
        self._slot_of = {}
        self._id_of = np.full((self.capacity,), -1, np.int64)
        self._high = self._count = 0
        self.reserve(hw)
        self.vectors.zero_()
        self.valid.zero_()
        self.vectors[:hw] = vectors.to(self.device)
        if scales is not None:
            self.scales.zero_()
            self.scales[:hw] = scales.to(self.device)
        self.valid[:hw] = torch.tensor(id_of >= 0, device=self.device)
        self._id_of[:hw] = id_of
        self._slot_of = dict(zip(id_of[live].tolist(), live.tolist()))
        self._count = len(live)
        self._high = hw
        self.reset_free()

    def reset_free(self) -> None:
        """Rebuild the free list from the id map: every slot below the high
        watermark that holds no id (none without ``reuse_slots``)."""
        self._free = (np.flatnonzero(self._id_of[: self._high] < 0).astype(np.int32)
                      if self.reuse_slots else np.zeros(0, np.int32))

    def slot(self, id_: int) -> int | None:
        return self._slot_of.get(int(id_))

    def slots_of(self, ids) -> np.ndarray:
        return np.array([self._slot_of[int(i)] for i in ids], np.int32)

    def ids_of(self, slots) -> np.ndarray:
        """Map slots back to external ids (-1 for a free slot or -1 input)."""
        slots = np.asarray(slots)
        with span("index.ids_of", rows=len(slots) if slots.ndim else 1):
            return np.where(slots >= 0, self._id_of[np.maximum(slots, 0)], -1)

    def get_vector(self, id_: int) -> np.ndarray | None:
        s = self.slot(id_)
        if s is None or not bool(self.valid[s]):
            return None
        row = self.vectors[s]
        return (row.float() if row.dtype == torch.bfloat16 else row).cpu().numpy()
