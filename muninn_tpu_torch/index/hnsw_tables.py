"""The search tables of an ``HnswIndex``: what its search reads besides the
store and the graph, derived from them and kept from one search to the next.

- The guidance shadows: the store's rows as bf16 (``vecs16``), and as int8
  rows quantized as stored with one f32 scale a row (``vecs8``,
  ``hnsw.py:979-982``), each built at its first use.
- The packed ``[cap, R0, d]`` neighbour table of the beam's guidance
  (``pack``): ``vecs16[neighbors0]``, or ``vecs8[neighbors0]`` with the
  neighbours' scales ``[cap, R0]`` in ``scales`` (``-1`` gathers slot 0, as
  the clamp does). Built whole at the first search on a CUDA device when it
  fits the index's ``pack_budget_bytes``, on the CPU only when forced (so
  that the row path stays exercised there), and again whole when
  ``search_quant`` changed (``hnsw.py:1007-1032``).
- The ``search_degree`` slices of ``neighbors0`` and of the packed table
  (``degree``).
- The routing pool, the promoted (level >= 1) slots -1-padded to a power of
  two (``pool``), and their f32 rows (``pool_vectors``).

What each kind of write invalidates; the write paths say what happened, and
nothing else touches these tables:

- ``rows_written``: rows of the store were written; the shadows' rows are
  patched in place, as a whole conversion of the store would give them.
- ``neighbours_changed``: rows whose neighbours changed are marked for the
  packed table (nothing to mark while no table is kept; the next one is
  gathered whole).
- ``write_ended``: the marks become the rows that the next search
  re-gathers (``hnsw.repack``); the pool's f32 rows and the slices are
  dropped, since a write in place keeps the identity of the tables that
  they are keyed on.
- ``promotions_changed``: the pool is listed again at the next search.
- ``drop``: the graph was replaced or the capacity grew; the shadows, the
  packed table, its marks, the pool's rows and the slices are built again,
  whole, at the next search.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from muninn_tpu_torch.ops.distance import quantize_rows_int8
from muninn_tpu_torch.tracing import span

SEARCH_QUANTS = ("bf16", "int8")  # the beam's guidance rows


def int8_guidance(quant: str) -> bool:
    """Whether ``quant`` names int8 guidance; one outside ``SEARCH_QUANTS``
    raises."""
    if quant not in SEARCH_QUANTS:
        raise ValueError(f"search_quant must be one of {SEARCH_QUANTS}, got {quant!r}")
    return quant == "int8"


def pow2_pad(members: np.ndarray) -> np.ndarray:
    """``members`` -1-padded to a power of two of at least 64."""
    size = 1 << int(np.ceil(np.log2(max(len(members), 64))))
    return np.pad(members, (0, size - len(members)), constant_values=-1)


class SearchTables:
    """The derived search tables of ``index`` (see the module docstring).
    Reads the index's store, ``neighbors0``, ``levels``, ``search_quant``,
    ``search_degree`` and ``pack_budget_bytes`` when it builds."""

    def __init__(self, index):
        self.bind(index)
        self.v16: torch.Tensor | None = None
        self.v8: tuple[torch.Tensor, torch.Tensor] | None = None
        self.packed: torch.Tensor | None = None
        self.scales: torch.Tensor | None = None  # the int8 table's [cap, R0]
        self.quant = "bf16"  # the guidance the packed table holds
        # rows of the packed table that writes changed ([cap] bool on the
        # device), and their slots once the write ended
        self.dirty: torch.Tensor | None = None
        self.dirty_rows: torch.Tensor | None = None
        # (search_degree, neighbors0, packed, scales, and their slices)
        self.slices: tuple | None = None
        self.pool_slots: torch.Tensor | None = None
        self.pool_stale = True
        self.pool_rows: torch.Tensor | None = None

    def bind(self, index) -> None:
        """Refer to ``index``, weakly: dropping the index frees its device
        memory at once, without waiting for a collection of cycles."""
        self._index = weakref.ref(index)

    @property
    def index(self):
        return self._index()

    def __getstate__(self):
        # a copied or unpickled index binds its tables again
        return {k: v for k, v in self.__dict__.items() if k != "_index"}

    # ── what a search reads ──

    def vecs16(self) -> torch.Tensor:
        if self.v16 is None:
            self.v16 = self.index.store.vectors.bfloat16()
        return self.v16

    def vecs8(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.v8 is None:
            self.v8 = quantize_rows_int8(self.index.store.vectors)
        return self.v8

    def pool(self) -> torch.Tensor | None:
        """The routing pool; None while the graph has no promoted node."""
        if self.pool_stale:
            ix = self.index
            members = np.nonzero(ix.levels >= 1)[0].astype(np.int32)
            self.pool_slots = (
                None if len(members) == 0
                else torch.as_tensor(pow2_pad(members), device=ix.device)
            )
            self.pool_rows = None
            self.pool_stale = False
        return self.pool_slots

    def pool_vectors(self, pool: torch.Tensor) -> torch.Tensor:
        if self.pool_rows is None:
            self.pool_rows = self.index.store.vectors[pool.clamp(min=0).long()]
        return self.pool_rows

    def pack(self, force: bool = False) -> torch.Tensor | None:
        """The packed table of the index's ``search_quant``: the kept one,
        after it re-gathered the rows that writes marked, or one gathered
        whole; None over the budget, and on the CPU unless ``force``d. A
        ``search_quant`` outside ``SEARCH_QUANTS`` raises."""
        ix = self.index
        int8 = int8_guidance(ix.search_quant)
        if self.packed is not None and self.quant == ix.search_quant:
            if self.dirty_rows is not None:
                self._repack(self.dirty_rows)
            return self.packed
        need = ix.store.capacity * ix.m0 * ix.dim * (1 if int8 else 2)
        if need > ix.pack_budget_bytes:
            return None
        if ix.device.type == "cpu" and not force:
            return None
        with span("hnsw.repack", rows=ix.neighbors0.shape[0], whole=1):
            # one gather of the whole table, not one per row
            nb = ix.neighbors0.clamp(min=0).long()
            if int8:
                vi, sc = self.vecs8()
                self.packed, self.scales = vi[nb], sc[nb]
            else:
                self.packed, self.scales = self.vecs16()[nb], None
        self.quant = ix.search_quant
        self.dirty = self.dirty_rows = None
        return self.packed

    def _repack(self, rows: torch.Tensor) -> None:
        """Re-gather the packed rows ``rows`` from the shadow the table was
        built from, and clear the marks."""
        with span("hnsw.repack", rows=rows.shape[0], whole=0):
            nb = self.index.neighbors0[rows].clamp(min=0).long()
            if self.quant == "int8":
                vi, sc = self.vecs8()
                self.packed[rows], self.scales[rows] = vi[nb], sc[nb]
            else:
                self.packed[rows] = self.vecs16()[nb]
            self.dirty.zero_()
        self.dirty_rows = None
        self.slices = None

    def rebuild(self) -> None:
        """Gather the packed table whole for the current ``search_quant``,
        on any device."""
        self.packed = self.scales = None
        self.slices = None
        self.pack(force=True)

    def degree(self, packed: torch.Tensor | None, pscales: torch.Tensor | None):
        """``(neighbors0, packed, pscales)`` as the beam reads them: their
        first ``search_degree`` columns when that is below ``2M``
        (``hnsw.py:850-869``). The slices are copied once and cached, keyed
        on the knob and the identity of the source tables, which the cache
        keeps alive so that the identity stays sound."""
        ix = self.index
        sd = ix.search_degree
        if not sd or sd >= ix.m0:
            return ix.neighbors0, packed, pscales
        c = self.slices
        if not (c is not None and c[0] == sd and c[1] is ix.neighbors0
                and c[2] is packed and c[3] is pscales):
            def cut(t):
                return None if t is None else t[:, :sd].contiguous()

            self.slices = c = (sd, ix.neighbors0, packed, pscales,
                               cut(ix.neighbors0), cut(packed), cut(pscales))
        return c[4], c[5], c[6]

    # ── what the writes tell ──

    def rows_written(self, slots: torch.Tensor, rows: torch.Tensor) -> None:
        """The store's rows ``slots`` now hold the f32 ``rows``."""
        if self.v16 is not None:
            self.v16[slots] = rows.bfloat16()
        if self.v8 is not None:
            self.v8[0][slots], self.v8[1][slots] = quantize_rows_int8(rows)

    def neighbours_changed(self, rows: torch.Tensor) -> None:
        """Rows (device slots, or a ``[cap]`` mask) whose neighbours
        changed; no host read."""
        if self.packed is None:
            return  # the next pack is whole
        if self.dirty is None:
            self.dirty = torch.zeros(self.index.neighbors0.shape[0],
                                     dtype=torch.bool, device=self.index.device)
        if rows.dtype == torch.bool:
            self.dirty |= rows
        else:
            self.dirty[rows] = True

    def write_ended(self) -> None:
        if self.dirty is not None and self.packed is not None:
            self.dirty_rows = self.dirty.nonzero().squeeze(1)
        self.pool_rows = None
        self.slices = None

    def promotions_changed(self) -> None:
        self.pool_stale = True

    def drop(self) -> None:
        self.v16 = self.v8 = None
        self.packed = self.scales = None
        self.dirty = self.dirty_rows = None
        self.pool_rows = None
        self.slices = None
