"""Graph core: node interning, edge lists, the device-resident CSR.

The port's copy of ``muninn_tpu.graph.core`` (the reference's
``src/graph_load.c`` string-id hash map and adjacency lists, and
``src/graph_csr.c`` CSR build and delta merge):

- Node ids (strings or ints) are interned to dense ``int32`` indices at
  the API boundary (``NodeTable``), never in hot paths.
- The device representation is a **sorted COO + offsets** pair (which
  *is* CSR): ``src[E], dst[E], w[E]`` sorted by src, plus
  ``offsets[V+1]``, as torch tensors on the graph's device. The
  fixpoints (``graph.traversal``, ``graph.pagerank``) reduce over its
  rows with ``ops.segments``.
- Both directions are kept (forward = sorted by src, reverse = sorted by
  dst re-labelled as src), the reference's fwd/rev CSR pair
  (``src/graph_csr.c:20-83``), and 'both' merges them.

``DeviceCsr`` keeps the JAX package's padded layout (a pow-2 capacity,
inert ``(V, V, w=0)`` pads), so its arrays equal JAX's array for array.

A graph built by ``Graph.from_device_edges`` keeps its padded COO on the
device for its lifetime: each direction is sorted from it, so the edges of
a row always keep their input order. (The JAX package drops that COO above
2**25 edges and derives the opposite direction from the first one built,
whose rows then come out in ascending order of the other endpoint; no
analytic reads the order within a row.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from muninn_tpu_torch import native
from muninn_tpu_torch.index.store import resolve_device

DIRECTIONS = ("forward", "reverse", "both")


def _pad_bucket(e: int) -> int:
    """Pow2 capacity bucket of an edge count (at least 64): the padded
    layout of the JAX package's CSR, kept so the arrays match."""
    return max(64, 1 << int(np.ceil(np.log2(max(e, 1)))))


class NodeTable:
    """Dense interning of arbitrary hashable node ids -> int32 indices.

    Reference analogue: DJB2 + linear-probing hash map in
    ``src/graph_load.c:56-123``. Python's dict plays that role on host;
    indices are what reach the device.
    """

    def __init__(self):
        self._index: dict = {}
        self._ids: list = []

    def __len__(self) -> int:
        return len(self._ids)

    def find_or_add(self, node_id) -> int:
        idx = self._index.get(node_id)
        if idx is None:
            idx = len(self._ids)
            self._index[node_id] = idx
            self._ids.append(node_id)
        return idx

    def find(self, node_id) -> int | None:
        return self._index.get(node_id)

    def id_of(self, idx: int):
        return self._ids[idx]

    def intern_many(self, ids) -> np.ndarray:
        return np.fromiter(
            (self.find_or_add(i) for i in ids), np.int32, count=len(ids)
        )

    @property
    def ids(self) -> list:
        return self._ids


class IdentityNodeTable:
    """Node ids ARE the dense indices ``0..n-1``.

    Used by :meth:`Graph.from_device_edges`, where a python list/dict of
    10M+ interned ids would dwarf the graph itself. API-compatible with
    :class:`NodeTable` for lookups; the table is fixed-size, so
    ``find_or_add`` of an out-of-range id raises.
    """

    def __init__(self, n: int):
        self._n = int(n)

    def __len__(self) -> int:
        return self._n

    def find(self, node_id) -> int | None:
        try:
            i = int(node_id)
        except (TypeError, ValueError):
            return None
        return i if 0 <= i < self._n else None

    def find_or_add(self, node_id) -> int:
        i = self.find(node_id)
        if i is None:
            raise KeyError(
                f"identity node table is fixed at {self._n} nodes; "
                f"cannot intern {node_id!r}"
            )
        return i

    def id_of(self, idx: int) -> int:
        return int(idx)

    def intern_many(self, ids) -> np.ndarray:
        a = np.asarray(ids, np.int64)
        if a.size and (a.min() < 0 or a.max() >= self._n):
            raise KeyError("node id out of range for identity table")
        return a.astype(np.int32)

    @property
    def ids(self) -> range:
        return range(self._n)


@dataclass
class DeviceCsr:
    """One direction of the graph on the device. ``src``/``dst`` are sorted
    by ``src``; ``offsets[v]:offsets[v+1]`` slices v's out-edges.

    Arrays are padded to a pow2 capacity with **inert pad edges**
    ``(V, V, w=0)``: they sort after every valid edge and no row's
    ``[offsets[v], offsets[v+1])`` reaches them. Host-side consumers slice
    via ``host_coo()``. ``e_valid`` is the live edge count
    (== ``offsets[num_nodes]``).

    ``src`` and ``weights`` are **None** on device builds
    (``Graph.from_device_edges``): ``src`` is redundant with ``offsets``
    and an unweighted graph's ones-vector is dead memory. :meth:`s` and
    :meth:`w` materialize (and cache) them on demand; the pull fixpoints
    never do.
    """

    offsets: torch.Tensor          # int32 [V+1]
    src: torch.Tensor | None       # int32 [E_cap] (sorted; pads = V) or None
    dst: torch.Tensor              # int32 [E_cap] (pads = V)
    weights: torch.Tensor | None   # float32 [E_cap] (pads = 0) or None
    e_valid: int
    #: host-known max segment length (the JAX contract's pass count input)
    max_deg: int = 1

    @property
    def num_nodes(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.e_valid

    @property
    def capacity(self) -> int:
        return self.dst.shape[0]

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def s(self) -> torch.Tensor:
        """The sorted key array, materialized from ``offsets`` when a device
        build left it out (pads land at exactly V because
        ``offsets[-1] == e_valid``)."""
        if self.src is None:
            self.src = _src_from_offsets(self.offsets, self.capacity)
        return self.src

    def w(self) -> torch.Tensor:
        """Edge weights, materializing the implicit ones (pads 0) for an
        unweighted device build."""
        if self.weights is None:
            pos = torch.arange(self.capacity, device=self.dst.device)
            self.weights = (pos < self.e_valid).float()
        return self.weights

    def host_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Valid edges as host numpy arrays (pads sliced off)."""
        e = self.e_valid
        return (
            self.s()[:e].cpu().numpy(),
            self.dst[:e].cpu().numpy(),
            self.w()[:e].cpu().numpy(),
        )


def _src_from_offsets(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """The sorted key array of a CSR, from its offsets (pads = V)."""
    pos = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets, pos, right=True, out_int32=True) - 1


def build_csr_arrays(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host CSR build via the native O(E+V) counting sort
    (``muninn_tpu_torch.native``, the ``src/graph_csr.c:20-83`` role), with
    a numpy fallback inside."""
    return native.csr_build(src, dst, w, num_nodes)


class Graph:
    """In-memory graph over interned nodes, with device CSR both ways.

    ``from_edges`` mirrors the reference TVF loader semantics
    (``graph_data_load``, ``src/graph_load.c:164-245``): arbitrary node
    ids, optional weights, optional temporal filter, direction handling
    via the fwd/rev CSR pair. Analytics methods live in
    ``muninn_tpu_torch.graph.api.Graph`` (subclass). ``device`` is where
    the CSR lives (the card unless the caller asks for the CPU).
    """

    # class-level defaults: a graph built by ``__new__`` and attribute
    # assignment (as JAX's GraphCache does) never runs ``__init__``
    _dev_coo: tuple | None = None
    _e_dev: int = 0
    _src_np = None
    _dst_np = None
    _w_np = None
    _both: DeviceCsr | None = None

    def __init__(
        self,
        nodes: NodeTable,
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        weights: np.ndarray | None,
        *,
        device: str | torch.device = "cuda",
    ):
        self.nodes = nodes
        self.device = resolve_device(device)
        e = len(src_idx)
        self._src = src_idx.astype(np.int32)
        self._dst = dst_idx.astype(np.int32)
        self._w = (
            np.ones(e, np.float32) if weights is None
            else np.asarray(weights, np.float32)
        )
        self.has_weights = weights is not None
        self._fwd: DeviceCsr | None = None
        self._rev: DeviceCsr | None = None
        self._host_csr: dict[str, tuple] = {}

    # host COO mirrors: plain numpy arrays for host-built graphs, lazy
    # (downloaded once on first touch) for device-built graphs
    @property
    def _src(self) -> np.ndarray:
        if self._src_np is None:
            self._materialize_host()
        return self._src_np

    @_src.setter
    def _src(self, v) -> None:
        self._src_np = v

    @property
    def _dst(self) -> np.ndarray:
        if self._dst_np is None:
            self._materialize_host()
        return self._dst_np

    @_dst.setter
    def _dst(self, v) -> None:
        self._dst_np = v

    @property
    def _w(self) -> np.ndarray:
        if self._w_np is None:
            self._materialize_host()
        return self._w_np

    @_w.setter
    def _w(self, v) -> None:
        self._w_np = v

    def _materialize_host(self) -> None:
        """Download the device COO once (pads sliced off). Only reached
        from a device-built graph when a host-side consumer touches the
        mirrors."""
        e = self._e_dev
        js, jd, jw = self._dev_coo
        self._src_np = js[:e].cpu().numpy()
        self._dst_np = jd[:e].cpu().numpy()
        self._w_np = (
            np.ones(e, np.float32) if jw is None else jw[:e].cpu().numpy()
        )

    # ── construction ──

    @classmethod
    def from_edges(
        cls,
        src_ids,
        dst_ids,
        weights=None,
        *,
        timestamps=None,
        time_start=None,
        time_end=None,
        nodes: NodeTable | None = None,
        device: str | torch.device = "cuda",
    ) -> "Graph":
        """Build from parallel src/dst id sequences.

        ``timestamps`` + ``time_start``/``time_end`` mirror the
        reference's temporal WHERE filtering
        (``src/graph_load.c:164-212``): edges outside the window are
        dropped before interning.

        Integer numpy id arrays take a vectorized interning fast path;
        arbitrary hashables go through the NodeTable dict.
        """
        # numpy-integer fast path (also catches python-int lists: the
        # asarray probe is far cheaper than dict interning 10M ids)
        np_fast = nodes is None
        if np_fast and not (
            isinstance(src_ids, np.ndarray)
            and isinstance(dst_ids, np.ndarray)
        ):
            try:
                sa = np.asarray(src_ids)
                da = np.asarray(dst_ids)
                if (np.issubdtype(sa.dtype, np.integer)
                        and np.issubdtype(da.dtype, np.integer)):
                    src_ids, dst_ids = sa, da
                else:
                    np_fast = False
            except (ValueError, TypeError):
                np_fast = False
        np_fast = (
            np_fast
            and isinstance(src_ids, np.ndarray)
            and isinstance(dst_ids, np.ndarray)
            and np.issubdtype(src_ids.dtype, np.integer)
            and np.issubdtype(dst_ids.dtype, np.integer)
        )
        if not np_fast:
            src_ids = list(src_ids)
            dst_ids = list(dst_ids)
        if len(src_ids) != len(dst_ids):
            raise ValueError("src/dst length mismatch")
        keep = None
        if timestamps is not None:
            ts = np.asarray(timestamps, np.float64)
            keep = np.ones(len(src_ids), bool)
            if time_start is not None:
                keep &= ts >= time_start
            if time_end is not None:
                keep &= ts <= time_end
        if weights is not None:
            weights = np.asarray(weights, np.float32)
            if keep is not None:
                weights = weights[keep]
        if keep is not None:
            if np_fast:
                src_ids = src_ids[keep]
                dst_ids = dst_ids[keep]
            else:
                src_ids = [s for s, k in zip(src_ids, keep) if k]
                dst_ids = [s for s, k in zip(dst_ids, keep) if k]
        if np_fast:
            combined = np.concatenate([src_ids, dst_ids])
            lo = int(combined.min()) if combined.size else 0
            hi = int(combined.max()) if combined.size else 0
            span = hi - lo + 1
            if 0 < span <= max(4 * combined.size, 1 << 22):
                # bounded-range ids: flag-array interning is O(E + span)
                # where np.unique sorts
                seen = np.zeros(span, bool)
                seen[combined - lo] = True
                remap = np.cumsum(seen, dtype=np.int64) - 1
                uniq = np.nonzero(seen)[0] + lo
                inv = remap[combined - lo]
            else:
                uniq, inv = np.unique(combined, return_inverse=True)
            table = NodeTable()
            table._ids = uniq.tolist()
            table._index = {u: i for i, u in enumerate(table._ids)}
            si = inv[: len(src_ids)].astype(np.int32)
            di = inv[len(src_ids):].astype(np.int32)
            return cls(table, si, di, weights, device=device)
        table = nodes if nodes is not None else NodeTable()
        si = table.intern_many(src_ids)
        di = table.intern_many(dst_ids)
        return cls(table, si, di, weights, device=device)

    @classmethod
    def from_device_edges(
        cls, src, dst, *, num_nodes: int, weights=None,
        device: str | torch.device | None = None,
    ) -> "Graph":
        """Build from dense int32 edge arrays that stay on the device —
        nothing crosses the host boundary.

        The constructor for device-scale graphs (10M+ nodes, 100M+ edges):
        edges generated on the device (e.g. from a ``torch.Generator``) stay
        there, the CSR is built by a device stable sort, and node ids are
        the dense indices themselves (:class:`IdentityNodeTable`). The host
        COO mirrors are lazy: host analytics and persistence still work,
        but pay a one-time download. Ids must already be in
        ``[0, num_nodes)``; arbitrary external ids are a host concept, use
        :meth:`from_edges`.

        Tensors keep their device; numpy arrays go to ``device`` (the card
        unless the caller asks for the CPU).
        """
        if device is None:
            device = src.device if isinstance(src, torch.Tensor) else "cuda"
        dev = resolve_device(device)
        js, jd = _on(src, torch.int32, dev), _on(dst, torch.int32, dev)
        if js.shape != jd.shape or js.ndim != 1:
            raise ValueError("src/dst must be equal-length 1-D arrays")
        e = int(js.shape[0])
        pad = _pad_bucket(e) - e
        jw = None
        if weights is not None:
            jw = torch.nn.functional.pad(_on(weights, torch.float32, dev),
                                         (0, pad))
        # inert pads (V, V, 0): sort after every valid edge
        js = torch.nn.functional.pad(js, (0, pad), value=num_nodes)
        jd = torch.nn.functional.pad(jd, (0, pad), value=num_nodes)
        g = cls(IdentityNodeTable(num_nodes), np.zeros(0, np.int32),
                np.zeros(0, np.int32), None, device=dev)
        g._dev_coo = (js, jd, jw)
        g._e_dev = e
        g._src = g._dst = g._w = None  # lazy mirrors
        g.has_weights = weights is not None
        return g

    # ── views ──

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        if self._src_np is None:
            return self._e_dev
        return len(self._src_np)

    @property
    def device_native(self) -> bool:
        """True while this graph's edges live only on the device (built by
        :meth:`from_device_edges`, host mirrors never materialized)."""
        return self._src_np is None and self._dev_coo is not None

    def csr(self, direction: str = "forward") -> DeviceCsr:
        """Direction semantics match the reference
        (``src/graph_load.c:215-245``): 'forward' follows src->dst,
        'reverse' follows dst->src, 'both' treats edges as undirected
        (each edge present in both orientations)."""
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}")
        dev = self._dev_coo is not None
        if direction == "forward":
            if self._fwd is None:
                self._fwd = (
                    self._build_device(0) if dev
                    else self._build(self._src, self._dst)
                )
            return self._fwd
        if direction == "reverse":
            if self._rev is None:
                self._rev = (
                    self._build_device(1) if dev
                    else self._build(self._dst, self._src)
                )
            return self._rev
        if self._both is None:
            if dev or (self._fwd is not None and self._rev is not None):
                # both directions on the device: one stable two-way merge,
                # no host sort and no re-upload
                self._both = merge_both_device(
                    self.csr("forward"), self.csr("reverse"))
            else:
                s = np.concatenate([self._src, self._dst])
                d = np.concatenate([self._dst, self._src])
                w = np.concatenate([self._w, self._w])
                off, ss, dd, ww = build_csr_arrays(s, d, w, self.num_nodes)
                self._both = _to_device_csr(off, ss, dd, ww, self.num_nodes,
                                            self.device)
        return self._both

    def _build(self, s: np.ndarray, d: np.ndarray) -> DeviceCsr:
        off, ss, dd, ww = build_csr_arrays(s, d, self._w, self.num_nodes)
        return _to_device_csr(off, ss, dd, ww, self.num_nodes, self.device)

    def _build_device(self, flip: int) -> DeviceCsr:
        """CSR by a device stable sort over the device COO — the host
        counting sort's edge order (``native.csr_build``): grouped by key
        node, input order within a group, pads last. ``flip=1`` builds the
        reverse direction (sort by dst). The sorted key array is left out
        (``offsets`` encode it; ``DeviceCsr.s()`` rebuilds it on demand),
        and an unweighted graph carries ``weights=None``."""
        js, jd, jw = self._dev_coo
        s, d = (jd, js) if flip else (js, jd)
        off, dd, ww = _sort_csr(s, d, jw, self.num_nodes)
        max_deg = int((off[1:] - off[:-1]).max()) if self.num_nodes else 1
        return DeviceCsr(off, None, dd, ww, self._e_dev, max(max_deg, 1))

    def host_coo(self, direction: str = "forward"):
        """(src, dst, w) numpy COO in the requested direction with NO
        device involvement. 'both' doubles each edge."""
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}")
        if direction == "forward":
            return self._src, self._dst, self._w
        if direction == "reverse":
            return self._dst, self._src, self._w
        return (
            np.concatenate([self._src, self._dst]),
            np.concatenate([self._dst, self._src]),
            np.concatenate([self._w, self._w]),
        )

    def host_csr(self, direction: str = "forward"):
        """(offsets, src, dst, w) numpy CSR via the native counting
        sort, cached per direction. Device arrays are untouched."""
        hit = self._host_csr.get(direction)
        if hit is None:
            s, d, w = self.host_coo(direction)
            hit = build_csr_arrays(s, d, w, self.num_nodes)
            self._host_csr[direction] = hit
        return hit

    def node_index(self, node_id) -> int:
        idx = self.nodes.find(node_id)
        if idx is None:
            raise KeyError(f"unknown node {node_id!r}")
        return idx

    def node_ids(self, indices) -> list:
        return [self.nodes.id_of(int(i)) for i in indices]


def _on(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` (a tensor, or an array-like copied) as ``dtype`` on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _sort_csr(s: torch.Tensor, d: torch.Tensor, w: torch.Tensor | None,
              num_nodes: int):
    """Sort a padded device COO by ``s`` (stable) and derive offsets. Pads
    carry ``s == num_nodes`` so they sort to the tail; offsets stop at the
    first pad. Returns (offsets, dst, weights or None)."""
    ss, order = torch.sort(s, stable=True)
    dd = d.index_select(0, order)
    ww = None if w is None else w.index_select(0, order)
    del order
    off = torch.searchsorted(
        ss, torch.arange(num_nodes + 1, dtype=torch.int32, device=s.device),
        out_int32=True,
    )
    return off, dd, ww


def _to_device_csr(
    off: np.ndarray, ss: np.ndarray, dd: np.ndarray, ww: np.ndarray,
    num_nodes: int, device: torch.device,
) -> DeviceCsr:
    e = len(ss)
    cap = _pad_bucket(e)
    ss = np.pad(ss, (0, cap - e), constant_values=num_nodes)
    dd = np.pad(dd, (0, cap - e), constant_values=num_nodes)
    ww = np.pad(ww, (0, cap - e))
    max_deg = int(np.max(np.diff(off))) if num_nodes > 0 else 1
    return DeviceCsr(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (off, ss, dd, ww)),
        e, max_deg,
    )


# ─────────────── device-side incremental CSR maintenance ───────────────
# The reference rewrites only affected 4096-node blocks on incremental
# rebuild (src/graph_adjacency.c:649-1005, src/graph_csr.c:341-478). Here
# the CSR lives in capacity-padded device arrays, and a small delta is
# applied on the device (delete-mark + compact, then a sorted-merge
# insert) with O(delta) host work and upload.


def csr_patch_positions(
    offsets: torch.Tensor,   # [V+1] int32
    src: torch.Tensor,       # [E_cap] int32 sorted, pads = V
    dst: torch.Tensor,       # [E_cap] int32, pads = V
    w: torch.Tensor,         # [E_cap] f32, pads = 0
    del_pos: torch.Tensor,   # [Kd] int32 CSR positions to remove; pads = E_cap
    del_src: torch.Tensor,   # [Kd] int32 src at each removed position; pads = V
    ins_src: torch.Tensor,   # [Ki] int32 sorted by src; pads = V
    ins_dst: torch.Tensor,   # [Ki] int32; pads = V
    ins_w: torch.Tensor,     # [Ki] f32
    num_nodes: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply (deletes-by-position, inserts) to a sorted padded CSR.

    The HOST decides which CSR slots die: it mirrors the device order
    bit-exactly, so finding a delete's first live (src, dst) occurrence is
    a tiny host lookup and the device never matches keys. Surviving edges
    keep their order and inserts land after the existing edges of their
    src, in insert order — the host replay's order (graph_csr.c:219-247):
    one stable sort by src of the survivors followed by the inserts.

    Returns (offsets, src, dst, w, new_e_valid) with ``new_e_valid`` a
    0-d int32 tensor; the live count must fit ``E_cap`` (caller checks)."""
    e_cap = src.shape[0]
    remove = torch.zeros(e_cap + 1, dtype=torch.bool, device=src.device)
    remove[del_pos.long().clamp(0, e_cap)] = True
    keep = (src < num_nodes) & ~remove[:e_cap]
    live_i = ins_src < num_nodes

    comb_src = torch.cat([torch.where(keep, src, num_nodes),
                          torch.where(live_i, ins_src, num_nodes)])
    comb_dst = torch.cat([torch.where(keep, dst, num_nodes),
                          torch.where(live_i, ins_dst, num_nodes)])
    comb_w = torch.cat([torch.where(keep, w, 0.0),
                        torch.where(live_i, ins_w, 0.0)])
    # the concatenation is in (position, insert index) order already, so a
    # stable sort by src is the sort by (src, rank)
    ss, order = torch.sort(comb_src, stable=True)
    order = order[:e_cap]
    src3 = ss[:e_cap]
    dst3 = comb_dst.index_select(0, order)
    w3 = comb_w.index_select(0, order)

    def counts(idx: torch.Tensor) -> torch.Tensor:
        c = torch.zeros(num_nodes + 1, dtype=torch.int32, device=src.device)
        c.index_add_(0, idx.long().clamp(0, num_nodes),
                     torch.ones_like(idx, dtype=torch.int32))
        return c[:num_nodes]

    delta = torch.cumsum(counts(torch.where(live_i, ins_src, num_nodes))
                         - counts(del_src), 0, dtype=torch.int32)
    offsets = offsets + torch.cat([delta.new_zeros(1), delta])
    e_new = (keep.sum() + live_i.sum()).to(torch.int32)
    return offsets, src3, dst3, w3, e_new


def _merge_sorted_pair(a_src, a_dst, a_w, b_src, b_dst, b_w):
    """Stable two-way merge of two src-sorted padded COO sets (a's entries
    precede b's on equal src; pads sort last in both). ``a_w``/``b_w`` may
    both be ``None`` (unweighted device CSRs) — the merged weights are then
    ``None`` too."""
    ca, cb = a_src.shape[0], b_src.shape[0]
    dev = a_src.device
    ta = torch.arange(ca, device=dev) + torch.searchsorted(b_src, a_src)
    tb = torch.arange(cb, device=dev) + torch.searchsorted(a_src, b_src,
                                                           right=True)
    n = ca + cb
    src = torch.empty(n, dtype=torch.int32, device=dev)
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    src[ta], src[tb] = a_src, b_src
    dst[ta], dst[tb] = a_dst, b_dst
    w = None
    if a_w is not None or b_w is not None:
        w = torch.empty(n, dtype=torch.float32, device=dev)
        w[ta] = a_w if a_w is not None else torch.ones(ca, device=dev)
        w[tb] = b_w if b_w is not None else torch.ones(cb, device=dev)
    return src, dst, w


def merge_both_device(fwd: DeviceCsr, rev: DeviceCsr) -> DeviceCsr:
    """'both'-direction CSR from the fwd and rev device CSRs by one device
    merge — the host build's stable order (forward orientations before
    reverse copies on equal src)."""
    src, dst, w = _merge_sorted_pair(
        fwd.s(), fwd.dst, fwd.weights, rev.s(), rev.dst, rev.weights
    )
    return DeviceCsr(
        fwd.offsets + rev.offsets, src, dst, w, fwd.e_valid + rev.e_valid,
        fwd.max_deg + rev.max_deg,
    )
