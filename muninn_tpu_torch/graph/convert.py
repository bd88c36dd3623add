"""Carry a graph's state between ``muninn_tpu`` and this package.

Both directions take and give only numpy, so neither package imports the
other. ``graph_to_numpy`` reads a ``Graph`` of either package (the two
share their attribute names; JAX arrays and torch tensors both come back
as numpy), and ``graph_from_numpy`` builds the port's ``Graph`` on a
device, with every built direction's CSR as it was: the port's fixpoints
then run on JAX's own arrays.

The state:

- nodes: ``num_nodes``; ``identity_nodes`` (True for a
  ``from_device_edges`` graph, whose ids are the indices) or ``node_ids``
  (the interned ids in index order, as a numpy array);
- the host COO ``src [E]``, ``dst [E]`` int32 and ``w [E]`` f32, in input
  order (downloaded from the device COO of a device-built graph, without
  caching it there), ``has_weights`` and ``device_native`` (the graph's
  edges lived only on the device: the port's graph keeps them there too);
- for each built direction ``<d>`` in forward, reverse, both:
  ``<d>_offsets [V+1]``, ``<d>_dst [E_cap]`` int32, ``<d>_src`` and
  ``<d>_weights [E_cap]`` where the CSR holds them, ``<d>_e_valid`` and
  ``<d>_max_deg``.

``graph_cache_to_numpy`` and ``graph_cache_from_numpy`` do the same for a
``GraphCache`` of either package: ``node_ids``, the COO ``src``, ``dst``,
``w`` in storage order, ``weighted``, ``generation`` and ``block_lens``
(the persisted block layout, None until a save or load set one). A cache's
pending deltas are applied first, as ``save`` applies them; its device
CSRs are derived again on the other side.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.graph.adjacency import GraphCache
from muninn_tpu_torch.graph.api import Graph
from muninn_tpu_torch.graph.core import (
    DIRECTIONS,
    DeviceCsr,
    IdentityNodeTable,
    NodeTable,
)
from muninn_tpu_torch.index.store import resolve_device


def _np(a) -> np.ndarray:
    """A JAX array, a torch tensor (on any device) or a numpy array as
    numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _built(g, direction: str):
    return {"forward": g._fwd, "reverse": g._rev,
            "both": getattr(g, "_both", None)}[direction]


def _ids_array(ids) -> np.ndarray:
    """Interned node ids as numpy: a typed array where numpy keeps every id
    as it was (ints stay ints, strings strings), else an object array."""
    arr = np.asarray(ids)
    if arr.dtype.kind not in "iuU" or arr.tolist() != list(ids):
        arr = np.array(list(ids), dtype=object)
    return arr


def graph_to_numpy(g) -> dict:
    """The state of ``g``, a ``Graph`` of either package (see the module
    docstring)."""
    state: dict = {"num_nodes": g.num_nodes, "has_weights": g.has_weights,
                   "device_native": bool(g.device_native)}
    if hasattr(g.nodes, "_index"):
        state["node_ids"] = _ids_array(g.nodes.ids)
    else:
        state["identity_nodes"] = True
    if g._src_np is None and g._dev_coo is not None:
        e = g._e_dev
        js, jd, jw = g._dev_coo
        state["src"], state["dst"] = _np(js)[:e], _np(jd)[:e]
        state["w"] = (np.ones(e, np.float32) if jw is None
                      else _np(jw)[:e])
    else:  # host mirrors (materialized on first touch, as in either package)
        state["src"], state["dst"], state["w"] = g._src, g._dst, g._w
    for d in DIRECTIONS:
        c = _built(g, d)
        if c is None:
            continue
        state[f"{d}_offsets"] = _np(c.offsets)
        state[f"{d}_dst"] = _np(c.dst)
        if c.src is not None:
            state[f"{d}_src"] = _np(c.src)
        if c.weights is not None:
            state[f"{d}_weights"] = _np(c.weights)
        state[f"{d}_e_valid"] = int(c.e_valid)
        state[f"{d}_max_deg"] = int(c.max_deg)
    return state


def _tensor(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of a caller's array)."""
    return torch.from_numpy(np.array(a, dtype)).to(device)


def graph_from_numpy(state: dict, device: str | torch.device = "cuda") -> Graph:
    """The port's ``Graph`` of ``state`` (see the module docstring) on
    ``device``, with the state's built directions as its CSRs."""
    dev = resolve_device(device)
    n = int(state["num_nodes"])
    src = np.asarray(state["src"], np.int32)
    dst = np.asarray(state["dst"], np.int32)
    w = np.asarray(state["w"], np.float32)
    if len(src) != len(dst) or len(src) != len(w):
        raise ValueError("src, dst and w must have one length")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n):
        raise ValueError("an edge endpoint lies outside [0, num_nodes)")
    weights = w if state["has_weights"] else None
    if state.get("device_native"):
        g = Graph.from_device_edges(src, dst, num_nodes=n, weights=weights,
                                    device=dev)
    else:
        if state.get("identity_nodes"):
            nodes = IdentityNodeTable(n)
        else:
            nodes = NodeTable()
            nodes._ids = np.asarray(state["node_ids"]).tolist()
            nodes._index = {u: i for i, u in enumerate(nodes._ids)}
        if len(nodes) != n:
            raise ValueError("node_ids must hold num_nodes ids")
        g = Graph(nodes, src, dst, weights, device=dev)
    for d in DIRECTIONS:
        if f"{d}_offsets" not in state:
            continue
        e_valid = int(state[f"{d}_e_valid"])
        off = np.asarray(state[f"{d}_offsets"], np.int32)
        cdst = np.asarray(state[f"{d}_dst"], np.int32)
        if (off.shape != (n + 1,) or int(off[0]) != 0
                or int(off[-1]) != e_valid or (np.diff(off) < 0).any()):
            raise ValueError(f"{d}: offsets must rise from 0 to e_valid"
                             " over num_nodes + 1 entries")
        if cdst.ndim != 1 or cdst.shape[0] < e_valid or (
                cdst.size and (cdst.min() < 0 or cdst.max() > n)):
            raise ValueError(f"{d}: dst must hold e_valid ids in"
                             " [0, num_nodes] (pads = num_nodes)")
        opt = {k: _tensor(state[f"{d}_{k}"], t, dev) if f"{d}_{k}" in state
               else None for k, t in (("src", np.int32), ("weights", np.float32))}
        c = DeviceCsr(_tensor(off, np.int32, dev), opt["src"],
                      _tensor(cdst, np.int32, dev), opt["weights"], e_valid,
                      int(state[f"{d}_max_deg"]))
        if d == "forward":
            g._fwd = c
        elif d == "reverse":
            g._rev = c
        else:
            g._both = c
    return g


def graph_cache_to_numpy(gc) -> dict:
    """The state of ``gc``, a ``GraphCache`` of either package, after its
    pending deltas are applied (see the module docstring)."""
    gc._ensure_fresh()
    lens = gc._block_lens
    return {
        "node_ids": _ids_array(gc.nodes.ids),
        "src": np.asarray(gc._src, np.int32),
        "dst": np.asarray(gc._dst, np.int32),
        "w": np.asarray(gc._w, np.float32),
        "weighted": bool(gc.weighted),
        "generation": int(gc.generation),
        "block_lens": None if lens is None else [int(x) for x in lens],
    }


def graph_cache_from_numpy(state: dict,
                           device: str | torch.device = "cuda") -> GraphCache:
    """The port's ``GraphCache`` of ``state`` (see the module docstring) on
    ``device``. Its block layout is kept, with no block dirty and no save
    directory: the first ``save`` writes every block."""
    gc = GraphCache(weighted=bool(state["weighted"]), device=device)
    src = np.array(state["src"], np.int32)
    dst = np.array(state["dst"], np.int32)
    w = np.array(state["w"], np.float32)
    ids = list(np.asarray(state["node_ids"]).tolist())
    n = len(ids)
    if len(src) != len(dst) or len(src) != len(w):
        raise ValueError("src, dst and w must have one length")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n):
        raise ValueError("an edge endpoint lies outside the node ids")
    lens = state.get("block_lens")
    if lens is not None and sum(lens) != len(src):
        raise ValueError("block_lens must sum to the edge count")
    gc.nodes._ids = ids
    gc.nodes._index = {u: i for i, u in enumerate(ids)}
    if len(gc.nodes._index) != n:
        raise ValueError("node_ids must be distinct")
    gc._src, gc._dst, gc._w = src, dst, w
    gc.generation = int(state["generation"])
    gc._block_lens = None if lens is None else [int(x) for x in lens]
    return gc
