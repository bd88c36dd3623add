"""Carry an index's state between ``muninn_tpu`` and this package.

Both directions take and give only numpy, so neither package imports the
other.

Flat: ``state`` holds ``dim``, ``metric`` (the metric's name),
``vectors [hw, d]`` f32, ``valid [hw]`` bool and ``id_of [hw]`` int64 with
-1 on free slots, where ``hw`` is the store's high watermark. From a
``muninn_tpu`` ``FlatIndex`` these are ``np.asarray(store.vectors[:hw])``,
``np.asarray(store.valid[:hw])`` and ``store._id_of[:hw]``. Optional:
``precision``, ``rescore_r`` and ``proj_dim`` (the search-mode settings
``save_flat`` writes), and ``proj [d, dp]`` f32, the basis of a built
``proj_rescored`` shadow (``index._proj[0]`` in ``muninn_tpu``).

Quantized flat: exactly the fields ``muninn_tpu.io.checkpoint.
save_quantized`` writes, over the store's whole capacity ``cap``:
``codes [cap, d]`` int8, ``scales [cap]`` f32, ``valid [cap]`` bool,
``ids [cap]`` int64 (-1 on free slots); scalars ``dim``, ``metric``,
``high_watermark``, ``count``.

HNSW: exactly the fields ``muninn_tpu.io.checkpoint.save_hnsw`` writes, so
a JAX checkpoint's ``arrays.npz`` and ``manifest.json`` together are a
state. Arrays, over the store's whole capacity ``cap``:
``vectors [cap, d]`` f32, ``valid [cap]`` bool, ``ids [cap]`` int64 (-1 on
free slots), ``levels [cap]`` int32 (-1 on free slots), ``neighbors0
[cap, 2m]`` int32, ``dists0 [cap, 2m]`` f32, ``hi_index [cap]`` int32,
``hi_neighbors [cap_hi, 8, m]`` int32. Scalars: ``dim``, ``metric``, ``m``,
``ef_construction``, ``entry_point``, ``max_level``, ``hi_count``,
``high_watermark``, ``count``.

IVF: exactly the fields ``muninn_tpu.io.checkpoint.save_ivf`` writes. Arrays
over the store's capacity ``cap``: ``vectors [cap, d]`` f32, or for a bf16
store ``vectors_u16 [cap, d]`` uint16 (the bf16 bit patterns: numpy has no
bf16), ``valid [cap]`` bool, ``ids [cap]`` int64 (-1 on free slots), and
``pending [P]`` int64 (slots in no cluster). A built index also carries
``centroids [ncl, d]`` f32, ``member_slots [ncl_pad, S]`` int32 (-1 on free
slots), ``fill [ncl]`` int64 and its blocks: ``blocks_u16 [ncl_pad, S, d]``
uint16 (bf16 bits), or ``blocks_i8 [ncl_pad, S, d]`` int8 with
``block_scales [ncl_pad, S]`` f32. Scalars: ``dim``, ``metric``,
``cluster_size``, ``nprobe``, ``rescore_r``, ``slack``, ``kmeans_iters``,
``assign_rounds``, ``train_sample``, ``seed``, ``quant``, ``built``,
``high_watermark``, ``count``.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.index.flat import FlatIndex, QuantizedFlatIndex
from muninn_tpu_torch.index.hnsw import HnswIndex
from muninn_tpu_torch.index.ivf import IvfIndex

_HNSW_ARRAYS = {
    "vectors": np.float32, "valid": bool, "ids": np.int64,
    "levels": np.int32, "neighbors0": np.int32, "dists0": np.float32,
    "hi_index": np.int32, "hi_neighbors": np.int32,
}
_HNSW_SCALARS = ("dim", "m", "ef_construction", "entry_point", "max_level",
                 "hi_count", "high_watermark", "count")


def _check_valid(valid: np.ndarray, ids: np.ndarray) -> None:
    if not np.array_equal(valid, ids >= 0):
        raise ValueError("valid must be True exactly on the slots with an id")


def _restore_store(store, vectors: torch.Tensor, valid: np.ndarray,
                   ids: np.ndarray, hw: int, count: int) -> None:
    """Install whole-capacity arrays and rebuild the slot map from ``ids``,
    after checking that they agree with ``hw`` and ``count``."""
    cap = vectors.shape[0]
    if valid.shape != (cap,) or ids.shape != (cap,):
        raise ValueError(
            f"valid {valid.shape} and ids {ids.shape} do not fit {cap} rows")
    _check_valid(valid, ids)
    live = np.flatnonzero(ids >= 0)
    if len(live) != count or len(np.unique(ids[live])) != len(live):
        raise ValueError("ids must hold count distinct ids")
    if not 0 <= hw <= cap or (len(live) and live[-1] >= hw):
        raise ValueError("high_watermark must lie above every live slot")
    dev = store.device
    store.vectors = vectors.to(dev)
    store.valid = torch.tensor(valid, device=dev)
    store._id_of = ids.copy()
    store._slot_of = dict(zip(ids[live].tolist(), live.tolist()))
    store._count = count
    store._high = hw
    store.reset_free()


def flat_index_from_numpy(state: dict,
                          device: str | torch.device = "cuda") -> FlatIndex:
    """Build a ``FlatIndex`` on ``device`` from ``state``. The slot map, the
    live count and the high watermark are rebuilt from ``id_of``; a carried
    ``proj`` basis builds the ``proj_rescored`` shadow."""
    id_of = np.asarray(state["id_of"], np.int64)
    _check_valid(np.asarray(state["valid"], bool), id_of)
    hw = id_of.shape[0]
    index = FlatIndex(int(state["dim"]), state["metric"],
                      capacity=max(hw, 1), device=device,
                      precision=str(state.get("precision", "highest")),
                      proj_dim=int(state.get("proj_dim", 128)))
    if "rescore_r" in state:
        index.rescore_r = int(state["rescore_r"])
    index.store.restore(state["vectors"], id_of)
    if state.get("proj") is not None:
        index.set_proj_basis(np.asarray(state["proj"], np.float32))
    return index


def flat_index_to_numpy(index: FlatIndex) -> dict:
    """The state of ``index`` as numpy arrays (see the module docstring)."""
    hw = index.store.high_watermark
    return {
        "dim": index.dim,
        "metric": index.metric.value,
        "vectors": index.store.vectors[:hw].cpu().numpy().copy(),
        "valid": index.store.valid[:hw].cpu().numpy().copy(),
        "id_of": index.store._id_of[:hw].copy(),
        "precision": index.precision,
        "rescore_r": index.rescore_r,
        "proj_dim": index.proj_dim,
        "proj": (None if index._proj is None
                 else index._proj[0].cpu().numpy().copy()),
    }


def quantized_index_from_numpy(
    state: dict, device: str | torch.device = "cuda"
) -> QuantizedFlatIndex:
    """Build a ``QuantizedFlatIndex`` on ``device`` from ``state`` (see the
    module docstring). Its capacity is that of ``state``; the slot map is
    rebuilt from ``ids``."""
    codes = np.asarray(state["codes"], np.int8)
    scales = np.asarray(state["scales"], np.float32)
    ids = np.asarray(state["ids"], np.int64)
    cap, dim = codes.shape[0], int(state["dim"])
    hw, count = int(state["high_watermark"]), int(state["count"])
    if codes.shape != (cap, dim) or scales.shape != (cap,) or ids.shape != (cap,):
        raise ValueError(
            f"codes {codes.shape}, scales {scales.shape} and ids {ids.shape}"
            f" do not fit dim {dim}"
        )
    _check_valid(np.asarray(state["valid"], bool), ids)
    if (ids[hw:] >= 0).any() or int((ids >= 0).sum()) != count:
        raise ValueError("ids must hold count ids, all below high_watermark")
    index = QuantizedFlatIndex(dim, str(state["metric"]), capacity=cap,
                               device=device)
    index.store.restore(codes[:hw], ids[:hw], scales=scales[:hw])
    return index


def quantized_index_to_numpy(index: QuantizedFlatIndex) -> dict:
    """The state of ``index`` as ``save_quantized`` writes it (see the
    module docstring)."""
    st = index.store
    return {
        "codes": st.vectors.cpu().numpy().copy(),
        "scales": st.scales.cpu().numpy().copy(),
        "valid": st.valid.cpu().numpy().copy(),
        "ids": st._id_of.copy(),
        "dim": index.dim,
        "metric": index.metric.value,
        "high_watermark": st.high_watermark,
        "count": len(st),
    }


def hnsw_index_from_numpy(state: dict, device: str | torch.device = "cuda",
                          reuse_slots: bool = True) -> HnswIndex:
    """Build an ``HnswIndex`` on ``device`` from ``state`` (see the module
    docstring). Its capacity is that of ``state``; the slot map is rebuilt
    from ``ids``, and with ``reuse_slots`` (``HnswIndex``'s knob) the free
    slots and upper-level rows from ``ids`` and ``hi_index``. The packed
    neighbour table is built as after a bulk build: at the first search on
    a CUDA device."""
    a = {k: np.asarray(state[k], t) for k, t in _HNSW_ARRAYS.items()}
    sc = {k: int(state[k]) for k in _HNSW_SCALARS}
    cap, dim, m = a["vectors"].shape[0], sc["dim"], sc["m"]
    want = {"vectors": (cap, dim), "valid": (cap,), "ids": (cap,),
            "levels": (cap,), "neighbors0": (cap, 2 * m),
            "dists0": (cap, 2 * m), "hi_index": (cap,)}
    for k, shape in want.items():
        if a[k].shape != shape:
            raise ValueError(f"{k} has shape {a[k].shape}, want {shape}")
    hn = a["hi_neighbors"]
    if hn.ndim != 3 or hn.shape[2] != m:
        raise ValueError(f"hi_neighbors has shape {hn.shape}, want (*, *, {m})")
    # an out-of-range gather is a device-side assert on CUDA: refuse here
    if not ((a["neighbors0"] >= -1) & (a["neighbors0"] < cap)).all():
        raise ValueError("neighbors0 holds a slot outside the store")
    if not ((a["hi_index"] >= -1) & (a["hi_index"] < hn.shape[0])).all():
        raise ValueError("hi_index points outside hi_neighbors")
    if not ((hn >= -1) & (hn < cap)).all():
        raise ValueError("hi_neighbors holds a slot outside the store")

    index = HnswIndex(dim, str(state["metric"]), m=m,
                      ef_construction=sc["ef_construction"], capacity=cap,
                      device=device, reuse_slots=reuse_slots)
    dev = index.device
    _restore_store(index.store, torch.tensor(a["vectors"]), a["valid"],
                   a["ids"], sc["high_watermark"], sc["count"])
    index.levels = a["levels"].copy()
    index.neighbors0 = torch.tensor(a["neighbors0"], device=dev)
    index.dists0 = torch.tensor(a["dists0"], device=dev)
    index.hi_index = torch.tensor(a["hi_index"], device=dev)
    index._hi_index_np = a["hi_index"].copy()
    index.hi_neighbors = torch.tensor(hn, device=dev)
    index._hi_count = sc["hi_count"]
    index._reset_hi_free()
    index.entry_point = sc["entry_point"]
    index.max_level = sc["max_level"]
    return index


def hnsw_index_to_numpy(index: HnswIndex) -> dict:
    """The state of ``index`` as numpy arrays and Python scalars (see the
    module docstring). Queued upper-level wiring is flushed first, as
    ``save_hnsw`` flushes it (``checkpoint.py:54``)."""
    index._flush_hi_wiring()
    st = index.store
    return {
        "vectors": st.vectors.cpu().numpy().copy(),
        "valid": st.valid.cpu().numpy().copy(),
        "ids": st._id_of.copy(),
        "levels": index.levels.copy(),
        "neighbors0": index.neighbors0.cpu().numpy().copy(),
        "dists0": index.dists0.cpu().numpy().copy(),
        "hi_index": index.hi_index.cpu().numpy().copy(),
        "hi_neighbors": index.hi_neighbors.cpu().numpy().copy(),
        "dim": index.dim,
        "metric": index.metric.value,
        "m": index.m,
        "ef_construction": index.ef_construction,
        "entry_point": index.entry_point,
        "max_level": index.max_level,
        "hi_count": index._hi_count,
        "high_watermark": st.high_watermark,
        "count": len(st),
    }


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bit patterns as uint16 numpy."""
    return t.cpu().view(torch.int16).numpy().view(np.uint16).copy()


def _from_bf16_bits(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint16).view(np.int16)
    ).view(torch.bfloat16).to(dev)


def ivf_index_from_numpy(state: dict,
                         device: str | torch.device = "cuda") -> IvfIndex:
    """Build an ``IvfIndex`` on ``device`` from ``state`` (see the module
    docstring). Its capacity is that of ``state``; every array is checked
    against the others and the scalars, so that no slot points outside the
    store."""
    bf16_store = "vectors_u16" in state
    vectors = np.asarray(state["vectors_u16" if bf16_store else "vectors"])
    dim, s = int(state["dim"]), int(state["cluster_size"])
    quant = str(state.get("quant", "bf16"))
    if vectors.ndim != 2 or vectors.shape[1] != dim:
        raise ValueError(f"vectors have shape {vectors.shape}, want (*, {dim})")
    cap = vectors.shape[0]
    index = IvfIndex(
        dim, str(state["metric"]), cluster_size=s,
        nprobe=int(state["nprobe"]), rescore_r=int(state["rescore_r"]),
        slack=float(state["slack"]), kmeans_iters=int(state["kmeans_iters"]),
        assign_rounds=int(state.get("assign_rounds", 2)),
        train_sample=int(state["train_sample"]), seed=int(state["seed"]),
        capacity=cap, quant=quant,
        store_dtype=torch.bfloat16 if bf16_store else torch.float32,
        device=device,
    )
    dev = index.device
    _restore_store(
        index.store,
        (_from_bf16_bits(vectors, dev) if bf16_store
         else torch.tensor(np.asarray(vectors, np.float32))),
        np.asarray(state["valid"], bool), np.asarray(state["ids"], np.int64),
        int(state["high_watermark"]), int(state["count"]))
    pending = np.asarray(state["pending"], np.int64)
    if pending.ndim != 1 or not ((pending >= 0) & (pending < cap)).all():
        raise ValueError("pending holds a slot outside the store")
    if bool(state["built"]):
        cent = np.asarray(state["centroids"], np.float32)
        ms = np.asarray(state["member_slots"], np.int32)
        fill = np.asarray(state["fill"], np.int64)
        blocks = np.asarray(state["blocks_i8" if quant == "int8"
                                  else "blocks_u16"])
        ncl, ncl_pad = cent.shape[0], ms.shape[0]
        if (cent.shape != (ncl, dim) or ncl < 1 or ms.shape != (ncl_pad, s)
                or ncl_pad < ncl or blocks.shape != (ncl_pad, s, dim)
                or fill.shape != (ncl,)):
            raise ValueError(
                f"centroids {cent.shape}, member_slots {ms.shape}, blocks"
                f" {blocks.shape} and fill {fill.shape} do not fit"
                f" cluster_size {s} and dim {dim}")
        if not ((ms >= -1) & (ms < cap)).all():
            raise ValueError("member_slots holds a slot outside the store")
        if not np.array_equal(fill, (ms[:ncl] >= 0).sum(axis=1)) or (
                ms[ncl:] >= 0).any():
            raise ValueError("fill disagrees with member_slots")
        index.centroids = torch.tensor(cent, device=dev)
        index.member_slots = torch.tensor(ms, device=dev)
        index._fill = fill.copy()
        if quant == "int8":
            scales = np.asarray(state["block_scales"], np.float32)
            if scales.shape != (ncl_pad, s):
                raise ValueError(
                    f"block_scales have shape {scales.shape}, want"
                    f" {(ncl_pad, s)}")
            index.blocks = torch.tensor(np.asarray(blocks, np.int8), device=dev)
            index.block_scales = torch.tensor(scales, device=dev)
        else:
            index.blocks = _from_bf16_bits(blocks, dev)
    index._pending = [pending.astype(np.int32)] if pending.size else []
    index._pending_count = int(pending.size)
    return index


def ivf_index_to_numpy(index: IvfIndex) -> dict:
    """The state of ``index`` as ``save_ivf`` writes it (see the module
    docstring)."""
    st = index.store
    built = index.centroids is not None
    state = (
        {"vectors_u16": _bf16_bits(st.vectors)}
        if st.vectors.dtype == torch.bfloat16
        else {"vectors": st.vectors.cpu().numpy().copy()}
    )
    state.update({
        "valid": st.valid.cpu().numpy().copy(),
        "ids": st._id_of.copy(),
        "pending": index._pending_slots().astype(np.int64),
    })
    if built:
        state["centroids"] = index.centroids.cpu().numpy().copy()
        if index.quant == "int8":
            state["blocks_i8"] = index.blocks.cpu().numpy().copy()
            state["block_scales"] = index.block_scales.cpu().numpy().copy()
        else:
            state["blocks_u16"] = _bf16_bits(index.blocks)
        state["member_slots"] = index.member_slots.cpu().numpy().copy()
        state["fill"] = index._fill.copy()
    state.update({
        "dim": index.dim,
        "metric": index.metric.value,
        "cluster_size": index.cluster_size,
        "nprobe": index.nprobe,
        "rescore_r": index.rescore_r,
        "slack": index.slack,
        "kmeans_iters": index.kmeans_iters,
        "assign_rounds": index.assign_rounds,
        "train_sample": index.train_sample,
        "seed": index.seed,
        "quant": index.quant,
        "built": built,
        "high_watermark": st.high_watermark,
        "count": len(st),
    })
    return state
