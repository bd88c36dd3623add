"""Checkpoints, the PyTorch port of ``muninn_tpu/io/checkpoint.py``.

The same directory format as the JAX package (``FORMAT_VERSION = 1``): the
arrays in ``arrays.npz`` and the scalars in ``manifest.json``, beside the
index kind. A checkpoint written by either package loads in the other with
identical search results. Each kind goes through ``index/convert.py``,
whose states are exactly the fields written here; the flat kind writes its
store over the whole capacity, as ``save_flat`` does, and carries the
search-mode settings (the int8 and projection shadows are rebuilt at the
first search). ``save_hnsw`` wires the queued upper levels first.

Every ``load_*`` takes ``device``, the card unless ``device="cpu"``.
``DeltaLog`` is the append-only JSONL mutation log replayed after a load.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from muninn_tpu_torch.index.convert import (
    flat_index_from_numpy,
    hnsw_index_from_numpy,
    hnsw_index_to_numpy,
    ivf_index_from_numpy,
    ivf_index_to_numpy,
    quantized_index_from_numpy,
    quantized_index_to_numpy,
)

FORMAT_VERSION = 1


def _write_manifest(path: Path, kind: str, meta: dict) -> None:
    manifest = {"format_version": FORMAT_VERSION, "kind": kind, **meta}
    # atomic swap: a crash mid-write must not tear the one file every load
    # gates on (torn data files fail their zip CRCs instead)
    tmp = path / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, path / "manifest.json")


def _read_manifest(path: Path, kind: str) -> dict:
    m = json.loads((path / "manifest.json").read_text())
    if m.get("kind") != kind:
        raise ValueError(f"checkpoint at {path} is {m.get('kind')}, expected {kind}")
    if m.get("format_version") > FORMAT_VERSION:
        raise ValueError("checkpoint written by a newer format version")
    return m


def _save(path, kind: str, state: dict) -> None:
    """Write ``state``: its numpy arrays to ``arrays.npz``, the rest to the
    manifest."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
    np.savez(p / "arrays.npz", **arrays)
    meta = {k: v.item() if isinstance(v, np.generic) else v
            for k, v in state.items() if k not in arrays}
    _write_manifest(p, kind, meta)


def _load(path, kind: str) -> dict:
    """The manifest and the arrays of a checkpoint of ``kind`` as one state."""
    p = Path(path)
    m = _read_manifest(p, kind)
    with np.load(p / "arrays.npz") as z:
        return {**m, **{k: z[k] for k in z.files}}


# ───────────────────────── HNSW ─────────────────────────


def save_hnsw(index, path: str | os.PathLike) -> None:
    """Write an ``HnswIndex`` (store, level-0 and upper-level tables, levels,
    id map, parameters) to the directory ``path``."""
    _save(path, "hnsw", hnsw_index_to_numpy(index))


def load_hnsw(path: str | os.PathLike, device: str | torch.device = "cuda",
              reuse_slots: bool = True):
    """An ``HnswIndex`` on ``device`` from a checkpoint of either package;
    its searches return what the saved index's returned. ``reuse_slots``
    False keeps the JAX package's slot numbers through later writes."""
    return hnsw_index_from_numpy(_load(path, "hnsw"), device=device,
                                 reuse_slots=reuse_slots)


# ───────────────────────── Flat ─────────────────────────


def save_flat(index, path: str | os.PathLike) -> None:
    """Write a ``FlatIndex``: its store over the whole capacity and its
    search-mode settings."""
    st = index.store
    _save(path, "flat", {
        "vectors": st.vectors.cpu().numpy(),
        "valid": st.valid.cpu().numpy(),
        "ids": st._id_of.copy(),
        "dim": index.dim,
        "metric": index.metric.value,
        "high_watermark": st.high_watermark,
        "count": len(st),
        "precision": index.precision,
        "proj_dim": index.proj_dim,
        "rescore_r": index.rescore_r,
    })


def load_flat(path: str | os.PathLike, device: str | torch.device = "cuda"):
    """A ``FlatIndex`` on ``device`` from a checkpoint of either package,
    in the saved precision mode."""
    s = _load(path, "flat")
    ids = np.asarray(s["ids"], np.int64)
    hw, count = int(s["high_watermark"]), int(s["count"])
    if (not 0 <= hw <= ids.shape[0] or (ids[hw:] >= 0).any()
            or int((ids >= 0).sum()) != count):
        raise ValueError("ids must hold count ids, all below high_watermark")
    state = {
        "dim": s["dim"], "metric": s["metric"],
        "vectors": s["vectors"][:hw], "valid": s["valid"][:hw],
        "id_of": ids[:hw],
        "precision": s.get("precision", "highest"),
        "proj_dim": s.get("proj_dim", 128),
    }
    if "rescore_r" in s:
        state["rescore_r"] = s["rescore_r"]
    return flat_index_from_numpy(state, device=device)


def save_quantized(index, path: str | os.PathLike) -> None:
    """Write a ``QuantizedFlatIndex``: the int8 codes and per-row scales
    are the stored rows (no f32 copy exists)."""
    _save(path, "quantized", quantized_index_to_numpy(index))


def load_quantized(path: str | os.PathLike,
                   device: str | torch.device = "cuda"):
    return quantized_index_from_numpy(_load(path, "quantized"), device=device)


# ───────────────────────── IVF ─────────────────────────


def save_ivf(index, path: str | os.PathLike) -> None:
    """Write an ``IvfIndex``: store, centroids, blocks (bf16 as uint16
    bits, or int8 with their scales), membership and the pending region."""
    _save(path, "ivf", ivf_index_to_numpy(index))


def load_ivf(path: str | os.PathLike, device: str | torch.device = "cuda"):
    """An ``IvfIndex`` on ``device`` from a checkpoint of either package;
    its searches return what the saved index's returned."""
    return ivf_index_from_numpy(_load(path, "ivf"), device=device)


# ───────────────────────── Delta log ─────────────────────────


class DeltaLog:
    """Append-only JSONL mutation log (the ``_delta`` shadow table role).
    Each record: ``{"op": "insert" | "delete", ...payload}``. Replay bridges
    the gap between checkpoints."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, op: str, **payload) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"op": op, **payload}) + "\n")

    def append_many(self, records) -> None:
        """Append a batch of record dicts (each with "op") in one write."""
        with open(self.path, "a") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))

    def __len__(self) -> int:
        if not self.path.exists():
            return 0
        with open(self.path) as f:
            return sum(1 for _ in f)

    def replay(self):
        """Yield records in append order. A malformed final line is a torn
        append that was never acknowledged, and is skipped; a malformed line
        anywhere else is corruption, and raises."""
        if not self.path.exists():
            return
        with open(self.path) as f:
            lines = [ln.strip() for ln in f]
        lines = [ln for ln in lines if ln]
        for i, line in enumerate(lines):
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    return  # torn tail
                raise

    def clear(self) -> None:
        if self.path.exists():
            self.path.unlink()
