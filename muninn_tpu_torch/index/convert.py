"""Carry a flat index's state between ``muninn_tpu`` and this package.

Both directions take and give only numpy, so neither package imports the
other. ``state`` holds ``dim``, ``metric`` (the metric's name),
``vectors [hw, d]`` f32, ``valid [hw]`` bool and ``id_of [hw]`` int64 with
-1 on free slots, where ``hw`` is the store's high watermark. From a
``muninn_tpu`` ``FlatIndex`` these are ``np.asarray(store.vectors[:hw])``,
``np.asarray(store.valid[:hw])`` and ``store._id_of[:hw]``.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch.index.flat import FlatIndex


def flat_index_from_numpy(state: dict, device: str | torch.device = "cpu") -> FlatIndex:
    """Build a ``FlatIndex`` on ``device`` from ``state``. The slot map, the
    live count and the high watermark are rebuilt from ``id_of``."""
    id_of = np.asarray(state["id_of"], np.int64)
    valid = np.asarray(state["valid"], bool)
    if not np.array_equal(valid, id_of >= 0):
        raise ValueError("valid must be True exactly on the slots with an id")
    hw = id_of.shape[0]
    index = FlatIndex(int(state["dim"]), state["metric"],
                      capacity=max(hw, 1), device=device)
    index.store.restore(state["vectors"], id_of)
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
    }
