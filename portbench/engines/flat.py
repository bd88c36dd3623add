"""``FlatIndex`` as a traffic file names it: ``"engine": "flat"``, its
``precision`` and, for the rescored modes, ``rescore_r``."""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import FlatIndex


def build(p: dict, x: torch.Tensor, ids: np.ndarray, seed: int) -> FlatIndex:
    index = FlatIndex(p["dim"], p["metric"], capacity=p["rows"],
                      device=x.device, precision=p["precision"])
    if "rescore_r" in p:
        index.rescore_r = int(p["rescore_r"])
    index.insert(ids, x)
    return index


def search(index: FlatIndex, queries: np.ndarray, k: int, p: dict):
    """One request: numpy queries in, ``(ids int64, dists f32)`` numpy out."""
    return index.search(queries, k)
