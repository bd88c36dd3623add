"""``HnswIndex`` as a configuration's ``hnsw`` group builds it (bulk insert
into an empty index, levels drawn from the run's seed), searched with the
index's default engine at the group's ``ef_search``, or at the traffic
file's own ``ef_search`` where it gives one."""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import HnswIndex


def build(p: dict, x: torch.Tensor, ids: np.ndarray, seed: int) -> HnswIndex:
    h = p["hnsw"]
    index = HnswIndex(p["dim"], p["metric"], m=h["m"],
                      ef_construction=h["ef_construction"],
                      capacity=h["capacity"], seed=seed, expand=h["expand"],
                      wave_size=h["wave_size"], device=x.device)
    index.insert(ids, x)
    return index


def search(index: HnswIndex, queries: np.ndarray, k: int, p: dict):
    """One request: numpy queries in, ``(ids int64, dists f32)`` numpy out."""
    return index.search(queries, k,
                        ef_search=p.get("ef_search", p["hnsw"]["ef_search"]))
