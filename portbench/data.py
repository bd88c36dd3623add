"""The cells' data, made from the seed on the run's device.

The recipe is ``bench.py``'s (``gen``, ``bench.py:325-335``), as
``chip_smoke.py``'s ``clustered_on_device`` follows it with a
``torch.Generator``: Gaussian cluster centres, each row a centre plus
Gaussian noise, unit-normalised; each query a random row plus smaller noise,
re-normalised. Every seed makes the same sizes: only the values change.
"""

from __future__ import annotations

import numpy as np
import torch

ID_BASE = 1 << 40  # external ids are ID_BASE + a permutation of the rows


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def rows(gen: torch.Generator, cfg: dict, device: torch.device) -> torch.Tensor:
    """``cfg["rows"] x cfg["dim"]`` float32 unit rows about
    ``cfg["centres"]`` centres with ``cfg["noise"]`` noise, in three large
    calls on ``device``."""
    n, d = cfg["rows"], cfg["dim"]
    centres = torch.randn(cfg["centres"], d, generator=gen, device=device)
    x = centres[torch.randint(0, cfg["centres"], (n,), generator=gen,
                              device=device)]
    x += cfg["noise"] * torch.randn(n, d, generator=gen, device=device)
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    return x


def query_pool(gen: torch.Generator, x: torch.Tensor, cfg: dict,
               count: int, batch: int) -> list[np.ndarray]:
    """``count`` queries (rows of ``x`` plus ``cfg["query_noise"]`` noise,
    unit-normalised), downloaded once and cut into host batches of
    ``batch`` rows."""
    q = x[torch.randint(0, x.shape[0], (count,), generator=gen,
                        device=x.device)]
    q = q + cfg["query_noise"] * torch.randn(q.shape, generator=gen,
                                             device=x.device)
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    q = q.cpu().numpy()
    return [np.ascontiguousarray(q[s : s + batch])
            for s in range(0, count - batch + 1, batch)]


def external_ids(seed: int, n: int) -> np.ndarray:
    """The int64 id of each row, ``ID_BASE`` plus a seeded permutation, so
    that a slot never equals its id."""
    return ID_BASE + np.random.default_rng(int(seed)).permutation(n)


def rows_of(ids: np.ndarray, ext: np.ndarray) -> np.ndarray:
    """The row of each id in ``ids`` under ``ext`` (the distinct id of each
    row), -1 for an id that no row has."""
    ids = np.asarray(ids, np.int64)
    ext = np.asarray(ext, np.int64)
    if len(ext) == 0:
        return np.full(ids.shape, -1, np.int64)
    order = np.argsort(ext)
    srt = ext[order]
    pos = np.minimum(np.searchsorted(srt, ids), len(srt) - 1)
    return np.where(srt[pos] == ids, order[pos], -1)
