"""Steady churn on an ``HnswIndex`` table: each request deletes, upserts and
inserts rows, then searches a pool batch.

The index is built as ``engines/hnsw.py`` builds it. The traffic's
``churn`` group sets a request's writes: ``upserts`` distinct live ids drawn
by a Zipf law of constant ``zipf`` (YCSB's request distribution, 0.99 in its
workload A) over the live ids in the order of a seeded permutation, where
the built ids come first and new ids are appended, cold; ``deletes``
distinct live ids drawn uniformly from the rest; ``inserts`` new ids. One
``delete`` of the upserted and deleted ids, then one ``insert`` of the
upserted ids (fresh rows under the same ids) and the new ids, so that the
live count stays where the build left it; then one ``search`` of the pool's
batch at the table's ``ef_search``. Each request raises ``run.epoch`` before
its search; ``live_rows(run, state)`` replays the writes forward from the
seed. Every row written is made on the run's device by the table's own
recipe (one of its centres plus noise, unit rows), from the seed and the
write's number alone.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import HnswIndex
from portbench import data
from portbench.run import seeded_rows


def build(p: dict, x: torch.Tensor, ids: np.ndarray, seed: int) -> HnswIndex:
    h = p["hnsw"]
    index = HnswIndex(p["dim"], p["metric"], m=h["m"],
                      ef_construction=h["ef_construction"],
                      capacity=h["capacity"], seed=seed, expand=h["expand"],
                      wave_size=h["wave_size"], device=x.device)
    index.insert(ids, x)
    return index


def search(index: HnswIndex, queries: np.ndarray, k: int, p: dict):
    """One search: numpy queries in, ``(ids int64, dists f32)`` numpy out."""
    return index.search(queries, k, ef_search=p["hnsw"]["ef_search"])


class Churn:
    """A run's writes so far: the live ids in the Zipf law's order, the ids
    each write deleted and put, in order, and the law's weights."""

    def __init__(self, run):
        self.order = np.random.default_rng([run.seed, 9]).permutation(run.ids)
        self.log: list[tuple[np.ndarray, np.ndarray]] = []
        ranks = np.arange(1, len(self.order) + 1, dtype=np.float64)
        w = ranks ** -float(run.p["churn"]["zipf"])
        self.weights = w / w.sum()
        self.centres = torch.randn(run.p["centres"], run.p["dim"],
                                   generator=data.generator(run.seed, run.device),
                                   device=run.device)  # data.rows' first draw
        self.replayed = None  # (state, live rows, their ids)


def _churn(run) -> Churn:
    if getattr(run, "churn", None) is None:
        run.churn = Churn(run)
    return run.churn


def new_rows(run, w: int, n: int) -> torch.Tensor:
    """The ``n`` rows that write ``w`` puts, made again from the seed and
    ``w`` alone by the table's recipe, on the run's device."""
    c, p = _churn(run), run.p
    seed = np.random.default_rng([run.seed, 8, w]).integers(2**62)
    gen = data.generator(int(seed), run.device)
    x = c.centres[torch.randint(0, p["centres"], (n,), generator=gen,
                                device=run.device)]
    x += p["noise"] * torch.randn(n, p["dim"], generator=gen, device=run.device)
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    return x


def request(run, i: int):
    """Delete, upsert and insert, raise the state, search a pool batch.
    Returns ``(batch, ids, dists, rows written)``."""
    c, spec = _churn(run), run.p["churn"]
    w = len(c.log)
    rng = np.random.default_rng([run.seed, 7, w])
    n = len(c.order)
    up = rng.choice(n, spec["upserts"], replace=False, p=c.weights)
    rest = np.setdiff1d(np.arange(n), up, assume_unique=True)
    gone = rng.choice(rest, spec["deletes"], replace=False)
    new = (data.ID_BASE + run.p["rows"] + spec["inserts"] * w
           + np.arange(spec["inserts"], dtype=np.int64))
    dead = np.concatenate([c.order[up], c.order[gone]])
    put = np.concatenate([c.order[up], new])
    run.index.delete(dead)
    run.index.insert(put, new_rows(run, w, len(put)))
    c.order = np.concatenate([np.delete(c.order, gone), new])
    c.log.append((dead, put))
    run.epoch = len(c.log)
    b = i % len(run.pool)
    ids, dists = run.engine.search(run.index, run.pool[b], run.k, run.p)
    return b, ids, dists, len(dead) + len(put)


def live_rows(run, state: int | None = None):
    """The rows and ids live once the first ``state`` writes were made (all
    of them: None), replayed forward from the last state asked for, or from
    the seed's rows; one state's rows are kept."""
    c = _churn(run)
    state = len(c.log) if state is None else state
    at, x, ids = c.replayed or (0, None, None)
    if x is None or at > state:
        at, (x, ids) = 0, seeded_rows(run)
    c.replayed = None
    for w in range(at, state):
        dead, put = c.log[w]
        keep = ~np.isin(ids, dead)
        x = torch.cat([x[torch.from_numpy(keep).to(x.device)],
                       new_rows(run, w, len(put))])
        ids = np.concatenate([ids[keep], put])
    c.replayed = (state, x, ids)
    return x, ids
