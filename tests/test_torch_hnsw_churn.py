"""muninn_tpu_torch's HNSW churn path against muninn_tpu's on the CPU.

The same seeded numpy inputs go through both packages: insert waves after a
bulk build and into an empty index (``insert_mode`` "exact" and "beam",
``mn_ru`` on and off), deletes with repair, the deferred upper-level wiring,
the search routes without a promoted pool or with ``search_bf16 = False``,
the MN-RU prune on JAX's own tie case, and checkpoints
carried across in both directions. Both sides run with
``build_precision = "highest"`` (the port ranks ``default`` by bf16
operands on every device, JAX on the CPU in f32) and the same
``search_bf16``; JAX's Pallas kernels run in interpret mode, as its own
tests run them. Tables must match row by row: ids equal except where the
two ids are float64 ties of the row's own vector, distances within 1e-5
relative. Sizes are small (d = 16, m <= 6, waves of 64 rows).
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.index.hnsw import HnswIndex as JaxHnswIndex
from muninn_tpu.index.hnsw import _prune_rows as jax_prune_rows
from muninn_tpu.io.checkpoint import load_hnsw, save_hnsw
from muninn_tpu_torch import HnswIndex
from muninn_tpu_torch.index import hnsw as hnsw_mod
from muninn_tpu_torch.index.convert import hnsw_index_from_numpy, hnsw_index_to_numpy

D = 16
WAVE = 64


def _rows(seed, n):
    """Unit-norm Gaussian rows (embedding scale, where f32 distances carry
    about 1e-7 of rounding)."""
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(metric, m=6, mn_ru=True, mode="exact", seed=3, capacity=256):
    """A JAX and a port index with the same knobs, both at exact build
    precision and f32 search; the port never reuses a slot, as JAX does
    not, so that their tables match slot for slot."""
    j = JaxHnswIndex(D, metric, m=m, ef_construction=40, wave_size=WAVE,
                     capacity=capacity, seed=seed, mn_ru=mn_ru)
    t = HnswIndex(D, metric, m=m, ef_construction=40, wave_size=WAVE,
                  capacity=capacity, seed=seed, mn_ru=mn_ru, device="cpu",
                  reuse_slots=False)
    for idx in (j, t):
        idx.build_precision = "highest"
        idx.insert_mode = mode
        idx.search_bf16 = False
    return j, t


def _dist64(a, b, metric):
    a, b = a.astype(np.float64), b.astype(np.float64)
    dots = (a * b).sum(-1)
    if metric == "l2":
        return ((a - b) ** 2).sum(-1)
    if metric == "inner_product":
        return -dots
    return 1.0 - dots / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_ties(vecs, owners, jid, tid, metric):
    """Where the two packages chose other ids, both ids are float64 ties of
    their owner's vector (within 1e-6 relative)."""
    assert (jid >= 0).all() and (tid >= 0).all()
    dj = _dist64(vecs[owners], vecs[jid], metric)
    dt = _dist64(vecs[owners], vecs[tid], metric)
    assert np.all(np.abs(dj - dt) <= 1e-6 * (1 + np.abs(dj))), (owners, jid, tid)


def _assert_graph_matches(j, t, metric):
    """Levels, entry point, validity, hi_index and the level-0 tables."""
    np.testing.assert_array_equal(t.levels, j.levels)
    assert (t.entry_point, t.max_level, t._hi_count) == (
        j.entry_point, j.max_level, j._hi_count)
    assert len(t) == len(j) and t.store.high_watermark == j.store.high_watermark
    np.testing.assert_array_equal(t.store.valid.numpy(), np.asarray(j.store.valid))
    np.testing.assert_array_equal(t.hi_index.numpy(), np.asarray(j.hi_index))
    jn, jd = np.asarray(j.neighbors0), np.asarray(j.dists0)
    tn, td = t.neighbors0.numpy(), t.dists0.numpy()
    assert tn.shape == jn.shape and td.shape == jd.shape
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-6)
    r, c = np.nonzero(tn != jn)
    if len(r):
        _assert_ties(t.store.vectors.numpy(), r, jn[r, c], tn[r, c], metric)


def _assert_hi_matches(j, t, metric):
    """The upper-level tables, row by row up to float64 ties of the row
    owner's vector."""
    jh, th = np.asarray(j.hi_neighbors), t.hi_neighbors.numpy()
    assert th.shape == jh.shape
    np.testing.assert_array_equal(th < 0, jh < 0)
    h, lv, c = np.nonzero(th != jh)
    if len(h):
        hi = t.hi_index.numpy()
        owner = np.full(th.shape[0], -1)
        owner[hi[hi >= 0]] = np.nonzero(hi >= 0)[0]
        assert (owner[h] >= 0).all()
        _assert_ties(t.store.vectors.numpy(), owner[h], jh[h, lv, c], th[h, lv, c],
                     metric)


def _both(j, t, fn):
    fn(j)
    fn(t)


def _assert_queue_matches(j, t):
    """The port's queued promotions, in queue order, equal JAX's queued
    waves one after another; returns the port's queued slots."""
    ts, tl = t._queued_promotions()
    js = np.concatenate([np.asarray(sl) for sl, _ in j._hi_pending] or [[]])
    jl = np.concatenate([np.asarray(lv) for _, lv in j._hi_pending] or [[]])
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tl, jl)
    return ts


@pytest.mark.parametrize("metric,mn_ru", [("l2", True), ("l2", False),
                                          ("cosine", True), ("inner_product", False)])
def test_bulk_then_exact_waves_match_jax(metric, mn_ru):
    """A bulk build, then two exact waves (one insert of two waves): the
    tables equal JAX's, and so do the upper levels once the queued
    promotions are flushed."""
    x = _rows(1, 430)
    j, t = _pair(metric, mn_ru=mn_ru)
    _both(j, t, lambda idx: idx.insert(np.arange(300), x[:300]))
    _both(j, t, lambda idx: idx.insert(np.arange(300, 428), x[300:428]))
    assert len(_assert_queue_matches(j, t))
    _assert_graph_matches(j, t, metric)
    _both(j, t, lambda idx: idx._flush_hi_wiring())
    assert not len(_assert_queue_matches(j, t))
    np.testing.assert_array_equal(t.hi_index.numpy(), np.asarray(j.hi_index))
    _assert_hi_matches(j, t, metric)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_beam_waves_match_jax(metric):
    """``insert_mode = "beam"``: waves into an empty index (the first one
    has no candidate but its own rows, the rest route from the pool and
    search at ef_construction) match JAX's tables, then its upper levels."""
    x = _rows(2, 330)
    j, t = _pair(metric, mode="beam")
    _both(j, t, lambda idx: idx.insert(np.arange(200), x[:200]))
    _both(j, t, lambda idx: idx.insert(np.arange(200, 330), x[200:]))
    _assert_graph_matches(j, t, metric)
    _both(j, t, lambda idx: idx._flush_hi_wiring())
    _assert_hi_matches(j, t, metric)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_delete_matches_jax(metric):
    """Deletes after waves, one of them holding the entry point and a
    promotion still queued, one larger than wave_size: the tables,
    validity, queue and rescanned entry point equal JAX's; then a wave
    after the deletes and the flush."""
    x = _rows(3, 480)
    j, t = _pair(metric, m=4)
    _both(j, t, lambda idx: idx.insert(np.arange(200), x[:200]))
    _both(j, t, lambda idx: idx.insert(np.arange(200, 400), x[200:400]))
    pending = _assert_queue_matches(j, t)
    ep = t.entry_point
    dead = t.store.ids_of(np.unique(np.concatenate(
        [[ep, pending[0]], np.arange(3, 400, 11)])))
    _both(j, t, lambda idx: idx.delete(dead))
    assert t.entry_point != ep and t.levels[ep] == -1
    assert pending[0] not in _assert_queue_matches(j, t)
    _assert_graph_matches(j, t, metric)
    more = np.setdiff1d(np.arange(100, 180), dead)
    assert len(more) > WAVE  # two delete waves
    _both(j, t, lambda idx: idx.delete(more))
    _both(j, t, lambda idx: idx.insert(np.arange(400, 480), x[400:]))
    _assert_graph_matches(j, t, metric)
    _both(j, t, lambda idx: idx._flush_hi_wiring())
    _assert_hi_matches(j, t, metric)
    live = np.nonzero(t.store.valid.numpy())[0]
    rows = t.neighbors0.numpy()[live]
    assert not ((rows >= 0) & ~t.store.valid.numpy()[np.maximum(rows, 0)]).any()


def _churned(metric, seed=4):
    x = _rows(seed, 560)
    j, t = _pair(metric)
    _both(j, t, lambda idx: idx.insert(np.arange(300), x[:300]))
    _both(j, t, lambda idx: idx.insert(np.arange(300, 460), x[300:460]))
    _both(j, t, lambda idx: idx.delete(np.arange(0, 460, 5)))
    _both(j, t, lambda idx: idx.insert(np.arange(460, 560), x[460:]))
    for idx in (j, t):
        idx.exact_small_n = 0
    q = x[np.arange(1, 560, 9)] + 0.05 * np.random.default_rng(seed).standard_normal(
        (63, D)).astype(np.float32)
    return j, t, q


def _assert_same_search(j, t, q, k=5, ef=24):
    jid, jd = j.search(q, k=k, ef_search=ef)
    tid, td = t.search(q, k=k, ef_search=ef)
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5, atol=1e-6)
    return tid


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_search_after_churn_matches_jax(metric):
    """After waves and deletes: the f32 route (``search_bf16 = False``,
    exact routing and an f32 beam) returns JAX's ids and distances; so does
    a graph whose promoted nodes all died (no pool: the entry point seeds
    the beam), with bf16 guidance and without. No deleted id comes back."""
    j, t, q = _churned(metric)
    assert t.tables.pool() is not None
    ids = _assert_same_search(j, t, q)
    assert not np.isin(ids, np.arange(0, 460, 5)).any()
    promoted = np.nonzero(t.levels >= 1)[0]
    _both(j, t, lambda idx: idx.delete(t.store.ids_of(promoted)))
    assert t.tables.pool() is None and t.entry_point >= 0
    assert t.entry_point == j.entry_point
    for bf16 in (False, True):
        j.search_bf16 = t.search_bf16 = bf16
        ids = _assert_same_search(j, t, q)
        assert (ids >= 0).all() and not np.isin(ids, t.store.ids_of(promoted)).any()


def test_prune_rows_mn_ru_tiebreak_matches_jax():
    """JAX's hand-built tie case (``tests/test_hnsw.py:106-146``): among
    equidistant candidates the MN-RU prune keeps the one sharing more
    neighbours with the candidate list; without the tiebreak the closest
    stays first. Both packages give the same rows."""
    cap, m_max = 8, 2
    nb = np.full((cap, m_max), -1, np.int32)
    dd = np.full((cap, m_max), np.inf, np.float32)
    nb[0], dd[0] = [1, 2], [0.5, 1.0]
    nb[3], nb[2], nb[4] = [1, 2], [6, 7], [6, 7]
    ai = np.full((cap, m_max), -1, np.int32)
    ad = np.full((cap, m_max), np.inf, np.float32)
    ai[0], ad[0] = [3, 4], [1.0, 1.0]
    for mn in (True, False):
        jn, jd = jax_prune_rows(jnp.asarray(nb), jnp.asarray(dd), jnp.asarray(ai),
                                jnp.asarray(ad), jnp.asarray([0], jnp.int32), m_max,
                                mn_tiebreak=mn)
        tn, td = torch.from_numpy(nb.copy()), torch.from_numpy(dd.copy())
        hnsw_mod._prune_rows(tn, td, torch.from_numpy(ai), torch.from_numpy(ad),
                             torch.tensor([0]), m_max, mn_tiebreak=mn)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert tn[0, 0] == 1
        if mn:
            assert tn[0, 1] == 3  # the mutual-rich tie


def test_mn_ru_prune_reads_the_table_before_any_chunk_wrote(monkeypatch):
    """A prune in chunks of one row equals the prune in one chunk: every
    chunk counts mutual neighbours in the table as it stood before the
    prune (here row 3, a neighbour of row 0, is pruned first)."""
    rng = np.random.default_rng(9)
    cap, m0 = 40, 6
    nb = torch.from_numpy(rng.integers(-1, cap, (cap, m0)).astype(np.int32))
    dd = torch.from_numpy(rng.integers(1, 4, (cap, m0)).astype(np.float32))  # ties
    dd, order = torch.sort(torch.where(nb >= 0, dd, torch.inf), dim=1, stable=True)
    nb = torch.gather(nb, 1, order)
    ai = torch.from_numpy(rng.integers(-1, cap, (cap, m0)).astype(np.int32))
    ad = torch.from_numpy(rng.integers(1, 4, (cap, m0)).astype(np.float32))
    ad = torch.where(ai >= 0, ad, torch.inf)
    aff = torch.tensor([3, 0, 7, 12, 25])
    whole = (nb.clone(), dd.clone())
    hnsw_mod._prune_rows(*whole, ai, ad, aff, m0, mn_tiebreak=True)
    monkeypatch.setattr(hnsw_mod, "_PRUNE_ROWS", 1)
    chunked = (nb.clone(), dd.clone())
    hnsw_mod._prune_rows(*chunked, ai, ad, aff, m0, mn_tiebreak=True)
    assert torch.equal(chunked[0], whole[0]) and torch.equal(chunked[1], whole[1])
    _, jd = jax_prune_rows(jnp.asarray(nb.numpy()), jnp.asarray(dd.numpy()),
                            jnp.asarray(ai.numpy()), jnp.asarray(ad.numpy()),
                            jnp.asarray(aff.numpy(), jnp.int32), m0, mn_tiebreak=True)
    # JAX breaks exact (distance, count) ties in its own order, so only the
    # kept distances are compared
    np.testing.assert_array_equal(whole[1].numpy(), np.asarray(jd))


def _carry(j, path):
    save_hnsw(j, path)
    state = dict(np.load(path / "arrays.npz"))
    state.update(json.loads((path / "manifest.json").read_text()))
    return state


def test_checkpoints_after_waves_cross_both_ways(tmp_path):
    """A JAX index after waves goes through ``save_hnsw`` into the port, and
    a port index after waves through ``hnsw_index_to_numpy`` (which flushes
    its queued promotions) into JAX's ``load_hnsw``: each pair searches
    alike."""
    x = _rows(8, 420)
    q = x[:30] + 0.05 * np.random.default_rng(8).standard_normal((30, D)).astype(np.float32)
    j, t = _pair("cosine")
    _both(j, t, lambda idx: idx.insert(np.arange(300), x[:300]))
    _both(j, t, lambda idx: idx.insert(np.arange(300, 420), x[300:]))

    assert len(_assert_queue_matches(j, t))  # before save_hnsw flushes j's
    tj = hnsw_index_from_numpy(_carry(j, tmp_path / "jax"), device="cpu")
    state = hnsw_index_to_numpy(t)
    assert not len(t._queued_promotions()[0])
    out = tmp_path / "port"
    out.mkdir()
    np.savez(out / "arrays.npz", **{k: state[k] for k in (
        "vectors", "valid", "ids", "levels", "neighbors0", "dists0", "hi_index",
        "hi_neighbors")})
    meta = {k: state[k] for k in ("dim", "metric", "m", "ef_construction",
                                  "entry_point", "max_level", "hi_count",
                                  "high_watermark", "count")}
    (out / "manifest.json").write_text(json.dumps(
        {"format_version": 1, "kind": "hnsw", **meta}))
    jt = load_hnsw(out)
    _assert_hi_matches(j, t, "cosine")  # j was flushed by save_hnsw
    for a, b in ((j, tj), (jt, t)):
        for idx in (a, b):
            idx.exact_small_n = 0
            idx.search_bf16 = False
        _assert_same_search(a, b, q)
