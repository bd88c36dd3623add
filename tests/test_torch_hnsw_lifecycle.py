"""The HNSW lifecycle tests of ``tests/test_hnsw.py`` on muninn_tpu_torch's
``HnswIndex`` on the CPU: insert waves, delete and repair, entry-point
rescans, recall against the exact ``FlatIndex`` after churn, seeded
determinism, and the full lifecycle down to an empty index and back
(``tests/test_hnsw.py:48-104``, ``:148-197``, ``:668-753``). Each keeps the
reference test's sizes, knobs and floors.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest

from muninn_tpu_torch import FlatIndex, HnswIndex


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def build_index(rng, n=600, dim=24, metric="l2", m=8, efc=60, wave=200, seed=7):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    idx = HnswIndex(dim, metric, m=m, ef_construction=efc, wave_size=wave,
                    seed=seed, device="cpu")
    idx.insert(np.arange(n), vecs)
    return idx, vecs


def _flat(dim, ids, vecs, capacity=1024):
    flat = FlatIndex(dim, "l2", capacity=capacity, device="cpu")
    flat.insert(ids, vecs)
    return flat


def recall_at_k(idx, flat, queries, k=10, ef=None):
    got_ids, _ = idx.search(queries, k=k, ef_search=ef)
    true_ids, _ = flat.search(queries, k=k)
    hits = sum(len(set(g[g >= 0]) & set(t[t >= 0])) for g, t in zip(got_ids, true_ids))
    return hits / (len(queries) * k)


def _no_stale_edges(idx):
    valid = idx.store.valid.numpy()
    rows = idx.neighbors0.numpy()[np.nonzero(valid)[0]]
    return not ((rows >= 0) & ~valid[np.maximum(rows, 0)]).any()


def test_delete_removes_from_results(rng):
    idx, vecs = build_index(rng, n=300)
    ids, _ = idx.search(vecs[50], k=5, ef_search=32)
    assert ids[0] == 50
    idx.delete([50])
    ids2, _ = idx.search(vecs[50], k=5, ef_search=32)
    assert 50 not in ids2
    assert len(idx) == 299


def test_delete_entry_point_rescans(rng):
    idx, vecs = build_index(rng, n=200)
    ep_slot = idx.entry_point
    idx.delete([int(idx.store.ids_of([ep_slot])[0])])
    assert idx.entry_point != ep_slot and idx.entry_point >= 0
    assert idx.max_level == int(idx.levels[idx.entry_point])
    ids, _ = idx.search(vecs[3], k=1, ef_search=32)
    assert ids[0] == 3


@pytest.mark.parametrize("exact_small_n", [8192, 0])
def test_recall_after_delete_wave(rng, exact_small_n):
    """Also with the graph search at this size (``exact_small_n = 0``)."""
    idx, vecs = build_index(rng, n=500)
    idx.exact_small_n = exact_small_n
    dead = np.arange(0, 100)
    idx.delete(dead)
    flat = _flat(24, np.arange(100, 500), vecs[100:])
    queries = rng.standard_normal((30, 24)).astype(np.float32)
    assert recall_at_k(idx, flat, queries, k=10, ef=64) >= 0.85
    ids, _ = idx.search(queries, k=10, ef_search=64)
    assert not np.isin(ids[ids >= 0], dead).any()
    assert _no_stale_edges(idx)


def test_no_edges_to_tombstones_after_churn(rng):
    """Delete repair scrubs every stale edge, and inserts after a delete
    never select a deleted slot (src/hnsw_algo.c:408-410); nor do the
    upper levels, before or after the queued promotions are wired."""
    idx, _ = build_index(rng, n=600, wave=128)
    idx.delete(np.arange(0, 200))
    idx.insert(np.arange(1000, 1100), rng.standard_normal((100, 24)).astype(np.float32))
    assert _no_stale_edges(idx)
    valid = idx.store.valid.numpy()
    for flush in (False, True):
        if flush:
            idx._flush_hi_wiring()
        hi = idx.hi_neighbors.numpy()
        assert not ((hi >= 0) & ~valid[np.maximum(hi, 0)]).any()


def test_incremental_insert_keeps_recall(rng):
    dim = 24
    vecs = rng.standard_normal((600, dim)).astype(np.float32)
    idx = HnswIndex(dim, "l2", m=8, ef_construction=60, wave_size=100, seed=3,
                    device="cpu")
    for s in range(0, 600, 150):
        idx.insert(np.arange(s, s + 150), vecs[s : s + 150])
    idx.exact_small_n = 0  # the graph, not the exact fallback
    flat = _flat(dim, np.arange(600), vecs)
    queries = rng.standard_normal((40, dim)).astype(np.float32)
    assert recall_at_k(idx, flat, queries, k=10, ef=64) >= 0.90


@pytest.mark.parametrize("insert_mode", ["exact", "beam"])
def test_insert_modes_keep_recall(rng, insert_mode):
    """Both wave candidate sources (``insert_mode``), searched through the
    graph: recall@10 at least 0.9 on clustered rows."""
    dim, n = 24, 900
    centres = rng.standard_normal((12, dim)).astype(np.float32)
    vecs = centres[rng.integers(0, 12, n)] + 0.3 * rng.standard_normal((n, dim)).astype(np.float32)
    idx = HnswIndex(dim, "l2", m=8, ef_construction=60, wave_size=128, seed=5,
                    device="cpu")
    idx.insert_mode = insert_mode
    idx.insert(np.arange(300), vecs[:300])
    idx.insert(np.arange(300, n), vecs[300:])
    idx.exact_small_n = 0
    flat = _flat(dim, np.arange(n), vecs)
    queries = vecs[rng.integers(0, n, 40)] + 0.05 * rng.standard_normal((40, dim)).astype(np.float32)
    assert recall_at_k(idx, flat, queries, k=10, ef=64) >= 0.9


def test_empty_index_search():
    idx = HnswIndex(16, "l2", device="cpu")
    ids, dists = idx.search(np.zeros(16, np.float32), k=3)
    assert (ids == -1).all() and np.isinf(dists).all()


def test_ef_search_default_is_2k(rng):
    idx, vecs = build_index(rng, n=200)
    ids, _ = idx.search(vecs[7], k=5)  # src/hnsw_vtab.c:600-603: ef = 2k
    assert ids[0] == 7
    idx.exact_small_n = 0
    ids, _ = idx.search(vecs[7], k=5)
    assert ids[0] == 7


def test_seeded_determinism(rng):
    """The same seed gives the same levels and results, and ``seed_rng``
    resets the level sampling of an index built with another seed."""
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((10, 16)).astype(np.float32)
    runs = []
    for seed, reseed in ((99, None), (99, None), (5, 99)):
        idx = HnswIndex(16, "l2", m=8, ef_construction=40, wave_size=100,
                        seed=seed, device="cpu")
        if reseed is not None:
            idx.seed_rng(reseed)
        idx.insert(np.arange(300), vecs)
        idx.exact_small_n = 0
        runs.append((idx.levels.copy(), idx.search(q, k=5, ef_search=32)[0]))
    for levels, ids in runs[1:]:
        np.testing.assert_array_equal(levels, runs[0][0])
        np.testing.assert_array_equal(ids, runs[0][1])


def test_invalid_args():
    with pytest.raises(ValueError):
        HnswIndex(16, "l2", m=1, device="cpu")
    with pytest.raises(ValueError):
        HnswIndex(16, "bogus", device="cpu")
    idx = HnswIndex(16, "l2", device="cpu")
    idx.insert([1], np.zeros((1, 16), np.float32))
    with pytest.raises(ValueError):
        idx.search(np.zeros(9), k=1)
    with pytest.raises(ValueError, match="duplicate id"):
        idx.insert([1], np.zeros((1, 16), np.float32))
    with pytest.raises(KeyError):
        idx.delete([2])
    assert len(idx) == 1
    idx.insert_mode = "greedy"
    with pytest.raises(ValueError, match="insert_mode"):
        idx.insert([3], np.ones((1, 16), np.float32))
    assert len(idx) == 1 and idx.store.slot(3) is None


def test_randomized_churn_differential(rng):
    """Interleaved insert and delete waves keep the invariants (no live
    edge to a tombstone, the live count) and recall against the exact
    oracle (``tests/test_hnsw.py:668-709``)."""
    dim = 16
    idx = HnswIndex(dim, "l2", m=6, ef_construction=48, wave_size=64, seed=11,
                    device="cpu")
    live: dict[int, np.ndarray] = {}
    next_id = 0
    for phase in range(6):
        n_ins = int(rng.integers(40, 120))
        vecs = rng.standard_normal((n_ins, dim)).astype(np.float32)
        ids = np.arange(next_id, next_id + n_ins)
        next_id += n_ins
        idx.insert(ids, vecs)
        live.update(zip(ids.tolist(), vecs))
        if phase >= 1 and len(live) > 80:
            kill = rng.choice(sorted(live), size=30, replace=False)
            idx.delete(kill)
            for i in kill.tolist():
                del live[i]
        assert len(idx) == len(live)
        assert _no_stale_edges(idx)

    keys = np.array(sorted(live))
    mat = np.stack([live[i] for i in keys.tolist()])
    flat = _flat(dim, keys, mat, capacity=2048)
    q = mat[rng.choice(len(keys), 25, replace=False)]
    for exact_small_n in (8192, 0):
        idx.exact_small_n = exact_small_n
        got, _ = idx.search(q, k=5, ef_search=48)
        want, _ = flat.search(q, k=5)
        hits = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(got, want))
        assert hits / (25 * 5) >= 0.9
        assert set(got[got >= 0].tolist()) <= set(keys.tolist())


def test_full_lifecycle_edges(rng):
    """Odd-sized inserts with capacity growth, repeated deletion of the
    nearest row, deletion of everything, then the same ids reinserted
    with new vectors (and a zero vector): searches stay oracle-exact
    (``tests/test_hnsw.py:711-753``)."""
    dim, total = 8, 150
    idx = HnswIndex(dim, "l2", m=4, ef_construction=32, capacity=64, seed=7,
                    wave_size=32, device="cpu")
    vecs = rng.standard_normal((total, dim)).astype(np.float32)
    pos = 0
    while pos < total:
        step = int(rng.integers(1, 37))
        idx.insert(np.arange(pos, min(pos + step, total)), vecs[pos : pos + step])
        pos += step
    assert len(idx) == total

    probe = vecs[0:1]
    killed = []
    for _ in range(10):
        top = int(idx.search(probe, k=1)[0][0, 0])
        idx.delete(np.array([top]))
        killed.append(top)
    got, _ = idx.search(probe, k=10)
    assert not set(got.ravel().tolist()) & set(killed)

    idx.delete(np.array(sorted(set(range(total)) - set(killed))))
    assert len(idx) == 0 and idx.entry_point == -1
    assert (idx.search(probe, k=5)[0] == -1).all()

    v2 = rng.standard_normal((20, dim)).astype(np.float32)
    v2[3] = 0.0
    idx.insert(np.arange(20), v2)
    flat = _flat(dim, np.arange(20), v2, capacity=64)
    q = v2 + 0.01 * rng.standard_normal((20, dim)).astype(np.float32)
    got2 = idx.search(q, k=3)[0]
    want2 = flat.search(q, k=3)[0]
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got2, want2))
    assert hits / 60 >= 0.95
    assert int(idx.search(np.zeros((1, dim), np.float32), k=1)[0][0, 0]) == 3


def test_bulk_build_into_an_emptied_index_wires_no_tombstone(rng):
    """An index emptied by deletes, then bulk-built again: the sweep masks
    the dead rows below the batch, so no live edge points at a tombstone.
    (The JAX package's sweep, ``hnsw.py:1170``, passes no mask and wires
    dead rows in here: a fault of the reference the port does not copy,
    ROADMAP queue 3.) Slots are not reused here, so that the dead rows
    stay below the batch."""
    x = rng.standard_normal((300, 8)).astype(np.float32)
    idx = HnswIndex(8, "l2", m=4, wave_size=32, device="cpu", reuse_slots=False)
    idx.insert(np.arange(300), x)
    idx.delete(np.arange(300))
    idx.insert(np.arange(300), x + 0.01)
    assert len(idx) == 300 and idx.store.high_watermark == 600
    assert _no_stale_edges(idx)
    idx.exact_small_n = 0
    flat = _flat(8, np.arange(300), x + 0.01)
    q = x[::10] + 0.05
    assert recall_at_k(idx, flat, q, k=5, ef=32) >= 0.9
