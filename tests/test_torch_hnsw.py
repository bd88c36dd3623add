"""muninn_tpu_torch's HnswIndex against muninn_tpu's on the CPU.

The same seeded numpy inputs go through both packages: the bulk build
(levels, entry point, upper-level tables and the level-0 graph), search
over a JAX-built graph carried across with ``index.convert`` against JAX's
fused query path (``_search_topk_fused`` with ``fused=True,
interpret=True``, as ``tests/test_hnsw.py`` drives it), and the slice as a
whole: build and search in each package. Sizes are small (n <= 3,000,
d <= 128, m = 8, wave_size = 512).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.index.hnsw import HnswIndex as JaxHnswIndex
from muninn_tpu.index.hnsw import _search_topk_fused as jax_search_topk_fused
from muninn_tpu.index.hnsw import _search_topk_whole as jax_search_topk_whole
from muninn_tpu.ops.pallas_beam_loop import pack_wide as jax_pack_wide
from muninn_tpu.io.checkpoint import save_hnsw
from muninn_tpu_torch import FlatIndex, HnswIndex
from muninn_tpu_torch.index import hnsw as hnsw_mod
from muninn_tpu_torch.index.convert import hnsw_index_from_numpy, hnsw_index_to_numpy
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops import beam_step as beam_step_mod

REPO = Path(__file__).resolve().parents[1]
METRICS = ["l2", "cosine", "inner_product"]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(n, d, metric, precision, seed=5):
    """The same rows bulk-inserted into a JAX and a port index."""
    x = _unit(np.random.default_rng(seed), n, d)
    j = JaxHnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                     capacity=n, seed=seed)
    t = HnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                  capacity=n, seed=seed, device="cpu")
    j.build_precision = t.build_precision = precision
    j.insert(np.arange(n), x)
    t.insert(np.arange(n), x)
    return j, t, x


def _row_sets_equal(a, b):
    return np.array([set(u[u >= 0]) == set(v[v >= 0]) for u, v in zip(a, b)])


@pytest.mark.parametrize("metric", METRICS)
def test_bulk_build_matches_jax_at_highest(metric):
    """Exact sweeps on both sides: the same levels, entry point and hi
    rows; level-0 rows equal as sets in >= 99% of rows (a float64 tie
    may swap the last neighbour); edge distances within 1e-5; upper-level
    rows equal as sets in >= 99% of rows."""
    n = 2500
    j, t, _ = _pair(n, 64, metric, "highest")
    np.testing.assert_array_equal(t.levels, j.levels)
    assert (t.entry_point, t.max_level) == (j.entry_point, j.max_level)
    assert t._hi_count == j._hi_count
    np.testing.assert_array_equal(t.hi_index.numpy(), np.asarray(j.hi_index))
    jn, tn = np.asarray(j.neighbors0)[:n], t.neighbors0.numpy()[:n]
    assert _row_sets_equal(tn, jn).mean() >= 0.99
    same = _row_sets_equal(tn, jn)
    jd, td = np.asarray(j.dists0)[:n][same], t.dists0.numpy()[:n][same]
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    # the same f32 products summed in another order; each row is sorted,
    # so equal sets give aligned distances
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-5)
    jh, th = np.asarray(j.hi_neighbors), t.hi_neighbors.numpy()
    assert jh.shape == th.shape
    rows = slice(0, t._hi_count)
    assert _row_sets_equal(th[rows].reshape(-1, 8), jh[rows].reshape(-1, 8)).mean() >= 0.99


def test_bulk_build_at_default_precision_agrees_with_jax():
    """The port's default sweep ranks by bf16 operands, JAX's on the CPU in
    f32: at least 97% of level-0 edges agree."""
    n = 2500
    j, t, _ = _pair(n, 64, "cosine", "default")
    jn, tn = np.asarray(j.neighbors0)[:n], t.neighbors0.numpy()[:n]
    agree = np.mean([len(set(u) & set(v)) / len(u) for u, v in zip(tn, jn)])
    assert agree >= 0.97, agree
    np.testing.assert_array_equal(t.levels, j.levels)


def _carry(j, tmp_path):
    """The JAX index's checkpoint fields, as save_hnsw writes them."""
    save_hnsw(j, tmp_path)
    state = dict(np.load(tmp_path / "arrays.npz"))
    state.update(json.loads((tmp_path / "manifest.json").read_text()))
    return state


def _recall(ids, truth):
    k = truth.shape[1]
    return np.mean([len(set(a[a >= 0]) & set(b)) / k for a, b in zip(ids, truth)])


def _assert_same_results(tid, tdist, jid, jdist, truth, k):
    """Per-query id overlap >= 0.98, distances of shared ids within 1e-5,
    the port's recall at least JAX's - 0.01."""
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(tid, jid)])
    assert overlap >= 0.98, overlap
    for a, da, b, db in zip(tid, tdist, jid, jdist):
        theirs = dict(zip(b.tolist(), db.tolist()))
        for i, dv in zip(a.tolist(), da.tolist()):
            if i in theirs:
                assert abs(dv - theirs[i]) <= 1e-5 * (1 + abs(dv))
    assert _recall(tid, truth) >= _recall(jid, truth) - 0.01


def _jax_fused_search(j, q, k, ef, topm=0):
    pool = j._routing_pool()
    packed = j._maybe_packed(force=True)
    d, s = jax_search_topk_fused(
        jnp.asarray(q), pool, j._pool_vecs(pool), j.store.vectors,
        j._vecs16(), j.neighbors0, j.store.valid, j.metric, k, ef,
        j.expand, min(j.route_entries, ef),
        True,  # interpret
        None, 0, packed, True, -(-ef // j.expand) + 1, True, None, topm,
    )
    return j.store.ids_of(np.asarray(s)), np.asarray(d)


def _jax_whole_search(j, q, k, ef):
    """JAX's whole-beam query path in interpret mode, at the knobs its
    ``_search_topk_chunked`` passes (``hnsw.py:838-845``)."""
    pool = j._routing_pool()
    d, s = jax_search_topk_whole(
        jnp.asarray(q), pool, j._pool_vecs(pool), j.store.vectors,
        j._vecs16(), jax_pack_wide(j._vecs16(), j.neighbors0), j.store.valid,
        j.metric, k, ef, j.expand, min(j.route_entries, ef),
        True, 0, -(-ef // j.expand) + 1, "dma",
    )
    return j.store.ids_of(np.asarray(s)), np.asarray(d)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A cosine JAX graph (n = 3,000, d = 128, m = 8) and its state, with
    queries near rows and their exact top-10."""
    n, d = 3000, 128
    rng = np.random.default_rng(11)
    x = _unit(rng, n, d)
    q = x[:64] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    j = JaxHnswIndex(d, "cosine", m=8, ef_construction=64, wave_size=512,
                     capacity=n)
    j.insert(np.arange(n), x)
    state = _carry(j, tmp_path_factory.mktemp("carried"))
    flat = FlatIndex(d, "cosine", device="cpu")
    flat.insert(np.arange(n), x)
    truth, _ = flat.search(q, k=10)
    return j, state, q, truth


def _counting(monkeypatch, name, module=hnsw_mod):
    """Count the calls ``module`` (the HNSW module unless given) makes to
    ``name``."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("metric", METRICS)
def test_search_on_carried_graph_matches_jax_fused(metric, tmp_path):
    """JAX's graph carried across: the port's search (packed blocks, then
    the row path) against JAX's fused query path on the same graph."""
    n, d, k, ef = 3000, 128, 10, 32
    rng = np.random.default_rng(11)
    x = _unit(rng, n, d)
    q = x[:64] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    j = JaxHnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                     capacity=n)
    j.insert(np.arange(n), x)
    t = hnsw_index_from_numpy(_carry(j, tmp_path), device="cpu")
    flat = FlatIndex(d, metric, device="cpu")
    flat.insert(np.arange(n), x)
    truth, _ = flat.search(q, k=k)
    jid, jdist = _jax_fused_search(j, q, k, ef)

    t.exact_small_n = 0  # the beam path at this size
    assert t._maybe_packed() is None  # the CPU packs only when asked
    t.pack_neighbors()
    packed = t._maybe_packed()
    assert packed is not None and packed.dtype == torch.bfloat16
    assert packed.shape == (t.store.capacity, t.m0, d)
    tid, tdist = t.search(q, k=k, ef_search=ef)
    _assert_same_results(tid, tdist, jid, jdist, truth, k)

    t.pack_budget_bytes = 0  # over budget: no table, the row path
    t.pack_neighbors()
    assert t._maybe_packed() is None
    rid, rdist = t.search(q, k=k, ef_search=ef)
    _assert_same_results(rid, rdist, jid, jdist, truth, k)


def test_topm_search_on_carried_graph_matches_jax(carried, monkeypatch):
    """``beam_topm = 8`` on JAX's graph carried across: the search goes
    through ``gather_block_topm`` and matches JAX's ``_search_topk_fused(...,
    topm=8)`` in interpret mode within ``_assert_same_results``'
    tolerances; ``beam_topm`` is capped at R0 (16), where it is the dots
    path."""
    j, state, q, truth = carried
    k, ef = 10, 32
    t = hnsw_index_from_numpy(state, device="cpu")
    t.exact_small_n = 0
    t.pack_neighbors()
    jid, jdist = _jax_fused_search(j, q, k, ef, topm=8)
    calls = _counting(monkeypatch, "gather_block_topm", beam_step_mod)
    t.beam_topm = 8
    tid, tdist = t.search(q, k=k, ef_search=ef)
    assert calls
    _assert_same_results(tid, tdist, jid, jdist, truth, k)
    t.beam_topm = 0
    did, ddist = t.search(q, k=k, ef_search=ef)
    t.beam_topm = 1000  # capped at R0: the dots path's results
    wid, wdist = t.search(q, k=k, ef_search=ef)
    _assert_same_results(wid, wdist, did, ddist, truth, k)


def test_search_degree_cached_and_matches_jax(carried):
    """``search_degree`` slices ``neighbors0`` and the packed table once and
    caches them (``tests/test_hnsw.py:595-636``): a second search reuses the
    slices, a new knob or ``pack_neighbors()`` replaces them; results match
    JAX's packed path with the same ``search_degree`` on the carried graph
    within ``_assert_same_results``' tolerances."""
    j, state, q, truth = carried
    k, ef = 10, 32
    t = hnsw_index_from_numpy(state, device="cpu")
    t.exact_small_n = j.exact_small_n = 0
    t.pack_neighbors()
    j.pack_neighbors()
    j.search_bf16 = True
    t.search_degree = j.search_degree = 8
    try:
        jid, jdist = j.search(q, k=k, ef_search=ef)
    finally:
        j.search_bf16, j.search_degree, j.exact_small_n = False, None, 8192
    tid, tdist = t.search(q, k=k, ef_search=ef)
    cache1 = t._sd_cache
    assert cache1 is not None and cache1[4].shape == (t.store.capacity, 8)
    assert cache1[5].shape == (t.store.capacity, 8, 128) and cache1[5].is_contiguous()
    tid2, tdist2 = t.search(q, k=k, ef_search=ef)
    assert t._sd_cache is cache1
    np.testing.assert_array_equal(tid, tid2)
    np.testing.assert_array_equal(tdist, tdist2)
    _assert_same_results(tid, tdist, np.asarray(jid), np.asarray(jdist), truth, k)
    # half the degree on unclustered rows trades recall for reads
    assert _recall(tid, truth) >= 0.5
    t.search_degree = 12
    t.search(q, k=k, ef_search=ef)
    cache2 = t._sd_cache
    assert cache2 is not cache1 and cache2[4].shape[1] == 12
    t.pack_neighbors()
    t.search(q, k=k, ef_search=ef)
    assert t._sd_cache is not cache2 and t._sd_cache[2] is t._maybe_packed()
    cache3 = t._sd_cache
    t.insert(np.arange(3000, 3004), state["vectors"][:4])  # a wave: new tables
    t.search(q, k=k, ef_search=ef)
    assert t._sd_cache is not cache3 and t._sd_cache[1] is t.neighbors0
    t.search_degree = 16  # >= 2M: the whole rows, no slices
    assert t._search_tables(t._maybe_packed(), None)[0] is t.neighbors0


def test_whole_path_on_carried_graph_matches_jax(carried, monkeypatch):
    """``beam_whole = "force"`` on JAX's graph carried across runs the
    whole-beam loop and matches JAX's ``_search_topk_whole`` in interpret
    mode within ``_assert_same_results``' tolerances. On a CPU index
    ``beam_whole = True`` and int8 guidance take the fused path, as JAX's
    gate (``hnsw.py:820-845``) says."""
    j, state, q, truth = carried
    k, ef = 10, 32
    t = hnsw_index_from_numpy(state, device="cpu")
    t.exact_small_n = 0
    jid, jdist = _jax_whole_search(j, q, k, ef)
    calls = _counting(monkeypatch, "beam_loop")
    t.beam_whole = "force"
    tid, tdist = t.search(q, k=k, ef_search=ef)
    assert len(calls) == 1
    assert t._maybe_packed() is not None  # "force" builds the shared table
    _assert_same_results(tid, tdist, jid, jdist, truth, k)
    t.beam_whole = True
    t.search(q, k=k, ef_search=ef)
    t.beam_whole = "force"
    t.search_quant = "int8"
    t.search(q, k=k, ef_search=ef)
    assert len(calls) == 1


def test_whole_path_respects_jax_deletes(tmp_path):
    """``tests/test_beam_loop.py:243-257`` across packages: JAX soft-deletes
    (and repairs around) 100 ids, the graph is carried across, and the
    port's whole-beam search never returns a victim."""
    n, d = 3000, 128
    rng = np.random.default_rng(21)
    x = _unit(rng, n, d)
    q = x[rng.integers(0, n, 48)] + 0.05 * rng.standard_normal((48, d)).astype(np.float32)
    j = JaxHnswIndex(d, "cosine", m=8, ef_construction=64, wave_size=512,
                     capacity=n)
    j.insert(np.arange(n), x)
    victims = np.arange(100, 200)
    j.delete(victims)
    t = hnsw_index_from_numpy(_carry(j, tmp_path), device="cpu")
    t.exact_small_n = 0
    t.beam_whole = "force"
    ids, dist = t.search(q, k=10, ef_search=32)
    assert not np.isin(ids, victims).any()
    assert (ids >= 0).all() and np.isfinite(dist).all()
    flat = FlatIndex(d, "cosine", device="cpu")
    flat.insert(np.arange(n), x)
    flat.delete(victims)
    assert _recall(ids, flat.search(q, k=10)[0]) >= 0.8


@pytest.mark.parametrize("metric", METRICS)
def test_whole_path_unaligned_d_equals_fused_path(metric):
    """d = 100 (no TPU alignment in the port): the whole-beam path over the
    packed table returns exactly the fused path's ids and distances, as
    both run the same steps with the same tie order."""
    n, d, k, ef = 2100, 100, 10, 24
    rng = np.random.default_rng(27)
    x = _unit(rng, n, d)
    q = x[:40] + 0.05 * rng.standard_normal((40, d)).astype(np.float32)
    t = HnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                  capacity=n, expand=8, device="cpu")
    t.insert(np.arange(n), x)
    t.exact_small_n = 0
    t.pack_neighbors()
    fid, fdist = t.search(q, k=k, ef_search=ef)
    t.beam_whole = "force"
    wid, wdist = t.search(q, k=k, ef_search=ef)
    np.testing.assert_array_equal(wid, fid)
    np.testing.assert_array_equal(wdist, fdist)
    t.search_degree = 12  # the same through the cached slices
    wid, wdist = t.search(q, k=k, ef_search=ef)
    t.beam_whole = False
    fid, fdist = t.search(q, k=k, ef_search=ef)
    np.testing.assert_array_equal(wid, fid)
    np.testing.assert_array_equal(wdist, fdist)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_slice_build_and_search_against_jax(metric):
    """The slice as a whole at the default knobs (bf16 bulk sweep, bf16
    routing and beam) on clustered rows: each package builds and searches
    its own index. The
    port's graph differs by bf16 ties, so its recall is held to JAX's
    within 0.02, and its returned distances are exact f32 distances of the
    returned rows (within 1e-5)."""
    n, d, k, ef = 3000, 128, 10, 24
    # bench.py's recipe: rows = Gaussian centre + 0.3 noise, unit-normalised;
    # queries = rows + 0.05 noise
    rng = np.random.default_rng(12)
    centres = rng.standard_normal((30, d)).astype(np.float32)
    x = centres[rng.integers(0, 30, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 80)] + 0.05 * rng.standard_normal((80, d)).astype(np.float32)
    j = JaxHnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                     capacity=n, expand=8)
    t = HnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                  capacity=n, expand=8, device="cpu")
    j.insert(np.arange(n), x)
    t.insert(np.arange(n), x)
    t.exact_small_n = 0
    t.pack_neighbors()
    flat = FlatIndex(d, metric, device="cpu")
    flat.insert(np.arange(n), x)
    truth, _ = flat.search(q, k=k)
    tid, tdist = t.search(q, k=k, ef_search=ef)
    jid, _ = _jax_fused_search(j, q, k, ef)
    assert _recall(tid, truth) >= _recall(jid, truth) - 0.02
    assert _recall(tid, truth) >= 0.9
    rows = x[np.maximum(tid, 0)].astype(np.float64)
    q64 = q.astype(np.float64)[:, None, :]
    if metric == "l2":
        want = ((rows - q64) ** 2).sum(-1)
    else:
        want = 1 - (rows * q64).sum(-1) / np.linalg.norm(q64, axis=-1)
    np.testing.assert_allclose(tdist, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_int8_guidance_on_carried_graph_matches_jax(metric, tmp_path):
    """``search_quant = "int8"`` on a JAX-built graph carried across: the
    port's row-dequant beam (``scales``, the path the CPU takes without a
    packed table) returns the same ids as JAX's, and distances within 1e-5
    (the same f32 rescore summed in another order). Routing ranks by bf16
    operands in the port and by f32 in JAX on the CPU; on this data it
    picks the same entries."""
    n, d, k, ef = 3000, 64, 10, 32
    rng = np.random.default_rng(17)
    x = _unit(rng, n, d)
    q = x[:64] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    j = JaxHnswIndex(d, metric, m=8, ef_construction=64, wave_size=512,
                     capacity=n)
    j.insert(np.arange(n), x)
    t = hnsw_index_from_numpy(_carry(j, tmp_path), device="cpu")
    flat = FlatIndex(d, metric, device="cpu")
    flat.insert(np.arange(n), x)
    truth, _ = flat.search(q, k=k)
    j.search_bf16 = True
    j.exact_small_n = t.exact_small_n = 0
    j.search_quant = t.search_quant = "int8"
    jid, jdist = j.search(q, k=k, ef_search=ef)
    assert t._maybe_packed() is None  # the row path with scales
    tid, tdist = t.search(q, k=k, ef_search=ef)
    assert t._v8 is not None and t._v8[0].dtype == torch.int8
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(tdist, np.asarray(jdist), rtol=1e-5, atol=1e-5)
    assert _recall(tid, truth) >= 0.9


def test_int8_packed_search_matches_row_dequant():
    """The packed int8 table (blocks plus per-neighbour scales, built by
    ``pack_neighbors()``) against the row-dequant path on the same index,
    as ``tests/test_hnsw.py:369-405`` holds the packed path against the row
    path; switching the guidance back rebuilds a bf16 table."""
    n, d, k, ef = 3000, 32, 10, 32
    rng = np.random.default_rng(19)
    x = _unit(rng, n, d)
    q = x[:64] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    t = HnswIndex(d, "cosine", m=8, ef_construction=64, wave_size=512,
                  capacity=2 * n, device="cpu")
    t.insert(np.arange(n), x)
    t.exact_small_n = 0
    t.search_quant = "int8"
    ids_row, d_row = t.search(q, k=k, ef_search=ef)
    t.pack_neighbors()
    packed = t._maybe_packed()
    assert packed.dtype == torch.int8 and packed.shape == (t.store.capacity, t.m0, d)
    assert t._packed_scales.shape == (t.store.capacity, t.m0)
    ids_pk, d_pk = t.search(q, k=k, ef_search=ef)
    # the two forms round the dequantized dot differently: a near-tie in
    # the guidance may swap a row; returned distances are the exact rescore
    assert np.mean(ids_pk == ids_row) >= 0.99
    same = ids_pk == ids_row
    np.testing.assert_allclose(d_pk[same], d_row[same], rtol=1e-6, atol=1e-7)
    t.search_quant = "bf16"  # the int8 table no longer matches
    assert t._maybe_packed(force=True).dtype == torch.bfloat16
    assert t._packed_scales is None


def test_unknown_search_quant_raises():
    """A ``search_quant`` other than "bf16" or "int8" raises at search and
    at packing instead of running bf16 guidance."""
    rng = np.random.default_rng(29)
    x = _unit(rng, 2100, 16)
    t = HnswIndex(16, "cosine", m=8, wave_size=512, device="cpu")
    t.insert(np.arange(2100), x)
    t.exact_small_n = 0
    t.search_quant = "int4"
    with pytest.raises(ValueError, match="search_quant"):
        t.search(x[:4], k=3)
    with pytest.raises(ValueError, match="search_quant"):
        t.pack_neighbors()


def test_int8_guidance_recall_within_bf16():
    """``tests/test_hnsw.py:266-300`` on the port: int8 guidance keeps
    recall within 0.03 of bf16 guidance (0.06 with patience 4); the exact
    rescore fixes the final ranking."""
    rng = np.random.default_rng(23)
    n, d, k = 2500, 32, 5
    centres = rng.standard_normal((25, d)).astype(np.float32)
    data = centres[rng.integers(0, 25, n)] + 0.1 * rng.standard_normal((n, d)).astype(np.float32)
    queries = data[rng.integers(0, n, 48)] + 0.02 * rng.standard_normal((48, d)).astype(np.float32)
    flat = FlatIndex(d, "cosine", device="cpu")
    flat.insert(np.arange(n), data)
    truth, _ = flat.search(queries, k=k)
    t = HnswIndex(d, "cosine", m=8, ef_construction=64, wave_size=512, device="cpu")
    t.insert(np.arange(n), data)
    t.exact_small_n = 0
    r16 = _recall(t.search(queries, k=k, ef_search=32)[0], truth)
    t.search_quant = "int8"
    r8 = _recall(t.search(queries, k=k, ef_search=32)[0], truth)
    assert r8 >= r16 - 0.03, (r8, r16)
    t.beam_patience = 4
    r8p = _recall(t.search(queries, k=k, ef_search=32)[0], truth)
    assert r8p >= r16 - 0.06, (r8p, r16)


def test_small_index_search_is_exact_flat():
    """At or below exact_small_n stored rows, search is FlatIndex's."""
    rng = np.random.default_rng(13)
    x = _unit(rng, 2100, 32)
    t = HnswIndex(32, "cosine", m=8, wave_size=512, device="cpu")
    t.insert(np.arange(2100) + 7, x)
    flat = FlatIndex(32, "cosine", device="cpu")
    flat.insert(np.arange(2100) + 7, x)
    q = x[:9] + 0.1
    hi, hd = t.search(q, k=5, ef_search=8)
    fi, fd = flat.search(q, k=5)
    np.testing.assert_array_equal(hi, fi)
    np.testing.assert_array_equal(hd, fd)
    one_i, one_d = t.search(q[0], k=5)
    assert one_i.shape == one_d.shape == (5,)


def test_hnsw_edge_cases_and_errors():
    """An empty index, a query of the wrong width; inserts of fewer than
    4 * wave_size rows into an empty index and of any size into a
    non-empty one run as waves, and search as JAX's does (exact flat at
    this size); bad knobs raise."""
    t = HnswIndex(16, "l2", m=4, wave_size=64, device="cpu")
    i, d = t.search(np.zeros((3, 16), np.float32), k=4)
    assert i.shape == (3, 4) and (i == -1).all() and np.isinf(d).all()
    with pytest.raises(ValueError, match="query dim 15 != index dim 16"):
        t.search(np.zeros(15), k=1)
    x = np.random.default_rng(14).standard_normal((600, 16)).astype(np.float32)
    q = x[::37] + 0.1
    small = HnswIndex(16, "l2", m=4, wave_size=64, device="cpu")
    small_j = JaxHnswIndex(16, "l2", m=4, wave_size=64)
    for idx in (small, small_j):
        idx.insert(np.arange(100), x[:100])  # < 4 waves: two waves
    assert len(small) == 100 and not small._packed_auto
    tid, tdist = small.search(q, k=5)
    jid, jdist = small_j.search(q, k=5)
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(tdist, np.asarray(jdist), rtol=1e-5, atol=1e-5)
    j = JaxHnswIndex(16, "l2", m=4, wave_size=64)
    for idx in (t, j):
        idx.insert(np.arange(300), x[:300])  # bulk
        idx.insert(np.arange(300, 600), x[300:])  # waves into a non-empty index
    assert len(t) == 600
    tid, tdist = t.search(q, k=5)
    jid, jdist = j.search(q, k=5)
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(tdist, np.asarray(jdist), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="m must be >= 2"):
        HnswIndex(16, m=1)
    with pytest.raises(ValueError, match="invalid metric"):
        HnswIndex(16, "euclidean")


def test_hnsw_state_round_trips(tmp_path):
    rng = np.random.default_rng(15)
    x = _unit(rng, 1100, 24)
    j = JaxHnswIndex(24, "cosine", m=6, ef_construction=40, wave_size=256,
                     capacity=1100)
    j.insert(np.arange(1100) * 2 + 1, x)
    state = _carry(j, tmp_path)
    t = hnsw_index_from_numpy(state, device="cpu")
    assert len(t) == 1100 and t.store.slot(2 * 17 + 1) == 17
    back = hnsw_index_to_numpy(t)
    assert set(back) == set(state) - {"kind", "format_version"}
    for key, val in back.items():
        np.testing.assert_array_equal(np.asarray(val), np.asarray(state[key]), err_msg=key)
    # the port's own state round-trips too
    again = hnsw_index_to_numpy(hnsw_index_from_numpy(back, device="cpu"))
    for key, val in again.items():
        np.testing.assert_array_equal(np.asarray(val), np.asarray(back[key]), err_msg=key)
    bad = dict(back, valid=~back["valid"])
    with pytest.raises(ValueError, match="valid"):
        hnsw_index_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="neighbors0"):
        hnsw_index_from_numpy(dict(back, neighbors0=back["neighbors0"][:, :3]),
                              device="cpu")
    with pytest.raises(ValueError, match="outside the store"):
        hnsw_index_from_numpy(dict(back, neighbors0=back["neighbors0"] + 5000),
                              device="cpu")
    with pytest.raises(ValueError, match="hi_index points outside"):
        hnsw_index_from_numpy(dict(back, hi_index=back["hi_index"] + 10**6),
                              device="cpu")


def _run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_hnsw_modules_import_no_jax():
    res = _run("""
        import sys
        from muninn_tpu_torch import HnswIndex
        from muninn_tpu_torch.index import convert, hnsw
        from muninn_tpu_torch.ops import beam, beam_loop, gather
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "muninn_tpu" or m.startswith("muninn_tpu.")]
        assert not bad, bad
    """)
    assert res.returncode == 0, res.stderr


def test_hnsw_cpu_path_never_builds_or_launches(tmp_path):
    """Build, an insert wave, a delete with repair, the upper-level flush,
    search (packed and row paths, top-m, search_degree, the whole-beam
    path) and the row gather on CPU tensors run the plain versions: no
    launch is counted and nvcc is never called."""
    fake = tmp_path / "bin"
    fake.mkdir()
    marker = tmp_path / "nvcc_called"
    nvcc = fake / "nvcc"
    nvcc.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{fake}{os.pathsep}{os.environ['PATH']}",
               CUDA_HOME=str(tmp_path))
    res = _run("""
        import numpy as np
        from muninn_tpu_torch.ops import _build
        from muninn_tpu_torch import HnswIndex
        x = np.random.default_rng(0).standard_normal((600, 8)).astype(np.float32)
        idx = HnswIndex(8, "cosine", m=4, wave_size=128, device="cpu")
        idx.insert(np.arange(600), x)
        idx.insert(np.arange(600, 700), x[:100] + 0.5)  # a wave
        idx.delete(np.arange(0, 50))  # a delete with repair
        idx._flush_hi_wiring()
        idx.exact_small_n = 0
        idx.search(x[:5], k=3)
        idx.pack_neighbors()
        idx.search(x[:5], k=3)
        for knob, value in (("beam_topm", 4), ("search_degree", 6),
                            ("beam_whole", True), ("beam_whole", "force")):
            setattr(idx, knob, value)
            idx.search(x[:5], k=3)
        idx.search_quant = "int8"
        idx.search(x[:5], k=3)
        idx.pack_neighbors()
        idx.search(x[:5], k=3)
        import torch
        from muninn_tpu_torch.ops.gather import gather_rows
        gather_rows(torch.from_numpy(x), torch.arange(9, dtype=torch.int32))
        from muninn_tpu_torch import FlatIndex, QuantizedFlatIndex
        for flat in (QuantizedFlatIndex(8, device="cpu"),
                     FlatIndex(8, "cosine", precision="int8_rescored", device="cpu"),
                     FlatIndex(8, "cosine", precision="proj_rescored", device="cpu")):
            flat.insert(np.arange(600), x)
            flat.search(x[:5], k=3)
        assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
        assert not _build._LIBS
    """, env=env)
    assert res.returncode == 0, res.stderr
    assert not marker.exists()
