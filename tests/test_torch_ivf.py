"""muninn_tpu_torch's IVF index against muninn_tpu's on the CPU.

The same seeded numpy inputs go through both packages: the host assignment
(bitwise), Lloyd's steps from the same seeds and the top-C centroids (within
1e-5), a build from the same external centroids (member tables and blocks
equal), searches after churn on the non-fused route of every metric, and the
fused route through the kernels' plain versions against JAX's
``_ivf_search(fused=True, interpret=True)`` on integer-grid rows. The
seeding and the training sample, which come from each framework's own
generator, are held by statistics. Then the cases of ``tests/test_ivf.py``
on the port (all but the serving and sharded ones), and the two faults of
the reference that the port does not copy. Ids must be equal except where
the two rows are float64 ties for the query; every index lives on the CPU.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.index import ivf as jax_ivf
from muninn_tpu.index.ivf import IvfIndex as JaxIvfIndex
from muninn_tpu.ops.distance import Metric as JaxMetric
from muninn_tpu_torch import FlatIndex, IvfIndex
from muninn_tpu_torch.index import ivf as ivf_mod
from muninn_tpu_torch.io.checkpoint import load_ivf, save_ivf
from muninn_tpu_torch.ops.distance import Metric, quantize_rows_int8

D = 32
METRICS = ["l2", "cosine", "inner_product"]


def _clustered(rng, n, d, n_centers=40, q=200):
    """``tests/test_ivf.py``'s recipe: unit rows about Gaussian centres,
    queries near rows."""
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    x = centers[rng.integers(0, n_centers, n)]
    x = x + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qq = x[rng.integers(0, n, q)]
    qq = qq + 0.05 * rng.standard_normal((q, d)).astype(np.float32)
    qq /= np.linalg.norm(qq, axis=1, keepdims=True)
    return x, qq


def _recall(ids, true_ids):
    ids = np.asarray(ids)
    return sum(
        len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ids, true_ids)
    ) / true_ids.size


def _ivf(dim, metric="cosine", **kw):
    idx = IvfIndex(dim, metric, device="cpu", **kw)
    assert idx.device.type == "cpu" and idx.store.vectors.device.type == "cpu"
    return idx


def _truth(x, q, metric, k=10, ids=None):
    flat = FlatIndex(x.shape[1], metric, capacity=len(x), device="cpu")
    assert flat.device.type == "cpu"
    flat.insert(np.arange(len(x)) if ids is None else ids, x)
    return flat.search(q, k=k)


def _dist64(a, b, metric):
    a, b = a.astype(np.float64), b.astype(np.float64)
    dots = (a * b).sum(-1)
    if metric == "l2":
        return ((a - b) ** 2).sum(-1)
    if metric == "inner_product":
        return -dots
    return 1.0 - dots / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_ids_tie(got, want, q, rows_of, metric):
    """``got`` and ``want`` (ids or slots, ``[B, k]``) equal, except where
    both are live and float64 ties for their query within 1e-6."""
    b, c = np.nonzero(got != want)
    if len(b):
        assert (got[b, c] >= 0).all() and (want[b, c] >= 0).all()
        dg = _dist64(q[b], rows_of(got[b, c]), metric)
        dw = _dist64(q[b], rows_of(want[b, c]), metric)
        assert np.all(np.abs(dg - dw) <= 1e-6 * (1 + np.abs(dw))), (b, c)


# ───────────────────────── host helpers, bitwise ─────────────────────────


@pytest.mark.parametrize("n,ncl,s,c,fill0", [
    (500, 4, 130, 4, None),                      # everyone fits
    (600, 5, 100, 3, [100, 50, 0, 99, 20]),      # full, partly full; 369 fit nowhere
    (300, 8, 16, 8, [16] * 7 + [0]),             # one cluster with room
])
def test_balanced_assign_and_ranks_match_jax(n, ncl, s, c, fill0):
    """Integer distances (ties inside a cluster's run), full and partly full
    clusters and rows that fit nowhere: the assignment, ``fill`` after the
    call and the ranks equal JAX's."""
    rng = np.random.default_rng(n + ncl)
    top_cl = np.argsort(rng.random((n, ncl)), axis=1)[:, :c].astype(np.int32)
    top_d = np.sort(rng.integers(0, 20, (n, c)).astype(np.float32), axis=1)
    f0 = np.zeros(ncl, np.int64) if fill0 is None else np.array(fill0, np.int64)
    fj, ft = f0.copy(), f0.copy()
    want = jax_ivf._balanced_assign(top_cl, top_d, fj, s)
    got = ivf_mod._balanced_assign(top_cl, top_d, ft, s)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ft, fj)
    placed = got >= 0
    assert placed.sum() == min(n, int((s - f0).clip(min=0).sum()))
    assert (ft <= s).all()
    np.testing.assert_array_equal(ivf_mod._ranks_within(got[placed], f0),
                                  jax_ivf._ranks_within(got[placed], f0))


# ───────────────────────── build, against JAX ─────────────────────────


def _padded(x, npad):
    v = np.zeros((npad, x.shape[1]), np.float32)
    v[: len(x)] = x
    return v, np.arange(npad) < len(x)


@pytest.mark.parametrize("metric", METRICS)
def test_lloyd_matches_jax_from_the_same_seeds(metric):
    """JAX's ``_kmeans`` against the port's ``_lloyd`` from JAX's own seed
    rows (its Gumbel top-k, recomputed here): centroids within 1e-5."""
    x, _ = _clustered(np.random.default_rng(1), 3000, D)
    v, valid = _padded(x, 3072)
    ncl, iters, key = 40, 5, jax.random.PRNGKey(4)
    want = jax_ivf._kmeans(jnp.asarray(v), jnp.asarray(valid), key, iters, ncl,
                           1024, JaxMetric(metric))
    g = jax.random.gumbel(key, (v.shape[0],))
    _, seeds = jax.lax.top_k(jnp.where(jnp.asarray(valid), g, -jnp.inf), ncl)
    got = ivf_mod._lloyd(torch.from_numpy(x), torch.from_numpy(v[np.asarray(seeds)]),
                         iters, Metric(metric))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_topc_centroids_match_jax(metric):
    rng = np.random.default_rng(2)
    x, _ = _clustered(rng, 3000, D)
    v, _ = _padded(x, 3072)
    cent = rng.standard_normal((40, D)).astype(np.float32)
    jd, ji = jax_ivf._topc_centroids(jnp.asarray(v), jnp.asarray(cent), 16, 1024,
                                     JaxMetric(metric))
    td, ti = ivf_mod._topc_centroids(torch.from_numpy(v), torch.arange(3072),
                                     torch.from_numpy(cent), 16, Metric(metric))
    ji, ti = np.asarray(ji), ti.numpy()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    rows = np.repeat(np.arange(3072), 16).reshape(3072, 16)
    b, c = np.nonzero(ti != ji)
    _assert_ids_tie(ti[b, c][:, None], ji[b, c][:, None], v[rows[b, c]],
                    lambda i: cent[i], metric)


def _build_pair(quant, rounds, metric="cosine", n=3000, ncl=50, seed=5, **kw):
    """A JAX and a port index with the same rows, built from the same
    external centroids (``ncl`` rows of the data)."""
    rng = np.random.default_rng(seed)
    x, q = _clustered(rng, n, D)
    c0 = x[rng.choice(n, ncl, replace=False)]
    j = JaxIvfIndex(D, metric, cluster_size=64, assign_rounds=rounds,
                    quant=quant, **kw)
    t = _ivf(D, metric, cluster_size=64, assign_rounds=rounds, quant=quant, **kw)
    for idx in (j, t):
        idx.load_rows(np.arange(n), x)
        idx.rebuild(centroids=c0)
    return j, t, x, q


def _assert_same_build(j, t):
    np.testing.assert_array_equal(t.member_slots.numpy(), np.asarray(j.member_slots))
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(t._pending_slots(), j._pending_slots())
    if t.quant == "int8":
        np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
        np.testing.assert_allclose(t.block_scales.numpy(), np.asarray(j.block_scales),
                                   rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(t.blocks.view(torch.int16).numpy(),
                                      np.asarray(j.blocks).view(np.int16))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_rebuild_from_centroids_one_round_matches_jax(quant):
    """50 clusters of 64 for 3,000 rows (many rows displaced): member
    tables, fill and blocks equal, scales within 1e-6, the refit centroids
    within 1e-5."""
    j, t, _, _ = _build_pair(quant, 1)
    assert t.blocks.dtype == (torch.int8 if quant == "int8" else torch.bfloat16)
    _assert_same_build(j, t)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_rebuild_from_centroids_two_rounds_close_to_jax(quant):
    """Round 2 assigns against the refit means, which differ from JAX's in
    the last bits: at least 99% of the member table and of the searched
    ids equal."""
    j, t, _, q = _build_pair(quant, 2)
    assert np.mean(t.member_slots.numpy() == np.asarray(j.member_slots)) >= 0.99
    jid, _ = j.search(q, k=10)
    tid, _ = t.search(q, k=10)
    assert np.mean(tid == np.asarray(jid)) >= 0.99


def test_quantize_blocks_matches_jax():
    """Per-row int8 quantization of packed bf16 blocks over more clusters
    than one chunk. The port's codes are the IEEE f32 quotient rounded half
    to even, exactly; JAX's jitted ones equal them except by one code where
    that quotient lies within one ulp of a half-integer (XLA does not form
    the quotient by one correctly rounded division). Scales within 1e-6."""
    rng = np.random.default_rng(14)
    blocks = torch.from_numpy(
        rng.standard_normal((1030, 8, 16)).astype(np.float32)).bfloat16()
    blocks[3, 2] = 0.0
    bf = blocks.float().numpy()
    jq, js = jax_ivf._quantize_blocks(jnp.asarray(bf).astype(jnp.bfloat16))
    tq, ts = ivf_mod._quantize_blocks(blocks)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    quot = bf / np.maximum(ts.numpy()[..., None], np.float32(1e-30))
    np.testing.assert_array_equal(tq.numpy(), np.clip(np.round(quot), -127, 127))
    jq, tq = np.asarray(jq).astype(np.int32), tq.numpy().astype(np.int32)
    diff = jq != tq
    assert diff.mean() < 1e-3 and (np.abs(jq - tq)[diff] == 1).all()
    half = np.abs(quot - np.floor(quot) - 0.5)
    assert (half[diff] <= np.spacing(np.abs(quot[diff]))).all()


# ───────────────────────── search, against JAX ─────────────────────────


def _assert_same_search(j, t, q, x_of, metric, k=10, nprobe=None):
    jid, jd = j.search(q, k=k, nprobe=nprobe)
    tid, td = t.search(q, k=k, nprobe=nprobe)
    jid, jd = np.asarray(jid), np.asarray(jd)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-6)
    _assert_ids_tie(tid, jid, q, x_of, metric)
    return tid


@pytest.mark.parametrize("metric", METRICS)
def test_search_after_churn_matches_jax(metric):
    """The non-fused route after churn: inserts placed in clusters, rows in
    the pending region (``load_rows``), deletes in both; k within and above
    ``nprobe * cluster_size``. The member tables stay equal, the searches
    return JAX's ids and distances, and no deleted id."""
    j, t, x, q = _build_pair("bf16", 1, metric, n=2000, ncl=40, seed=9,
                             nprobe=2, rescore_r=16)
    extra, _ = _clustered(np.random.default_rng(10), 200, D)
    for idx in (j, t):
        idx.insert(np.arange(2000, 2150), extra[:150])
        idx.load_rows(np.arange(2150, 2200), extra[150:])
        idx.delete(np.r_[np.arange(0, 300, 7), np.arange(2140, 2160)])
    _assert_same_build(j, t)
    assert t._pending_count == j._pending_count >= 50
    allx = np.concatenate([x, extra])
    dead = np.r_[np.arange(0, 300, 7), np.arange(2140, 2160)]
    for k in (10, 2 * 64 + 7):
        ids = _assert_same_search(j, t, q, lambda i: allx[i], metric, k=k)
        assert ids.shape == (len(q), k)
        assert not np.isin(ids, dead).any()


def _grid(rng, n, d):
    """Multiples of 1/4 in [-1, 1], no zero row: exact in bf16, and every
    dot and squared norm at d <= 128 exact in f32 in any order."""
    v = rng.integers(-4, 5, (n, d)).astype(np.float32) / 4.0
    v[np.abs(v).sum(axis=-1) == 0, 0] = 1.0
    return v


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "inner_product"])
def test_fused_route_matches_jax_interpret(metric, quant):
    """``_ivf_search(fused=True)`` through the plain ``flat_topk`` (bf16
    operands) and ``gather_block_dots`` against JAX's interpret-mode route
    on grid rows (d = 128, S = 32), where bf16 rounding and every product
    are exact: equal slots and distances. Queries whose p + 1 nearest
    centroids tie are left out (the order of tied probes is open)."""
    rng = np.random.default_rng(31 if metric == "l2" else 32)
    d, s, ncl, p, k, r = 128, 32, 12, 3, 10, 24
    vec = _grid(rng, ncl * s, d)
    valid = rng.random(ncl * s) >= 0.1
    ms = rng.permutation(ncl * s).astype(np.int32)
    ms[rng.random(ncl * s) < 0.1] = -1
    ms = ms.reshape(ncl, s)
    cent = _grid(rng, ncl, d)
    q = _grid(rng, 400, d)
    dc = np.sort(_dist64(q[:, None, :], cent[None], metric), axis=1)[:, : p + 1]
    q = q[(np.diff(dc, axis=1) > 0).all(axis=1)][:64]
    assert len(q) >= 32
    blocks = vec[np.maximum(ms, 0)] * (ms >= 0)[..., None]
    if quant == "int8":
        bi, bs = quantize_rows_int8(torch.from_numpy(blocks))
        tb, ts = bi, bs
        jb, js = jnp.asarray(bi.numpy()), jnp.asarray(bs.numpy())
    else:
        tb, ts = torch.from_numpy(blocks).bfloat16(), None
        jb, js = jnp.asarray(blocks).astype(jnp.bfloat16), None
    want_d, want_i = jax_ivf._ivf_search(
        jnp.asarray(q), jnp.asarray(cent), jb, jnp.asarray(ms), jnp.asarray(vec),
        jnp.asarray(valid), JaxMetric(metric), k, p, r, True, True, scales=js)
    got_d, got_i = ivf_mod._ivf_search(
        torch.from_numpy(q), torch.from_numpy(cent), tb, torch.from_numpy(ms),
        torch.from_numpy(vec), torch.from_numpy(valid), Metric(metric), k, p, r,
        True, scales=ts)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_fused_route_on_a_cpu_index_keeps_recall():
    """``use_kernels`` on a CPU index (bf16 probe selection, block dots
    through the plain kernels): recall within 0.01 of the non-fused route."""
    x, q = _clustered(np.random.default_rng(3), 4000, 64)
    true_ids, _ = _truth(x, q, "cosine")
    idx = _ivf(64, cluster_size=64, nprobe=8, rescore_r=32)
    assert not idx.use_kernels
    idx.insert(np.arange(4000), x)
    plain = _recall(idx.search(q, k=10)[0], true_ids)
    idx.use_kernels = True
    fused = _recall(idx.search(q, k=10)[0], true_ids)
    assert fused >= plain - 0.01 and fused >= 0.9


# ───────────────────────── the build's randomness ─────────────────────────


def test_seeding_and_train_sample_draw_distinct_live_rows(monkeypatch):
    """The training sample is exactly ``train_sample`` distinct live rows,
    the seeds ``nlist`` distinct rows of it; over 40 seeds every live row is
    drawn about equally often (the first and second half of the rows within
    0.5 of 10 draws each on average) and no deleted row ever."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2000, 8)).astype(np.float32)
    dead = np.arange(0, 2000, 10)
    seen, sample = [], {}

    def spy_kmeans(v, ncl, iters, metric, gen):
        sample["v"] = v.clone()
        return real_kmeans(v, ncl, iters, metric, gen)

    def spy_lloyd(v, cent, iters, metric):
        seen.append((v, cent))
        return cent

    real_kmeans = ivf_mod._kmeans
    monkeypatch.setattr(ivf_mod, "_kmeans", spy_kmeans)
    monkeypatch.setattr(ivf_mod, "_lloyd", spy_lloyd)
    counts = np.zeros(2000)
    for seed in range(40):
        idx = _ivf(8, "l2", cluster_size=16, train_sample=450, kmeans_iters=0,
                   assign_rounds=1, seed=seed)
        idx.load_rows(np.arange(2000), x)
        idx.delete(dead)
        idx.rebuild()
        v = sample["v"].numpy()
        rows = np.flatnonzero((x[:, None, :] == v[None]).all(-1).any(1))
        assert len(v) == 450 and len(rows) == 450
        assert not np.isin(rows, dead).any()
        counts[rows] += 1
        sv, cent = seen[-1]
        assert cent.shape == (idx.nlist, 8)
        assert len(np.unique(cent.numpy(), axis=0)) == idx.nlist
        assert (cent.numpy()[:, None, :] == sv.numpy()[None]).all(-1).any(1).all()
    assert counts[dead].sum() == 0
    live = np.setdiff1d(np.arange(2000), dead)
    half = len(live) // 2
    assert abs(counts[live[:half]].mean() - 10.0) < 0.5
    assert abs(counts[live[half:]].mean() - 10.0) < 0.5


# ───────────────────────── tests/test_ivf.py on the port ─────────────────────────


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(3)
    x, q = _clustered(rng, 6000, 64)
    true_ids, true_d = _truth(x, q, "cosine")
    idx = _ivf(64, "cosine", cluster_size=64, nprobe=8, rescore_r=32)
    idx.insert(np.arange(6000), x)
    return x, q, true_ids, true_d, idx


def test_bulk_build_recall(built):
    x, q, true_ids, true_d, idx = built
    assert idx.centroids is not None  # the bulk insert built it
    assert idx.nlist >= 6000 // 64
    ids, d = idx.search(q, k=10)
    assert _recall(ids, true_ids) >= 0.9
    ids16, _ = idx.search(q, k=10, nprobe=16)
    assert _recall(ids16, true_ids) >= _recall(ids, true_ids) - 0.02


def test_exact_rescored_distances(built):
    x, q, true_ids, true_d, idx = built
    ids, d = idx.search(q, k=10)
    hits = 0
    for a, da, b, db in zip(ids, d, true_ids, true_d):
        if a[0] == b[0]:
            assert abs(da[0] - db[0]) < 1e-4
            hits += 1
    assert hits > len(q) * 0.8


def test_single_query_and_self_hit(built):
    x, q, true_ids, true_d, idx = built
    ids, d = idx.search(x[17], k=5)
    assert ids.shape == (5,)
    assert ids[0] == 17 and d[0] < 1e-5


def test_incremental_insert_and_pending(built):
    x = built[0]
    rng = np.random.default_rng(8)
    idx = _ivf(64, "cosine", cluster_size=64, nprobe=8)
    idx.insert(np.arange(6000), x)
    extra = x[:300] + 0.01 * rng.standard_normal((300, 64)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    idx.insert(np.arange(6000, 6300), extra)
    ids, _ = idx.search(extra[7], k=3)
    assert 6007 in ids


def test_delete_and_rebuild():
    x, q = _clustered(np.random.default_rng(11), 3000, 32)
    idx = _ivf(32, "cosine", cluster_size=64, nprobe=8)
    idx.insert(np.arange(3000), x)
    true_ids, _ = _truth(x, q, "cosine")
    victims = np.unique(true_ids[:, 0])[:30].astype(np.int64)
    idx.delete(victims)
    ids, _ = idx.search(q, k=10)
    assert not (set(np.asarray(ids).ravel().tolist()) & set(victims.tolist()))
    idx.rebuild()
    keep = np.setdiff1d(np.arange(3000), victims)
    t2, _ = _truth(x[keep], q, "cosine", ids=keep)
    ids2, _ = idx.search(q, k=10)
    assert _recall(ids2, t2) >= 0.9


@pytest.mark.parametrize("metric", ["l2", "inner_product"])
def test_other_metrics(metric):
    x, q = _clustered(np.random.default_rng(7), 3000, 32)
    t, _ = _truth(x, q, metric)
    idx = _ivf(32, metric, cluster_size=64, nprobe=10)
    idx.insert(np.arange(3000), x)
    ids, _ = idx.search(q, k=10)
    assert _recall(ids, t) >= 0.85


def test_unbuilt_exact_fallback():
    x, _ = _clustered(np.random.default_rng(5), 50, 32)
    idx = _ivf(32, "cosine", cluster_size=64)
    idx.insert(np.arange(50), x)
    assert idx.centroids is None  # below the build threshold
    ids, d = idx.search(x[3], k=5)
    assert ids[0] == 3
    ei, _ = _ivf(32, "cosine").search(x[:2], k=3)
    assert (np.asarray(ei) == -1).all()


def test_balanced_assign_capacity():
    rng = np.random.default_rng(0)
    n, ncl, s = 500, 4, 130
    top_cl = np.argsort(rng.standard_normal((n, 4)), axis=1)
    top_d = np.sort(rng.standard_normal((n, 4)).astype(np.float32), axis=1)
    fill = np.zeros(ncl, np.int64)
    assigned = ivf_mod._balanced_assign(top_cl.astype(np.int32), top_d, fill, s)
    assert (assigned >= 0).all()
    counts = np.bincount(assigned, minlength=ncl)
    assert (counts <= s).all() and counts.sum() == n
    ranks = ivf_mod._ranks_within(assigned, np.zeros(ncl, np.int64))
    for c in range(ncl):
        r = np.sort(ranks[assigned == c])
        assert (r == np.arange(r.size)).all()


def test_int8_blocks_recall_and_churn():
    rng = np.random.default_rng(11)
    x, q = _clustered(rng, 5000, 64)
    true_ids, _ = _truth(x, q, "cosine")
    idx = _ivf(64, "cosine", cluster_size=64, nprobe=8, rescore_r=32, quant="int8")
    idx.insert(np.arange(5000), x)
    idx.rebuild()
    assert idx.blocks.dtype == torch.int8 and idx.block_scales is not None
    ids, d = idx.search(q, k=10)
    assert _recall(ids, true_ids) > 0.93
    assert np.all(np.diff(d, axis=1) >= -1e-6)
    new = rng.standard_normal((8, 64)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    idx.insert(np.arange(9000, 9008), new)
    ids2, _ = idx.search(new, k=1)
    assert ids2[:, 0].tolist() == list(range(9000, 9008))
    idx.delete([9000])
    ids3, _ = idx.search(new[:1], k=1)
    assert int(ids3[0, 0]) != 9000


def test_randomized_churn_differential(tmp_path):
    """Interleaved insert and delete waves against a live-set flat oracle:
    no ghost ids, near-exact recall probing every cluster, and a mid-churn
    checkpoint that searches alike."""
    rng = np.random.default_rng(23)
    for trial, quant in [(0, "bf16"), (1, "int8")]:
        dim, metric = 16, "cosine"
        idx = _ivf(dim, metric, cluster_size=64, seed=trial, quant=quant)
        live = {}
        v0 = rng.standard_normal((600, dim)).astype(np.float32)
        idx.insert(np.arange(600), v0)
        live.update(zip(range(600), v0))
        nid = 600
        for phase in range(3):
            n_ins = int(rng.integers(40, 120))
            v = rng.standard_normal((n_ins, dim)).astype(np.float32)
            ids = np.arange(nid, nid + n_ins)
            nid += n_ins
            idx.insert(ids, v)
            live.update(zip(ids.tolist(), v))
            if phase:
                kill = rng.choice(sorted(live), size=50, replace=False)
                idx.delete(kill)
                for i in kill.tolist():
                    del live[i]
        keys = np.array(sorted(live))
        mat = np.stack([live[i] for i in keys.tolist()])
        q = mat[rng.choice(len(keys), 25, replace=False)] + \
            0.03 * rng.standard_normal((25, dim)).astype(np.float32)
        got, _ = idx.search(q, k=5, nprobe=idx.nlist)
        want, _ = _truth(mat, q, metric, k=5, ids=keys)
        assert set(got[got >= 0].tolist()) <= set(keys.tolist())
        hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
                   for a, b in zip(got, want))
        assert hits / (25 * 5) >= 0.9
        save_ivf(idx, tmp_path / f"ck{trial}")
        idx2 = load_ivf(tmp_path / f"ck{trial}", device="cpu")
        assert idx2.device.type == "cpu"
        g2, _ = idx2.search(q, k=5, nprobe=idx2.nlist)
        assert np.array_equal(got, g2)


def test_bf16_store_mode(tmp_path):
    """``store_dtype=torch.bfloat16`` halves the store; the rescore reads
    bf16 rows. Recall within 0.02 of the f32 store's, f32 distances out,
    churn and a checkpoint round trip through the bf16 store."""
    x, q = _clustered(np.random.default_rng(3), 4000, 48)
    true_ids, _ = _truth(x, q, "cosine")
    recalls = {}
    for dt in (torch.float32, torch.bfloat16):
        idx = _ivf(48, "cosine", cluster_size=64, nprobe=8, rescore_r=32,
                   seed=1, store_dtype=dt)
        idx.insert(np.arange(4000), x)
        assert idx.store.vectors.dtype == dt
        ids, dists = idx.search(q, k=10)
        recalls[dt] = _recall(ids, true_ids)
        assert dists.dtype == np.float32
        idx.insert(np.arange(4000, 4032), x[:32])
        idx.delete(np.arange(16))
        ids2, _ = idx.search(q[:8], k=5)
        assert not set(ids2[ids2 >= 0].tolist()) & set(range(16))
        save_ivf(idx, tmp_path / str(dt))
        idx3 = load_ivf(tmp_path / str(dt), device="cpu")
        assert idx3.store.vectors.dtype == dt
        np.testing.assert_array_equal(idx3.search(q[:8], k=5)[0],
                                      idx.search(q[:8], k=5)[0])
    assert recalls[torch.bfloat16] >= recalls[torch.float32] - 0.02, recalls


def test_large_query_batch_chunks_internally():
    """A batch past the 8,192-query chunk answers as the same queries in a
    small batch do, across the chunk boundary."""
    rng = np.random.default_rng(3)
    d, n = 24, 900
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = _ivf(d, "cosine", cluster_size=32, nprobe=4, seed=0)
    idx.insert(np.arange(n), x)
    idx.rebuild()
    big = np.repeat(x[:130], 65, axis=0)        # 8,450 > 8,192
    ids, dists = idx.search(big, k=3)
    assert ids.shape == (8450, 3)
    ref_ids, ref_d = idx.search(x[:130], k=3)
    for row in (0, 8191, 8192, 8449):
        np.testing.assert_array_equal(ids[row], ref_ids[row // 65])
        np.testing.assert_allclose(dists[row], ref_d[row // 65], rtol=1e-5)


# ───────────────────────── reference faults not copied ─────────────────────────


def test_pack_chunk_follows_the_padded_multiple():
    """``cluster_size = 96`` does not divide 131,072. With 1,366 clusters
    the slots (131,136) pass pc = 131,040, so ``rebuild`` pads them to
    262,080: JAX's pack, chunked at 131,072 rows, cannot reshape them
    (``ivf.py:201-202``); the port chunks by pc and packs every live row
    exactly once."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2000, 8)).astype(np.float32)
    j = JaxIvfIndex(8, "l2", cluster_size=96, kmeans_iters=2, assign_rounds=1)
    j.load_rows(np.arange(2000), x)
    with pytest.raises(TypeError, match="reshape"):
        j.rebuild(nlist=1366)
    t = _ivf(8, "l2", cluster_size=96, kmeans_iters=2, assign_rounds=1)
    t.load_rows(np.arange(2000), x)
    t.rebuild(nlist=1366)
    assert t.blocks.shape == (262_080 // 96, 96, 8)
    ms = t.member_slots.numpy()
    np.testing.assert_array_equal(np.sort(ms[ms >= 0]), np.arange(2000))
    rows = t.blocks.float().numpy().reshape(-1, 8)[ms.reshape(-1) >= 0]
    np.testing.assert_array_equal(
        rows, torch.from_numpy(x[ms[ms >= 0]]).bfloat16().float().numpy())
    ids, d = t.search(x[:20], k=1, nprobe=4)
    assert (ids[:, 0] == np.arange(20)).all()


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_non_fused_query_chunk_sized_at_four_bytes(quant, monkeypatch):
    """The non-fused route gathers ``[B, p*S, d]`` f32 rows whatever the
    blocks' type, so the port sizes its query chunk at 4 bytes an element;
    JAX sizes it at the blocks' itemsize (``ivf.py:796-800``), 2 or 1, a
    transient 2x or 4x its budget. With the budget at 300 queries' worth,
    1,000 queries take four calls, and answer as one call does."""
    x, q = _clustered(np.random.default_rng(12), 2000, D, q=1000)
    idx = _ivf(D, "cosine", cluster_size=32, nprobe=4, quant=quant)
    idx.insert(np.arange(2000), x)
    assert not idx._fused_ok()
    want = idx.search(q, k=5)
    per_q = 4 * 32 * D * 4
    monkeypatch.setattr(ivf_mod, "_GATHER_BYTES", 300 * per_q)
    assert idx._query_chunk(4) == 300
    itemsize = idx.blocks.element_size()
    assert 300 * per_q // (4 * 32 * D * itemsize) == 300 * 4 // itemsize
    calls = []
    real = ivf_mod._ivf_search

    def spy(q_, *a, **kw):
        calls.append(q_.shape[0])
        return real(q_, *a, **kw)

    monkeypatch.setattr(ivf_mod, "_ivf_search", spy)
    got = idx.search(q, k=5)
    assert calls == [300, 300, 300, 100]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
