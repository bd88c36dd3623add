"""muninn_tpu_torch's int8 path against muninn_tpu's on the CPU.

The same seeded numpy inputs go through the JAX function and its port:
``quantize_rows_int8``; ``flat_topk_int8`` and ``flat_topk(precision=
"int8")`` against the JAX kernel's own CPU route (``interpret=True``); the
two-tier searches ``flat_topk_int8_rescored`` and ``flat_topk_proj_rescored``
with the same projection basis; ``FlatIndex`` in its rescored modes and
``QuantizedFlatIndex`` against the JAX indexes; and the carry-across of
both. Every index here is built with ``device="cpu"``.

Integer dots are exact on both sides, so the rank-only tile values agree
to the bit and ids are equal except at exact ties of the tile value. The
port forms the distances ``base + qs * value`` in rounded f32 steps, and
JAX's compiled program differs from it by up to two ulps (inner products
of raw Gaussian rows reach ~30), hence distances within 1e-6, relative
and absolute.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.index.flat import FlatIndex as JaxFlatIndex
from muninn_tpu.index.flat import QuantizedFlatIndex as JaxQuantizedFlatIndex
from muninn_tpu.index.flat import pick_rescore_r as jax_pick_rescore_r
from muninn_tpu.io.checkpoint import load_quantized, save_quantized
from muninn_tpu.ops.distance import quantize_rows_int8 as jax_quantize
from muninn_tpu.ops.pallas_flat import flat_topk as jax_flat_topk
from muninn_tpu.ops.pallas_flat import flat_topk_int8 as jax_flat_topk_int8
from muninn_tpu.ops.pallas_flat import (
    flat_topk_int8_rescored as jax_int8_rescored,
)
from muninn_tpu.ops.pallas_flat import (
    flat_topk_proj_rescored as jax_proj_rescored,
)
from muninn_tpu.ops.pallas_flat import proj_basis as jax_proj_basis
from muninn_tpu_torch import FlatIndex, QuantizedFlatIndex
from muninn_tpu_torch.index.convert import (
    flat_index_from_numpy,
    flat_index_to_numpy,
    quantized_index_from_numpy,
    quantized_index_to_numpy,
)
from muninn_tpu_torch.index.flat import pick_rescore_r
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.distance import quantize_rows_int8, unit_rows
from muninn_tpu_torch.ops.flat_topk import (
    flat_topk,
    flat_topk_int8,
    flat_topk_int8_cuda,
    flat_topk_int8_rescored,
    flat_topk_proj_rescored,
    proj_basis,
)

INT8_METRICS = ["cosine", "inner_product"]


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _tiles(q, ci, cs, metric):
    """The rank-only tile values ``-(f32(dot) * cs)`` of the port's quantized
    queries against every corpus row, rounded in f32 as the kernel rounds
    them, for tie judgement."""
    q = _t(q).float()
    if metric == "cosine":
        q = unit_rows(q)
    qi, _ = quantize_rows_int8(q)
    dots = qi.numpy().astype(np.int64) @ np.asarray(ci).astype(np.int64).T
    return -(dots.astype(np.float32) * np.asarray(cs, np.float32))


def _assert_ids_equal_up_to_ties(gi, wi, tiles):
    """Ids equal except where the two rows' tile values are equal."""
    diff = np.argwhere(gi != wi)
    for b, r in diff:
        assert gi[b, r] >= 0 and wi[b, r] >= 0, (b, r)
        assert tiles[b, gi[b, r]] == tiles[b, wi[b, r]], (b, r)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape", [(300, 96), (5, 40, 72)], ids=["rows", "clusters"])
def test_quantize_rows_int8_matches_jax(shape, normalize):
    rng = np.random.default_rng(len(shape) + normalize)
    v = (rng.standard_normal(shape) * rng.uniform(0.1, 10, shape[:-1])[..., None])
    v = v.astype(np.float32)
    v.reshape(-1, shape[-1])[3] = 0.0  # a zero row: scale 0, values 0
    gi, gs = quantize_rows_int8(_t(v), normalize=normalize)
    wi, ws = (np.asarray(a) for a in jax_quantize(jnp.asarray(v), normalize=normalize))
    assert gi.dtype == torch.int8 and tuple(gi.shape) == shape
    assert tuple(gs.shape) == shape[:-1] and gs.dtype == torch.float32
    diff = np.abs(gi.numpy().astype(np.int32) - wi.astype(np.int32))
    # normalize: an ulp of the row norm may move a value across .5
    assert diff.max() <= (1 if normalize else 0)
    assert (diff > 0).mean() <= 1e-3
    if normalize:
        # the two packages' f32 row norms differ by an ulp in about a third
        # of the rows (another summation order), which moves the scale of
        # the unit row by at most two ulps of f32
        np.testing.assert_array_max_ulp(gs.numpy(), ws, maxulp=2)
    else:
        np.testing.assert_array_equal(gs.numpy(), ws)
    assert (gi.numpy().reshape(-1, shape[-1])[3] == 0).all()
    assert gs.numpy().reshape(-1)[3] == 0.0
    # round half to even, as jnp.round: 2.5 -> 2, 3.5 -> 4 at scale 1
    half = _t(np.array([[127.0, 2.5, 3.5, -2.5, 0.5]], np.float32))
    np.testing.assert_array_equal(quantize_rows_int8(half)[0].numpy(),
                                  [[127, 2, 4, -2, 0]])


# (B, N, d, k, masked): k up to 1,024 (above the live row count in the last)
INT8_SHAPES = [(7, 1001, 40, 1, False), (13, 2999, 100, 10, True),
               (5, 1500, 64, 1024, True)]


def _int8_data(seed, b, n, d, masked, metric):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    ci, cs = (np.asarray(a) for a in jax_quantize(
        jnp.asarray(c), normalize=metric == "cosine"))
    valid = rng.random(n) < 0.7 if masked else None
    return q, c, ci, cs, valid


@pytest.mark.parametrize("metric", INT8_METRICS)
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "b{}_n{}_d{}_k{}".format(*s))
def test_flat_topk_int8_matches_jax_interpret(metric, shape):
    """The corpus rows and scales are carried across bit for bit."""
    b, n, d, k, masked = shape
    q, _, ci, cs, valid = _int8_data(sum(shape[:4]), b, n, d, masked, metric)
    wd, wi = jax_flat_topk_int8(
        jnp.asarray(q), jnp.asarray(ci), jnp.asarray(cs), k, metric=metric,
        corpus_valid=None if valid is None else jnp.asarray(valid),
        interpret=True,
    )
    gd, gi = flat_topk_int8(
        _t(q), _t(ci), _t(cs), k, metric=metric,
        corpus_valid=None if valid is None else _t(valid),
    )
    gd, gi, wd, wi = gd.numpy(), gi.numpy(), np.asarray(wd), np.asarray(wi)
    assert gd.shape == (b, k) and gi.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_array_equal(gi < 0, wi < 0)
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6, atol=1e-6)
    _assert_ids_equal_up_to_ties(gi, wi, _tiles(q, ci, cs, metric))
    if masked:
        assert valid[gi[gi >= 0]].all()
    if k > n * 0.7:
        live = int(valid.sum())
        assert (gi[:, live:] == -1).all() and np.isinf(gd[:, live:]).all()


@pytest.mark.parametrize("metric", INT8_METRICS)
def test_flat_topk_precision_int8_matches_jax(metric):
    """flat_topk(precision="int8") quantizes both sides per call."""
    q, c, ci, cs, valid = _int8_data(17, 11, 2000, 48, True, metric)
    wd, wi = jax_flat_topk(jnp.asarray(q), jnp.asarray(c), 10, metric=metric,
                           corpus_valid=jnp.asarray(valid), interpret=True,
                           precision="int8")
    gd, gi = flat_topk(_t(q), _t(c), 10, metric=metric,
                       corpus_valid=_t(valid), precision="int8")
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6, atol=1e-6)
    gci, gcs = quantize_rows_int8(_t(c), normalize=metric == "cosine")
    _assert_ids_equal_up_to_ties(gi.numpy(), np.asarray(wi),
                                 _tiles(q, gci.numpy(), gcs.numpy(), metric))


def test_int8_l2_raises_value_error():
    q, c = torch.zeros(2, 8), torch.ones(5, 8)
    ci, cs = quantize_rows_int8(c)
    with pytest.raises(ValueError, match="cosine/inner_product"):
        flat_topk_int8(q, ci, cs, 1, metric="l2")
    with pytest.raises(ValueError, match="cosine/inner_product"):
        flat_topk(q, c, 1, metric="l2", precision="int8")
    with pytest.raises(ValueError, match="cosine/inner_product"):
        flat_topk_proj_rescored(q, c, torch.eye(8), ci, cs, 1, metric="l2")
    with pytest.raises(ValueError, match="cosine/inner_product"):
        QuantizedFlatIndex(8, "l2", device="cpu")


def test_int8_zero_query_and_masked_rows():
    """An all-zero query has scale 0: live rows get distance ``base``,
    masked rows stay (inf, -1), never NaN."""
    c = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 8)).astype(np.float32))
    ci, cs = quantize_rows_int8(c, normalize=True)
    valid = torch.tensor([True, False, True, False, True, False])
    d, i = flat_topk_int8(torch.zeros(1, 8), ci, cs, 5, corpus_valid=valid)
    assert not torch.isnan(d).any()
    np.testing.assert_array_equal(d.numpy()[0], [1, 1, 1, np.inf, np.inf])
    assert sorted(i.numpy()[0, :3].tolist()) == [0, 2, 4]
    assert (i.numpy()[0, 3:] == -1).all()


@pytest.mark.parametrize("metric", INT8_METRICS)
def test_int8_rescored_matches_jax(metric):
    q, c, ci, cs, valid = _int8_data(23, 9, 1800, 64, True, metric)
    wd, wi = jax_int8_rescored(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ci),
                               jnp.asarray(cs), 10, r=24, metric=metric,
                               corpus_valid=jnp.asarray(valid), interpret=True)
    gd, gi = flat_topk_int8_rescored(_t(q), _t(c), _t(ci), _t(cs), 10, 24,
                                     metric=metric, corpus_valid=_t(valid))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)


def _low_rank_rows(rng, n, d, rank):
    """Rows near a ``rank``-d subspace with well-separated second moments."""
    core = rng.standard_normal((n, rank)).astype(np.float32)
    core *= np.linspace(3.0, 0.5, rank, dtype=np.float32)
    lift = np.linalg.qr(rng.standard_normal((d, rank)))[0].T.astype(np.float32)
    x = core @ lift + 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_proj_basis_orthonormal_and_equal_to_jax_up_to_sign():
    x = _low_rank_rows(np.random.default_rng(29), 700, 64, 12)
    g = proj_basis(_t(x), 10, chunk=256).numpy()
    w = np.asarray(jax_proj_basis(jnp.asarray(x), 10, chunk=256))
    assert g.shape == (64, 10) and g.dtype == np.float32
    np.testing.assert_allclose(g.T @ g, np.eye(10), atol=1e-5)
    np.testing.assert_allclose(np.abs(w.T @ g), np.eye(10), atol=1e-3)
    with pytest.raises(ValueError, match="proj dim"):
        proj_basis(_t(x), 0)


@pytest.mark.parametrize("metric", INT8_METRICS)
def test_proj_rescored_matches_jax_with_the_same_basis(metric):
    rng = np.random.default_rng(31)
    x = _low_rank_rows(rng, 1500, 64, 16)
    q = x[:20] + 0.05 * rng.standard_normal((20, 64)).astype(np.float32)
    valid = rng.random(1500) < 0.8
    w = np.asarray(jax_proj_basis(jnp.asarray(x), 24))
    pi, ps = (np.asarray(a) for a in jax_quantize(jnp.asarray(x @ w)))
    wd, wi = jax_proj_rescored(jnp.asarray(q), jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(pi), jnp.asarray(ps), 10, r=32,
                               metric=metric, corpus_valid=jnp.asarray(valid),
                               interpret=True)
    gd, gi = flat_topk_proj_rescored(_t(q), _t(x), _t(w), _t(pi), _t(ps), 10,
                                     32, metric=metric, corpus_valid=_t(valid))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)


def _recall(ids, truth):
    k = truth.shape[1]
    return np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / k
                    for a, b in zip(ids, truth)])


def _clustered(rng, n, d, centres, q_n):
    c = rng.standard_normal((centres, d)).astype(np.float32)
    x = c[rng.integers(0, centres, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:q_n] + 0.05 * rng.standard_normal((q_n, d)).astype(np.float32)
    return x, q


def _assert_exact_distances(ids, dist, tid, tdist):
    for a, da, b, db in zip(ids, dist, tid, tdist):
        theirs = dict(zip(b.tolist(), db.tolist()))
        for cid, dv in zip(a.tolist(), da.tolist()):
            if cid in theirs:
                assert abs(dv - theirs[cid]) < 1e-5


def test_flat_index_int8_rescored_mode():
    """``tests/test_flat_index.py:192-221``: recall against exact, exact
    distances for returned ids, deletes respected without a rebuild; and an
    insert drops the shadow."""
    rng = np.random.default_rng(37)
    n, d, k = 500, 64, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:32] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    exact = FlatIndex(d, "cosine", device="cpu")
    exact.insert(np.arange(n), x)
    tid, tdist = exact.search(q, k=k)
    idx = FlatIndex(d, "cosine", precision="int8_rescored", device="cpu")
    assert idx.rescore_r == 16
    idx.insert(np.arange(n), x)
    ids, dist = idx.search(q, k=k)
    assert _recall(ids, tid) >= 0.95
    _assert_exact_distances(ids, dist, tid, tdist)
    shadow = idx._i8
    assert shadow is not None and shadow[0].dtype == torch.int8
    idx.delete(tid[0][:3])
    ids2, _ = idx.search(q[:1], k=k)
    assert not (set(tid[0][:3]) & set(ids2[0]))
    assert idx._i8 is shadow  # a delete keeps the shadow
    idx.insert([n], x[:1])
    assert idx._i8 is None
    idx.search(q[:1], k=k)
    assert idx._i8[0].shape[0] == n + 1


def test_flat_index_proj_rescored_mode():
    """``tests/test_flat_index.py:340-389`` on the port."""
    rng = np.random.default_rng(41)
    n, d, k = 800, 96, 10
    x, q = _clustered(rng, n, d, 12, 32)
    exact = FlatIndex(d, "cosine", device="cpu")
    exact.insert(np.arange(n), x)
    tid, tdist = exact.search(q, k=k)
    idx = FlatIndex(d, "cosine", precision="proj_rescored", proj_dim=32,
                    device="cpu")
    assert idx.rescore_r == 32
    idx.insert(np.arange(n), x)
    idx.rescore_r = 48
    ids, dist = idx.search(q, k=k)
    assert _recall(ids, tid) >= 0.95
    _assert_exact_distances(ids, dist, tid, tdist)
    assert idx._proj is not None and idx._proj[0].shape == (d, 32)
    idx.insert([n], x[:1] * -1.0)
    assert idx._proj is None
    idx.search(q[:1], k=k)
    assert idx._proj is not None and idx._proj[1].shape[0] == n + 1
    idx.delete(tid[0][:3])
    ids2, _ = idx.search(q[:1], k=k)
    assert not (set(tid[0][:3]) & set(ids2[0]))
    bad = FlatIndex(d, "l2", precision="proj_rescored", device="cpu")
    bad.insert(np.arange(4), x[:4])
    with pytest.raises(ValueError, match="cosine/inner_product"):
        bad.search(q[:1], k=2)


def test_pick_rescore_r_mirrors_jax():
    """``tests/test_flat_index.py:224-249``, and the same result as JAX's
    helper on random candidate lists."""
    cand = np.array([[10, 11, 12, 13, 14, 15, 16, 17],
                     [20, 21, 22, 23, 24, 25, 26, 27]])
    true = np.array([[10, 11, 12], [20, 21, 27]])
    r, curve = pick_rescore_r(true, cand, (4, 8), target_recall=0.99)
    assert curve[4] == (3 / 3 + 2 / 3) / 2 and curve[8] == 1.0 and r == 8
    assert pick_rescore_r(true, cand, (4, 8), target_recall=0.80)[0] == 4
    r3, curve3 = pick_rescore_r(np.array([[99, 98, 97], [96, 95, 94]]), cand,
                                (4, 8), 0.5)
    assert r3 == 8 and curve3[8] == 0.0
    r4, curve4 = pick_rescore_r(np.array([[10, -1, -1], [20, -1, -1]]), cand,
                                (4,), 0.99)
    assert curve4[4] == 1.0 and r4 == 4
    rng = np.random.default_rng(43)
    for _ in range(5):
        cand = np.stack([rng.permutation(60)[:32] for _ in range(9)])
        true = np.stack([rng.permutation(60)[:5] for _ in range(9)])
        true[0, 3:] = -1
        ladder = (8, 12, 16, 24, 32)
        assert pick_rescore_r(true, cand, ladder, 0.6) == \
            jax_pick_rescore_r(true, cand, ladder, 0.6)


@pytest.mark.parametrize("precision", ["int8_rescored", "proj_rescored"])
def test_tune_rescore_r_matches_jax(precision):
    """The same seed gives the same r and the same curve as JAX. The
    projected mode runs on the JAX index's own basis, carried across."""
    rng = np.random.default_rng(47)
    n, d, k = 700, 64, 10
    x, _ = _clustered(rng, n, d, 8, 1)
    j = JaxFlatIndex(d, "cosine", precision=precision, proj_dim=24,
                     use_pallas=False)
    j.insert(np.arange(n), x)
    t = FlatIndex(d, "cosine", precision=precision, proj_dim=24, device="cpu")
    t.insert(np.arange(n), x)
    if precision == "proj_rescored":
        j.search(x[:1], k=k)  # builds JAX's basis
        t.set_proj_basis(np.asarray(j._proj[0]))
    jr = j.tune_rescore_r(k=k, target_recall=0.98, sample=96, seed=3)
    tr = t.tune_rescore_r(k=k, target_recall=0.98, sample=96, seed=3)
    assert tr == jr == t.rescore_r
    assert t.tune_report == j.tune_report
    rs = sorted(t.tune_report)
    assert all(t.tune_report[a] <= t.tune_report[b] for a, b in zip(rs, rs[1:]))
    with pytest.raises(ValueError, match="tune_rescore_r applies"):
        FlatIndex(d, "cosine", device="cpu").tune_rescore_r()


def test_quantized_flat_index():
    """``tests/test_flat_index.py:147-189`` on the port."""
    rng = np.random.default_rng(53)
    n, d, k = 3000, 48, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = v[rng.integers(0, n, 32)] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    exact = FlatIndex(d, "cosine", device="cpu")
    exact.insert(np.arange(n), v)
    ti, _ = exact.search(q, k=k)
    qi = QuantizedFlatIndex(d, "cosine", device="cpu")
    qi.insert(np.arange(n), v)
    assert qi.store.vectors.dtype == torch.int8
    assert qi.store.scales.dtype == torch.float32
    ids, dists = qi.search(q, k=k)
    assert _recall(ids, ti) >= 0.9
    assert np.all(np.diff(dists, axis=1) >= -1e-6)
    one_ids, _ = qi.search(q[0], k=3)
    assert one_ids.shape == (3,)
    top = int(one_ids[0])
    qi.delete([top])
    after, _ = qi.search(q[0], k=3)
    assert top not in set(after.tolist())
    assert len(qi) == n - 1
    qi.insert([], np.zeros((0, d), np.float32))  # a legal no-op
    # growth across the capacity boundary keeps the scales in step
    extra = rng.standard_normal((1200, d)).astype(np.float32)
    qi2 = QuantizedFlatIndex(d, "cosine", capacity=1024, device="cpu")
    qi2.insert(np.arange(600), extra[:600])
    qi2.insert(np.arange(600, 1200), extra[600:])
    assert qi2.store.capacity == 2048 and qi2.store.scales.shape == (2048,)
    ids2, _ = qi2.search(extra[7], k=1)
    assert int(ids2[0]) == 7
    ids3, _ = qi2.search(extra[1100], k=1)
    assert int(ids3[0]) == 1100


@pytest.mark.parametrize("metric", INT8_METRICS)
def test_quantized_flat_index_matches_jax(metric):
    rng = np.random.default_rng(59)
    n, d, k = 1500, 40, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = v[:15] + 0.1 * rng.standard_normal((15, d)).astype(np.float32)
    j = JaxQuantizedFlatIndex(d, metric, capacity=1024, use_pallas=False)
    t = QuantizedFlatIndex(d, metric, capacity=1024, device="cpu")
    for idx in (j, t):
        idx.insert(np.arange(n) + 7, v)
        idx.delete(np.arange(0, n, 9) + 7)
    wi, wd = j.search(q, k=k)
    gi, gd = t.search(q, k=k)
    np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-6, atol=1e-6)
    hw = t.store.high_watermark
    tiles = _tiles(q, t.store.vectors[:hw].numpy(), t.store.scales[:hw].numpy(),
                   metric)
    _assert_ids_equal_up_to_ties(t.store.slots_of(gi.reshape(-1)).reshape(gi.shape),
                                 t.store.slots_of(np.asarray(wi).reshape(-1)).reshape(gi.shape),
                                 tiles)


def test_quantized_carry_across_both_ways(tmp_path):
    """A JAX checkpoint's fields (``save_quantized``) build the port's
    index; the port's state loads back into JAX with ``load_quantized``;
    all three search alike."""
    rng = np.random.default_rng(61)
    n, d = 1300, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    j = JaxQuantizedFlatIndex(d, "inner_product", use_pallas=False)
    j.insert(np.arange(n) * 2, v)
    j.delete(np.arange(0, 2 * n, 14))
    save_quantized(j, tmp_path / "jax")
    state = dict(np.load(tmp_path / "jax" / "arrays.npz"))
    state.update(json.loads((tmp_path / "jax" / "manifest.json").read_text()))
    t = quantized_index_from_numpy(state, device="cpu")
    assert len(t) == len(j) and t.store.capacity == j.store.capacity
    wi, wd = j.search(q, k=8)
    ti, td = t.search(q, k=8)
    np.testing.assert_array_equal(ti, np.asarray(wi))
    np.testing.assert_array_equal(td, np.asarray(wd))
    back = quantized_index_to_numpy(t)
    for key in ("codes", "scales", "valid", "ids"):
        np.testing.assert_array_equal(back[key], state[key], err_msg=key)
    for key in ("dim", "metric", "high_watermark", "count"):
        assert back[key] == state[key], key
    # the port's state as a JAX checkpoint
    out = tmp_path / "port"
    out.mkdir()
    np.savez(out / "arrays.npz", **{key: back[key] for key in
                                    ("codes", "scales", "valid", "ids")})
    manifest = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    manifest.update({key: back[key] for key in
                     ("dim", "metric", "high_watermark", "count")})
    (out / "manifest.json").write_text(json.dumps(manifest))
    j2 = load_quantized(out)
    ji, jd = j2.search(q, k=8)
    np.testing.assert_array_equal(np.asarray(ji), ti)
    np.testing.assert_array_equal(np.asarray(jd), td)
    with pytest.raises(ValueError, match="valid"):
        quantized_index_from_numpy(dict(state, valid=~state["valid"]), device="cpu")


def test_flat_carry_keeps_proj_basis():
    """A carried ``proj`` basis gives the port JAX's projected shadow, and
    the state round-trips with its search settings."""
    rng = np.random.default_rng(67)
    x, q = _clustered(rng, 900, 48, 10, 12)
    j = JaxFlatIndex(48, "cosine", precision="proj_rescored", proj_dim=16,
                     use_pallas=False)
    j.insert(np.arange(900), x)
    wi, wd = j.search(q, k=10)
    hw = j.store.high_watermark
    state = {"dim": 48, "metric": "cosine", "precision": "proj_rescored",
             "proj_dim": 16, "rescore_r": j.rescore_r,
             "vectors": np.asarray(j.store.vectors[:hw]),
             "valid": np.asarray(j.store.valid[:hw]),
             "id_of": j.store._id_of[:hw].copy(),
             "proj": np.asarray(j._proj[0])}
    t = flat_index_from_numpy(state, device="cpu")
    np.testing.assert_array_equal(t._proj[1].numpy(), np.asarray(j._proj[1]))
    ti, td = t.search(q, k=10)
    np.testing.assert_array_equal(ti, wi)
    np.testing.assert_allclose(td, wd, rtol=1e-5, atol=1e-6)
    back = flat_index_to_numpy(t)
    np.testing.assert_array_equal(back["proj"], state["proj"])
    assert (back["precision"], back["proj_dim"], back["rescore_r"]) == \
        ("proj_rescored", 16, j.rescore_r)


@pytest.mark.parametrize("precision", ["int8_rescored", "proj_rescored"])
def test_index_search_is_the_ops_two_tier_search(precision):
    """``FlatIndex.search_device`` and ``tune_rescore_r`` share one
    retrieve; the index's search equals the ops two-tier function on the
    index's own shadow, bit for bit."""
    rng = np.random.default_rng(71)
    x, q = _clustered(rng, 1500, 32, 12, 20)
    t = FlatIndex(32, "cosine", device="cpu", precision=precision, proj_dim=8)
    t.insert(np.arange(1500), x)
    t.delete(np.arange(0, 1500, 11))
    gd, gi = t.search_device(q, 10)
    hw, corpus, valid = t._live()
    qt = _t(q)
    if precision == "int8_rescored":
        vi, sc = t._i8
        wd, wi = flat_topk_int8_rescored(qt, corpus, vi, sc, 10, t.rescore_r,
                                         metric="cosine", corpus_valid=valid)
    else:
        w, vi, sc = t._proj
        wd, wi = flat_topk_proj_rescored(qt, corpus, w, vi, sc, 10, t.rescore_r,
                                         metric="cosine", corpus_valid=valid)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def test_int8_launcher_refuses_cpu_tensors():
    q = torch.zeros(2, 8)
    ci, cs = quantize_rows_int8(torch.ones(5, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_topk_int8_cuda(q, ci, cs, 3)
    with pytest.raises(ValueError, match="k <= 1024"):
        flat_topk_int8_cuda(q, ci, cs, 1025)
    assert _build.LAUNCHES["flat_topk_int8"] == 0


DEFAULT_DEVICE_CASES = {
    "FlatIndex": lambda: FlatIndex(8, "cosine"),
    "QuantizedFlatIndex": lambda: QuantizedFlatIndex(8),
    "HnswIndex": lambda: __import__("muninn_tpu_torch").HnswIndex(8),
    "VectorStore": lambda: __import__(
        "muninn_tpu_torch.index.store", fromlist=["VectorStore"]).VectorStore(8),
    "flat_index_from_numpy": lambda: flat_index_from_numpy({
        "dim": 2, "metric": "l2", "vectors": np.zeros((1, 2), np.float32),
        "valid": np.array([True]), "id_of": np.array([3])}),
    "quantized_index_from_numpy": lambda: quantized_index_from_numpy({
        "codes": np.zeros((4, 2), np.int8), "scales": np.zeros(4, np.float32),
        "valid": np.zeros(4, bool), "ids": np.full(4, -1), "dim": 2,
        "metric": "cosine", "high_watermark": 0, "count": 0}),
}


@pytest.mark.parametrize("make", list(DEFAULT_DEVICE_CASES))
def test_default_device_is_the_card(make):
    """Without ``device``, an index lands on the card; without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default lands on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DEFAULT_DEVICE_CASES[make]()


@pytest.mark.parametrize("k", [0, 1025])
def test_int8_launcher_refuses_k_before_a_launch(k):
    ci, cs = quantize_rows_int8(torch.ones(5, 8))
    with pytest.raises(ValueError, match="k <= 1024"):
        flat_topk_int8_cuda(torch.zeros(2, 8), ci, cs, k)
    assert _build.LAUNCHES["flat_topk_int8"] == _build.LAUNCHES["flat_topk_mma"] == 0


@pytest.mark.parametrize("corpus", [torch.ones(5, 8), torch.ones(5, 8, dtype=torch.int16),
                                    torch.ones(8, 5, dtype=torch.int8).T])
def test_int8_launcher_refuses_a_corpus_it_cannot_read_in_place(corpus):
    """A corpus of another type, or strided, raises before the device is
    looked at: the kernel reads the int8 rows in place."""
    with pytest.raises(ValueError, match="contiguous int8 corpus"):
        flat_topk_int8_cuda(torch.zeros(2, 8), corpus, torch.ones(5), 3)
    assert _build.LAUNCHES["flat_topk_int8"] == _build.LAUNCHES["flat_topk_mma"] == 0
