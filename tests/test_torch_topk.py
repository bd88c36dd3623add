"""muninn_tpu_torch.ops.topk against muninn_tpu.ops.topk on the CPU: the same
seeded numpy inputs through both packages. Top-k and merges only move
values, so results must be equal, not close."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.ops import topk as jt
from muninn_tpu_torch.ops import topk as tt


def _both_masked(d, k, mask=None, ids=None):
    want = jt.masked_topk(
        jnp.asarray(d), k,
        mask=None if mask is None else jnp.asarray(mask),
        ids=None if ids is None else jnp.asarray(ids),
    )
    got = tt.masked_topk(
        torch.from_numpy(d), k,
        mask=None if mask is None else torch.from_numpy(mask),
        ids=None if ids is None else torch.from_numpy(ids),
    )
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize(
    "b,n,k,masked,with_ids",
    [(3, 20, 5, False, False), (2, 10, 5, True, False), (1, 4, 8, False, False),
     (4, 37, 37, True, True), (2, 6, 3, False, True), (5, 50, 64, True, False)],
)
def test_masked_topk_matches_jax(b, n, k, masked, with_ids):
    rng = np.random.default_rng(b * 100 + n)
    d = rng.standard_normal((b, n)).astype(np.float32)
    mask = rng.random((b, n)) < 0.6 if masked else None
    ids = (rng.permutation(1000)[:n] + 10).astype(np.int32)[None, :] if with_ids else None
    (wd, wi), (gd, gi) = _both_masked(d, k, mask, ids)
    assert gd.shape == (b, k) and gi.dtype == np.int32
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


def _both_merge(da, ia, db, ib):
    want = jt.merge_topk(*(jnp.asarray(x) for x in (da, ia, db, ib)))
    got = tt.merge_topk(*(torch.from_numpy(x) for x in (da, ia, db, ib)))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_merge_topk_dedups_like_jax():
    da = np.array([[1.0, 3.0, 5.0]], np.float32)
    ia = np.array([[1, 3, 5]], np.int32)
    db = np.array([[2.0, 3.0, 9.0]], np.float32)
    ib = np.array([[2, 3, 9]], np.int32)  # id 3 in both
    (wd, wi), (gd, gi) = _both_merge(da, ia, db, ib)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi[0], [1, 2, 3])


def test_merge_topk_invalid_slots_like_jax():
    da = np.array([[1.0, np.inf]], np.float32)
    ia = np.array([[4, -1]], np.int32)
    db = np.array([[0.5, np.inf]], np.float32)
    ib = np.array([[7, -1]], np.int32)
    (wd, wi), (gd, gi) = _both_merge(da, ia, db, ib)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("seed", range(6))
def test_merge_topk_random_matches_jax(seed):
    """Random widths, duplicate ids with distinct distances, and (inf, -1)
    padding."""
    rng = np.random.default_rng(seed)
    b, ka, kb = 3, int(rng.integers(1, 12)), int(rng.integers(1, 12))
    da = np.sort(rng.standard_normal((b, ka)).astype(np.float32), axis=1)
    db = np.sort(rng.standard_normal((b, kb)).astype(np.float32), axis=1)
    ia = rng.integers(-1, 8, (b, ka)).astype(np.int32)
    ib = rng.integers(-1, 8, (b, kb)).astype(np.int32)
    da = np.where(ia < 0, np.inf, da).astype(np.float32)
    db = np.where(ib < 0, np.inf, db).astype(np.float32)
    (wd, wi), (gd, gi) = _both_merge(da, ia, db, ib)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [3, 12, 40])
def test_sorted_topk_unique_matches_jax(seed, k):
    """Duplicate ids with distinct distances, (inf, -1) slots, and k above
    the candidate count (width 24): the tail is padded with (inf, -1)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((4, 24)).astype(np.float32)
    i = rng.integers(-1, 15, (4, 24)).astype(np.int32)
    d = np.where(i < 0, np.inf, d).astype(np.float32)
    wd, wi = jt.sorted_topk_unique(jnp.asarray(d), jnp.asarray(i), k)
    gd, gi = tt.sorted_topk_unique(torch.from_numpy(d), torch.from_numpy(i), k)
    assert gd.shape == (4, k) and gi.dtype == torch.int32
    # only moves values: equal, not close (rtol=atol=1e-5 would also hold)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if k > 24:
        assert np.isinf(gd.numpy()[:, 24:]).all() and (gi.numpy()[:, 24:] == -1).all()


def _both_flagged(da, ia, fa, db, ib, fb):
    want = jt.merge_topk_flagged(*(jnp.asarray(x) for x in (da, ia, fa, db, ib, fb)))
    got = tt.merge_topk_flagged(*(torch.from_numpy(x) for x in (da, ia, fa, db, ib, fb)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


def test_merge_topk_flagged_true_flag_wins_like_jax():
    """Of a duplicated id, the flagged occurrence survives even where the
    unflagged one is closer; flags ride with their entries."""
    da = np.array([[1.0, 2.0, 4.0]], np.float32)
    ia = np.array([[7, 3, 5]], np.int32)
    fa = np.array([[False, False, True]])
    db = np.array([[2.5, 3.0, 4.0]], np.float32)
    ib = np.array([[3, 5, 9]], np.int32)   # 3 flagged here only; 5 unflagged
    fb = np.array([[True, False, False]])
    d, i, f = _both_flagged(da, ia, fa, db, ib, fb)
    np.testing.assert_array_equal(i[0], [7, 3, 5])
    np.testing.assert_array_equal(d[0], [1.0, 2.5, 4.0])
    np.testing.assert_array_equal(f[0], [False, True, True])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_topk_flagged_random_matches_jax(seed):
    """Duplicated ids, integer distances (ties everywhere), -1 slots and
    random flags: every output equal to JAX's."""
    rng = np.random.default_rng(seed)
    b, ka, kb = 4, 9, 12
    da = np.sort(rng.integers(0, 6, (b, ka)).astype(np.float32), axis=1)
    db = np.sort(rng.integers(0, 6, (b, kb)).astype(np.float32), axis=1)
    ia = rng.integers(-1, 10, (b, ka)).astype(np.int32)
    ib = rng.integers(-1, 10, (b, kb)).astype(np.int32)
    da[ia < 0] = np.inf
    db[ib < 0] = np.inf
    fa, fb = rng.random((b, ka)) < 0.5, rng.random((b, kb)) < 0.5
    d, i, _ = _both_flagged(da, ia, fa, db, ib, fb)
    assert d.shape == (b, ka)
    live = i[i >= 0]
    assert len(live) == len(set(zip(np.nonzero(i >= 0)[0], live)))


@pytest.mark.parametrize("seed", [0, 1])
def test_smallest_k_select_matches_the_sort_and_jax(seed):
    """Integer values (ties across the k-th value in most rows), inf
    entries and rows with fewer than k finite ones: the values and
    positions of a stable sort, which are ``lax.top_k``'s of the negated
    rows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 12, (64, 300)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.inf
    x[5, 3:] = np.inf
    for k in (1, 7, 40, 300):
        gv, gp = tt.smallest_k_select(torch.from_numpy(x), k)
        sv, sp = tt.smallest_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), sv.numpy())
        np.testing.assert_array_equal(gp.numpy(), sp.numpy())
        jv, jp = jax.lax.top_k(-jnp.asarray(x), k)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(gv.numpy(), -np.asarray(jv))
