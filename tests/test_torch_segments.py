"""The port's ops/segments against numpy brute force and against
``muninn_tpu.ops.segments`` on the same arrays (CPU tensors).

Mirrors tests/test_segments.py case for case. JAX's
``test_seg_min_insufficient_passes_is_wrong_by_design`` pins the TPU
shift-doubling scan's short-pass artifact; the port's min is one
``scatter_reduce_`` and exact at any pass count, which its replacement
asserts.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.ops import segments as jseg
from muninn_tpu_torch.ops import segments
from muninn_tpu_torch.ops.segments import (
    bincount_chunked,
    n_passes_for,
    seg_ids,
    seg_max,
    seg_min,
    seg_positions,
    seg_positions_chunked,
    seg_reduce_chunked,
    seg_sum,
    seg_sum_chunked,
    spos_dtype_for,
)

INF = np.float32(np.inf)


def random_offsets(rng, v, e_pad, max_deg):
    """Offsets for v segments with degrees in [0, max_deg], total <=
    e_pad (rest is padding past the last segment)."""
    degs = rng.integers(0, max_deg + 1, v)
    while degs.sum() > e_pad:
        degs[rng.integers(0, v)] = 0
    off = np.zeros(v + 1, np.int32)
    off[1:] = np.cumsum(degs)
    return off


def brute(vals, off, op, identity):
    out = []
    for i in range(len(off) - 1):
        seg = vals[off[i]:off[i + 1]]
        out.append(op(seg) if len(seg) else identity)
    return np.asarray(out)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_min_max_match_brute(seed):
    r = np.random.default_rng(seed)
    v, e_pad, max_deg = 37, 256, 19
    off = random_offsets(r, v, e_pad, max_deg)
    vals = r.standard_normal(e_pad).astype(np.float32)
    spos = seg_positions(t(off), e_pad)
    npass = n_passes_for(max_deg)
    got_min = seg_min(t(vals), spos, t(off), INF, npass).numpy()
    got_max = seg_max(t(vals), spos, t(off), -INF, npass).numpy()
    np.testing.assert_allclose(got_min, brute(vals, off, np.min, INF))
    np.testing.assert_allclose(got_max, brute(vals, off, np.max, -INF))


def test_seg_min_int_identity(rng):
    """int32 values with an INT-style big identity (the BFS fixpoint
    shape) — empty segments come back as identity."""
    e_pad = 64
    off = np.array([0, 3, 3, 7, 7, 7, 20, 25, 40, 64, 64], np.int32)
    vals = rng.integers(0, 1000, e_pad).astype(np.int32)
    big = np.int32(2**30)
    spos = seg_positions(t(off), e_pad)
    got = seg_min(t(vals), spos, t(off), int(big), n_passes_for(24)).numpy()
    want = brute(vals, off, np.min, big)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert got[1] == big and got[3] == big and got[4] == big and got[9] == big


def test_seg_sum_matches_brute():
    v, e_pad, max_deg = 29, 2048, 40
    r = np.random.default_rng(7)
    off = random_offsets(r, v, e_pad, max_deg)
    vals = np.zeros(e_pad, np.float32)
    n_valid = off[-1]
    vals[:n_valid] = r.standard_normal(n_valid).astype(np.float32)  # pads 0
    got = seg_sum(t(vals), t(off)).numpy()
    want = brute(vals, off, np.sum, 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seg_sum_batched_leading_axis(rng):
    """seg_sum broadcasts over leading axes (Brandes runs batched
    sources through one call)."""
    off = np.array([0, 2, 5, 5, 8], np.int32)
    vals = rng.standard_normal((3, 8)).astype(np.float32)
    got = seg_sum(t(vals), t(off)).numpy()
    for b in range(3):
        np.testing.assert_allclose(
            got[b], brute(vals[b], off, np.sum, 0.0), rtol=1e-5, atol=1e-6
        )


def test_n_passes_boundaries():
    assert n_passes_for(1) == 1
    assert n_passes_for(2) == 1
    assert n_passes_for(3) == 2
    assert n_passes_for(1024) == 10
    assert n_passes_for(1025) == 11


def test_seg_min_exact_at_any_pass_count():
    """Replaces JAX's short-pass case: the port's min reduces every
    segment whole, so a pass count below log2(max segment) changes
    nothing (JAX's scan under-reduces there by design)."""
    e_pad = 64
    off = np.array([0, 64], np.int32)  # one segment of 64
    spos = seg_positions(t(off), e_pad)
    vals2 = np.full(64, 100.0, np.float32)
    vals2[1] = -5.0  # the min mid-segment
    for n_passes in (1, 2, n_passes_for(64)):
        got = seg_min(t(vals2), spos, t(off), INF, n_passes).numpy()
        assert got[0] == -5.0
    short = np.asarray(jseg.seg_min(jnp.asarray(vals2), jnp.asarray(spos.numpy()),
                                    jnp.asarray(off), INF, 1))
    assert short[0] != -5.0  # the JAX scan's artifact the port lacks


# ───────────── chunked forms ─────────────


@pytest.mark.parametrize("seed,chunk", [(0, 32), (1, 64), (2, 128)])
def test_seg_reduce_chunked_matches_one_shot(seed, chunk):
    """Chunk boundaries split segments arbitrarily; the per-chunk
    portions must combine to the exact one-shot reduction."""
    r = np.random.default_rng(seed)
    v, e_pad, max_deg = 53, 512, 37
    off = random_offsets(r, v, e_pad, max_deg)
    vals = r.integers(-1000, 1000, e_pad).astype(np.int32)
    npass = n_passes_for(max_deg)
    spos_c = seg_positions_chunked(t(off), e_pad, chunk, npass)
    valst = t(vals)
    got = seg_reduce_chunked(
        lambda cs: valst[cs:cs + chunk], spos_c, t(off), 2**30, npass,
        chunk, torch.minimum, torch.int32,
    ).numpy()
    want = brute(vals, off, np.min, np.int32(2**30))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,chunk", [(0, 32), (3, 256)])
def test_seg_sum_chunked_matches_brute(seed, chunk):
    r = np.random.default_rng(seed)
    v, e_pad, max_deg = 41, 512, 50
    off = random_offsets(r, v, e_pad, max_deg)
    vals = r.standard_normal(e_pad).astype(np.float32)
    vals[off[-1]:] = 0.0  # pads must contribute 0
    valst = t(vals)
    got = seg_sum_chunked(lambda cs: valst[cs:cs + chunk], t(off), e_pad,
                          chunk).numpy()
    want = brute(vals, off, np.sum, np.float32(0.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seg_positions_chunked_clips_exactly():
    """Clipped positions equal the exact ones wherever a >=shift test
    can distinguish them (values below the clip cap)."""
    r = np.random.default_rng(7)
    v, e_pad = 29, 256
    off = random_offsets(r, v, e_pad, 21)
    npass = n_passes_for(21)
    dt, cap = spos_dtype_for(npass)
    exact = seg_positions(t(off), e_pad).numpy()
    got = seg_positions_chunked(t(off), e_pad, 32, npass)
    np.testing.assert_array_equal(got.numpy(),
                                  np.minimum(exact, cap).astype(got.numpy().dtype))
    assert got.dtype == dt


def test_bincount_chunked_matches_numpy():
    for seed in (0, 1):
        r = np.random.default_rng(seed)
        e_pad, nb = 512, 37
        ids = r.integers(0, nb + 1, e_pad).astype(np.int32)  # nb = pad
        w = r.random(e_pad).astype(np.float32)
        live = ids < nb
        got_u = bincount_chunked(t(ids), None, nb, 64).numpy()
        want_u = np.bincount(ids[live], minlength=nb).astype(np.float32)
        np.testing.assert_allclose(got_u, want_u)
        got_w = bincount_chunked(t(ids), t(w), nb, 64).numpy()
        want_w = np.bincount(ids[live], weights=w[live], minlength=nb)
        np.testing.assert_allclose(got_w, want_w, rtol=1e-5, atol=1e-5)


def test_chunked_reducers_reject_ragged_tail():
    """A chunk that does not divide e_pad would silently drop the tail;
    the guard must reject it instead."""
    off = t(np.array([0, 3, 100], np.int32))
    vals = torch.zeros(100)
    ids = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError):
        bincount_chunked(ids, None, 2, 48)
    with pytest.raises(ValueError):
        seg_sum_chunked(lambda c: vals[c:c + 48], off, 100, 48)
    with pytest.raises(ValueError):
        seg_positions_chunked(off, 100, 48, 4)


# ───────────── against muninn_tpu.ops.segments ─────────────


@pytest.mark.parametrize("seed", [0, 1])
def test_one_shot_forms_match_jax(seed):
    """seg_positions, seg_min/seg_max (float and int32) and seg_sum on the
    same arrays: positions and min/max equal, sums within f32 rounding."""
    r = np.random.default_rng(seed)
    v, e_pad, max_deg = 61, 1024, 30
    off = random_offsets(r, v, e_pad, max_deg)
    npass = n_passes_for(max_deg)
    jspos = jseg.seg_positions(jnp.asarray(off), e_pad)
    spos = seg_positions(t(off), e_pad)
    np.testing.assert_array_equal(spos.numpy(), np.asarray(jspos))
    f = r.standard_normal(e_pad).astype(np.float32)
    i = r.integers(-2**30, 2**30, e_pad).astype(np.int32)
    for vals, lo, hi in ((f, INF, -INF), (i, 2**30, -2**30)):
        for fn, jfn, ident in ((seg_min, jseg.seg_min, lo),
                               (seg_max, jseg.seg_max, hi)):
            want = np.asarray(jfn(jnp.asarray(vals), jspos, jnp.asarray(off),
                                  ident, npass))
            got = fn(t(vals), spos, t(off), ident, npass).numpy()
            np.testing.assert_array_equal(got, want)
    f[off[-1]:] = 0.0
    np.testing.assert_allclose(
        seg_sum(t(f), t(off)).numpy(),
        np.asarray(jseg.seg_sum(jnp.asarray(f), jnp.asarray(off))),
        rtol=1e-5, atol=1e-5)


def test_chunked_forms_match_jax():
    """The chunked positions, min, sum and bincount on JAX's own inputs."""
    import jax

    r = np.random.default_rng(5)
    v, e_pad, max_deg, chunk = 47, 512, 33, 64
    off = random_offsets(r, v, e_pad, max_deg)
    npass = n_passes_for(max_deg)
    ids = r.integers(0, v + 1, e_pad).astype(np.int32)
    w = r.random(e_pad).astype(np.float32)
    vals = r.integers(-500, 500, e_pad).astype(np.int32)
    f = r.standard_normal(e_pad).astype(np.float32)
    f[off[-1]:] = 0.0
    jo = jnp.asarray(off)
    np.testing.assert_array_equal(
        seg_positions_chunked(t(off), e_pad, chunk, npass).numpy(),
        np.asarray(jseg.seg_positions_chunked(jo, e_pad, chunk, npass)))
    jv, vt = jnp.asarray(vals), t(vals)
    want = jseg.seg_reduce_chunked(
        lambda c: jax.lax.dynamic_slice(jv, (c,), (chunk,)),
        jseg.seg_positions_chunked(jo, e_pad, chunk, npass), jo,
        np.int32(2**30), npass, chunk, jnp.minimum, jnp.int32)
    got = seg_reduce_chunked(
        lambda c: vt[c:c + chunk], seg_positions_chunked(t(off), e_pad, chunk,
                                                         npass),
        t(off), 2**30, npass, chunk, torch.minimum, torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jf, ft = jnp.asarray(f), t(f)
    np.testing.assert_allclose(
        seg_sum_chunked(lambda c: ft[c:c + chunk], t(off), e_pad, chunk).numpy(),
        np.asarray(jseg.seg_sum_chunked(
            lambda c: jax.lax.dynamic_slice(jf, (c,), (chunk,)), jo, e_pad,
            chunk)),
        rtol=1e-5, atol=1e-5)
    for wt, jw in ((None, None), (t(w), jnp.asarray(w))):
        np.testing.assert_allclose(
            bincount_chunked(t(ids), wt, v, chunk).numpy(),
            np.asarray(jseg.bincount_chunked(jnp.asarray(ids), jw, v, chunk)),
            rtol=1e-5, atol=1e-5)


def test_seg_ids_cover_the_rows():
    """seg_ids gives each covered position its row, and no id past the
    rows' edges: the padding takes no part in a reduction."""
    off = np.array([0, 2, 2, 5, 9], np.int32)
    np.testing.assert_array_equal(seg_ids(t(off)).numpy(),
                                  [0, 0, 2, 2, 2, 3, 3, 3, 3])
    assert seg_ids(t(np.zeros(4, np.int32))).numel() == 0


def test_seg_sum_long_rows_scan_row_by_row(monkeypatch):
    """Rows of at least LONG_ROW take one 1-D scan each; the sums are the
    batched scan's."""
    r = np.random.default_rng(3)
    vals = torch.from_numpy(r.standard_normal((3, 2, 50)).astype(np.float32))
    offsets = torch.tensor([0, 7, 7, 30, 50], dtype=torch.int32)
    want = seg_sum(vals, offsets)
    monkeypatch.setattr(segments, "LONG_ROW", 50)
    np.testing.assert_array_equal(seg_sum(vals, offsets).numpy(), want.numpy())
