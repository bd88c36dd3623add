"""muninn_tpu_torch.ops.beam.gather_block_topm against muninn_tpu's on the
CPU.

The same seeded numpy inputs go through ``gather_block_topm_plain`` and the
Pallas kernel in interpret mode (as ``tests/test_hnsw.py:413-508`` runs it),
and the port's top-m beam against its dots beam
(``tests/test_hnsw.py:511-545``).
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.ops.distance import Metric as JaxMetric
from muninn_tpu.ops.pallas_beam import gather_block_topm as jax_gather_block_topm
from muninn_tpu_torch.index.hnsw import _beam_search_level0
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.beam import (
    BIG,
    gather_block_topm,
    gather_block_topm_cuda,
)
from muninn_tpu_torch.ops.distance import Metric

METRICS = ["l2", "cosine", "inner_product"]


def _inputs(seed, n=256, d=128, r0=8, e=3, b=16):
    """``tests/test_hnsw.py:413-427``: Gaussian blocks and queries, random
    picks, 25% of lanes penalised by 3e38."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, r0, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, e)).astype(np.int32)
    pen = np.where(rng.random((b, e * r0)) < 0.25, 3.0e38, 0.0).astype(np.float32)
    return x, q, idx, pen


def _jax(q, idx, x, pen, metric, m):
    md, ml = jax_gather_block_topm(
        jnp.asarray(q), jnp.asarray(idx), jnp.asarray(x), jnp.asarray(pen),
        metric=JaxMetric(metric), m=m, interpret=True,
    )
    return np.asarray(md), np.asarray(ml)


def _port(q, idx, x, pen, metric, m):
    md, ml = gather_block_topm(torch.from_numpy(q), torch.from_numpy(idx),
                               torch.from_numpy(x), torch.from_numpy(pen),
                               metric, m)
    assert md.dtype == torch.float32 and ml.dtype == torch.int32
    return md.numpy(), ml.numpy()


@pytest.mark.parametrize("metric", METRICS)
def test_topm_plain_matches_jax_kernel(metric):
    """Distances within 1e-5 relative (the same f32 products summed in
    another order; masked entries sit at 3e38, where 1e-5 relative is the
    f32 ulp scale); local indices equal wherever the distance is below
    BIG/2, except at near-ties of the float64 distances (within 1e-5)."""
    x, q, idx, pen = _inputs(5)
    m = 5
    jd, jl = _jax(q, idx, x, pen, metric, m)
    td, tl = _port(q, idx, x, pen, metric, m)
    assert td.shape == tl.shape == (16, 3, m)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    assert np.all(td[:, :, 1:] >= td[:, :, :-1])
    real = td < BIG / 2
    differ = real & (tl != jl)
    if differ.any():
        # a swap is allowed only between rows whose float64 distances tie
        blocks = x.astype(np.float64)[idx]               # [b, e, r0, d]
        dots = np.einsum("bd,berd->ber", q.astype(np.float64), blocks)
        cn2 = (blocks ** 2).sum(-1)
        qn2 = (q.astype(np.float64) ** 2).sum(-1)[:, None, None]
        ref = {"inner_product": -dots, "l2": np.maximum(qn2 + cn2 - 2 * dots, 0),
               "cosine": 1 - dots / np.sqrt(qn2 * cn2)}[metric]
        a = np.take_along_axis(ref, tl.astype(np.int64), axis=2)[differ]
        c = np.take_along_axis(ref, jl.astype(np.int64), axis=2)[differ]
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
    assert differ.mean() <= 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topm_plain_matches_jax_kernel_at_m_r0_and_bf16(dtype):
    """m = R0 (every candidate kept) and m = 1 on bf16 and f32 blocks with
    R0 = 16 (the bf16 TPU tile): distances within 1e-5, indices equal below
    BIG/2 in at least 99% of entries."""
    x, q, idx, pen = _inputs(6, r0=16, e=4, b=12)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for m in (1, 16):
        jd, jl = jax_gather_block_topm(
            jnp.asarray(q), jnp.asarray(idx), xj, jnp.asarray(pen),
            metric=JaxMetric.COSINE, m=m, interpret=True,
        )
        td, tl = gather_block_topm(torch.from_numpy(q), torch.from_numpy(idx),
                                   xt, torch.from_numpy(pen), "cosine", m)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
        real = td.numpy() < BIG / 2
        assert (tl.numpy()[real] == np.asarray(jl)[real]).mean() >= 0.99


def test_topm_dead_picks_give_big_at_local_zero():
    """``tests/test_hnsw.py:458-508``: a dead pick (-1) reads no block and
    gives (BIG, 0); live picks are unchanged by their neighbours' deaths;
    the same against JAX's kernel."""
    rng = np.random.default_rng(9)
    n, d, r0, e, b, m = 128, 128, 8, 4, 16, 3
    x = rng.standard_normal((n, r0, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, e)).astype(np.int32)
    dead = rng.random((b, e)) < 0.4
    dead[0] = True
    dead[1] = False
    idx_dead = np.where(dead, -1, idx).astype(np.int32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    pen = np.zeros((b, e * r0), np.float32)
    ad, al = _port(q, idx, x, pen, "l2", m)
    sd, sl = _port(q, idx_dead, x, pen, "l2", m)
    np.testing.assert_array_equal(sd[~dead], ad[~dead])
    np.testing.assert_array_equal(sl[~dead], al[~dead])
    assert (sd[dead] == np.float32(BIG)).all() and (sl[dead] == 0).all()
    jd, jl = _jax(q, idx_dead, x, pen, "l2", m)
    np.testing.assert_allclose(sd, jd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sl[dead], jl[dead])


def test_topm_refuses_bad_input():
    q = torch.zeros(2, 8)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    blocks = torch.zeros(4, 5, 8)
    pen = torch.zeros(2, 15)
    with pytest.raises(ValueError, match=r"m=0 must be in \(0, R0=5\]"):
        gather_block_topm(q, idx, blocks, pen, "l2", 0)
    with pytest.raises(ValueError, match=r"m=6 must be in \(0, R0=5\]"):
        gather_block_topm(q, idx, blocks, pen, "l2", 6)
    with pytest.raises(ValueError, match="f32 or bf16 blocks"):
        gather_block_topm(q, idx, blocks.to(torch.int8), pen, "l2", 2)
    with pytest.raises(ValueError, match="packed dim 9 != query dim 8"):
        gather_block_topm(q, idx, torch.zeros(4, 5, 9), pen, "l2", 2)
    with pytest.raises(ValueError, match="penalty has shape"):
        gather_block_topm(q, idx, blocks, torch.zeros(2, 14), "l2", 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_block_topm_cuda(q, idx, blocks, pen, "l2", 2)
    assert _build.LAUNCHES["beam_topm"] == 0


def test_topm_plain_any_shape_against_float64():
    """No alignment limit in the port: d = 100, R0 = 5, m = 3 against a
    float64 reference of the epilogue and a stable sort (distances within
    1e-5 relative, indices equal)."""
    x, q, idx, pen = _inputs(12, n=20, d=100, r0=5, e=2, b=6)
    pen[:] = 0
    td, tl = _port(q, idx, x, pen, "l2", 3)
    blocks = x.astype(np.float64)[idx]
    want = ((blocks - q.astype(np.float64)[:, None, None, :]) ** 2).sum(-1)
    order = np.argsort(want, axis=2, kind="stable")[:, :, :3]
    np.testing.assert_allclose(td, np.take_along_axis(want, order, axis=2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl, order)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_topm_full_width_beam_equals_dots_beam(metric):
    """``tests/test_hnsw.py:511-545`` on the port: ``topm == R0`` keeps
    every candidate, so the beam equals the packed dots beam: the same slots
    in at least 97% of each beam on average, distances within 1e-5 (the two
    paths share the epilogue and differ only in where the top-m sorts)."""
    rng = np.random.default_rng(31)
    n, d, r0, ef = 512, 128, 16, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    nbrs = rng.integers(0, n, (n, r0)).astype(np.int32)
    q = x[:32] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    entry = rng.integers(0, n, (32, 4)).astype(np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(entry), torch.from_numpy(x),
            torch.from_numpy(nbrs), Metric(metric), ef)
    packed = torch.from_numpy(x[nbrs])
    bd, bi = _beam_search_level0(*args, expand=4, packed=packed)
    td, ti = _beam_search_level0(*args, expand=4, packed=packed, topm=r0)
    same = np.mean([len(set(a[a >= 0]) & set(c[c >= 0])) / max((a >= 0).sum(), 1)
                    for a, c in zip(bi.numpy(), ti.numpy())])
    assert same >= 0.97, same
    np.testing.assert_allclose(td.numpy(), bd.numpy(), rtol=1e-5, atol=1e-5)
    # a narrower top-m still finds most of the full beam
    _, ni = _beam_search_level0(*args, expand=4, packed=packed, topm=4)
    near = np.mean([len(set(a[a >= 0]) & set(c[c >= 0])) / max((a >= 0).sum(), 1)
                    for a, c in zip(bi.numpy(), ni.numpy())])
    assert near >= 0.8, near
