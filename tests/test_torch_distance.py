"""muninn_tpu_torch.ops.distance against muninn_tpu.ops.distance on the CPU:
the same seeded numpy inputs through both packages."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.ops import distance as jd
from muninn_tpu_torch.ops import distance as td

METRICS = ["l2", "cosine", "inner_product"]


def test_metric_values_match():
    assert [m.value for m in td.Metric] == [m.value for m in jd.Metric]


@pytest.mark.parametrize("name", METRICS)
def test_parse_metric_names(name):
    assert td.parse_metric(name).value == jd.parse_metric(name).value
    assert td.parse_metric(td.Metric(name)) is td.Metric(name)


def test_parse_metric_bad_name_same_error():
    with pytest.raises(ValueError) as jax_err:
        jd.parse_metric("euclidean")
    with pytest.raises(ValueError) as torch_err:
        td.parse_metric("euclidean")
    assert str(torch_err.value) == str(jax_err.value)


# (B, N, d) with nothing a multiple of anything
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(7, 19, 33), (13, 101, 96)])
def test_pairwise_distances_match_jax(metric, shape):
    b, n, d = shape
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    want = np.asarray(
        jd.pairwise_distances(jnp.asarray(q), jnp.asarray(c), jd.Metric(metric))
    )
    got = td.pairwise_distances(torch.from_numpy(q), torch.from_numpy(c),
                                metric).numpy()
    # both are f32 products, summed in another order by another BLAS: a few
    # ulps of the operands' magnitude apart
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_squared_norms_match_jax():
    x = np.random.default_rng(5).standard_normal((11, 40)).astype(np.float32)
    np.testing.assert_allclose(
        td.squared_norms(torch.from_numpy(x)).numpy(),
        np.asarray(jd.squared_norms(jnp.asarray(x))),
        rtol=1e-6,
    )


def test_l2_self_distance_clamped_at_zero():
    x = np.random.default_rng(6).standard_normal((5, 16)).astype(np.float32)
    got = td.pairwise_distances(torch.from_numpy(x), torch.from_numpy(x), "l2")
    want = np.asarray(jd.pairwise_distances(jnp.asarray(x), jnp.asarray(x),
                                            jd.Metric.L2))
    assert (got.numpy() >= 0).all()
    np.testing.assert_allclose(np.diag(got.numpy()), np.diag(want), atol=1e-5)


def test_cosine_zero_vector_guard_matches_jax():
    q = np.zeros((1, 8), np.float32)
    c = np.ones((2, 8), np.float32)
    got = td.pairwise_distances(torch.from_numpy(q), torch.from_numpy(c),
                                "cosine").numpy()
    want = np.asarray(jd.pairwise_distances(jnp.asarray(q), jnp.asarray(c),
                                            jd.Metric.COSINE))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, 1.0)


# (B, C, d) with nothing aligned; candidates in f32 and in bf16 as the beam
# gathers them
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(5, 17, 33), (9, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathered_distances_match_jax(metric, shape, dtype):
    b, c, d = shape
    rng = np.random.default_rng(sum(shape))
    # unit-norm rows, the scale of the embeddings the beam scores
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cand = rng.standard_normal((b, c, d)).astype(np.float32)
    cand /= np.linalg.norm(cand, axis=-1, keepdims=True)
    cand[0, 0] = 0.0   # cosine: the zero-norm guard
    cand[1, 1] = q[1]  # l2: an exact match, clamped at 0
    tc = torch.from_numpy(cand).to(getattr(torch, dtype))
    want = np.asarray(jd.gathered_distances(
        jnp.asarray(q), jnp.asarray(tc.float().numpy()), jd.Metric(metric)))
    got = td.gathered_distances(torch.from_numpy(q), tc, metric).numpy()
    assert got.shape == (b, c) and got.dtype == np.float32
    # the same f32 products summed in another order: a few ulps of terms
    # of magnitude ~1 apart
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if metric == "l2":
        assert (got >= 0).all()


@pytest.mark.parametrize("eps", [1e-12, 0.5])
def test_normalize_rows_matches_jax(eps):
    """Gaussian rows, a zero row and rows below ``eps`` in norm; leading
    axes pass through."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 6, 20)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 2] *= 1e-3
    want = np.asarray(jd.normalize_rows(jnp.asarray(x), eps))
    got = td.normalize_rows(torch.from_numpy(x), eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[0, 0], 0.0)
