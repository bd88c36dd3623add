"""muninn_tpu_torch.ops.beam_loop against muninn_tpu's whole-beam kernel on
the CPU.

The same seeded numpy inputs go through ``beam_loop_plain`` and the Pallas
``beam_loop`` in interpret mode (as ``tests/test_beam_loop.py`` runs it,
over JAX's ``pack_wide`` table and either pick transfer): integer-grid
vectors (every dot and squared norm exact in f32) give bit-equal slots,
Gaussian rows give the same beams up to float noise at near-ties, and the
plain loop equals the port's own fused beam (``_beam_search_level0`` over
packed blocks).
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.ops.distance import Metric as JaxMetric
from muninn_tpu.ops.pallas_beam_loop import beam_loop as jax_beam_loop
from muninn_tpu.ops.pallas_beam_loop import pack_wide as jax_pack_wide
from muninn_tpu.index.hnsw import _beam_search_level0 as jax_beam
from muninn_tpu_torch.index.hnsw import _beam_search_level0
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops import beam_loop as beam_loop_mod
from muninn_tpu_torch.ops.beam_loop import (
    MAX_CANDIDATES,
    MAX_EF,
    beam_loop,
    beam_loop_cuda,
    beam_loop_plain,
)
from muninn_tpu_torch.ops.distance import Metric, gathered_distances

METRICS = ["l2", "cosine", "inner_product"]


def _grid(rng, shape):
    """``tests/test_beam_loop.py:203-206``: multiples of 1/4 in [-1, 1], no
    all-zero row; exact in bf16, and every dot and squared norm of two such
    rows at d = 128 is exact in f32."""
    v = rng.integers(-4, 5, shape).astype(np.float32) / 4.0
    v[np.abs(v).sum(axis=-1) == 0, 0] = 1.0
    return v


def _init_beam(q, entries, v16, metric, ef):
    """Entry distances from the bf16 rows, +inf / -1 padded to ef
    (``hnsw.py:508-516``)."""
    b, r = entries.shape
    e_d = gathered_distances(torch.from_numpy(q),
                             v16[torch.from_numpy(entries).clamp(min=0).long()].float(),
                             metric).numpy()
    init_d = np.full((b, ef), np.inf, np.float32)
    init_i = np.full((b, ef), -1, np.int32)
    init_d[:, :r] = np.where(entries >= 0, e_d, np.inf)
    init_i[:, :r] = entries
    return init_d, init_i


@pytest.mark.parametrize("trial", range(4))
def test_beam_loop_bit_equal_to_jax_and_fused_beam_on_grid(trial):
    """``tests/test_beam_loop.py:186-240``'s recipe, random geometry per
    trial over the three metrics (the last runs the default max_iters, so
    most queries stop early): slots bit-equal to JAX's kernel and to the
    port's fused beam; distances within 1e-6 (exact on l2 and inner
    product; cosine takes the same correctly rounded sqrt and divide)."""
    rng = np.random.default_rng(23 + trial)
    d, r0 = 128, 16
    cap = int(rng.integers(96, 400))
    b = int(rng.integers(1, 40))
    ef = int(rng.integers(4, 25))
    expand = int(rng.integers(1, 7))
    patience = int(rng.integers(1, 16))
    mi = int(rng.integers(1, 8)) if trial < 3 else 0
    metric = METRICS[trial % 3]
    xfer = ["dma", "scalar"][trial % 2]
    r_ent = int(rng.integers(1, min(6, ef) + 1))
    vecs = _grid(rng, (cap, d))
    nbrs = rng.integers(-1, cap, (cap, r0)).astype(np.int32)
    q = _grid(rng, (b, d))
    entries = rng.integers(0, cap, (b, r_ent)).astype(np.int32)
    entries[rng.random((b, r_ent)) < 0.1] = -1

    v16 = torch.from_numpy(vecs).bfloat16()
    init_d, init_i = _init_beam(q, entries, v16, metric, ef)
    jd, ji = jax_beam_loop(
        jnp.asarray(q), jnp.asarray(init_d), jnp.asarray(init_i),
        jax_pack_wide(jnp.asarray(vecs, jnp.bfloat16), jnp.asarray(nbrs)),
        metric=JaxMetric(metric), ef=ef, expand=expand, patience=patience,
        max_iters=mi, interpret=True, pick_xfer=xfer,
    )
    packed = v16[torch.from_numpy(nbrs).clamp(min=0).long()]
    td, ti, n_exp, fresh = beam_loop_plain(
        torch.from_numpy(q), torch.from_numpy(init_d), torch.from_numpy(init_i),
        packed, torch.from_numpy(nbrs), metric, ef, expand, patience, mi)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(np.nan_to_num(td.numpy(), posinf=1e38),
                               np.nan_to_num(np.asarray(jd), posinf=1e38),
                               rtol=1e-6, atol=1e-6)
    assert 0 < fresh <= n_exp * r0
    fd, fi = _beam_search_level0(
        torch.from_numpy(q), torch.from_numpy(entries), v16,
        torch.from_numpy(nbrs), Metric(metric), ef, expand, max_iters=mi,
        patience=patience, packed=packed)
    np.testing.assert_array_equal(ti.numpy(), fi.numpy())
    np.testing.assert_array_equal(td.numpy(), fd.numpy())


def _gaussian_graph(seed, n=600, d=128, r0=16, b=64, ef=24):
    """Unit Gaussian rows, a random r0-regular graph, queries near rows,
    8 random entries each, as bf16 blocks and their initial beam."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    nbrs = rng.integers(0, n, (n, r0)).astype(np.int32)
    q = x[:b] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    entries = rng.integers(0, n, (b, 8)).astype(np.int32)
    v16 = torch.from_numpy(x).bfloat16()
    return x, nbrs, q, entries, v16


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_beam_loop_matches_jax_on_gaussian_rows(metric):
    """``tests/test_beam_loop.py:111-131``'s bounds: beam id overlap >= 0.99
    on average and >= 0.9 per query (only summation-order noise at near-tied
    beam boundaries may differ); distances of agreeing slots within 1e-5."""
    ef, expand = 24, 4
    x, nbrs, q, entries, v16 = _gaussian_graph(41)
    init_d, init_i = _init_beam(q, entries, v16, metric, ef)
    jd, ji = jax_beam_loop(
        jnp.asarray(q), jnp.asarray(init_d), jnp.asarray(init_i),
        jax_pack_wide(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nbrs)),
        metric=JaxMetric(metric), ef=ef, expand=expand, max_iters=7,
        interpret=True,
    )
    td, ti = beam_loop(torch.from_numpy(q), torch.from_numpy(init_d),
                       torch.from_numpy(init_i),
                       v16[torch.from_numpy(nbrs).long()], torch.from_numpy(nbrs),
                       metric, ef, expand, max_iters=7)
    ti, ji, td, jd = ti.numpy(), np.asarray(ji), td.numpy(), np.asarray(jd)
    overlaps = [len(set(a[a >= 0]) & set(c[c >= 0])) / max((c >= 0).sum(), 1)
                for a, c in zip(ti, ji)]
    assert np.mean(overlaps) >= 0.99, np.mean(overlaps)
    assert np.min(overlaps) >= 0.9, np.min(overlaps)
    agree = (ti == ji) & (ji >= 0)
    np.testing.assert_allclose(td[agree], jd[agree], rtol=1e-5, atol=1e-5)


def test_beam_loop_refuses_bad_input():
    """Shape errors as JAX's; the CUDA wrapper refuses CPU tensors and, before
    that, an ef or E * R0 above the limits that shared memory sets."""
    x, nbrs, q, entries, v16 = _gaussian_graph(44, n=64, b=4)
    packed = v16[torch.from_numpy(nbrs).long()]
    nb = torch.from_numpy(nbrs)
    qt = torch.from_numpy(q)

    def init(ef):
        return torch.full((4, ef), np.inf), torch.full((4, ef), -1, dtype=torch.int32)

    with pytest.raises(ValueError, match="init beam shape mismatch"):
        beam_loop(qt, *init(8), packed, nb, "l2", ef=9)
    with pytest.raises(ValueError, match="packed dim"):
        beam_loop(qt[:, :64], *init(8), packed, nb, "l2", ef=8)
    with pytest.raises(ValueError, match="neighbors0 has shape"):
        beam_loop(qt, *init(8), packed, nb[:, :8], "l2", ef=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        beam_loop_cuda(qt, *init(8), packed, nb, "l2", ef=8)
    with pytest.raises(ValueError, match=f"ef <= {MAX_EF}"):
        beam_loop_cuda(qt, *init(MAX_EF + 1), packed, nb, "l2", ef=MAX_EF + 1)
    wide = MAX_CANDIDATES // 16 + 1  # E * R0 just above the limit
    with pytest.raises(ValueError, match=f"E\\*R0 <= {MAX_CANDIDATES}"):
        beam_loop_cuda(qt, *init(wide), packed, nb, "l2", ef=wide, expand=wide)
    assert _build.LAUNCHES["beam_loop"] == 0


def test_beam_loop_counts_and_early_stop():
    """Running to the default max_iters (24 steps here) gives what a budget
    far above it gives (no query is live after it), and the counts are
    those of the expansions made: at most E per query and step, and no more
    fresh candidates than their neighbour rows hold."""
    ef, expand = 24, 4
    x, nbrs, q, entries, v16 = _gaussian_graph(45, b=16)
    init_d, init_i = _init_beam(q, entries, v16, "l2", ef)
    args = (torch.from_numpy(q), torch.from_numpy(init_d), torch.from_numpy(init_i),
            v16[torch.from_numpy(nbrs).long()], torch.from_numpy(nbrs), "l2", ef,
            expand)
    d0, i0, n0, f0 = beam_loop_plain(*args)            # the default budget
    d1, i1, n1, f1 = beam_loop_plain(*args, max_iters=500)
    assert torch.equal(i0, i1) and torch.equal(d0, d1) and (n0, f0) == (n1, f1)
    assert 0 < f0 <= n0 * 16 and n0 <= 16 * 24 * expand
    assert bool((d0[:, 1:] >= d0[:, :-1]).all())


def _grid_case(seed, r0_full, r0, metric, b=20, ef=24, expand=4, mi=6):
    """Integer-grid rows over a random graph whose neighbour rows are cut
    to their first ``r0`` of ``r0_full`` columns, as ``search_degree``
    slices them: (q, entries, vecs, cut ids, the plain loop's result)."""
    rng = np.random.default_rng(seed)
    d, cap = 128, 300
    vecs = _grid(rng, (cap, d))
    nbrs = rng.integers(-1, cap, (cap, r0_full)).astype(np.int32)[:, :r0].copy()
    q = _grid(rng, (b, d))
    entries = rng.integers(0, cap, (b, 4)).astype(np.int32)
    v16 = torch.from_numpy(vecs).bfloat16()
    init_d, init_i = _init_beam(q, entries, v16, metric, ef)
    packed = v16[torch.from_numpy(nbrs).clamp(min=0).long()]
    td, ti, _, _ = beam_loop_plain(
        torch.from_numpy(q), torch.from_numpy(init_d), torch.from_numpy(init_i),
        packed, torch.from_numpy(nbrs), metric, ef, expand, 0, mi)
    return q, entries, vecs, nbrs, init_d, init_i, td, ti


@pytest.mark.parametrize("metric", METRICS)
def test_beam_loop_plain_bit_equal_to_jax_kernel_at_search_degree_16(metric):
    """``search_degree = 16`` of a 32-wide graph, the narrowest cut the TPU
    kernel takes (R0 % 16): the plain loop's slots bit-equal to JAX's kernel
    in interpret mode on integer-grid rows, distances within 1e-6."""
    ef, expand = 24, 4
    q, _, vecs, nbrs, init_d, init_i, td, ti = _grid_case(60, 32, 16, metric)
    jd, ji = jax_beam_loop(
        jnp.asarray(q), jnp.asarray(init_d), jnp.asarray(init_i),
        jax_pack_wide(jnp.asarray(vecs, jnp.bfloat16), jnp.asarray(nbrs)),
        metric=JaxMetric(metric), ef=ef, expand=expand, max_iters=6,
        interpret=True,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(np.nan_to_num(td.numpy(), posinf=1e38),
                               np.nan_to_num(np.asarray(jd), posinf=1e38),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_beam_loop_plain_bit_equal_to_jax_packed_beam_at_search_degree_12(metric):
    """``search_degree = 12`` of a 32-wide graph, a width JAX's kernels
    refuse: the plain loop against JAX's beam over the same cut packed
    blocks (``_beam_search_level0``, XLA branch), bit-equal slots and
    distances on integer-grid rows."""
    ef, expand = 24, 4
    q, entries, vecs, nbrs, _, _, td, ti = _grid_case(70, 32, 12, metric)
    packed = torch.from_numpy(vecs).bfloat16()[torch.from_numpy(nbrs).clamp(min=0).long()]
    jd, ji = jax_beam(
        jnp.asarray(q), jnp.asarray(entries), jnp.asarray(vecs, jnp.bfloat16),
        jnp.asarray(nbrs), JaxMetric(metric), ef, expand=expand, max_iters=6,
        packed=jnp.asarray(packed.float().numpy(), jnp.bfloat16),
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.nan_to_num(td.numpy(), posinf=1e38),
                                  np.nan_to_num(np.asarray(jd), posinf=1e38))


def _source_smem_words():
    """``smem_words`` and ``kScratchWords`` as csrc/beam_phases.cuh (the
    layout csrc/beam_loop.cu and csrc/beam_step.cu share) writes them, as a
    function of (dq, ef, e, c, h)."""
    src = (Path(beam_loop_mod.__file__).parents[1] / "csrc" / "beam_phases.cuh").read_text()
    expr = re.search(r"smem_words\([^)]*\)\s*\{\s*return ([^;]+);", src).group(1)
    scratch = int(re.search(r"constexpr int kScratchWords = (\d+);", src).group(1))
    return lambda dq, ef, e, c, h: eval(
        expr, {"dq": dq, "ef": ef, "e": e, "c": c, "h": h, "kScratchWords": scratch})


@pytest.mark.parametrize("d,ef,e,r0", [
    (384, 24, 8, 32), (37, 5, 3, 12), (1024, MAX_EF, 128, 32),
    (1024, MAX_EF, MAX_EF, 4), (1024, MAX_EF, 1, MAX_CANDIDATES),
    (40_000, MAX_EF, 128, 32), (58_000, 24, 8, 32), (1, 1, 1, 1)])
def test_smem_bytes_is_the_sources_count(d, ef, e, r0):
    """``_smem_bytes`` is the source's ``smem_words`` at the plan's hash
    size and query placement, 4 bytes a word; the plan fits a block, keeps
    the hash at least as large as the step's ids, and keeps the query in
    shared memory at d = 1,024 even at ``MAX_EF`` and ``MAX_CANDIDATES``."""
    h, qsm, nbytes = beam_loop_mod._plan(d, ef, e, r0)
    dq = -(-d // 4) * 4 if qsm else 0
    assert nbytes == 4 * _source_smem_words()(dq, ef, e, e * r0, h)
    assert nbytes == beam_loop_mod._smem_bytes(d, ef, e, r0)
    assert nbytes <= beam_loop_mod._SMEM_BYTES
    assert h >= ef + e * r0 and h & (h - 1) == 0
    if d <= 1024:
        assert qsm


def test_every_shape_of_the_limits_fits():
    """No (d, ef, E, R0) within ``MAX_EF`` and ``MAX_CANDIDATES`` is refused
    for shared memory: every one the previous layout (4 * (d + 6 ef +
    3 E*R0 + E) bytes) took, and wider queries too."""
    for d in (1, 100, 384, 1024, 20_000, 40_000, 58_000, 1 << 20):
        for ef in (1, 24, 257, MAX_EF):
            for e, r0 in ((1, 1), (1, 32), (8, 32), (ef, 4), (128, 32), (1, MAX_CANDIDATES)):
                if e > ef or e * r0 > MAX_CANDIDATES:
                    continue
                assert beam_loop_mod._smem_bytes(d, ef, e, r0) <= beam_loop_mod._SMEM_BYTES
