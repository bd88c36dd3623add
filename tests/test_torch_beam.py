"""muninn_tpu_torch.ops.beam and the HNSW level-0 beam against muninn_tpu on
the CPU.

The same seeded numpy inputs go through the JAX function and its port:
``gather_block_dots_plain`` against the Pallas kernel in interpret mode,
and the port's ``_beam_search_level0`` over packed blocks against JAX's
fused beam (``fused=True, interpret=True``), as ``tests/test_hnsw.py``
holds the fused beam against the XLA one.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.index.hnsw import _beam_search_level0 as jax_beam
from muninn_tpu.ops.distance import Metric as JaxMetric
from muninn_tpu.ops.pallas_beam import gather_block_dots as jax_gather_block_dots
from muninn_tpu_torch.index.hnsw import _beam_search_level0
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.beam import (
    gather_block_dots,
    gather_block_dots_cuda,
    gather_block_dots_plain,
)
from muninn_tpu_torch.ops.distance import Metric, quantize_rows_int8

METRICS = ["l2", "cosine", "inner_product"]


def _picks(rng, b, e, cap):
    idx = rng.integers(0, cap, (b, e)).astype(np.int32)
    dead = rng.random((b, e)) < 0.4
    dead[0] = True   # a fully dead query
    dead[1] = False  # a fully live one
    return np.where(dead, -1, idx).astype(np.int32), dead


# the TPU kernel's aligned shapes: d % 128 == 0, R0 a multiple of the
# dtype's sublanes (8 for f32, 16 for bf16)
@pytest.mark.parametrize("dtype,r0", [("float32", 8), ("float32", 16),
                                      ("bfloat16", 16)])
def test_gather_block_dots_plain_matches_jax_kernel(dtype, r0):
    rng = np.random.default_rng(r0)
    cap, d, e, b = 96, 128, 4, 16
    packed = torch.from_numpy(
        rng.standard_normal((cap, r0, d)).astype(np.float32)
    ).to(getattr(torch, dtype))
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx, dead = _picks(rng, b, e, cap)
    wd, wc = jax_gather_block_dots(
        jnp.asarray(q), jnp.asarray(idx),
        jnp.asarray(packed.float().numpy()).astype(getattr(jnp, dtype)),
        interpret=True,
    )
    gd, gc = gather_block_dots(torch.from_numpy(q), torch.from_numpy(idx), packed)
    gd, gc, wd, wc = gd.numpy(), gc.numpy(), np.asarray(wd), np.asarray(wc)
    assert gd.shape == gc.shape == (b, e * r0) and gd.dtype == np.float32
    lanes = np.repeat(dead, r0, axis=1)
    # live lanes: the same f32 products summed in another order, a few
    # ulps of |q||c| ~ d apart (1e-5 relative, 1e-5 absolute)
    np.testing.assert_allclose(gd[~lanes], wd[~lanes], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gc[~lanes], wc[~lanes], rtol=1e-5, atol=1e-5)
    # dead lanes: exactly 0, as the TPU kernel writes them
    assert (gd[lanes] == 0).all() and (gc[lanes] == 0).all()
    assert (gd[0] == 0).all() and (gc[1] > 0).all()


def test_gather_block_dots_plain_any_shape():
    """No alignment limit in the port: d = 100, R0 = 5, against a numpy
    float64 reference (1e-5 relative)."""
    rng = np.random.default_rng(3)
    cap, r0, d, e, b = 20, 5, 100, 3, 6
    packed = rng.standard_normal((cap, r0, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx, dead = _picks(rng, b, e, cap)
    gd, gc = gather_block_dots_plain(torch.from_numpy(q), torch.from_numpy(idx),
                                     torch.from_numpy(packed))
    blocks = packed.astype(np.float64)[np.maximum(idx, 0)].reshape(b, e * r0, d)
    live = ~np.repeat(dead, r0, axis=1)
    want_d = np.where(live, np.einsum("bd,bcd->bc", q.astype(np.float64), blocks), 0)
    want_c = np.where(live, (blocks ** 2).sum(-1), 0)
    np.testing.assert_allclose(gd.numpy(), want_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), want_c, rtol=1e-5, atol=1e-5)


def test_gather_block_dots_refuses_bad_input():
    q, idx = torch.zeros(2, 8), torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_block_dots_cuda(q, idx, torch.zeros(4, 5, 8))
    with pytest.raises(ValueError, match="packed dim 9 != query dim 8"):
        gather_block_dots(q, idx, torch.zeros(4, 5, 9))
    with pytest.raises(ValueError, match="idx has 3 rows"):
        gather_block_dots(q, torch.zeros(3, 3, dtype=torch.int32),
                          torch.zeros(4, 5, 8))
    assert _build.LAUNCHES["beam_dots"] == 0


def _beam_inputs(seed, n=512, d=128, r0=16, b=40):
    """Unit-norm rows, a random r0-regular neighbour table, queries near
    corpus rows and 4 random entries per query, as test_hnsw.py builds
    them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    nbrs = rng.integers(0, n, (n, r0)).astype(np.int32)
    q = x[:b] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    entry = rng.integers(0, n, (b, 4)).astype(np.int32)
    return x, nbrs, q, entry


def _overlap(a, b):
    return np.mean([len(set(u[u >= 0]) & set(v[v >= 0])) / max((u >= 0).sum(), 1)
                    for u, v in zip(a, b)])


@pytest.mark.parametrize("metric", METRICS)
def test_packed_beam_matches_jax_fused_beam(metric):
    """The port's beam over packed blocks against JAX's fused beam: beam
    id sets overlap >= 0.95 (both break exact ties to the lower position,
    but f32 sums in another order can swap near-ties), the first ef/2
    sorted distances within 1e-5."""
    ef = 24
    x, nbrs, q, entry = _beam_inputs(7)
    packed = x[nbrs]
    jd, ji = jax_beam(
        jnp.asarray(q), jnp.asarray(entry), jnp.asarray(x), jnp.asarray(nbrs),
        JaxMetric(metric), ef, expand=4, packed=jnp.asarray(packed),
        fused=True, interpret=True,
    )
    td, ti = _beam_search_level0(
        torch.from_numpy(q), torch.from_numpy(entry), torch.from_numpy(x),
        torch.from_numpy(nbrs), Metric(metric), ef, expand=4,
        packed=torch.from_numpy(packed),
    )
    assert td.shape == ti.shape == (40, ef) and ti.dtype == torch.int32
    assert _overlap(ti.numpy(), np.asarray(ji)) >= 0.95
    np.testing.assert_allclose(
        np.sort(td.numpy(), axis=1)[:, : ef // 2],
        np.sort(np.asarray(jd), axis=1)[:, : ef // 2], rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("metric", METRICS)
def test_row_beam_matches_packed_beam(metric):
    """Without a packed table the beam gathers rows of ``vectors``: the
    same beam as over packed blocks (the same f32 products), and the same
    as JAX's row path."""
    ef = 24
    x, nbrs, q, entry = _beam_inputs(8, r0=8)
    args = (torch.from_numpy(q), torch.from_numpy(entry), torch.from_numpy(x),
            torch.from_numpy(nbrs), Metric(metric), ef)
    pd, pi = _beam_search_level0(*args, expand=4, packed=torch.from_numpy(x[nbrs]))
    rd, ri = _beam_search_level0(*args, expand=4)
    jd, ji = jax_beam(
        jnp.asarray(q), jnp.asarray(entry), jnp.asarray(x), jnp.asarray(nbrs),
        JaxMetric(metric), ef, expand=4,
    )
    assert _overlap(ri.numpy(), pi.numpy()) >= 0.95
    assert _overlap(ri.numpy(), np.asarray(ji)) >= 0.95
    np.testing.assert_allclose(rd.numpy()[:, : ef // 2], pd.numpy()[:, : ef // 2],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rd.numpy()[:, : ef // 2],
                               np.asarray(jd)[:, : ef // 2], rtol=1e-5, atol=1e-5)


def test_beam_stops_at_max_iters_and_without_entries():
    """One iteration expands exactly ``expand`` entries per query; a query
    with no live entry keeps an empty beam."""
    x, nbrs, q, entry = _beam_inputs(9, b=6)
    entry[0] = -1
    d, i = _beam_search_level0(
        torch.from_numpy(q), torch.from_numpy(entry), torch.from_numpy(x),
        torch.from_numpy(nbrs), Metric.COSINE, 24, expand=2, max_iters=1,
    )
    assert (i[0] == -1).all() and torch.isinf(d[0]).all()
    # 4 entries + 2 expansions x 16 neighbours fill more than half the beam
    assert ((i[1:] >= 0).sum(dim=1) > 12).all()
    assert bool((d[1:, 1:] >= d[1:, :-1]).all())


def test_build_runs_one_nvcc_per_missing_source(tmp_path, monkeypatch):
    """``_build.build`` compiles every missing source (one compiler process
    each), skips a library already built from the same source, and raises
    naming each source that failed."""
    bin_dir, csrc = tmp_path / "bin", tmp_path / "csrc"
    bin_dir.mkdir()
    csrc.mkdir()
    calls = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then echo fake-nvcc; exit 0; fi\n'
        'out=""; src=""\n'
        'while [ $# -gt 0 ]; do case "$1" in -o) out="$2"; shift;;'
        ' *.cu) src="$1";; esac; shift; done\n'
        f'echo "$src" >> {calls}\n'
        'case "$src" in *bad.cu) echo "bad.cu: error" >&2; exit 1;; esac\n'
        'echo lib > "$out"\n'
    )
    nvcc.chmod(0o755)
    for name in ("one", "two", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    paths = _build.build(["one", "two"])
    assert sorted(paths) == ["one", "two"]
    assert all(p.read_text() == "lib\n" for p in paths.values())
    assert len(calls.read_text().split()) == 2
    with pytest.raises(RuntimeError, match="failed to build bad.cu"):
        _build.build(["one", "bad"])
    # "one" was built already: only "bad" reached the compiler
    assert calls.read_text().split()[2:] == [str(csrc / "bad.cu")]
    assert not list((tmp_path / "out").glob("*.tmp"))


def _int8_table(x, nbrs):
    """Rows quantized as HNSW int8 guidance stores them (not normalised)
    and the packed int8 blocks with their per-neighbour scales."""
    vi, sc = quantize_rows_int8(torch.from_numpy(x))
    nb = torch.from_numpy(nbrs).long()
    return vi, sc, vi[nb], sc[nb]


@pytest.mark.parametrize("d", [100, 128])
def test_gather_block_dots_plain_int8_blocks(d):
    """int8 blocks: after the caller's per-neighbour scaling (``dots * ps``,
    ``cn2 * ps * ps``) the results equal float64 dots and squared norms of
    the dequantized rows within 1e-5; dead lanes are exactly 0."""
    rng = np.random.default_rng(d)
    n, r0, e, b = 64, 16, 4, 12
    x, nbrs, _, _ = _beam_inputs(d, n=n, d=d, r0=r0, b=b)
    _, _, packed, pscales = _int8_table(x, nbrs)
    assert packed.dtype == torch.int8 and tuple(pscales.shape) == (n, r0)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    idx, dead = _picks(rng, b, e, n)
    gd, gc = gather_block_dots(torch.from_numpy(q), torch.from_numpy(idx), packed)
    lanes = np.repeat(dead, r0, axis=1)
    assert (gd.numpy()[lanes] == 0).all() and (gc.numpy()[lanes] == 0).all()
    ps = pscales[torch.from_numpy(idx).clamp(min=0).long()].reshape(b, e * r0)
    deq = (packed.double() * pscales.double()[..., None]).numpy()
    blocks = deq[np.maximum(idx, 0)].reshape(b, e * r0, d)
    want_d = np.where(lanes, 0, np.einsum("bd,bcd->bc", q.astype(np.float64), blocks))
    want_c = np.where(lanes, 0, (blocks ** 2).sum(-1))
    np.testing.assert_allclose((gd * ps).numpy(), want_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((gc * ps * ps).numpy(), want_c, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_block_dots_cuda(torch.from_numpy(q), torch.from_numpy(idx), packed)
    assert _build.LAUNCHES["beam_dots_int8"] == 0


@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_int8_beam_matches_jax_and_packed_matches_row_dequant(metric):
    """int8 guidance: the port's row-dequant beam (``scales``) against JAX's
    on the same int8 table, and the port's packed int8 beam (``pscales``
    epilogue) against its row path, as ``tests/test_hnsw.py:369-405`` holds
    JAX's fused int8 beam against its row path: beam id sets overlap >=
    0.95, the first ef/2 sorted distances within 1e-4 (the two forms round
    the dequantized dot in another order)."""
    ef = 24
    x, nbrs, q, entry = _beam_inputs(11, r0=32, b=24)
    vi, sc, packed, pscales = _int8_table(x, nbrs)
    args = (torch.from_numpy(q), torch.from_numpy(entry), vi,
            torch.from_numpy(nbrs), Metric(metric), ef)
    rd, ri = _beam_search_level0(*args, expand=4, scales=sc)
    pd, pi = _beam_search_level0(*args, expand=4, scales=sc, packed=packed,
                                 pscales=pscales)
    jd, ji = jax_beam(
        jnp.asarray(q), jnp.asarray(entry), jnp.asarray(vi.numpy()),
        jnp.asarray(nbrs), JaxMetric(metric), ef, expand=4,
        scales=jnp.asarray(sc.numpy()),
    )
    assert _overlap(ri.numpy(), np.asarray(ji)) >= 0.95
    np.testing.assert_allclose(rd.numpy()[:, : ef // 2],
                               np.asarray(jd)[:, : ef // 2], rtol=1e-5, atol=1e-5)
    assert _overlap(pi.numpy(), ri.numpy()) >= 0.95
    np.testing.assert_allclose(np.sort(pd.numpy(), axis=1)[:, : ef // 2],
                               np.sort(rd.numpy(), axis=1)[:, : ef // 2],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,r0", [("float32", 12), ("bfloat16", 12),
                                      ("float32", 20), ("bfloat16", 24)])
def test_gather_block_dots_plain_at_search_degree_widths(dtype, r0):
    """``search_degree`` cuts each packed block to its first ``r0`` rows (12,
    20, 24 of 32), widths the TPU kernel's sublane rule refuses: the plain
    version over the cut table equals JAX's kernel (interpret mode) over the
    uncut one, on the cut rows; dead lanes exactly 0."""
    rng = np.random.default_rng(100 + r0)
    cap, full, d, e, b = 64, 32, 128, 3, 12
    table = torch.from_numpy(
        rng.standard_normal((cap, full, d)).astype(np.float32)
    ).to(getattr(torch, dtype))
    cut = table[:, :r0].contiguous()
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx, dead = _picks(rng, b, e, cap)
    wd, wc = jax_gather_block_dots(
        jnp.asarray(q), jnp.asarray(idx),
        jnp.asarray(table.float().numpy()).astype(getattr(jnp, dtype)),
        interpret=True,
    )
    wd = np.asarray(wd).reshape(b, e, full)[:, :, :r0].reshape(b, e * r0)
    wc = np.asarray(wc).reshape(b, e, full)[:, :, :r0].reshape(b, e * r0)
    gd, gc = gather_block_dots(torch.from_numpy(q), torch.from_numpy(idx), cut)
    lanes = np.repeat(dead, r0, axis=1)
    np.testing.assert_allclose(gd.numpy()[~lanes], wd[~lanes], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gc.numpy()[~lanes], wc[~lanes], rtol=1e-5, atol=1e-5)
    assert (gd.numpy()[lanes] == 0).all() and (gc.numpy()[lanes] == 0).all()
