"""muninn_tpu_torch's exact flat search against muninn_tpu's on the CPU.

The same seeded numpy inputs go through the JAX function and its port:
``flat_topk`` against the JAX kernel's own CPU route (``interpret=True``),
``FlatIndex`` against the JAX ``FlatIndex(use_pallas=False)``, and a JAX
index carried across with ``index.convert``. Data is continuous Gaussian,
so there are no ties and the ids must be equal.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.index.flat import FlatIndex as JaxFlatIndex
from muninn_tpu.index.flat import _xla_chunked_topk
from muninn_tpu.ops.distance import Metric as JaxMetric
from muninn_tpu.ops.pallas_flat import flat_topk as jax_flat_topk
from muninn_tpu_torch import FlatIndex
from muninn_tpu_torch.index.convert import flat_index_from_numpy, flat_index_to_numpy
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops import flat_topk as flat_topk_mod
from muninn_tpu_torch.ops.flat_topk import (
    MAX_K,
    flat_topk,
    flat_topk_cuda,
    flat_topk_plain,
)

REPO = Path(__file__).resolve().parents[1]
METRICS = ["l2", "cosine", "inner_product"]


def _data(seed, b, n, d, masked):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    valid = rng.random(n) < 0.7 if masked else None
    return q, c, valid


# (B, N, d, k, masked): B and N multiples of nothing, d = 40 and 100, k in
# {1, 10, 64}, and k > N in the last
SHAPES = [(7, 1001, 40, 1, False), (13, 2999, 100, 10, True),
          (5, 777, 40, 64, True), (3, 50, 100, 64, True)]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}_n{}_d{}_k{}".format(*s))
def test_flat_topk_matches_jax_interpret(metric, shape):
    b, n, d, k, masked = shape
    q, c, valid = _data(sum(shape[:4]), b, n, d, masked)
    wd, wi = jax_flat_topk(
        jnp.asarray(q), jnp.asarray(c), k, metric=metric,
        corpus_valid=None if valid is None else jnp.asarray(valid),
        interpret=True,
    )
    gd, gi = flat_topk(
        torch.from_numpy(q), torch.from_numpy(c), k, metric=metric,
        corpus_valid=None if valid is None else torch.from_numpy(valid),
    )
    gd, gi = gd.numpy(), gi.numpy()
    assert gd.shape == (b, k) and gi.dtype == np.int32
    np.testing.assert_array_equal(gi, np.asarray(wi))
    # same f32 products, summed in another order by another BLAS
    np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-5, atol=1e-6)
    if n < k:
        live = int(valid.sum())
        assert (gi[:, live:] == -1).all() and np.isinf(gd[:, live:]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_chunked_plain_matches_jax_xla_chunked(metric, monkeypatch):
    """flat_topk_plain, merging chunks of 128 rows (700 rows: 6 chunks, the
    last ragged), against the JAX chunked reference at the same chunk."""
    monkeypatch.setattr(flat_topk_mod, "_CHUNK", 128)
    q, c, valid = _data(11, 6, 700, 24, True)
    wd, wi = _xla_chunked_topk(jnp.asarray(q), jnp.asarray(c), jnp.asarray(valid),
                               7, JaxMetric(metric), chunk=128)
    gd, gi = flat_topk_plain(torch.from_numpy(q), torch.from_numpy(c), 7,
                             metric=metric, corpus_valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # JAX forms l2 as qn + cn - 2*dot and cosine as dot / (|q| |c|), the
    # port as (qn - 2*dot) + cn and a dot of unit rows: the same values up
    # to f32 rounding of distances of magnitude ~50 (l2) and ~1
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)


def _assert_same_search(tidx, jidx, q, k, metric):
    ti, tdist = tidx.search(q, k=k)
    ji, jdist = jidx.search(q, k=k)
    np.testing.assert_array_equal(ti, ji)
    # l2: the JAX XLA route clamps at 0 (distance.py:101) and forms
    # qn + cn - 2*dot, the kernel route (qn - 2*dot) + cn unclamped
    # (pallas_flat.py:102); near-duplicate pairs sit at ~1e-4, where the
    # cancellation of O(100) terms leaves errors of a few 1e-6
    atol = 1e-5 if metric == "l2" else 1e-6
    np.testing.assert_allclose(tdist, jdist, rtol=1e-5, atol=atol)
    return ti


@pytest.mark.parametrize("metric", METRICS)
def test_flat_index_matches_jax_insert_delete_grow(metric):
    rng = np.random.default_rng(21)
    d, k = 48, 10
    x = rng.standard_normal((1500, d)).astype(np.float32)
    q = x[rng.integers(0, 700, 9)] + 0.001 * rng.standard_normal((9, d)).astype(np.float32)
    tidx = FlatIndex(d, metric, capacity=1024, device="cpu")
    jidx = JaxFlatIndex(d, metric, capacity=1024, use_pallas=False)
    for idx in (tidx, jidx):
        idx.insert(np.arange(700) * 3 + 5, x[:700])
    first = _assert_same_search(tidx, jidx, q, k, metric)
    dead = np.unique(first[:, :2])
    for idx in (tidx, jidx):
        idx.delete(dead)
    after = _assert_same_search(tidx, jidx, q, k, metric)
    assert not np.isin(after, dead).any()
    for idx in (tidx, jidx):  # 700 + 800 rows outgrow capacity 1024
        idx.insert(np.arange(700, 1500) * 3 + 5, x[700:])
    assert tidx.store.capacity == jidx.store.capacity == 2048
    assert len(tidx) == len(jidx) == 1500 - len(dead)
    _assert_same_search(tidx, jidx, x[1200:1207], k, metric)
    one_t, one_d = tidx.search(x[1300], k=3)
    one_j, _ = jidx.search(x[1300], k=3)
    assert one_t.shape == one_d.shape == (3,)
    np.testing.assert_array_equal(one_t, one_j)


def test_flat_index_search_device_is_slot_space():
    x = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
    idx = FlatIndex(8, "l2", device="cpu")
    idx.insert(np.arange(40) + 500, x)
    d, slots = idx.search_device(torch.from_numpy(x[:3]), k=2)
    assert isinstance(d, torch.Tensor) and slots.dtype == torch.int32
    np.testing.assert_array_equal(slots[:, 0].numpy(), [0, 1, 2])
    ids, _ = idx.search(x[:3], k=2)
    np.testing.assert_array_equal(ids, idx.store.ids_of(slots.numpy()))


def test_flat_index_errors():
    idx = FlatIndex(8, "l2", device="cpu")
    idx.insert([1], np.ones((1, 8), np.float32))
    with pytest.raises(ValueError, match="query dim 9 != index dim 8"):
        idx.search(np.zeros(9), k=1)
    with pytest.raises(ValueError, match="duplicate id"):
        idx.insert([1], np.ones((1, 8), np.float32))
    with pytest.raises(KeyError):
        idx.delete([2])
    with pytest.raises(ValueError, match="invalid metric"):
        FlatIndex(8, "euclidean")
    # the int8 modes are ported; l2 has no int8 form, as in muninn_tpu
    l2_int8 = FlatIndex(8, "l2", precision="int8_rescored", device="cpu")
    l2_int8.insert([1], np.ones((1, 8), np.float32))
    with pytest.raises(ValueError, match="cosine/inner_product"):
        l2_int8.search(np.ones(8), k=1)
    with pytest.raises(ValueError, match="tune_rescore_r applies"):
        idx.tune_rescore_r()
    with pytest.raises(ValueError, match="precision"):
        FlatIndex(8, "cosine", precision="fastest", device="cpu")
    with pytest.raises(ValueError, match="cosine/inner_product"):
        flat_topk(torch.zeros(1, 8), torch.zeros(4, 8), 1, precision="int8")
    with pytest.raises(ValueError, match="precision"):
        flat_topk(torch.zeros(1, 8), torch.zeros(4, 8), 1, precision="fastest")


def _jax_state(jidx):
    hw = jidx.store.high_watermark
    return {
        "dim": jidx.dim,
        "metric": jidx.metric.value,
        "vectors": np.asarray(jidx.store.vectors[:hw]),
        "valid": np.asarray(jidx.store.valid[:hw]),
        "id_of": jidx.store._id_of[:hw].copy(),
    }


@pytest.mark.parametrize("metric", METRICS)
def test_carry_jax_index_across(metric):
    rng = np.random.default_rng(31)
    d = 40
    x = rng.standard_normal((900, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    jidx = JaxFlatIndex(d, metric, use_pallas=False)
    jidx.insert(np.arange(900) + 10_000, x)
    jidx.delete(np.arange(0, 900, 7) + 10_000)
    state = _jax_state(jidx)
    tidx = flat_index_from_numpy(state, device="cpu")
    assert len(tidx) == len(jidx)
    assert tidx.store.high_watermark == jidx.store.high_watermark
    _assert_same_search(tidx, jidx, q, 10, metric)
    back = flat_index_to_numpy(tidx)
    assert back["dim"] == state["dim"] and back["metric"] == state["metric"]
    for key in ("vectors", "valid", "id_of"):
        np.testing.assert_array_equal(back[key], state[key])
    # the carried index keeps working: insert after the old high watermark
    tidx.insert([1], x[:1])
    ids, _ = tidx.search(x[0], k=1)
    assert ids[0] == 1


def test_carry_rejects_inconsistent_valid():
    state = {"dim": 2, "metric": "l2", "vectors": np.zeros((2, 2), np.float32),
             "valid": np.array([True, True]), "id_of": np.array([4, -1])}
    with pytest.raises(ValueError, match="valid"):
        flat_index_from_numpy(state, device="cpu")


def _run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_pulls_in_no_jax():
    res = _run("""
        import sys
        import muninn_tpu_torch
        from muninn_tpu_torch.index import convert
        from muninn_tpu_torch.ops import flat_topk
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "muninn_tpu" or m.startswith("muninn_tpu.")]
        assert not bad, bad
    """)
    assert res.returncode == 0, res.stderr


def test_cpu_path_never_builds_or_launches(tmp_path):
    """On CPU tensors the plain version runs: no launch is counted and
    nvcc is never called, neither at import nor at search."""
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
        from muninn_tpu_torch import FlatIndex
        idx = FlatIndex(8, "cosine", device="cpu")
        idx.insert(np.arange(30), np.random.default_rng(0).standard_normal((30, 8)))
        idx.search(np.ones(8), k=3)
        assert _build.LAUNCHES["flat_topk"] == 0, _build.LAUNCHES
        assert not _build._LIBS
    """, env=env)
    assert res.returncode == 0, res.stderr
    assert not marker.exists()


def test_kernel_launcher_refuses_cpu_tensors():
    q, c = torch.zeros(2, 8), torch.zeros(5, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_topk_cuda(q, c, 3)
    with pytest.raises(ValueError, match=f"k <= {MAX_K}"):
        flat_topk_cuda(q, c, MAX_K + 1)
    # the kernel never copies the corpus to make it f32 or contiguous
    with pytest.raises(ValueError, match="contiguous float32 corpus"):
        flat_topk_cuda(q, c.double(), 3)
    with pytest.raises(ValueError, match="strided"):
        flat_topk_cuda(q, torch.zeros(8, 5).T, 3)
    assert _build.LAUNCHES["flat_topk"] == 0


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (round to nearest even), back to f32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _default_reference64(q, c, valid, metric):
    """float64 distances of the bf16 mode: the unit query and the raw
    corpus row rounded to bf16, the epilogue from the f32 rows."""
    q = q.astype(np.float64)
    c32 = c
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    dots = _bf16(q.astype(np.float32)).astype(np.float64) @ _bf16(c32).astype(np.float64).T
    cn = (c32.astype(np.float64) ** 2).sum(1)
    if metric == "l2":
        dist = (q ** 2).sum(1)[:, None] - 2 * dots + cn[None, :]
    elif metric == "cosine":
        dist = 1 - dots / np.sqrt(cn)[None, :]
    else:
        dist = -dots
    return np.where(valid[None, :], dist, np.inf)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", ["default", "bfloat16"])
def test_flat_topk_bf16_mode_matches_float64_reference(metric, precision):
    """The plain bf16-operand mode against a float64 numpy reference on
    bf16-rounded operands: distances within 1e-5 (f32 sums of exact
    products against float64), ids equal except where the float64 distances
    of the two ids are tied within that tolerance."""
    b, n, d, k = 9, 1500, 72, 33
    q, c, valid = _data(41, b, n, d, True)
    ref = _default_reference64(q, c, valid, metric)
    order = np.argsort(ref, axis=1, kind="stable")[:, :k]
    want_d = np.take_along_axis(ref, order, axis=1)
    gd, gi = flat_topk_plain(torch.from_numpy(q), torch.from_numpy(c), k,
                             metric=metric, corpus_valid=torch.from_numpy(valid),
                             precision=precision)
    gd, gi = gd.numpy(), gi.numpy().astype(np.int64)
    np.testing.assert_allclose(gd, want_d, rtol=1e-5, atol=1e-5)
    diff = gi != order
    got_ref = np.take_along_axis(ref, gi, axis=1)
    assert np.all(np.abs(got_ref - want_d)[diff] <= 1e-5 * (1 + np.abs(want_d[diff])))


def test_flat_bf16_mode_recall_vs_highest():
    """Recall@10 of the bf16-operand mode against the exact one on
    unit-norm Gaussian rows: at least 0.98."""
    rng = np.random.default_rng(43)
    c = rng.standard_normal((3000, 64)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = c[:200] + 0.3 * rng.standard_normal((200, 64)).astype(np.float32)
    fast = FlatIndex(64, "cosine", precision="default", device="cpu")
    exact = FlatIndex(64, "cosine", device="cpu")
    for idx in (fast, exact):
        idx.insert(np.arange(3000), c)
    fi, _ = fast.search(q, k=10)
    ei, _ = exact.search(q, k=10)
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(fi, ei)])
    assert rec >= 0.98, rec
    assert fast.precision == "default"


def test_kernel_launcher_bf16_mode_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_topk_cuda(torch.zeros(2, 8), torch.zeros(5, 8), 3, precision="default")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat_topk_cuda(torch.zeros(2, 8), torch.zeros(5, 8), 3,
                       metric="cosine", precision="int8")
    assert _build.LAUNCHES["flat_topk"] == _build.LAUNCHES["flat_topk_int8"] == 0


# ── the tensor-core kernel's host logic (csrc/flat_topk_mma.cu) ──


@pytest.mark.parametrize("op", ["bf16", "int8"])
@pytest.mark.parametrize("d", [1, 100, 384, 768, 5000])
@pytest.mark.parametrize(
    "k", [1, 10, 16, 17, 33, 48, 49, 100, 112, 113, 240, 241, 496, 497, 1008,
          1009, 1024])
def test_mma_plan_fits_shared_memory_and_holds_k(k, d, op):
    """The buffer holds k plus one check's columns in the least power of
    two; the query tile shrinks as the buffer grows, so the buffers take
    64 KB (128 KB past k = 1008); the queries stay resident where a ring of
    3 stages still fits, and stream otherwise; the ring is as deep as the
    rest of the 227 KB allows, 2 to 6 stages."""
    code = {"bf16": flat_topk_mod._OP_BF16, "int8": flat_topk_mod._OP_INT8}[op]
    tq, w, stages, a_chunks = flat_topk_mod.mma_plan(k, d, code)
    check = flat_topk_mod.MMA_CHECK
    assert w & (w - 1) == 0 and w >= k + check and w // 2 < k + check
    assert tq == max(8, min(128, 8192 // w))
    assert tq * w * 8 <= (128 if k > 1008 else 64) * 1024
    n_chunks = -(-d * (2 if op == "bf16" else 1) // 128)
    assert a_chunks in (0, n_chunks)
    assert (3 if a_chunks else 2) <= stages <= flat_topk_mod.MMA_MAX_STAGES
    limit = flat_topk_mod.SMEM_LIMIT
    smem = flat_topk_mod.mma_smem_bytes
    assert smem(tq, w, stages, a_chunks) <= limit
    assert (stages == flat_topk_mod.MMA_MAX_STAGES
            or smem(tq, w, stages + 1, a_chunks) > limit)
    if a_chunks == 0:  # streamed only because resident would not fit
        assert smem(tq, w, 3, n_chunks) > limit


def test_mma_plan_of_the_main_paths():
    """Two consumer warpgroups (128 queries), resident queries and a deep
    ring at the main paths: the flat bf16 search (k=10, d=384), the HNSW
    build's sweep (k = m0 + 1 = 33), int8_rescored's first tier (r=16,
    d=768); one warpgroup of 8 queries at k = 1024, and queries that
    stream through the ring at d=768 in bf16."""
    bf16, int8 = flat_topk_mod._OP_BF16, flat_topk_mod._OP_INT8
    assert flat_topk_mod.mma_plan(10, 384, bf16) == (128, 32, 5, 6)
    assert flat_topk_mod.mma_plan(33, 384, bf16) == (128, 64, 3, 6)
    assert flat_topk_mod.mma_plan(16, 768, int8) == (128, 32, 5, 6)
    assert flat_topk_mod.mma_plan(1024, 100, int8) == (8, 2048, 5, 1)
    assert flat_topk_mod.mma_plan(10, 768, bf16) == (128, 32, 5, 0)


@pytest.mark.parametrize("k", [0, -3, MAX_K + 1])
def test_mma_plan_refuses_k_outside_the_kernel(k):
    with pytest.raises(ValueError, match=f"k <= {MAX_K}"):
        flat_topk_mod.mma_plan(k, 384, flat_topk_mod._OP_BF16)


@pytest.mark.parametrize("d", [1, 63, 64, 65, 100, 384, 768])
def test_mma_rows_bf16_rounds_and_zero_pads(d):
    """bf16 rows: rounded to nearest even (the plain version's rounding),
    zero past d up to a whole 128 bytes."""
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((5, d))
                         .astype(np.float32))
    out = flat_topk_mod.mma_rows(x, flat_topk_mod._OP_BF16)
    assert out.dtype == torch.bfloat16
    assert out.shape == (5, -(-d // 64) * 64) and out.is_contiguous()
    assert torch.equal(out[:, :d].float(), flat_topk_mod._bf16_round(x))
    assert not out[:, d:].float().any()


@pytest.mark.parametrize("d", [1, 100, 127, 128, 129, 768])
def test_mma_rows_int8_zero_pads(d):
    x = torch.from_numpy(np.random.default_rng(d).integers(-127, 128, (3, d))
                         .astype(np.int8))
    out = flat_topk_mod.mma_rows(x, flat_topk_mod._OP_INT8)
    assert out.dtype == torch.int8 and out.shape == (3, -(-d // 128) * 128)
    assert torch.equal(out[:, :d], x) and not out[:, d:].any()


@pytest.mark.parametrize("k", [0, MAX_K + 1])
def test_bf16_launcher_refuses_k_before_a_launch(k):
    with pytest.raises(ValueError, match=f"k <= {MAX_K}"):
        flat_topk_cuda(torch.zeros(2, 8), torch.zeros(5, 8), k,
                       precision="default")
    assert _build.LAUNCHES["flat_topk"] == _build.LAUNCHES["flat_topk_mma"] == 0


@pytest.mark.parametrize("corpus", [torch.zeros(5, 8, dtype=torch.float64),
                                    torch.zeros(5, 8, dtype=torch.bfloat16),
                                    torch.zeros(8, 5).T])
def test_bf16_launcher_refuses_a_corpus_it_would_copy(corpus):
    with pytest.raises(ValueError, match="contiguous float32 corpus"):
        flat_topk_cuda(torch.zeros(2, 8), corpus, 3, precision="bfloat16")
    assert _build.LAUNCHES["flat_topk_mma"] == 0


# ── the f32 kernel's host logic (csrc/flat_topk.cu, ``highest``) ──


@pytest.mark.parametrize("b", [1, 9, 64, 8192])
@pytest.mark.parametrize(
    "k", [1, 10, 16, 17, 33, 48, 49, 100, 112, 113, 240, 241, 496, 497, 1008,
          1009, 1024])
def test_f32_plan_fits_shared_memory_and_holds_k(k, b):
    """The buffer is the least power of two holding k plus one check's
    columns; the query tile is the largest of 128 down to 8, not above b's
    power of two, that leaves a ring of 3 stages (2 where none does); the
    ring is as deep as the rest of the 227 KB allows, at most 4. A stage
    holds 32 features of any d (the ragged tail zero-filled), so d plays no
    part in the plan."""
    tq, w, stages = flat_topk_mod.f32_plan(k, b)
    cols = flat_topk_mod.f32_check_cols(tq)
    assert tq in flat_topk_mod.F32_QUERY_TILES
    assert tq == 8 or tq < 2 * b
    assert w & (w - 1) == 0 and w >= k + cols and w // 2 < k + cols
    smem = flat_topk_mod.f32_smem_bytes
    limit = flat_topk_mod.SMEM_LIMIT
    assert flat_topk_mod.F32_MIN_STAGES <= stages <= flat_topk_mod.F32_MAX_STAGES
    assert smem(tq, w, stages) <= limit
    assert stages == flat_topk_mod.F32_MAX_STAGES or smem(tq, w, stages + 1) > limit
    for other in flat_topk_mod.F32_QUERY_TILES:  # the choice is the first that fits
        ow = 1 << (k + flat_topk_mod.f32_check_cols(other) - 1).bit_length()
        if other < 2 * b or other == 8:
            if stages == 2:
                assert smem(other, ow, 3) > limit
            if other > tq:
                assert smem(other, ow, min(stages, 3)) > limit


def test_f32_plan_of_the_main_paths():
    """The 128-query tile and a 3-stage ring at FlatIndex's exact search
    (k=10, any batch of more than 64) and at the small k of tune_rescore_r
    and HNSW's exact path; smaller tiles at larger k and at small batches;
    8 queries and 2 stages at k = 1024, whose buffers need 128 KB."""
    assert flat_topk_mod.f32_plan(10, 8192) == (128, 32, 3)
    assert flat_topk_mod.f32_plan(10, 1024) == (128, 32, 3)
    assert flat_topk_mod.f32_plan(1, 512) == (128, 32, 3)
    assert flat_topk_mod.f32_plan(16, 8192) == (128, 32, 3)
    assert flat_topk_mod.f32_plan(33, 8192) == (64, 64, 4)
    assert flat_topk_mod.f32_plan(100, 8192) == (64, 128, 3)
    assert flat_topk_mod.f32_plan(10, 64) == (64, 32, 4)
    assert flat_topk_mod.f32_plan(10, 1) == (8, 64, 4)
    assert flat_topk_mod.f32_plan(MAX_K, 8192) == (8, 2048, 2)


@pytest.mark.parametrize("k", [0, -3, MAX_K + 1])
def test_f32_plan_refuses_k_outside_the_kernel(k):
    with pytest.raises(ValueError, match=f"k <= {MAX_K}"):
        flat_topk_mod.f32_plan(k, 8192)


@pytest.mark.parametrize("case", ["k0", "k1025", "f64", "bf16", "strided", "cpu"])
def test_f32_launcher_refuses_before_a_build_or_launch(case):
    """``highest`` on CUDA refuses k outside [1, 1024], a corpus it would
    have to copy, and CPU tensors, before any library is built or kernel
    launched."""
    q, c, k = torch.zeros(2, 8), torch.zeros(5, 8), 3
    if case == "k0":
        k = 0
    elif case == "k1025":
        k = MAX_K + 1
    elif case == "f64":
        c = c.double()
    elif case == "bf16":
        c = c.bfloat16()
    elif case == "strided":
        c = torch.zeros(8, 5).T
    match = {"k0": "k <= ", "k1025": "k <= ", "f64": "contiguous float32",
             "bf16": "contiguous float32", "strided": "strided",
             "cpu": "CUDA tensors"}[case]
    with pytest.raises(ValueError, match=match):
        flat_topk_cuda(q, c, k, metric="cosine")
    assert "flat_topk" not in _build._LIBS
    assert _build.LAUNCHES["flat_topk"] == 0
