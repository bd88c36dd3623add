"""muninn_tpu_torch.ops.beam_step: one step of the fused HNSW beam.

On the CPU: which engine a beam takes (``step_engine``, a pure function of
the inputs' device, shapes and ``topm``), the kernel wrapper's shape and
type refusals, the plain wrapper's go-on flag, and the beam loop driven
through the kernel's flag protocol (the engine forced to "kernel", whose
wrapper runs the plain step on CPU tensors) giving the eager loop's results.

On the card (marked ``card``; they skip without one): the kernel step bit
for bit against ``beam_step_plain`` over a grid of block types, metrics and
shapes, step after step, and a whole ``HnswIndex`` search against the eager
path. The file imports no JAX, so on the machine with the card it runs
without the suite's conftest:
``python -m pytest tests/test_torch_beam_step.py --noconftest -q -p no:cacheprovider``.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import itertools

import numpy as np
import pytest
import torch

from muninn_tpu_torch import HnswIndex, tracing
from muninn_tpu_torch.index import hnsw as hnsw_mod
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops import beam_step as bs
from muninn_tpu_torch.ops.beam_loop import MAX_CANDIDATES, MAX_EF
from muninn_tpu_torch.ops.distance import (
    gathered_distances,
    quantize_rows_int8,
    squared_norms,
)

METRICS = ["l2", "cosine", "inner_product"]


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100 machine")
    return torch.device("cuda")


# ── the engine a beam takes ──

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def _meta(r0=32, d=384, dtype=torch.bfloat16, cap=1000):
    """A packed table's shape and type without its data."""
    return torch.empty((cap, r0, d), dtype=dtype, device="meta")


@pytest.mark.parametrize("device, packed, topm, ef, expand, want", [
    (CUDA, _meta(), 0, 64, 8, "kernel"),                         # the HNSW cell
    (CUDA, _meta(dtype=torch.int8), 0, 64, 8, "kernel"),         # int8 guidance
    (CUDA, _meta(dtype=torch.float32), 0, 64, 8, "eager"),       # f32 blocks
    (CUDA, _meta(r0=32, d=64), 0, 24, 8, "kernel"),              # Node2Vec's index
    (CUDA, _meta(r0=16), 0, MAX_EF, 8, "kernel"),                # at the ef limit
    (CUDA, _meta(r0=MAX_CANDIDATES // 8), 0, 64, 8, "kernel"),   # at the E*R0 limit
    (CUDA, _meta(r0=32), 0, 4, 8, "kernel"),                     # E = min(expand, ef)
    (CPU, _meta(), 0, 64, 8, "eager"),                           # the CPU
    (CUDA, None, 0, 64, 8, "eager"),                             # the row path
    (CUDA, _meta(), 12, 64, 8, "eager"),                         # top-m
    (CUDA, _meta(), 0, MAX_EF + 1, 8, "eager"),                  # above the ef limit
    (CUDA, _meta(r0=MAX_CANDIDATES // 8 + 1), 0, 64, 8, "eager"),  # above E*R0
    (CUDA, _meta(dtype=torch.float16), 0, 64, 8, "eager"),       # no such blocks
])
def test_step_engine_picks_by_inputs(device, packed, topm, ef, expand, want):
    assert bs.step_engine(device, packed, topm, ef, expand) == want


def test_step_engine_admits_every_shape_within_the_limits():
    """Where ef and E*R0 are within the limits, shared memory never refuses
    the kernel: the query moves to device memory before that."""
    for d, ef, e, r0 in itertools.product((1, 100, 384, 4096, 1 << 20),
                                          (1, 64, MAX_EF), (1, 8, 128),
                                          (1, 32)):
        want = "kernel" if min(e, ef) * r0 <= MAX_CANDIDATES else "eager"
        assert bs.step_engine(CUDA, _meta(r0=r0, d=d, cap=4), 0, ef, e) == want


# ── the kernel wrapper's refusals, on CPU tensors ──


def _state(b=4, ef=8, d=16, cap=30, r0=6, e=2):
    """Arguments of ``beam_step_cuda`` as keyword tensors (CPU)."""
    return dict(
        qf=torch.zeros((b, d)), qn2=torch.zeros((b, 1)),
        beam_d=torch.full((b, ef), float("inf")),
        beam_i=torch.full((b, ef), -1, dtype=torch.int32),
        expanded=torch.zeros((b, ef), dtype=torch.bool),
        stall=torch.zeros(b, dtype=torch.int64),
        neighbors0=torch.zeros((cap, r0), dtype=torch.int32),
        packed=torch.zeros((cap, r0, d), dtype=torch.bfloat16),
        metric="l2", expand=e, patience=3,
    )


def _with(**change):
    args = _state()
    args.update(change)
    return args


@pytest.mark.parametrize("args, match", [
    (_with(qf=torch.zeros(16)), "beam_step takes queries"),
    (_with(packed=torch.zeros((30, 6, 8), dtype=torch.bfloat16)), "packed dim"),
    (_with(neighbors0=torch.zeros((30, 5), dtype=torch.int32)), "neighbors0 has shape"),
    (_with(beam_i=torch.zeros((4, 7), dtype=torch.int32)), "beam state shape"),
    (_with(expanded=torch.zeros((3, 8), dtype=torch.bool)), "beam state shape"),
    (_with(stall=torch.zeros(5, dtype=torch.int64)), "beam state shape"),
    (_with(qn2=torch.zeros((5, 1))), "beam state shape"),
    (_with(pscales=torch.zeros((30, 5))), "pscales has shape"),
    (_with(flag=torch.zeros(2, dtype=torch.int32)), "flag has 2 elements"),
    (_with(expand=9), "expand=9"),
    (_with(expand=0), "expand=0"),
    (_with(qf=torch.zeros((4, 16), dtype=torch.float64)), "float32 queries"),
    (_with(beam_d=torch.zeros((4, 8), dtype=torch.float16)), "float32 beam_d"),
    (_with(beam_i=torch.zeros((4, 8), dtype=torch.int64)), "int32 beam_i"),
    (_with(expanded=torch.zeros((4, 8), dtype=torch.uint8)), "bool expanded"),
    (_with(stall=torch.zeros(4, dtype=torch.int32)), "int64 stall"),
    (_with(neighbors0=torch.zeros((30, 6), dtype=torch.int64)), "int32 neighbors0"),
    (_with(packed=torch.zeros((30, 6, 16), dtype=torch.float16)), "bf16 or int8"),
    (_with(packed=torch.zeros((30, 6, 16))), "bf16 or int8"),
    (_with(pscales=torch.zeros((30, 6), dtype=torch.float16)), "f32 pscales"),
    (_with(flag=torch.zeros(1, dtype=torch.int64)), "int32 flag"),
    (_with(patience=0), "patience=0"),
    (_with(), "CUDA tensors"),
])
def test_cuda_wrapper_refuses(args, match):
    """Shapes and types are checked before the device, so each refusal
    shows on the CPU; a CPU tensor is refused last, and nothing launches."""
    _build.reset_launches()
    with pytest.raises(ValueError, match=match):
        bs.beam_step_cuda(**args)
    assert _build.LAUNCHES["beam_step"] == 0


@pytest.mark.parametrize("ef, e, r0, match", [
    (MAX_EF + 1, 8, 4, f"ef <= {MAX_EF}"),
    (64, 8, MAX_CANDIDATES // 8 + 1, f"E\\*R0 <= {MAX_CANDIDATES}"),
])
def test_cuda_wrapper_refuses_above_the_limits(ef, e, r0, match):
    args = _state(ef=ef, e=e, r0=r0, cap=3)
    with pytest.raises(ValueError, match=match):
        bs.beam_step_cuda(**args)


# ── a small graph, on any device ──


def _graph(seed, d, r0, cap, dtype, metric, *, b=24, entries=4, dead=0.1,
           device="cpu"):
    """A near-neighbour graph over random rows with -1 padding, some rows
    deleted (no neighbours, no edge pointing at them), its packed table
    (bf16, or int8 with per-neighbour scales) and ``entries`` routed slots
    a query, some -1, with their distances, unsorted as routing leaves
    them: (qf, qn2, nb, packed, pscales, (entry distances, entry slots))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")
    k = min(r0, cap - 1)
    nb = np.full((cap, r0), -1, np.int32)
    nb[:, :k] = order[:, :k]
    # some long links, a ragged tail of -1, deleted rows
    swap = rng.random((cap, r0)) < 0.2
    nb = np.where(swap & (nb >= 0), rng.integers(0, cap, (cap, r0)), nb).astype(np.int32)
    tail = rng.integers(r0 // 2, r0 + 1, cap)
    nb[np.arange(r0)[None, :] >= tail[:, None]] = -1
    gone = rng.random(cap) < dead
    nb[gone] = -1
    nb[np.isin(nb, np.flatnonzero(gone))] = -1
    ent = rng.integers(0, cap, (b, entries)).astype(np.int32)
    ent[rng.random((b, entries)) < 0.15] = -1

    dev = torch.device(device)
    xt = torch.from_numpy(x).to(dev)
    nbt = torch.from_numpy(nb).to(dev)
    idx = nbt.clamp(min=0).long()
    if dtype == "int8":
        vi, sc = quantize_rows_int8(xt)
        packed, pscales = vi[idx].contiguous(), sc[idx].contiguous()
        rows = vi.float() * sc[:, None]
    else:
        packed, pscales = xt.bfloat16()[idx].contiguous(), None
        rows = xt.bfloat16()
    qf = torch.from_numpy(q).to(dev)
    qn2 = squared_norms(qf)[:, None]
    et = torch.from_numpy(ent).to(dev)
    e_d = gathered_distances(qf, rows[et.clamp(min=0).long()], metric)
    e_d = torch.where(et >= 0, e_d, float("inf"))
    return qf, qn2, nbt, packed, pscales, (e_d, et)


def _first_beam(init, ef):
    e_d, et = init
    b, r = et.shape
    dev = et.device
    beam_d = torch.full((b, ef), float("inf"), device=dev)
    beam_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_d[:, : min(r, ef)] = e_d[:, :ef]
    beam_i[:, : min(r, ef)] = et[:, :ef]
    return (beam_d, beam_i, torch.zeros((b, ef), dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.int64, device=dev))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_plain_wrapper_ors_the_go_on_flag(dtype):
    """On CPU tensors ``beam_step`` is ``beam_step_plain`` and ORs the new
    beam's ``go_on`` into the flag, leaving a set flag set."""
    qf, qn2, nb, packed, ps, init = _graph(7, 16, 8, 60, dtype, "l2")
    state = _first_beam(init, 12)
    for start in (0, 1):
        flag = torch.full((1,), start, dtype=torch.int32)
        out = bs.beam_step(qf, qn2, *state, nb, packed, "l2", 4, 3, pscales=ps,
                           flag=flag)
        want = bs.beam_step_plain(qf, qn2, *state, nb, "l2", 4, 3, packed=packed,
                                  pscales=ps)
        for a, w in zip(out, want):
            assert torch.equal(a, w)
        assert int(flag) == (start | int(bs.go_on(out[1], out[2], out[3], 3)))


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_loop_through_the_kernel_protocol_equals_eager(quant, metric, monkeypatch):
    """The beam loop with the engine forced to "kernel" on the CPU (its
    wrapper runs the plain step, the flags live in the device tensor the
    kernel would write): the same answers, steps and host reads as the
    eager loop."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    idx = HnswIndex(32, metric, m=8, ef_construction=32, capacity=2048,
                    wave_size=512, seed=5, device="cpu")
    idx.insert(np.arange(1500), x)
    idx.exact_small_n = 0
    idx.search_quant = quant
    idx.pack_neighbors()
    syncs = []
    for engine in ("eager", "kernel"):
        monkeypatch.setattr(hnsw_mod, "step_engine", lambda *a, _e=engine: _e)
        before = tracing.HOST_SYNCS["hnsw_beam"]
        got = idx.search(q, 10, ef_search=24)
        syncs.append(tracing.HOST_SYNCS["hnsw_beam"] - before)
        if engine == "eager":
            want = got
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert syncs[0] == syncs[1] > 0


# ── on the card ──

GRID = list(itertools.product(["bf16", "int8"], METRICS, [10, 64, 1024], [1, 8],
                              [16, 32], [64, 100, 384]))
# (name, dtype, metric, ef, expand, r0, d, cap, patience, dedup)
SPECIAL = [
    (f"{name}-{dtype}-{metric}", dtype, metric, *rest)
    for dtype in ("bf16", "int8") for metric in METRICS
    for name, *rest in (
        ("fewer_rows_than_ef", 64, 8, 32, 100, 40, 0, True),
        ("dedup_off", 64, 8, 32, 384, 300, 0, False),
        ("short_patience", 24, 4, 16, 64, 300, 3, True),
    )
]


def _steps_agree(card, seed, dtype, metric, ef, expand, r0, d, *, cap=300,
                 patience=0, dedup=True, steps=12):
    """Run the kernel and the plain step side by side from one first beam,
    ``steps`` steps (past the point where the loop would stop), and hold
    the kernel's state and go-on flag bit for bit to the plain's."""
    qf, qn2, nb, packed, ps, init = _graph(seed, d, r0, cap, dtype, metric,
                                           device=str(card))
    e = min(expand, ef)
    if patience <= 0:
        patience = max(ef // 4, 10)
    plain = _first_beam(init, ef)
    kern = tuple(t.clone() for t in plain)
    flags = torch.zeros(steps, dtype=torch.int32, device=card)
    _build.reset_launches()
    for step in range(steps):
        plain = bs.beam_step_plain(qf, qn2, *plain, nb, metric, e, patience,
                                   packed=packed, pscales=ps, dedup=dedup)
        kern = bs.beam_step_cuda(qf, qn2, *kern, nb, packed, metric, e, patience,
                                 pscales=ps, dedup=dedup,
                                 flag=flags[step : step + 1])
        torch.cuda.synchronize()
        names = ("distances", "slots", "expanded", "stall")
        for name, k, p in zip(names, kern, plain):
            if k.dtype == torch.float32:
                k, p = k.view(torch.int32), p.view(torch.int32)
            assert torch.equal(k, p), f"step {step}: {name} differ"
        want = int(bs.go_on(plain[1], plain[2], plain[3], patience))
        assert int(flags[step]) == want, f"step {step}: go-on flag"
    assert _build.LAUNCHES["beam_step"] == steps
    assert _build.LAUNCHES["beam_dots"] + _build.LAUNCHES["beam_dots_int8"] > 0


@pytest.mark.card
@pytest.mark.parametrize("dtype, metric, ef, expand, r0, d", GRID)
def test_kernel_step_equals_plain(card, dtype, metric, ef, expand, r0, d):
    _steps_agree(card, ef * 7 + d + r0, dtype, metric, ef, expand, r0, d)


@pytest.mark.card
@pytest.mark.parametrize("name, dtype, metric, ef, expand, r0, d, cap, patience, dedup",
                         SPECIAL, ids=[s[0] for s in SPECIAL])
def test_kernel_step_equals_plain_special(card, name, dtype, metric, ef, expand,
                                          r0, d, cap, patience, dedup):
    _steps_agree(card, len(name) + d, dtype, metric, ef, expand, r0, d, cap=cap,
                 patience=patience, dedup=dedup)


@pytest.mark.card
@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_equals_eager_path(card, quant, metric, monkeypatch):
    """A whole ``HnswIndex`` search on the card through the kernel against
    the same search with every step eager: the same ids and distances; the
    kernel launched once a step the eager path ran, and no ``beam_dots``."""
    rng = np.random.default_rng(21)
    n, d = 6000, 96
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:300] + 0.1 * rng.standard_normal((300, d)).astype(np.float32)
    idx = HnswIndex(d, metric, m=8, ef_construction=64, capacity=n,
                    wave_size=1024, seed=9, expand=8, device=card)
    idx.insert(np.arange(n), x)
    idx.exact_small_n = 0
    idx.search_quant = quant
    _build.reset_launches()
    kid, kdist = idx.search(q, 10, ef_search=48)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert launches["beam_step"] > 0, launches
    assert launches["beam_dots"] == launches["beam_dots_int8"] == 0, launches

    calls = []
    real = hnsw_mod.beam_step_plain
    monkeypatch.setattr(hnsw_mod, "step_engine", lambda *a: "eager")
    monkeypatch.setattr(hnsw_mod, "beam_step_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    eid, edist = idx.search(q, 10, ef_search=48)
    np.testing.assert_array_equal(kid, eid)
    np.testing.assert_array_equal(kdist, edist)
    assert launches["beam_step"] == len(calls)
