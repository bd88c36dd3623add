"""muninn_tpu_torch.tracing on the CPU: the span tree of a search, one
request id per call, the counted host reads, the counter registry under
its old names, and the spans' times against their ``torch.profiler``
copies."""

import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from muninn_tpu_torch import FlatIndex, HnswIndex, IvfIndex, tracing
from muninn_tpu_torch.graph import traversal
from muninn_tpu_torch.ops import _build

D = 16


def _rows(n, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: (its result, the spans it
    recorded, the profiler)."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.spans(), prof


def _children(spans, parent):
    return [s for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent == parent.id]


def _names(spans):
    return [s.name for s in spans]


def _roots(spans):
    return [s for s in spans if s.parent is None]


def _check_request(spans, root, queries):
    """The API level of one search's tree: ``index.search`` over the device
    search, the download and the id map, all in one request."""
    assert root.name == "index.search" and root.attrs["queries"] == queries
    assert {s.request for s in spans} == {root.request}
    top = _children(spans, root)
    assert _names(top) == ["index.search_device", "index.download",
                           "index.ids_of"]
    assert top[1].attrs["bytes"] == queries * 10 * (4 + 4)
    assert top[2].attrs["rows"] == queries
    for s in spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    inner = _children(spans, top[0])
    assert inner[0].name == "index.upload"
    assert inner[0].attrs["bytes"] == queries * D * 4
    return inner


@pytest.fixture(scope="module")
def flat_rows():
    return _rows(3000), _rows(37, seed=1)


@pytest.mark.parametrize("precision, ops", [
    ("highest", ["ops.flat_topk"]),
    ("int8_rescored", ["ops.int8_retrieve", "ops.rescore"]),
])
def test_flat_span_tree(flat_rows, precision, ops):
    x, q = flat_rows
    idx = FlatIndex(D, "cosine", capacity=len(x), device="cpu",
                    precision=precision)
    idx.insert(np.arange(len(x)), x)
    _, spans, _ = _profiled(lambda: [idx.search(q, 10), idx.search(q[:5], 10)])
    roots = _roots(spans)
    assert len(roots) == 2 and roots[0].request != roots[1].request
    for root, b in zip(sorted(roots, key=lambda s: s.start_ns), (37, 5)):
        mine = [s for s in spans if s.request == root.request]
        inner = _check_request(mine, root, b)
        assert _names(inner[1:]) == ops
        assert inner[1].attrs["rows"] == len(x)
        assert root.attrs["host_syncs"] == 2


@pytest.fixture(scope="module")
def hnsw():
    idx = HnswIndex(D, "l2", m=8, ef_construction=32, capacity=2048,
                    wave_size=512, seed=3, device="cpu")
    idx.insert(np.arange(1500), _rows(1500, seed=2))
    idx.exact_small_n = 0  # search by the beam at this size
    return idx


def test_hnsw_fused_span_tree_and_host_syncs(hnsw):
    q = _rows(40, seed=4)
    _, spans, _ = _profiled(lambda: hnsw.search(q, 10, ef_search=32))
    (root,) = _roots(spans)
    (chunk,) = _check_request(spans, root, 40)[1:]
    assert chunk.name == "hnsw.chunk" and chunk.attrs["rows"] == 40
    route, beam, rescore = _children(spans, chunk)
    assert _names([route, beam, rescore]) == ["hnsw.route", "hnsw.beam",
                                              "hnsw.rescore"]
    assert beam.attrs["engine"] == "eager"  # the CPU's step, row path
    steps = _children(spans, beam)
    assert len(steps) == beam.attrs["steps"] >= 2
    assert [s.attrs["step"] for s in steps] == list(range(len(steps)))
    for step in steps:
        assert _names(_children(spans, step)) == ["hnsw.step_read"]
    # one flag read a step entered, two downloads
    assert root.attrs["host_syncs"] == beam.attrs["steps"] + 2


def test_hnsw_beam_engine_attribute_keeps_the_step_tree(hnsw, monkeypatch):
    """The ``hnsw.beam`` span names its step engine; with the kernel's flag
    protocol (the engine forced to "kernel": on CPU tensors its wrapper runs
    the plain step) the steps keep their tree, one read a step, and the
    request its host reads."""
    from muninn_tpu_torch.index import hnsw as hnsw_mod

    hnsw.pack_neighbors()
    q = _rows(40, seed=4)
    trees = {}
    for engine in ("eager", "kernel"):
        monkeypatch.setattr(hnsw_mod, "step_engine", lambda *a, _e=engine: _e)
        _, spans, _ = _profiled(lambda: hnsw.search(q, 10, ef_search=32))
        (root,) = _roots(spans)
        (beam,) = [s for s in spans if s.name == "hnsw.beam"]
        assert beam.attrs["engine"] == engine
        steps = _children(spans, beam)
        assert len(steps) == beam.attrs["steps"] >= 2
        assert [s.attrs["step"] for s in steps] == list(range(len(steps)))
        for step in steps:
            assert _names(_children(spans, step)) == ["hnsw.step_read"]
        assert root.attrs["host_syncs"] == beam.attrs["steps"] + 2
        trees[engine] = (beam.attrs["steps"], root.attrs["host_syncs"])
    assert trees["eager"] == trees["kernel"]


def test_hnsw_whole_beam_span_tree(hnsw):
    hnsw.pack_neighbors()
    hnsw.beam_whole = "force"
    try:
        q = _rows(24, seed=5)
        _, spans, _ = _profiled(lambda: hnsw.search(q, 10, ef_search=32))
    finally:
        hnsw.beam_whole = False
    (root,) = _roots(spans)
    (chunk,) = _check_request(spans, root, 24)[1:]
    assert _names(_children(spans, chunk)) == ["hnsw.route", "hnsw.beam_whole",
                                               "hnsw.rescore"]
    assert root.attrs["host_syncs"] == 2
    assert not any(s.name.startswith("hnsw.beam_step") for s in spans)


def _delete_waves(device):
    """A delete of 150 ids in waves of 64 (three waves) under a profiler:
    its ``hnsw.repair`` spans and the counters it moved."""
    idx = HnswIndex(D, "l2", m=8, ef_construction=32, capacity=2048,
                    wave_size=64, seed=3, device=device)
    idx.insert(np.arange(1500), _rows(1500, seed=2))
    _build.reset_launches()
    tracing.reset_host_syncs()
    _, spans, _ = _profiled(lambda: idx.delete(np.arange(0, 1500, 10)))
    return ([s for s in spans if s.name == "hnsw.repair"], dict(_build.LAUNCHES),
            dict(tracing.HOST_SYNCS))


def test_cpu_delete_repair_is_eager():
    """On the CPU each delete wave's repair is the eager one: its span says
    so with the rows it rewrote, after one read of the wave's two counts."""
    repairs, launches, syncs = _delete_waves("cpu")
    assert [s.attrs["engine"] for s in repairs] == ["eager"] * 3
    assert all(s.attrs["rows"] > 0 for s in repairs)
    assert syncs["hnsw_delete_counts"] == 3 and launches["delete_repair"] == 0


@pytest.mark.card
def test_card_delete_repair_is_one_launch_a_wave():
    """On the card each delete wave's repair is one ``delete_repair`` launch
    and reads nothing back; no ``flat_topk`` launch is left in it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100 machine")
    repairs, launches, syncs = _delete_waves("cuda")
    assert [s.attrs["engine"] for s in repairs] == ["kernel"] * 3
    assert launches["delete_repair"] == 3 and launches["flat_topk"] == 0
    assert syncs["hnsw_delete_counts"] == 0


def test_ivf_api_spans():
    x = _rows(2500, seed=6)
    idx = IvfIndex(D, "cosine", cluster_size=64, nprobe=4, kmeans_iters=2,
                   capacity=len(x), device="cpu")
    idx.insert(np.arange(len(x)), x)
    idx.rebuild()
    (ids, _), spans, _ = _profiled(lambda: idx.search(_rows(9, seed=7), 10))
    (root,) = _roots(spans)
    assert _names(_check_request(spans, root, 9)) == ["index.upload"]
    assert ids.shape == (9, 10)


def test_single_query_is_one_request(flat_rows):
    x, q = flat_rows
    idx = FlatIndex(D, "cosine", capacity=len(x), device="cpu")
    idx.insert(np.arange(len(x)), x)
    (ids, d), spans, _ = _profiled(lambda: idx.search(q[0], 10))
    assert ids.shape == d.shape == (10,)
    (root,) = _roots(spans)
    _check_request(spans, root, 1)


def test_no_span_without_a_profiler_while_counters_count(flat_rows, hnsw):
    x, q = flat_rows
    idx = FlatIndex(D, "cosine", capacity=len(x), device="cpu")
    idx.insert(np.arange(len(x)), x)
    tracing.reset()
    tracing.reset_host_syncs()
    assert not torch.autograd._profiler_enabled()
    idx.search(q, 10)
    hnsw.search(q, 10, ef_search=32)
    assert tracing.spans() == []
    assert tracing.HOST_SYNCS["download"] == 4
    assert tracing.HOST_SYNCS["hnsw_beam"] >= 2
    with tracing.span("a", rows=1) as a, tracing.request("b") as b:
        a.set(x=1)
        b.set(y=2)
    assert a is b and tracing.spans() == []


def test_registry_is_shared_under_the_old_names():
    assert _build.LAUNCHES is tracing.LAUNCHES
    assert traversal.HOST_SYNCS is tracing.HOST_SYNCS
    assert {"bfs", "leiden", "download", "hnsw_beam"} <= set(tracing.HOST_SYNCS)
    _build.LAUNCHES["flat_topk"] += 3
    _build.reset_launches()
    assert not any(tracing.LAUNCHES.values())
    traversal.HOST_SYNCS["bfs"] += 2
    traversal.reset_host_syncs()
    assert not any(tracing.HOST_SYNCS.values())


def test_host_read_counts_and_reads():
    tracing.reset_host_syncs()
    flag = torch.tensor([False, True]).any()
    assert tracing.host_read("hnsw_beam", flag) is True
    arr = tracing.host_read("download", torch.arange(6).reshape(2, 3))
    assert isinstance(arr, np.ndarray) and arr.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert tracing.HOST_SYNCS["hnsw_beam"] == tracing.HOST_SYNCS["download"] == 1


def test_buffer_is_bounded_and_reset_clears(monkeypatch):
    monkeypatch.setattr(tracing, "_SPANS", tracing.deque(maxlen=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert _names(tracing.spans()) == ["s2", "s3", "s4"]
    tracing.reset()
    assert tracing.spans() == []
    assert tracing.MAX_SPANS >= 1 << 16


def test_ranges_are_muninn_and_agree_with_kineto(flat_rows, hnsw):
    x, q = flat_rows
    idx = FlatIndex(D, "cosine", capacity=len(x), device="cpu",
                    precision="int8_rescored")
    idx.insert(np.arange(len(x)), x)

    def work():
        for _ in range(3):
            idx.search(q, 10)
            hnsw.search(q, 10, ef_search=32)
    _, spans, prof = _profiled(work)
    kin = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() != torch.autograd.DeviceType.CUDA]
    assert not any(e.name().startswith("span:") for e in kin)
    ranges = sorted((e for e in kin if e.name().startswith(tracing.PREFIX)),
                    key=lambda e: e.start_ns())
    mine = sorted(spans, key=lambda s: s.start_ns)
    assert [e.name() for e in ranges] == [tracing.PREFIX + s.name for s in mine]
    starts = [abs(s.start_ns - e.start_ns()) for s, e in zip(mine, ranges)]
    ends = [abs(s.end_ns - e.end_ns()) for s, e in zip(mine, ranges)]
    assert statistics.median(starts) < 50_000
    assert statistics.median(ends) < 50_000
    # each span's times enclose its range
    assert all(s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns
               for s, e in zip(mine, ranges))


def test_import_decides_nothing_about_a_card():
    code = ("import torch, muninn_tpu_torch, muninn_tpu_torch.tracing as t\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert t._recording is torch.autograd._profiler_enabled\n"
            "import sys; assert 'triton' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
