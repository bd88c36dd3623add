"""CPU self-tests of the readers of the program's own spans
(``program.py``, ``per_layer/ops.host_syncs_per_req.py``,
``per_layer/index.upload_ms.py``, ``per_layer/hnsw.step_idle_ms.py``): on a
made-up timeline, without spans, with spans that do not pair, in the
tiny traced runs, and the form of their entries in ``BENCHMARK.json``.

    python -m pytest portbench -q
"""

from __future__ import annotations

import sys

import pytest

from muninn_tpu_torch import tracing
from portbench import program
from portbench.run import Bench
from portbench.test_portbench import CELLS, NAME, SPEC, UNIT, tiny_run
from portbench.trace import Trace

NEW = {"ops.host_syncs_per_req": ("syncs/req", "program_counter", "dispatch",
                                  "p95_ms", CELLS),
       "index.upload_ms": ("ms", "program_span", "index API", "p95_ms", CELLS),
       "hnsw.step_idle_ms": ("ms", "program_span", "HNSW beam glue", "qps",
                             ["c100k-384.hnsw"])}
BASE_NS = 1_792_000_000_123_456_789  # the profiler's start, in unix ns


def _read(name, run):
    return Bench().module("per_layer", name).read(run)


class FakeRun:
    def __init__(self, trace):
        self.trace = trace


def _span(name, start_us, end_us, id_, parent, request, delay_ns=0, **attrs):
    """A program span at ``start_us``..``end_us`` on the trace's clock,
    stamped ``delay_ns`` later in unix ns, as the program stamps it."""
    return tracing.Span(name, BASE_NS + int(start_us * 1e3) + delay_ns,
                        BASE_NS + int(end_us * 1e3) + delay_ns, id_, parent,
                        request, attrs)


def _timeline():
    """Two HNSW-like requests: device ops, the benchmark's request spans and
    the program's spans."""
    ops = [("void beam_dots_kernel<8>(float const*)", 20, 24),
           ("void at::native::elementwise_kernel<128, 4>(int)", 26, 27),
           ("Memcpy HtoD (Pageable -> Device)", 3, 8),
           ("void beam_dots_kernel<8>(float const*)", 125, 131),
           ("Memcpy HtoD (Pageable -> Device)", 102, 106)]
    reqs = [("request", 0, 50), ("request", 100, 150)]
    spans = [
        _span("index.search", 1, 48, 1, None, 1, host_syncs=4),
        _span("index.search_device", 2, 44, 2, 1, 1),
        _span("index.upload", 2, 9, 3, 2, 1, bytes=4096),
        _span("hnsw.beam", 10, 40, 4, 2, 1, steps=2),
        _span("hnsw.beam_step", 10, 25, 5, 4, 1, step=0),
        _span("hnsw.step_read", 10, 12, 6, 5, 1),
        _span("hnsw.beam_step", 25, 40, 7, 4, 1, step=1),
        _span("hnsw.step_read", 25, 26, 8, 7, 1),
        _span("index.download", 44, 46, 9, 1, 1, bytes=64),
        _span("index.ids_of", 46, 48, 10, 1, 1, rows=2),
        # the second request's stamps lie 2 us later against its request
        _span("index.search", 101, 149, 11, None, 2, 2000, host_syncs=7),
        _span("index.search_device", 101, 140, 12, 11, 2, 2000),
        _span("index.upload", 101, 107, 13, 12, 2, 2000, bytes=4096),
        _span("hnsw.beam", 110, 135, 14, 12, 2, 2000, steps=1),
        _span("hnsw.beam_step", 110, 135, 15, 14, 2, 2000, step=0),
        _span("hnsw.step_read", 110, 111, 16, 15, 2, 2000),
    ]
    # a span of another call, before the window, is left out
    spans.insert(0, _span("hnsw.beam", -500, -400, 99, None, None))
    return Trace(ops, reqs, frozenset({"beam_dots_kernel"})), spans


@pytest.fixture
def spans(monkeypatch):
    """Sets what ``tracing.spans()`` returns."""
    def use(recorded):
        monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    return use


def test_placed_on_the_trace_clock(spans):
    tr, recorded = _timeline()
    spans(recorded)
    placed = program.placed(FakeRun(tr))
    assert len(placed) == len(recorded) - 1 and 99 not in {s.id for s in placed}
    search = {s.request: s for s in placed if s.name == "index.search"}
    # the smallest start difference is the first request's 1 us
    assert search[1].start == pytest.approx(0.0) and search[1].end == pytest.approx(47)
    assert search[2].start == pytest.approx(102) and search[2].end == pytest.approx(150)


def test_readers_on_a_timeline(spans):
    tr, recorded = _timeline()
    spans(recorded)
    run = FakeRun(tr)
    assert _read("ops.host_syncs_per_req", run) == pytest.approx((4 + 7) / 2)
    # uploads of 7 and 6 us over two requests
    assert _read("index.upload_ms", run) == pytest.approx((7 + 6) / 2 / 1e3)
    # placed on the trace's clock (1 us earlier): the steps at 9..24, 24..39
    # and 111..136; busy inside them 20..24 and 26..27, then 125..131
    idle = (15 - 4) + (15 - 1) + (25 - 6)
    assert _read("hnsw.step_idle_ms", run) == pytest.approx(idle / 2 / 1e3)


def test_idle_by_span_sums_to_the_windows_idle(spans):
    tr, recorded = _timeline()
    spans(recorded)
    run = FakeRun(tr)
    idle = program.idle_by_span(run, program.placed(run))
    assert sum(idle.values()) == pytest.approx(tr.window_us - tr.busy_us)
    assert idle["harness"] == pytest.approx(50)  # 50 .. 100
    assert idle["hnsw.step_read"] == pytest.approx(2 + 1 + 1)
    assert all(v >= -1e-9 for v in idle.values())


def test_none_without_spans(spans, monkeypatch):
    tr, _ = _timeline()
    spans([])
    for name in NEW:
        assert _read(name, FakeRun(tr)) is None
    # a port without the tracing module, as a commit before it
    monkeypatch.setitem(sys.modules, "muninn_tpu_torch.tracing", None)
    assert program.recorded() == []
    for name in NEW:
        assert _read(name, FakeRun(tr)) is None


@pytest.mark.parametrize("fault", ["extra", "missing", "outside"])
def test_none_when_spans_and_requests_do_not_pair(spans, fault):
    tr, recorded = _timeline()
    if fault == "extra":
        recorded.append(_span("index.search", 151, 152, 50, None, 3, host_syncs=2))
    elif fault == "missing":
        recorded = [s for s in recorded if s.id != 11]
    else:  # the second search outlasts its request by 10 us
        recorded = [s._replace(end_ns=s.end_ns + 10_000) if s.id == 11 else s
                    for s in recorded]
    spans(recorded)
    assert program.placed(FakeRun(tr)) is None
    for name in NEW:
        assert _read(name, FakeRun(tr)) is None


def test_new_entries_form():
    layers = {m["layer"] for m in SPEC["per_layer"] if m["name"] not in NEW}
    got = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in NEW}
    assert list(got) == list(NEW) == [m["name"] for m in SPEC["per_layer"][-3:]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for name, (unit, source, layer, moves, cells) in NEW.items():
        m = got[name]
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["unit"] == unit
        assert (m["source"], m["layer"], m["moves"]) == (source, layer, moves)
        assert m["better"] == "lower" and layer in layers
        assert m["workloads"] == cells
        assert set(cells) <= set(e2e[moves].get("workloads", CELLS))


@pytest.mark.parametrize("name", ["c100k-384.exact", "c1m-768.int8",
                                  "c100k-384.hnsw"])
def test_tiny_traced_run_reports_the_new_metrics(name):
    tracing.reset()
    run = tiny_run(name, trace=True)
    line = run.line(trace=True)
    assert line["correct"], line["checks"]
    want = {m for m, spec in NEW.items() if name in spec[4]}
    assert want <= set(line["metrics"])
    assert line["metrics"]["index.upload_ms"]["value"] > 0
    placed = program.placed(run)
    syncs = line["metrics"]["ops.host_syncs_per_req"]["value"]
    if name.endswith("hnsw"):
        steps = sum(s.attrs["steps"] for s in placed if s.name == "hnsw.beam")
        assert syncs == pytest.approx(steps / len(run.trace.requests) + 2)
        assert line["metrics"]["hnsw.step_idle_ms"]["value"] > 0
    else:
        assert syncs == 2
        assert "hnsw.step_idle_ms" not in line["metrics"]
    idle = program.idle_by_span(run, placed)
    assert sum(idle.values()) == pytest.approx(
        run.trace.window_us - run.trace.busy_us, rel=1e-6)
