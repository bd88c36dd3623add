"""CPU self-tests of the ``c100k-384.churn`` cell (``engines/hnsw_churn.py``,
``traffic/churn.json``) and of its four per-layer readers
(``per_layer/hnsw.insert_ms.py``, ``hnsw.delete_ms.py``,
``hnsw.repack_rows_per_req.py``, ``store.slot_waste.py``, through
``program_writes.py``): the tiny run judged state by state, the faults that
must make it not correct, the traffic's writes, the replay of the live rows,
the readers on a made-up timeline and in a tiny traced run, and the form of
the new entries in ``BENCHMARK.json``.

    python -m pytest portbench -q
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from muninn_tpu_torch import tracing
from portbench.run import ROOT, Bench, Run
from portbench.test_portbench import (CELLS, NAME, SPEC, UNIT, SEED, TinyBench,
                                      _half, _stale)
from portbench.test_program_spans import FakeRun, _span, _timeline

CELL = "c100k-384.churn"
SMALL = {"upserts": 48, "deletes": 48, "inserts": 48, "zipf": 0.99}
READERS = {"hnsw.insert_ms": ("ms", "program_span", "HNSW writes"),
           "hnsw.delete_ms": ("ms", "program_span", "HNSW writes"),
           "hnsw.repack_rows_per_req": ("rows/req", "program_counter",
                                        "HNSW beam glue"),
           "store.slot_waste": ("%", "program_counter", "index API")}


def _run(seconds=0.5, churn=SMALL, trace=False, patch=None) -> Run:
    """A tiny run of the cell at ``churn``'s sizes, set up and measured; an
    untimed run measures again until it made three requests."""
    bench = TinyBench()
    cell = bench.cell(CELL)
    cell.params["churn"] = dict(churn)
    run = Run(bench, cell, SEED, "cpu")
    run.setup(time.perf_counter())
    if patch is not None:
        patch(run)
    run.window(seconds, trace)
    while seconds and not trace and run.attempted < 3:
        run.window(seconds)
    return run


def _finish(run: Run) -> Run:
    run.close()
    run.judge()
    return run


def test_tiny_run_is_correct_state_by_state():
    """Several requests that write: correct when each answer is judged
    against the rows of its own state, one state a request."""
    run = _finish(_run())
    assert run.failed == 0 and run.attempted >= 3, run.errors
    assert run.correct, run.checks()
    assert run.states == run.attempted == len({a[4] for a in run.kept})
    assert sorted({a[4] for a in run.kept}) == list(range(3, run.epoch + 1))


def _altered(run, monkeypatch):
    """One id of every query's answer moved to a neighbouring slot where
    the rescore produces it."""
    import muninn_tpu_torch.index.hnsw as hnsw

    orig = hnsw._rescore_topk

    def altered(*args, **kwargs):
        d, s = orig(*args, **kwargs)
        s = s.clone()
        s[:, 0] = torch.where(s[:, 0] > 0, s[:, 0] - 1, s[:, 0] + 1)
        return d, s
    monkeypatch.setattr(hnsw, "_rescore_topk", altered)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_makes_the_run_not_correct(fault, monkeypatch):
    patch = {"stale": _stale, "half": _half,
             "altered": lambda run: _altered(run, monkeypatch)}[fault]
    run = _finish(_run(patch=patch))
    assert run.failed == 0 and run.states > 1
    assert not run.correct, run.checks()


def test_a_request_writes_the_traffics_rows():
    """At the traffic's own sizes: a request deletes 2,048 ids, half of them
    upserted under the same ids, and inserts 2,048, so that the live count
    stays; the upserts come from the hottest ranks, the new ids go last."""
    p = Bench().cell(CELL).params["churn"]
    assert p == {"upserts": 1024, "deletes": 1024, "inserts": 1024, "zipf": 0.99}
    run = _run(seconds=0.0, churn=p)
    c = run.churn
    live = len(run.index)
    order = c.order.copy()
    _, ids, dists, written = run.request(run, 7)
    dead, put = c.log[-1]
    assert written == 4096 == len(dead) + len(put) and len(run.index) == live
    ups = np.intersect1d(dead, put)
    assert len(ups) == 1024 and len(np.unique(dead)) == 2048
    rank = {int(i): r for r, i in enumerate(order)}
    # Zipf(0.99) over 12,000 ranks: the hottest ids are all upserted, and
    # half the upserts lie in the first fifth
    assert set(order[:16].tolist()) <= set(ups.tolist())
    assert np.median([rank[int(i)] for i in ups]) < len(order) / 5
    assert (c.order[-1024:] == put[1024:]).all() and len(c.order) == live
    assert ids.shape == (64, 10) and run.epoch == len(c.log)


def test_live_rows_replay_the_index():
    """The rows ``live_rows`` replays from the seed for the last state are
    the index's own live rows, bit for bit; an earlier state replays again
    from the seed."""
    run = _run()
    x, ext = run.live_rows(run)
    st = run.index.store
    assert len(ext) == len(st)
    slots = st.slots_of(ext)
    assert torch.equal(st.vectors[torch.from_numpy(slots).long()], x)
    x1, ext1 = run.live_rows(run, 1)
    assert len(ext1) == len(ext) and not np.array_equal(ext1, ext)
    x2, ext2 = run.live_rows(run)
    assert torch.equal(x2, x) and np.array_equal(ext2, ext)


def _read(name, run):
    return Bench().module("per_layer", name).read(run)


def _writes(recorded):
    """Write spans around the made-up timeline's two searches: a delete and
    an insert before each, one more insert outside the window, and a
    re-gather in each search."""
    base = max(s.id for s in recorded) + 1
    more = [
        _span("index.delete", 9, 10, base, None, 50, rows=8),
        _span("index.insert", 10, 10.5, base + 1, None, 51, rows=8,
              high_watermark=110, live=100),
        _span("index.delete", 99, 100, base + 2, None, 52, 2000, rows=8),
        _span("index.insert", 100, 101, base + 3, None, 53, 2000, rows=8,
              high_watermark=102, live=100),
        _span("index.insert", -900, -800, base + 4, None, 54, rows=8,
              high_watermark=999, live=1),
        _span("hnsw.repack", 2.5, 3, base + 5, 2, 1, rows=30, whole=0),
        _span("hnsw.repack", 101.5, 102, base + 6, 12, 2, 2000, rows=10, whole=0),
    ]
    return recorded + more


def test_readers_on_a_timeline(monkeypatch):
    tr, recorded = _timeline()
    monkeypatch.setattr(tracing, "spans", lambda: list(_writes(recorded)))
    run = FakeRun(tr)
    # the window's two inserts, 0.5 and 1 us, and two deletes of 1 us, over
    # two requests
    assert _read("hnsw.insert_ms", run) == pytest.approx(1.5e-3 / 2)
    assert _read("hnsw.delete_ms", run) == pytest.approx(2e-3 / 2)
    assert _read("hnsw.repack_rows_per_req", run) == pytest.approx(20)
    assert _read("store.slot_waste", run) == pytest.approx(2.0)  # 102 over 100
    monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    for name in READERS:  # a port or a cell without writes
        assert _read(name, run) is None


def test_tiny_traced_run_reports_the_new_metrics():
    """A traced tiny run with the packed table forced on the CPU: the four
    readers find their spans; no slot is wasted, the re-gathers stay below
    the table's rows."""
    tracing.reset()
    run = _finish(_run(seconds=1.5, trace=True,
                       patch=lambda run: run.index.pack_neighbors()))
    line = run.line(trace=True)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    assert set(READERS) <= set(got)
    assert got["hnsw.insert_ms"]["value"] > 0 and got["hnsw.delete_ms"]["value"] > 0
    assert 0 < got["hnsw.repack_rows_per_req"]["value"] < 16_384
    assert got["store.slot_waste"]["value"] == 0.0
    assert {"index.host_ms", "ops.kernels_per_req", "device.idle"} <= set(got)


def test_entries_form():
    (cell,) = [w for w in SPEC["workloads"] if w["name"] == CELL]
    assert CELLS[-1] == CELL
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "minilm-100k-384-churn", "churn", 1)
    (conf,) = [c for c in SPEC["configs"] if c["name"] == cell["config"]]
    assert SPEC["configs"][-1] == conf
    (table,) = [c for c in SPEC["configs"] if c["name"] == "minilm-100k-384"]
    assert conf["source"] != table["source"]
    table, churn = (json.loads((ROOT / c["file"]).read_text()) for c in (table, conf))
    assert churn["reduced"] == conf["reduced"] == [] and churn["guarantees"]
    # the same table as the read-only cells search, at the same settings
    for key in ("rows", "dim", "metric", "k", "centres", "noise", "query_noise",
                "hnsw", "source_recall_at_10"):
        assert churn[key] == table[key], key
    layers = {m["layer"] for m in SPEC["per_layer"] if m["name"] not in READERS}
    got = {m["name"]: m for m in SPEC["per_layer"][-4:]}
    assert list(got) == list(READERS)
    for name, (unit, source, layer) in READERS.items():
        m = got[name]
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["unit"] == unit
        assert (m["source"], m["layer"], m["moves"]) == (source, layer, "p95_ms")
        assert m["better"] == "lower" and m["workloads"] == [CELL]
        assert layer in layers or layer == "HNSW writes"
