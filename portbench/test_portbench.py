"""CPU self-tests of the benchmark: every cell's traffic at a tiny size
through the port's plain versions (``device="cpu"``) against the reference,
the result line's shape, discovery by file, the import checks, the kernel
counts, the controls and the faults that ``correct`` must catch. One test
runs on the card and skips here.

    python -m pytest portbench -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import data, reference
from portbench.control import control_numbers, readings
from portbench.peaks import bound_s
from portbench.run import ROOT, Bench, Run, foreign_modules, run_cell, seeded_rows
from portbench.trace import Cover, Trace, handwritten_kernels

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
# the cells' shapes cut to what the CPU runs in about a second: HNSW keeps
# more rows than its exact_small_n (8,192), so that the beam runs
TINY = {"rows": 12_000, "dim": 32, "centres": 50, "queries_per_request": 64,
        "pool_queries": 256}
TINY_HNSW = {"capacity": 16_384, "wave_size": 1024}
SEED = 2**31 + 11  # more than 32 signed bits hold


class TinyBench(Bench):
    """``Bench`` whose cells are cut to ``TINY``."""

    def cell(self, name):
        cell = super().cell(name)
        cell.params.update(TINY)
        if "hnsw" in cell.params:
            cell.params["hnsw"] = {**cell.params["hnsw"], **TINY_HNSW}
        return cell


def tiny_run(name, seconds=0.4, trace=False, patch=None, bench=None) -> Run:
    """One run of ``name`` on the CPU; ``patch(run)`` breaks it after set-up."""
    run = Run(bench or TinyBench(), (bench or TinyBench()).cell(name), SEED, "cpu")
    run.setup(time.perf_counter())
    if patch is not None:
        patch(run)
    run.window(seconds, trace)
    run.close()
    run.judge()
    return run


# ── every cell at a tiny size, and the line ──


@pytest.mark.parametrize("name", CELLS)
def test_cell_tiny_run_is_correct(name):
    run = tiny_run(name)
    assert run.correct, run.checks()
    assert run.failed == 0 and run.attempted >= 1
    assert set(run.checks()) == set(run.p["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_last_line_shape(name):
    run = tiny_run(name)
    line = json.loads(json.dumps(run.line(trace=False)))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "checks"]
    want = {m["name"] for m in SPEC["end_to_end"]
            if name in m.get("workloads", (name,))}
    assert set(line["metrics"]) == want
    for m in SPEC["end_to_end"]:
        if m["name"] in want:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(len(v) == 2 for v in line["checks"].values())


def test_traced_line_shape():
    run = tiny_run("c100k-384.exact", trace=True)
    line = run.line(trace=True)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert {g[0] for g in line["breakdown"]["idle_gaps"]} <= {
        "request", "search_device", "ids_of", "harness"}
    # the CPU has no device: only the host-side readers find something
    assert "index.host_ms" in line["metrics"]
    assert "flat_topk_roofline" not in line["metrics"]


# ── discovery by file ──


def test_configuration_found_from_a_new_file(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {"rows": 9_000, "dim": 24, "metric": "cosine", "k": 10, "centres": 30,
            "noise": 0.3, "query_noise": 0.05, "queries_per_request": 48,
            "source": "a test", "assumed": [], "reduced": []}
    (tmp_path / "portbench" / "configs" / "test-9k-24.json").write_text(json.dumps(conf))
    spec["configs"].append({"name": "test-9k-24", "source": "a test",
                            "file": "portbench/configs/test-9k-24.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "t9k.exact", "config": "test-9k-24",
                              "traffic": "exact", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path)
    cell = bench.cell("t9k.exact")
    cell.params["pool_queries"] = 192
    run = Run(bench, cell, SEED, "cpu")
    run.setup(time.perf_counter())
    run.window(0.3)
    run.close()
    run.judge()
    assert run.correct and run.batch == 48
    assert set(run.line(False)["metrics"]) == {"qps", "p95_ms", "setup_s"}


CHURN_ENGINE = '''
"""A test engine that owns its requests and its live rows: each request
inserts one far row under a new id, then searches a pool batch."""
import numpy as np
import torch
from muninn_tpu_torch import FlatIndex
from portbench.run import search_request, seeded_rows


def build(p, x, ids, seed):
    index = FlatIndex(p["dim"], p["metric"], capacity=p["rows"] + 4096,
                      device=x.device, precision=p["precision"])
    index.insert(ids, x)
    return index


def search(index, queries, k, p):
    return index.search(queries, k)


def request(run, i):
    if not hasattr(run, "churn"):
        x, ids = seeded_rows(run)
        run.churn = [[x], [ids]]
    row = torch.full((1, run.p["dim"]), 1000.0, device=run.device)
    new = np.array([run.churn[1][0].max() + 1 + sum(map(len, run.churn[1]))])
    run.index.insert(new, row)
    run.churn[0].append(row)
    run.churn[1].append(new)
    b, ids, dists, _ = search_request(run, i)
    return b, ids, dists, 1


def live_rows(run):
    return torch.cat(run.churn[0]), np.concatenate(run.churn[1])
'''


def test_engine_file_owns_requests_and_live_rows(tmp_path):
    """A mix that writes rows is a new engine file and a new traffic file:
    the run counts what it wrote and judges against the engine's live rows."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "engines" / "churntest.py").write_text(CHURN_ENGINE)
    traffic = json.loads((ROOT / "portbench" / "traffic" / "exact.json").read_text())
    traffic["engine"] = "churntest"
    (tmp_path / "portbench" / "traffic" / "churntest.json").write_text(json.dumps(traffic))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "c100k-384.churntest", "config": "minilm-100k-384",
                              "traffic": "churntest", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    run = tiny_run("c100k-384.churntest", bench=type("B", (TinyBench,), {})(tmp_path))
    assert run.correct, run.checks()
    assert run.written == run.attempted  # the window's writes alone
    x, ext = run.live_rows(run)
    # the two warm-up requests wrote a row each too
    assert len(ext) == len(x) == TINY["rows"] + run.written + 2


# ── answers judged against the live rows of their own state ──

CHURN_DELETES, CHURN_UPSERTS, CHURN_INSERTS = 16, 4, 8


def _churn_request(run, i, stale=False):
    """A request that writes, on a real ``HnswIndex(device="cpu")``: it
    deletes the top id of 16 queries of the last answer to its pool batch,
    gives 4 other ids of that answer new vectors near the batch's queries,
    and inserts 8 rows near them under new ids, so that the writes change
    what this batch's answers hold; it raises ``run.epoch`` and searches
    (``stale``: searches first, over the state before its writes)."""
    if getattr(run, "log", None) is None:
        run.log, run.live, run.last = [], set(run.ids.tolist()), {}
        run.next_id = int(run.ids.max()) + 1
    b = i % len(run.pool)
    queries = run.pool[b]
    if stale:
        ids, dists = run.engine.search(run.index, queries, run.k, run.p)
    rng = np.random.default_rng([run.seed, 3, i])
    last = run.last.get(b)
    gone = ups = np.zeros(0, np.int64)
    if last is not None:
        rows = rng.choice(len(last), CHURN_DELETES, replace=False)
        gone = np.array([j for j in dict.fromkeys(last[rows, 0].tolist())
                         if j in run.live], np.int64)
        spare = [j for j in dict.fromkeys(last[:, 1:].reshape(-1).tolist())
                 if j in run.live and j not in set(gone.tolist())]
        ups = np.array(spare[:CHURN_UPSERTS], np.int64)
    new = np.arange(run.next_id, run.next_id + CHURN_INSERTS, dtype=np.int64)
    run.next_id += CHURN_INSERTS
    put = np.concatenate([ups, new])
    near = torch.from_numpy(queries[rng.choice(len(queries), len(put), replace=False)])
    vecs = near + 0.01 * torch.from_numpy(
        rng.standard_normal(near.shape).astype(np.float32))
    vecs /= torch.linalg.norm(vecs, dim=1, keepdim=True)
    run.index.delete(np.concatenate([gone, ups]))
    run.index.insert(put, vecs)
    run.live -= set(gone.tolist())
    run.live |= set(new.tolist())
    run.log.append((np.concatenate([gone, ups]), put, vecs))
    run.epoch = len(run.log)
    if not stale:
        ids, dists = run.engine.search(run.index, queries, run.k, run.p)
    run.last[b] = ids
    return b, ids, dists, len(gone) + len(ups) + len(put)


def _churn_live_rows(run, state=None):
    """The rows live once the first ``state`` writes were made (all of
    them: None), replayed from the seed and the engine's log of ids and
    vectors written."""
    x, ids = seeded_rows(run)
    for gone, put, vecs in run.log[: len(run.log) if state is None else state]:
        keep = ~np.isin(ids, gone)
        x = torch.cat([x[torch.from_numpy(keep)], vecs])
        ids = np.concatenate([ids[keep], put])
    return x, ids


def churn_run(stale=False) -> Run:
    """A tiny run of the HNSW cell whose requests are ``_churn_request``."""
    bench = TinyBench()
    run = Run(bench, bench.cell("c100k-384.hnsw"), SEED, "cpu")
    run.request = lambda run, i: _churn_request(run, i, stale)
    run.live_rows = _churn_live_rows
    run.setup(time.perf_counter())
    run.window(0.6)
    run.close()
    run.judge()
    return run


def test_each_answer_is_judged_against_its_own_live_rows():
    """Requests that delete, upsert and insert rows before their search:
    correct under the judge of each state, and not against the last state
    alone, where rows deleted after an answer are ids no live row has."""
    run = churn_run()
    assert run.failed == 0 and run.written > 0
    assert run.correct, run.checks()
    assert run.states == len({a[4] for a in run.kept}) > 1
    run.kept = [(*a[:4], run.epoch) for a in run.kept]
    run.judge()
    assert run.states == 1 and run.numbers["bad_rows"] > 0


def test_answer_from_before_its_writes_is_not_correct():
    """An engine that searches before its writes and reports the state
    after them gives answers from an older state than it claims."""
    run = churn_run(stale=True)
    assert run.failed == 0 and run.states > 1
    assert not run.correct, run.checks()


def _judge_as_before(q, x, which, ans_rows, ans_d, ref_d, ref_rows, metric,
                     block=1024) -> dict:
    """The judge over one live set as it was before states were judged
    apart, kept as the reference that one state must equal bit for bit."""
    dev = x.device
    a_n, k = ans_rows.shape
    srt = np.sort(ans_rows, axis=1)
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    finite = np.isfinite(ans_d)
    desc = (np.diff(np.where(finite, ans_d, np.inf), axis=1) < 0).any(1)
    bad = (ans_rows < 0).any(1) | dup | ~finite.all(1) | desc
    dist_err = rank_gap = 0.0
    hits = 0
    for s in range(0, a_n, block):
        sl = slice(s, s + block)
        w = torch.from_numpy(which[sl]).to(dev)
        rr = torch.from_numpy(ans_rows[sl]).to(dev)
        known = rr >= 0
        qb = torch.from_numpy(q[which[sl]]).to(dev, torch.float64)
        d64 = reference.row_distances64(qb, x[rr.clamp(min=0)].double(), metric)
        ad = torch.from_numpy(ans_d[sl]).to(dev, torch.float64)
        ok = known & torch.isfinite(ad)
        if bool(ok.any()):
            dist_err = max(dist_err, float((ad - d64).abs()[ok].max()))
        good = torch.from_numpy(~bad[sl]).to(dev)
        if bool(good.any()):
            gap = (d64 - ref_d[w])[good]
            rank_gap = max(rank_gap, float(gap.max()))
        hits += int((ref_rows[w][:, :, None] == rr[:, None, :]).any(2).sum())
    return {"bad_rows": int(bad.sum()), "dist_err": dist_err,
            "rank_gap": rank_gap, f"miss_at_{k}": 1.0 - hits / max(a_n * k, 1)}


@pytest.mark.parametrize("name", CELLS)
def test_one_state_judges_as_before(name):
    """An engine without a state counter: the program's and the controls'
    numbers are those of one judge over every kept answer and one live
    set, bit for bit."""
    run = tiny_run(name)
    controls = {c: run.bench.module("controls", c) for c in run.p["controls"]}
    got = control_numbers(run, controls)
    assert run.states == 1
    kept = run.kept
    q, which = run.judged_queries(kept)
    x, ext = run.live_rows(run)
    ref_d, ref_rows = reference.exact_topk(q, x, run.k, run.p["metric"])
    rows, dists = run.answers(kept, ext)
    want = _judge_as_before(q, x, which, rows, dists, ref_d, ref_rows,
                            run.p["metric"])
    assert run.numbers == want
    for c, mod in controls.items():
        c_rows, c_dists = mod.answer(run, q, x)
        assert got[c] == _judge_as_before(q, x, np.arange(len(q)), c_rows, c_dists,
                                          ref_d, ref_rows, run.p["metric"])


@pytest.mark.parametrize("name", CELLS)
def test_split_states_pool_to_one_states_numbers(name):
    """One state's answers split into two states over the same live set
    pool to the numbers of the one."""
    run = tiny_run(name)
    one = dict(run.numbers)
    half = len(run.kept) // 2
    assert half >= 1
    run.kept = [(*a[:4], int(j >= half)) for j, a in enumerate(run.kept)]
    run.live_rows = lambda run, state: seeded_rows(run)
    run.judge()
    assert run.states == 2 and run.numbers == one


def test_churn_probe_judges_each_state():
    """``probes/churn_judge.py`` at a tiny size: its waves, deletes and
    searches are correct under the judge of each state, and not against the
    last state alone."""
    from portbench.probes import churn_judge

    run = churn_judge.churn_run(TinyBench(), SEED, "cpu",
                                sizes={"inserts": 64, "deletes": 32, "queries": 64})
    out = churn_judge.probe(run, 0.6, time.perf_counter())
    assert out["failed"] == 0 and out["correct"], out["checks"]
    assert out["states"] == out["requests"] > 1
    assert out["end_state_checks"]["bad_rows"][0] > 0
    assert out["store_after"]["high_watermark"] == (
        TINY["rows"] + 64 * (out["requests"] + 2))


def test_open_loop_arrivals_count_their_wait():
    """A traffic's ``arrivals_per_s`` sends requests at fixed times; a
    request that waits behind the one in flight counts the wait."""
    bench = TinyBench()
    cell = bench.cell("c100k-384.exact")
    run = Run(bench, cell, SEED, "cpu")
    run.setup(time.perf_counter())
    run.p["arrivals_per_s"] = 10.0
    run.window(0.45)
    assert run.attempted == 5  # due at 0, 0.1, 0.2, 0.3, 0.4 s
    assert run.window_s >= 0.4
    run.p["arrivals_per_s"] = 1e6  # every request due at once: each waits
    run.latencies.clear()
    run.window(0.2)
    assert run.latencies == sorted(run.latencies)
    run.close()
    run.judge()
    assert run.correct, run.checks()


# ── import checks ──


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    assert foreign_modules() == []
    monkeypatch.setitem(sys.modules, "muninn_tpu_torch_extra", sys)
    assert foreign_modules() == []
    monkeypatch.setitem(sys.modules, "muninn_tpu.index", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert foreign_modules() == ["jax", "muninn_tpu"]


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    code = ("import time, portbench.test_portbench as t\n"
            "run = t.tiny_run('c100k-384.hnsw', seconds=0.2)\n"
            "assert run.correct")
    assert not _modules_after(code) & {"jax", "jaxlib", "flax", "muninn_tpu"}


def test_reference_imports_nothing_of_the_port():
    code = ("import portbench.reference, portbench.data, portbench.peaks\n"
            "import importlib.util as u\n"
            "for n in ('tf32', 'int4_retrieve'):\n"
            "    s = u.spec_from_file_location(n, f'portbench/controls/{n}.py')\n"
            "    s.loader.exec_module(u.module_from_spec(s))")
    mods = _modules_after(code)
    assert not mods & {"muninn_tpu_torch", "muninn_tpu", "jax", "jaxlib", "flax"}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


# ── the reference ──


def test_reference_matches_brute_force_float64():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((700, 16)).astype(np.float32))
    q = rng.standard_normal((50, 16)).astype(np.float32)
    for metric in ("cosine", "l2", "inner_product"):
        d, r = reference.exact_topk(q, x, 7, metric, q_block=16, x_block=128)
        full = reference.distances64(torch.from_numpy(q).double(), x.double(), metric)
        want = torch.sort(full, dim=1).values[:, :7]
        assert torch.allclose(d, want, rtol=0, atol=1e-12)
        assert torch.allclose(torch.gather(full, 1, r), d, rtol=0, atol=1e-12)


def test_judge_numbers():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(data.rows(data.generator(5, torch.device("cpu")),
                                   {**TINY, "rows": 500, "noise": 0.3},
                                   torch.device("cpu")).numpy())
    q = rng.standard_normal((8, 32)).astype(np.float32)
    ref_d, ref_rows = reference.exact_topk(q, x, 10, "cosine")
    rows, dists = ref_rows.numpy().copy(), ref_d.numpy().astype(np.float32)
    which = np.arange(8)
    ok = reference.judge(q, x, which, rows, dists, ref_d, ref_rows, "cosine")
    assert ok["bad_rows"] == 0 and ok["miss_at_10"] == 0.0
    assert ok["dist_err"] < 1e-7 and ok["rank_gap"] == 0.0
    rows2 = rows.copy()
    rows2[0, 0] = rows2[0, 1]  # an id twice
    rows2[1, 9] = -1           # an id no row has
    bad = reference.judge(q, x, which, rows2, dists, ref_d, ref_rows, "cosine")
    assert bad["bad_rows"] == 2
    assert bad["miss_at_10"] == pytest.approx(2 / 80)


def test_rows_of_maps_ids_back():
    ext = data.external_ids(SEED, 1000)
    assert (ext >= data.ID_BASE).all() and len(set(ext)) == 1000
    assert np.array_equal(data.rows_of(ext[[5, 7]], ext), [5, 7])
    assert np.array_equal(data.rows_of([-1, 3, data.ID_BASE + 1000], ext), [-1, -1, -1])


def test_same_seed_same_data():
    cpu = torch.device("cpu")
    a = data.rows(data.generator(SEED, cpu), {**TINY, "noise": 0.3}, cpu)
    b = data.rows(data.generator(SEED, cpu), {**TINY, "noise": 0.3}, cpu)
    c = data.rows(data.generator(SEED + 1, cpu), {**TINY, "noise": 0.3}, cpu)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.allclose(torch.linalg.norm(a, dim=1), torch.ones(len(a)))


# ── kernel counts, pinned to PERF.md section 6's bounds ──


def _bound_ms(kernel: str, **p) -> float:
    count = Bench().module("kernels", kernel)
    ops, nbytes = count.work(p)
    return bound_s(ops, count.PEAK, nbytes) * 1e3


def test_kernel_counts_match_perf_md_bounds():
    p100k = dict(queries_per_request=8192, rows=100_000, dim=384, k=10)
    assert _bound_ms("flat_topk", **p100k) == pytest.approx(9.390, abs=5e-4)
    p1m = dict(queries_per_request=1024, rows=1_000_000, dim=768, k=10)
    assert _bound_ms("flat_topk", **p1m) == pytest.approx(23.476, abs=5e-4)
    s8 = dict(queries_per_request=8192, rows=1_000_000, dim=768, rescore_r=16)
    assert _bound_ms("flat_topk_mma", **s8) == pytest.approx(6.358, abs=5e-4)


def test_kernel_names_are_the_programs():
    names = handwritten_kernels()
    assert {"flat_topk_kernel", "flat_topk_mma_kernel", "beam_dots_kernel",
            "beam_topm_kernel", "beam_loop_kernel", "gather_rows_kernel"} <= names
    for kernel in ("flat_topk", "flat_topk_mma"):
        assert Bench().module("kernels", kernel).NAME in names


# ── the trace readers on a made-up timeline ──


def test_trace_readers_on_a_timeline():
    ops = [("void flat_topk_kernel<128>(float const*)", 10, 60),
           ("Memcpy HtoD (Pageable -> Device)", 2, 8),
           ("void at::native::elementwise_kernel<128, 4>(int)", 62, 64),
           ("void flat_topk_kernel<128>(float const*)", 110, 150)]
    spans = [("request", 0, 70), ("search_device", 1, 66), ("ids_of", 66, 69),
             ("request", 100, 160), ("search_device", 101, 155),
             ("ids_of", 155, 158)]
    tr = Trace(ops, spans, frozenset({"flat_topk_kernel"}))
    assert tr.window == (0, 160) and tr.busy_us == 6 + 50 + 2 + 40
    idle = tr.idle_by_span()
    assert sum(idle.values()) == pytest.approx(160 - 98)
    assert idle["harness"] == pytest.approx(30)  # 70 .. 100
    assert idle["ids_of"] == pytest.approx(3 + 3)
    bench = Bench()

    class FakeRun:
        trace = tr
        p = dict(queries_per_request=8192, rows=100_000, dim=384, k=10)

        def roofline(self, kernel):
            return Run.roofline(self, kernel)
    FakeRun.bench = bench
    run = FakeRun()
    # outside search_device, with no device op: 0..1 and 66..70; 100..101
    # and 155..160 (the launches' gaps inside search_device are not counted)
    host = bench.module("per_layer", "index.host_ms").read(run)
    assert host == pytest.approx(((1 + 4) + (1 + 5)) / 2 / 1e3)
    assert bench.module("per_layer", "ops.kernels_per_req").read(run) == 1.5
    assert bench.module("per_layer", "hnsw.glue_ms").read(run) == pytest.approx(1e-3)
    assert bench.module("per_layer", "device.idle").read(run) == pytest.approx(
        100 * (1 - 98 / 160))
    roof = bench.module("per_layer", "flat_topk_roofline").read(run)
    assert roof == pytest.approx(100 * 2 * 9.390e-3 / 90e-6, rel=1e-3)
    assert bench.module("per_layer", "flat_topk_mma_roofline").read(run) is None
    top = tr.breakdown()["device_ops"]
    assert top[0] == ["flat_topk_kernel<128>", pytest.approx(90e-6)]


def test_cover_within():
    c = Cover([(0, 2), (1, 3), (5, 6)])
    assert c.within(0, 10) == 4 and c.within(2.5, 5.5) == 1.0 and c.within(7, 9) == 0


# ── controls: the reference one precision down must fail ──


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = readings(TinyBench(), name, SEED, 0.3, device="cpu")
    assert out["correct"]
    assert out["tf32"]["correct"] is False
    assert out["tf32"]["dist_err"] > 10 * out["program"]["dist_err"]


def test_tf32_rounds_to_ten_mantissa_bits():
    tf32 = Bench().module("controls", "tf32").tf32
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 0.1])
    y = tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0 + 2**-9, -1.0]  # ties to even
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


# ── faults under the timed path: correct must come out false ──


def _stale(run):
    """Every request answered with the answer to the pool's last batch."""
    kept = run.engine.search(run.index, run.pool[-1], run.k, run.p)
    run.engine.search = lambda index, q, k, p: kept


def _half(run):
    search = run.engine.search

    def half(index, q, k, p):
        ids, d = search(index, q[: len(q) // 2], k, p)
        return np.concatenate([ids, ids]), np.concatenate([d, d])
    run.engine.search = half


def _alter(run, monkeypatch):
    """One id of every query's answer moved to a neighbouring slot where
    the program produces it."""
    import muninn_tpu_torch.index.flat as flat
    import muninn_tpu_torch.index.hnsw as hnsw

    site = {"highest": (flat, "flat_topk"), "int8_rescored": (flat, "rescore")}
    mod, fn = (hnsw, "_rescore_topk") if run.p["engine"] == "hnsw" else \
        site[run.p["precision"]]
    orig = getattr(mod, fn)

    def altered(*args, **kwargs):
        d, s = orig(*args, **kwargs)
        s = s.clone()
        s[:, 0] = torch.where(s[:, 0] > 0, s[:, 0] - 1, s[:, 0] + 1)
        return d, s
    monkeypatch.setattr(mod, fn, altered)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_not_correct(name, fault, monkeypatch):
    patch = {"stale": _stale, "half": _half,
             "altered": lambda run: _alter(run, monkeypatch)}[fault]
    run = tiny_run(name, patch=patch)
    assert run.failed == 0
    assert not run.correct, run.checks()


# ── BENCHMARK.json against the contract's form ──

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    used = {w["config"] for w in SPEC["workloads"]}
    assert set(names) == used and len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in (*SPEC["end_to_end"], *SPEC["per_layer"]):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert (ROOT / "portbench" / "end_to_end" / f"{m['name']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (ROOT / "portbench" / "per_layer" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS) for m in SPEC["per_layer"])


# ── on the card ──


@pytest.mark.card
def test_cell_on_the_card(card):
    run = run_cell(Bench(), "c100k-384.exact", SEED, 1.0, trace=True,
                   device=str(card), t0=time.perf_counter())
    line = run.line(trace=True)
    assert line["correct"], line["checks"]
    assert 0 < line["metrics"]["flat_topk_roofline"]["value"] <= 100
    assert line["device"]["busy_s"] > 0
