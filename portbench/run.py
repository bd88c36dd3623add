"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A run is one process: it makes the cell's rows
and a pool of query batches from the seed on the card, builds the index
through the port's public API, sends two warm-up requests, then a closed
loop of one client with one request in flight for ``--seconds``. A request
is what the traffic's engine (``engines/<name>.py``) makes it: its
``request(run, i)`` where it has one, else ``search_request``, one
``search`` of a pool batch (numpy queries in, external ids and distances
out as numpy), the pool cycled. After the window it reads the peak device
memory, frees the index, judges a seeded sample of every request's answers
against the float64 reference (``reference.py``) over the rows that were
live when the answer was given, and checks that no module of JAX or of the
JAX package was loaded.

The live rows: an engine whose requests change them (a delete, an insert, a
new vector under an existing id) keeps a state counter, ``run.epoch``: an
int that each such request raises before its own search. The run stores
the counter's value after each request with that request's answers, and
judges the answers of each state against the engine's ``live_rows(run,
state)``, a state at a time in ascending order (so that the engine can
replay its writes forward once from the seed), pooling the numbers over the
states. An answer given from an older state than its request reports is
judged against the newer rows, and fails. An engine that leaves
``run.epoch`` None writes nothing that an answer could hold: its answers
are judged against one live set, its ``live_rows(run)``, else
``seeded_rows``.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the same window under ``torch.profiler`` and reports its per-layer metrics,
the device's busy and window seconds, and a breakdown. The numbers judged
come last on standard error and last in the line, each beside its limit.
Without a CUDA card the run prints no result and exits 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the start of set-up

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import data, reference  # noqa: E402
from portbench.peaks import bound_s  # noqa: E402
from portbench.trace import SPAN, Trace, handwritten_kernels  # noqa: E402

T_IMPORTED = time.perf_counter()  # torch, numpy and the harness imported

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = frozenset({"jax", "jaxlib", "flax", "muninn_tpu"})
WARM_REQUESTS = 2
CHECK_ROWS = 16  # answers judged per request, drawn from the seed


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``muninn_tpu_torch`` is not ``muninn_tpu``)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FOREIGN)


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    def __init__(self, bench: "Bench", spec: dict):
        self.name = spec["name"]
        self.chips = int(spec["chips"])
        conf = next(c for c in bench.spec["configs"] if c["name"] == spec["config"])
        self.config = json.loads((bench.root / conf["file"]).read_text())
        self.traffic = json.loads(
            (bench.pkg / "traffic" / f"{spec['traffic']}.json").read_text())
        # the traffic's settings over the configuration's (a traffic may
        # send its own batch)
        self.params = {**self.config, **self.traffic}
        self.end_to_end = bench.metrics("end_to_end", self.name)
        self.per_layer = bench.metrics("per_layer", self.name)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names under
    ``root/portbench``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.pkg = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        for spec in self.spec["workloads"]:
            if spec["name"] == name:
                return Cell(self, spec)
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics(self, group: str, cell: str) -> list[dict]:
        return [m for m in self.spec[group]
                if cell in m.get("workloads", (cell,))]

    def module(self, folder: str, name: str):
        """``portbench/<folder>/<name>.py``, loaded from its path (metric
        names hold dots)."""
        return _load(self.pkg / folder / f"{name}.py", f"{folder}_{name}")


def search_request(run: "Run", i: int):
    """The default request ``i`` of a run: one ``search`` of the pool's
    batch ``i`` (the pool cycled). Returns ``(batch, ids, dists, written)``:
    the pool batch answered (None where a request answers no query), the
    answers as numpy, and the rows the request wrote to the index."""
    b = i % len(run.pool)
    ids, dists = run.engine.search(run.index, run.pool[b], run.k, run.p)
    return b, ids, dists, 0


def seeded_rows(run: "Run"):
    """The default live set that answers are judged against: the rows the
    index was built from, made again from the seed, and the id of each."""
    x = data.rows(data.generator(run.seed, run.device), run.p, run.device)
    return x, run.ids


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spanned(name: str, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(SPAN + name):
            return fn(*args, **kwargs)
    return call


class Run:
    """One run of a cell: ``setup``, ``window``, ``close``, ``judge``."""

    def __init__(self, bench: Bench, cell: Cell, seed: int,
                 device: str | torch.device = "cuda"):
        self.bench, self.cell, self.seed = bench, cell, int(seed)
        self.device = torch.device(device)
        self.p = cell.params
        self.engine = bench.module("engines", self.p["engine"])
        # an engine that writes rows, or sends other requests than one
        # search of a pool batch, owns its requests and its live rows
        self.request = getattr(self.engine, "request", search_request)
        self.live_rows = getattr(self.engine, "live_rows", seeded_rows)
        self.batch = int(self.p["queries_per_request"])
        self.k = int(self.p["k"])
        self.latencies: list[float] = []
        self.kept: list[tuple] = []  # (pool batch, rows, ids, dists, state)
        self.epoch: int | None = None  # the live state; see the module's doc
        self.attempted = self.failed = self.answered = self.written = 0
        self.errors: list[str] = []
        self.window_s = 0.0
        self.trace: Trace | None = None
        self.numbers: dict = {}
        self.states = 0  # live states judged
        self.memory_peak = 0
        self.check_rows = CHECK_ROWS

    def setup(self, t0: float, marks=()) -> None:
        """``marks``: ``(part, time it ended)`` of set-up before this call."""
        marks = [("start", t0), *marks, ("port import", time.perf_counter())]
        gen = data.generator(self.seed, self.device)
        x = data.rows(gen, self.p, self.device)
        self.pool = data.query_pool(gen, x, self.p, int(self.p["pool_queries"]),
                                    self.batch)
        self.ids = data.external_ids(self.seed, self.p["rows"])
        _sync(self.device)
        marks.append(("data", time.perf_counter()))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.index = self.engine.build(self.p, x, self.ids, self.seed)
        del x
        _sync(self.device)
        marks.append(("build", time.perf_counter()))
        for i in range(WARM_REQUESTS):
            self.request(self, i)
        _sync(self.device)
        marks.append(("warm-up", time.perf_counter()))
        self.setup_s = marks[-1][1] - t0
        # seconds of each part of set-up
        self.setup_parts = {name: t - marks[i][1]
                            for i, (name, t) in enumerate(marks[1:])}

    def _loop(self, seconds: float, spans: bool) -> None:
        rng = np.random.default_rng([self.seed, 1])
        request = self.request
        # a traffic's fixed rate: request i arrives at start + i / rate and
        # its latency counts the wait behind the one in flight (open loop);
        # without one, each request starts when the last one ends
        rate = self.p.get("arrivals_per_s")
        start = end = time.perf_counter()
        i = 0
        while end - start < seconds and not (rate and i / rate >= seconds):
            self.attempted += 1
            t = time.perf_counter()
            if rate:
                due = start + i / rate
                if t < due:
                    time.sleep(due - t)
                t = due
            try:
                if spans:
                    with torch.profiler.record_function(SPAN + "request"):
                        b, ids, dists, written = request(self, i)
                else:
                    b, ids, dists, written = request(self, i)
            except Exception as exc:  # a request that never answers
                end = time.perf_counter()
                self.failed += 1
                self.errors.append(repr(exc))
            else:
                end = time.perf_counter()
                self.written += written
                if b is not None:
                    self.answered += len(ids)
                    rows = rng.integers(0, len(ids), self.check_rows)
                    self.kept.append((b, rows, ids[rows], dists[rows],
                                      self.epoch))
            self.latencies.append(end - t)
            i += 1
        self.window_s = end - start

    def window(self, seconds: float, trace: bool = False) -> None:
        if not trace:
            self._loop(seconds, spans=False)
            return
        self.index.search_device = _spanned("search_device", self.index.search_device)
        self.index.store.ids_of = _spanned("ids_of", self.index.store.ids_of)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self._loop(seconds, spans=True)
            _sync(self.device)
        self.trace = Trace.from_profiler(prof, handwritten_kernels())

    def close(self) -> None:
        """Read the peak device memory and free the program's state."""
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))
        del self.index
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged_queries(self, kept: list[tuple]) -> tuple[np.ndarray, np.ndarray]:
        """The distinct queries of the ``kept`` answers, and which of them
        each kept answer is to."""
        pairs = np.array([(p, r) for p, rows, *_ in kept for r in rows],
                         np.int64).reshape(-1, 2)
        uniq, which = np.unique(pairs, axis=0, return_inverse=True)
        q = np.zeros((len(uniq), self.p["dim"]), np.float32)
        for j, (p, r) in enumerate(uniq):
            q[j] = self.pool[p][r]
        return q, which.reshape(-1)

    def answers(self, kept: list[tuple], ext: np.ndarray):
        """The ``kept`` answers as rows of the live set whose ids are
        ``ext`` (-1 for an id that no live row has)."""
        ids = np.concatenate([a[2] for a in kept])
        dists = np.concatenate([a[3] for a in kept])
        return data.rows_of(ids, ext), dists.astype(np.float32)

    def judge(self, visit=None) -> None:
        """Judge each kept answer against the exact top-k over the rows live
        in its state, a state at a time in ascending order, with one
        state's live rows on the device at a time; pool the numbers over
        the states into ``numbers``. ``visit(q, x, ref_d, ref_rows)``, where
        given, sees each state's distinct queries, live rows and their exact
        top-k (the controls answer them)."""
        tallies = []
        for state in sorted({a[4] for a in self.kept}):
            kept = [a for a in self.kept if a[4] == state]
            q, which = self.judged_queries(kept)
            # an engine that keeps no state counter has one live set
            x, ext = (self.live_rows(self) if state is None
                      else self.live_rows(self, state))
            ref_d, ref_rows = reference.exact_topk(q, x, self.k, self.p["metric"])
            rows, dists = self.answers(kept, ext)
            tallies.append(reference.tally(q, x, which, rows, dists, ref_d,
                                           ref_rows, self.p["metric"]))
            if visit is not None:
                visit(q, x, ref_d, ref_rows)
            del x, ext, ref_d, ref_rows
        self.states = len(tallies)
        self.numbers = reference.pool(tallies, self.k)

    def checks(self, numbers: dict | None = None) -> dict:
        """Each number judged (the run's, or ``numbers``), beside its
        limit."""
        numbers = self.numbers if numbers is None else numbers
        return {name: [numbers[name], limit]
                for name, limit in self.p["limits"].items()}

    @staticmethod
    def within(checks: dict) -> bool:
        return all(v <= lim for v, lim in checks.values())

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0 and bool(self.kept)
                and self.within(self.checks()))

    def roofline(self, kernel: str) -> float | None:
        """100 x the bound of ``kernels/<kernel>.py`` over the time of its
        launches in the trace; None where it was not launched."""
        count = self.bench.module("kernels", kernel)
        times = [e - s for n, s, e in self.trace.kernels if count.NAME in n]
        if not times:
            return None
        ops, nbytes = count.work(self.p)
        return 100.0 * len(times) * bound_s(ops, count.PEAK, nbytes) / (sum(times) / 1e6)

    def metrics(self, trace: bool) -> dict:
        specs = self.cell.per_layer if trace else self.cell.end_to_end
        folder = "per_layer" if trace else "end_to_end"
        out = {}
        for m in specs:
            value = self.bench.module(folder, m["name"]).read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    def device_info(self) -> dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
                "count": self.cell.chips, "memory_peak_bytes": self.memory_peak}
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                 f"--id={self.device.index or 0}"],
                capture_output=True, text=True, timeout=30, check=True)
            info["power_limit_w"] = float(smi.stdout.split()[0])
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            pass
        return info

    def line(self, trace: bool) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics(trace),
               "device": self.device_info()}
        if trace:
            out["device"]["busy_s"] = self.trace.busy_us / 1e6
            out["device"]["window_s"] = self.trace.window_us / 1e6
            out["breakdown"] = self.trace.breakdown()
        out["checks"] = self.checks()
        return out


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None, marks=()) -> Run:
    """Set up, measure, free and judge one run of cell ``name``."""
    run = Run(bench, bench.cell(name), seed, device)
    run.setup(T0 if t0 is None else t0, marks)
    run.window(seconds, trace)
    run.close()
    run.judge()
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s);"
              f" found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks = [("imports", T_IMPORTED), ("CUDA init", time.perf_counter())]
    run = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   marks=marks)
    bad = foreign_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    line = run.line(bool(args.trace))
    print("portbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in run.setup_parts.items()), file=sys.stderr)
    for err in run.errors[:3]:
        print(f"portbench: a request failed: {err}", file=sys.stderr)
    for name, (value, limit) in line["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
