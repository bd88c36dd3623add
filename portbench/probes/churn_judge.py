"""The judge of each live state under steady HNSW churn, on one CUDA card:
a probe of what a churn cell would ask of the harness and of the program,
not a cell.

    python3 -m portbench.probes.churn_judge --seed 7 [--seconds 10] [--out FILE]

from the root of a checkout. It runs the harness's ``Run`` on the
``c100k-384.hnsw`` cell's table (``minilm-100k-384``: 100k x 384 l2 rows,
the HNSW index bulk-built at the configuration's settings) with a probe
engine in place of the traffic's: each request inserts a wave of 2,048 new
rows (the table's recipe: its centres plus noise), deletes 1,024 live ids
drawn from the seed,
repacks the beam's neighbour table (``pack_neighbors``, so that the search
can stay on the ``beam_step`` kernel) and searches a pool batch of 2,048
queries (``bench.py:428-471``'s sizes). Each request raises ``run.epoch``
before its search; the engine's ``live_rows(run, state)`` replays the
writes forward from the seed.

It prints one JSON line: the card and its power limit; requests, queries
and rows written a second; the ``checks`` of the judge of each state and of
the same kept answers judged against the last state alone, with the
states judged and each judge's seconds; ``store.capacity``,
``store.high_watermark`` and the live rows before and after the window, and
whether the packed table was there for the last search.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import data  # noqa: E402
from portbench.run import Bench, Run, foreign_modules, seeded_rows  # noqa: E402

CELL = "c100k-384.hnsw"
SIZES = {"inserts": 2048, "deletes": 1024, "queries": 2048}


def _new_rows(run: Run, w: int) -> tuple[np.ndarray, torch.Tensor]:
    """The rows of write ``w`` (the run's ``w``-th, warm-up included), made
    again from the seed alone by the table's own recipe: one of the table's
    centres plus ``noise``, unit-normalised, on the run's device; and their
    new ids (``ID_BASE`` + rows + ``inserts`` x ``w``)."""
    n, p = run.sizes["inserts"], run.p
    if getattr(run, "centres", None) is None:  # data.rows' first draw
        run.centres = torch.randn(p["centres"], p["dim"], device=run.device,
                                  generator=data.generator(run.seed, run.device))
    seed = np.random.default_rng([run.seed, 5, w]).integers(2**62)
    gen = data.generator(int(seed), run.device)
    x = run.centres[torch.randint(0, p["centres"], (n,), generator=gen,
                                  device=run.device)]
    x += p["noise"] * torch.randn(n, p["dim"], generator=gen, device=run.device)
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    ids = data.ID_BASE + run.p["rows"] + n * w + np.arange(n, dtype=np.int64)
    return ids, x


def request(run: Run, i: int):
    """Insert a wave, delete ids drawn from the seed, repack, search."""
    if getattr(run, "log", None) is None:
        run.log = []  # the ids each write deleted, in order
        run.live = np.sort(run.ids)
    w = len(run.log)
    ids_new, x_new = _new_rows(run, w)
    rng = np.random.default_rng([run.seed, 6, w])
    gone = rng.choice(run.live, run.sizes["deletes"], replace=False)
    run.index.insert(ids_new, x_new)
    run.index.delete(gone)
    run.index.pack_neighbors()
    run.live = np.union1d(np.setdiff1d(run.live, gone, assume_unique=True), ids_new)
    run.log.append(gone)
    run.epoch = len(run.log)
    b = i % len(run.pool)
    ids, dists = run.engine.search(run.index, run.pool[b], run.k, run.p)
    return b, ids, dists, len(ids_new) + len(gone)


def live_rows(run: Run, state: int | None = None):
    """The rows and ids live once the first ``state`` writes were made (all
    of them: None), replayed forward from the last state asked for, or from
    the seed's rows; one state's rows are kept."""
    state = len(run.log) if state is None else state
    at, x, ids = getattr(run, "replayed", None) or (0, None, None)
    if x is None or at > state:
        at, (x, ids) = 0, seeded_rows(run)
    run.replayed = None
    for w in range(at, state):
        ids_new, x_new = _new_rows(run, w)
        gone = run.log[w]
        keep = ~np.isin(ids, gone)
        x = torch.cat([x[torch.from_numpy(keep).to(x.device)], x_new])
        ids = np.concatenate([ids[keep], ids_new])
    run.replayed = (state, x, ids)
    return x, ids


def churn_run(bench: Bench, seed: int, device: str = "cuda",
              sizes: dict = SIZES, cell: str = CELL) -> Run:
    """A run of ``cell``'s table whose requests are this probe's."""
    spec = bench.cell(cell)
    spec.params["queries_per_request"] = sizes["queries"]
    run = Run(bench, spec, seed, device)
    run.sizes = sizes
    run.request, run.live_rows = request, live_rows
    return run


def _store(run: Run) -> dict:
    st = run.index.store
    return {"capacity": st.capacity, "high_watermark": st.high_watermark,
            "live": len(st), "packed": run.index._packed is not None}


def _judged(run: Run) -> tuple[dict, int, float]:
    t = time.perf_counter()
    run.judge()
    return run.checks(), run.states, time.perf_counter() - t


def probe(run: Run, seconds: float, t0: float) -> dict:
    """Set up, measure, free, then judge the kept answers by their states
    and against the last state alone."""
    run.setup(t0)
    before = _store(run)
    run.window(seconds)
    after = _store(run)
    run.close()
    per_state, states, judge_s = _judged(run)
    correct = run.correct
    last = run.epoch
    run.kept = [(*a[:4], last) for a in run.kept]
    end_state, _, end_judge_s = _judged(run)
    run.replayed = None
    return {"requests": run.attempted, "failed": run.failed,
            "window_s": run.window_s, "setup_s": run.setup_s,
            "requests_per_s": run.attempted / run.window_s,
            "queries_per_s": run.answered / run.window_s,
            "rows_written_per_s": run.written / run.window_s,
            "states": states, "judged": int(sum(len(a[1]) for a in run.kept)),
            "judge_s": judge_s, "checks": per_state,
            "correct": correct,
            "end_state_judge_s": end_judge_s, "end_state_checks": end_state,
            "end_state_correct": Run.within(end_state),
            "store_before": before, "store_after": after,
            "errors": run.errors[:3]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", help="also append the line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("churn_judge: no CUDA card", file=sys.stderr)
        return 2
    run = churn_run(Bench(), args.seed)
    out = {"seed": args.seed, "kind": torch.cuda.get_device_name(),
           **probe(run, args.seconds, T0)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    out["power_limit"] = smi.stdout.strip()
    bad = foreign_modules()
    if bad:
        print(f"churn_judge: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
