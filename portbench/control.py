"""The readings that a cell's limits are set from, on the card, in one
process for many seeds (the benchmark's own runs never run this).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds 10]
        [--check-rows 48] [--out FILE]

For each seed: one run of the cell as ``run.py`` makes it (set-up, the
window, the program's answers judged: the lower readings), then each
control that the cell's traffic file lists (``controls/<name>.py``) answers
the same judged queries over the same live rows, a live state at a time as
the run judges them, and is judged by the same numbers, pooled over the
states as the program's are (the upper readings). Prints one JSON line a
seed and a summary: for each number the largest the program read and, for
each control, the smallest it read.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import reference
from portbench.run import Bench, Run, foreign_modules


def readings(bench: Bench, name: str, seed: int, seconds: float,
             device: str = "cuda", check_rows: int | None = None) -> dict:
    """One seed's numbers: the program's and each listed control's;
    ``check_rows`` answers judged a request (``run.CHECK_ROWS`` by
    default), so that a shorter window judges as many as a run does."""
    run = Run(bench, bench.cell(name), seed, device)
    if check_rows:
        run.check_rows = check_rows
    run.setup(time.perf_counter())
    run.window(seconds)
    controls = {c: bench.module("controls", c) for c in run.p.get("controls", ())}
    run.close()
    nums = control_numbers(run, controls)
    out = {"workload": name, "seed": seed, "correct": run.correct,
           "requests": run.attempted, "judged": int(sum(len(k[1]) for k in run.kept)),
           "states": run.states, "qps": run.answered / run.window_s,
           "program": run.numbers}
    for c in controls:
        out[c] = dict(nums[c], correct=Run.within(run.checks(nums[c])))
    return out


def control_numbers(run: Run, controls: dict) -> dict:
    """Judge the run's answers (into ``run.numbers``) and each control of
    ``controls`` (name: module) on the same judged queries over the same
    live rows, a live state at a time; returns each control's numbers,
    pooled over the states as the program's are."""
    tallies = {c: [] for c in controls}

    def visit(q, x, ref_d, ref_rows):
        for c, mod in controls.items():
            rows, dists = mod.answer(run, q, x)
            tallies[c].append(reference.tally(q, x, np.arange(len(q)), rows,
                                              dists, ref_d, ref_rows,
                                              run.p["metric"]))

    run.judge(visit)
    return {c: reference.pool(t, run.k) for c, t in tallies.items()}


def summary(lines: list[dict]) -> dict:
    """For each number, the program's largest reading and each control's
    smallest."""
    out = {"program_max": {}, "seeds": [ln["seed"] for ln in lines],
           "all_correct": all(ln["correct"] for ln in lines)}
    for name in lines[0]["program"]:
        out["program_max"][name] = max(ln["program"][name] for ln in lines)
    for c in lines[0]:
        if isinstance(lines[0][c], dict) and "correct" in lines[0][c]:
            out[f"{c}_min"] = {n: min(ln[c][n] for ln in lines)
                               for n in lines[0]["program"]}
            out[f"{c}_ever_correct"] = any(ln[c]["correct"] for ln in lines)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window; BENCHMARK.json's run_seconds by default")
    ap.add_argument("--check-rows", type=int, default=None,
                    help="answers judged a request")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    seconds = args.seconds or bench.spec["run_seconds"]
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        lines.append(readings(bench, args.workload, seed, seconds,
                              check_rows=args.check_rows))
        lines[-1]["kind"] = torch.cuda.get_device_name()
        print(json.dumps(lines[-1]), flush=True)
    result = {"summary": summary(lines), "workload": args.workload,
              "foreign_modules": foreign_modules()}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in (*lines, result):
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
