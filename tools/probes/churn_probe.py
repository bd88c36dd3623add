"""Where the time of the port's HNSW churn goes, on one CUDA card.

    python3 tools/probes/churn_probe.py

At chip_smoke.py phase 15's shapes (bench.py:428-471): its data recipe,
the HNSW cosine 100k x 384 index of phase 10 (m=16, bulk build), then
insert waves of 2,048 rows and deletes of 1,024 ids. For each of the two:

- host wall time per wave or delete (median, no profiler, one synchronize
  after each), with ``mn_ru`` on and off for the waves;
- under ``torch.profiler``, one wave (delete) as it runs: the device's busy
  time and idle share;
- then one more with each part between synchronizes: the device ms of the
  kernels inside each part's host range and the part's host ms. Parts are
  the functions of ``muninn_tpu_torch.index.hnsw`` a wave calls
  (``flat_topk``: the candidates; ``pairwise_distances`` and
  ``masked_topk``: the wave's rows among themselves; ``merge_topk`` and
  ``sorted_topk_unique``: merge and selection; ``_grouped_bounded_append``:
  the reverse edges; ``_prune_rows``: the MN-RU prune) and a delete calls
  (``flat_topk`` and ``merge_topk`` in the repair); the rest of the wave's
  or delete's time is "other" (writes, the mark scan, host bookkeeping).

Every line names the card and its power limit.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from muninn_tpu_torch import HnswIndex  # noqa: E402
from muninn_tpu_torch.index import hnsw as hnsw_mod  # noqa: E402
from muninn_tpu_torch.ops import _build  # noqa: E402

WAVE_PARTS = ("flat_topk", "pairwise_distances", "masked_topk", "merge_topk",
              "sorted_topk_unique", "_grouped_bounded_append", "_prune_rows")
DELETE_PARTS = ("flat_topk", "merge_topk")
KIND = torch.autograd.DeviceType.CUDA
ACT = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def union_ms(spans) -> float:
    busy, last = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy += max(0.0, t - max(s, last))
        last = max(last, t)
    return busy / 1e3


def device_spans(prof) -> list[tuple[float, float]]:
    """The device's kernels and copies, in microseconds (not the ranges'
    device-side annotations)."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == KIND and not e.name.startswith("probe:")]


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile(card: str, what: str, step, parts) -> None:
    """One call of ``step`` as it runs (busy and idle), then one with each
    of ``parts`` fenced (device and host ms by part)."""
    wall = timed(step)
    with torch.profiler.profile(activities=ACT) as prof:
        step()
        torch.cuda.synchronize()
    busy = union_ms(device_spans(prof))
    print(f"{card}; {what} under the profiler: device busy {busy:.3f} ms of a"
          f" {wall:.3f} ms host wall taken just before it (idle"
          f" {1 - busy / wall:.1%})", flush=True)

    saved = {name: getattr(hnsw_mod, name) for name in parts}
    host: dict[str, float] = {}

    def fenced(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"probe:{name}"):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            host[name] = host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    try:
        for name in parts:
            setattr(hnsw_mod, name, fenced(name, saved[name]))
        with torch.profiler.profile(activities=ACT) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            total_host = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in saved.items():
            setattr(hnsw_mod, name, fn)
    kernels = device_spans(prof)
    dev: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in prof.events():
        if e.device_type != KIND and e.name.startswith("probe:"):
            lo, hi = e.time_range.start, e.time_range.end
            name = e.name[6:]
            dev[name] = dev.get(name, 0.0) + union_ms(
                [(s, t) for s, t in kernels if s >= lo and t <= hi])
            calls[name] = calls.get(name, 0) + 1
    total = union_ms(kernels)
    rows = ", ".join(f"{n} {dev.get(n, 0.0):.3f} / {host.get(n, 0.0):.3f}"
                     f" ({calls.get(n, 0)} calls)" for n in parts)
    print(f"{card}; {what}, parts fenced: device / host ms {rows}; other"
          f" {total - sum(dev.values()):.3f} / {total_host - sum(host.values()):.3f};"
          f" all kernels {total:.3f}, host {total_host:.3f}", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("churn_probe: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.load_all(["flat_topk", "flat_topk_mma", "beam_dots", "beam_loop"])
    n, d, churn, wave, kill = 100_000, 384, 32_768, 2048, 1024
    x, _, x15 = cs.clustered(np.random.default_rng(7), n, d, 1000, 8, churn)
    ext = np.arange(n + churn, dtype=np.int64)
    hnsw = HnswIndex(d, "cosine", m=16, ef_construction=200,
                     capacity=n + churn + 4096, seed=42, expand=8,
                     wave_size=4096, device="cuda")
    hnsw.insert(ext[:n], x)
    hnsw.wave_size = wave
    waves = iter(range(0, churn, wave))

    def next_wave():
        s = next(waves)
        hnsw.insert(ext[n + s : n + s + wave], x15[s : s + wave])

    next_wave()  # warm
    torch.cuda.synchronize()
    for mn in (True, False, True):
        hnsw.mn_ru = mn
        ms = statistics.median(timed(next_wave) for _ in range(3))
        print(f"{card}; insert wave of {wave} rows, mn_ru={mn}: host wall"
              f" {ms:.3f} ms (median of 3; {wave / ms * 1e3:.0f} vec/s)", flush=True)
    hnsw.mn_ru = True
    profile(card, f"insert wave of {wave} rows", next_wave, WAVE_PARTS)
    profile(card, f"insert wave of {wave} rows", next_wave, WAVE_PARTS)

    dels = iter(range(0, n, kill))

    def next_delete():
        s = next(dels)
        hnsw.delete(ext[s : s + kill])

    next_delete()  # warm
    torch.cuda.synchronize()
    ms = statistics.median(timed(next_delete) for _ in range(5))
    print(f"{card}; delete of {kill} ids: host wall {ms:.3f} ms (median of 5;"
          f" {kill / ms * 1e3:.0f} ids/s)", flush=True)
    profile(card, f"delete of {kill} ids", next_delete, DELETE_PARTS)
    profile(card, f"delete of {kill} ids", next_delete, DELETE_PARTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
