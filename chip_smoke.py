#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``muninn_tpu_torch``) on one CUDA card and
check it end to end.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the ``flat_topk`` kernel from ``muninn_tpu_torch/csrc``;
3. hold the kernel against its plain PyTorch version on the card, on
   unit-norm Gaussian rows: all three metrics, a 30% validity mask, ragged
   B and N, d in {100, 384, 768}, k in {1, 10, 100, 1024}, including k
   above the live row count;
4. the main path at the headline shape of ``bench.py``: a cosine
   ``FlatIndex`` of 100,000 x 384 clustered rows, insert, search 8,192
   queries at k=10, delete 1,000 ids, search again; both searches held
   against the plain version as in phase 3 (distances within TOL, ids
   equal up to float64 ties), no deleted id returned, and the kernel's
   launches counted over exactly this run; then kernel and plain timed;
5. 1,000,000 x 768 cosine, 1,024 queries, k=10: one search through the
   index, held against the plain version the same way, both timed.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# rtol and atol, kernel vs plain. The two sum the same f32 products in
# another order, which moves a result by a few ulps of the sum of |terms|:
# on unit-norm rows (embedding scale; the comparison data below) that is
# about 1e-7, while raw Gaussian rows at d=768 put it near 1e-4.
TOL = 1e-5
METRICS = ("l2", "cosine", "inner_product")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``reps`` calls after one warm-up, timed with
    CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dist64(q: np.ndarray, c: np.ndarray, metric: str) -> np.ndarray:
    """Float64 distances of matching rows of ``q`` and ``c``."""
    q = q.astype(np.float64)
    c = c.astype(np.float64)
    if metric == "l2":
        return ((q - c) ** 2).sum(-1)
    dots = (q * c).sum(-1)
    if metric == "inner_product":
        return -dots
    qn = np.maximum(np.linalg.norm(q, axis=-1), 1e-30)
    cn = np.maximum(np.linalg.norm(c, axis=-1), 1e-30)
    return 1.0 - dots / (qn * cn)


def compare(kd, ki, pd, pi, q, c, valid, metric) -> float:
    """Kernel result (kd, ki) against the plain one (pd, pi), all tensors of
    ``[B, k]`` in slot space, for queries ``q`` over corpus ``c`` (tensors on
    the card) with validity ``valid`` (bool tensor or None). Returns the
    largest absolute distance difference.

    Distances must agree within TOL. Ids must be equal except where the
    kernel's row is as near as the plain one's at that rank: a tie, judged
    by the float64 distance of the returned row's own vector, never by the
    distance the kernel reports for it."""
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    fin = np.isfinite(pd)
    check(np.array_equal(np.isfinite(kd), fin), "inf pattern differs")
    check(np.array_equal(ki >= 0, fin), "ids -1 exactly where dists are inf")
    check(bool(np.all(kd[:, 1:] >= kd[:, :-1])), "kernel dists not ascending")
    np.testing.assert_allclose(kd[fin], pd[fin], rtol=TOL, atol=TOL)
    srt = np.sort(ki, axis=1)
    check(not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(),
          "duplicate id in a row")
    if valid is not None:
        check(bool(valid.cpu().numpy()[ki[ki >= 0]].all()), "masked row returned")
    bad = np.argwhere(ki != pi)
    if len(bad):
        b, r = bad[:, 0], bad[:, 1]
        rows = c[torch.from_numpy(ki[b, r].astype(np.int64)).to(c.device)]
        qs = q[torch.from_numpy(b).to(q.device)]
        true = dist64(qs.cpu().numpy(), rows.cpu().numpy(), metric)
        check(bool(np.all(np.abs(true - pd[b, r]) <= TOL + TOL * np.abs(pd[b, r]))),
              f"{len(bad)} ids differ without a tie")
    return float(np.max(np.abs(kd[fin] - pd[fin]), initial=0.0))


def recall(kid: np.ndarray, pid: np.ndarray) -> float:
    """Share of the plain top-k ids that the kernel's top-k holds too (no
    allowance for ties: ``compare`` judges those)."""
    hits = sum(len(set(a.tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(kid, pid))
    return hits / int((pid >= 0).sum())


def unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def clustered(rng, n, d, n_clusters, n_queries):
    """The recipe of bench.py: Gaussian cluster centres, rows = centre +
    0.3 noise, unit-normalised; queries = corpus rows + 0.05 noise,
    re-normalised."""
    centres = rng.standard_normal((n_clusters, d), dtype=np.float32)
    x = centres[rng.integers(0, n_clusters, n)]
    x += 0.3 * rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, n_queries)]
    q = q + 0.05 * rng.standard_normal((n_queries, d), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def clustered_on_device(gen, n, d, n_clusters, n_queries):
    """``clustered`` made on the card from a torch generator."""
    dev = "cuda"
    centres = torch.randn(n_clusters, d, generator=gen, device=dev)
    x = centres[torch.randint(0, n_clusters, (n,), generator=gen, device=dev)]
    x += 0.3 * torch.randn(n, d, generator=gen, device=dev)
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    q = x[torch.randint(0, n, (n_queries,), generator=gen, device=dev)]
    q = q + 0.05 * torch.randn(n_queries, d, generator=gen, device=dev)
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    return x, q


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from muninn_tpu_torch import FlatIndex
    from muninn_tpu_torch.ops import _build
    from muninn_tpu_torch.ops.flat_topk import (
        _library,
        flat_topk,
        flat_topk_cuda,
        flat_topk_plain,
    )

    # 1. the card
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _library()
    print(f"build: flat_topk in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOGS.get("flat_topk", "").splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())
    sys.stdout.flush()

    # 3. kernel vs plain on the card
    rng = np.random.default_rng(1)
    max_err = 0.0
    n_cases = 0
    shapes = ((1, 5003), (37, 20011), (300, 9001), (65, 900))
    for mi, metric in enumerate(METRICS):
        for di, d in enumerate((100, 384, 768)):
            for ki_, k in enumerate((1, 10, 100, 1024)):
                b, n = shapes[(mi + di + ki_) % len(shapes)]
                q = unit_rows(rng.standard_normal((b, d), dtype=np.float32))
                c = unit_rows(rng.standard_normal((n, d), dtype=np.float32))
                masked = (mi + di + ki_) % 2 == 0 or n == 900
                valid = rng.random(n) >= 0.3 if masked else None
                qt = torch.from_numpy(q).cuda()
                ct = torch.from_numpy(c).cuda()
                vt = torch.from_numpy(valid).cuda() if masked else None
                kd, kid = flat_topk_cuda(qt, ct, k, metric=metric,
                                         corpus_valid=vt)
                torch.cuda.synchronize()
                pd, pid = flat_topk_plain(qt, ct, k, metric=metric,
                                          corpus_valid=vt)
                torch.cuda.synchronize()
                err = compare(kd, kid, pd, pid, qt, ct, vt, metric)
                max_err = max(max_err, err)
                n_cases += 1
    print(f"kernel vs plain: {n_cases} cases agree, max |d| error {max_err:.3g}",
          flush=True)

    # 4. main path at bench.py's headline shape
    n, d, nq, k = 100_000, 384, 8192, 10
    t0 = time.perf_counter()
    x, qq = clustered(np.random.default_rng(7), n, d, 1000, nq)
    print(f"data: {n} x {d} corpus, {nq} queries in"
          f" {time.perf_counter() - t0:.1f} s")
    ext = np.arange(n, dtype=np.int64) + 10_000_000
    index = FlatIndex(d, "cosine", device="cuda")
    _build.reset_launches()
    index.insert(ext, x)
    ids1, d1 = index.search(qq, k=k)
    dead = np.unique(ids1[:, 0])[:1000]
    index.delete(dead)
    ids2, d2 = index.search(qq, k=k)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["flat_topk"]
    check(launches >= 2, f"main path launched the kernel {launches} times")
    check(len(dead) == 1000 and len(index) == n - 1000, "delete count")
    check(not np.isin(ids2, dead).any(), "a deleted id came back")

    qg = torch.from_numpy(qq).cuda()
    corpus = index.store.vectors[:n]
    valid = index.store.valid[:n]
    all_valid = torch.ones(n, dtype=torch.bool, device="cuda")
    pd1, pslot1 = flat_topk_plain(qg, corpus, k, metric="cosine",
                                  corpus_valid=all_valid)
    pd, pslot = flat_topk_plain(qg, corpus, k, metric="cosine",
                                corpus_valid=valid)
    # the searches returned external ids: back to slots, to hold them
    # against the plain version (k is far below the live count, so no -1).
    # One insert batch: slot s holds ext[s], deleted since or not.
    errs, recalls = [], []
    for ids, dists, p_d, p_slot, v in ((ids1, d1, pd1, pslot1, all_valid),
                                       (ids2, d2, pd, pslot, valid)):
        check(bool((ids >= 0).all()), "a -1 id among live rows")
        slots = (ids - ext[0]).astype(np.int32)
        check(np.array_equal(ext[slots], ids), "an id outside the inserted batch")
        errs.append(compare(torch.from_numpy(dists), torch.from_numpy(slots),
                            p_d, p_slot, qg, corpus, v, "cosine"))
        recalls.append(recall(slots, p_slot.cpu().numpy()))
    main_err = max(errs)
    print(f"main path 100k: recall {recalls[0]} before delete, {recalls[1]}"
          f" after (every other id a float64 tie); max |d| error"
          f" {main_err:.3g}; launches {launches}")

    ms = device_ms(lambda: flat_topk(qg, corpus, k, metric="cosine",
                                     corpus_valid=valid))
    plain_ms = device_ms(lambda: flat_topk_plain(qg, corpus, k, metric="cosine",
                                                 corpus_valid=valid))
    print(f"100k x 384, {nq} queries, k={k}: kernel {ms:.3f} ms"
          f" ({nq / ms * 1e3:.0f} QPS), plain {plain_ms:.3f} ms"
          f" ({nq / plain_ms * 1e3:.0f} QPS)", flush=True)
    del index, corpus, valid, qg, pd, pd1
    torch.cuda.empty_cache()

    # 5. 1M x 768, the north-star shape
    n5, d5, nq5 = 1_000_000, 768, 1024
    gen = torch.Generator(device="cuda").manual_seed(11)
    x5, q5 = clustered_on_device(gen, n5, d5, 1000, nq5)
    big = FlatIndex(d5, "cosine", capacity=n5, device="cuda")
    big.insert(np.arange(n5), x5)
    del x5
    torch.cuda.empty_cache()
    bd, bslot = big.search_device(q5, k)
    c5 = big.store.vectors[:n5]
    v5 = big.store.valid[:n5]
    pd5, pslot5 = flat_topk_plain(q5, c5, k, metric="cosine", corpus_valid=v5)
    err5 = compare(bd, bslot, pd5, pslot5, q5, c5, v5, "cosine")
    r5 = recall(bslot.cpu().numpy(), pslot5.cpu().numpy())
    print(f"1M x 768: recall {r5} (every other id a float64 tie);"
          f" max |d| error {err5:.3g}")
    ms5 = device_ms(lambda: flat_topk(q5, c5, k, metric="cosine",
                                      corpus_valid=v5))
    plain_ms5 = device_ms(lambda: flat_topk_plain(q5, c5, k, metric="cosine",
                                                  corpus_valid=v5))
    print(f"1M x 768, {nq5} queries, k={k}: kernel {ms5:.3f} ms"
          f" ({nq5 / ms5 * 1e3:.0f} QPS), plain {plain_ms5:.3f} ms"
          f" ({nq5 / plain_ms5 * 1e3:.0f} QPS)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "flat_topk",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/flat_topk.cu",
        "replaces": "muninn_tpu/ops/pallas_flat.py:49",
        "ported_from": "ops/pallas_flat.py:_flat_topk_kernel",
        "launches": launches,
        "max_abs_err": max(max_err, main_err, err5),
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_1m_768": ms5,
        "plain_ms_1m_768": plain_ms5,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
