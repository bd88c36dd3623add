#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``muninn_tpu_torch``) on one CUDA card and
check it end to end.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the ``flat_topk`` and ``beam_dots`` kernels from
   ``muninn_tpu_torch/csrc``, one ``nvcc`` for each, started together;
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
   index, held against the plain version the same way, both timed;
6. the ``gather_block_dots`` kernel against its plain version: bf16 and f32
   blocks, d in {100, 128, 384, 768}, R0 in {16, 32}, E in {1, 8}, B in
   {1, 37, 300}, 40% dead picks; dots and squared norms within TOL, dead
   lanes exactly 0;
7. the bf16-operand mode of ``flat_topk`` (``precision="default"``) against
   its plain version: three metrics, k up to 33, a 30% mask, ids equal up to
   float64 ties of the bf16-rounded operands; then ``FlatIndex(precision=
   "default")`` on phase 4's data, held the same way, timed against plain,
   with its recall against phase 4's exact result;
8. the HNSW main path at ``bench.py``'s HNSW workload (``bench.py:377-381``)
   on phase 4's data: ``HnswIndex`` of 100,000 x 384 cosine rows, m=16,
   ef_construction=200, wave_size=4,096, capacity 136,864, expand=8,
   seed=42; bulk insert (timed), pack, search 8,192 queries at k=10,
   ef_search=24 with both kernels' launches counted over exactly this run;
   returned distances equal to the exact distance of each returned row,
   recall@10 against phase 4's exact result at least 0.95; then the search
   timed, and ``gather_block_dots`` kernel against plain on the picks of
   the first beam step of one 2,816-query chunk (E=8, R0=32, d=384, bf16).

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

# rtol and atol, kernel vs plain. The two sum the same f32 products (of f32
# operands, or of bf16-rounded ones, whose products are exact in f32) in
# another order, which moves a result by a few ulps of the sum of |terms|:
# on unit-norm rows (embedding scale; the comparison data below) that is
# about 1e-7, while raw Gaussian rows at d=768 put it near 1e-4.
TOL = 1e-5
METRICS = ("l2", "cosine", "inner_product")
MIN_HNSW_RECALL = 0.95


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


def bf16_round(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def dist64_bf16(q: np.ndarray, c: np.ndarray, metric: str) -> np.ndarray:
    """Float64 distances of matching rows as the bf16-operand mode ranks
    them: the product of the bf16-rounded query (unit query for cosine) and
    the bf16-rounded raw row; norms from the unrounded rows."""
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    if metric == "cosine":
        q64 = q64 / np.maximum(np.linalg.norm(q64, axis=-1, keepdims=True), 1e-30)
    dots = (bf16_round(q64).astype(np.float64)
            * bf16_round(c).astype(np.float64)).sum(-1)
    if metric == "inner_product":
        return -dots
    if metric == "cosine":
        return 1.0 - dots / np.maximum(np.linalg.norm(c64, axis=-1), 1e-30)
    return (q64 ** 2).sum(-1) - 2.0 * dots + (c64 ** 2).sum(-1)


def compare(kd, ki, pd, pi, q, c, valid, metric, ref=dist64) -> float:
    """Kernel result (kd, ki) against the plain one (pd, pi), all tensors of
    ``[B, k]`` in slot space, for queries ``q`` over corpus ``c`` (tensors on
    the card) with validity ``valid`` (bool tensor or None). Returns the
    largest absolute distance difference.

    Distances must agree within TOL. Ids must be equal except where the
    kernel's row is as near as the plain one's at that rank: a tie, judged
    by the float64 distance of the returned row's own vector, never by the
    distance the kernel reports for it (``ref``: ``dist64``, or
    ``dist64_bf16`` for the bf16-operand mode)."""
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
        true = ref(qs.cpu().numpy(), rows.cpu().numpy(), metric)
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
    from muninn_tpu_torch import FlatIndex, HnswIndex
    from muninn_tpu_torch.ops import _build, beam
    from muninn_tpu_torch.ops import flat_topk as flat_topk_mod
    from muninn_tpu_torch.ops.beam import (
        gather_block_dots_cuda,
        gather_block_dots_plain,
    )
    from muninn_tpu_torch.ops.flat_topk import (
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
    _build.load_all(["flat_topk", "beam_dots"])  # one nvcc each, in parallel
    flat_topk_mod._library()
    beam._library()
    print(f"build: flat_topk and beam_dots in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
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
    del big, c5, v5, q5, pd5
    torch.cuda.empty_cache()

    # 6. gather_block_dots kernel vs plain on the card
    rng = np.random.default_rng(6)
    beam_err = 0.0
    n_beam = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d6 in (100, 128, 384, 768):
            for r0 in (16, 32):
                for e in (1, 8):
                    for b in (1, 37, 300):
                        cap = 509
                        blocks = rng.standard_normal((cap, r0, d6),
                                                     dtype=np.float32)
                        blocks /= np.linalg.norm(blocks, axis=2, keepdims=True)
                        packed = torch.from_numpy(blocks).cuda().to(dtype)
                        qb = torch.from_numpy(unit_rows(
                            rng.standard_normal((b, d6), dtype=np.float32))).cuda()
                        picks = rng.integers(0, cap, (b, e)).astype(np.int32)
                        dead = rng.random((b, e)) < 0.4
                        picks[dead] = -1
                        it = torch.from_numpy(picks).cuda()
                        kd6, kc6 = gather_block_dots_cuda(qb, it, packed)
                        torch.cuda.synchronize()
                        pd6, pc6 = gather_block_dots_plain(qb, it, packed)
                        kd6, kc6, pd6, pc6 = (t.cpu().numpy()
                                              for t in (kd6, kc6, pd6, pc6))
                        lanes = np.repeat(dead, r0, axis=1)
                        check(bool((kd6[lanes] == 0).all() and (kc6[lanes] == 0).all()),
                              "beam_dots: a dead lane is not 0")
                        np.testing.assert_allclose(kd6, pd6, rtol=TOL, atol=TOL)
                        np.testing.assert_allclose(kc6, pc6, rtol=TOL, atol=TOL)
                        beam_err = max(beam_err, float(np.abs(kd6 - pd6).max(initial=0)),
                                       float(np.abs(kc6 - pc6).max(initial=0)))
                        n_beam += 1
    print(f"beam_dots kernel vs plain: {n_beam} cases agree, max error"
          f" {beam_err:.3g}", flush=True)

    # 7. flat_topk's bf16-operand mode, kernel vs plain
    bf_err = 0.0
    n_bf = 0
    for mi, metric in enumerate(METRICS):
        for b, n7, d7, k7 in ((37, 20011, 384, 33), (300, 9001, 100, 8),
                              (1, 5003, 768, 10)):
            q = torch.from_numpy(unit_rows(
                rng.standard_normal((b, d7), dtype=np.float32))).cuda()
            c = torch.from_numpy(unit_rows(
                rng.standard_normal((n7, d7), dtype=np.float32))).cuda()
            vt = torch.from_numpy(rng.random(n7) >= 0.3).cuda() if mi != 1 else None
            kd, kid = flat_topk_cuda(q, c, k7, metric=metric, corpus_valid=vt,
                                     precision="default")
            torch.cuda.synchronize()
            pd, pid = flat_topk_plain(q, c, k7, metric=metric, corpus_valid=vt,
                                      precision="default")
            bf_err = max(bf_err, compare(kd, kid, pd, pid, q, c, vt, metric,
                                         ref=dist64_bf16))
            n_bf += 1
    fast = FlatIndex(d, "cosine", capacity=n, device="cuda", precision="default")
    fast.insert(ext, x)
    qg = torch.from_numpy(qq).cuda()
    fd, fslot = fast.search_device(qg, k)
    corpus = fast.store.vectors[:n]
    valid = fast.store.valid[:n]
    pd, pslot = flat_topk_plain(qg, corpus, k, metric="cosine",
                                corpus_valid=valid, precision="default")
    bf_err = max(bf_err, compare(fd, fslot, pd, pslot, qg, corpus, valid,
                                 "cosine", ref=dist64_bf16))
    fast_recall = recall(fast.store.ids_of(fslot.cpu().numpy()), ids1)
    ms_def = device_ms(lambda: flat_topk(qg, corpus, k, metric="cosine",
                                         corpus_valid=valid, precision="default"))
    plain_ms_def = device_ms(lambda: flat_topk_plain(
        qg, corpus, k, metric="cosine", corpus_valid=valid, precision="default"))
    print(f"flat_topk bf16 mode vs plain: {n_bf + 1} cases agree, max |d| error"
          f" {bf_err:.3g}; FlatIndex(precision='default') 100k x 384, {nq}"
          f" queries: recall@{k} {fast_recall} vs exact; kernel {ms_def:.3f} ms"
          f" ({nq / ms_def * 1e3:.0f} QPS), plain {plain_ms_def:.3f} ms",
          flush=True)
    del fast, corpus, valid, pd
    torch.cuda.empty_cache()

    # 8. the HNSW main path at bench.py's HNSW workload, on phase 4's data
    ef, m, wave = 24, 16, 4096
    hnsw = HnswIndex(d, "cosine", m=m, ef_construction=200,
                     capacity=n + 32_768 + wave, seed=42, expand=8,
                     wave_size=wave, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    hnsw.insert(ext, x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hnsw.pack_neighbors()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    check(hnsw._maybe_packed() is not None, "the packed table was not built")
    t0 = time.perf_counter()
    hids, hd = hnsw.search(qq, k=k, ef_search=ef)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    hnsw_launches = dict(_build.LAUNCHES)
    for name in ("flat_topk", "beam_dots"):
        check(hnsw_launches[name] > 0,
              f"the HNSW path launched {name} {hnsw_launches[name]} times")
    check(hids.shape == (nq, k) and bool((hids >= 0).all())
          and bool(np.isfinite(hd).all()), "HNSW: a missing result")
    check(bool(np.all(hd[:, 1:] >= hd[:, :-1])), "HNSW dists not ascending")
    true = dist64(np.repeat(qq, k, axis=0), x[(hids - ext[0]).reshape(-1)],
                  "cosine").reshape(nq, k)
    np.testing.assert_allclose(hd, true, rtol=TOL, atol=TOL)
    hnsw_recall = recall(hids, ids1)
    check(hnsw_recall >= MIN_HNSW_RECALL,
          f"HNSW recall@{k} {hnsw_recall} < {MIN_HNSW_RECALL}")
    search_ms = device_ms(lambda: hnsw.search_device(qg, k, ef), reps=3)
    print(f"HNSW 100k x 384 cosine, m={m}, ef={ef}: build {build_s:.3f} s"
          f" ({n / build_s:.0f} vec/s), pack {pack_s:.3f} s; {nq} queries:"
          f" first search {first_s:.3f} s, then {search_ms:.3f} ms"
          f" ({nq / search_ms * 1e3:.0f} QPS); recall@{k} {hnsw_recall};"
          f" launches {hnsw_launches}", flush=True)
    # the first beam step of one chunk: picks = the routed entries
    chunk = 2816
    qc = qg[:chunk]
    pool = hnsw._routing_pool()
    _, sel = flat_topk(qc, hnsw._pool_vecs(pool), hnsw.route_entries,
                       metric="cosine", precision="default", corpus_valid=pool >= 0)
    picks = torch.where(sel >= 0, pool[sel.clamp(min=0).long()], -1)
    packed = hnsw._maybe_packed()
    kd8, kc8 = gather_block_dots_cuda(qc, picks, packed)
    torch.cuda.synchronize()
    pd8, pc8 = gather_block_dots_plain(qc, picks, packed)
    torch.testing.assert_close(kd8, pd8, rtol=TOL, atol=TOL)
    torch.testing.assert_close(kc8, pc8, rtol=TOL, atol=TOL)
    beam_err = max(beam_err, float((kd8 - pd8).abs().max()),
                   float((kc8 - pc8).abs().max()))
    beam_ms = device_ms(lambda: gather_block_dots_cuda(qc, picks, packed), reps=20)
    beam_plain_ms = device_ms(lambda: gather_block_dots_plain(qc, picks, packed))
    beam_bytes = picks.numel() * packed.shape[1] * packed.shape[2] * packed.element_size()
    print(f"gather_block_dots at [{chunk}, {picks.shape[1]}] x"
          f" [{packed.shape[1]}, {packed.shape[2]}] bf16: kernel {beam_ms:.4f} ms"
          f" ({beam_bytes / beam_ms / 1e6:.0f} GB/s of blocks read), plain"
          f" {beam_plain_ms:.4f} ms", flush=True)

    print(json.dumps({"kernels": [{
        "name": "flat_topk",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/flat_topk.cu",
        "replaces": "muninn_tpu/ops/pallas_flat.py:49",
        "ported_from": "ops/pallas_flat.py:_flat_topk_kernel",
        "launches": hnsw_launches["flat_topk"],
        "launches_flat_path": launches,
        "max_abs_err": max(max_err, main_err, err5, bf_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_1m_768": ms5,
        "plain_ms_1m_768": plain_ms5,
        "ms_default": ms_def,
        "plain_ms_default": plain_ms_def,
    }, {
        "name": "beam_dots",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/beam_dots.cu",
        "replaces": "muninn_tpu/ops/pallas_beam.py:46",
        "ported_from": "ops/pallas_beam.py:_beam_dots_kernel",
        "launches": hnsw_launches["beam_dots"],
        "max_abs_err": beam_err,
        "ms": beam_ms,
        "plain_ms": beam_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
