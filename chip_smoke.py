#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``muninn_tpu_torch``) on one CUDA card and
check it end to end.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the ``flat_topk`` (f32, ``highest``), ``flat_topk_mma`` (the
   tensor-core kernel of the bf16 and int8 modes), ``beam_dots`` (with its
   top-m mode), ``beam_loop``, ``beam_step``, ``gather_rows`` and
   ``delete_repair`` kernels from
   ``muninn_tpu_torch/csrc``, one ``nvcc`` for each, started together (and
   beside them, for phase 17, the host graph library with ``g++``); print
   ``ptxas``'s registers and spills, and the tensor-core kernel's shared
   memory at the main paths' plans; count the tensor-core instructions in
   its SASS (``cuobjdump -sass``: HGMMA for bf16, IGMMA for s8, both
   required); hold the f32 kernel to 0 spill bytes (``ptxas``) and to FFMA
   with no HMMA or HGMMA in its SASS;
3. hold the f32 kernel against its plain PyTorch version on the card, on
   unit-norm Gaussian rows: all three metrics, d in {37, 100, 384, 768}
   (37 takes the 4-byte copy path), k in {1, 10, 33, 100, 1024}, each
   masked (30%) and unmasked, B cycling through {1, 127, 128, 129, 300}
   (around the 128-query tile) and N as in phase 6 (off the 256-row tile
   and, last, below k): 120 cases;
4. the main path at the headline shape of ``bench.py``: a cosine
   ``FlatIndex`` of 100,000 x 384 clustered rows, insert, search 8,192
   queries at k=10, delete 1,000 ids, search again; both searches held
   against the plain version as in phase 3 (distances within TOL, ids
   equal up to float64 ties), no deleted id returned, and the kernel's
   launches counted over exactly this run; then kernel, plain and the
   library call (one f32 matmul, TF32 off, and ``torch.topk``) timed, and
   the matmul alone (``gemm_ms``); no launch of the tensor-core kernel; the
   kernel held to be faster than the library call and than plain;
5. 1,000,000 x 768 cosine, 1,024 queries, k=10: one search through the
   index, held against the plain version the same way; kernel, plain, the
   library call of phase 4 and its matmul alone (``gemm_ms_1m_768``) timed;
   the kernel held to be faster than the library call and than plain;
6. the tensor-core kernel's int8 mode (``flat_topk_int8``) against its
   plain version: cosine and inner product, d in {100, 384, 768}, k in {1,
   10, 33, 100, 1024}, each masked (30%) and unmasked, B cycling through
   {1, 63, 64, 65, 300} and N through {5003, 20011, 9001, 900, k/2 + 1} (no
   N a multiple of the 128-row tile; N below k), 60 cases; distances
   bitwise equal, ids equal except where the two rows' rank-only tile
   values are equal;
7. the int8 main path at ``bench.py``'s north-star shape
   (``bench.py:482-483``, ``:511-539``), on phase 5's 1M x 768 rows with
   8,192 queries, k=10: ``FlatIndex(precision="int8_rescored")`` at r=16
   (recall@10 >= 0.98 against exact ``highest`` on the first 512 queries,
   returned distances within TOL of float64) with its ``flat_topk_int8``
   launches counted over exactly this search, every one of them the
   tensor-core kernel's; ``QuantizedFlatIndex``
   insert, search, delete 1,000 ids, search again (no deleted id, recall@10
   >= 0.90); ``proj_rescored`` at proj_dim 128 and r=32 (recall reported);
   ``tune_rescore_r`` once; the int8 kernel, its plain version and the
   library call (``torch._int_mm`` per 65,536-row chunk, the same epilogue,
   ``torch.topk``) timed at the main path's call, the ``_int_mm``s alone
   (``gemm_ms``) beside it, and the kernel held to be faster than the
   library call;
8. the ``gather_block_dots`` kernel against its plain version: f32, bf16
   and int8 blocks, d in {100, 128, 384, 768}, R0 in {16, 32}, E in {1, 8},
   B in {1, 37, 300}, 40% dead picks (144 cases), then R0 in {12, 20} (the
   widths ``search_degree`` cuts to), E = 3, d in {37, 100, 384} (37 takes
   the element-wise path; 54 cases); dots and squared norms within TOL
   (int8: after the caller's per-neighbour scaling), dead lanes exactly 0,
   and a pick at or above ``cap`` NaN;
9. the bf16-operand mode of ``flat_topk`` (``precision="default"``, the
   tensor-core kernel) against its plain version: three metrics, d in {100,
   384, 768}, k in {1, 10, 33, 100, 1024}, each masked (30%) and unmasked,
   B and N cycling as in phase 6 (90 cases), ids equal up to float64 ties
   of the bf16-rounded operands; then ``FlatIndex(precision="default")`` on
   phase 4's data, held the same way, its launches counted (all of them the
   tensor-core kernel's), timed against plain and the library call (one
   bf16 matmul with f32 sums and output, ``torch.mm(...,
   out_dtype=torch.float32)``, and ``torch.topk``; its top-1 distances held
   to the kernel's within TOL), the matmul alone (``gemm_ms``), the kernel
   held to be faster than the library call, with its recall against phase
   4's exact result;
10. the HNSW main path at ``bench.py``'s HNSW workload (``bench.py:377-381``)
   on phase 4's data: ``HnswIndex`` of 100,000 x 384 cosine rows, m=16,
   ef_construction=200, wave_size=4,096, capacity 136,864, expand=8,
   seed=42; bulk insert (timed), pack, search 8,192 queries at k=10,
   ef_search=24 with the kernels' launches counted over exactly this run
   (every ``flat_topk`` launch of the build and the routing the tensor-core
   kernel's, one ``beam_step`` a beam step and no ``beam_dots``);
   returned distances equal to the exact distance of each returned row,
   recall@10 against phase 4's exact result at least 0.95; then the search
   timed, and ``gather_block_dots`` kernel against plain on the picks of
   the first beam step of one 2,816-query chunk (E=8, R0=32, d=384, bf16:
   the scoring launch of the eager step, which the fused beam takes above
   ``beam_step``'s limits); then ``beam_step`` at the HNSW cell's shape
   (ef=64, E=8, R0=32, d=384, bf16) over every step of one 2,816-query
   chunk's beam on this index (``beam_step_vs_plain``): kernel and plain
   bit for bit after every step, each timed over the beam, beside the
   bound (the live picks' ids, the kept rows, the query and the beam state
   in and out);
11. the same index with int8 beam guidance (``search_quant = "int8"``,
   repacked): search held and timed as in phase 10, with ``beam_step``
   launched on int8 blocks and no ``beam_dots``; then ``beam_step`` on the
   int8 blocks and their scales against plain at the chunk shape and this
   search's ef=24, as in phase 10;
12. the ``gather_block_topm`` kernel (``beam_dots``' top-m mode) against its
   plain version: three metrics, f32 and bf16 blocks, d in {100, 128, 384,
   768}, R0 in {16, 32}, E in {1, 8}, m in {1, 8, R0}, B cycling through
   {1, 37, 300}, 40% dead picks, 25% of lanes penalised (288 cases);
   distances within TOL, local indices equal below BIG/2 except at float64
   near-ties, dead picks (BIG, 0); then ``beam_topm = 12``
   (``tools/probes/hnsw_topm_probe.py:61-64``) on phase 10's index with bf16
   guidance, repacked: ``beam_topm`` and not ``beam_dots`` launched over
   exactly that search, held as in phase 10 and timed beside the fused
   search; the kernel against plain at the first beam step of one
   2,816-query chunk;
13. the ``beam_loop`` kernel against its plain version: integer-grid
   vectors (``tests/test_beam_loop.py:186-240``'s recipe) in 12 random
   geometries over the three metrics, one at the limits (ef = 1,024,
   E*R0 = 4,096, B = 3) and one whose query the kernel reads from device
   memory (d = 60,000), slots bit-equal and distances within 1e-6;
   Gaussian rows over a random graph, beam overlap at least 0.99 on
   average; then ``beam_whole = True`` on the same index at ef=24, expand=8:
   ``beam_loop`` and not ``beam_dots`` launched over exactly that search,
   held as in phase 10, recall within 0.01 of phase 10's fused search, timed
   beside it; the kernel against plain on one 2,816-query chunk;
14. the ``gather_rows`` kernel against ``table[idx]``: f32, bf16 and int8,
   d in {100, 384, 768}, M in {0, 1, 7, 1000, 4,099, 65,537}, bitwise
   equal, and rows outside the table filled with 0xFF bytes; then one
   ``gather_rows`` of the HNSW rescore's shape (8,192 x 24 random rows of
   phase 4's 100k x 384 f32 rows) with its launch counted, timed against
   plain and ``torch.index_select`` (printed side by side, no hard check:
   the two move by about 10% between calls);
15. the churn path at full width (``bench.py:428-471``) on phase 10's
   index: 32,768 more rows of phase 4's recipe (its centres) inserted in
   waves of 2,048 (one warm, then 15 timed: ``incr_insert_vec_per_s``),
   then 1,024 ids deleted at a time (one warm, then 7 timed:
   ``delete_repair_per_s``), slots 0..8,191 in all; every wave's
   ``flat_topk`` launch the tensor-core kernel's, the warm delete's repair
   taken eager (its f32 ``flat_topk`` calls kept for the checks below),
   each timed delete one ``delete_repair`` launch and no other; no live edge (level 0 or, after the queued promotions are
   wired, above) points at a tombstone; the packed table kept through the
   churn, its marked rows re-gathered, equal to a whole gather; the first
   2,048 queries searched at k=10, ef=32 by the row path (no table within a
   zero ``pack_budget_bytes``), the fused beam after ``pack_neighbors()``
   (``beam_step`` launched) and ``beam_whole``
   (``beam_loop`` launched): no deleted id, exact distances, recall@10
   against exact ``highest`` over the live rows at least 0.95 each;
   ``beam_step`` against plain over the fused search's beam of those 2,048
   queries (ef=32, tombstones and part-empty rows), as in phase 10; then
   the kernels against plain at the slice's shapes (the last wave's
   candidate call, bf16; a repair call, ``highest``; an all-masked corpus
   in both modes; ``beam_loop`` on a 2,816-query chunk of the churned
   graph, beam overlap at least 0.99), the two flat calls timed against
   plain and their library calls; and two waves into an empty index;
16. the IVF path at ``bench.py``'s north-star shape (``bench.py:583-653``)
   on its rows: 1M x 768 cosine about 4,096 centres (``bench.py:481-483``),
   8,192 queries:
   ``IvfIndex(cluster_size=128, rescore_r=32, seed=42)``, capacity
   1,004,096; the bulk insert timed (``build_s``, ``nlist``); searches at
   nprobe 2 and 4 (``northstar_1m_768d_ivf_p{2,4}_qps``), recall@10 on the
   first 512 queries against exact ``highest`` at least 0.95 and 0.98, every
   distance within TOL of float64, and one tensor-core ``flat_topk`` and one
   ``beam_dots`` launch per search; the search's device time split by part
   under ``torch.profiler`` once (nprobe 4); ``bench.py``'s churn (1,024
   warm inserts, 1,024 timed: ``ivf_incr_insert_vec_per_s``,
   ``ivf_pending_after_churn``, ``ivf_pending_qps`` at nprobe 4 on 2,048
   queries, one timed ``rebuild``: ``ivf_rebuild_s``); 4,096 new rows by
   ``load_rows`` into the pending region, each found first at distance
   within TOL of 0; 1,000 ids deleted and none returned; an int8-block
   index from the bf16 index's centroids (``rebuild(centroids=...)``),
   recall@10 at nprobe 4 within 0.01 of bf16's, ``beam_dots_int8``
   launched; ``save_ivf`` / ``load_ivf(device="cuda")`` of the bf16 index
   and the same for a flat index (phase 4's rows) and phase 15's HNSW
   index: identical ids, distances within TOL; then the probe call
   (8,192 x 9,375 centroids, k=4, bf16 operands) against its plain version
   and its library call, and ``gather_block_dots`` at ``[128, 768]`` blocks,
   E = 4, bf16 and int8, against plain, each timed beside its bound; last,
   the same build on phase 5's rows (1,000 centres), recall@10 at nprobe 2,
   4 and 16 reported with no floor (a query's neighbours there spread over
   about 9 clusters).
17. the graph core at ``graph_scale``'s sizes
   (``benchmarks/harness/treatments.py:344-441``), mean degree 10: A, 1M
   nodes and 10M edges (``BASELINE.json``'s configuration), and B, 10M nodes
   and 100M edges. Uniform src and dst drawn on the card from a seeded
   ``torch.Generator``, ``Graph.from_device_edges``, both CSR directions
   timed, then ``pagerank(iterations=20)``, ``connected_components`` and
   ``bfs(0)`` with ``backend="device"`` (at A also an unweighted
   ``shortest_path`` to the farthest node reached), each timed end to end
   with ``graph_scale``'s metric names, the host reads of each fixpoint
   counted, and the peak device memory read. The edges are downloaded once
   and the port's host C++ engine runs on them: BFS depths and parents
   equal, component labels equal after renumbering, at A PageRank within
   1e-5 relative and the path a shortest one; PageRank sums to 1 within
   1e-5 at both sizes. At A, ``auto`` must route each operation to the
   engine measured faster; at 10k nodes x 50k edges (the reference's
   largest published point) host and device times per operation are
   printed beside ``auto``'s choice. The phase's JSON line (``{"graph":
   ...}``) comes before the kernels' record.
18. the rest of the graph layer at ``BASELINE.json`` configs[4] ("Leiden
   community detection + Brandes betweenness on weighted 10M-edge graph"):
   phase 17's A (1M nodes, 10M uniform edges drawn on the card) with
   weights uniform in [0.1, 5.0) from the same generator, through
   ``Graph.from_device_edges``. First, at 10k nodes x 50k edges (the
   reference's largest published point), host and device times of
   ``betweenness(sample_sources=64)``, ``closeness()`` and
   ``leiden(seed=0)`` beside ``auto``'s pick. At A:
   ``betweenness(weighted=True, sample_sources=64, seed=0,
   backend="device")`` timed end to end with its host reads, source batch
   and peak device memory; the same call with 4 sources on the device and,
   on the edges downloaded once, on the host engine, within rtol 1e-3,
   atol 1e-3; the device's deduplicated COO and both CSRs array for array
   against the host's dedupe and counting sort; three
   ``leiden(seed=0, backend="device")`` runs with identical labels and Q,
   Q equal to ``modularity(labels)`` within 1e-5, and one host-engine
   Leiden (on a 100k x 1M graph of the same recipe if the measured cost
   puts it above 60 s at A) whose Q the device's must reach within 0.05;
   ``select(g, "3+0+3")`` with its depths equal to the host engine's BFS
   in each direction; ``auto``'s pick at A the engine measured faster for
   betweenness and Leiden. Then ``GraphCache.from_edges`` on A's edges with
   both CSR directions built, 5,000 ``add_edges`` between existing nodes
   and 5,000 ``remove_edges`` of existing edges applied by
   ``incremental_rebuild`` (timed against a full ``rebuild()`` plus the CSR
   build), both patched CSRs equal to a fresh build array for array and a
   BFS on them equal to the host engine's; ``save``, 1,000 more inserts and
   ``save`` again (only the tail block rewritten), ``load`` with equal
   edges. The phase's JSON line (``{"graph_analytics": ...}``) comes before
   the kernels' record; the phase adds no kernel.
19. Node2Vec at ``BASELINE.json`` configs[3] ("Node2Vec: p/q-biased random
   walks + SGNS training on 1M-node graph, embeddings indexed into HNSW"):
   1M nodes in blocks of 1,000, 10M edges drawn on the card (90% inside a
   block) through ``Graph.from_device_edges``; ``node2vec_train(dim=64,
   p=0.5, q=2.0, walk_length=80, window=5, neg_samples=5, num_walks=2,
   epochs=1, seed=0, walk_batch=2**20, sgns_chunk=256, backend="device",
   output_index=HnswIndex(64, "cosine"))``, the defaults' widths with the
   depth cut (epochs 5 -> 1, ``num_walks`` 10 -> 2). First, on the card,
   the node2vec treatment's host and device times at its 2k nodes and at
   the 4k crossover beside ``auto``'s pick; the hub's weighted draw; the
   one-step law of the walk (second hop given start and first hop, 100k
   walkers at three (p, q)) within 5 binomial standard deviations + 0.002
   of the closed form of the 4-round truncated rejection sampler; one SGNS
   chunk against the CPU's with the same negatives (within TOL); the walk
   tables of a weighted 100k-node graph against the CPU's (order equal,
   sums within 1e-6 relative); the two cliques separated (the host route
   at seed 2, the device route on average over 8 seeds). Then the run,
   timed by stage (``train_s`` and ``nodes_per_s``, the treatment's
   names; prep, walks and SGNS a pass; download; the HNSW insert) with its
   peak memory and kernel launches (the bulk build's ``flat_topk`` calls);
   4,096 sampled walks, every step an edge of the 'both' CSR or a dead
   end's repeat; unit rows, 2,048 of them under their ids in the index;
   the index's self-retrieval reported (the reference's trainer at this
   depth leaves every row near one direction, ROADMAP section 3), an exact
   search finding every sampled row first, the block purity of its top
   10 reported, and ``HnswIndex`` over 1M random unit rows of the same
   width finding each of 2,048 rows first for at least MIN_HNSW_RECALL;
   ``torch.profiler`` splits of one walk batch and 64 SGNS chunks; one
   default 4,096-walker batch timed; then ``flat_topk`` at the bulk
   build's call (8,192 x 1M x 64, k=33, bf16) against its plain version,
   timed with its bound and the bf16 library call in chunks of 2,048
   queries, and ``beam_step`` against plain over the beam of the index's
   search of the 2,048 sampled rows (ef=20, E=8, R0=32, d=64, bf16), as in
   phase 10. The phase's JSON line (``{"node2vec":
   ...}``) comes before the kernels' record; the phase adds no kernel.

20. ``delete_repair`` at the churn cell's shape: ``HnswIndex(384, "l2",
   m=16)`` bulk-built over phase 4's 100k rows, 2,048 seeded ids deleted
   in one wave (some 45-60k affected rows against a pool of 40-50k, kk
   33): the kernel's graph against the eager repair's (``flat_topk`` at
   ``highest`` in chunks of 4,096 rows, forced), bit for bit; the kernel
   timed (the graph restored between calls) beside its FP32 bound, the
   eager repair's device and wall ms, and the library yardstick, one f32
   ``torch.mm`` (TF32 off) of the affected rows against the pool and one
   ``torch.topk`` (in chunks of 8,192 rows, without the merge). Its JSON
   line (``{"delete_repair": ...}``) comes before the kernels' record,
   which carries it.

Each kernel's record carries its bound: the larger of the operations over
the card's peak rate for their type and the bytes (each input read once,
each output written once) over 3.35 TB/s, from the H100 SXM data sheet.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import itertools
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

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
MIN_RESCORED_RECALL = 0.98   # int8_rescored, r=16, against exact
MIN_QUANTIZED_RECALL = 0.90  # QuantizedFlatIndex, int8-only ranking
# the tensor-core kernel's cases (phases 6 and 9): k across its buffer
# widths up to MAX_K, B around one warpgroup's 64 rows, N off the 128-row
# tile and, last, below k; the f32 kernel's (phase 3): B around its
# 128-query tile
MMA_KS = (1, 10, 33, 100, 1024)
MMA_BS = (1, 63, 64, 65, 300)
F32_BS = (1, 127, 128, 129, 300)
# H100 SXM data sheet, dense, at 700 W: FP32 on CUDA cores, bf16 and int8 on
# tensor cores, HBM bandwidth
PEAK = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


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


def bound(ops: float, peak: str, nbytes: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of ``ops`` at
    ``PEAK[peak]`` and ``nbytes`` at the HBM rate, and which one it is."""
    t_ops = ops / PEAK[peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    them: the product of the bf16-rounded query and the bf16-rounded raw
    row; norms from the unrounded rows. For cosine, ``q`` is the unit query
    as the kernel's wrapper forms it (``unit_rows`` in f32 on the card):
    normalised in float64 instead, one of its components can round to the
    other bf16 neighbour, which moves every distance of that query by up to
    about 2e-4."""
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    dots = (bf16_round(q).astype(np.float64)
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
        if ref is dist64_bf16 and metric == "cosine":
            from muninn_tpu_torch.ops.distance import unit_rows

            q = unit_rows(q)  # the whole batch, as the wrapper normalises it
        qs = q[torch.from_numpy(b).to(q.device)]
        true = ref(qs.cpu().numpy(), rows.cpu().numpy(), metric)
        untied = np.abs(true - pd[b, r]) > TOL + TOL * np.abs(pd[b, r])
        check(not untied.any(), f"{int(untied.sum())} of {len(bad)} differing"
              " ids without a tie")
    return float(np.max(np.abs(kd[fin] - pd[fin]), initial=0.0))


def int8_tiles(qi: np.ndarray, ci: np.ndarray, cs: np.ndarray,
               cp: np.ndarray) -> np.ndarray:
    """Rank-only tile values of matching rows, as the kernel forms them:
    the exact integer dot rounded once to f32, ``cp - dot * cs`` with each
    step rounded in f32."""
    dots = (qi.astype(np.int64) * ci.astype(np.int64)).sum(-1)
    return cp.astype(np.float32) - dots.astype(np.float32) * cs.astype(np.float32)


def compare_int8(kd, ki, pd, pi, qi, ci, cs, cp) -> float:
    """The int8 kernel's result (kd, ki) against the plain one (pd, pi):
    distances bitwise equal; ids equal except at exact ties of the
    rank-only tile value, judged from the two returned rows themselves.
    ``qi`` [B, d] and ``ci`` [N, d] int8, ``cs`` and ``cp`` [N] f32, all on
    the card. Returns the largest absolute distance difference (0)."""
    check(torch.equal(kd, pd), "int8 distances differ from the plain version")
    bad = (ki != pi).nonzero()
    if len(bad):
        b = bad[:, 0]
        ka = ki[b, bad[:, 1]].long()
        pa = pi[b, bad[:, 1]].long()
        check(bool((ka >= 0).all() and (pa >= 0).all()), "an int8 id is -1")
        qb, ck, cpl, csk, cpk, csp, cpp = (t.cpu().numpy() for t in (
            qi[b], ci[ka], ci[pa], cs[ka], cp[ka], cs[pa], cp[pa]))
        tk = int8_tiles(qb, ck, csk, cpk)
        tp = int8_tiles(qb, cpl, csp, cpp)
        check(np.array_equal(tk, tp), f"{len(bad)} int8 ids differ without a tie")
    fin = torch.isfinite(pd)
    return float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0


def compare_topm(kd, kl, pd, pl, q, picks, packed, metric, big) -> float:
    """The top-m kernel's (kd, kl) [B, E, m] against the plain (pd, pl), on
    queries ``q`` [B, d] and ``picks`` [B, E] into ``packed``: distances
    within TOL; dead picks exactly (big, 0); local indices equal wherever
    the plain distance is below big/2, except where the two chosen rows'
    float64 distances tie within TOL. Returns the largest distance
    difference."""
    torch.testing.assert_close(kd, pd, rtol=TOL, atol=TOL)
    dead = picks < 0
    check(bool((kd[dead] == big).all() and (kl[dead] == 0).all()),
          "top-m: a dead pick is not (BIG, 0)")
    bad = (pd < big / 2) & (kl != pl)
    if bool(bad.any()):
        b, e, r = bad.nonzero(as_tuple=True)
        slot = picks[b, e].long()
        qs = q[b].cpu().numpy()
        ref_k = dist64(qs, packed[slot, kl[b, e, r].long()].float().cpu().numpy(), metric)
        ref_p = dist64(qs, packed[slot, pl[b, e, r].long()].float().cpu().numpy(), metric)
        check(bool(np.all(np.abs(ref_k - ref_p) <= TOL + TOL * np.abs(ref_p))),
              f"top-m: {len(b)} local indices differ without a tie")
    live = pd < big / 2
    return float((kd[live] - pd[live]).abs().max()) if bool(live.any()) else 0.0


def mma_shape(case: int, k: int, bs=MMA_BS) -> tuple[int, int]:
    """(B, N) of a flat kernel's ``case``-th comparison at ``k``: B cycles
    through ``bs`` and N through 5003, 20011, 9001, 900 and k/2 + 1, so that
    25 consecutive cases meet every pair."""
    ns = (5003, 20011, 9001, 900, k // 2 + 1)
    return bs[case % len(bs)], ns[(case // len(bs)) % len(ns)]


def grid_rows(rng, n: int, d: int) -> np.ndarray:
    """``tests/test_beam_loop.py:203-206``: multiples of 1/4 in [-1, 1], no
    all-zero row. Exact in bf16, and every dot and squared norm of two such
    rows at d <= 128 is exact in f32, in any order."""
    v = rng.integers(-4, 5, (n, d)).astype(np.float32) / 4.0
    v[np.abs(v).sum(axis=-1) == 0, 0] = 1.0
    return v


def recall(kid: np.ndarray, pid: np.ndarray) -> float:
    """Share of the plain top-k ids that the kernel's top-k holds too (no
    allowance for ties: ``compare`` judges those)."""
    hits = sum(len(set(a.tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(kid, pid))
    return hits / int((pid >= 0).sum())


def unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def clustered(rng, n, d, n_clusters, n_queries, extra):
    """The recipe of bench.py: Gaussian cluster centres, rows = centre +
    0.3 noise, unit-normalised; queries = corpus rows + 0.05 noise,
    re-normalised; then ``extra`` more rows about the same centres (the
    churn rows, drawn last so that they change nothing before them)."""
    centres = rng.standard_normal((n_clusters, d), dtype=np.float32)

    def rows(count):
        x = centres[rng.integers(0, n_clusters, count)]
        x += 0.3 * rng.standard_normal((count, d), dtype=np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    x = rows(n)
    q = x[rng.integers(0, n, n_queries)]
    q = q + 0.05 * rng.standard_normal((n_queries, d), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q, rows(extra)


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


def split_by_part(mod, parts, step) -> tuple[float, float, dict[str, float]]:
    """The host wall ms of one call of ``step`` (no profiler), the device's
    busy ms in one under ``torch.profiler`` as it runs, and each part's
    device ms in one with ``mod``'s functions ``parts`` fenced by
    synchronizes (kernels inside the part's range), "other" for the
    rest."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kind = torch.autograd.DeviceType.CUDA

    def union_ms(spans) -> float:
        busy, last = 0.0, float("-inf")
        for s, t in sorted(spans):
            busy += max(0.0, t - max(s, last))
            last = max(last, t)
        return busy / 1e3

    def kernels(prof):
        return [(e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == kind and not e.name.startswith("part:")]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=act) as prof:
        step()
        torch.cuda.synchronize()
    busy = union_ms(kernels(prof))
    saved = {name: getattr(mod, name) for name in parts}

    def fenced(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            with torch.profiler.record_function(f"part:{name}"):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return call

    try:
        for name in parts:
            setattr(mod, name, fenced(name, saved[name]))
        with torch.profiler.profile(activities=act) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(mod, name, fn)
    spans = kernels(prof)
    split = {name: 0.0 for name in parts}
    for e in prof.events():
        if e.device_type != kind and e.name.startswith("part:"):
            lo, hi = e.time_range.start, e.time_range.end
            split[e.name[5:]] += union_ms([(s, t) for s, t in spans
                                          if s >= lo and t <= hi])
    split["other"] = union_ms(spans) - sum(split.values())
    return busy, wall, split


def ivf_phase(x4: np.ndarray, q4: np.ndarray, hnsw, bf16_library, k: int) -> dict:
    """Phase 16: the IVF path at ``bench.py``'s north-star shape, its
    checkpoints, and its kernels at their IVF call shapes. ``x4`` and ``q4``
    are phase 4's rows and queries, ``hnsw`` phase 15's index. Returns the
    numbers of the kernels' record."""
    import shutil

    from muninn_tpu_torch import FlatIndex, IvfIndex
    from muninn_tpu_torch.index import ivf as ivf_mod
    from muninn_tpu_torch.io import checkpoint as ck
    from muninn_tpu_torch.ops import _build
    from muninn_tpu_torch.ops.beam import gather_block_dots_cuda, gather_block_dots_plain
    from muninn_tpu_torch.ops.distance import unit_rows as unit_t
    from muninn_tpu_torch.ops.flat_topk import flat_topk, flat_topk_cuda, flat_topk_plain

    card = card_line()
    n, d, nq, s = 1_000_000, 768, 8192, 128
    # bench.py's north-star rows: 4,096 centres (bench.py:481-483), the
    # recipe JAX's IVF recall was recorded on
    gen = torch.Generator(device="cuda").manual_seed(3)
    x16, q16 = clustered_on_device(gen, n, d, 4096, nq)
    _, truth = flat_topk(q16[:512], x16, k, metric="cosine")
    truth = truth.cpu().numpy()

    def exact_err(dd, slots, q, rows_of) -> tuple[float, int]:
        """Largest |returned distance - float64 cosine distance| of the
        returned rows, ascending and (inf, -1) exactly where a query has
        fewer than k results, and the count of such queries (their probed
        clusters held fewer than k live rows)."""
        got = slots >= 0
        check(bool((torch.isfinite(dd) == got).all()),
              "IVF: inf distances and -1 slots disagree")
        check(bool((dd[:, 1:] >= dd[:, :-1]).all()), "IVF: dists not ascending")
        err = 0.0
        for lo in range(0, q.shape[0], 2048):
            rows = rows_of(slots[lo:lo + 2048].clamp(min=0).long()).double()
            want = 1.0 - (rows * unit_t(q[lo:lo + 2048]).double()[:, None, :]).sum(-1) \
                / rows.norm(dim=-1)
            diff = (dd[lo:lo + 2048].double() - want).abs()
            err = max(err, float(torch.where(got[lo:lo + 2048], diff, 0.0).max()))
        check(err <= TOL, f"IVF distance error {err}")
        return err, int((~got).any(dim=1).sum())

    def rows_of(idx):
        return lambda sl: idx.store.vectors[sl]

    # 1. build and search (bench.py:588-620)
    ivf = IvfIndex(d, "cosine", cluster_size=s, rescore_r=32, capacity=n + 4096,
                   seed=42, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    ivf.insert(np.arange(n), x16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(sum(_build.LAUNCHES.values()) == 0,
          f"the IVF build launched {dict(_build.LAUNCHES)}")
    check(ivf.centroids is not None and ivf._pending_count == 0, "IVF: not built")
    sparse = int((ivf._fill < k).sum())
    print(f"{card}; IVF 1M x {d} cosine, cluster_size={s}: build {build_s:.3f} s"
          f" ({n / build_s:.0f} vec/s), nlist {ivf.nlist}, blocks"
          f" {tuple(ivf.blocks.shape)} {ivf.blocks.dtype}; {sparse} clusters"
          f" with fewer than {k} members (fewest {int(ivf._fill.min())})",
          flush=True)
    out: dict = {"build_s": build_s, "nlist": ivf.nlist,
                 "clusters_below_k": sparse}
    err = 0.0
    for p in (2, 4):
        _build.reset_launches()
        dd, sl = ivf.search_device(q16, k, nprobe=p)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(launches["flat_topk_mma"] == 1 and launches["flat_topk"] == 1
              and launches["beam_dots"] == 1 and sum(launches.values()) == 3,
              f"an IVF search at nprobe={p} launched {launches}")
        e, short = exact_err(dd, sl, q16, rows_of(ivf))
        err = max(err, e)
        rec = recall(sl[:512].cpu().numpy(), truth)
        floor = 0.98 if p == 4 else 0.95
        check(rec >= floor, f"IVF recall@{k} at nprobe={p}: {rec} < {floor}")
        ms = device_ms(lambda: ivf.search_device(q16, k, nprobe=p), reps=5)
        out[f"northstar_1m_768d_ivf_p{p}_qps"] = nq / ms * 1e3
        out[f"recall_p{p}"] = rec
        out[f"search_ms_p{p}"] = ms
        out[f"short_p{p}"] = short
        out["launches"] = launches
        print(f"  nprobe={p}: recall@{k} {rec} (first 512 queries vs exact);"
              f" {short} of {nq} queries with fewer than {k} results;"
              f" {nq} queries in {ms:.3f} ms"
              f" (northstar_1m_768d_ivf_p{p}_qps {nq / ms * 1e3:.1f});"
              f" launches {launches}", flush=True)
    busy, wall, split = split_by_part(
        ivf_mod, ("flat_topk", "gather_block_dots", "packed_distances",
                  "smallest_k", "gathered_distances", "sorted_topk_unique"),
        lambda: ivf.search_device(q16, k, nprobe=4))
    out["split"] = {"busy_ms": busy, "wall_ms": wall, **split}
    print(f"  nprobe=4 under the profiler: device busy {busy:.3f} ms, against a"
          f" {wall:.3f} ms host wall without it (idle {1 - busy / wall:.1%}); device ms,"
          " parts fenced: " + ", ".join(f"{kk} {v:.3f}" for kk, v in split.items()),
          flush=True)
    cent16 = ivf.centroids.clone()

    # 2. churn (bench.py:622-653), then the pending region and deletes
    churn_ids = np.arange(n, n + 2048)
    ivf.insert(churn_ids[:1024], x16[:1024])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf.insert(churn_ids[1024:], x16[1024:2048])
    torch.cuda.synchronize()
    out["ivf_incr_insert_vec_per_s"] = 1024 / (time.perf_counter() - t0)
    out["ivf_pending_after_churn"] = ivf._pending_count
    out["ivf_pending_qps"] = 2048 / device_ms(
        lambda: ivf.search_device(q16[:2048], k, nprobe=4), reps=5) * 1e3
    t0 = time.perf_counter()
    ivf.rebuild()
    torch.cuda.synchronize()
    out["ivf_rebuild_s"] = time.perf_counter() - t0
    check(ivf._pending_count == 0, "IVF: rows left pending by a rebuild")
    fresh = unit_t(torch.randn(4096, d, generator=gen, device="cuda"))
    fresh_ids = np.arange(2_000_000, 2_004_096)
    ivf.load_rows(fresh_ids, fresh)
    check(ivf._pending_count == 4096, f"pending {ivf._pending_count} after load_rows")
    _build.reset_launches()
    fd, fsl = ivf.search_device(fresh, k, nprobe=4)
    fids = ivf.store.ids_of(fsl.cpu().numpy())
    check(np.array_equal(fids[:, 0], fresh_ids), "a pending row is not its own first hit")
    check(float(fd[:, 0].abs().max()) <= TOL, "a pending row's self-distance")
    err = max(err, exact_err(fd, fsl, fresh, rows_of(ivf))[0])
    dd, sl = ivf.search_device(q16, k, nprobe=4)
    dead = np.unique(ivf.store.ids_of(sl[:, 0].cpu().numpy()))[:1000]
    check(len(dead) == 1000, "IVF: fewer than 1,000 distinct first hits")
    ivf.delete(dead)
    dd, sl = ivf.search_device(q16, k, nprobe=4)
    check(not np.isin(ivf.store.ids_of(sl.cpu().numpy()), dead).any(),
          "IVF: a deleted id came back")
    err = max(err, exact_err(dd, sl, q16, rows_of(ivf))[0])
    print(f"  churn: ivf_incr_insert_vec_per_s {out['ivf_incr_insert_vec_per_s']:.1f},"
          f" ivf_pending_after_churn {out['ivf_pending_after_churn']},"
          f" ivf_pending_qps {out['ivf_pending_qps']:.1f} (2,048 queries, nprobe=4),"
          f" ivf_rebuild_s {out['ivf_rebuild_s']:.3f}; 4,096 pending rows each"
          " found first; 1,000 deleted, none returned; max |d| error"
          f" {err:.3g}", flush=True)

    # 3. int8 blocks from the bf16 index's centroids
    ivf8 = IvfIndex(d, "cosine", cluster_size=s, rescore_r=32, capacity=n + 4096,
                    seed=42, quant="int8", device="cuda")
    ivf8.load_rows(np.arange(n), x16)
    del x16
    t0 = time.perf_counter()
    ivf8.rebuild(centroids=cent16)
    torch.cuda.synchronize()
    out["int8_rebuild_s"] = time.perf_counter() - t0
    _build.reset_launches()
    dd8, sl8 = ivf8.search_device(q16, k, nprobe=4)
    torch.cuda.synchronize()
    launches8 = dict(_build.LAUNCHES)
    check(launches8["beam_dots_int8"] == 1 and launches8["beam_dots"] == 0
          and launches8["flat_topk_mma"] == 1, f"an int8-block search launched {launches8}")
    err = max(err, exact_err(dd8, sl8, q16, rows_of(ivf8))[0])
    rec8 = recall(sl8[:512].cpu().numpy(), truth)
    check(abs(rec8 - out["recall_p4"]) <= 0.01,
          f"int8 blocks' recall {rec8} against bf16's {out['recall_p4']}")
    ms8 = device_ms(lambda: ivf8.search_device(q16, k, nprobe=4), reps=5)
    out.update(recall_int8_p4=rec8, int8_p4_qps=nq / ms8 * 1e3, launches_int8=launches8)
    print(f"  int8 blocks (rebuild from the bf16 centroids {out['int8_rebuild_s']:.3f} s):"
          f" recall@{k} {rec8} at nprobe=4; {ms8:.3f} ms ({nq / ms8 * 1e3:.1f} QPS);"
          f" launches {launches8}", flush=True)

    # 4. checkpoints on the card
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    flat = FlatIndex(x4.shape[1], "cosine", device="cuda")
    flat.insert(np.arange(len(x4)), x4)
    t0 = time.perf_counter()
    for kind, idx, search in (
            ("ivf", ivf, lambda i: i.search(q16, k=k, nprobe=4)),
            ("flat", flat, lambda i: i.search(q4[:2048], k=k)),
            ("hnsw", hnsw, lambda i: i.search(q4[:2048], k=k, ef_search=32))):
        getattr(ck, f"save_{kind}")(idx, root / kind)
        back = getattr(ck, f"load_{kind}")(root / kind, device="cuda")
        check(back.store.vectors.is_cuda, f"load_{kind} left the store off the card")
        if kind == "hnsw":
            for name in ("search_quant", "beam_topm", "beam_whole", "search_degree",
                         "expand", "route_entries", "beam_patience",
                         "beam_max_iters", "exact_small_n", "search_bf16"):
                setattr(back, name, getattr(idx, name))
            for h in (idx, back):
                h.pack_neighbors()
        (wi, wd), (gi, gd) = search(idx), search(back)
        check(np.array_equal(gi, wi), f"{kind} checkpoint: ids differ after load")
        np.testing.assert_allclose(gd, wd, rtol=TOL, atol=TOL)
        del back
    out["checkpoint_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    del flat
    print(f"  checkpoints: save/load on the card of the IVF (bf16, after churn),"
          f" flat and HNSW indexes, identical ids, in {out['checkpoint_s']:.1f} s",
          flush=True)

    # 5. the kernels at the IVF call shapes
    p = 4
    cent = ivf.centroids
    kd, ki = flat_topk_cuda(q16, cent, p, metric="cosine", precision="default")
    torch.cuda.synchronize()
    pd, pi = flat_topk_plain(q16, cent, p, metric="cosine", precision="default")
    all_c = torch.ones(cent.shape[0], dtype=torch.bool, device="cuda")
    out["probe_err"] = compare(kd, ki, pd, pi, q16, cent, None, "cosine",
                               ref=dist64_bf16)
    out["probe_ms"] = device_ms(lambda: flat_topk(
        q16, cent, p, metric="cosine", precision="default"), reps=20)
    out["probe_plain_ms"] = device_ms(lambda: flat_topk_plain(
        q16, cent, p, metric="cosine", precision="default"))
    out["probe_library_ms"] = device_ms(lambda: bf16_library(q16, cent, all_c, p), reps=20)
    ncl = cent.shape[0]
    out["probe_bound_ms"], out["probe_bound_by"] = bound(
        2.0 * nq * ncl * d, "bf16", 4.0 * (ncl + nq) * d + ncl + 8.0 * nq * p)

    def block_bound(blocks, picks):
        """Ops: a multiply-add for the dot and one for the squared norm of
        every row of every pick; bytes: each probed block once, the queries
        and ids, and the two [B, E*S] f32 outputs (and, per pick, the same
        with a block read for every pick)."""
        uniq = int(torch.unique(picks).numel())
        blk = blocks.shape[1] * blocks.shape[2] * blocks.element_size()
        io = q16.numel() * 4 + picks.numel() * 4 + 2 * picks.numel() * blocks.shape[1] * 4
        ops = 4.0 * picks.numel() * blocks.shape[1] * blocks.shape[2]
        return bound(ops, "fp32", uniq * blk + io), bound(ops, "fp32", picks.numel() * blk + io)[0]

    for tag, idx in (("", ivf), ("_int8", ivf8)):
        blocks = idx.blocks
        picks = flat_topk(q16, idx.centroids, p, metric="cosine",
                          precision="default")[1].clamp(min=0)
        kdot, kcn = gather_block_dots_cuda(q16, picks, blocks)
        torch.cuda.synchronize()
        scale = (idx.block_scales[picks.long()].reshape(nq, -1)
                 if idx.block_scales is not None else None)
        berr = 0.0
        for lo in range(0, nq, 1024):
            pdot, pcn = gather_block_dots_plain(q16[lo:lo + 1024], picks[lo:lo + 1024],
                                                blocks)
            a, b_, c_, e_ = kdot[lo:lo + 1024], kcn[lo:lo + 1024], pdot, pcn
            if scale is not None:
                sc = scale[lo:lo + 1024]
                a, b_, c_, e_ = a * sc, b_ * sc * sc, c_ * sc, e_ * sc * sc
            torch.testing.assert_close(a, c_, rtol=TOL, atol=TOL)
            torch.testing.assert_close(b_, e_, rtol=TOL, atol=TOL)
            berr = max(berr, float((a - c_).abs().max()), float((b_ - e_).abs().max()))
        out[f"beam_err{tag}"] = berr
        out[f"beam_ms{tag}"] = device_ms(
            lambda: gather_block_dots_cuda(q16, picks, blocks), reps=20)

        def plain_all():
            for lo in range(0, nq, 2048):
                gather_block_dots_plain(q16[lo:lo + 2048], picks[lo:lo + 2048], blocks)

        out[f"beam_plain_ms{tag}"] = device_ms(plain_all, reps=3)
        (out[f"beam_bound_ms{tag}"], out[f"beam_bound_by{tag}"]), \
            out[f"beam_bound_ms_per_pick{tag}"] = block_bound(blocks, picks)
    print(f"  probe call [{nq}, {d}] x [{ncl}, {d}] bf16 operands, k={p}: kernel"
          f" {out['probe_ms']:.4f} ms, plain {out['probe_plain_ms']:.4f} ms, library"
          f" {out['probe_library_ms']:.4f} ms; bound {out['probe_bound_ms']:.4f} ms"
          f" ({out['probe_bound_by']}); max |d| error {out['probe_err']:.3g}",
          flush=True)
    for tag, name in (("", "bf16"), ("_int8", "int8")):
        print(f"  gather_block_dots [{nq}, {p}] x [{s}, {d}] {name}: kernel"
              f" {out['beam_ms' + tag]:.4f} ms, plain {out['beam_plain_ms' + tag]:.4f}"
              f" ms (2,048 queries a call); bound {out['beam_bound_ms' + tag]:.4f} ms"
              f" ({out['beam_bound_by' + tag]}; each probed block read once),"
              f" {out['beam_bound_ms_per_pick' + tag]:.4f} ms with a block read per"
              f" pick; max error {out['beam_err' + tag]:.3g}", flush=True)
    out["err"] = err
    del ivf, ivf8
    torch.cuda.empty_cache()

    # 6. the data regime: phase 5's rows (1,000 centres, some 1,000 rows
    # each, so a query's top-10 spreads over about 9 clusters), no floor
    gen = torch.Generator(device="cuda").manual_seed(11)
    x5, q5 = clustered_on_device(gen, n, d, 1000, nq)
    _, truth5 = flat_topk(q5[:512], x5, k, metric="cosine")
    ivf5 = IvfIndex(d, "cosine", cluster_size=s, rescore_r=32, capacity=n + 4096,
                    seed=42, device="cuda")
    ivf5.insert(np.arange(n), x5)
    del x5
    out["recall_1000_centres"] = {
        p5: recall(ivf5.search_device(q5[:512], k, nprobe=p5)[1].cpu().numpy(),
                   truth5.cpu().numpy()) for p5 in (2, 4, 16)}
    print(f"  phase 5's rows (1,000 centres): recall@{k} by nprobe"
          f" {out['recall_1000_centres']} (no floor)", flush=True)
    del ivf5, q5
    print(json.dumps({"ivf_northstar_1m_768d": {
        key: out[key] for key in (
            "build_s", "nlist", "clusters_below_k", "recall_p2", "recall_p4",
            "short_p2", "short_p4",
            "northstar_1m_768d_ivf_p2_qps", "northstar_1m_768d_ivf_p4_qps",
            "ivf_incr_insert_vec_per_s", "ivf_pending_after_churn",
            "ivf_pending_qps", "ivf_rebuild_s", "recall_int8_p4", "int8_p4_qps",
            "recall_1000_centres")}}), flush=True)
    del q16
    torch.cuda.empty_cache()
    return out


# phase 17: graph_scale's sizes (benchmarks/harness/treatments.py:344-441),
# mean degree 10: A is BASELINE.json's 10M-edge configuration, B the
# treatment's largest row; and the reference's largest published point
# (10k nodes, 50k edges), where the routing's crossover lies
GRAPH_DEGREE = 10
GRAPH_SIZES = (("A", 1_000_000), ("B", 10_000_000))
GRAPH_ENVELOPE = (10_000, 50_000)
PR_RTOL = 1e-5  # PageRank, device (f64 sums) against the host's all-double run


def device_edges(n: int, e: int, seed: int):
    """Uniform src and dst on the card from a seeded CUDA generator, as
    graph_scale draws them with ``jax.random.randint``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randint(0, n, (e,), generator=gen, device="cuda",
                               dtype=torch.int32) for _ in range(2))


def timed_s(fn):
    """(result, host seconds) of one call, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_device_s(fn, reps: int) -> dict:
    """Median host seconds of ``reps`` calls of ``fn(backend)`` on each
    engine, after one warm call each."""
    times = {}
    for backend in ("host", "device"):
        fn(backend)
        times[backend] = statistics.median(
            timed_s(lambda: fn(backend))[1] for _ in range(reps))
    return {"host_s": times["host"], "device_s": times["device"]}


def graph_route_times(n: int, e: int, seed: int, reps: int = 3) -> dict:
    """Host engine against device fixpoints per operation on a
    ``from_edges`` graph on the card (host mirrors present), each CSR
    built beforehand: the median of ``reps`` timed calls after one warm
    call, in seconds, and what ``auto`` picks."""
    from muninn_tpu_torch.graph import Graph

    src, dst = (t.cpu().numpy() for t in device_edges(n, e, seed))
    g = Graph.from_edges(src, dst)
    t = int(dst[-1])
    ops = {
        "bfs": lambda b: g.bfs(0, backend=b, as_array=True),
        "components": lambda b: g.connected_components(backend=b,
                                                       as_array=True),
        "pagerank": lambda b: g.pagerank(backend=b, as_array=True),
        "shortest_path": lambda b: g.shortest_path(0, t, weighted=False,
                                                   backend=b),
    }
    return {name: {**host_device_s(fn, reps),
                   "auto_host": auto_picks_host(name, e)}
            for name, fn in ops.items()}


def auto_picks_host(op: str, e: int) -> bool:
    """Whether ``auto`` sends ``op`` on a graph of ``e`` edges (host
    mirrors present) to the host engine: the routing's own estimate and
    ceiling, as ``Graph`` passes them."""
    from muninn_tpu_torch.graph import routing

    estimate, ceiling = {
        "bfs": (routing.COST_BFS_EDGE * e, routing.HOST_SECONDS_BFS),
        "components": (routing.COST_COMPONENTS_EDGE * e,
                       routing.HOST_SECONDS_COMPONENTS),
        "pagerank": (routing.COST_PAGERANK_EDGE_ITER * e * 20,
                     routing.HOST_SECONDS_PAGERANK),
        "shortest_path": (routing.COST_SSSP_EDGE * e,
                          routing.HOST_SECONDS_SSSP),
    }[op]
    return routing.use_host("auto", estimate, ceiling)


def graph_size(n: int, seed: int, host_pagerank: bool) -> dict:
    """graph_scale at ``n`` nodes on the card: ``from_device_edges``, both
    CSR directions, PageRank (20 iterations), components and BFS from node
    0 with ``backend="device"`` (and an unweighted shortest path where
    ``host_pagerank``), each timed end to end through the public API, held
    against the host engine on the same edges, downloaded once."""
    from muninn_tpu_torch import native
    from muninn_tpu_torch.graph import Graph
    from muninn_tpu_torch.graph import traversal as trv

    e = n * GRAPH_DEGREE
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    src, dst = device_edges(n, e, seed)
    g = Graph.from_device_edges(src, dst, num_nodes=n)
    del src, dst  # the graph holds its padded copies
    _, build_s = timed_s(lambda: (g.csr("forward"), g.csr("reverse")))
    m = {"nodes": n, "edges": e, "csr_build_s": build_s,
         "csr_build_medge_per_s": 2 * e / build_s / 1e6}
    rank, pr_s = timed_s(lambda: g.pagerank(iterations=20, backend="device",
                                            as_array=True))
    m.update(pagerank20_s=pr_s, pagerank_medge_iter_per_s=20 * e / pr_s / 1e6,
             pagerank_sum=float(rank.sum(dtype=np.float64)))
    trv.reset_host_syncs()
    labels, cc_s = timed_s(lambda: g.connected_components(backend="device",
                                                          as_array=True))
    m.update(components_s=cc_s, n_components=int(labels.max()) + 1,
             components_host_syncs=trv.HOST_SYNCS["components"])
    (depth, parent), bfs_s = timed_s(lambda: g.bfs(0, backend="device",
                                                   as_array=True))
    m.update(bfs_s=bfs_s, bfs_reached=int((depth < 2**30).sum()),
             bfs_host_syncs=trv.HOST_SYNCS["bfs"])
    check(g.device_native, "a device analytic downloaded the host mirrors")
    check(abs(m["pagerank_sum"] - 1.0) <= 1e-5,
          f"PageRank sums to {m['pagerank_sum']!r} at {n} nodes")

    # the host engine on the same edges
    js, jd, _ = g._dev_coo
    (hs, hd), m["download_s"] = timed_s(
        lambda: (js[:e].cpu().numpy(), jd[:e].cpu().numpy()))
    (off, _, hdst, _), m["host_csr_build_s"] = timed_s(
        lambda: native.csr_build(hs, hd, None, n))
    (hdepth, hparent), m["host_bfs_s"] = timed_s(
        lambda: native.graph_bfs(off, hdst, 0, n))
    check(np.array_equal(depth, hdepth) and np.array_equal(parent, hparent),
          f"BFS depth or parent differs from the host engine at {n} nodes")
    hcomp, m["host_components_s"] = timed_s(
        lambda: native.graph_components(hs, hd, n))
    check(np.array_equal(labels, np.unique(hcomp, return_inverse=True)[1]),
          f"component labels differ from the host engine at {n} nodes")
    if host_pagerank:
        ones = np.ones(e, np.float32)
        deg = np.bincount(hs, minlength=n).astype(np.float32)
        hrank, m["host_pagerank20_s"] = timed_s(
            lambda: native.graph_pagerank(hs, hd, ones, deg, 0.85, 20, False))
        err = float(np.max(np.abs(rank - hrank) / hrank))
        m["pagerank_max_rel_err"] = err
        check(err <= PR_RTOL, f"PageRank differs from the host engine by"
              f" {err:.3g} relative at {n} nodes")
        # an unweighted shortest path to the farthest node BFS reached
        t = int(np.argmax(np.where(depth < 2**30, depth, -1)))
        trv.reset_host_syncs()
        (path, dist), m["shortest_path_s"] = timed_s(
            lambda: g.shortest_path(0, t, weighted=False, backend="device"))
        m["shortest_path_host_syncs"] = trv.HOST_SYNCS["sssp"]
        (hdist, _), m["host_shortest_path_s"] = timed_s(
            lambda: native.graph_sssp(hs, hd, ones, n, 0))
        hops = set(zip(hs[np.isin(hs, path)].tolist(),
                       hd[np.isin(hs, path)].tolist()))
        check(dist == float(hdist[t]) == float(depth[t]) == len(path) - 1
              and path[0] == 0 and path[-1] == t
              and all(h in hops for h in zip(path, path[1:])),
              f"shortest path 0 -> {t} is not a shortest path at {n} nodes")
        m["shortest_path_hops"] = len(path) - 1
    m["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
    del g
    torch.cuda.empty_cache()
    return m


def graph_phase() -> dict:
    """Phase 17: the graph core at graph_scale's sizes, and the routing's
    host-against-device times. Returns what the phase's JSON line prints."""
    from muninn_tpu_torch import native

    t0 = time.perf_counter()
    check(native.graph_available(), "the host graph library did not build")
    out = {"wait_native_s": time.perf_counter() - t0}
    # every op once at a small size first, so that no size's timings take
    # the first use of a CUDA kernel (module loading)
    graph_size(GRAPH_ENVELOPE[0], seed=1, host_pagerank=True)
    for name, n in GRAPH_SIZES:
        m = out[name] = graph_size(n, seed=17 + n, host_pagerank=name == "A")
        print(f"  graph {name}: {n:,} nodes, {m['edges']:,} edges:"
              f" csr {m['csr_build_s']:.4f} s, pagerank20"
              f" {m['pagerank20_s']:.4f} s (sum {m['pagerank_sum']:.9f}),"
              f" components {m['components_s']:.4f} s"
              f" ({m['n_components']:,}; {m['components_host_syncs']} syncs),"
              f" bfs {m['bfs_s']:.4f} s ({m['bfs_reached']:,} reached;"
              f" {m['bfs_host_syncs']} syncs), peak"
              f" {m['peak_mem_bytes'] / 2**30:.3f} GiB", flush=True)
    # auto at A: the engine this phase measured faster, for every op
    a = out["A"]
    for op, host_s, dev_s in (
            ("bfs", a["host_bfs_s"], a["bfs_s"]),
            ("components", a["host_components_s"], a["components_s"]),
            ("pagerank", a["host_pagerank20_s"], a["pagerank20_s"]),
            ("shortest_path", a["host_shortest_path_s"],
             a["shortest_path_s"])):
        auto_host = auto_picks_host(op, a["edges"])
        print(f"  graph A {op}: host {host_s:.4f} s, device {dev_s:.4f} s,"
              f" auto -> {'host' if auto_host else 'device'}")
        check(auto_host == (host_s < dev_s),
              f"auto routes {op} at 10M edges to the slower engine")
    out["envelope"] = graph_route_times(*GRAPH_ENVELOPE, seed=11)
    for op, r in out["envelope"].items():
        print(f"  graph {GRAPH_ENVELOPE[0]:,} x {GRAPH_ENVELOPE[1]:,} {op}:"
              f" host {r['host_s'] * 1e3:.3f} ms, device"
              f" {r['device_s'] * 1e3:.3f} ms, auto ->"
              f" {'host' if r['auto_host'] else 'device'}")
    out["phase_s"] = time.perf_counter() - t0
    return out


# phase 18: BASELINE.json configs[4] ("Leiden community detection + Brandes
# betweenness on weighted 10M-edge graph") at phase 17's A, with weights
BC_SOURCES = 64         # graph_centrality's bc_sources (treatments.py:294-297)
BC_CHECK_SOURCES = 4
BC_TOL = 1e-3           # host against device (tests/test_host_graph.py:87-113)
LEIDEN_Q_SLACK = 0.05   # host Q against device Q (test_host_graph.py:145-150)
HOST_LEIDEN_LIMIT_S = 60.0
HOST_LEIDEN_FALLBACK = (100_000, 1_000_000)
CACHE_CHURN = 5_000
CACHE_MORE_INSERTS = 1_000
SELECTOR = "3+0+3"


def weighted_device_edges(n: int, e: int, seed: int):
    """:func:`device_edges`' recipe plus weights uniform in [0.1, 5.0) from
    the same generator."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    src, dst = (torch.randint(0, n, (e,), generator=gen, device="cuda",
                              dtype=torch.int32) for _ in range(2))
    return src, dst, 0.1 + 4.9 * torch.rand(e, generator=gen, device="cuda")


def analytics_auto_host(op: str, n: int, e: int, weighted: bool = False,
                        sources: int = BC_SOURCES) -> bool:
    """Whether ``auto`` sends ``op`` (over the 'both' direction, as ``Graph``
    runs it by default) on a graph of ``n`` nodes and ``e`` edges with host
    mirrors to the host engine: the routing's estimate and ceiling, as
    ``Graph`` passes them."""
    from muninn_tpu_torch.graph import centrality as ctr
    from muninn_tpu_torch.graph import routing

    estimate, ceiling = {
        "betweenness": (ctr.brandes_host_seconds(min(n, sources), 2 * e,
                                                 weighted),
                        routing.HOST_SECONDS_BRANDES),
        "closeness": (ctr.closeness_host_seconds(n, 2 * e, weighted),
                      routing.HOST_SECONDS_CLOSENESS),
        "leiden": (routing.COST_LEIDEN_EDGE * 2 * e,
                   routing.HOST_SECONDS_LEIDEN),
    }[op]
    return routing.use_host("auto", estimate, ceiling)


def analytics_route_times(n: int, e: int, seed: int, reps: int = 3) -> dict:
    """Host engine against device per analytic on an unweighted
    ``from_edges`` graph on the card (as the reference's envelope test
    builds it): 64-source betweenness, closeness and Leiden, and what
    ``auto`` picks."""
    from muninn_tpu_torch.graph import Graph

    src, dst = (t.cpu().numpy() for t in device_edges(n, e, seed))
    g = Graph.from_edges(src, dst)
    ops = {
        "betweenness": lambda b: g.betweenness(sample_sources=BC_SOURCES,
                                               backend=b, as_array=True),
        "closeness": lambda b: g.closeness(backend=b, as_array=True),
        "leiden": lambda b: g.leiden(seed=0, backend=b, as_array=True),
    }
    return {name: {**host_device_s(fn, reps),
                   "auto_host": analytics_auto_host(name, g.num_nodes, e)}
            for name, fn in ops.items()}


def leiden_runs(g, runs: int) -> dict:
    """``runs`` device Leiden runs of ``g`` (seed 0): identical labels and
    Q in every run, Q equal to ``modularity(labels)``; their times, and the
    rounds (modularity evaluations) and sweeps (host reads) of one."""
    from muninn_tpu_torch.graph import community as cmty
    from muninn_tpu_torch.graph import traversal as trv

    rounds = [0]
    modularity = cmty.modularity

    def counted(*a, **k):
        rounds[0] += 1
        return modularity(*a, **k)

    results, times = [], []
    cmty.modularity = counted
    try:
        for _ in range(runs):
            rounds[0] = 0
            trv.reset_host_syncs()
            res, t = timed_s(lambda: g.leiden(seed=0, backend="device",
                                              as_array=True))
            results.append(res)
            times.append(t)
    finally:
        cmty.modularity = modularity
    labels, q = results[0]
    check(all(np.array_equal(lab, labels) and qq == q
              for lab, qq in results[1:]),
          "device Leiden gave other labels or Q for one seed")
    qm = g.modularity(labels)
    check(abs(qm - q) <= 1e-5, f"Leiden's Q {q!r} against modularity {qm!r}")
    return {"labels": labels, "q": q, "times_s": times,
            "median_s": statistics.median(times),
            "communities": int(labels.max()) + 1, "rounds": rounds[0],
            "sweeps": trv.HOST_SYNCS["leiden"]}


def selector_rows_host(hs, hd, n: int, start: int, depth: int) -> list:
    """The rows ``select`` gives for ``"<depth>+<start>+<depth>"``, built
    from the host engine's BFS depths in each direction."""
    from muninn_tpu_torch import native

    best = {start: (0, "self")}
    for direction, (a, b) in (("ancestor", (hd, hs)),
                              ("descendant", (hs, hd))):
        off, _, nbr, _ = native.csr_build(a, b, None, n)
        dep, _ = native.graph_bfs(off, nbr, start, depth)
        for v in np.nonzero(dep < 2**30)[0].tolist():
            if v != start and (v not in best or dep[v] < best[v][0]):
                best[v] = (int(dep[v]), direction)
    rows = [(v, d, how) for v, (d, how) in best.items()]
    rows.sort(key=lambda r: (r[1], str(r[0])))
    return rows


def graph_cache_churn(hs, hd, hw, seed: int) -> dict:
    """GraphCache on the card at A: from_edges and both CSRs; 5,000 inserts
    between existing nodes and 5,000 deletes of existing edges, applied by
    ``incremental_rebuild``, the patched CSRs held against a fresh build
    and a BFS against the host engine; a full rebuild; save, 1,000 more
    inserts, save (only the tail block rewritten), load."""
    import shutil

    from muninn_tpu_torch import GraphCache, native
    from muninn_tpu_torch.graph import Graph

    def both_csrs():
        g = gc.graph()
        g.csr("forward"), g.csr("reverse")
        return g

    m = {}
    gc, m["cache_from_edges_s"] = timed_s(
        lambda: GraphCache.from_edges(hs, hd, hw))
    g, m["cache_csr_build_s"] = timed_s(both_csrs)
    r = np.random.default_rng(seed)
    ids = gc.nodes.ids
    nn, e = len(ids), gc.num_edges

    def inserts(count):
        a, b = r.integers(0, nn, (2, count))
        gc.add_edges([ids[i] for i in a], [ids[i] for i in b],
                     r.uniform(0.1, 5.0, count).astype(np.float32))

    inserts(CACHE_CHURN)
    kill = r.choice(e, CACHE_CHURN, replace=False)
    gc.remove_edges([ids[i] for i in gc._src[kill]],
                    [ids[i] for i in gc._dst[kill]])
    _, m["incremental_rebuild_s"] = timed_s(gc.incremental_rebuild)
    check(gc.graph() is g and g._fwd is not None and g._rev is not None
          and gc.num_edges == e,
          "incremental_rebuild did not patch the CSRs in place")
    fresh = Graph(gc.nodes, gc._src.copy(), gc._dst.copy(), gc._w.copy())
    for d in ("forward", "reverse"):
        a, b = g.csr(d), fresh.csr(d)
        ev = a.e_valid
        check(ev == b.e_valid and torch.equal(a.offsets, b.offsets)
              and all(torch.equal(x[:ev], y[:ev])
                      for x, y in ((a.s(), b.s()), (a.dst, b.dst),
                                   (a.w(), b.w()))),
              f"the patched {d} CSR differs from a fresh build")
    del fresh
    depth, parent = g.bfs(ids[0], backend="device", as_array=True)
    off, _, nbr, _ = native.csr_build(gc._src, gc._dst, None, nn)
    hdepth, hparent = native.graph_bfs(off, nbr, 0, nn)
    check(np.array_equal(depth, hdepth) and np.array_equal(parent, hparent),
          "BFS on the patched CSRs differs from the host engine")

    def full():
        gc.rebuild()
        return both_csrs()

    g, m["full_rebuild_s"] = timed_s(full)
    del g

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    _, m["cache_save_s"] = timed_s(lambda: gc.save(root))
    blocks = sorted(root.glob("block_*.npz"))
    mtimes = {f.name: f.stat().st_mtime_ns for f in blocks}
    inserts(CACHE_MORE_INSERTS)
    _, m["cache_save_incremental_s"] = timed_s(lambda: gc.save(root))
    changed = [f.name for f in sorted(root.glob("block_*.npz"))
               if mtimes.get(f.name) != f.stat().st_mtime_ns]
    m.update(blocks=len(blocks), blocks_rewritten=changed)
    check(changed == [blocks[-1].name],
          f"the incremental save rewrote {changed}, not the tail block")
    back, m["cache_load_s"] = timed_s(lambda: GraphCache.load(root))
    check(back.nodes.ids == ids and all(
        np.array_equal(getattr(back, k), getattr(gc, k))
        for k in ("_src", "_dst", "_w")), "GraphCache.load: edges differ")
    shutil.rmtree(root, ignore_errors=True)
    return m


def graph_analytics_phase() -> dict:
    """Phase 18 (see the module docstring). Returns what the phase's JSON
    line prints."""
    from muninn_tpu_torch import select
    from muninn_tpu_torch import native
    from muninn_tpu_torch.graph import Graph
    from muninn_tpu_torch.graph import centrality as ctr
    from muninn_tpu_torch.graph import routing
    from muninn_tpu_torch.graph import traversal as trv
    from muninn_tpu_torch.graph.core import IdentityNodeTable

    t0 = time.perf_counter()
    # the envelope first: it also makes each device op's first call
    out = {"envelope": analytics_route_times(*GRAPH_ENVELOPE, seed=11)}
    for op, r in out["envelope"].items():
        print(f"  analytics {GRAPH_ENVELOPE[0]:,} x {GRAPH_ENVELOPE[1]:,}"
              f" {op}: host {r['host_s'] * 1e3:.3f} ms, device"
              f" {r['device_s'] * 1e3:.3f} ms, auto ->"
              f" {'host' if r['auto_host'] else 'device'}", flush=True)

    n = GRAPH_SIZES[0][1]
    e = n * GRAPH_DEGREE
    out.update(nodes=n, edges=e)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    src, dst, w = weighted_device_edges(n, e, seed=18)
    g = Graph.from_device_edges(src, dst, num_nodes=n, weights=w)
    del src, dst, w

    # betweenness: 64 weighted sources, then the 4-source check's device half
    out["betweenness_batch"] = ctr.source_batch(BC_SOURCES, 2 * e, n,
                                                torch.device("cuda"))
    trv.reset_host_syncs()
    torch.cuda.reset_peak_memory_stats()
    cb, out["betweenness_s"] = timed_s(lambda: g.betweenness(
        weighted=True, sample_sources=BC_SOURCES, seed=0, backend="device",
        as_array=True))
    out["betweenness_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["betweenness_host_syncs"] = {
        k: trv.HOST_SYNCS[k] for k in ("multi_source", "brandes")}
    check(cb.shape == (n,) and bool(np.isfinite(cb).all())
          and bool((cb >= 0).all()) and cb.max() > 0,
          "betweenness: not finite, negative or all zero")
    out["betweenness_max"] = float(cb.max())
    cb4, out["betweenness4_s"] = timed_s(lambda: g.betweenness(
        weighted=True, sample_sources=BC_CHECK_SOURCES, seed=0,
        backend="device", as_array=True))
    print(f"  betweenness at A ({BC_SOURCES} weighted sources):"
          f" {out['betweenness_s']:.3f} s, batch {out['betweenness_batch']},"
          f" host reads {out['betweenness_host_syncs']}, peak"
          f" {out['betweenness_peak_bytes'] / 2**30:.3f} GiB", flush=True)

    lei = leiden_runs(g, 3)
    labels = lei.pop("labels")
    out["leiden"] = lei
    out["leiden_s"] = lei["median_s"]
    print(f"  leiden at A: {lei['times_s']} s, Q {lei['q']:.6f},"
          f" {lei['communities']:,} communities, {lei['rounds']} rounds,"
          f" {lei['sweeps']} sweeps", flush=True)

    rows, out["select_s"] = timed_s(lambda: select(g, SELECTOR))
    out["select_rows"] = len(rows)
    check(g.device_native, "a device analytic downloaded the host mirrors")

    # the host engine on the same edges, downloaded once
    js, jd, jw = g._dev_coo
    (hs, hd, hw), out["download_s"] = timed_s(lambda: tuple(
        t[:e].cpu().numpy() for t in (js, jd, jw)))
    depth = int(SELECTOR.split("+")[0])
    check(rows == selector_rows_host(hs, hd, n, 0, depth),
          f"select({SELECTOR!r}) differs from the host engine's BFS depths")
    hg = Graph(IdentityNodeTable(n), hs, hd, hw)
    cb4h, out["host_betweenness4_s"] = timed_s(lambda: hg.betweenness(
        weighted=True, sample_sources=BC_CHECK_SOURCES, seed=0,
        backend="host", as_array=True))
    out["betweenness4_max_abs_err"] = float(np.max(np.abs(cb4 - cb4h)))
    check(np.allclose(cb4, cb4h, rtol=BC_TOL, atol=BC_TOL),
          "4-source betweenness: device and host engines differ")
    # the device's dedupe and CSR pair against the host's
    hsd, hdd, hwd = ctr.dedupe_parallel_edges(*hg.host_coo("both"), n)
    pair = ctr._sorted_pair(*ctr.dedupe_parallel_edges_device(
        *g._device_coo("both"), n), n)
    for flip in (0, 1):
        a, b = (hdd, hsd) if flip else (hsd, hdd)
        want = native.csr_build(a, b, hwd, n)
        check(all(np.array_equal(x.cpu().numpy(), y) for x, y in
                  zip(pair[3 * flip:3 * flip + 3],
                      (want[0], want[2], want[3]))),
              "the device's deduplicated CSR differs from the host's")
    out["deduped_edges"] = len(hsd)
    del pair, hsd, hdd, hwd

    # Leiden on the host engine: at A, or where its measured cost puts A
    # above HOST_LEIDEN_LIMIT_S, on a smaller graph of the same recipe
    out["host_leiden_estimate_s"] = routing.COST_LEIDEN_EDGE * 2 * e
    if out["host_leiden_estimate_s"] <= HOST_LEIDEN_LIMIT_S:
        out["host_leiden_at"] = f"{n} x {e}"
        (_, hq), out["host_leiden_s"] = timed_s(
            lambda: hg.leiden(seed=0, backend="host", as_array=True))
        dq = lei["q"]
    else:
        sn, se = HOST_LEIDEN_FALLBACK
        out["host_leiden_at"] = f"{sn} x {se}"
        ss, sd, sw = weighted_device_edges(sn, se, seed=19)
        small = Graph.from_device_edges(ss, sd, num_nodes=sn, weights=sw)
        dq = leiden_runs(small, 1)["q"]
        ss, sd, sw = (t[:se].cpu().numpy() for t in small._dev_coo)
        (_, hq), out["host_leiden_s"] = timed_s(lambda: Graph(
            IdentityNodeTable(sn), ss, sd, sw).leiden(
                seed=0, backend="host", as_array=True))
        del small
    out.update(host_leiden_q=hq, leiden_q_compared=dq)
    check(dq >= hq - LEIDEN_Q_SLACK,
          f"device Leiden's Q {dq:.6f} below the host's {hq:.6f}")
    print(f"  host engine: betweenness ({BC_CHECK_SOURCES} sources)"
          f" {out['host_betweenness4_s']:.3f} s against the device's"
          f" {out['betweenness4_s']:.3f} s (max abs error"
          f" {out['betweenness4_max_abs_err']:.3g}); Leiden at"
          f" {out['host_leiden_at']} {out['host_leiden_s']:.3f} s, Q"
          f" {hq:.6f} against the device's {dq:.6f}", flush=True)

    # auto at A: the engine this phase measured faster
    leiden_host_s = (out["host_leiden_s"] if out["host_leiden_at"]
                     == f"{n} x {e}" else out["host_leiden_estimate_s"])
    for op, host_s, dev_s, kw in (
            ("betweenness", out["host_betweenness4_s"], out["betweenness4_s"],
             dict(weighted=True, sources=BC_CHECK_SOURCES)),
            ("leiden", leiden_host_s, out["leiden_s"], {})):
        auto_host = analytics_auto_host(op, n, e, **kw)
        out[f"auto_{op}"] = "host" if auto_host else "device"
        check(auto_host == (host_s < dev_s),
              f"auto routes {op} at 10M edges to the slower engine")
    del g, hg, labels, cb, cb4, cb4h
    torch.cuda.empty_cache()

    out.update(graph_cache_churn(hs, hd, hw, seed=18))
    print(f"  GraphCache at A: incremental_rebuild of {CACHE_CHURN:,} inserts"
          f" and {CACHE_CHURN:,} deletes {out['incremental_rebuild_s']:.3f} s,"
          f" full rebuild and CSRs {out['full_rebuild_s']:.3f} s; save"
          f" {out['cache_save_s']:.3f} s, after {CACHE_MORE_INSERTS:,}"
          f" inserts {out['cache_save_incremental_s']:.3f} s"
          f" ({out['blocks_rewritten']} of {out['blocks']} blocks), load"
          f" {out['cache_load_s']:.3f} s; select {SELECTOR!r}"
          f" {out['select_s']:.3f} s ({out['select_rows']:,} rows)",
          flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# phase 19: BASELINE.json configs[3] ("Node2Vec: p/q-biased random walks +
# SGNS training on 1M-node graph, embeddings indexed into HNSW"): a planted
# partition of 1M nodes in blocks of 1,000, 10M edges drawn on the card,
# 90% of them inside a block (about 20M both-direction edges, phase 17's A
# in size)
N2V_NODES = 1_000_000
N2V_BLOCK = 1_000
N2V_EDGES = 10_000_000
N2V_INTRA = 0.9
# the trainer at its default widths, p=0.5 and q=2 (walks kept near their
# start: a step back weighs 2, an outward step 0.5); depth cut:
# epochs 5 -> 1, num_walks 10 -> 2; one walker batch a pass
N2V_TRAIN = dict(dim=64, p=0.5, q=2.0, walk_length=80, window=5,
                 neg_samples=5, num_walks=2, epochs=1, seed=0,
                 walk_batch=2**20, sgns_chunk=256, backend="device")
N2V_DEFAULT_BATCH = 4096      # node2vec_train's default walk_batch
N2V_WALK_SAMPLE = 4096        # walks checked edge by edge
N2V_SELF_QUERIES = 2048       # rows searched for themselves in the index
N2V_PROFILE_CHUNKS = 64       # SGNS chunks under the profiler
N2V_LAW_WALKERS = 100_000
N2V_LAW_PQ = ((1.0, 1.0), (0.25, 4.0), (4.0, 0.25))
N2V_CLIQUE_SEEDS = 8
# the node2vec treatment (benchmarks/harness/treatments.py:488-508):
# Erdos-Renyi at mean degree 5, dim 32, 2 walks of 20 a node, 1 epoch,
# walker batches of 1,024; its 2k-node point and the measured crossover
N2V_TREATMENT = dict(dim=32, num_walks=2, walk_length=20, epochs=1,
                     walk_batch=1024, sgns_chunk=256)
N2V_TREATMENT_NODES = 2_000
N2V_CROSSOVER_NODES = 4_000


def planted_edges(n: int, e: int, seed: int, device="cuda"):
    """``e`` edges over ``n`` nodes in blocks of ``N2V_BLOCK``: uniform
    sources, and a destination inside the source's block with probability
    ``N2V_INTRA``, else uniform; drawn from a seeded generator on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def ints(hi):
        return torch.randint(0, hi, (e,), generator=gen, device=device,
                             dtype=torch.int32)

    src = ints(n)
    inside = torch.rand(e, generator=gen, device=device) < N2V_INTRA
    near = src // N2V_BLOCK * N2V_BLOCK + ints(N2V_BLOCK)
    return src, torch.where(inside, near, ints(n))


def profile_ops(fn, top: int = 6) -> dict:
    """Host wall ms of one call, the device's busy ms in one under
    ``torch.profiler`` (idle share = 1 - busy / wall) and the ``top`` ops
    by the device ms of the kernels each launched itself."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    _, wall = timed_s(fn)
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    kind = torch.autograd.DeviceType.CUDA
    busy, last = 0.0, float("-inf")
    for s, t in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.device_type == kind):
        busy += max(0.0, t - max(s, last))
        last = max(last, t)
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])
    busy_ms = busy / 1e3
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            "top_ops_ms": [kv for kv in ops[:top] if kv[1] > 0]}


def n2v_route_times(n: int, reps: int = 3) -> dict:
    """The node2vec treatment at ``n`` nodes on the card: host trainer
    against device route (median of ``reps`` after a warm call each), the
    host estimate and ``auto``'s pick."""
    from muninn_tpu_torch.graph import Graph, routing
    from muninn_tpu_torch.models import node2vec as n2v

    r = np.random.default_rng(n)
    g = Graph.from_edges(r.integers(0, n, 5 * n), r.integers(0, n, 5 * n))
    out = host_device_s(lambda b: n2v.node2vec_train(
        g, seed=1, backend=b, **N2V_TREATMENT), reps)
    tr = N2V_TREATMENT
    est = n2v.host_estimate_s(n, tr["dim"], tr["num_walks"], tr["walk_length"],
                              5, 5, tr["epochs"])
    out.update(nodes=n, host_estimate_s=est,
               auto_host=routing.use_host("auto", est,
                                          routing.HOST_N2V_SECONDS))
    return out


def law_graph(device: str):
    """12 nodes, 30 distinct weighted undirected edges, no self-loops; and
    each node's neighbours with their summed weights."""
    from muninn_tpu_torch.graph import Graph

    r = np.random.default_rng(12)
    pairs = set()
    while len(pairs) < 30:
        a, b = sorted(r.integers(0, 12, 2))
        if a != b:
            pairs.add((int(a), int(b)))
    s, d = map(np.array, zip(*sorted(pairs)))
    w = r.uniform(0.5, 3.0, len(s)).astype(np.float32)
    nbrs = {v: {} for v in range(12)}
    for a, b, wt in zip(s, d, w):
        nbrs[a][b] = nbrs[a].get(b, 0.0) + float(wt)
        nbrs[b][a] = nbrs[b].get(a, 0.0) + float(wt)
    return Graph.from_edges(s, d, w, device=device), nbrs


def law_worst(walks: np.ndarray, nbrs: dict, p: float, q: float) -> float:
    """The largest deviation of a second-hop frequency, grouped by (start,
    first hop), from the closed form of the 4-round truncated rejection
    sampler, as a share of 5 binomial standard deviations + 0.002 (at most
    1 passes): P(c) = pi a (1 - (1 - A)^4) / A + pi (1 - a) (1 - A)^3, pi
    the weight share, a = bias / max_bias, A = sum of pi a."""
    groups = {}
    for s0, f, c in walks:
        groups.setdefault((int(s0), int(f)), []).append(int(c))
    max_bias = max(1 / p, 1.0, 1 / q)
    worst = 0.0
    for (prev, cur), cs in groups.items():
        row = nbrs[cur]
        tot = sum(row.values())
        pi = {c: wt / tot for c, wt in row.items()}
        a = {c: (1 / p if c == prev else 1.0 if c in nbrs[prev] else 1 / q)
             / max_bias for c in row}
        acc = sum(pi[c] * a[c] for c in row)
        counts = np.bincount(cs, minlength=12)
        check(set(np.nonzero(counts)[0]) <= set(row),
              "a walk left the first hop's row")
        for c in row:
            pc = (pi[c] * a[c] * (1 - (1 - acc) ** 4) / acc
                  + pi[c] * (1 - a[c]) * (1 - acc) ** 3)
            tol = 5.0 * np.sqrt(pc * (1 - pc) / len(cs)) + 0.002
            worst = max(worst, abs(counts[c] / len(cs) - pc) / tol)
    return worst


def n2v_card_checks() -> dict:
    """The port's node2vec sub-steps on the card against their closed forms
    and the CPU: the hub's weighted draw, the one-step law, the SGNS update
    (same negatives), the walk tables at 100k nodes, and the two cliques."""
    from muninn_tpu_torch.graph import Graph
    from muninn_tpu_torch.models import node2vec as n2v

    out = {}

    def cuda_gen(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gen

    def tables(g):
        c = g.csr("both")
        return c, *n2v._row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets,
                                       c.max_deg)

    # the hub: at p = q = 1 the next step follows the edge weights
    src = ["h"] * 9 + [f"n{i}" for i in range(1, 10)]
    dst = [f"n{i}" for i in range(1, 10)] + ["h"] * 9
    g = Graph.from_edges(src, dst, np.concatenate(
        [np.arange(1, 10, dtype=np.float32), np.ones(9, np.float32)]))
    c, dst_s, cumw = tables(g)
    hub = g.node_index("h")
    counts = np.zeros(g.num_nodes)
    for rep in range(5):
        walks = n2v.biased_walks(
            cuda_gen(rep), c.offsets, dst_s, cumw,
            torch.full((2048,), hub, dtype=torch.int32, device="cuda"),
            g.num_nodes, 1, 1.0, 1.0, max_deg=c.max_deg)
        counts += np.bincount(walks[:, 1].cpu().numpy(), minlength=g.num_nodes)
    check(counts[hub] == 0, "the hub's walk stayed in place")
    hub_err = max(abs(counts[g.node_index(f"n{i}")] / counts.sum() - i / 45.0)
                  / (0.015 + 0.25 * i / 45.0) for i in range(1, 10))
    check(hub_err <= 1.0, "the hub's weighted draw does not follow its weights")
    out["hub_worst_share_of_tolerance"] = hub_err

    # the one-step law at three (p, q)
    g, nbrs = law_graph("cuda")
    c, dst_s, cumw = tables(g)
    starts = torch.arange(N2V_LAW_WALKERS, device="cuda",
                          dtype=torch.int32) % 12
    out["law_worst_share_of_tolerance"] = {}
    for p, q in N2V_LAW_PQ:
        walks = n2v.biased_walks(cuda_gen(7), c.offsets, dst_s, cumw, starts,
                                 12, 2, p, q, max_deg=c.max_deg).cpu().numpy()
        worst = law_worst(walks, nbrs, p, q)
        check(worst <= 1.0, f"the walk's one-step law fails at p={p}, q={q}")
        out["law_worst_share_of_tolerance"][f"p={p},q={q}"] = worst

    # one SGNS chunk at the main path's shape, the same negatives on both
    r = np.random.default_rng(3)
    v, dim = 20_000, N2V_TRAIN["dim"]
    syn0 = torch.from_numpy(r.normal(0, 0.3, (v, dim)).astype(np.float32))
    syn1 = torch.from_numpy(r.normal(0, 0.3, (v, dim)).astype(np.float32))
    walks = torch.from_numpy(r.integers(0, v, (N2V_TRAIN["sgns_chunk"],
                                               N2V_TRAIN["walk_length"] + 1),
                                        dtype=np.int64).astype(np.int32))
    pc = n2v._pair_count(*walks.shape, N2V_TRAIN["window"])
    negs = torch.from_numpy(r.integers(0, v, (pc, N2V_TRAIN["neg_samples"])))
    cpu = n2v._sgns_apply(syn0.clone(), syn1.clone(), walks, negs, 0.025,
                          N2V_TRAIN["window"])
    gpu = n2v._sgns_apply(syn0.cuda(), syn1.cuda(), walks.cuda(), negs.cuda(),
                          0.025, N2V_TRAIN["window"])
    out["sgns_max_abs_err"] = max(float((a.cpu() - b).abs().max())
                                  for a, b in zip(gpu, cpu))
    check(out["sgns_max_abs_err"] <= TOL,
          f"the SGNS update on the card differs from the CPU's by"
          f" {out['sgns_max_abs_err']:.3g}")

    # the walk tables of a weighted 100k-node graph, on the card and the CPU
    s, d = planted_edges(100_000, 1_000_000, seed=23)
    w = torch.rand(s.shape[0], generator=cuda_gen(24), device="cuda") + 0.1
    got = tables(Graph.from_device_edges(s, d, num_nodes=100_000, weights=w))
    want = tables(Graph.from_device_edges(s.cpu(), d.cpu(), num_nodes=100_000,
                                          weights=w.cpu()))
    check(torch.equal(got[1].cpu(), want[1]),
          "the walk tables' row order differs between the card and the CPU")
    out["cumw_max_rel_err"] = float(((got[2].cpu() - want[2]).abs()
                                     / want[2].abs().clamp(min=1e-30)).max())
    check(out["cumw_max_rel_err"] <= 1e-6,
          f"the walk tables' prefix sums differ by {out['cumw_max_rel_err']:.3g}")

    # the two cliques: the host route at JAX's test seed, the device route
    # on average over seeds (its count-normalised step separates them by
    # about 0.12, with a wide spread from seed to seed)
    ends = [(f"v{b + i}", f"v{b + j}") for b in (0, 8) for i in range(8)
            for j in range(i + 1, 8)] + [("v0", "v8")]
    g = Graph.from_edges(*zip(*ends))
    kw = dict(dim=16, num_walks=6, walk_length=12, window=4, neg_samples=4,
              epochs=4, walk_batch=64, sgns_chunk=64)

    def separation(ids, emb):
        idx = {node: i for i, node in enumerate(ids)}
        a = [idx[f"v{i}"] for i in range(8)]
        b = [idx[f"v{i}"] for i in range(8, 16)]
        sims = emb @ emb.T
        return float((sims[np.ix_(a, a)].mean() + sims[np.ix_(b, b)].mean())
                     / 2 - sims[np.ix_(a, b)].mean())

    out["cliques_host"] = separation(*n2v.node2vec_train(g, seed=2, **kw))
    out["cliques_device"] = [separation(*n2v.node2vec_train(
        g, seed=seed, backend="device", **kw))
        for seed in range(N2V_CLIQUE_SEEDS)]
    check(out["cliques_host"] > 0.1
          and statistics.mean(out["cliques_device"]) > 0.1,
          f"the two cliques are not separated: {out['cliques_host']},"
          f" {out['cliques_device']}")
    return out


def beam_step_vs_plain(what: str, qc, entries, vectors, scales, neighbors0,
                       packed, pscales, metric, ef: int, expand: int) -> dict:
    """``beam_step`` against ``beam_step_plain`` over every step of one beam
    of the queries ``qc`` from the routed ``entries``, set up as
    ``_beam_search_level0`` sets it up (the entries scored from rows of
    ``vectors``, dequantized by ``scales`` for int8 guidance; its default
    patience, and ``HnswIndex``'s default step limit, ceil(ef / E) + 1):
    after each step the kernel's beam distances,
    slots, flags and stall and its go-on flag bit for bit equal to plain's;
    then each timed over the whole beam, in ms a step, beside the bound (the
    live picks' ids, the kept rows with their ``pscales``, the queries and
    their norms, and the state in and out). Returns the figures the
    kernels' record carries."""
    from muninn_tpu_torch.ops.beam_step import (beam_step_cuda, beam_step_plain,
                                                fetch_rows, go_on)
    from muninn_tpu_torch.ops.distance import gathered_distances, squared_norms
    from muninn_tpu_torch.ops.topk import smallest_k

    b, d = qc.shape
    r0 = neighbors0.shape[1]
    e = min(expand, ef)
    patience = max(ef // 4, 10)
    max_iters = -(-ef // e) + 1
    qc = qc.float().contiguous()
    q2 = squared_norms(qc)[:, None]
    ent = entries if entries.ndim == 2 else entries[:, None]
    e_d = gathered_distances(qc, fetch_rows(vectors, scales, ent.clamp(min=0).long()),
                             metric)
    init = (torch.full((b, ef), float("inf"), device=qc.device),
            torch.full((b, ef), -1, dtype=torch.int32, device=qc.device),
            torch.zeros((b, ef), dtype=torch.bool, device=qc.device),
            torch.zeros(b, dtype=torch.int64, device=qc.device))
    init[0][:, : ent.shape[1]] = torch.where(ent >= 0, e_d, float("inf"))
    init[1][:, : ent.shape[1]] = ent

    def work(st):
        """The live picks and the kept candidates of a step from state st."""
        bd, bi, bx, stl = st
        pick_d, pick = smallest_k(torch.where(bx | (bi < 0), float("inf"), bd), e)
        valid = pick_d < float("inf")
        do = valid & (valid.any(1) & (stl < patience))[:, None]
        ids = neighbors0[torch.gather(bi, 1, pick).clamp(min=0).long()].reshape(b, -1)
        ids = torch.where(do.repeat_interleave(r0, dim=1), ids, -1)
        ids = torch.where((ids[:, :, None] == bi[:, None, :]).any(dim=2), -1, ids)
        srt = torch.sort(ids, dim=1).values
        prev = torch.nn.functional.pad(srt[:, :-1], (1, 0), value=-1)
        return int(do.sum()), int(((srt >= 0) & (srt != prev)).sum())

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    plain, kern = init, tuple(t.clone() for t in init)
    flag = torch.zeros(1, dtype=torch.int32, device=qc.device)
    picks = kept = steps = 0
    while steps < max_iters and bool(go_on(plain[1], plain[2], plain[3], patience)):
        lp, kp = work(plain)
        picks, kept, steps = picks + lp, kept + kp, steps + 1
        plain = beam_step_plain(qc, q2, *plain, neighbors0, metric, e, patience,
                                packed=packed, pscales=pscales)
        flag.zero_()
        kern = beam_step_cuda(qc, q2, *kern, neighbors0, packed, metric, e,
                              patience, pscales=pscales, flag=flag)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(p)) for a, p in zip(kern, plain))
              and int(flag) == int(go_on(plain[1], plain[2], plain[3], patience)),
              f"{what}: beam_step differs from plain at step {steps - 1}")
    check(steps > 0, f"{what}: the beam took no step")

    def kernel_beam():
        st = tuple(t.clone() for t in init)
        for _ in range(steps):
            beam_step_cuda(qc, q2, *st, neighbors0, packed, metric, e, patience,
                           pscales=pscales)

    def plain_beam():
        st = init
        for _ in range(steps):
            st = beam_step_plain(qc, q2, *st, neighbors0, metric, e, patience,
                                 packed=packed, pscales=pscales)

    out = {"shape": [b, ef, e, r0, d, str(packed.dtype).removeprefix("torch.")],
           "steps": steps, "live_picks_per_step": picks / steps,
           "kept_per_step": kept / steps}
    out["ms"] = device_ms(kernel_beam, reps=20) / steps
    out["plain_ms"] = device_ms(plain_beam, reps=5) / steps
    state = b * (ef * (4 + 4 + 1) + 8)
    row = d * packed.element_size() + (0 if pscales is None else 4)
    nbytes = (picks * r0 * 4 + kept * row
              + steps * (qc.numel() * 4 + b * 4 + 2 * state))
    # a multiply-add for the dot and one for the squared norm
    bound_ms, out["bound_by"] = bound(4.0 * kept * d, "fp32", nbytes)
    out["bound_ms"] = bound_ms / steps
    print(f"  beam_step, {what}: [{b}, ef {ef}, E {e}] x [{r0}, {d}]"
          f" {out['shape'][-1]}, {steps} steps, bit-equal to plain after each:"
          f" kernel {out['ms']:.4f} ms a step, plain {out['plain_ms']:.4f} ms;"
          f" bound {out['bound_ms']:.4f} ms ({out['bound_by']};"
          f" {out['live_picks_per_step']:.0f} live picks and"
          f" {out['kept_per_step']:.0f} kept rows a step)", flush=True)
    return out


def node2vec_phase() -> dict:
    """Phase 19 (see the module docstring). Returns what the phase's JSON
    line prints."""
    from muninn_tpu_torch import FlatIndex, HnswIndex
    from muninn_tpu_torch.graph import Graph
    from muninn_tpu_torch.index.hnsw import _route
    from muninn_tpu_torch.models import node2vec as n2v
    from muninn_tpu_torch.ops import _build
    from muninn_tpu_torch.ops.distance import unit_rows as unit_t
    from muninn_tpu_torch.ops.flat_topk import (flat_topk, flat_topk_cuda,
                                                flat_topk_plain)

    t_phase = time.perf_counter()
    out = {"routing": {
        "treatment": n2v_route_times(N2V_TREATMENT_NODES),
        "crossover": n2v_route_times(N2V_CROSSOVER_NODES)}}
    for what, r in out["routing"].items():
        print(f"  node2vec treatment at {r['nodes']:,} nodes ({what}): host"
              f" {r['host_s'] * 1e3:.1f} ms, device {r['device_s'] * 1e3:.1f}"
              f" ms, host estimate {r['host_estimate_s'] * 1e3:.1f} ms, auto"
              f" -> {'host' if r['auto_host'] else 'device'}", flush=True)
    out["card_checks"] = n2v_card_checks()
    print(f"  node2vec on the card: {out['card_checks']}", flush=True)

    n, e = N2V_NODES, N2V_EDGES
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    src, dst = planted_edges(n, e, seed=19)
    g = Graph.from_device_edges(src, dst, num_nodes=n)
    del src, dst
    index = HnswIndex(N2V_TRAIN["dim"], "cosine")

    # every stage of the entry point timed by wrappers that synchronise
    spans, kept = {}, {}
    saved = {name: getattr(n2v, name) for name in
             ("_row_sorted_cumw", "biased_walks", "sgns_walk_batch", "_finish")}
    saved_insert = index.insert

    def fenced(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            spans.setdefault(name, []).append((t0, time.perf_counter()))
            kept.setdefault(name, res)  # the first call's result
            return res
        return call

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    try:
        for name, fn in saved.items():
            setattr(n2v, name, fenced(name, fn))
        index.insert = fenced("insert", saved_insert)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node_ids, emb = n2v.node2vec_train(g, output_index=index, **N2V_TRAIN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        for name, fn in saved.items():
            setattr(n2v, name, fn)
        index.insert = saved_insert
    launches = dict(_build.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base

    def dur(name):
        return [b - a for a, b in spans[name]]

    insert_s = dur("insert")[0]
    passes = N2V_TRAIN["num_walks"] * N2V_TRAIN["epochs"]
    wl = N2V_TRAIN["walk_length"]
    pairs = (n2v._pow2_at_least(n) * n2v._pair_count(1, wl + 1,
                                                     N2V_TRAIN["window"]))
    out.update(
        nodes=n, edges=e, train_s=t1 - t0 - insert_s,
        nodes_per_s=n / (t1 - t0 - insert_s), total_s=t1 - t0,
        prep_s=spans["biased_walks"][0][0] - t0,
        cumw_s=dur("_row_sorted_cumw")[0],
        walks_s=dur("biased_walks"), sgns_s=dur("sgns_walk_batch"),
        download_s=spans["_finish"][0][0] - spans["sgns_walk_batch"][-1][1],
        normalise_s=dur("_finish")[0] - insert_s, insert_s=insert_s,
        launches=launches)
    check(len(out["walks_s"]) == passes and len(out["sgns_s"]) == passes,
          f"{len(out['walks_s'])} walk batches for {passes} passes")
    out["walk_ms_per_step"] = [s * 1e3 / wl for s in out["walks_s"]]
    out["sgns_pairs_per_s"] = [pairs / s for s in out["sgns_s"]]
    print(f"  node2vec at {n:,} nodes x {e:,} edges: train"
          f" {out['train_s']:.3f} s ({out['nodes_per_s']:.0f} nodes/s): prep"
          f" {out['prep_s']:.3f} s (walk tables {out['cumw_s']:.3f}), walks"
          f" {[round(s, 3) for s in out['walks_s']]} s, SGNS"
          f" {[round(s, 3) for s in out['sgns_s']]} s, download"
          f" {out['download_s']:.3f} s, normalise {out['normalise_s']:.3f} s;"
          f" HNSW insert {insert_s:.3f} s; peak"
          f" {out['peak_bytes'] / 2**30:.3f} GiB; launches {launches}",
          flush=True)
    n_sweep = -(-n // 8192)
    check(launches["flat_topk_mma"] >= n_sweep,
          f"the HNSW build launched the bf16 kernel {launches['flat_topk_mma']}"
          f" times for {n_sweep} sweep chunks")

    # the walks: every step an edge of the 'both' CSR, or a dead end's repeat
    c = g.csr("both")
    ev = c.e_valid
    keys = torch.sort(c.s()[:ev].long() * n + c.dst[:ev].long()).values
    r = np.random.default_rng(19)
    gen_ctl = torch.Generator(device="cuda")
    gen_ctl.manual_seed(19)
    rows = torch.from_numpy(r.choice(n, N2V_WALK_SAMPLE, replace=False)).cuda()
    wk = kept["biased_walks"][rows].long()
    a, b = wk[:, :-1], wk[:, 1:]
    key = a * n + b
    pos = torch.searchsorted(keys, key).clamp(max=ev - 1)
    deg = c.degrees().long()
    ok = (keys[pos] == key) | ((a == b) & (deg[a] == 0))
    check(bool(ok.all()), f"{int((~ok).sum())} walk steps are not edges")

    # the embeddings and the output index: every row under its id
    norms = np.linalg.norm(emb, axis=1)
    check(emb.shape == (n, N2V_TRAIN["dim"]) and bool(np.isfinite(emb).all())
          and float(np.abs(norms - 1).max()) <= TOL,
          "embeddings not finite unit rows")
    check(node_ids == list(range(n)) and len(index) == n,
          f"the index holds {len(index)} rows")
    qrows = np.sort(r.choice(n, N2V_SELF_QUERIES, replace=False))
    slots = torch.from_numpy(index.store.slots_of(qrows + 1).astype(np.int64))
    check(np.array_equal(index.store.vectors[slots.cuda()].cpu().numpy(),
                         emb[qrows]), "an index row differs from its embedding")
    # the reference's count-normalised step at this depth leaves every
    # embedding near one direction (ROADMAP section 3): the norm of the mean
    # row, and the output index's self-retrieval, reported
    out["mean_row_norm"] = float(np.linalg.norm(emb.mean(0, dtype=np.float64)))
    _build.reset_launches()
    hids, _ = index.search(emb[qrows], k=10)
    torch.cuda.synchronize()
    out["search_launches"] = dict(_build.LAUNCHES)
    check(out["search_launches"]["beam_step"] > 0 and bool((hids > 0).all()),
          f"the index's search launched {out['search_launches']} or came"
          " back short")
    out["self_recall_output_index"] = float((hids[:, 0] == qrows + 1).mean())
    # the block purity of each sampled row's exact top 10 (itself left out)
    exact = FlatIndex(N2V_TRAIN["dim"], "cosine", capacity=n)
    exact.insert(np.arange(1, n + 1), emb)
    fids, _ = exact.search(emb[qrows], k=11)
    del exact
    check(bool((fids[:, 0] == qrows + 1).all()),
          "an exact search does not find a row's own embedding first")
    nb = fids[:, 1:]
    out["block_purity_top10"] = float(
        ((nb - 1) // N2V_BLOCK == (qrows[:, None] // N2V_BLOCK)).mean())
    out["block_purity_chance"] = (N2V_BLOCK - 1) / (n - 1)
    # the control: the same index at the same width and size over random
    # unit rows, where nothing is collapsed, holds the self-retrieval floor
    ctl_rows = unit_t(torch.randn((n, N2V_TRAIN["dim"]), generator=gen_ctl,
                                  device="cuda")).cpu().numpy()
    ctl = HnswIndex(N2V_TRAIN["dim"], "cosine")
    ctl.insert(np.arange(1, n + 1), ctl_rows)
    cids, _ = ctl.search(ctl_rows[qrows], k=10)
    del ctl, ctl_rows
    out["self_recall_control"] = float((cids[:, 0] == qrows + 1).mean())
    check(out["self_recall_control"] >= MIN_HNSW_RECALL,
          f"self-retrieval over random rows {out['self_recall_control']}"
          f" < {MIN_HNSW_RECALL}")
    print(f"  {N2V_WALK_SAMPLE} walks edge by edge: ok; unit rows, norm of"
          f" the mean row {out['mean_row_norm']:.5f}; index of {len(index):,},"
          f" every sampled row under its id; self-retrieval"
          f" {out['self_recall_output_index']} (search launches"
          f" {out['search_launches']}), {out['self_recall_control']} over"
          f" random unit rows; exact top-10 block purity"
          f" {out['block_purity_top10']:.5f} (chance"
          f" {out['block_purity_chance']:.5f})", flush=True)

    # one walk batch and 64 SGNS chunks under the profiler; one batch of
    # the default walk_batch timed
    off, dst_s, cumw = c.offsets, *kept["_row_sorted_cumw"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tr = N2V_TRAIN

    def walk(starts):
        return n2v.biased_walks(gen, off, dst_s, cumw, starts, n,
                                tr["walk_length"], tr["p"], tr["q"],
                                max_deg=c.max_deg)

    big = torch.arange(tr["walk_batch"], device="cuda", dtype=torch.int32) % n
    out["profile_walk_batch"] = profile_ops(lambda: walk(big))
    neg_table = torch.as_tensor(n2v.build_negative_table(
        deg.cpu().numpy()), device="cuda")
    syn0 = (torch.rand((n, tr["dim"]), generator=gen, device="cuda") - 0.5) / tr["dim"]
    syn1 = torch.zeros_like(syn0)
    walks = kept["biased_walks"][:N2V_PROFILE_CHUNKS * tr["sgns_chunk"]]

    def sgns(wk):
        n2v.sgns_walk_batch(syn0, syn1, wk, neg_table, gen, 0.025,
                            tr["window"], tr["neg_samples"],
                            min(tr["sgns_chunk"], wk.shape[0]))

    out["profile_sgns_64_chunks"] = profile_ops(lambda: sgns(walks))
    small = big[:N2V_DEFAULT_BATCH]
    small_walks, out["default_batch_walks_s"] = timed_s(lambda: walk(small))
    _, out["default_batch_sgns_s"] = timed_s(lambda: sgns(small_walks))
    print(f"  profiled: walk batch of {tr['walk_batch']:,}"
          f" {out['profile_walk_batch']}; {N2V_PROFILE_CHUNKS} SGNS chunks"
          f" {out['profile_sgns_64_chunks']}; one default batch of"
          f" {N2V_DEFAULT_BATCH}: walks {out['default_batch_walks_s']:.4f} s,"
          f" SGNS {out['default_batch_sgns_s']:.4f} s", flush=True)
    del syn0, syn1, walks, kept, keys, wk, key, pos, ok

    # the two kernels at the output index's call shapes (d = 64)
    corpus = index.store.vectors[:n]
    valid = index.store.valid[:n]
    qb = corpus[:8192]  # the bulk build's first sweep call
    kb = index.m0 + 1
    kd, ki = flat_topk_cuda(qb, corpus, kb, metric="cosine", corpus_valid=valid,
                            precision="default")
    torch.cuda.synchronize()
    pd, pi = flat_topk_plain(qb, corpus, kb, metric="cosine",
                             corpus_valid=valid, precision="default")
    out["flat_max_abs_err"] = compare(kd, ki, pd, pi, qb, corpus, valid,
                                      "cosine", ref=dist64_bf16)
    inv = 1.0 / torch.clamp(torch.linalg.norm(corpus, dim=1), min=1e-30)
    c16 = corpus.bfloat16()

    def library(qs):
        """The bf16 yardstick of phase 9 (bf16 matmul with f32 output, x
        1/|c|, ``torch.topk``), by chunks of 2,048 queries: one [8,192, 1M]
        f32 block would not fit beside the index."""
        res = []
        for s0 in range(0, qs.shape[0], 2048):
            sims = torch.mm(unit_t(qs[s0:s0 + 2048]).bfloat16(), c16.T,
                            out_dtype=torch.float32) * inv[None, :]
            res.append(torch.topk(torch.where(valid, sims, -torch.inf), kb,
                                  dim=1))
        return res

    lib_d = library(qb[:2048])[0].values
    check(bool(torch.isclose(1.0 - lib_d[:, 0], kd[:2048, 0], rtol=TOL,
                             atol=TOL).all()),
          "the bf16 yardstick's top-1 distances differ from the kernel's")
    out["flat_ms"] = device_ms(lambda: flat_topk_cuda(
        qb, corpus, kb, metric="cosine", corpus_valid=valid,
        precision="default"), reps=5)
    out["flat_plain_ms"] = device_ms(lambda: flat_topk_plain(
        qb, corpus, kb, metric="cosine", corpus_valid=valid,
        precision="default"), reps=3)
    out["flat_library_ms"] = device_ms(lambda: library(qb), reps=3)
    d64 = corpus.shape[1]
    out["flat_bound_ms"], out["flat_bound_by"] = bound(
        2.0 * qb.shape[0] * n * d64, "bf16",
        4.0 * (n + qb.shape[0]) * d64 + n + 8.0 * qb.shape[0] * kb)
    del kd, ki, pd, pi, lib_d, c16, inv
    torch.cuda.empty_cache()

    qc = torch.from_numpy(emb[qrows]).cuda()
    pool = index._routing_pool()
    sel = _route(qc, pool, index._pool_vecs(pool), index.metric,
                 index.route_entries)
    packed = index._maybe_packed()
    check(packed is not None and packed.shape[1:] == (index.m0, d64)
          and packed.dtype == torch.bfloat16,
          "the output index's packed table was not built")
    print(f"  flat_topk at the HNSW bulk build's call, [8192, {d64}] x"
          f" [{n}, {d64}] bf16, k={kb}: kernel {out['flat_ms']:.3f} ms, plain"
          f" {out['flat_plain_ms']:.3f} ms, library {out['flat_library_ms']:.3f}"
          f" ms; bound {out['flat_bound_ms']:.4f} ms ({out['flat_bound_by']});"
          f" max |d| error {out['flat_max_abs_err']:.3g}", flush=True)
    # the beam of the index's search above: ef_search's default, 2 * k
    out["beam_step"] = beam_step_vs_plain(
        "the Node2Vec output index's search", qc, sel, index._vecs16(), None,
        index.neighbors0, packed, None, index.metric, 2 * 10, index.expand)
    del index, g, emb, qc, sel, packed, corpus, valid
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def delete_repair_phase(x: np.ndarray, seed: int = 20) -> dict:
    """Phase 20 (see the module docstring): ``delete_repair`` at the churn
    cell's shape on ``x`` (phase 4's rows). Returns what the phase's JSON
    line prints."""
    from muninn_tpu_torch import HnswIndex
    from muninn_tpu_torch.index import hnsw as hnsw_mod
    from muninn_tpu_torch.ops import _build
    from muninn_tpu_torch.ops.delete_repair import delete_repair_cuda
    from muninn_tpu_torch.ops.distance import exact_f32_dots

    n, d = x.shape
    index = HnswIndex(d, "l2", m=16, ef_construction=200, capacity=137_216, seed=seed,
                      device="cuda")
    index.insert(np.arange(n), x)
    kk = index.m0 + 1
    ids = np.random.default_rng(seed).choice(n, 2048, replace=False)
    slots = torch.as_tensor(index.store.slots_of(ids), device="cuda")
    index.store.valid[slots] = False
    dead = torch.zeros(index.neighbors0.shape[0], dtype=torch.bool, device="cuda")
    dead[slots] = True
    _, aff, pool, counts = hnsw_mod._delete_lists(index.neighbors0, slots, dead,
                                                  index.m0)
    n_aff, n_pool = counts.tolist()
    vec = index.store.vectors[: index.store.high_watermark]
    nb0, nd0 = index.neighbors0.clone(), index.dists0.clone()

    def restore():
        index.neighbors0.copy_(nb0)
        index.dists0.copy_(nd0)

    def timed(fn, reps=3) -> tuple[list[float], list[float]]:
        """Device and wall ms of ``fn`` after ``restore``, ``reps`` times."""
        dev_ms, wall_ms = [], []
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        return dev_ms, wall_ms

    def kernel():
        delete_repair_cuda(vec, aff, pool, counts, dead, index.neighbors0,
                           index.dists0, kk, "l2", keep_if_empty=False)

    real_engine = hnsw_mod.repair_engine

    def eager():
        hnsw_mod.repair_engine = lambda *a: "eager"
        try:
            index._repair(aff, pool, counts, dead)
        finally:
            hnsw_mod.repair_engine = real_engine

    _build.reset_launches()
    kernel()
    check(_build.LAUNCHES["delete_repair"] == 1, f"the repair launched {_build.LAUNCHES}")
    k_nb, k_nd = index.neighbors0.clone(), index.dists0.clone()
    restore()
    eager()
    torch.cuda.synchronize()
    equal = bool(torch.equal(k_nb, index.neighbors0) and torch.equal(k_nd, index.dists0))
    check(equal, "delete_repair's graph differs from the eager repair's")
    changed = int((k_nb != nb0).any(dim=1).sum())
    ms, wall = timed(kernel)
    plain_ms, plain_wall = timed(eager)
    restore()
    q = vec[aff[:n_aff]]
    pv = vec[pool[:n_pool]]

    def library():
        for lo in range(0, n_aff, 8192):
            torch.topk(exact_f32_dots(q[lo : lo + 8192], pv), kk, dim=1, largest=False)

    library_ms = device_ms(library, reps=3)
    bound_ms, bound_by = bound(2.0 * n_aff * n_pool * d, "fp32",
                               4.0 * (n_aff + n_pool) * d + 8.0 * n_aff * index.m0)
    out = {"shape": {"affected": n_aff, "pool": n_pool, "d": d, "kk": kk},
           "rows_changed": changed, "bit_equal": equal,
           "ms": statistics.median(ms), "wall_ms": statistics.median(wall),
           "plain_ms": statistics.median(plain_ms),
           "plain_wall_ms": statistics.median(plain_wall),
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / statistics.median(ms),
           "launches_per_wave": 1}
    print(f"{card_line()}: delete_repair, {n_aff} affected rows x a pool of {n_pool},"
          f" d={d}, kk={kk}: kernel {out['ms']:.3f} ms (wall {out['wall_ms']:.3f}),"
          f" eager {out['plain_ms']:.3f} ms (wall {out['plain_wall_ms']:.3f}), library"
          f" {library_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}); bit for bit"
          f" the eager graph ({changed} rows changed)", flush=True)
    del index, nb0, nd0, k_nb, k_nd, q, pv
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from muninn_tpu_torch import FlatIndex, HnswIndex, QuantizedFlatIndex
    from muninn_tpu_torch import native
    from muninn_tpu_torch.index import hnsw as hnsw_mod
    from muninn_tpu_torch.index.hnsw import _route
    from muninn_tpu_torch.ops import _build, beam
    from muninn_tpu_torch.ops import beam_loop as beam_loop_mod
    from muninn_tpu_torch.ops import beam_step as beam_step_mod
    from muninn_tpu_torch.ops import delete_repair as delete_repair_mod
    from muninn_tpu_torch.ops import flat_topk as flat_topk_mod
    from muninn_tpu_torch.ops import gather as gather_mod
    from muninn_tpu_torch.ops.beam import (
        BIG,
        gather_block_dots_cuda,
        gather_block_dots_plain,
        gather_block_topm_cuda,
        gather_block_topm_plain,
    )
    from muninn_tpu_torch.ops.beam_loop import beam_loop_cuda, beam_loop_plain
    from muninn_tpu_torch.ops.distance import (
        exact_f32_dots,
        gathered_distances,
        quantize_rows_int8,
        unit_rows as unit_t,
    )
    from muninn_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_cuda,
        gather_rows_plain,
    )
    from muninn_tpu_torch.ops.flat_topk import (
        flat_topk,
        flat_topk_cuda,
        flat_topk_int8,
        flat_topk_int8_cuda,
        flat_topk_int8_plain,
        flat_topk_plain,
    )

    def f32_library(q, c, valid, k):
        """The library call of ``precision="highest"``: one f32 matmul of the
        unit rows (TF32 off) and one ``torch.topk``, masked rows excluded."""
        sims = exact_f32_dots(unit_t(q), unit_t(c))
        return torch.topk(torch.where(valid, sims, -torch.inf), k, dim=1)

    def bf16_library(q, c, valid, k):
        """The library call of the bf16-operand mode: one bf16 tensor-core
        matmul of the unit query and the raw rows, summed and returned in f32
        (``out_dtype``), 1/|c| folded in after, and one ``torch.topk``."""
        inv = 1.0 / torch.clamp(torch.linalg.norm(c, dim=1), min=1e-30)
        sims = torch.mm(unit_t(q).bfloat16(), c.bfloat16().T,
                        out_dtype=torch.float32) * inv[None, :]
        return torch.topk(torch.where(valid, sims, -torch.inf), k, dim=1)

    # 1. the card
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build; the graph phase's host library (g++) alongside
    native_build = threading.Thread(target=native.graph_available)
    native_build.start()
    t0 = time.perf_counter()
    sources = ["flat_topk", "flat_topk_mma", "beam_dots", "beam_loop",
               "beam_step", "gather_rows", "delete_repair"]
    _build.load_all(sources)  # one nvcc each, in parallel
    for mod in (flat_topk_mod, beam, beam_loop_mod, beam_step_mod, gather_mod,
                delete_repair_mod):
        mod._library()
    flat_topk_mod._mma_library()
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("Used", "spill", "wgmma", "arning")):
                print(f"  ptxas {name}:", line.strip())
    # the tensor-core kernel's dynamic shared memory (ptxas counts only the
    # static part) at the main paths' plans
    for what, k_, d_, op in (("bf16 flat search", 10, 384, flat_topk_mod._OP_BF16),
                             ("bf16 HNSW build sweep", 33, 384, flat_topk_mod._OP_BF16),
                             ("int8_rescored", 16, 768, flat_topk_mod._OP_INT8),
                             ("k=1024", 1024, 100, flat_topk_mod._OP_INT8)):
        plan = flat_topk_mod.mma_plan(k_, d_, op)
        print(f"  flat_topk_mma plan {what} (k={k_}, d={d_}): (tq, w, stages,"
              f" resident query chunks) {plan}, {flat_topk_mod.mma_smem_bytes(*plan)}"
              " bytes of dynamic shared memory")
    mma_so = _build.build(["flat_topk_mma"])["flat_topk_mma"]  # built above
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(mma_so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    n_hgmma, n_igmma = sass.count("HGMMA"), sass.count("IGMMA")
    print(f"  flat_topk_mma SASS: {n_hgmma} HGMMA (bf16), {n_igmma} IGMMA (s8)")
    check(n_hgmma > 0 and n_igmma > 0,
          "the tensor-core kernel's SASS lacks HGMMA or IGMMA")
    # highest stays exact f32 on CUDA cores: fmaf, no tensor-core instruction
    plan = flat_topk_mod.f32_plan(10, 8192)
    print(f"  flat_topk plan at k=10, B=8,192: (tq, w, stages) {plan},"
          f" {flat_topk_mod.f32_smem_bytes(*plan)} bytes of dynamic shared memory")
    f32_log = _build.BUILD_LOGS.get("flat_topk")
    if f32_log is None:
        print("  flat_topk: library built by an earlier run, no ptxas log to read")
    else:
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", f32_log)]
        check(bool(spills) and not any(spills), "ptxas spilled in flat_topk")
    f32_so = _build.build(["flat_topk"])["flat_topk"]
    sass = subprocess.run([str(cuobjdump), "-sass", str(f32_so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    n_ffma, n_mma = sass.count("FFMA"), sass.count("HMMA") + sass.count("HGMMA")
    print(f"  flat_topk SASS: {n_ffma} FFMA, {n_mma} HMMA/HGMMA")
    check(n_ffma > 0 and n_mma == 0, "the f32 kernel's SASS is not FFMA alone")
    # the delete's repair likewise: exact f32, and no spill
    rep_log = _build.BUILD_LOGS.get("delete_repair")
    if rep_log is not None:
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", rep_log)]
        check(bool(spills) and not any(spills), "ptxas spilled in delete_repair")
    rep_so = _build.build(["delete_repair"])["delete_repair"]
    sass = subprocess.run([str(cuobjdump), "-sass", str(rep_so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    n_ffma, n_mma = sass.count("FFMA"), sass.count("HMMA") + sass.count("HGMMA")
    print(f"  delete_repair SASS: {n_ffma} FFMA, {n_mma} HMMA/HGMMA; plan at kk=33"
          f" {delete_repair_mod.repair_plan(33)}")
    check(n_ffma > 0 and n_mma == 0, "the repair kernel's SASS is not FFMA alone")
    sys.stdout.flush()

    # 3. the f32 kernel vs plain on the card
    rng = np.random.default_rng(1)
    max_err = 0.0
    n_cases = 0
    for case, (metric, d, k, masked) in enumerate(itertools.product(
            METRICS, (37, 100, 384, 768), MMA_KS, (False, True))):
        b, n = mma_shape(case, k, F32_BS)
        qt = torch.from_numpy(unit_rows(
            rng.standard_normal((b, d), dtype=np.float32))).cuda()
        ct = torch.from_numpy(unit_rows(
            rng.standard_normal((n, d), dtype=np.float32))).cuda()
        vt = torch.from_numpy(rng.random(n) >= 0.3).cuda() if masked else None
        kd, kid = flat_topk_cuda(qt, ct, k, metric=metric, corpus_valid=vt)
        torch.cuda.synchronize()
        pd, pid = flat_topk_plain(qt, ct, k, metric=metric, corpus_valid=vt)
        max_err = max(max_err, compare(kd, kid, pd, pid, qt, ct, vt, metric))
        n_cases += 1
    print(f"kernel vs plain: {n_cases} cases agree, max |d| error {max_err:.3g}",
          flush=True)

    # 4. main path at bench.py's headline shape
    n, d, nq, k = 100_000, 384, 8192, 10
    t0 = time.perf_counter()
    churn = 32_768  # phase 15's rows
    x, qq, x15 = clustered(np.random.default_rng(7), n, d, 1000, nq, churn)
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
    check(_build.LAUNCHES["flat_topk_mma"] == 0,
          "precision='highest' launched the tensor-core kernel")
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

    library_ms = device_ms(lambda: f32_library(qg, corpus, valid, k))
    qu, cu = unit_t(qg), unit_t(corpus)
    gemm_ms = device_ms(lambda: exact_f32_dots(qu, cu))
    del qu, cu
    flops = 2.0 * nq * n * d
    f32_bound, f32_bound_by = bound(flops, "fp32",
                                    4.0 * (n + nq) * d + n + 8.0 * nq * k)
    print(f"100k x 384, {nq} queries, k={k}: kernel {ms:.3f} ms"
          f" ({nq / ms * 1e3:.0f} QPS, {flops / ms / 1e9:.2f} TFLOP/s),"
          f" plain {plain_ms:.3f} ms ({nq / plain_ms * 1e3:.0f} QPS), library"
          f" {library_ms:.3f} ms (its f32 matmul alone {gemm_ms:.3f} ms);"
          f" bound {f32_bound:.3f} ms ({f32_bound_by})", flush=True)
    check(ms < library_ms and ms < plain_ms,
          f"highest at 100k x 384: kernel {ms} ms, not faster than the library"
          f" call's {library_ms} ms and plain's {plain_ms} ms")
    del index, corpus, valid, qg, pd, pd1
    torch.cuda.empty_cache()

    # 5. 1M x 768, the north-star shape; phase 7 takes all 8,192 queries
    n5, d5, nq5 = 1_000_000, 768, 1024
    gen = torch.Generator(device="cuda").manual_seed(11)
    x5, q7 = clustered_on_device(gen, n5, d5, 1000, 8192)
    q5 = q7[:nq5]
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
    library_ms5 = device_ms(lambda: f32_library(q5, c5, v5, k))
    qu, cu = unit_t(q5), unit_t(c5)
    gemm_ms5 = device_ms(lambda: exact_f32_dots(qu, cu))
    del qu, cu
    flops5 = 2.0 * nq5 * n5 * d5
    bound5, _ = bound(flops5, "fp32", 4.0 * (n5 + nq5) * d5 + n5 + 8.0 * nq5 * k)
    print(f"1M x 768, {nq5} queries, k={k}: kernel {ms5:.3f} ms"
          f" ({nq5 / ms5 * 1e3:.0f} QPS, {flops5 / ms5 / 1e9:.2f} TFLOP/s), plain"
          f" {plain_ms5:.3f} ms ({nq5 / plain_ms5 * 1e3:.0f} QPS), library"
          f" {library_ms5:.3f} ms (its f32 matmul alone {gemm_ms5:.3f} ms);"
          f" bound {bound5:.3f} ms", flush=True)
    check(ms5 < library_ms5 and ms5 < plain_ms5,
          f"highest at 1M x 768: kernel {ms5} ms, not faster than the library"
          f" call's {library_ms5} ms and plain's {plain_ms5} ms")
    torch.cuda.empty_cache()
    del pd5

    # 6. the int8 mode of the tensor-core kernel (flat_topk_int8) vs plain
    rng = np.random.default_rng(5)
    n_i8 = 0
    i8_err = 0.0
    for case, (metric, d6, k6, masked) in enumerate(itertools.product(
            ("cosine", "inner_product"), (100, 384, 768), MMA_KS, (False, True))):
        b, n6 = mma_shape(case, k6)
        qt = torch.from_numpy(unit_rows(
            rng.standard_normal((b, d6), dtype=np.float32))).cuda()
        ct = torch.from_numpy(rng.standard_normal((n6, d6), dtype=np.float32)).cuda()
        ci, cs = quantize_rows_int8(ct, normalize=metric == "cosine")
        vt = torch.from_numpy(rng.random(n6) >= 0.3).cuda() if masked else None
        kd, kid = flat_topk_int8_cuda(qt, ci, cs, k6, metric=metric, corpus_valid=vt)
        torch.cuda.synchronize()
        pd, pid = flat_topk_int8_plain(qt, ci, cs, k6, metric=metric, corpus_valid=vt)
        qi, _ = quantize_rows_int8(unit_t(qt) if metric == "cosine" else qt)
        cp = torch.zeros(n6, device="cuda")
        if vt is not None:
            cp = torch.where(vt, cp, torch.inf)
        i8_err = max(i8_err, compare_int8(kd, kid, pd, pid, qi, ci, cs, cp))
        n_i8 += 1
    print(f"flat_topk_int8 kernel vs plain: {n_i8} cases, distances bitwise"
          " equal, ids equal up to exact tile ties", flush=True)

    # 7. the int8 main path at the north-star shape: 1M x 768 cosine, 8,192
    # queries, k=10 (bench.py:482-483, :511-539)
    nq7, r7 = q7.shape[0], 16
    ext7 = np.arange(n5, dtype=np.int64)
    _, truth7 = flat_topk(q7[:512], c5, k, metric="cosine", corpus_valid=v5)
    truth7 = truth7.cpu().numpy()
    resc = FlatIndex(d5, "cosine", capacity=n5, device="cuda",
                     precision="int8_rescored")
    resc.insert(ext7, c5)
    check(resc.rescore_r == r7, f"int8_rescored r is {resc.rescore_r}")
    _build.reset_launches()
    t0 = time.perf_counter()
    rd, rslot = resc.search_device(q7, k)
    torch.cuda.synchronize()
    resc_first_s = time.perf_counter() - t0
    i8_launches = _build.LAUNCHES["flat_topk_int8"]
    check(i8_launches > 0, f"int8_rescored launched flat_topk_int8 {i8_launches} times")
    check(_build.LAUNCHES["flat_topk_mma"] == i8_launches,
          f"int8_rescored launched another kernel: {dict(_build.LAUNCHES)}")
    check(bool((rslot >= 0).all() and torch.isfinite(rd).all()),
          "int8_rescored: a missing result")
    check(bool((rd[:, 1:] >= rd[:, :-1]).all()), "int8_rescored dists not ascending")
    rows = c5[rslot.long()].double()
    want = 1.0 - (rows * unit_t(q7).double()[:, None, :]).sum(-1) / rows.norm(dim=-1)
    resc_err = float((rd.double() - want).abs().max())
    check(resc_err <= TOL, f"int8_rescored distance error {resc_err}")
    del rows, want
    resc_recall = recall(rslot[:512].cpu().numpy(), truth7)
    check(resc_recall >= MIN_RESCORED_RECALL,
          f"int8_rescored recall@{k} {resc_recall} < {MIN_RESCORED_RECALL}")
    resc_ms = device_ms(lambda: resc.search_device(q7, k), reps=3)
    print(f"FlatIndex(int8_rescored) 1M x 768, {nq7} queries, k={k}, r={r7}:"
          f" recall@{k} {resc_recall} (first 512 queries vs exact), max |d|"
          f" error {resc_err:.3g} vs float64; first search {resc_first_s:.3f} s,"
          f" then {resc_ms:.3f} ms ({nq7 / resc_ms * 1e3:.0f} QPS); launches"
          f" {dict(_build.LAUNCHES)}", flush=True)

    # the int8 kernel at the main path's call: 8,192 x 1M x 768, k=r=16
    vi7, sc7 = resc._i8
    valid7 = resc.store.valid[:n5]
    kd7, ki7 = flat_topk_int8(q7, vi7, sc7, r7, metric="cosine", corpus_valid=valid7)
    pd7, pi7 = flat_topk_int8_plain(q7, vi7, sc7, r7, metric="cosine",
                                    corpus_valid=valid7)
    qi7, _ = quantize_rows_int8(unit_t(q7))
    i8_err = max(i8_err, compare_int8(kd7, ki7, pd7, pi7, qi7, vi7, sc7,
                                      torch.zeros(n5, device="cuda")))
    del pd7, pi7, qi7
    i8_ms = device_ms(lambda: flat_topk_int8(q7, vi7, sc7, r7, metric="cosine",
                                             corpus_valid=valid7))
    i8_plain_ms = device_ms(lambda: flat_topk_int8_plain(
        q7, vi7, sc7, r7, metric="cosine", corpus_valid=valid7))

    def int8_library():
        # cuBLASLt int8 -> int32 (torch._int_mm) per 65,536-row chunk: its
        # shape rules (m > 16; k and n multiples of 8) hold at 8,192 x 768
        # and chunks of 65,536 and 16,960 rows; the same rank-only epilogue
        qi, qs = quantize_rows_int8(unit_t(q7))
        part_d, part_i = [], []
        for lo in range(0, n5, 65536):
            dots = torch._int_mm(qi, vi7[lo : lo + 65536].T)
            tile = -(dots.float() * sc7[None, lo : lo + 65536])
            td, ti = torch.topk(tile, r7, dim=1, largest=False)
            part_d.append(td)
            part_i.append(ti + lo)
        md, pos = torch.topk(torch.cat(part_d, 1), r7, dim=1, largest=False)
        return 1.0 + qs[:, None] * md, torch.gather(torch.cat(part_i, 1), 1, pos)

    ld7, _ = int8_library()
    check(torch.equal(ld7, kd7), "the _int_mm yardstick's distances differ")
    i8_library_ms = device_ms(int8_library)
    qi7, _ = quantize_rows_int8(unit_t(q7))

    def int8_gemms():
        # the yardstick's products alone, over the same chunks
        for lo in range(0, n5, 65536):
            torch._int_mm(qi7, vi7[lo : lo + 65536].T)

    i8_gemm_ms = device_ms(int8_gemms)
    del qi7
    check(i8_ms < i8_library_ms,
          f"flat_topk_int8 {i8_ms} ms is not faster than _int_mm's {i8_library_ms} ms")
    i8_ops = 2.0 * nq7 * n5 * d5
    # int8 rows and f32 scales and mask in, f32 queries in, [B, r] out
    i8_bound, i8_bound_by = bound(
        i8_ops, "int8", n5 * d5 + 5.0 * n5 + 4.0 * nq7 * d5 + 8.0 * nq7 * r7)
    print(f"flat_topk_int8 {nq7} x 1M x 768, k={r7}: kernel {i8_ms:.3f} ms"
          f" ({nq7 / i8_ms * 1e3:.0f} QPS, {i8_ops / i8_ms / 1e9:.2f} TOP/s),"
          f" plain {i8_plain_ms:.3f} ms ({nq7 / i8_plain_ms * 1e3:.0f} QPS),"
          f" library (_int_mm) {i8_library_ms:.3f} ms"
          f" ({nq7 / i8_library_ms * 1e3:.0f} QPS; its _int_mm products alone"
          f" {i8_gemm_ms:.3f} ms); bound {i8_bound:.3f} ms"
          f" ({nq7 / i8_bound * 1e3:.0f} QPS, {i8_bound_by})", flush=True)
    r_tuned = resc.tune_rescore_r(k=k)
    print(f"tune_rescore_r: r={r_tuned}, curve {resc.tune_report}", flush=True)
    del resc, vi7, sc7, valid7, kd7, ld7, rd, rslot
    torch.cuda.empty_cache()

    quant = QuantizedFlatIndex(d5, "cosine", capacity=n5, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    quant.insert(ext7, c5)
    qd1, qslot1 = quant.search_device(q7, k)
    dead7 = np.unique(qslot1[:, 0].cpu().numpy())[:1000]
    quant.delete(dead7)
    qd2, qslot2 = quant.search_device(q7, k)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_launches = _build.LAUNCHES["flat_topk_int8"]
    check(quant_launches >= 2, f"QuantizedFlatIndex launched {quant_launches} times")
    check(_build.LAUNCHES["flat_topk_mma"] == quant_launches,
          f"QuantizedFlatIndex launched another kernel: {dict(_build.LAUNCHES)}")
    check(len(dead7) == 1000 and len(quant) == n5 - 1000, "quantized delete count")
    check(not np.isin(qslot2.cpu().numpy(), dead7).any(), "a deleted id came back")
    check(bool(torch.isfinite(qd2).all() and (qd2[:, 1:] >= qd2[:, :-1]).all()),
          "quantized dists not finite and ascending")
    _, truth7b = flat_topk(q7[:512], c5, k, metric="cosine",
                           corpus_valid=quant.store.valid[:n5])
    q_recall1 = recall(qslot1[:512].cpu().numpy(), truth7)
    q_recall2 = recall(qslot2[:512].cpu().numpy(), truth7b.cpu().numpy())
    check(q_recall2 >= MIN_QUANTIZED_RECALL,
          f"QuantizedFlatIndex recall@{k} {q_recall2} < {MIN_QUANTIZED_RECALL}")
    quant_ms = device_ms(lambda: quant.search_device(q7, k), reps=3)
    print(f"QuantizedFlatIndex 1M x 768: insert, search, delete 1,000, search"
          f" in {quant_s:.3f} s; recall@{k} {q_recall1} before delete,"
          f" {q_recall2} after; search {quant_ms:.3f} ms"
          f" ({nq7 / quant_ms * 1e3:.0f} QPS); launches {quant_launches}",
          flush=True)
    del quant, qd1, qd2, qslot1, qslot2
    torch.cuda.empty_cache()

    proj = FlatIndex(d5, "cosine", capacity=n5, device="cuda",
                     precision="proj_rescored", proj_dim=128)
    proj.insert(ext7, c5)
    _build.reset_launches()
    t0 = time.perf_counter()
    pjd, pjslot = proj.search_device(q7, k)
    torch.cuda.synchronize()
    proj_first_s = time.perf_counter() - t0
    check(_build.LAUNCHES["flat_topk_int8"] > 0
          and _build.LAUNCHES["flat_topk_mma"] == _build.LAUNCHES["flat_topk_int8"],
          f"proj_rescored launches {dict(_build.LAUNCHES)}")
    check(bool((pjslot >= 0).all() and torch.isfinite(pjd).all()),
          "proj_rescored: a missing result")
    proj_recall = recall(pjslot[:512].cpu().numpy(), truth7)
    proj_ms = device_ms(lambda: proj.search_device(q7, k), reps=3)
    print(f"FlatIndex(proj_rescored) proj_dim=128, r={proj.rescore_r}: recall@{k}"
          f" {proj_recall} (no floor); first search (basis, shadow) "
          f"{proj_first_s:.3f} s, then {proj_ms:.3f} ms"
          f" ({nq7 / proj_ms * 1e3:.0f} QPS)", flush=True)
    del proj, pjd, pjslot, big, c5, v5, q5, q7
    torch.cuda.empty_cache()

    # 8. gather_block_dots kernel vs plain on the card
    rng = np.random.default_rng(6)
    beam_err = 0.0
    n_beam = 0

    def beam_case(dtype, d6, r0, e, b):
        """One gather_block_dots case: unit rows in ``dtype`` blocks, 40%
        dead picks; dead lanes exactly 0, the rest within TOL of plain (int8
        after the caller's per-neighbour scaling). Returns the largest
        error."""
        cap = 509
        blocks = rng.standard_normal((cap, r0, d6), dtype=np.float32)
        blocks /= np.linalg.norm(blocks, axis=2, keepdims=True)
        packed = torch.from_numpy(blocks).cuda()
        if dtype == torch.int8:
            packed, scales = quantize_rows_int8(packed)
        else:
            packed = packed.to(dtype)
        qb = torch.from_numpy(unit_rows(
            rng.standard_normal((b, d6), dtype=np.float32))).cuda()
        picks = rng.integers(0, cap, (b, e)).astype(np.int32)
        dead = rng.random((b, e)) < 0.4
        picks[dead] = -1
        it = torch.from_numpy(picks).cuda()
        kd6, kc6 = gather_block_dots_cuda(qb, it, packed)
        torch.cuda.synchronize()
        pd6, pc6 = gather_block_dots_plain(qb, it, packed)
        kd6, kc6, pd6, pc6 = (t.cpu().numpy() for t in (kd6, kc6, pd6, pc6))
        lanes = np.repeat(dead, r0, axis=1)
        check(bool((kd6[lanes] == 0).all() and (kc6[lanes] == 0).all()),
              "beam_dots: a dead lane is not 0")
        if dtype == torch.int8:
            # the caller's per-neighbour dequantization
            ps = scales[it.clamp(min=0).long()].reshape(b, e * r0)
            ps = ps.cpu().numpy()
            kd6, pd6 = kd6 * ps, pd6 * ps
            kc6, pc6 = kc6 * ps * ps, pc6 * ps * ps
        np.testing.assert_allclose(kd6, pd6, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(kc6, pc6, rtol=TOL, atol=TOL)
        if dtype == torch.float32 and r0 == 12 and b == 1:
            # a pick at or above cap: NaN lanes, no read; its live neighbour
            # pick as plain gives it
            bad = torch.tensor([[picks[0, 0] if picks[0, 0] >= 0 else 0, cap, -1]],
                               dtype=torch.int32, device="cuda")
            kdn, kcn = gather_block_dots_cuda(qb, bad, packed)
            pdn, pcn = gather_block_dots_plain(qb, bad.clamp(max=cap - 1)[:, :1], packed)
            check(bool(torch.isnan(kdn[0, r0:2 * r0]).all()
                       and torch.isnan(kcn[0, r0:2 * r0]).all()),
                  "beam_dots: a pick at or above cap is not NaN")
            check(bool((kdn[0, 2 * r0:] == 0).all()), "beam_dots: a dead lane is not 0")
            torch.testing.assert_close(kdn[:, :r0], pdn, rtol=TOL, atol=TOL)
            torch.testing.assert_close(kcn[:, :r0], pcn, rtol=TOL, atol=TOL)
        return max(float(np.abs(kd6 - pd6).max(initial=0)),
                   float(np.abs(kc6 - pc6).max(initial=0)))

    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for d6 in (100, 128, 384, 768):
            for r0 in (16, 32):
                for e in (1, 8):
                    for b in (1, 37, 300):
                        beam_err = max(beam_err, beam_case(dtype, d6, r0, e, b))
                        n_beam += 1
    # search_degree's cut widths, three picks, the element-wise path (d=37)
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for d6 in (37, 100, 384):
            for r0 in (12, 20):
                for b in (1, 37, 300):
                    beam_err = max(beam_err, beam_case(dtype, d6, r0, 3, b))
                    n_beam += 1
    print(f"beam_dots kernel vs plain: {n_beam} cases agree, max error"
          f" {beam_err:.3g}; a pick at or above cap gives NaN", flush=True)

    # 9. flat_topk's bf16-operand mode (the tensor-core kernel) vs plain
    bf_err = 0.0
    n_bf = 0
    for case, (metric, d7, k7, masked) in enumerate(itertools.product(
            METRICS, (100, 384, 768), MMA_KS, (False, True))):
        b, n7 = mma_shape(case, k7)
        q = torch.from_numpy(unit_rows(
            rng.standard_normal((b, d7), dtype=np.float32))).cuda()
        c = torch.from_numpy(unit_rows(
            rng.standard_normal((n7, d7), dtype=np.float32))).cuda()
        vt = torch.from_numpy(rng.random(n7) >= 0.3).cuda() if masked else None
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
    _build.reset_launches()
    fd, fslot = fast.search_device(qg, k)
    torch.cuda.synchronize()
    bf_launches = _build.LAUNCHES["flat_topk"]
    check(bf_launches > 0 and _build.LAUNCHES["flat_topk_mma"] == bf_launches,
          f"FlatIndex(precision='default') launches {dict(_build.LAUNCHES)}")
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
    # the yardstick computes the kernel's function: its top-1 is the
    # kernel's up to a tie of the bf16-rounded operands
    lib_d, lib_i = bf16_library(qg, corpus, valid, k)
    lib_top = lib_i[:, 0].int()
    check(bool(torch.isclose(1.0 - lib_d[:, 0], fd[:, 0], rtol=TOL, atol=TOL).all()),
          "the bf16 yardstick's top-1 distances differ from the kernel's")
    library_ms_def = device_ms(lambda: bf16_library(qg, corpus, valid, k))
    q16, c16 = unit_t(qg).bfloat16(), corpus.bfloat16()
    gemm_ms_def = device_ms(lambda: torch.mm(q16, c16.T, out_dtype=torch.float32))
    del q16, c16
    check(ms_def < library_ms_def,
          f"the bf16 mode's {ms_def} ms is not faster than the library's"
          f" {library_ms_def} ms")
    bound_def, bound_def_by = bound(flops, "bf16", 4.0 * (n + nq) * d + n + 8.0 * nq * k)
    print(f"flat_topk bf16 mode vs plain: {n_bf + 1} cases agree, max |d| error"
          f" {bf_err:.3g}; FlatIndex(precision='default') 100k x 384, {nq}"
          f" queries: recall@{k} {fast_recall} vs exact; kernel {ms_def:.3f} ms"
          f" ({nq / ms_def * 1e3:.0f} QPS), plain {plain_ms_def:.3f} ms, library"
          f" (bf16 matmul, f32 out) {library_ms_def:.3f} ms (the matmul alone"
          f" {gemm_ms_def:.3f} ms); launches {bf_launches}; bound"
          f" {bound_def:.3f} ms; top-1 equal to the kernel's in"
          f" {float((lib_top == fslot[:, 0]).float().mean()):.5f} of queries",
          flush=True)
    del fast, corpus, valid, pd, lib_d, lib_i
    torch.cuda.empty_cache()

    def check_hnsw(hids, hd, what: str) -> float:
        """An HNSW search of phase 4's queries: every query answered, its
        distances ascending and each the exact float64 distance of the
        returned row, recall@k against phase 4's exact result at least
        MIN_HNSW_RECALL. Returns the recall."""
        check(hids.shape == (nq, k) and bool((hids >= 0).all())
              and bool(np.isfinite(hd).all()), f"{what}: a missing result")
        check(bool(np.all(hd[:, 1:] >= hd[:, :-1])), f"{what} dists not ascending")
        true = dist64(np.repeat(qq, k, axis=0), x[(hids - ext[0]).reshape(-1)],
                      "cosine").reshape(nq, k)
        np.testing.assert_allclose(hd, true, rtol=TOL, atol=TOL)
        rec = recall(hids, ids1)
        check(rec >= MIN_HNSW_RECALL, f"{what} recall@{k} {rec} < {MIN_HNSW_RECALL}")
        return rec

    # 10. the HNSW main path at bench.py's HNSW workload, on phase 4's data
    ef, m, wave = 24, 16, 4096
    hnsw = HnswIndex(d, "cosine", m=m, ef_construction=200,
                     capacity=n + churn + wave, seed=42, expand=8,
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
    for name in ("flat_topk", "beam_step"):
        check(hnsw_launches[name] > 0,
              f"the HNSW path launched {name} {hnsw_launches[name]} times")
    check(hnsw_launches["beam_dots"] == 0,
          f"the fused beam launched beam_dots: {hnsw_launches}")
    check(hnsw_launches["flat_topk_mma"] == hnsw_launches["flat_topk"],
          f"the HNSW build or routing launched another kernel: {hnsw_launches}")
    hnsw_recall = check_hnsw(hids, hd, "HNSW")
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
    live_picks = int((picks >= 0).sum())

    def beam_bound(pk):
        """Bytes of the live picks' blocks, the queries and ids read, and
        the two [B, E*R0] f32 outputs written."""
        nbytes = (live_picks * pk.shape[1] * pk.shape[2] * pk.element_size()
                  + qc.numel() * 4 + picks.numel() * 4
                  + 2 * picks.numel() * pk.shape[1] * 4)
        # a multiply-add for the dot and one for the squared norm
        return bound(4.0 * live_picks * pk.shape[1] * pk.shape[2], "fp32", nbytes)

    beam_bound_ms, beam_bound_by = beam_bound(packed)
    block_bytes = live_picks * packed.shape[1] * packed.shape[2] * packed.element_size()
    print(f"gather_block_dots at [{chunk}, {picks.shape[1]}] x"
          f" [{packed.shape[1]}, {packed.shape[2]}] bf16: kernel {beam_ms:.4f} ms"
          f" ({block_bytes / beam_ms / 1e6:.0f} GB/s of blocks read), plain"
          f" {beam_plain_ms:.4f} ms; bound {beam_bound_ms:.4f} ms"
          f" ({beam_bound_by})", flush=True)

    # beam_step at the HNSW cell's shape (c100k-384.hnsw: ef 64, E 8, R0 32,
    # d 384, bf16), every step of one chunk's beam from its routed entries
    step10 = beam_step_vs_plain("the HNSW cell's shape", qc, picks, hnsw._vecs16(),
                                None, hnsw.neighbors0, packed, None, "cosine", 64,
                                hnsw.expand)
    del packed

    # 11. int8 beam guidance on the same graph, repacked
    hnsw.search_quant = "int8"
    hnsw.pack_neighbors()
    packed8 = hnsw._maybe_packed()
    check(packed8 is not None and packed8.dtype == torch.int8,
          "the int8 packed table was not built")
    _build.reset_launches()
    t0 = time.perf_counter()
    hids8, hd8 = hnsw.search(qq, k=k, ef_search=ef)
    torch.cuda.synchronize()
    first8_s = time.perf_counter() - t0
    hnsw8_launches = dict(_build.LAUNCHES)
    check(hnsw8_launches["beam_step"] > 0 and hnsw8_launches["beam_dots"] == 0
          and hnsw8_launches["beam_dots_int8"] == 0,
          f"int8 guidance launches {hnsw8_launches}")
    hnsw8_recall = check_hnsw(hids8, hd8, "HNSW int8")
    search8_ms = device_ms(lambda: hnsw.search_device(qg, k, ef), reps=3)
    print(f"HNSW int8 guidance, ef={ef}: {nq} queries: first search"
          f" {first8_s:.3f} s, then {search8_ms:.3f} ms"
          f" ({nq / search8_ms * 1e3:.0f} QPS); recall@{k} {hnsw8_recall};"
          f" launches {hnsw8_launches}", flush=True)
    # beam_step on the int8 blocks and their scales, at this search's ef
    v8, sc8 = hnsw._vecs8()
    step11 = beam_step_vs_plain("int8 guidance", qc, picks, v8, sc8, hnsw.neighbors0,
                                packed8, hnsw._packed_scales, "cosine", ef,
                                hnsw.expand)
    del v8, sc8, packed8

    # 12. gather_block_topm (beam_dots' top-m mode): kernel vs plain, then
    # beam_topm on phase 10's index with bf16 guidance
    gen = torch.Generator(device="cuda").manual_seed(12)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    topm_err, n_topm = 0.0, 0
    for d12 in (100, 128, 384, 768):
        for r0 in (16, 32):
            base = unit_t(torch.randn(509, r0, d12, generator=gen, device="cuda"))
            for dtype in (torch.float32, torch.bfloat16):
                blocks = base.to(dtype)
                for metric in METRICS:
                    for e in (1, 8):
                        for m12 in (1, 8, r0):
                            b = (1, 37, 300)[n_topm % 3]
                            qb = unit_t(torch.randn(b, d12, generator=gen, device="cuda"))
                            pk = torch.randint(0, 509, (b, e), generator=gen,
                                               device="cuda", dtype=torch.int32)
                            pk[rand(b, e) < 0.4] = -1
                            pen = torch.where(rand(b, e * r0) < 0.25, BIG, 0.0)
                            kd12, kl12 = gather_block_topm_cuda(qb, pk, blocks, pen,
                                                                metric, m12)
                            torch.cuda.synchronize()
                            pd12, pl12 = gather_block_topm_plain(qb, pk, blocks, pen,
                                                                 metric, m12)
                            topm_err = max(topm_err, compare_topm(
                                kd12, kl12, pd12, pl12, qb, pk, blocks, metric, BIG))
                            n_topm += 1
    print(f"beam_topm kernel vs plain: {n_topm} cases agree, max |d| error"
          f" {topm_err:.3g}", flush=True)

    hnsw.search_quant = "bf16"
    hnsw.pack_neighbors()
    packed = hnsw._maybe_packed()
    topm = 12
    hnsw.beam_topm = topm
    _build.reset_launches()
    t0 = time.perf_counter()
    tids, tdist = hnsw.search(qq, k=k, ef_search=ef)
    torch.cuda.synchronize()
    topm_first_s = time.perf_counter() - t0
    topm_launches = dict(_build.LAUNCHES)
    check(topm_launches["beam_topm"] > 0 and topm_launches["beam_dots"] == 0
          and topm_launches["beam_step"] == 0,
          f"beam_topm search launches {topm_launches}")
    topm_recall = check_hnsw(tids, tdist, "HNSW beam_topm")
    topm_search_ms = device_ms(lambda: hnsw.search_device(qg, k, ef), reps=3)
    hnsw.beam_topm = 0
    fused12_ms = device_ms(lambda: hnsw.search_device(qg, k, ef), reps=3)
    print(f"HNSW beam_topm={topm}, ef={ef}: {nq} queries: first search"
          f" {topm_first_s:.3f} s, then {topm_search_ms:.3f} ms"
          f" ({nq / topm_search_ms * 1e3:.0f} QPS), fused search in the same"
          f" call {fused12_ms:.3f} ms; recall@{k} {topm_recall}; launches"
          f" {topm_launches}", flush=True)
    # the first beam step of phase 10's chunk: in-beam and empty lanes masked
    r0h = packed.shape[1]
    nb12 = hnsw.neighbors0[picks.clamp(min=0).long()].reshape(chunk, -1)
    in_beam = (nb12[:, :, None] == picks[:, None, :]).any(dim=2)
    pen12 = torch.where(in_beam | (nb12 < 0), BIG, 0.0)
    kd12, kl12 = gather_block_topm_cuda(qc, picks, packed, pen12, "cosine", topm)
    torch.cuda.synchronize()
    pd12, pl12 = gather_block_topm_plain(qc, picks, packed, pen12, "cosine", topm)
    topm_err = max(topm_err, compare_topm(kd12, kl12, pd12, pl12, qc, picks,
                                          packed, "cosine", BIG))
    topm_ms = device_ms(lambda: gather_block_topm_cuda(qc, picks, packed, pen12,
                                                       "cosine", topm), reps=20)
    topm_plain_ms = device_ms(lambda: gather_block_topm_plain(
        qc, picks, packed, pen12, "cosine", topm))
    # the live blocks, the penalty, queries, norms and ids read; the two
    # [B, E, m] outputs written
    topm_bound_ms, topm_bound_by = bound(
        4.0 * live_picks * r0h * d,
        "fp32",
        live_picks * r0h * d * 2 + pen12.numel() * 4 + qc.numel() * 4 + chunk * 4
        + picks.numel() * 4 + 2 * picks.numel() * topm * 4)
    print(f"gather_block_topm at [{chunk}, {picks.shape[1]}] x [{r0h}, {d}] bf16,"
          f" m={topm}: kernel {topm_ms:.4f} ms, plain {topm_plain_ms:.4f} ms;"
          f" bound {topm_bound_ms:.4f} ms ({topm_bound_by})", flush=True)

    # 13. beam_loop: kernel vs plain, then beam_whole on the same index
    rng = np.random.default_rng(13)
    loop_err, n_grid = 0.0, 0

    def loop_case(metric, d13, r0, cap, b, ef13, expand, patience, mi13) -> float:
        """One beam_loop geometry on integer-grid rows: slots bit-equal to
        plain, distances within 1e-6. Returns the largest error."""
        v16 = torch.from_numpy(grid_rows(rng, cap, d13)).cuda().bfloat16()
        nb13 = torch.from_numpy(rng.integers(-1, cap, (cap, r0)).astype(np.int32)).cuda()
        q13 = torch.from_numpy(grid_rows(rng, b, d13)).cuda()
        r13 = min(8, ef13)
        ent = rng.integers(0, cap, (b, r13)).astype(np.int32)
        ent[rng.random((b, r13)) < 0.1] = -1
        ent = torch.from_numpy(ent).cuda()
        e_d = gathered_distances(q13, v16[ent.clamp(min=0).long()].float(), metric)
        init_d = torch.full((b, ef13), torch.inf, device="cuda")
        init_i = torch.full((b, ef13), -1, dtype=torch.int32, device="cuda")
        init_d[:, :r13] = torch.where(ent >= 0, e_d, torch.inf)
        init_i[:, :r13] = ent
        blocks = v16[nb13.clamp(min=0).long()]
        args13 = (q13, init_d, init_i, blocks, nb13, metric, ef13, expand, patience, mi13)
        kd13, ki13 = beam_loop_cuda(*args13)
        torch.cuda.synchronize()
        pd13, pi13, _, _ = beam_loop_plain(*args13)
        check(torch.equal(ki13, pi13),
              f"beam_loop: slots differ on grid rows ({metric}, d={d13}, R0={r0},"
              f" ef={ef13}, expand={expand})")
        fin = torch.isfinite(pd13)
        check(torch.equal(torch.isfinite(kd13), fin), "beam_loop: inf pattern differs")
        torch.testing.assert_close(kd13[fin], pd13[fin], rtol=1e-6, atol=1e-6)
        return float((kd13[fin] - pd13[fin]).abs().max()) if bool(fin.any()) else 0.0

    for trial in range(12):
        metric = METRICS[trial % 3]
        d13, r0 = (100, 128)[trial % 2], (16, 32)[(trial // 2) % 2]
        cap, b = int(rng.integers(96, 2000)), int(rng.integers(1, 300))
        ef13, expand = int(rng.integers(4, 65)), int(rng.integers(1, 9))
        patience, mi13 = int(rng.integers(1, 16)), int(rng.integers(0, 8))
        loop_err = max(loop_err, loop_case(metric, d13, r0, cap, b, ef13, expand,
                                           patience, mi13))
        n_grid += 1
    # the limits: ef = MAX_EF, E*R0 = MAX_CANDIDATES (128 picks of 32 rows);
    # then a query too wide for shared memory beside the rest, which the
    # kernel reads from device memory
    loop_err = max(loop_err, loop_case("l2", 128, 32, 3000, 3, beam_loop_mod.MAX_EF,
                                       128, 0, 6))
    check(not beam_loop_mod._plan(60_000, 24, 4, 16)[1],
          "beam_loop: d = 60,000 keeps the query in shared memory")
    loop_err = max(loop_err, loop_case("inner_product", 60_000, 16, 64, 2, 24, 4, 0, 4))
    n_grid += 2
    # Gaussian rows over a random 32-regular graph: only summation order differs
    cap, d13, b = 5000, 384, 300
    v16 = unit_t(torch.randn(cap, d13, generator=gen, device="cuda")).bfloat16()
    nb13 = torch.randint(0, cap, (cap, 32), generator=gen, device="cuda", dtype=torch.int32)
    q13 = unit_t(torch.randn(b, d13, generator=gen, device="cuda"))
    ent = torch.randint(0, cap, (b, 8), generator=gen, device="cuda", dtype=torch.int32)
    init_d = torch.full((b, ef), torch.inf, device="cuda")
    init_i = torch.full((b, ef), -1, dtype=torch.int32, device="cuda")
    init_d[:, :8] = gathered_distances(q13, v16[ent.long()].float(), "cosine")
    init_i[:, :8] = ent
    args13 = (q13, init_d, init_i, v16[nb13.long()], nb13, "cosine", ef, 8)
    kd13, ki13 = beam_loop_cuda(*args13)
    torch.cuda.synchronize()
    pd13, pi13, _, _ = beam_loop_plain(*args13)

    def beam_overlap(ka, pa) -> float:
        ka, pa = ka.cpu().numpy(), pa.cpu().numpy()
        return float(np.mean([len(set(u[u >= 0]) & set(v[v >= 0])) / max((v >= 0).sum(), 1)
                              for u, v in zip(ka, pa)]))

    def agreeing_err(kd_, ki_, pd_, pi_) -> float:
        agree = (ki_ == pi_) & (pi_ >= 0)
        torch.testing.assert_close(kd_[agree], pd_[agree], rtol=TOL, atol=TOL)
        return float((kd_[agree] - pd_[agree]).abs().max()) if bool(agree.any()) else 0.0

    gauss_overlap = beam_overlap(ki13, pi13)
    check(gauss_overlap >= 0.99, f"beam_loop: Gaussian beam overlap {gauss_overlap}")
    loop_err = max(loop_err, agreeing_err(kd13, ki13, pd13, pi13))
    print(f"beam_loop kernel vs plain: {n_grid} grid geometries with bit-equal"
          f" slots, Gaussian beam overlap {gauss_overlap:.5f}; max |d| error"
          f" {loop_err:.3g}", flush=True)

    hnsw.beam_whole = True
    _build.reset_launches()
    t0 = time.perf_counter()
    wids, wdist = hnsw.search(qq, k=k, ef_search=ef)
    torch.cuda.synchronize()
    whole_first_s = time.perf_counter() - t0
    whole_launches = dict(_build.LAUNCHES)
    check(whole_launches["beam_loop"] > 0 and whole_launches["beam_dots"] == 0
          and whole_launches["beam_step"] == 0 and whole_launches["flat_topk"] > 0,
          f"whole-beam search launches {whole_launches}")
    whole_recall = check_hnsw(wids, wdist, "HNSW whole-beam")
    check(abs(whole_recall - hnsw_recall) <= 0.01,
          f"whole-beam recall {whole_recall} vs fused {hnsw_recall}")
    whole_search_ms = device_ms(lambda: hnsw.search_device(qg, k, ef), reps=3)
    hnsw.beam_whole = False
    fused13_ms = device_ms(lambda: hnsw.search_device(qg, k, ef), reps=3)
    print(f"HNSW beam_whole, ef={ef}, expand={hnsw.expand}: {nq} queries: first"
          f" search {whole_first_s:.3f} s, then {whole_search_ms:.3f} ms"
          f" ({nq / whole_search_ms * 1e3:.0f} QPS), fused search in the same"
          f" call {fused13_ms:.3f} ms; recall@{k} {whole_recall} (fused"
          f" {hnsw_recall}); launches {whole_launches}", flush=True)
    # one chunk of the whole path: its routed entries as the initial beam
    r13 = min(hnsw.route_entries, ef)
    ent = _route(qc, pool, hnsw._pool_vecs(pool), hnsw.metric, r13)
    init_d = torch.full((chunk, ef), torch.inf, device="cuda")
    init_i = torch.full((chunk, ef), -1, dtype=torch.int32, device="cuda")
    init_d[:, :r13] = torch.where(
        ent >= 0, gathered_distances(qc, hnsw._vecs16()[ent.clamp(min=0).long()].float(),
                                     "cosine"), torch.inf)
    init_i[:, :r13] = ent
    mi13 = -(-ef // hnsw.expand) + 1  # the search's own step budget
    args13 = (qc, init_d, init_i, packed, hnsw.neighbors0, "cosine", ef, hnsw.expand,
              0, mi13)
    kd13, ki13 = beam_loop_cuda(*args13)
    torch.cuda.synchronize()
    pd13, pi13, n_exp, fresh = beam_loop_plain(*args13)
    chunk_overlap = beam_overlap(ki13, pi13)
    check(chunk_overlap >= 0.99, f"beam_loop: chunk beam overlap {chunk_overlap}")
    loop_err = max(loop_err, agreeing_err(kd13, ki13, pd13, pi13))
    loop_ms = device_ms(lambda: beam_loop_cuda(*args13), reps=20)
    loop_plain_ms = device_ms(lambda: beam_loop_plain(*args13))
    # the ids of every expansion, the rows of the candidates the dedup keeps
    # (the kernel reads no others), the queries and norms, the beams in and
    # out; beside it, the bound counting every block of every expansion
    beam_io = qc.numel() * 4 + chunk * 4 + 2 * chunk * ef * 8
    loop_bound_ms, loop_bound_by = bound(
        4.0 * fresh * d, "fp32", n_exp * r0h * 4 + fresh * d * 2 + beam_io)
    loop_bound_blocks_ms = bound(
        4.0 * n_exp * r0h * d, "fp32", n_exp * r0h * (d * 2 + 4) + beam_io)[0]
    print(f"beam_loop at [{chunk}] queries, ef={ef}, expand={hnsw.expand},"
          f" {mi13} steps: kernel {loop_ms:.4f} ms, plain {loop_plain_ms:.4f} ms;"
          f" {n_exp} expansions, {fresh} fresh rows; beam overlap"
          f" {chunk_overlap:.5f}; bound {loop_bound_ms:.4f} ms ({loop_bound_by};"
          f" {loop_bound_blocks_ms:.4f} ms counting every block)", flush=True)

    # 14. gather_rows: kernel vs table[idx], then the HNSW rescore's shape
    n_gather = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for d14 in (100, 384, 768):
            t14 = torch.randn(20011, d14, generator=gen, device="cuda") * 40
            t14 = t14.round().clamp(-127, 127).to(dtype)
            for m14 in (0, 1, 7, 1000, 4099, 65537):
                i14 = torch.randint(0, 20011, (m14,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                k14 = gather_rows_cuda(t14, i14)
                torch.cuda.synchronize()
                p14 = gather_rows_plain(t14, i14)
                check(k14.dtype == p14.dtype and k14.shape == p14.shape
                      and torch.equal(k14.view(torch.uint8), p14.view(torch.uint8)),
                      f"gather_rows differs from table[idx] ({dtype}, {d14}, {m14})")
                n_gather += 1
    off = gather_rows_cuda(t14, torch.tensor([-1, 20011, 5], dtype=torch.int32,
                                             device="cuda"))
    check(bool((off[:2].view(torch.uint8) == 255).all()) and torch.equal(off[2], t14[5]),
          "gather_rows: rows outside the table are not 0xFF")
    corpus = hnsw.store.vectors[:n]
    i14 = torch.randint(0, n, (nq * ef,), generator=gen, device="cuda", dtype=torch.int32)
    _build.reset_launches()
    rows14 = gather_rows(corpus, i14)
    torch.cuda.synchronize()
    gather_launches = _build.LAUNCHES["gather_rows"]
    check(gather_launches > 0, f"gather_rows launched {gather_launches} times")
    check(torch.equal(rows14.view(torch.uint8),
                      torch.index_select(corpus, 0, i14).view(torch.uint8)),
          "gather_rows differs from index_select at the rescore's shape")
    gather_ms = device_ms(lambda: gather_rows_cuda(corpus, i14), reps=20)
    gather_plain_ms = device_ms(lambda: gather_rows_plain(corpus, i14), reps=20)
    gather_library_ms = device_ms(lambda: torch.index_select(corpus, 0, i14), reps=20)
    gbytes = 2.0 * i14.numel() * d * 4 + i14.numel() * 4
    gather_bound_ms, gather_bound_by = bound(0.0, "fp32", gbytes)
    print(f"gather_rows: {n_gather} cases bitwise equal; {i14.numel()} x {d} f32"
          f" rows of {n}: kernel {gather_ms:.4f} ms ({gbytes / gather_ms / 1e6:.0f}"
          f" GB/s), plain {gather_plain_ms:.4f} ms, index_select"
          f" {gather_library_ms:.4f} ms; bound {gather_bound_ms:.4f} ms"
          f" ({gather_bound_by})", flush=True)

    # 15. the churn path at full width (bench.py:428-471) on phase 10's index
    wave15, kill15, ef15, nq15 = 2048, 1024, 32, 2048
    ext15 = ext[0] + n + np.arange(churn, dtype=np.int64)
    hnsw.beam_whole = False
    hnsw.wave_size = wave15
    hnsw.insert(ext15[:wave15], x15[:wave15])  # warm wave
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for s15 in range(wave15, churn, wave15):
        hnsw.insert(ext15[s15 : s15 + wave15], x15[s15 : s15 + wave15])
    torch.cuda.synchronize()
    incr_rate = (churn - wave15) / (time.perf_counter() - t0)
    wave_launches = dict(_build.LAUNCHES)
    n_waves = churn // wave15 - 1
    check(wave_launches["flat_topk"] == n_waves
          and wave_launches["flat_topk_mma"] == n_waves
          and sum(wave_launches.values()) == 2 * n_waves,
          f"{n_waves} insert waves launched {wave_launches}")
    # the last wave's candidate call: its rows against the rows up to the
    # high watermark, its own rows still invalid
    hw15 = hnsw.store.high_watermark
    cw = hnsw.store.vectors[:hw15]
    qw = cw[hw15 - wave15 :].clone()
    vw = hnsw.store.valid[:hw15].clone()
    vw[hw15 - wave15 :] = False

    dead15 = ext[: 8 * kill15]
    repair_calls = []
    real_flat_topk = hnsw_mod.flat_topk

    def recording(*args, **kwargs):
        repair_calls.append((args, kwargs))
        return real_flat_topk(*args, **kwargs)

    # the warm delete's repair calls, kept: its repair taken eager
    real_engine = hnsw_mod.repair_engine
    hnsw_mod.flat_topk = recording
    hnsw_mod.repair_engine = lambda *a: "eager"
    _build.reset_launches()
    try:
        hnsw.delete(dead15[:kill15])
    finally:
        hnsw_mod.flat_topk = real_flat_topk
        hnsw_mod.repair_engine = real_engine
    warm_del_launches = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for s15 in range(kill15, 8 * kill15, kill15):
        hnsw.delete(dead15[s15 : s15 + kill15])
    torch.cuda.synchronize()
    delete_rate = 7 * kill15 / (time.perf_counter() - t0)
    del_launches = dict(_build.LAUNCHES)
    check(del_launches["delete_repair"] == 7
          and sum(del_launches.values()) == del_launches["delete_repair"],
          f"7 delete waves launched {del_launches}")
    check(len(hnsw) == n + churn - 8 * kill15, f"churned count {len(hnsw)}")
    hnsw._flush_hi_wiring()
    valid15 = hnsw.store.valid.cpu().numpy()
    check(not valid15[: 8 * kill15].any() and valid15[8 * kill15 : n + churn].all(),
          "validity after churn")
    nb15 = hnsw.neighbors0.cpu().numpy()[valid15]
    hi15 = hnsw.hi_neighbors.cpu().numpy()
    for what, t15 in (("level-0", nb15), ("upper-level", hi15)):
        stale = int(((t15 >= 0) & ~valid15[np.maximum(t15, 0)]).sum())
        check(stale == 0, f"{stale} live {what} edges point at tombstones")
    part_empty = int((nb15 < 0).any(axis=1).sum())

    x_all = np.concatenate([x, x15])
    q15, qg15 = qq[:nq15], qg[:nq15]
    _, tslot = flat_topk(qg15, hnsw.store.vectors[:hw15], k, metric="cosine",
                         corpus_valid=hnsw.store.valid[:hw15])
    truth15 = hnsw.store.ids_of(tslot.cpu().numpy())

    def check_churn(cids, cd, what: str) -> float:
        """A search after churn: every query answered, no deleted id, each
        distance the exact float64 distance of its row, recall@k against
        exact highest over the live rows at least MIN_HNSW_RECALL."""
        check(cids.shape == (nq15, k) and bool((cids >= 0).all())
              and bool(np.isfinite(cd).all()), f"{what}: a missing result")
        check(not np.isin(cids, dead15).any(), f"{what}: a deleted id came back")
        true = dist64(np.repeat(q15, k, axis=0), x_all[(cids - ext[0]).reshape(-1)],
                      "cosine").reshape(nq15, k)
        np.testing.assert_allclose(cd, true, rtol=TOL, atol=TOL)
        rec = recall(cids, truth15)
        check(rec >= MIN_HNSW_RECALL, f"{what} recall@{k} {rec} < {MIN_HNSW_RECALL}")
        return rec

    # the table kept through churn, its marked rows re-gathered, against a
    # whole gather
    kept15 = hnsw._maybe_packed()
    check(kept15 is not None and torch.equal(
        kept15, hnsw._vecs16()[hnsw.neighbors0.clamp(min=0).long()]),
          "the packed table kept through churn is not a whole gather")
    del kept15
    churn15 = {}
    budget15 = hnsw.pack_budget_bytes
    for engine in ("row", "fused", "whole"):
        # the row path: no table within a zero budget
        hnsw.pack_budget_bytes = 0 if engine == "row" else budget15
        if engine != "whole":
            hnsw.pack_neighbors()
        hnsw.beam_whole = engine == "whole"
        _build.reset_launches()
        cids, cd = hnsw.search(q15, k=k, ef_search=ef15)
        torch.cuda.synchronize()
        launches15 = dict(_build.LAUNCHES)
        want = {"row": ("flat_topk", None), "fused": ("beam_step", "beam_loop"),
                "whole": ("beam_loop", "beam_step")}[engine]
        check(launches15["flat_topk"] > 0 and launches15[want[0]] > 0
              and (want[1] is None or launches15[want[1]] == 0)
              and launches15["beam_dots"] == 0
              and (engine != "row" or launches15["beam_step"] == 0),
              f"{engine} search after churn launches {launches15}")
        churn15[engine] = (check_churn(cids, cd, f"{engine} search after churn"),
                           device_ms(lambda: hnsw.search_device(qg15, k, ef15), reps=3),
                           launches15)
    hnsw.beam_whole = False
    pool15 = hnsw._routing_pool()
    step15 = beam_step_vs_plain(
        "search after churn", qg15,
        _route(qg15, pool15, hnsw._pool_vecs(pool15), "cosine",
               min(hnsw.route_entries, ef15)),
        hnsw._vecs16(), None, hnsw.neighbors0, hnsw._maybe_packed(), None, "cosine",
        ef15, hnsw.expand)
    print(f"{card_line()}: churn at 100k x 384, m={m}: incr_insert_vec_per_s"
          f" {incr_rate:.1f} ({n_waves} waves of {wave15}), delete_repair_per_s"
          f" {delete_rate:.1f} (7 deletes of {kill15}); {len(hnsw)} live rows,"
          f" {part_empty} of them with a part-empty neighbour row; launches per"
          f" {n_waves} waves {wave_launches}, per 7 deletes {del_launches}",
          flush=True)
    for engine, (rec, ms15, l15) in churn15.items():
        print(f"  {engine} search after churn, {nq15} queries, ef={ef15}:"
              f" churn_recall_at_10 {rec}; {ms15:.3f} ms"
              f" ({nq15 / ms15 * 1e3:.0f} QPS); launches {l15}", flush=True)

    # the kernels against plain at the slice's shapes: the last wave's call
    kdw, kiw = flat_topk_cuda(qw, cw, hnsw.m0, metric="cosine", corpus_valid=vw,
                              precision="default")
    torch.cuda.synchronize()
    pdw, piw = flat_topk_plain(qw, cw, hnsw.m0, metric="cosine", corpus_valid=vw,
                               precision="default")
    bf_err = max(bf_err, compare(kdw, kiw, pdw, piw, qw, cw, vw, "cosine",
                                 ref=dist64_bf16))
    wave_ms = device_ms(lambda: flat_topk(qw, cw, hnsw.m0, metric="cosine",
                                          corpus_valid=vw, precision="default"))
    wave_plain_ms = device_ms(lambda: flat_topk_plain(
        qw, cw, hnsw.m0, metric="cosine", corpus_valid=vw, precision="default"))
    wave_library_ms = device_ms(lambda: bf16_library(qw, cw, vw, hnsw.m0))
    wave_bound, wave_bound_by = bound(
        2.0 * wave15 * hw15 * d, "bf16",
        4.0 * (hw15 + wave15) * d + hw15 + 8.0 * wave15 * hnsw.m0)
    # a repair call of the warm delete: affected rows against the pool
    (rq, rc, rk), rkw = repair_calls[0]
    check(rkw["precision"] == "highest" and rk == hnsw.m0 + 1,
          f"the repair call's k {rk}, {rkw}")
    kdr, kir = flat_topk_cuda(rq, rc, rk, metric="cosine")
    torch.cuda.synchronize()
    pdr, pir = flat_topk_plain(rq, rc, rk, metric="cosine")
    repair_err = compare(kdr, kir, pdr, pir, rq, rc, None, "cosine")
    all_rc = torch.ones(rc.shape[0], dtype=torch.bool, device="cuda")
    repair_ms = device_ms(lambda: flat_topk(rq, rc, rk, metric="cosine"))
    repair_plain_ms = device_ms(lambda: flat_topk_plain(rq, rc, rk, metric="cosine"))
    repair_library_ms = device_ms(lambda: f32_library(rq, rc, all_rc, rk))
    repair_bound, repair_bound_by = bound(
        2.0 * rq.shape[0] * rc.shape[0] * d, "fp32",
        4.0 * (rq.shape[0] + rc.shape[0]) * d + 8.0 * rq.shape[0] * rk)
    # an all-masked corpus: the first wave into an empty index
    none_valid = torch.zeros(wave15, dtype=torch.bool, device="cuda")
    for prec, km in (("default", hnsw.m0), ("highest", hnsw.m0 + 1)):
        for fn in (flat_topk_cuda, flat_topk_plain):
            md, mi = fn(qw, qw, km, metric="cosine", corpus_valid=none_valid,
                        precision=prec)
            torch.cuda.synchronize()
            check(bool(torch.isinf(md).all() and (mi == -1).all()),
                  f"{fn.__name__} ({prec}) over an all-masked corpus")
    print(f"flat_topk at the churn's calls: wave [{wave15}, {d}] x [{hw15}, {d}]"
          f" bf16, k={hnsw.m0}, {int(vw.sum())} valid: kernel {wave_ms:.4f} ms,"
          f" plain {wave_plain_ms:.4f} ms, library {wave_library_ms:.4f} ms; bound"
          f" {wave_bound:.4f} ms ({wave_bound_by}); repair [{rq.shape[0]}, {d}] x"
          f" [{rc.shape[0]}, {d}] highest, k={rk} ({len(repair_calls)} calls in the"
          f" warm delete): kernel {repair_ms:.4f} ms, plain {repair_plain_ms:.4f} ms,"
          f" library {repair_library_ms:.4f} ms; bound {repair_bound:.4f} ms"
          f" ({repair_bound_by}); max |d| error {repair_err:.3g}; an all-masked"
          f" corpus gives (inf, -1) in both modes", flush=True)
    del cw, qw, vw, kdw, pdw, repair_calls, rq, rc

    # beam_loop on a chunk of the churned graph: tombstones and part-empty rows
    pool15 = hnsw._routing_pool()
    r15 = min(hnsw.route_entries, ef15)
    ent = _route(qc, pool15, hnsw._pool_vecs(pool15), hnsw.metric, r15)
    init_d = torch.full((chunk, ef15), torch.inf, device="cuda")
    init_i = torch.full((chunk, ef15), -1, dtype=torch.int32, device="cuda")
    init_d[:, :r15] = torch.where(
        ent >= 0, gathered_distances(qc, hnsw._vecs16()[ent.clamp(min=0).long()].float(),
                                     "cosine"), torch.inf)
    init_i[:, :r15] = ent
    args15 = (qc, init_d, init_i, hnsw._maybe_packed(), hnsw.neighbors0, "cosine",
              ef15, hnsw.expand, 0, -(-ef15 // hnsw.expand) + 1)
    kd15, ki15 = beam_loop_cuda(*args15)
    torch.cuda.synchronize()
    pd15, pi15, _, _ = beam_loop_plain(*args15)
    churn_overlap = beam_overlap(ki15, pi15)
    check(churn_overlap >= 0.99, f"beam_loop: churned-graph beam overlap {churn_overlap}")
    loop_err = max(loop_err, agreeing_err(kd15, ki15, pd15, pi15))
    print(f"beam_loop on the churned graph, [{chunk}] queries, ef={ef15}: beam"
          f" overlap {churn_overlap:.5f}", flush=True)

    # waves into an empty index: the first one's corpus is all masked
    empty15 = HnswIndex(d, "cosine", m=m, wave_size=wave15, capacity=4096, seed=42,
                      device="cuda")
    _build.reset_launches()
    empty15.insert(ext[:3000], x[:3000])
    torch.cuda.synchronize()
    check(_build.LAUNCHES["flat_topk_mma"] == 2 and len(empty15) == 3000,
          f"two waves into an empty index launched {dict(_build.LAUNCHES)}")
    nbf = empty15.neighbors0[:3000]
    check(bool((nbf[:, 0] >= 0).all() and (nbf < 3000).all()),
          "a row of the first waves without neighbours")
    fids, _ = empty15.search(qq[:64], k=k)
    check(bool((fids >= 0).all()), "search after waves into an empty index")
    del empty15, nbf

    # 16. the IVF path at bench.py's north-star shape, and checkpoints
    ivf16 = ivf_phase(x, qq, hnsw, bf16_library, k)

    # 17. the graph core at graph_scale's sizes (no hand-written kernel)
    native_build.join()
    graph17 = graph_phase()
    print(json.dumps({"graph": graph17}))

    # 18. the rest of the graph layer at BASELINE.json configs[4] (no
    # hand-written kernel)
    graph18 = graph_analytics_phase()
    print(json.dumps({"graph_analytics": graph18}))

    # 19. Node2Vec at BASELINE.json configs[3], its embeddings indexed into
    # HnswIndex (no kernel of its own; the index's two at d = 64)
    n2v19 = node2vec_phase()
    print(json.dumps({"node2vec": n2v19}))

    # 20. the delete's repair at the churn cell's shape
    rep20 = delete_repair_phase(x)
    print(json.dumps({"delete_repair": rep20}))

    print(json.dumps({"kernels": [{
        "name": "flat_topk",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/flat_topk.cu",
        "replaces": "muninn_tpu/ops/pallas_flat.py:49",
        "launches": launches,
        "max_abs_err": max(max_err, main_err, err5, repair_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": f32_bound,
        "bound_by": f32_bound_by,
        "library_ms": library_ms,
        "gemm_ms": gemm_ms,
        "ms_1m_768": ms5,
        "plain_ms_1m_768": plain_ms5,
        "bound_ms_1m_768": bound5,
        "library_ms_1m_768": library_ms5,
        "gemm_ms_1m_768": gemm_ms5,
        "launches_repair_eager_delete": warm_del_launches["flat_topk"],
        "ms_repair": repair_ms,
        "plain_ms_repair": repair_plain_ms,
        "bound_ms_repair": repair_bound,
        "bound_by_repair": repair_bound_by,
        "library_ms_repair": repair_library_ms,
    }, {
        "name": "flat_topk_bf16",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/flat_topk_mma.cu",
        "replaces": "muninn_tpu/ops/pallas_flat.py:49",
        "launches": bf_launches,
        "launches_hnsw_build_and_search": hnsw_launches["flat_topk_mma"],
        "max_abs_err": bf_err,
        "ms": ms_def,
        "plain_ms": plain_ms_def,
        "bound_ms": bound_def,
        "bound_by": bound_def_by,
        "library_ms": library_ms_def,
        "gemm_ms": gemm_ms_def,
        "launches_15_waves": wave_launches["flat_topk_mma"],
        "ms_wave": wave_ms,
        "plain_ms_wave": wave_plain_ms,
        "bound_ms_wave": wave_bound,
        "bound_by_wave": wave_bound_by,
        "library_ms_wave": wave_library_ms,
        "launches_ivf_search": ivf16["launches"]["flat_topk_mma"],
        "max_abs_err_ivf_probe": ivf16["probe_err"],
        "launches_node2vec_hnsw_build": n2v19["launches"]["flat_topk_mma"],
        "max_abs_err_n2v_build": n2v19["flat_max_abs_err"],
        "ms_n2v_build": n2v19["flat_ms"],
        "plain_ms_n2v_build": n2v19["flat_plain_ms"],
        "bound_ms_n2v_build": n2v19["flat_bound_ms"],
        "bound_by_n2v_build": n2v19["flat_bound_by"],
        "library_ms_n2v_build": n2v19["flat_library_ms"],
        "ms_ivf_probe": ivf16["probe_ms"],
        "plain_ms_ivf_probe": ivf16["probe_plain_ms"],
        "bound_ms_ivf_probe": ivf16["probe_bound_ms"],
        "bound_by_ivf_probe": ivf16["probe_bound_by"],
        "library_ms_ivf_probe": ivf16["probe_library_ms"],
    }, {
        "name": "flat_topk_int8",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/flat_topk_mma.cu",
        "replaces": "muninn_tpu/ops/pallas_flat.py:74",
        "launches": i8_launches,
        "launches_quantized_path": quant_launches,
        "max_abs_err": i8_err,
        "ms": i8_ms,
        "plain_ms": i8_plain_ms,
        "bound_ms": i8_bound,
        "bound_by": i8_bound_by,
        "library_ms": i8_library_ms,
        "gemm_ms": i8_gemm_ms,
    }, {
        "name": "beam_dots",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/beam_dots.cu",
        "replaces": "muninn_tpu/ops/pallas_beam.py:46",
        "launches": hnsw_launches["beam_dots"],
        "max_abs_err": beam_err,
        "ms": beam_ms,
        "plain_ms": beam_plain_ms,
        "bound_ms": beam_bound_ms,
        "bound_by": beam_bound_by,
        "library_ms": None,
        "bound_share": beam_bound_ms / beam_ms,
        "launches_ivf_search": ivf16["launches"]["beam_dots"],
        "max_abs_err_ivf": ivf16["beam_err"],
        "ms_ivf": ivf16["beam_ms"],
        "plain_ms_ivf": ivf16["beam_plain_ms"],
        "bound_ms_ivf": ivf16["beam_bound_ms"],
        "bound_by_ivf": ivf16["beam_bound_by"],
        "bound_ms_ivf_per_pick": ivf16["beam_bound_ms_per_pick"],
        "launches_ivf_int8_search": ivf16["launches_int8"]["beam_dots_int8"],
        "max_abs_err_ivf_int8": ivf16["beam_err_int8"],
        "ms_ivf_int8": ivf16["beam_ms_int8"],
        "plain_ms_ivf_int8": ivf16["beam_plain_ms_int8"],
        "bound_ms_ivf_int8": ivf16["beam_bound_ms_int8"],
        "bound_by_ivf_int8": ivf16["beam_bound_by_int8"],
        "bound_ms_ivf_per_pick_int8": ivf16["beam_bound_ms_per_pick_int8"],
    }, {
        "name": "beam_step",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/beam_step.cu",
        "replaces": "muninn_tpu/ops/pallas_beam.py:46 and the XLA glue of"
                    " muninn_tpu/index/hnsw.py:271-416",
        "launches": hnsw_launches["beam_step"],
        "launches_int8": hnsw8_launches["beam_step"],
        "launches_churn_search": churn15["fused"][2]["beam_step"],
        "launches_n2v_self_search": n2v19["search_launches"]["beam_step"],
        "max_abs_err": 0.0,
        "shape": step10["shape"],
        "steps": step10["steps"],
        "ms": step10["ms"],
        "plain_ms": step10["plain_ms"],
        "bound_ms": step10["bound_ms"],
        "bound_by": step10["bound_by"],
        "library_ms": None,
        "bound_share": step10["bound_ms"] / step10["ms"],
        **{f"{field}_{tag}": st[field]
           for tag, st in (("int8", step11), ("churn", step15),
                           ("n2v", n2v19["beam_step"]))
           for field in ("shape", "steps", "ms", "plain_ms", "bound_ms", "bound_by")},
    }, {
        "name": "beam_topm",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/beam_dots.cu",
        "replaces": "muninn_tpu/ops/pallas_beam.py:214",
        "launches": topm_launches["beam_topm"],
        "max_abs_err": topm_err,
        "ms": topm_ms,
        "plain_ms": topm_plain_ms,
        "bound_ms": topm_bound_ms,
        "bound_by": topm_bound_by,
        "library_ms": None,
        "bound_share": topm_bound_ms / topm_ms,
        "search_ms": topm_search_ms,
        "fused_search_ms": fused12_ms,
        "recall": topm_recall,
    }, {
        "name": "beam_loop",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/beam_loop.cu",
        "replaces": "muninn_tpu/ops/pallas_beam_loop.py:91",
        "launches": whole_launches["beam_loop"],
        "max_abs_err": loop_err,
        "ms": loop_ms,
        "plain_ms": loop_plain_ms,
        "bound_ms": loop_bound_ms,
        "bound_by": loop_bound_by,
        "library_ms": None,
        "bound_ms_all_blocks": loop_bound_blocks_ms,
        "bound_share": loop_bound_ms / loop_ms,
        "expansions": n_exp,
        "fresh_rows": fresh,
        "search_ms": whole_search_ms,
        "fused_search_ms": fused13_ms,
        "recall": whole_recall,
        "launches_churn_search": churn15["whole"][2]["beam_loop"],
        "churn_beam_overlap": churn_overlap,
    }, {
        "name": "gather_rows",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/gather_rows.cu",
        "replaces": "muninn_tpu/ops/pallas_gather.py:36",
        "launches": gather_launches,
        "max_abs_err": 0.0,
        "ms": gather_ms,
        "plain_ms": gather_plain_ms,
        "bound_ms": gather_bound_ms,
        "bound_by": gather_bound_by,
        "library_ms": gather_library_ms,
    }, {
        "name": "delete_repair",
        "route": "cuda",
        "source": "muninn_tpu_torch/csrc/delete_repair.cu",
        "replaces": "the XLA glue of muninn_tpu/index/hnsw.py:1860-1896 around"
                    " muninn_tpu/ops/pallas_flat.py:49 (highest)",
        "launches": rep20["launches_per_wave"],
        "launches_churn_7_deletes": del_launches["delete_repair"],
        "max_abs_err": 0.0,
        **{key: rep20[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "bound_share")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
