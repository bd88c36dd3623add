"""Where the time of the HNSW beam kernels goes, on one CUDA card.

    python3 tools/probes/beam_probe.py [--parent DIR]

Three parts, all at chip_smoke.py's shapes (HNSW cosine 100k x 384, m=16,
expand=8, ef=24, on its data recipe; one 2,816-query chunk):

1. ``beam_loop`` (csrc/beam_loop.cu) at phase 13's chunk shape: the kernel,
   stubbed variants (``noscore``: a made-up distance instead of reading the
   kept rows; ``nodedup``: every third candidate kept, no duplicate test),
   and a ``timed`` variant that adds the SM cycles of each phase of each
   block step into device counters (thread 0 reads ``clock64`` after each
   phase's closing barrier), printed as shares of the block time.
2. ``beam_dots`` (csrc/beam_dots.cu) at phase 10/11's chunk shape, bf16
   and int8 blocks, and the top-m mode at phase 12's: the kernel and
   variants with the row loads replaced by made-up words (``noload``) or
   the multiply-adds by a sink that keeps the loads (``nofma``).
   Both kernels also with 64, 128 or 256 threads a block (``t64``,
   ``t128``, ``t256``: those the source does not use), with a register cap
   (``lb4``: 4 blocks of 256 threads an SM; ``lb6``: 6 of 128), and with 1
   or 4 row groups a warp (``g1``, ``g4``) and 4 or 8 loads a lane and row
   in a pass (``u4``, ``u8``) where the source has those knobs. Since
   ``beam_loop``'s phases moved to csrc/beam_phases.cuh (shared with
   ``beam_step``), its block size and its dedup lie in that header: its
   current text has no ``t<n>`` and no ``nodedup`` variants.
3. The whole-beam HNSW search (``beam_whole = True``, 8,192 queries) with
   each tree's ``beam_loop``, then under ``torch.profiler``: the device's
   busy time and idle share as it runs, and the kernel time of routing
   (``_route``), entry scoring, ``beam_loop`` and the rescore, each run
   between synchronizes.

Variants are built from the source's text under build/probe_src/, never as
options of the kernels (a variant of csrc/block_rows.cuh is written beside
them and included in its place). ``--parent DIR`` also builds DIR's
``muninn_tpu_torch/csrc`` beam sources (a checkout of an earlier commit,
e.g. unpacked by ``git archive`` under build/) and times them in turns with
this tree's: parent, this, this, parent. Times are CUDA-event medians
(chip_smoke.device_ms); every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402
from muninn_tpu_torch import HnswIndex  # noqa: E402
from muninn_tpu_torch.index import hnsw as hnsw_mod  # noqa: E402
from muninn_tpu_torch.ops import _build, beam  # noqa: E402
from muninn_tpu_torch.ops import beam_loop as loop_mod  # noqa: E402
from muninn_tpu_torch.ops.distance import gathered_distances  # noqa: E402

# counters 0-5: the phases of a step; 6: whole blocks; 7: block steps
TIMER = """
__device__ unsigned long long g_phase[8];
#define PHASE(k) if (threadIdx.x == 0) { const long long t_ = clock64(); \\
  atomicAdd(&g_phase[k], (unsigned long long)(t_ - t_last)); t_last = t_; }
"""
TIMER_READ = """
extern "C" int beam_probe_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
"""

# Each kernel generation's anchors, the first whose `marker` the source
# holds: the step loop's head and the kernel's end for the timer, the line
# each phase ends before (names in order; the last ends the step), and the
# variants: edits of the source, each (old, new, times found), and of
# block_rows.cuh where the rows are scored there.
LOOP_GENS = [{
    # the phases in csrc/beam_phases.cuh, shared with beam_step.cu: the dedup
    # lies in the header, so this generation has no nodedup variant
    "marker": "score_contenders<__nv_bfloat16, kGroups, kUnits>(",
    "start": "  const size_t b = blockIdx.x;\n",
    "step": "  for (int it = 0; it < max_iters; ++it) {\n",
    "phases": [("pick", "    // candidates:"), ("ids", "    // dedup:"),
               ("dedup", "    // score:"), ("score", "    // rank:"),
               ("rank", "    // merge:"),
               ("merge", "  }\n  for (int p = tid; p < ef; p += kThreads) {\n"
                         "    out_d[b * ef + p] = p < nfin")],
    "end": "  for (int p = tid; p < ef; p += kThreads) {\n    out_d[b * ef + p] = p < nfin",
    "noscore": [(("    score_contenders<__nv_bfloat16, kGroups, kUnits>(", "        });\n"),
                 """    for (int r = tid; r < nk; r += kThreads) {
      const float d = (float)(s.kl[r] & 1023) * 1e-3f;
      if (d < thr) {
        const int at = atomicAdd(&s.sc[1], 1);
        s.kd[at] = d;
        s.kx[at] = r;
      }
    }
    __syncthreads();
""", 1)],
}, {
    "marker": "pick: the first E unexpanded entries with a slot",  # sorted beam
    "start": "  const size_t b = blockIdx.x;\n",
    "step": "  for (int it = 0; it < max_iters; ++it) {\n",
    "phases": [("pick", "    // candidates:"), ("ids", "    // dedup:"),
               ("dedup", "    // score:"), ("score", "    // rank:"),
               ("rank", "    // merge:"),
               ("merge", "  }\n  for (int p = tid; p < ef; p += kThreads) {\n"
                         "    out_d[b * ef + p] = p < nfin")],
    "end": "  for (int p = tid; p < ef; p += kThreads) {\n    out_d[b * ef + p] = p < nfin",
    "noscore": [(("    block_rows::score_rows<__nv_bfloat16, kGroups, kUnits>(", "        });\n"),
                 """    for (int s = tid; s < nk; s += kThreads) {
      const float d = (float)(kl[s] & 1023) * 1e-3f;
      if (d < thr) {
        const int at = atomicAdd(&sc[1], 1);
        kd[at] = d;
        kx[at] = s;
      }
    }
""", 1)],
    "nodedup": [("if (h >= 0 && hv[h] == j0 + t)", "if (h >= 0 && (j0 + t) % 3 == 0)", 1)],
}, {
    "marker": "rank each unexpanded live entry among the others",  # rank counting
    "start": "  const size_t b = blockIdx.x;\n",
    "step": "  for (int it = 0; it < max_iters; ++it) {\n",
    "phases": [("pick", "    // the picks' neighbour ids"),
               ("ids", "    // dedup: drop ids"),
               ("dedup", "    // score the kept candidates"),
               ("score", "    // merge: rank each"),
               ("merge", "    // fill-aware improvement"),
               ("counts", "  }\n  for (int p = tid; p < ef; p += kThreads) {\n"
                          "    out_d[b * ef + p] = bd[p];")],
    "end": "  for (int p = tid; p < ef; p += kThreads) {\n    out_d[b * ef + p] = bd[p];",
    "noscore": [("""      float dot, sq;
      row_dot(packed + ((size_t)bi[pk[i]] * R0 + (j - i * R0)) * D, qs, D, vec,
              lane, dot, sq);
      if (lane == 0) cd[j] = metric_distance(dot, sq, q2, mode);""",
                 "      if (lane == 0) cd[j] = (float)(ci[j] & 1023) * 1e-3f + (float)i;", 1)],
    "nodedup": [("""      for (int p = 0; k && p < ef; ++p) k = bi[p] != id;
      for (int o = 0; k && o < j; ++o) k = ci[o] != id;""",
                 "      k = k && j % 3 == 0;", 1)],
}]
LOADS = "// The loads of one row: 16-byte units (kVec) or single elements."
SINK = """template <typename X>
__device__ __forceinline__ float probe_sink(X x) { return static_cast<float>(x); }
__device__ __forceinline__ float probe_sink(const uint4& w) {
  return __uint_as_float((w.x ^ w.y ^ w.z ^ w.w) & 0x007fffffu);
}

""" + LOADS
DOTS_GENS = [{
    "marker": "block_rows::score_rows",  # the rows scored in block_rows.cuh
    "header": {
        "noload": [("w[g][s] = __ldg(src[g] + u);",
                    "w[g][s] = *reinterpret_cast<const W*>(q);", 1)],
        "nofma": [(LOADS, SINK, 1),
                  ("if (src[g] != nullptr) Elem<T>::add(w[g][s], qu, dot[g], sq[g]);",
                   "if (src[g] != nullptr) dot[g] += probe_sink(w[g][s]);", 2)],
    },
}, {
    "marker": "unpack(__ldg(rv + v), x, row);",  # one row a warp
    "noload": [("unpack(__ldg(rv + v), x, row);",
                "unpack(make_uint4(v, lane, v ^ lane, 0x3f800000u), x, row);", 1)],
    "nofma": [("unpack(__ldg(rv + v), x, row);",
               "const uint4 w_ = __ldg(rv + v);\n"
               "      dot += __uint_as_float((w_.x ^ w_.y ^ w_.z ^ w_.w) & 0x007fffffu);\n"
               "      continue;", 1)],
}]
# every generation: 64, 128 or 256 threads a block (those the source does
# not have), at most 64 registers a thread at 256 threads (4 blocks an SM),
# at most 85 at 128 (6 blocks); where the source has the knobs, 1 or 4 row
# groups a warp, 4 or 8 loads a lane and row
LB = "__launch_bounds__(kThreads)"
KNOB_VARIANTS = {
    "lb4": [(LB, "__launch_bounds__(kThreads, 4)", None)],
    "lb6": [(LB, "__launch_bounds__(kThreads, 6)", None)],
    "g1": [("constexpr int kGroups = 2;", "constexpr int kGroups = 1;", 1)],
    "g4": [("constexpr int kGroups = 2;", "constexpr int kGroups = 4;", 1)],
    "u4": [("constexpr int kUnits = 8;", "constexpr int kUnits = 4;", 1)],
    "u8": [("constexpr int kUnits = 4;", "constexpr int kUnits = 8;", 1)],
}


def sub(text: str, old, new: str, times: int | None = 1) -> str:
    """``text`` with ``old`` replaced by ``new``; ``old`` must be found
    ``times`` times (None: at least once). ``old`` may be a pair (start,
    end): the span from start through the first end after it, found once."""
    if isinstance(old, tuple):
        start, end = old
        if text.count(start) != 1:
            raise RuntimeError(f"probe: the kernel source changed; {start!r} not found once")
        i = text.index(start)
        j = text.index(end, i) + len(end)
        return text[:i] + new + text[j:]
    n = text.count(old)
    if n == 0 or (times is not None and n != times):
        raise RuntimeError(f"probe: the kernel source changed; {old!r} found {n} times")
    return text.replace(old, new)


def gen_of(text: str, gens: list[dict]) -> dict:
    for g in gens:
        if g["marker"] in text:
            return g
    raise RuntimeError("probe: no anchor set matches the kernel source")


def edits(text: str, triples) -> str:
    for old, new, times in triples:
        text = sub(text, old, new, times)
    return text


def shape_variants(src: str) -> dict[str, str]:
    # a source whose block size lies in csrc/beam_phases.cuh (128 threads)
    # keeps it: no t<n> variants
    threads = re.search(r"constexpr int kThreads = (\d+);", src)
    out = {} if threads is None else {
        f"t{n}": src.replace(threads.group(0), f"constexpr int kThreads = {n};")
        for n in (64, 128, 256) if str(n) != threads.group(1)}
    knobs = dict(KNOB_VARIANTS)
    del knobs["lb4" if threads is None or threads.group(1) == "128" else "lb6"]
    out.update({v: edits(src, e) for v, e in knobs.items()
                if all(old in src for old, _, _ in e)})
    return out


def loop_variants(src: str, header: str) -> dict[str, tuple[str, str | None]]:
    g = gen_of(src, LOOP_GENS)
    timed = sub(src, "#include <stdint.h>\n", "#include <stdint.h>\n" + TIMER)
    timed = sub(timed, g["start"], g["start"] + "  const long long t_start = clock64();\n")
    timed = sub(timed, g["step"], g["step"] + "    long long t_last = clock64();\n")
    last = len(g["phases"]) - 1
    for k, (_, anchor) in enumerate(g["phases"]):
        count = ("    if (threadIdx.x == 0) atomicAdd(&g_phase[7], 1ull);\n"
                 if k == last else "")
        timed = sub(timed, anchor, f"    PHASE({k});\n{count}{anchor}")
    timed = sub(timed, g["end"], "  if (threadIdx.x == 0) atomicAdd(&g_phase[6],"
                " (unsigned long long)(clock64() - t_start));\n" + g["end"])
    out = {"timed": (timed + TIMER_READ, None)}
    out.update({v: (edits(src, g[v]), None) for v in ("noscore", "nodedup") if v in g})
    out.update({v: (t, None) for v, t in shape_variants(src).items()})
    return out


def dots_variants(src: str, header: str) -> dict[str, tuple[str, str | None]]:
    g = gen_of(src, DOTS_GENS)
    if "header" in g:
        out = {v: (src, edits(header, e)) for v, e in g["header"].items()}
    else:
        out = {v: (edits(src, g[v]), None) for v in ("noload", "nofma")}
    out.update({v: (t, None) for v, t in shape_variants(src).items()})
    return out


def build_variants(csrc: Path, tag: str) -> tuple[dict, Path]:
    """Write this source tree's beam sources and their variants under
    build/probe_src/ as ``<kernel>_<tag>[_<variant>].cu`` (a variant of the
    shared header as ``block_rows_<tag>_<variant>.cuh``, included in its
    place); return the names of each kernel's builds."""
    probe_dir = _build.BUILD_DIR.parent / "probe_src"
    probe_dir.mkdir(parents=True, exist_ok=True)
    header_path = csrc / "block_rows.cuh"
    header = header_path.read_text() if header_path.is_file() else ""
    names = {}
    for kernel, make in (("beam_loop", loop_variants), ("beam_dots", dots_variants)):
        src = (csrc / f"{kernel}.cu").read_text()
        if header:  # this tree's header, not the build's -I csrc one
            (probe_dir / f"block_rows_{tag}.cuh").write_text(header)
            src = src.replace('#include "block_rows.cuh"', f'#include "block_rows_{tag}.cuh"')
        names[kernel] = {"": f"{kernel}_{tag}"}
        (probe_dir / f"{kernel}_{tag}.cu").write_text(src)
        for v, (text, hdr) in make(src, header).items():
            name = f"{kernel}_{tag}_{v}"
            if hdr is not None:
                (probe_dir / f"block_rows_{tag}_{v}.cuh").write_text(hdr)
                text = text.replace(f'#include "block_rows_{tag}.cuh"',
                                    f'#include "block_rows_{tag}_{v}.cuh"')
            names[kernel][v] = name
            (probe_dir / f"{name}.cu").write_text(text)
    return names, probe_dir


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose beam kernels are timed beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("beam_probe: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    trees = [("this", _build.CSRC_DIR)]
    if args.parent is not None:
        trees.insert(0, ("parent", args.parent / "muninn_tpu_torch" / "csrc"))
    builds, probe_dir = {}, None
    for tag, csrc in trees:
        builds[tag], probe_dir = build_variants(csrc, tag)
    _build.load_all(["flat_topk_mma", "beam_dots", "beam_loop"])
    csrc_dir = _build.CSRC_DIR
    try:
        _build.CSRC_DIR = probe_dir
        _build.load_all([n for b in builds.values() for k in b.values() for n in k.values()])
    finally:
        _build.CSRC_DIR = csrc_dir
    real = {k: _build._LIBS[k] for k in ("beam_loop", "beam_dots")}

    def use(kernel: str, name: str | None) -> None:
        lib = real[kernel] if name is None else _build._LIBS[name]
        if kernel == "beam_loop":
            loop_mod._LIB = loop_mod._bind(lib)
        else:
            _build._LIBS[kernel] = lib
            beam._LIB = None
            beam._library()

    # the HNSW index and chunk of chip_smoke.py phases 10-13
    n, d, nq, k, ef, chunk = 100_000, 384, 8192, 10, 24, 2816
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, qg = cs.clustered_on_device(gen, n, d, 1000, nq)
    hnsw = HnswIndex(d, "cosine", m=16, ef_construction=200, capacity=n + 32_768 + 4096,
                     seed=42, expand=8, wave_size=4096, device="cuda")
    hnsw.insert(torch.arange(n).numpy(), x)
    hnsw.pack_neighbors()
    packed = hnsw._maybe_packed()
    qc = qg[:chunk]
    pool = hnsw._routing_pool()
    pv = hnsw._pool_vecs(pool)
    picks = hnsw_mod._route(qc, pool, pv, hnsw.metric, hnsw.route_entries)
    r = min(hnsw.route_entries, ef)
    ent = picks[:, :r]
    init_d = torch.full((chunk, ef), torch.inf, device="cuda")
    init_i = torch.full((chunk, ef), -1, dtype=torch.int32, device="cuda")
    init_d[:, :r] = torch.where(ent >= 0, gathered_distances(
        qc, hnsw._vecs16()[ent.clamp(min=0).long()].float(), "cosine"), torch.inf)
    init_i[:, :r] = ent
    mi = -(-ef // hnsw.expand) + 1
    largs = (qc, init_d, init_i, packed, hnsw.neighbors0, "cosine", ef, hnsw.expand, 0, mi)
    _, _, n_exp, fresh = loop_mod.beam_loop_plain(*largs)
    nb = hnsw.neighbors0[picks.clamp(min=0).long()].reshape(chunk, -1)
    pen = torch.where((nb[:, :, None] == picks[:, None, :]).any(dim=2) | (nb < 0),
                      beam.BIG, 0.0)
    hnsw.search_quant = "int8"
    hnsw.pack_neighbors()
    packed8 = hnsw._maybe_packed()
    hnsw.search_quant = "bf16"
    hnsw.pack_neighbors()
    print(f"{card}; chunk {chunk} queries, picks {tuple(picks.shape)}, blocks"
          f" {tuple(packed.shape)}; beam_loop: ef={ef}, expand={hnsw.expand},"
          f" {mi} steps, {n_exp} expansions, {fresh} fresh rows", flush=True)

    runs = {
        "beam_loop": ("beam_loop", lambda: loop_mod.beam_loop_cuda(*largs)),
        "beam_dots bf16": ("beam_dots", lambda: beam.gather_block_dots_cuda(qc, picks, packed)),
        "beam_dots int8": ("beam_dots", lambda: beam.gather_block_dots_cuda(qc, picks, packed8)),
        "beam_topm m=12": ("beam_dots", lambda: beam.gather_block_topm_cuda(
            qc, picks, packed, pen, "cosine", 12)),
    }
    order = [t for t, _ in trees]
    if len(order) == 2:
        order = ["parent", "this", "this", "parent"]
    for tag in order:
        for what, (kernel, fn) in runs.items():
            for v, name in builds[tag][kernel].items():
                if v == "timed":
                    continue
                use(kernel, name)
                ms = cs.device_ms(fn, reps=20)
                print(f"{card}; {tag} {what} {v or 'kernel'}: {ms:.4f} ms", flush=True)
            use(kernel, None)

    # the timed beam_loop: cycles of each phase, summed over blocks
    for tag in dict.fromkeys(order):
        name = builds[tag]["beam_loop"]["timed"]
        lib = _build._LIBS[name]
        lib.beam_probe_phases.argtypes = [ctypes.c_void_p]
        use("beam_loop", name)
        buf = (ctypes.c_ulonglong * 8)()
        lib.beam_probe_phases(buf)  # zero the counters
        loop_mod.beam_loop_cuda(*largs)
        torch.cuda.synchronize()
        rc = lib.beam_probe_phases(buf)
        if rc != 0:
            raise RuntimeError(f"beam_probe_phases failed: CUDA error {rc}")
        gname = gen_of((probe_dir / f"{name}.cu").read_text(), LOOP_GENS)["phases"]
        total, steps = buf[6], buf[7]
        split = ", ".join(f"{p} {buf[i] / total:.1%} ({buf[i] / max(steps, 1):.0f} cyc/step)"
                          for i, (p, _) in enumerate(gname))
        print(f"{card}; {tag} beam_loop phases, share of block cycles"
              f" ({total / chunk:.0f} cycles a block, {steps} block steps): {split}",
              flush=True)
        use("beam_loop", None)

    # the whole-beam search with each tree's kernel, in turns
    hnsw.beam_whole = True
    for tag in order:
        use("beam_loop", builds[tag]["beam_loop"][""])
        ms = cs.device_ms(lambda: hnsw.search_device(qg, k, ef), reps=5)
        print(f"{card}; {tag} whole-beam search, {nq} queries: {ms:.3f} ms", flush=True)
    use("beam_loop", None)

    # one whole-beam search under the profiler: as it runs (the device's
    # busy time and idle share), then with each part between synchronizes
    # (each part's kernel time, from the kernels inside its host range)
    parts = {"routing": "_route", "beam_loop": "beam_loop", "rescore": "_rescore_topk",
             "chunk": "_search_topk_whole"}
    saved = {attr: getattr(hnsw_mod, attr) for attr in parts.values()}
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kind = torch.autograd.DeviceType.CUDA

    def fenced(label, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            with torch.profiler.record_function(f"probe:{label}"):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return call

    def union_ms(spans) -> float:
        busy, last = 0.0, float("-inf")
        for s, t in sorted(spans):
            busy += max(0.0, t - max(s, last))
            last = max(last, t)
        return busy / 1e3

    def device_spans(prof) -> list[tuple[float, float]]:
        """The device's kernels and copies (not the ranges' device-side
        annotations), in microseconds."""
        return [(e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == kind and not e.name.startswith("probe:")]

    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        hnsw.search_device(qg, k, ef)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls[1:])[2]
    with torch.profiler.profile(activities=act) as prof:
        hnsw.search_device(qg, k, ef)
        torch.cuda.synchronize()
    spans = device_spans(prof)
    busy_ms = union_ms(spans)
    print(f"{card}; whole-beam search, {nq} queries: host wall {wall_ms:.3f} ms"
          f" (median of 5, no profiler), device busy {busy_ms:.3f} ms under the"
          f" profiler (idle {1 - busy_ms / wall_ms:.1%}), {len(spans)} kernels"
          " and copies", flush=True)
    try:
        for label, attr in parts.items():
            setattr(hnsw_mod, attr, fenced(label, saved[attr]))
        with torch.profiler.profile(activities=act) as prof:
            hnsw.search_device(qg, k, ef)
            torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(hnsw_mod, attr, fn)
        hnsw.beam_whole = False
    kernels = device_spans(prof)
    split = {}
    for e in prof.events():
        if e.device_type != kind and e.name.startswith("probe:"):
            lo, hi = e.time_range.start, e.time_range.end
            split.setdefault(e.name[6:], []).append(
                union_ms([(s, t) for s, t in kernels if s >= lo and t <= hi]))
    total = union_ms(kernels)
    got = {lab: sum(v) for lab, v in split.items()}
    entry = got["chunk"] - got["routing"] - got["beam_loop"] - got["rescore"]
    print(f"{card}; whole-beam search, parts fenced, {len(split['chunk'])} chunks:"
          f" device ms routing {got['routing']:.3f}, entry scoring and beam set-up"
          f" {entry:.3f}, beam_loop {got['beam_loop']:.3f}, rescore"
          f" {got['rescore']:.3f}, outside the chunks {total - got['chunk']:.3f};"
          f" all kernels {total:.3f}", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
