"""Where the time of the tensor-core flat_topk kernel (csrc/flat_topk_mma.cu)
goes, on one CUDA card: the kernel against variants of itself with a part
stubbed out, its epilogue's counters, and its corpus split count.

    python3 tools/probes/flat_topk_mma_probe.py

Shapes: the bf16 mode at 100k x 384 x 8,192, k=10, and the int8 mode at
1M x 768 x 8,192, k=16, on chip_smoke.py's data recipe. Variants, built
from the source's text under build/probe_src/ (never an option of the
kernel itself):

- ``noepi``: the epilogue skipped (loads and MMAs);
- ``nomma``: the MMAs and the epilogue skipped (the load pipeline alone);
- ``noload``: the corpus loads and the epilogue skipped (MMAs and barriers);
- ``counts``: the kernel with global counters of its epilogue's cycles, its
  merges and its appends.

Times are CUDA-event medians (chip_smoke.device_ms); every line names the
card and its power limit.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402
from muninn_tpu_torch.ops import _build  # noqa: E402
from muninn_tpu_torch.ops import flat_topk as ft  # noqa: E402
from muninn_tpu_torch.ops.distance import quantize_rows_int8  # noqa: E402

EPI = """      if (nvalid > 0)
        epilogue<kOp>(acc, mine, mine + kTileRows, bd, bi, cnt, thr, k, W, t0,
                      row0, nvalid, lane, rtA, rtB);"""
MMA = "          mma(acc, desc(a_u + 32 * ks), desc(b_u + 32 * ks), (kc | ks) != 0);"
LOAD = "            tma_load(b_u, &map_c, kc * kChunk, t0, bars + 8 * s);"
TX = "    const int tx = (resident ? 0 : kAChunk) + (path == 2 ? kTileRows * kChunk : 0);"


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"probe: the kernel source changed; not found once:\n{old}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    noepi = sub(src, EPI, "")
    counts = sub(src, "namespace {\n", "namespace {\n__device__ unsigned long long g_counts[3];\n")
    counts = sub(counts, EPI, "      const long long e0 = clock64();\n" + EPI + """
      if (lane == 0) atomicAdd(&g_counts[0], (unsigned long long)(clock64() - e0));""")
    counts = sub(counts, "          if (lane == 0) {\n            cnt[r] = 0;",
                 "          if (lane == 0) {\n            atomicAdd(&g_counts[1], 1ull);\n            cnt[r] = 0;")
    counts = sub(counts, "        const int pos = atomicAdd(&cnt[r], 1);",
                 "        atomicAdd(&g_counts[2], 1ull);\n        const int pos = atomicAdd(&cnt[r], 1);")
    counts += """
extern "C" int flat_topk_mma_counts(unsigned long long* out, int reset) {
  unsigned long long z[3] = {0, 0, 0};
  if (reset) return (int)cudaMemcpyToSymbol(g_counts, z, sizeof z);
  return (int)cudaMemcpyFromSymbol(out, g_counts, sizeof z);
}
"""
    return {
        "noepi": noepi,
        "nomma": sub(noepi, MMA, ""),
        "noload": sub(sub(noepi, LOAD, "            ;"), TX, "    const int tx = resident ? 0 : kAChunk;"),
        "counts": counts,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_topk_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.load_all(["flat_topk_mma"])
    real = _build._LIBS["flat_topk_mma"]
    probe_dir = _build.BUILD_DIR.parent / "probe_src"
    probe_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for name, text in variants((_build.CSRC_DIR / "flat_topk_mma.cu").read_text()).items():
        (probe_dir / f"flat_topk_mma_{name}.cu").write_text(text)
        names.append(f"flat_topk_mma_{name}")
    csrc = _build.CSRC_DIR
    try:
        _build.CSRC_DIR = probe_dir
        _build.load_all(names)
    finally:
        _build.CSRC_DIR = csrc

    def use(lib) -> None:
        _build._LIBS["flat_topk_mma"] = lib
        ft._MMA_LIB = None
        ft._mma_library()

    gen = torch.Generator(device="cuda").manual_seed(3)
    x, q = cs.clustered_on_device(gen, 100_000, 384, 1000, 8192)
    x5, q5 = cs.clustered_on_device(gen, 1_000_000, 768, 1000, 8192)
    vi, sc = quantize_rows_int8(x5, normalize=True)
    del x5
    torch.cuda.empty_cache()
    runs = {
        "bf16 100k x 384 x 8192 k=10": lambda: ft.flat_topk(
            q, x, 10, metric="cosine", precision="default"),
        "int8 1M x 768 x 8192 k=16": lambda: ft.flat_topk_int8(
            q5, vi, sc, 16, metric="cosine"),
    }
    print(card)
    print(f"bf16 copy of the 100k x 384 corpus (mma_rows):"
          f" {cs.device_ms(lambda: ft.mma_rows(x, ft._OP_BF16)):.4f} ms")
    for name in ("flat_topk_mma", *names[:3], "flat_topk_mma"):
        use(real if name == "flat_topk_mma" else _build._LIBS[name])
        times = ", ".join(f"{what} {cs.device_ms(fn):.3f} ms" for what, fn in runs.items())
        print(f"{name}: {times}", flush=True)

    lib = _build._LIBS["flat_topk_mma_counts"]
    use(lib)
    buf = (ctypes.c_ulonglong * 3)()
    for what, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        lib.flat_topk_mma_counts(buf, 1)
        fn()
        torch.cuda.synchronize()
        lib.flat_topk_mma_counts(buf, 0)
        print(f"counts, {what}: epilogue {buf[0]:.4g} warp-cycles, merges {buf[1]},"
              f" appends {buf[2]}", flush=True)

    use(real)
    splits = ft._mma_library().flat_topk_mma_splits
    for s in (None, 1, 4, 16, 64):
        ft._mma_library().flat_topk_mma_splits = splits if s is None else (lambda *a, s=s: s)
        times = ", ".join(f"{what} {cs.device_ms(fn):.3f} ms" for what, fn in runs.items())
        print(f"splits {s or 'from the occupancy API'}: {times}", flush=True)
    ft._mma_library().flat_topk_mma_splits = splits
    for b in (1, 64, 1024):
        print(f"B={b}: bf16 {cs.device_ms(lambda: ft.flat_topk(q[:b], x, 10, metric='cosine', precision='default')):.3f} ms,"
              f" int8 {cs.device_ms(lambda: ft.flat_topk_int8(q5[:b], vi, sc, 16, metric='cosine')):.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
