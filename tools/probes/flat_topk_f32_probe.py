"""Where the time of the f32 flat_topk kernel (csrc/flat_topk.cu, the
``precision="highest"`` mode) goes, on one CUDA card: the kernel against
variants of itself with a part stubbed out, and its corpus split count.
It answers whether ``highest`` is bound by staging (the cp.async ring and
its barriers) or by the FMA pipe (the FMAs and their shared loads).

    python3 tools/probes/flat_topk_f32_probe.py

Shapes: chip_smoke.py's two ``highest`` shapes, cosine 100k x 384 x 8,192
and 1M x 768 x 1,024, k=10, on its data recipe. Variants, built from the
source's text under build/probe_src/ (never an option of the kernel
itself):

- ``noepi``: the top-k selection replaced by a sink that sums the
  accumulators (loads and FMAs);
- ``nofma``: the FMAs skipped, the selection kept (loads, barriers and a
  selection that ends at its vote once the thresholds settle);
- ``noload``: the copies into the ring skipped and the selection replaced by
  the sink (FMAs on stale shared memory, and barriers).

Times are CUDA-event medians (chip_smoke.device_ms); every line names the
card and its power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402
from muninn_tpu_torch.ops import _build  # noqa: E402
from muninn_tpu_torch.ops import flat_topk as ft  # noqa: E402

EPI = """      select_tile<TQ>(acc, rt, st, bd, bi, cnt, thr, k, W, mode, t0, row_hi,
                 qrow, live, ly, lx, lane);"""
SINK = """      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < G::kRq; ++i)
#pragma unroll
        for (int j = 0; j < G::kRc; ++j) sum += acc[i][j];
      if (sum == -12345.f) out_d[0] = sum;"""
FMA = "    multiply<TQ>(st, qrow, lx, acc);"
LOADS = ("      cp16(st + 4 * (r * kStride + 4 * u), src, in ? 16 : 0);",
         "      cp4(st + 4 * (r * kStride + u), src, in ? 4 : 0);")


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"probe: the kernel source changed; not found once:\n{old}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    noepi = sub(src, EPI, SINK)
    noload = noepi
    for line in LOADS:
        noload = sub(noload, line, "      (void)src;")
    return {"noepi": noepi, "nofma": sub(src, FMA, ""), "noload": noload}


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_topk_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.load_all(["flat_topk"])
    real = _build._LIBS["flat_topk"]
    probe_dir = _build.BUILD_DIR.parent / "probe_src"
    probe_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for name, text in variants((_build.CSRC_DIR / "flat_topk.cu").read_text()).items():
        (probe_dir / f"flat_topk_{name}.cu").write_text(text)
        names.append(f"flat_topk_{name}")
    csrc = _build.CSRC_DIR
    try:
        _build.CSRC_DIR = probe_dir
        _build.load_all(names)
    finally:
        _build.CSRC_DIR = csrc

    def use(lib) -> None:
        _build._LIBS["flat_topk"] = lib
        ft._LIB = None
        ft._library()

    gen = torch.Generator(device="cuda").manual_seed(3)
    x, q = cs.clustered_on_device(gen, 100_000, 384, 1000, 8192)
    x5, q5 = cs.clustered_on_device(gen, 1_000_000, 768, 1000, 1024)
    runs = {
        "100k x 384 x 8192": lambda: ft.flat_topk(q, x, 10, metric="cosine"),
        "1M x 768 x 1024": lambda: ft.flat_topk(q5, x5, 10, metric="cosine"),
    }
    print(f"{card}; FP32 bound {cs.bound(2.0 * 8192 * 100_000 * 384, 'fp32', 0)[0]:.3f}"
          f" / {cs.bound(2.0 * 1024 * 1_000_000 * 768, 'fp32', 0)[0]:.3f} ms")
    for name in ("flat_topk", *names, "flat_topk"):
        use(real if name == "flat_topk" else _build._LIBS[name])
        times = ", ".join(f"{what} {cs.device_ms(fn):.3f} ms" for what, fn in runs.items())
        print(f"{card}; {name}: {times}", flush=True)

    use(real)
    lib = ft._library()
    splits = lib.flat_topk_splits
    print(f"{card}; splits from the occupancy API: 100k x 384 x 8192"
          f" {splits(8192, 100_000, 10, *ft.f32_plan(10, 8192), 0)}, 1M x 768 x 1024"
          f" {splits(1024, 1_000_000, 10, *ft.f32_plan(10, 1024), 0)}")
    for s in (None, 1, 4, 16, 64):
        lib.flat_topk_splits = splits if s is None else (lambda *a, s=s: s)
        times = ", ".join(f"{what} {cs.device_ms(fn):.3f} ms" for what, fn in runs.items())
        print(f"{card}; splits {s or 'from the occupancy API'}: {times}", flush=True)
    lib.flat_topk_splits = splits
    for b in (1, 64, 1024):
        print(f"{card}; B={b}: 100k x 384 {cs.device_ms(lambda: ft.flat_topk(q[:b], x, 10, metric='cosine')):.3f} ms,"
              f" 1M x 768 {cs.device_ms(lambda: ft.flat_topk(q5[:b], x5, 10, metric='cosine')):.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
