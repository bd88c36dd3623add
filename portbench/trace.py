"""What a traced window leaves for the per-layer readers: the device's
operations from ``torch.profiler`` and the benchmark's own host spans,
times in microseconds on the profiler's clock.

The spans come from this folder, around the calls into each layer (the
program has none of its own yet): ``request`` around each ``search``,
``search_device`` around the index's device search, and ``ids_of`` around
the slot-to-id map. A device operation is a kernel, a copy or a memset.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path

import torch

SPAN = "span:"  # prefix of the benchmark's record_function ranges
# each span and the span it lies inside; time outside any request is the
# harness's own
PARENT = {"request": None, "search_device": "request", "ids_of": "request"}
OUTSIDE = "harness"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")


def handwritten_kernels() -> frozenset[str]:
    """The names of the program's hand-written CUDA kernels, read from its
    ``csrc/*.cu`` sources."""
    import muninn_tpu_torch

    csrc = Path(muninn_tpu_torch.__file__).resolve().parent / "csrc"
    return frozenset(name for src in csrc.glob("*.cu")
                     for name in _GLOBAL.findall(src.read_text()))


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name[5:] if name.startswith("void ") else name


def _merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Cover:
    """Disjoint intervals with the length they cover up to any time."""

    def __init__(self, intervals):
        self.iv = _merged(intervals)
        self.starts = [s for s, _ in self.iv]
        self.cum = [0.0]
        for s, e in self.iv:
            self.cum.append(self.cum[-1] + e - s)

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.iv[i - 1]
        return self.cum[i - 1] + min(t, e) - s

    def within(self, lo: float, hi: float) -> float:
        return max(self.upto(hi) - self.upto(lo), 0.0)


class Trace:
    def __init__(self, ops, spans, handwritten=frozenset()):
        """``ops``: ``(name, start, end)`` device operations; ``spans``:
        ``(name, start, end)`` host spans named as in ``PARENT``."""
        self.spans = {name: sorted((s, e) for n, s, e in spans if n == name)
                      for name in PARENT}
        self.requests = self.spans["request"]
        self.window = ((self.requests[0][0], self.requests[-1][1])
                       if self.requests else (0.0, 0.0))
        lo, hi = self.window
        self.ops = [(n, s, e) for n, s, e in ops if e > lo and s < hi]
        self.kernels = [op for op in self.ops
                        if not op[0].startswith(("Memcpy", "Memset"))]
        self.handwritten = handwritten
        self.busy = Cover((max(s, lo), min(e, hi)) for _, s, e in self.ops)

    @classmethod
    def from_profiler(cls, prof, handwritten=frozenset()) -> "Trace":
        """From the profiler's raw events: building its ``events()`` list
        takes about 80 us an event in Python, minutes for a window of the
        HNSW cell."""
        kind = torch.autograd.DeviceType.CUDA
        results = prof.profiler.kineto_results
        base = results.trace_start_ns()
        ops, spans = [], []
        for e in results.events():
            name = e.name()
            on_device = e.device_type() == kind
            t = ((e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3)
            if name.startswith(SPAN):
                if not on_device:  # not the range's copy on the device
                    spans.append((name[len(SPAN):], *t))
            elif on_device and not e.is_user_annotation():
                ops.append((name, *t))
        return cls(ops, spans, handwritten)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return self.busy.within(*self.window)

    def is_handwritten(self, name: str) -> bool:
        return short_name(name).split("<", 1)[0] in self.handwritten

    def idle_by_span(self) -> dict[str, float]:
        """Idle device time (no operation running) in the window, in
        microseconds, by the innermost benchmark span the host was in."""
        covers = {name: Cover(iv) for name, iv in self.spans.items()}
        out = {name: 0.0 for name in (*PARENT, OUTSIDE)}
        lo, hi = self.window
        edges = [lo, *(x for iv in self.busy.iv for x in iv), hi]
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            inside = {name: c.within(a, b) for name, c in covers.items()}
            for name, parent in PARENT.items():
                out[name] += inside[name]
                if parent is not None:
                    out[parent] -= inside[name]
            out[OUTSIDE] += (b - a) - inside["request"]
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        host span, in seconds."""
        by_op: dict[str, float] = {}
        for name, s, e in self.ops:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(((k, v / 1e6) for k, v in self.idle_by_span().items()
                       if v > 0), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(kv) for kv in ops],
                "idle_gaps": [list(kv) for kv in idle]}
