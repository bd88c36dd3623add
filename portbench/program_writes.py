"""The program's write spans (``index.insert``, ``index.delete``: requests
of their own, which ``program.placed`` does not pair with the benchmark's
requests) in a traced window, for the churn cell's per-layer readers.

``window_spans(run, name)`` takes the clock from the window's placed
searches (``program.placed``) and returns the recorded spans named
``name`` that start inside the traced window, oldest first; None where the
searches cannot be placed or no such span was recorded (a port without
write spans, a cell that writes nothing).
"""

from __future__ import annotations

from portbench.program import SEARCH, placed, recorded


def window_spans(run, name: str) -> list | None:
    spans = placed(run)
    if spans is None:
        return None
    raw = {s.id: s for s in recorded()}
    first = next(s for s in spans if s.name == SEARCH)
    base_ns = raw[first.id].start_ns - first.start * 1e3
    lo, hi = run.trace.window
    out = sorted((s for s in raw.values() if s.name == name
                  and lo <= (s.start_ns - base_ns) / 1e3 <= hi),
                 key=lambda s: s.start_ns)
    return out or None


def ms_per_request(run, name: str) -> float | None:
    """Host milliseconds a request inside the window's ``name`` spans, from
    the spans' own durations."""
    spans = window_spans(run, name)
    if spans is None:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(run.trace.requests)
