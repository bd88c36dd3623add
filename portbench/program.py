"""The program's own spans (``muninn_tpu_torch.tracing``) placed on a traced
run's clock, for the per-layer readers that read them.

``run.trace`` keeps its times in microseconds from the profiler's start,
which it does not keep; the program's spans keep unix nanoseconds, the
profiler's own clock. ``placed(run)`` estimates that start: it pairs the
i-th ``index.search`` span with the i-th ``request`` span of the window and
takes the smallest difference of their starts, so that each search starts
at or after its request. It returns None where the port has no tracing
module (a commit before it), recorded no span, or where searches and
requests differ in number or a shifted search leaves its request.
"""

from __future__ import annotations

from typing import NamedTuple

SEARCH = "index.search"  # the span of one public search call
SLACK_US = 1.0  # the trace's float microseconds against integer nanoseconds


class Placed(NamedTuple):
    name: str
    start: float  # microseconds on run.trace's clock
    end: float
    id: int
    parent: int | None
    request: int | None
    attrs: dict


def recorded() -> list:
    """The program's recorded spans; none where the port has no tracing
    module."""
    try:
        from muninn_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def placed(run) -> list[Placed] | None:
    """The spans of the window's searches on ``run.trace``'s clock, or
    None where they cannot be placed."""
    tr = run.trace
    spans = recorded()
    searches = sorted((s for s in spans if s.name == SEARCH),
                      key=lambda s: s.start_ns)
    if tr is None or not searches or len(searches) != len(tr.requests):
        return None
    base = min(s.start_ns - round(lo * 1e3)
               for s, (lo, _) in zip(searches, tr.requests))
    for s, (lo, hi) in zip(searches, tr.requests):
        if ((s.start_ns - base) / 1e3 < lo - SLACK_US
                or (s.end_ns - base) / 1e3 > hi + SLACK_US):
            return None
    ids = {s.request for s in searches}
    return [Placed(s.name, (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3,
                   s.id, s.parent, s.request, s.attrs)
            for s in spans if s.request in ids]


def idle_by_span(run, spans: list[Placed]) -> dict[str, float]:
    """Device-idle microseconds in the window by the innermost program span
    the host was in; ``"request"`` is the rest of the benchmark's request
    spans, ``"harness"`` the time between them."""
    busy = run.trace.busy
    lo, hi = run.trace.window

    def idle(s, e):
        s, e = max(s, lo), min(e, hi)
        return max((e - s) - busy.within(s, e), 0.0) if e > s else 0.0

    out: dict[str, float] = {}
    child_idle: dict[int, float] = {}
    for s in spans:
        t = idle(s.start, s.end)
        out[s.name] = out.get(s.name, 0.0) + t
        if s.parent is not None:
            child_idle[s.parent] = child_idle.get(s.parent, 0.0) + t
    for s in spans:
        out[s.name] -= child_idle.get(s.id, 0.0)
    in_requests = sum(idle(s, e) for s, e in run.trace.requests)
    out["request"] = in_requests - sum(idle(s.start, s.end) for s in spans
                                       if s.name == SEARCH)
    out["harness"] = idle(lo, hi) - in_requests
    return out
