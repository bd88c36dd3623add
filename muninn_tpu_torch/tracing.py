"""Spans and counters of the port's search path.

Spans. ``request(name)`` opens the span of one public API call (the
``index.search`` of every index) and gives it a new request id;
``span(name)`` opens a span inside it (``index.upload``,
``index.search_device``, ``ops.flat_topk``, ``hnsw.beam_step``, ...). A
span records its name, its start and end in ``time.time_ns()``, its own
id, its parent's, its request's and a few attributes (rows, bytes, the
beam's steps); the ``index.search`` span also records ``host_syncs``, the
counted host reads its request made. Spans record only while a
``torch.profiler`` session records: otherwise ``span`` and ``request``
return one shared no-op context (one call to
``torch.autograd._profiler_enabled``, no span object and no clock read),
so the path costs the same with tracing off. While recording, each span
is also a ``torch.profiler.record_function`` range named ``muninn:<name>``,
which its times enclose (a span holds the profiler's own cost of its range,
not its parent), so the exported trace shows it on the device timeline's
clock (Kineto's times are unix nanoseconds too).
The last ``MAX_SPANS`` spans are kept in memory: ``spans()`` returns a
copy, ``reset()`` clears them.

Operator use::

    from muninn_tpu_torch import tracing
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        index.search(queries, 10)
    for s in tracing.spans():
        print(s.request, s.name, (s.end_ns - s.start_ns) / 1e6, s.attrs)
    prof.export_chrome_trace("trace.json")  # the same spans as muninn: ranges

Counters, which count whether or not a profiler records:

- ``LAUNCHES[name]``: launches of each hand-written kernel family, added
  by its wrapper after each launch its launcher accepted
  (``ops._build.LAUNCHES`` is this dict);
- ``HOST_SYNCS[site]``: host reads through ``host_read``: the graph
  fixpoints' "go on" flags by fixpoint (``graph.traversal.HOST_SYNCS`` is
  this dict), ``download`` (each result copied back by a ``search``),
  ``hnsw_beam`` (the fused HNSW beam's flag, one a step), and an HNSW
  delete's reads: ``hnsw_delete_counts`` (the counts of a wave's affected
  rows and repair pool, read only where the wave's repair is eager) and
  ``hnsw_entry_rescan`` (the validity mask, when the entry point died).

Spans of the write path: ``index.insert`` and ``index.delete`` (one request
a call, with ``rows`` and, when they end, the store's ``high_watermark``,
``live`` and ``capacity``), and inside them ``hnsw.wave``, ``store.register``
(``rows``, ``reused`` slots, ``grew`` 0/1, ``high_watermark``, ``live``),
``hnsw.prune`` (the rows it rewrites) and ``hnsw.repair`` (its ``engine``,
"kernel" or "eager", and on the eager engine the ``rows`` it rewrites); in a
search, ``hnsw.repack`` (the packed neighbour rows re-gathered, ``whole`` 0/1).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

PREFIX = "muninn:"  # the record_function ranges of the spans
MAX_SPANS = 1 << 18

# one count per kernel and operand family: flat_topk's float modes and its
# int8 mode, beam_dots on f32/bf16 blocks and on int8 blocks, beam_dots'
# top-m mode, the whole-beam loop, one step of the fused beam (any block
# type), the row gather, a delete wave's repair; flat_topk_mma counts the
# tensor-core kernel's launches (flat_topk's bf16 mode and flat_topk_int8),
# each of them also counted under its mode's family
LAUNCHES: dict[str, int] = {"flat_topk": 0, "flat_topk_int8": 0,
                            "flat_topk_mma": 0,
                            "beam_dots": 0, "beam_dots_int8": 0,
                            "beam_topm": 0, "beam_loop": 0, "beam_step": 0,
                            "gather_rows": 0, "delete_repair": 0}

#: host reads by site: the graph fixpoints' flags by fixpoint, a search's
#: result downloads, the HNSW beam's flag, an HNSW delete's reads
HOST_SYNCS: dict[str, int] = {"bfs": 0, "seeded_bfs": 0,
                              "multi_source": 0, "components": 0,
                              "sssp": 0, "brandes": 0, "leiden": 0,
                              "download": 0, "hnsw_beam": 0,
                              "hnsw_delete_counts": 0,
                              "hnsw_entry_rescan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reset_host_syncs() -> None:
    for name in HOST_SYNCS:
        HOST_SYNCS[name] = 0


def host_read(site: str, tensor: torch.Tensor):
    """Read ``tensor`` back to the host, counted under ``site``: a 0-d
    tensor as a Python scalar, any other as a numpy array."""
    HOST_SYNCS[site] += 1
    return tensor.item() if tensor.ndim == 0 else tensor.cpu().numpy()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    id: int
    parent: int | None  # the enclosing span's id
    request: int | None  # the id of the API call it lies in
    attrs: dict


_SPANS: deque[Span] = deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_LOCAL = threading.local()
_recording = torch.autograd._profiler_enabled


def spans() -> list[Span]:
    """The recorded spans, oldest first (a copy)."""
    return list(_SPANS)


def reset() -> None:
    _SPANS.clear()


class _Null:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start",
                 "_range", "_syncs")

    def __init__(self, name: str, attrs: dict, new_request: bool):
        self.name, self.attrs = name, attrs
        self.request = next(_REQUESTS) if new_request else None
        # the request's host reads, counted from here
        self._syncs = sum(HOST_SYNCS.values()) if new_request else None

    def __enter__(self):
        stack = _LOCAL.__dict__.setdefault("stack", [])
        top = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = top.id if top else None
        if self.request is None and top is not None:
            self.request = top.request
        stack.append(self)
        self.start = time.time_ns()
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        end = time.time_ns()
        _LOCAL.stack.pop()
        if self._syncs is not None:
            self.attrs["host_syncs"] = sum(HOST_SYNCS.values()) - self._syncs
        _SPANS.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.request, self.attrs))
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span inside the current request (``with span(...) as s:``;
    ``s.set(key=value)`` adds attributes), or a no-op while no profiler
    records."""
    return _Open(name, attrs, False) if _recording() else _NULL


def request(name: str, **attrs):
    """The span of one public API call: a new request id, and its host
    reads as ``host_syncs`` when it ends; a no-op while no profiler
    records."""
    return _Open(name, attrs, True) if _recording() else _NULL
