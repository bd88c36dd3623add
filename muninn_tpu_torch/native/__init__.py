"""Native host runtime bindings (ctypes): the port's own copy of
``muninn_tpu.native``.

The first call that needs the library compiles ``src/muninn_host.cpp`` and
``src/muninn_graph.cpp`` with ``g++ -O3`` into ``build/native/`` at the root
of the checkout (git-ignored), named by a hash of the sources, the flags, the
compiler's version and the target it resolves ``-march=native`` to, and loads
it with ``ctypes``; a later process on the same machine finds the library
there and skips the build. Nothing is built while this module is imported. It
exposes:

- ``InternTable`` — bulk string-id interning (graph_load.c hash-map role)
- ``csr_build`` — O(E+V) counting-sort CSR build (graph_csr.c:20-83)
- ``csr_apply_delta`` — insert/delete merge (graph_csr.c:175-325)
- ``jaro_winkler`` / ``jaro_winkler_batch`` (string_sim.c:11-96)
- the ``graph_*`` host kernels and ``node2vec_train_host``
  (``src/muninn_graph.cpp``), the host engine that ``graph.routing`` sends
  an operation to when it is faster there.

``InternTable``, ``csr_build``, ``csr_apply_delta`` and the Jaro-Winkler
functions have a numpy/python fallback (``HAVE_NATIVE`` False), so the
package works where no compiler is available; the ``graph_*`` kernels
return ``None`` there and their callers take the device path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRCS = [_DIR / "src" / "muninn_host.cpp", _DIR / "src" / "muninn_graph.cpp"]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_tried = False
HAVE_NATIVE = False

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_VP, _CP = ctypes.c_void_p, ctypes.c_char_p
_I32, _I64, _U64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
_F32 = ctypes.c_float

# (restype, argtypes) of every entry point of the two sources
_SIGNATURES = {
    "muninn_intern_new": (_VP, []),
    "muninn_intern_free": (None, [_VP]),
    "muninn_intern_size": (_I32, [_VP]),
    "muninn_intern_add": (_I32, [_VP, _CP, _I64P, _I64, _I32P]),
    "muninn_intern_find": (None, [_VP, _CP, _I64P, _I64, _I32P]),
    "muninn_intern_bytes": (_I64, [_VP]),
    "muninn_csr_build": (None, [_I32P, _I32P, _F32P, _I64, _I32, _I32P,
                                _I32P, _I32P, _F32P]),
    "muninn_csr_apply_delta": (_I64, [_I32P, _I32P, _F32P, _I64, _I32P,
                                      _I32P, _F32P, _U8P, _I64, _I32P,
                                      _I32P, _F32P, _I64P, _I64P]),
    "muninn_jaro_winkler": (ctypes.c_double, [_CP, _I64, _CP, _I64]),
    "muninn_jaro_winkler_batch": (None, [_CP, _I64P, _CP, _I64P, _I64,
                                         _F64P]),
    "muninn_graph_bfs": (None, [_I32P, _I32P, _I32, _I32, _I32, _I32P,
                                _I32P]),
    "muninn_graph_dfs": (None, [_I32P, _I32P, _I32, _I32, _I32, _I32P,
                                _I32P, _I32P, _I32P]),
    "muninn_graph_components": (None, [_I32P, _I32P, _I64, _I32, _I32P]),
    "muninn_graph_pagerank": (None, [_I32P, _I32P, _F32P, _F32P, _I64, _I32,
                                     _F32, _I32, _I32, _F32P]),
    "muninn_graph_sssp": (None, [_I32P, _I32P, _F32P, _I64, _I32, _I32,
                                 _F32P, _I32P]),
    "muninn_graph_brandes": (None, [_I32P, _I32P, _F32P, _I64, _I32, _I32P,
                                    _I32, _I32, _I32, _F64P, _F64P]),
    "muninn_graph_closeness": (None, [_I32P, _I32P, _F32P, _I64, _I32, _I32,
                                      _I32, _F32P]),
    "muninn_graph_leiden": (ctypes.c_double, [_I32P, _I32P, _F32P, _I64,
                                              _I32, _F32, _I32, _U64, _I32P]),
    "muninn_node2vec_train": (None, [_I32P, _I32P, _F32P, _I64, _I32, _I32,
                                     _F32, _F32, _I32, _I32, _I32, _I32,
                                     _F32, _I32, _U64, _F32P]),
}


def _gxx(*args: str) -> str:
    return subprocess.run(
        ["g++", *args], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout


def library_path() -> Path:
    """Where the library of these sources, flags and this machine's
    compiler and target lies (built or not)."""
    try:  # what -march=native means here: a library built for one CPU
        target = _gxx("-march=native", "-Q", "--help=target")  # may not run on another
    except (OSError, subprocess.SubprocessError):
        target = ""
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in _SRCS)
        + "\0".join((*_FLAGS, _gxx("--version"), target)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libmuninn_host-{digest}.so"


def _build(out: Path) -> bool:
    """Compile the sources into ``out``, with ``-march=native`` where the
    compiler takes it, else for the portable baseline; under a lock, so
    concurrent processes build once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():  # another process built it while this one waited
            return True
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        for extra in (["-march=native"], []):
            try:
                subprocess.run(
                    ["g++", *_FLAGS, *extra, "-o", str(tmp), *map(str, _SRCS)],
                    check=True, capture_output=True, timeout=300,
                )
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, out)  # atomic: a reader sees all or nothing
            return True
        tmp.unlink(missing_ok=True)
    return False


def _load():
    """The loaded library, built on first use; None where it cannot be
    built or loaded (no compiler), and then the fallbacks run."""
    global _lib, _tried, HAVE_NATIVE
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = library_path()
    except (OSError, subprocess.SubprocessError):
        return None
    if not path.is_file() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    HAVE_NATIVE = True
    return lib


def _pack_strings(strings) -> tuple[bytes, np.ndarray]:
    bs = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
    offsets = np.zeros(len(bs) + 1, np.int64)
    np.cumsum([len(b) for b in bs], out=offsets[1:])
    return b"".join(bs), offsets


class InternTable:
    """Bulk string interning backed by the native hash map (falls back
    to a Python dict)."""

    def __init__(self):
        self._lib = _load()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.muninn_intern_new())
            self._py = None
        else:
            self._h = None
            self._py = {}
            self._ids = []

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.muninn_intern_free(self._h)
            self._h = None

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.muninn_intern_size(self._h))
        return len(self._ids)

    def add(self, strings) -> np.ndarray:
        if self._lib is not None:
            buf, offs = _pack_strings(strings)
            out = np.empty(len(strings), np.int32)
            self._lib.muninn_intern_add(
                self._h, buf, offs.ctypes.data_as(_I64P), len(strings),
                out.ctypes.data_as(_I32P),
            )
            return out
        out = np.empty(len(strings), np.int32)
        for i, s in enumerate(strings):
            idx = self._py.get(s)
            if idx is None:
                idx = len(self._ids)
                self._py[s] = idx
                self._ids.append(s)
            out[i] = idx
        return out

    def find(self, strings) -> np.ndarray:
        if self._lib is not None:
            buf, offs = _pack_strings(strings)
            out = np.empty(len(strings), np.int32)
            self._lib.muninn_intern_find(
                self._h, buf, offs.ctypes.data_as(_I64P), len(strings),
                out.ctypes.data_as(_I32P),
            )
            return out
        return np.array([self._py.get(s, -1) for s in strings], np.int32)


def csr_build(src: np.ndarray, dst: np.ndarray, w: np.ndarray | None, num_nodes: int):
    """Counting-sort CSR build. Returns (offsets, src_sorted, dst_sorted, w_sorted)."""
    lib = _load()
    e = len(src)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    ww = np.ascontiguousarray(w, np.float32) if w is not None else None
    if lib is not None:
        offsets = np.empty(num_nodes + 1, np.int32)
        os_ = np.empty(e, np.int32)
        od = np.empty(e, np.int32)
        ow = np.empty(e, np.float32)
        lib.muninn_csr_build(
            src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
            ww.ctypes.data_as(_F32P) if ww is not None else None,
            e, num_nodes, offsets.ctypes.data_as(_I32P),
            os_.ctypes.data_as(_I32P), od.ctypes.data_as(_I32P),
            ow.ctypes.data_as(_F32P),
        )
        return offsets, os_, od, ow
    # numpy fallback
    order = np.argsort(src, kind="stable")
    s = src[order]
    d = dst[order]
    ow = (ww[order] if ww is not None else np.ones(e, np.float32))
    counts = np.bincount(s, minlength=num_nodes)
    offsets = np.zeros(num_nodes + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return offsets, s, d, ow


def csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op,
                    return_removed: bool = False):
    """Apply a delta (op 0=insert, 1=delete) to an edge list.

    Deltas replay in order; a delete removes only the first live
    matching (src, dst) occurrence — existing edges before same-batch
    inserts (reference graph_csr.c:219-247: linear scan, remove one,
    break).

    ``return_removed``: also return the ascending original positions of
    removed pre-existing edges (int64) — block-granular persistence
    shrinks only the owning blocks (graph_csr.c:341-478 role)."""
    lib = _load()
    e, nd = len(src), len(d_src)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    d_src = np.ascontiguousarray(d_src, np.int32)
    d_dst = np.ascontiguousarray(d_dst, np.int32)
    d_w = np.ascontiguousarray(d_w, np.float32)
    d_op = np.ascontiguousarray(d_op, np.uint8)
    if lib is not None:
        cap = e + int((d_op == 0).sum())
        out_s = np.empty(cap, np.int32)
        out_d = np.empty(cap, np.int32)
        out_w = np.empty(cap, np.float32)
        n_del = int((d_op == 1).sum())
        rem = np.empty(max(n_del, 1), np.int64)
        n_rem = ctypes.c_int64(0)
        n = lib.muninn_csr_apply_delta(
            src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
            w.ctypes.data_as(_F32P), e,
            d_src.ctypes.data_as(_I32P), d_dst.ctypes.data_as(_I32P),
            d_w.ctypes.data_as(_F32P), d_op.ctypes.data_as(_U8P), nd,
            out_s.ctypes.data_as(_I32P), out_d.ctypes.data_as(_I32P),
            out_w.ctypes.data_as(_F32P),
            rem.ctypes.data_as(_I64P), ctypes.byref(n_rem),
        )
        out = (out_s[:n], out_d[:n], out_w[:n])
        return out + (rem[: n_rem.value],) if return_removed else out
    # numpy fallback: same in-order single-match replay as the C++
    from collections import deque

    existing: dict | None = None
    removed = np.zeros(e, bool)
    ns: list[int] = []
    ndd: list[int] = []
    nw: list[float] = []
    nrem: list[bool] = []
    fresh: dict[tuple[int, int], deque] = {}
    for s, d, ww_, o in zip(d_src, d_dst, d_w, d_op):
        key = (int(s), int(d))
        if o == 0:
            fresh.setdefault(key, deque()).append(len(ns))
            ns.append(int(s))
            ndd.append(int(d))
            nw.append(float(ww_))
            nrem.append(False)
        else:
            if existing is None:
                # index only the keys this batch deletes (an all-edges
                # dict is O(E) python objects — minutes at 10M edges)
                del_keys = {
                    (int(a), int(b))
                    for a, b, o in zip(d_src, d_dst, d_op) if o == 1
                }
                existing = {}
                for i, (es, ed) in enumerate(zip(src, dst)):
                    kk = (int(es), int(ed))
                    if kk in del_keys:
                        existing.setdefault(kk, deque()).append(i)
            q = existing.get(key)
            if q:
                removed[q.popleft()] = True
            else:
                q = fresh.get(key)
                if q:
                    nrem[q.popleft()] = True
    keep = ~removed
    live = [i for i, r in enumerate(nrem) if not r]
    out = (
        np.concatenate([src[keep], np.array([ns[i] for i in live], np.int32)]),
        np.concatenate([dst[keep], np.array([ndd[i] for i in live], np.int32)]),
        np.concatenate([w[keep], np.array([nw[i] for i in live], np.float32)]),
    )
    if return_removed:
        return out + (np.nonzero(removed)[0].astype(np.int64),)
    return out


def jaro_winkler(a: str, b: str) -> float:
    """Jaro-Winkler similarity in [0, 1] (string_sim.c:11-96).

    Non-ASCII strings route to the code-point implementation on every
    environment: the C++ kernel scans UTF-8 BYTES, so 'Café' would
    score differently with and without the native lib — around the ER
    cascade threshold that made entity merges environment-dependent."""
    lib = _load()
    if lib is not None and a.isascii() and b.isascii():
        ab, bb = a.encode(), b.encode()
        return float(lib.muninn_jaro_winkler(ab, len(ab), bb, len(bb)))
    return _jw_py(a, b)


def jaro_winkler_batch(pairs_a, pairs_b) -> np.ndarray:
    """Batch JW; non-ASCII pairs score via the code-point path (see
    ``jaro_winkler``), ASCII pairs via the native kernel."""
    lib = _load()
    if lib is not None:
        non_ascii = [
            i for i, (a, b) in enumerate(zip(pairs_a, pairs_b))
            if not (a.isascii() and b.isascii())
        ]
        if non_ascii:
            res = np.empty(len(pairs_a), np.float64)
            na = set(non_ascii)
            asc_idx = [i for i in range(len(pairs_a)) if i not in na]
            if asc_idx:
                res[asc_idx] = jaro_winkler_batch(
                    [pairs_a[i] for i in asc_idx],
                    [pairs_b[i] for i in asc_idx],
                )
            for i in non_ascii:
                res[i] = _jw_py(pairs_a[i], pairs_b[i])
            return res
        buf_a, off_a = _pack_strings(pairs_a)
        buf_b, off_b = _pack_strings(pairs_b)
        out = np.empty(len(pairs_a), np.float64)
        lib.muninn_jaro_winkler_batch(
            buf_a, off_a.ctypes.data_as(_I64P),
            buf_b, off_b.ctypes.data_as(_I64P),
            len(pairs_a), out.ctypes.data_as(_F64P),
        )
        return out
    return np.array([_jw_py(a, b) for a, b in zip(pairs_a, pairs_b)])


def _jw_py(a: str, b: str) -> float:
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return 1.0
    if la == 0 or lb == 0:
        return 0.0
    window = max(la, lb) // 2 - 1
    window = max(window, 0)
    ma = [False] * la
    mb = [False] * lb
    matches = 0
    for i in range(la):
        for j in range(max(0, i - window), min(lb, i + window + 1)):
            if not mb[j] and a[i] == b[j]:
                ma[i] = mb[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    t = 0
    j = 0
    for i in range(la):
        if not ma[i]:
            continue
        while not mb[j]:
            j += 1
        if a[i] != b[j]:
            t += 1
        j += 1
    m = float(matches)
    jv = (m / la + m / lb + (m - t / 2.0) / m) / 3.0
    prefix = 0
    for i in range(min(la, lb, 4)):
        if a[i] == b[i]:
            prefix += 1
        else:
            break
    return jv + prefix * 0.1 * (1.0 - jv)


# ──────────────── host graph kernels (muninn_graph.cpp) ────────────────
# The host engine of graph.routing: classic sequential algorithms, faster
# than the device fixpoints on small graphs (routing.py holds the measured
# crossovers). No numpy fallbacks here: callers take the DEVICE path when
# native is unavailable, so results are always produced either way.


def graph_available() -> bool:
    return _load() is not None


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def graph_bfs(offsets, dst, start: int, max_depth: int):
    """BFS over a forward CSR -> (depth int32[V] (2^30 unreached),
    parent int32[V]). Same min-index-predecessor tie-break as
    traversal.bfs_pull. None if native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    offsets = _i32(offsets)
    dst = _i32(dst)
    v = len(offsets) - 1
    depth = np.empty(v, np.int32)
    parent = np.empty(v, np.int32)
    lib.muninn_graph_bfs(
        offsets.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        v, start, min(max_depth, 2**30),
        depth.ctypes.data_as(_I32P), parent.ctypes.data_as(_I32P),
    )
    return depth, parent


def graph_dfs(offsets, dst, start: int, max_depth: int):
    """Preorder DFS over a forward CSR -> (order, depth, parent) int32
    arrays of the reached rows, lowest-index neighbor first (same
    enumeration as traversal.dfs_host). None if native is unavailable —
    the caller keeps the python fallback (DFS has no device path)."""
    lib = _load()
    if lib is None:
        return None
    offsets = _i32(offsets)
    dst = _i32(dst)
    v = len(offsets) - 1
    order = np.empty(v, np.int32)
    depth = np.empty(v, np.int32)
    parent = np.empty(v, np.int32)
    n = ctypes.c_int32(0)
    lib.muninn_graph_dfs(
        offsets.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        v, start, min(max_depth, 2**30),
        order.ctypes.data_as(_I32P), depth.ctypes.data_as(_I32P),
        parent.ctypes.data_as(_I32P), ctypes.byref(n),
    )
    k = int(n.value)
    return order[:k], depth[:k], parent[:k]


def graph_components(src, dst, num_nodes: int):
    """Union-find components; labels = min node index per component
    (what min-label propagation converges to). None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    comp = np.empty(num_nodes, np.int32)
    lib.muninn_graph_components(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        len(src), num_nodes, comp.ctypes.data_as(_I32P),
    )
    return comp


def graph_pagerank(src, dst, w, out_degree, damping: float,
                   iterations: int, weighted: bool):
    """Power iteration with dangling redistribution (the
    pagerank_device formula, double accumulation)."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    w = _f32(w)
    out_degree = _f32(out_degree)
    v = len(out_degree)
    rank = np.empty(v, np.float32)
    lib.muninn_graph_pagerank(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        w.ctypes.data_as(_F32P), out_degree.ctypes.data_as(_F32P),
        len(src), v, damping, iterations, 1 if weighted else 0,
        rank.ctypes.data_as(_F32P),
    )
    return rank


def graph_sssp(src, dst, w, num_nodes: int, start: int):
    """Dijkstra + tight-edge min-index parents (the
    traversal.sssp_with_parents_pull contract). None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    w = _f32(w)
    dist = np.empty(num_nodes, np.float32)
    parent = np.empty(num_nodes, np.int32)
    lib.muninn_graph_sssp(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        w.ctypes.data_as(_F32P), len(src), num_nodes, start,
        dist.ctypes.data_as(_F32P), parent.ctypes.data_as(_I32P),
    )
    return dist, parent


def graph_brandes(src, dst, w, num_nodes: int, sources,
                  weighted: bool, want_edge: bool):
    """Raw Brandes sums over the given sources -> (node_cb f64[V],
    edge_cb f64[E] | None). Scaling/halving/normalization stay with the
    Python wrapper (centrality.betweenness)."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    w = _f32(w)
    sources = _i32(sources)
    node_cb = np.empty(num_nodes, np.float64)
    edge_cb = np.empty(len(src) if want_edge else 1, np.float64)
    lib.muninn_graph_brandes(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        w.ctypes.data_as(_F32P), len(src), num_nodes,
        sources.ctypes.data_as(_I32P), len(sources),
        1 if weighted else 0, 1 if want_edge else 0,
        node_cb.ctypes.data_as(_F64P), edge_cb.ctypes.data_as(_F64P),
    )
    return node_cb, (edge_cb if want_edge else None)


def graph_closeness(src, dst, w, num_nodes: int, weighted: bool,
                    normalized: bool):
    """Per-source closeness with Wasserman-Faust correction
    (centrality.closeness contract)."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    w = _f32(w)
    out = np.empty(num_nodes, np.float32)
    lib.muninn_graph_closeness(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        w.ctypes.data_as(_F32P), len(src), num_nodes,
        1 if weighted else 0, 1 if normalized else 0,
        out.ctypes.data_as(_F32P),
    )
    return out


def graph_leiden(src, dst, w, num_nodes: int, resolution: float,
                 max_rounds: int, seed: int):
    """Sequential queue-based Leiden over the 'both' COO ->
    (labels int32[V] renumbered, modularity). None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    w = _f32(w)
    labels = np.empty(num_nodes, np.int32)
    q = lib.muninn_graph_leiden(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        w.ctypes.data_as(_F32P), len(src), num_nodes, resolution,
        max_rounds, seed, labels.ctypes.data_as(_I32P),
    )
    return labels, float(q)


def node2vec_train_host(src, dst, w, num_nodes: int, dim: int, p: float,
                        q: float, num_walks: int, walk_length: int,
                        window: int, neg_samples: int, lr: float,
                        epochs: int, seed: int):
    """Sequential node2vec (p/q walks + SGNS) over the 'both' COO ->
    raw embeddings f32 [V, dim] (caller normalizes). None if
    unavailable. Host path for small graphs (reference src/node2vec.c
    role)."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(src), _i32(dst)
    w = _f32(w)
    out = np.empty((num_nodes, dim), np.float32)
    lib.muninn_node2vec_train(
        src.ctypes.data_as(_I32P), dst.ctypes.data_as(_I32P),
        w.ctypes.data_as(_F32P), len(src), num_nodes, dim, p, q,
        num_walks, walk_length, window, neg_samples, lr, epochs, seed,
        out.ctypes.data_as(_F32P),
    )
    return out
