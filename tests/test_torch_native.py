"""The port's native host runtime (``muninn_tpu_torch.native``): interning,
CSR build/delta, Jaro-Winkler and the graph host kernels — native against
the python fallbacks, and against ``muninn_tpu.native`` on the same inputs.

Mirrors tests/test_native.py case for case, then holds every entry point of
the port's library to the JAX package's library, and checks where the port
builds it.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from muninn_tpu import native as jnative
from muninn_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]


def test_native_builds():
    assert native._load() is not None, "g++ build of the host library failed"
    assert native.HAVE_NATIVE


def test_intern_table_roundtrip():
    t = native.InternTable()
    ids = t.add(["apple", "banana", "apple", "cherry"])
    np.testing.assert_array_equal(ids, [0, 1, 0, 2])
    assert len(t) == 3
    found = t.find(["banana", "durian", "apple"])
    np.testing.assert_array_equal(found, [1, -1, 0])


def test_intern_unicode():
    t = native.InternTable()
    ids = t.add(["héllo", "wörld", "héllo"])
    np.testing.assert_array_equal(ids, [0, 1, 0])


def test_csr_build_matches_numpy(rng):
    e, v = 5000, 300
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    off, s, d, ww = native.csr_build(src, dst, w, v)
    assert off[-1] == e
    np.testing.assert_array_equal(
        np.diff(off), np.bincount(src, minlength=v)
    )
    assert (s == np.sort(src, kind="stable")).all()
    for node in rng.integers(0, v, 10):
        seg = slice(off[node], off[node + 1])
        want_dst = dst[src == node]
        np.testing.assert_array_equal(np.sort(d[seg]), np.sort(want_dst))


def test_csr_apply_delta():
    src = np.array([0, 1, 2, 1], np.int32)
    dst = np.array([1, 2, 0, 2], np.int32)
    w = np.ones(4, np.float32)
    # delete ONE (1,2) pair (the other parallel duplicate survives,
    # graph_csr.c:219-247 removes a single match), insert (3,0)
    d_src = np.array([1, 3], np.int32)
    d_dst = np.array([2, 0], np.int32)
    d_w = np.array([0, 2.5], np.float32)
    d_op = np.array([1, 0], np.uint8)
    s, d, ww = native.csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op)
    pairs = sorted(zip(s.tolist(), d.tolist()))
    assert pairs == [(0, 1), (1, 2), (2, 0), (3, 0)]
    assert ww[list(zip(s, d)).index((3, 0))] == 2.5


def test_csr_apply_delta_in_order_replay():
    """Deltas replay in order: delete-then-insert of the same edge in
    one batch keeps the edge; insert-then-delete cancels out; a delete
    of a never-present edge is a no-op."""
    src = np.array([0], np.int32)
    dst = np.array([1], np.int32)
    w = np.array([1.0], np.float32)
    d_src = np.array([0, 0, 5, 5, 9], np.int32)
    d_dst = np.array([1, 1, 6, 6, 9], np.int32)
    d_w = np.array([0.0, 7.0, 3.0, 0.0, 0.0], np.float32)
    d_op = np.array([1, 0, 0, 1, 1], np.uint8)
    s, d, ww = native.csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op)
    assert list(zip(s.tolist(), d.tolist())) == [(0, 1)]
    assert ww[0] == 7.0


def test_csr_apply_delta_fallback_matches_native(rng, monkeypatch):
    e, nd, v = 200, 120, 12
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    d_src = rng.integers(0, v, nd).astype(np.int32)
    d_dst = rng.integers(0, v, nd).astype(np.int32)
    d_w = rng.random(nd).astype(np.float32)
    d_op = rng.integers(0, 2, nd).astype(np.uint8)
    ns, ndd, nw = native.csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op)
    monkeypatch.setattr(native, "_load", lambda: None)
    ps, pd, pw = native.csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op)
    np.testing.assert_array_equal(ns, ps)
    np.testing.assert_array_equal(ndd, pd)
    np.testing.assert_allclose(nw, pw)


@pytest.mark.parametrize(
    "a,b,expected",
    [
        ("martha", "marhta", 0.9611),
        ("dixon", "dicksonx", 0.8133),
        ("jellyfish", "smellyfish", 0.8962),
        ("", "", 1.0),
        ("abc", "", 0.0),
        ("same", "same", 1.0),
    ],
)
def test_jaro_winkler_known_values(a, b, expected):
    assert native.jaro_winkler(a, b) == pytest.approx(expected, abs=1e-3)


def test_jaro_winkler_native_matches_python():
    cases = [
        ("alice smith", "alice smyth"),
        ("bob", "robert"),
        ("acme corp", "acme corporation"),
        ("x", "y"),
    ]
    for a, b in cases:
        assert native.jaro_winkler(a, b) == pytest.approx(
            native._jw_py(a, b), abs=1e-9
        )


def test_jaro_winkler_batch():
    out = native.jaro_winkler_batch(["martha", "dixon"], ["marhta", "dicksonx"])
    assert out[0] == pytest.approx(0.9611, abs=1e-3)
    assert out[1] == pytest.approx(0.8133, abs=1e-3)


def test_jaro_winkler_unicode_consistent_across_backends():
    """Non-ASCII strings score identically with and without the native
    lib (code points are the contract, not UTF-8 bytes)."""
    pairs = [("Café Corp", "Cafe Corp"), ("Ångström", "Angstrom"),
             ("naïve", "naive"), ("plain", "plane")]
    for a, b in pairs:
        assert native.jaro_winkler(a, b) == pytest.approx(
            native._jw_py(a, b), abs=1e-12)
    got = native.jaro_winkler_batch([a for a, _ in pairs], [b for _, b in pairs])
    np.testing.assert_allclose(got, [native._jw_py(a, b) for a, b in pairs],
                               atol=1e-12)


# ───────────── the build, and against muninn_tpu.native ─────────────


def test_library_builds_under_build_dir():
    """The port compiles its own copy of the sources into the git-ignored
    build/native/ at the repo root, never next to them, and ships no
    binary."""
    native._load()
    path = native.library_path()
    assert path.is_file()
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libmuninn_host-") and path.suffix == ".so"
    assert not list((REPO / "muninn_tpu_torch" / "native").rglob("*.so"))
    tracked = subprocess.run(["git", "ls-files", "muninn_tpu_torch"], cwd=REPO,
                             capture_output=True, text=True).stdout.split()
    assert not [f for f in tracked if f.endswith(".so")]
    for name in ("muninn_host.cpp", "muninn_graph.cpp"):
        ours = (REPO / "muninn_tpu_torch/native/src" / name).read_text()
        theirs = (REPO / "muninn_tpu/native/src" / name).read_text()
        # the same code below each file's header comment
        assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]


def test_native_imports_neither_jax_nor_muninn_tpu():
    res = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import sys
        from muninn_tpu_torch import native
        native._load()
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "muninn_tpu")]
        assert not bad, bad
    """)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_interning_and_csr_match_jax(rng):
    strings = [f"node{i % 97}" for i in rng.integers(0, 1000, 400)]
    a, b = native.InternTable(), jnative.InternTable()
    np.testing.assert_array_equal(a.add(strings), b.add(strings))
    np.testing.assert_array_equal(a.find(strings[::3] + ["zz"]),
                                  b.find(strings[::3] + ["zz"]))
    e, v = 3000, 200
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    for weights in (w, None):
        for x, y in zip(native.csr_build(src, dst, weights, v),
                        jnative.csr_build(src, dst, weights, v)):
            np.testing.assert_array_equal(x, y)
    d_src = rng.integers(0, v, 300).astype(np.int32)
    d_dst = rng.integers(0, v, 300).astype(np.int32)
    d_w = rng.random(300).astype(np.float32)
    d_op = rng.integers(0, 2, 300).astype(np.uint8)
    for x, y in zip(
            native.csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op, True),
            jnative.csr_apply_delta(src, dst, w, d_src, d_dst, d_w, d_op, True)):
        np.testing.assert_array_equal(x, y)
    pa = ["martha", "Café Corp", "acme corp"]
    pb = ["marhta", "Cafe Corp", "acme corporation"]
    np.testing.assert_array_equal(native.jaro_winkler_batch(pa, pb),
                                  jnative.jaro_winkler_batch(pa, pb))


def test_graph_kernels_match_jax(rng):
    """Every graph host kernel, the port's library against JAX's, on the
    same edges: bitwise equal outputs."""
    v, e = 90, 500
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.uniform(0.5, 2.0, e).astype(np.float32)
    off, _, d, _ = native.csr_build(src, dst, w, v)
    deg = np.bincount(src, weights=w, minlength=v).astype(np.float32)
    calls = [
        ("graph_bfs", (off, d, 3, 5)),
        ("graph_dfs", (off, d, 3, v)),
        ("graph_components", (src, dst, v)),
        ("graph_pagerank", (src, dst, w, deg, 0.85, 20, True)),
        ("graph_sssp", (src, dst, w, v, 3)),
        ("graph_brandes", (src, dst, w, v, np.arange(0, v, 7), True, True)),
        ("graph_closeness", (src, dst, w, v, False, True)),
        ("graph_leiden", (src, dst, w, v, 1.0, 20, 7)),
        ("node2vec_train_host", (src, dst, w, v, 8, 1.0, 0.5, 2, 6, 2, 2,
                                 0.025, 1, 3)),
    ]
    for name, args in calls:
        ours, theirs = getattr(native, name)(*args), getattr(jnative, name)(*args)
        if not isinstance(ours, tuple):
            ours, theirs = (ours,), (theirs,)
        assert len(ours) == len(theirs), name
        for x, y in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
