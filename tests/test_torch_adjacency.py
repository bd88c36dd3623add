"""The port's ``GraphCache`` (``muninn_tpu_torch.graph.adjacency``) on CPU
tensors, against its own replay semantics and against
``muninn_tpu.graph.adjacency``.

Mirrors the twelve ``GraphCache`` cases of tests/test_persistence.py and
tests/test_graph.py's ``test_graphcache_churn_differential_representative``
and ``test_incremental_patch_bit_identical_to_rebuild``. Then the
differentials: the same mutations give both packages the same COO and the
same patched device CSR; checkpoints load in both directions with equal
nodes, edges and block layout and equal BFS, components and PageRank; the
numpy carry-across (``graph.convert``) both ways.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json
import os
import time

import numpy as np
import pytest
import torch

from muninn_tpu.graph.adjacency import GraphCache as JaxGraphCache
from muninn_tpu_torch.graph import Graph, GraphCache
from muninn_tpu_torch.graph.convert import (
    graph_cache_from_numpy,
    graph_cache_to_numpy,
)
from muninn_tpu_torch.io.checkpoint import DeltaLog

CPU = "cpu"


def _cache(*args, **kw):
    return GraphCache.from_edges(*args, device=CPU, **kw)


# ───────────── tests/test_persistence.py's GraphCache cases ─────────────


def test_graph_cache_lazy_freshness(rng):
    gc = _cache(["a", "b"], ["b", "c"])
    gen0 = gc.generation
    g = gc.graph()
    assert {n for n, _, _ in g.bfs("a")} == {"a", "b", "c"}
    # mutation queues a delta; read refreshes lazily
    gc.add_edges(["c"], ["d"])
    assert gc.delta_count == 1
    g2 = gc.graph()
    assert gc.delta_count == 0
    assert gc.generation > gen0
    assert {n for n, _, _ in g2.bfs("a")} == {"a", "b", "c", "d"}


def test_graph_cache_delete_edges(rng):
    gc = _cache(["a", "b", "c"], ["b", "c", "d"])
    gc.remove_edges(["b"], ["c"])
    g = gc.graph()
    assert {n for n, _, _ in g.bfs("a")} == {"a", "b"}
    assert gc.num_edges == 2


def test_graph_cache_incremental_patches_device_csr(rng):
    """incremental_rebuild applies a mixed delta to the device CSRs in place
    and the result is identical to a from-scratch build of the post-delta
    COO."""
    V, E = 150, 900
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    w = rng.random(E).astype(np.float32)
    gc = _cache(src.tolist(), dst.tolist(), w)
    g = gc.graph()
    g.csr("forward"); g.csr("reverse"); g.csr("both")

    gc.add_edges(
        rng.integers(0, V, 50).tolist(), rng.integers(0, V, 50).tolist(),
        rng.random(50).astype(np.float32),
    )
    di = rng.choice(E, 30, replace=False)
    gc.remove_edges(src[di].tolist(), dst[di].tolist())
    gc.remove_edges([int(src[0])], [int(dst[0])])
    gc.add_edges([int(src[0])], [int(dst[0])], [9.0])  # delete-then-re-add
    gc.incremental_rebuild()
    g2 = gc.graph()
    assert g2 is g, "incremental keeps the live graph object"

    ref = Graph(gc.nodes, gc._src.copy(), gc._dst.copy(), gc._w.copy(),
                device=CPU)
    for direction in ("forward", "reverse", "both"):
        ca, cb = g2.csr(direction), ref.csr(direction)
        assert ca.e_valid == cb.e_valid
        e = ca.e_valid
        np.testing.assert_array_equal(ca.offsets.numpy(), cb.offsets.numpy())
        np.testing.assert_array_equal(ca.s()[:e].numpy(), cb.s()[:e].numpy())
        np.testing.assert_array_equal(ca.dst[:e].numpy(), cb.dst[:e].numpy())
        np.testing.assert_allclose(ca.w()[:e].numpy(), cb.w()[:e].numpy())

    pr, pr_ref = g2.pagerank(), ref.pagerank()
    for k in pr:
        assert abs(pr[k] - pr_ref[k]) < 1e-6

    # a delta that adds a new node falls back to full rebuild
    gc.add_edges(["fresh-node"], [int(src[1])])
    gc.incremental_rebuild()
    assert gc.num_nodes == V + 1
    assert gc.graph().num_nodes == V + 1


def test_graph_cache_in_order_delta_replay(rng):
    """Deltas replay sequentially: delete-then-re-add in one pending batch
    keeps the edge, and one delete removes only one of two parallel
    duplicate edges (reference graph_csr.c:219-247)."""
    gc = _cache(["a", "a"], ["b", "b"])  # duplicate edge
    gc.remove_edges(["a"], ["b"])
    assert gc.graph() is not None
    assert gc.num_edges == 1  # one duplicate survives

    gc.remove_edges(["a"], ["b"])
    gc.add_edges(["a"], ["b"])
    gc.graph()
    assert gc.num_edges == 1  # delete-then-re-add keeps the edge

    gc.add_edges(["x"], ["y"])
    gc.remove_edges(["x"], ["y"])
    gc.graph()
    assert gc.num_edges == 1  # same-batch insert+delete cancels


def test_graph_cache_degrees(rng):
    gc = _cache(["a", "a", "b"], ["b", "c", "c"], weights=[2.0, 3.0, 4.0])
    deg = gc.degrees()
    # (in, out, w_in, w_out)
    assert deg["a"] == (0, 2, 0.0, 5.0)
    assert deg["c"] == (2, 0, 7.0, 0.0)


def test_graph_cache_save_load_with_delta_log(rng, tmp_path):
    log = tmp_path / "delta.jsonl"
    gc = _cache(["a"], ["b"], log_path=str(log))
    gc.save(tmp_path / "gc")          # clears the log
    gc.add_edges(["b"], ["c"])        # post-checkpoint mutation -> log
    assert len(DeltaLog(log)) == 1

    gc2 = GraphCache.load(tmp_path / "gc", log_path=str(log), device=CPU)
    g = gc2.graph()
    assert {n for n, _, _ in g.bfs("a")} == {"a", "b", "c"}


def test_graph_cache_explicit_rebuild_commands(rng):
    gc = _cache(["a"], ["b"])
    gc.add_edges(["b"], ["c"])
    gc.incremental_rebuild()
    assert gc.delta_count == 0
    gc.add_edges(["c"], ["d"])
    gc.rebuild()
    assert gc.num_edges == 3


def test_graph_cache_incremental_threshold_boundary(rng):
    # delta <= max(10, E/10) -> incremental; more -> full rebuild.
    # Both paths must converge to the same edge set.
    gc = _cache([f"n{i}" for i in range(200)],
                [f"n{i+1}" for i in range(200)])
    gen0 = gc.generation
    gc.add_edges(["n0"] * 10, [f"m{i}" for i in range(10)])   # == threshold min
    gc.graph()
    assert gc.generation == gen0 + 1
    assert gc.num_edges == 210
    gc.add_edges(["n1"] * 50, [f"q{i}" for i in range(50)])   # > E/10 -> full
    gc.graph()
    assert gc.num_edges == 260


def test_graph_cache_block_granular_save(rng, tmp_path, monkeypatch):
    """save() rewrites only dirty blocks: a small delta after a big save
    must not touch clean block files (the reference's 4096-node-block
    rewrite granularity, src/graph_csr.c:341-478)."""
    V, E = 500, 40_000
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    gc = _cache(src.tolist(), dst.tolist())
    gc_blocks = 4096
    monkeypatch.setattr(GraphCache, "BLOCK_EDGES", gc_blocks)
    d = tmp_path / "ck"
    gc.save(d)
    files = sorted(d.glob("block_*.npz"))
    assert len(files) == -(-E // gc_blocks)
    mtimes0 = {f.name: f.stat().st_mtime_ns for f in files}
    time.sleep(0.01)

    # small mixed delta: delete 3 edges from block 0, insert 5
    gc.remove_edges(src[:3].tolist(), dst[:3].tolist())
    gc.add_edges(rng.integers(0, V, 5).tolist(), rng.integers(0, V, 5).tolist())
    gc.rebuild()
    gc.save(d)
    files1 = sorted(d.glob("block_*.npz"))
    changed = [f.name for f in files1
               if mtimes0.get(f.name) != f.stat().st_mtime_ns]
    # only the deletion-owning block(s) + the tail block rewrite
    assert len(changed) <= 3, changed
    assert f"block_{len(files) - 1:05d}.npz" in changed

    # round trip equals the live arrays
    gc2 = GraphCache.load(d, device=CPU)
    np.testing.assert_array_equal(gc2._src, gc._src)
    np.testing.assert_array_equal(gc2._dst, gc._dst)
    np.testing.assert_array_equal(gc2._w, gc._w)
    assert gc2.nodes.ids == gc.nodes.ids
    # incremental save continues to work from the loaded instance
    gc2.add_edges([0], [1])
    gc2.rebuild()
    gc2.save(d)
    gc3 = GraphCache.load(d, device=CPU)
    np.testing.assert_array_equal(gc3._src, gc2._src)


def test_graph_cache_save_load_unweighted_roundtrip_blocks(tmp_path):
    gc = _cache(["a", "b", "c"], ["b", "c", "a"])
    gc.save(tmp_path / "g")
    gc2 = GraphCache.load(tmp_path / "g", device=CPU)
    assert gc2.num_edges == 3
    assert gc2.graph().bfs("a") == gc.graph().bfs("a")


def test_graph_cache_incremental_fast_path_matches_replay(rng):
    """The mirror-driven delete fast path (no O(E) replay scan) is identical
    to sequential replay across randomized mixed batches, including
    duplicate edges and delete-then-re-add."""
    V, E = 80, 400
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    w = rng.random(E).astype(np.float32)
    gc1 = _cache(src.tolist(), dst.tolist(), w)
    gc2 = _cache(src.tolist(), dst.tolist(), w)
    g1 = gc1.graph()
    g1.csr("forward"); g1.csr("reverse")  # materialize -> incremental path
    for _batch in range(3):
        for _ in range(30):
            if rng.random() < 0.5:
                i = rng.integers(0, E)
                a, b = int(src[i]), int(dst[i])
                gc1.remove_edges([a], [b]); gc2.remove_edges([a], [b])
            else:
                a, b = int(rng.integers(0, V)), int(rng.integers(0, V))
                ww = float(rng.random())
                gc1.add_edges([a], [b], [ww]); gc2.add_edges([a], [b], [ww])
        gc1.incremental_rebuild()
        gc2.rebuild()
        np.testing.assert_array_equal(gc1._src, gc2._src)
        np.testing.assert_array_equal(gc1._dst, gc2._dst)
        np.testing.assert_allclose(gc1._w, gc2._w)


def test_graph_cache_nodes_crc_guards_id_flips(tmp_path):
    """nodes.jsonl is guarded by the manifest's running crc32: a flipped
    byte raises, incremental saves keep the crc consistent, and pre-crc
    checkpoints still load."""
    gc = _cache(["alice", "bob"], ["bob", "carol"])
    p = tmp_path / "ck"
    gc.save(p)
    # incremental append keeps the running crc valid
    gc.add_edges(["dave"], ["alice"])
    gc.save(p)
    gc2 = GraphCache.load(p, device=CPU)
    assert gc2.nodes.id_of(3) == "dave"

    raw = bytearray((p / "nodes.jsonl").read_bytes())
    raw[2] ^= 0x08
    (p / "nodes.jsonl").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32"):
        GraphCache.load(p, device=CPU)

    # pre-crc checkpoint (older manifest without the key) still loads
    m = json.loads((p / "manifest.json").read_text())
    del m["nodes_crc32"]
    (p / "manifest.json").write_text(json.dumps(m))
    GraphCache.load(p, device=CPU)  # no crc key -> compat path, no raise


# ───────────── tests/test_graph.py's GraphCache cases ─────────────


@pytest.mark.parametrize("seed", [3, 11])
def test_graphcache_churn_differential_representative(seed, tmp_path):
    """Random interleavings of inserts / deletes / lazy reads / explicit
    rebuilds vs an in-order list oracle with the reference's sequential
    replay semantics (a delete removes the FIRST live matching occurrence,
    ``src/graph_csr.c:219-247``); COO storage order must match the replay
    exactly through incremental patches, and block-granular save/load must
    round-trip mid-churn."""
    trng = np.random.default_rng(seed)
    weighted = bool(seed % 2)
    edges = []
    gc = GraphCache(weighted=weighted, device=CPU)
    gc.BLOCK_EDGES = 64
    s0 = trng.integers(0, 50, 120).tolist()
    d0 = trng.integers(0, 50, 120).tolist()
    w0 = (trng.uniform(0.5, 2.0, 120).astype(np.float32)
          if weighted else np.ones(120, np.float32))
    gc.add_edges(s0, d0, w0 if weighted else None)
    edges += [(a, b, float(w)) for a, b, w in zip(s0, d0, w0.tolist())]
    gc.graph()
    for phase in range(4):
        if trng.random() < 0.7:
            gc.graph().csr("forward")
        if trng.random() < 0.5:
            gc.graph().csr("reverse")
        ins_n = int(trng.integers(2, 12))
        si = trng.integers(0, 58, ins_n).tolist()  # some new nodes
        di = trng.integers(0, 58, ins_n).tolist()
        wi = (trng.uniform(0.5, 2.0, ins_n).astype(np.float32)
              if weighted else np.ones(ins_n, np.float32))
        gc.add_edges(si, di, wi if weighted else None)
        edges += [(a, b, float(w)) for a, b, w in zip(si, di, wi.tolist())]
        kill = [edges[int(trng.integers(0, len(edges)))][:2]
                for _ in range(int(trng.integers(1, 10)))] + [(99, 98)]
        gc.remove_edges([k[0] for k in kill], [k[1] for k in kill])
        for s, d in kill:
            for i, e in enumerate(edges):
                if e[0] == s and e[1] == d:
                    del edges[i]
                    break
        mode = trng.random()
        if mode < 0.4:
            gc.incremental_rebuild()
        elif mode < 0.6:
            gc.rebuild()
        gc.graph()  # lazy path otherwise
        ids = gc.nodes.ids
        got = [(ids[s], ids[d], float(w)) for s, d, w in zip(
            gc._src.tolist(), gc._dst.tolist(), gc._w.tolist())]
        assert got == edges, f"seed={seed} phase={phase}"
    gc.save(tmp_path / f"churn{seed}")
    gc2 = GraphCache.load(tmp_path / f"churn{seed}", device=CPU)
    ids2 = gc2.nodes.ids
    got2 = [(ids2[s], ids2[d], float(w)) for s, d, w in zip(
        gc2._src.tolist(), gc2._dst.tolist(), gc2._w.tolist())]
    assert got2 == edges, f"seed={seed} reload"


def test_incremental_patch_bit_identical_to_rebuild(rng):
    """Device arrays after an incremental patch EXACTLY equal the arrays a
    full rebuild produces (order included) — the host mirror / device order
    invariant the position-based patch relies on."""
    n, e = 200, 3000
    src = rng.integers(0, n, e).astype(np.int64)
    dst = rng.integers(0, n, e).astype(np.int64)
    src[50:60] = src[0]  # parallel duplicates on purpose
    dst[50:60] = dst[0]
    gc = _cache(src, dst)
    g = gc.graph()
    for direction in ("forward", "reverse"):
        g.csr(direction)

    ins_s = rng.integers(0, n, 80).astype(np.int64)
    ins_d = rng.integers(0, n, 80).astype(np.int64)
    del_idx = rng.choice(e, 40, replace=False)
    gc.remove_edges(src[del_idx].tolist(), dst[del_idx].tolist())
    gc.add_edges(ins_s.tolist(), ins_d.tolist())
    gc.incremental_rebuild()
    g2 = gc.graph()
    patched = {d: g2.csr(d) for d in ("forward", "reverse")}

    gc2 = _cache(np.array([gc.nodes.id_of(int(i)) for i in gc._src]),
                 np.array([gc.nodes.id_of(int(i)) for i in gc._dst]))
    g3 = gc2.graph()
    for d in ("forward", "reverse"):
        a, b = patched[d], g3.csr(d)
        e_v = a.e_valid
        assert e_v == b.e_valid
        np.testing.assert_array_equal(a.offsets.numpy(), b.offsets.numpy())
        np.testing.assert_array_equal(a.src[:e_v].numpy(), b.src[:e_v].numpy())
        np.testing.assert_array_equal(a.dst[:e_v].numpy(), b.dst[:e_v].numpy())


# ───────────── against muninn_tpu.graph.adjacency ─────────────


def _churn(gc, seed):
    """The same seeded mixed batches into a cache of either package:
    inserts among existing and new nodes, deletes of live and absent
    edges, a device CSR built between batches."""
    r = np.random.default_rng(seed)
    for batch in range(4):
        g = gc.graph()
        g.csr("forward")
        if batch % 2:
            g.csr("reverse")
        live = list(zip(gc._src.tolist(), gc._dst.tolist()))
        ids = gc.nodes.ids
        kill = [live[int(i)] for i in r.integers(0, len(live), 12)]
        gc.remove_edges([ids[s] for s, _ in kill] + ["absent"],
                        [ids[d] for _, d in kill] + [ids[0]])
        hi = 60 if batch == 3 else 40  # the last batch adds new nodes
        gc.add_edges(r.integers(0, hi, 15).tolist(),
                     r.integers(0, hi, 15).tolist(),
                     r.uniform(0.5, 2.0, 15).astype(np.float32))
        gc.graph()
    return gc


def test_churn_matches_jax(rng):
    """The same mutations give both packages the same COO (order included)
    and the same device CSRs, patched in place or rebuilt."""
    src = rng.integers(0, 40, 300)
    dst = rng.integers(0, 40, 300)
    w = rng.uniform(0.5, 2.0, 300).astype(np.float32)
    ours = _churn(_cache(src, dst, w), 5)
    ref = _churn(JaxGraphCache.from_edges(src, dst, w), 5)
    assert ours.nodes.ids == ref.nodes.ids
    assert ours.generation == ref.generation
    for a in ("_src", "_dst", "_w"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(ref, a))
    for d in ("forward", "reverse"):
        a, b = ours.graph().csr(d), ref.graph().csr(d)
        assert a.e_valid == b.e_valid
        np.testing.assert_array_equal(a.offsets.numpy(), np.asarray(b.offsets))
        for x, y in ((a.s(), b.s()), (a.dst, b.dst), (a.w(), b.w())):
            np.testing.assert_array_equal(x[:a.e_valid].numpy(),
                                          np.asarray(y)[:a.e_valid])


def _same_cache(a, b):
    """Equal nodes, edges and block layout, and equal BFS, components and
    PageRank results."""
    assert list(a.nodes.ids) == list(b.nodes.ids)
    for k in ("_src", "_dst", "_w"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)))
    assert a._block_lens == b._block_lens
    assert a.weighted == b.weighted and a.generation == b.generation
    ga, gb = a.graph(), b.graph()
    start = ga.nodes.id_of(0)
    assert ga.bfs(start) == gb.bfs(start)
    assert ga.connected_components() == gb.connected_components()
    pa, pb = ga.pagerank(), gb.pagerank()
    assert set(pa) == set(pb)
    assert all(abs(pa[k] - pb[k]) < 1e-6 for k in pa)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(rng, tmp_path, monkeypatch, direction):
    """A checkpoint written by either package loads in the other, through
    an incremental save (only the dirty blocks rewritten) too."""
    monkeypatch.setattr(GraphCache, "BLOCK_EDGES", 256)
    monkeypatch.setattr(JaxGraphCache, "BLOCK_EDGES", 256)
    src = [f"v{i}" for i in rng.integers(0, 90, 1000)]
    dst = [f"v{i}" for i in rng.integers(0, 90, 1000)]
    w = rng.uniform(0.5, 2.0, 1000).astype(np.float32)
    if direction == "jax_to_port":
        writer = JaxGraphCache.from_edges(src, dst, w)
        load = lambda p: GraphCache.load(p, device=CPU)  # noqa: E731
    else:
        writer = _cache(src, dst, w)
        load = JaxGraphCache.load
    p = tmp_path / "ck"
    writer.save(p)
    _same_cache(load(p), writer)
    writer.remove_edges(src[:5], dst[:5])
    writer.add_edges(["v1", "new"], ["new", "v2"], [1.5, 2.5])
    writer.save(p)
    _same_cache(load(p), writer)


def test_port_and_jax_write_identical_files(rng, tmp_path):
    """Byte for byte: the same cache saved by both packages gives the same
    manifest, nodes.jsonl and block arrays."""
    src = rng.integers(0, 50, 500)
    dst = rng.integers(0, 50, 500)
    _cache(src, dst).save(tmp_path / "port")
    JaxGraphCache.from_edges(src, dst).save(tmp_path / "jax")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for f in names:
        if f.endswith(".npz"):
            a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert ((tmp_path / "port" / f).read_bytes()
                    == (tmp_path / "jax" / f).read_bytes()), f


@pytest.mark.parametrize("ids", ["strings", "ints", "mixed"])
def test_convert_crosses_packages(rng, tmp_path, ids):
    """graph.convert carries a cache's state across in memory, both ways,
    its block layout included; mixed id types survive."""
    n = 40
    names = {"strings": [f"s{i}" for i in range(n)],
             "ints": list(range(100, 100 + n)),
             "mixed": [f"s{i}" if i % 3 else i for i in range(n)]}[ids]
    src = [names[i] for i in rng.integers(0, n, 200)]
    dst = [names[i] for i in rng.integers(0, n, 200)]
    ref = JaxGraphCache.from_edges(src, dst)
    ref.save(tmp_path / "jax")  # sets a block layout
    ref.add_edges(src[:3], dst[4:7])
    ours = graph_cache_from_numpy(graph_cache_to_numpy(ref), device=CPU)
    _same_cache(ours, ref)
    back = JaxGraphCache()
    state = graph_cache_to_numpy(ours)
    back.nodes._ids = list(state["node_ids"].tolist())
    back.nodes._index = {u: i for i, u in enumerate(back.nodes._ids)}
    back._src, back._dst, back._w = state["src"], state["dst"], state["w"]
    back.weighted, back.generation = state["weighted"], state["generation"]
    back._block_lens = state["block_lens"]
    _same_cache(back, ours)


def test_convert_refuses_bad_state(rng):
    state = graph_cache_to_numpy(_cache(["a", "b"], ["b", "c"]))
    with pytest.raises(ValueError, match="outside"):
        graph_cache_from_numpy({**state, "dst": np.array([1, 3], np.int32)},
                               device=CPU)
    with pytest.raises(ValueError, match="block_lens"):
        graph_cache_from_numpy({**state, "block_lens": [5]}, device=CPU)


# ───────────── the port's own ─────────────


def test_graph_view_sets_every_init_attribute(rng):
    """graph() builds the Graph by __new__, setting everything
    Graph.__init__ sets (and the device-COO state it leaves to class
    defaults), and answers on the cache's device."""
    src = rng.integers(0, 30, 100)
    dst = rng.integers(0, 30, 100)
    gc = _cache(src, dst)
    view = gc.graph()
    built = Graph(gc.nodes, gc._src.copy(), gc._dst.copy(), None, device=CPU)
    assert set(vars(built)) <= set(vars(view))
    assert view._dev_coo is None and view._both is None
    assert view.device == torch.device(CPU)
    assert not view.device_native
    assert view.pagerank(backend="device") == pytest.approx(
        built.pagerank(backend="device"))


def test_graph_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        assert GraphCache().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphCache()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphCache.from_edges(["a"], ["b"])
