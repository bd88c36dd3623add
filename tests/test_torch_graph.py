"""The port's graph core (``muninn_tpu_torch.graph``) on CPU tensors: against
networkx, against its own host engine, and against ``muninn_tpu.graph`` on
the same seeded edges.

Mirrors the traversal, shortest-path, components and PageRank cases of
tests/test_graph.py (each with ``backend="auto"``, which routes these small
graphs to the host engine as in JAX, and with ``backend="device"``, the
fixpoints), and its device-build cases; centrality, communities, the
selector and ``GraphCache`` have test files of their own. JAX's
``test_chunked_fixpoints_match_one_shot`` and
``test_coo_drop_derives_opposite_direction`` have no counterpart: the port
has neither the chunked fixpoints nor the COO drop.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from muninn_tpu.graph import Graph as JaxGraph
from muninn_tpu.graph import core as jcore
from muninn_tpu.graph import traversal as jtrv
from muninn_tpu_torch import native
from muninn_tpu_torch.graph import Graph, core, traversal as trv
from muninn_tpu_torch.graph.convert import graph_from_numpy, graph_to_numpy

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
DIRECTIONS = ("forward", "reverse", "both")
BACKENDS = ("auto", "device")


def random_graph(rng, n=60, p=0.08, directed=True, weighted=False, seed=1):
    g = nx.gnp_random_graph(n, p, seed=seed, directed=directed)
    src = [f"n{u}" for u, v in g.edges()]
    dst = [f"n{v}" for u, v in g.edges()]
    w = None
    if weighted:
        w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
        for (u, v), wt in zip(g.edges(), w):
            g[u][v]["weight"] = float(wt)
    return Graph.from_edges(src, dst, w, device=CPU), g


# ───────────── tests/test_graph.py's cases, against networkx ─────────────


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_depths_match_networkx(rng, backend):
    mg, g = random_graph(rng, n=40, p=0.1)
    src0 = next(iter(g.nodes()))
    rows = mg.bfs(f"n{src0}", direction="forward", backend=backend)
    want = nx.single_source_shortest_path_length(g, src0)
    got = {n: d for n, d, _ in rows}
    assert got == {f"n{k}": v for k, v in want.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_max_depth(rng, backend):
    mg, g = random_graph(rng, n=40, p=0.1)
    src0 = next(iter(g.nodes()))
    rows = mg.bfs(f"n{src0}", max_depth=2, backend=backend)
    assert all(d <= 2 for _, d, _ in rows)
    want = nx.single_source_shortest_path_length(g, src0, cutoff=2)
    assert {n: d for n, d, _ in rows} == {f"n{k}": v for k, v in want.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_parent_is_predecessor(rng, backend):
    mg, g = random_graph(rng, n=40, p=0.1)
    src0 = next(iter(g.nodes()))
    for n, d, p in mg.bfs(f"n{src0}", backend=backend):
        if p is not None:
            assert g.has_edge(int(p[1:]), int(n[1:]))


def test_dfs_visits_reachable_set(rng):
    mg, g = random_graph(rng, n=40, p=0.1)
    src0 = next(iter(g.nodes()))
    rows = mg.dfs(f"n{src0}")
    want = set(nx.descendants(g, src0)) | {src0}
    assert {int(n[1:]) for n, _, _ in rows} == want
    depth = {n: d for n, d, _ in rows}
    for n, d, p in rows:
        if p is not None:
            assert depth[p] == d - 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_shortest_path_unweighted(rng, backend):
    mg, g = random_graph(rng, n=50, p=0.1)
    nodes = list(g.nodes())
    s, t = nodes[0], nodes[-1]
    path, dist = mg.shortest_path(f"n{s}", f"n{t}", weighted=False,
                                  backend=backend)
    try:
        want = nx.shortest_path_length(g, s, t)
        assert dist == pytest.approx(want)
        assert len(path) == want + 1
        for a, b in zip(path, path[1:]):
            assert g.has_edge(int(a[1:]), int(b[1:]))
    except nx.NetworkXNoPath:
        assert path == [] and np.isinf(dist)


@pytest.mark.parametrize("backend", BACKENDS)
def test_shortest_path_weighted(rng, backend):
    mg, g = random_graph(rng, n=50, p=0.12, weighted=True)
    nodes = list(g.nodes())
    s, t = nodes[1], nodes[-2]
    path, dist = mg.shortest_path(f"n{s}", f"n{t}", weighted=True,
                                  backend=backend)
    try:
        want = nx.dijkstra_path_length(g, s, t)
        assert dist == pytest.approx(want, rel=1e-5)
        for a, b in zip(path, path[1:]):
            assert g.has_edge(int(a[1:]), int(b[1:]))
    except nx.NetworkXNoPath:
        assert path == [] and np.isinf(dist)


@pytest.mark.parametrize("backend", BACKENDS)
def test_connected_components(rng, backend):
    mg, g = random_graph(rng, n=60, p=0.03)
    comp = mg.connected_components(backend=backend)
    # edge-list graphs have no isolated nodes — drop them from the oracle
    ug = g.to_undirected()
    want_sets = [s for s in nx.connected_components(ug)
                 if len(s) > 1 or any(True for _ in ug.edges(next(iter(s))))]
    by_id = {}
    for node, (cid, size) in comp.items():
        by_id.setdefault(cid, set()).add(int(node[1:]))
    got_sets = sorted(map(frozenset, by_id.values()), key=min)
    assert got_sets == sorted(map(frozenset, want_sets), key=min)
    for node, (cid, size) in comp.items():
        assert size == len(by_id[cid])


@pytest.mark.parametrize("backend", BACKENDS)
def test_pagerank_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=50, p=0.1)
    got = mg.pagerank(damping=0.85, iterations=60, backend=backend)
    want = nx.pagerank(g, alpha=0.85, tol=1e-10)
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=2e-4)


def test_temporal_filter():
    src = ["a", "b", "c"]
    dst = ["b", "c", "d"]
    ts = [1.0, 5.0, 9.0]
    mg = Graph.from_edges(src, dst, timestamps=ts, time_start=2, time_end=8,
                          device=CPU)
    assert mg.num_edges == 1
    for backend in BACKENDS:
        rows = mg.bfs("b", backend=backend)
        assert {n for n, _, _ in rows} == {"b", "c"}


def test_unknown_node_raises():
    mg = Graph.from_edges(["a"], ["b"], device=CPU)
    with pytest.raises(KeyError):
        mg.bfs("zzz")


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_reverse_direction(backend):
    mg = Graph.from_edges(["a", "b"], ["b", "c"], device=CPU)
    fwd = {n for n, _, _ in mg.bfs("c", direction="forward", backend=backend)}
    rev = {n for n, _, _ in mg.bfs("c", direction="reverse", backend=backend)}
    assert fwd == {"c"}
    assert rev == {"a", "b", "c"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_pagerank_weighted(rng, backend):
    mg, g = random_graph(rng, n=40, p=0.12, weighted=True)
    got = mg.pagerank(damping=0.85, iterations=60, weighted=True,
                      backend=backend)
    want = nx.pagerank(g, alpha=0.85, weight="weight", tol=1e-10)
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=3e-4)


def test_device_graph_matches_host_build(rng):
    """Graph.from_device_edges (device-resident COO, device stable-sort
    CSR, identity node table) gives the same CSRs and analytics as the
    host-interned path."""
    n, e = 400, 2500
    s = rng.integers(0, n, e)
    d = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    gh = Graph.from_edges(s, d, w, device=CPU)
    gd = Graph.from_device_edges(torch.from_numpy(s), torch.from_numpy(d),
                                 num_nodes=n, weights=torch.from_numpy(w))
    assert gd.device.type == "cpu"  # the tensors' device
    for direction in DIRECTIONS:
        ch, cd = gh.csr(direction), gd.csr(direction)
        assert ch.e_valid == cd.e_valid and ch.max_deg == cd.max_deg
        ev = ch.e_valid
        assert torch.equal(ch.offsets, cd.offsets)
        assert torch.equal(ch.s()[:ev], cd.s()[:ev])
        assert torch.equal(ch.dst[:ev], cd.dst[:ev])
        assert torch.equal(ch.w()[:ev], cd.w()[:ev])
    np.testing.assert_allclose(
        gh.pagerank(backend="device", as_array=True),
        gd.pagerank(backend="device", as_array=True), rtol=1e-6)
    np.testing.assert_array_equal(
        gh.connected_components(backend="device", as_array=True),
        gd.connected_components(backend="device", as_array=True))
    dh, ph = gh.bfs(0, as_array=True, backend="device")
    dd_, pd = gd.bfs(0, as_array=True, backend="device")
    np.testing.assert_array_equal(dh, dd_)
    np.testing.assert_array_equal(ph, pd)


def test_device_graph_lazy_host_mirrors(rng):
    """Host mirrors materialize once on first host-side touch and the
    host backend then agrees; dict-mode results still work."""
    n, e = 200, 1200
    s = rng.integers(0, n, e)
    d = rng.integers(0, n, e)
    gd = Graph.from_device_edges(s, d, num_nodes=n, device=CPU)
    assert gd.num_edges == e and gd.num_nodes == n
    assert gd._src_np is None  # nothing downloaded yet
    pr_dev = gd.pagerank(backend="device", as_array=True)
    assert gd._src_np is None  # device analytics keep it lazy
    np.testing.assert_array_equal(gd._src, s.astype(np.int32))
    np.testing.assert_allclose(
        gd.pagerank(backend="host", as_array=True), pr_dev,
        rtol=2e-4, atol=1e-7)
    cc = gd.connected_components()
    assert isinstance(cc, dict) and len(cc) == n
    assert gd.node_index(5) == 5
    with pytest.raises(KeyError):
        gd.node_index("zebra")
    with pytest.raises(KeyError):
        gd.nodes.find_or_add(n + 7)


def test_device_graph_auto_routing_stays_on_device(rng):
    """'auto' does not route an unmaterialized device-resident graph to
    the host engine, which would first download the whole COO. Once the
    mirrors exist, tiny graphs route host again."""
    n, e = 150, 800
    gd = Graph.from_device_edges(
        rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n, device=CPU)
    assert gd._use_host("auto", 0.0) is False
    pr = gd.pagerank(as_array=True)  # default backend='auto'
    assert gd._src_np is None        # no mirror download happened
    assert abs(float(pr.sum()) - 1.0) < 1e-3
    _ = gd._src                      # materialize mirrors explicitly
    assert gd._use_host("auto", 0.0) is True


def test_lean_device_graph_unweighted(rng):
    """from_device_edges without weights builds CSRs without src or
    weights, and all analytics agree with the host-interned build."""
    n, e = 250, 1500
    s = rng.integers(0, n, e)
    d = rng.integers(0, n, e)
    gh = Graph.from_edges(s, d, device=CPU)
    gd = Graph.from_device_edges(s, d, num_nodes=n, device=CPU)
    cd = gd.csr("forward")
    assert cd.weights is None and cd.src is None
    ch = gh.csr("forward")
    ev = ch.e_valid
    assert torch.equal(ch.s()[:ev], cd.s()[:ev])
    assert torch.equal(ch.w()[:ev], cd.w()[:ev])
    np.testing.assert_allclose(
        gh.pagerank(backend="device", as_array=True),
        gd.pagerank(backend="device", as_array=True), rtol=1e-5)
    dh, ph = gh.bfs(0, backend="device", as_array=True)
    dd, pd = gd.bfs(0, backend="device", as_array=True)
    np.testing.assert_array_equal(dh, dd)
    np.testing.assert_array_equal(ph, pd)
    np.testing.assert_array_equal(
        gh.connected_components(backend="device", as_array=True),
        gd.connected_components(backend="device", as_array=True))


# ───────────── against muninn_tpu.graph on the same edges ─────────────


def edge_pair(seed: int, weighted: bool, n: int = 90, e: int = 450):
    """The same seeded edges (sparse integer ids, so interning renumbers
    them) as a JAX graph and a port graph."""
    r = np.random.default_rng(seed)
    s = r.integers(0, n, e) * 3 + 7
    d = r.integers(0, n, e) * 3 + 7
    w = r.uniform(0.5, 2.0, e).astype(np.float32) if weighted else None
    return JaxGraph.from_edges(s, d, w), Graph.from_edges(s, d, w, device=CPU)


def built(g, direction):
    """A direction's CSR if the graph has built it, else None."""
    return {"forward": g._fwd, "reverse": g._rev, "both": g._both}[direction]


def assert_csr_equal(jc, tc):
    ev = jc.e_valid
    assert tc.e_valid == ev and tc.max_deg == jc.max_deg
    assert tc.capacity == jc.capacity
    np.testing.assert_array_equal(tc.offsets.numpy(), np.asarray(jc.offsets))
    np.testing.assert_array_equal(tc.s()[:ev].numpy(), np.asarray(jc.s()[:ev]))
    np.testing.assert_array_equal(tc.dst[:ev].numpy(), np.asarray(jc.dst[:ev]))
    np.testing.assert_array_equal(tc.w()[:ev].numpy(), np.asarray(jc.w()[:ev]))


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_arrays_match_jax(weighted):
    """DeviceCsr arrays equal JAX's for from_edges, from_device_edges and
    the 'both' merge of the device-built directions."""
    r = np.random.default_rng(3)
    n, e = 120, 700
    s, d = r.integers(0, n, e), r.integers(0, n, e)
    w = r.uniform(0.5, 2.0, e).astype(np.float32) if weighted else None
    jh, th = JaxGraph.from_edges(s, d, w), Graph.from_edges(s, d, w, device=CPU)
    jd = JaxGraph.from_device_edges(s, d, num_nodes=n, weights=w)
    td = Graph.from_device_edges(s, d, num_nodes=n, weights=w, device=CPU)
    for direction in DIRECTIONS:
        assert_csr_equal(jh.csr(direction), th.csr(direction))
        assert_csr_equal(jd.csr(direction), td.csr(direction))
    # the merge of two device-built directions, also on a host graph
    th2 = Graph.from_edges(s, d, w, device=CPU)
    th2.csr("forward"), th2.csr("reverse")
    assert_csr_equal(jh.csr("both"), th2.csr("both"))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_bfs_matches_jax(direction, weighted):
    jg, tg = edge_pair(11, weighted)
    start = jg.nodes.id_of(0)
    for backend in BACKENDS:
        assert (tg.bfs(start, direction=direction, backend=backend)
                == jg.bfs(start, direction=direction, backend=backend))
        for jx, tx in zip(
                jg.bfs(start, direction=direction, backend=backend,
                       as_array=True),
                tg.bfs(start, direction=direction, backend=backend,
                       as_array=True)):
            np.testing.assert_array_equal(tx, jx)
    assert (tg.bfs(start, max_depth=2, direction=direction, backend="device")
            == jg.bfs(start, max_depth=2, direction=direction,
                      backend="device"))


@pytest.mark.parametrize("weighted", [False, True])
def test_components_match_jax(weighted):
    jg, tg = edge_pair(12, weighted, n=150, e=160)  # sparse: many components
    for backend in BACKENDS:
        want = jg.connected_components(backend=backend)
        assert tg.connected_components(backend=backend) == want
        assert len({c for c, _ in want.values()}) > 5
        np.testing.assert_array_equal(
            tg.connected_components(backend=backend, as_array=True),
            jg.connected_components(backend=backend, as_array=True))


def path_cost(g, direction, path, weighted):
    """The cost of ``path`` along ``direction`` through g's edges (the
    cheapest parallel edge), asserting each hop is an edge."""
    s, d, w = g.host_coo(direction)
    cost = 0.0
    for a, b in zip(path, path[1:]):
        hop = (s == g.node_index(a)) & (d == g.node_index(b))
        assert hop.any(), (a, b)
        cost += float(w[hop].min()) if weighted else 1.0
    return cost


@pytest.mark.parametrize("weighted", [False, True])
def test_shortest_path_matches_jax(weighted):
    """Distances within 1e-5 relative of JAX's, on every direction and
    backend; both packages' paths are valid and optimal."""
    jg, tg = edge_pair(13, True)
    start = jg.nodes.id_of(0)
    ends = [jg.nodes.id_of(i) for i in range(1, jg.num_nodes, 11)]
    for direction in DIRECTIONS:
        for backend in BACKENDS:
            for t in ends:
                tp, td = tg.shortest_path(start, t, weighted=weighted,
                                          direction=direction, backend=backend)
                jp, jd = jg.shortest_path(start, t, weighted=weighted,
                                          direction=direction, backend=backend)
                if np.isinf(jd):
                    assert tp == [] and np.isinf(td)
                    continue
                assert td == pytest.approx(jd, rel=1e-5)
                for p in (tp, jp):
                    assert p[0] == start and p[-1] == t
                    assert path_cost(tg, direction, p, weighted) == (
                        pytest.approx(td, rel=1e-5))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_pagerank_matches_jax(direction, weighted):
    """PageRank within rtol 1e-5, atol 1e-7 of JAX's host path (all-double)
    and, unweighted, of JAX's device path. JAX's device path forms
    weighted out-degrees from an f32 prefix sum, whose cancellation error
    (about an ulp of the total weight) puts its weighted ranks farther
    than that from the exact ones; there the port is held to lie no
    farther from JAX's device ranks than those lie from JAX's host ranks,
    plus the tolerance."""
    for has_w in (False, True):
        jg, tg = edge_pair(14, has_w)
        kw = dict(direction=direction, weighted=weighted and has_w,
                  as_array=True)
        jh = jg.pagerank(backend="host", **kw)
        jd = jg.pagerank(backend="device", **kw)
        for backend in BACKENDS:
            got = tg.pagerank(backend=backend, **kw)
            np.testing.assert_allclose(got, jh, rtol=1e-5, atol=1e-7)
            if not kw["weighted"]:
                np.testing.assert_allclose(got, jd, rtol=1e-5, atol=1e-7)
            else:
                assert np.all(np.abs(got - jd)
                              <= np.abs(jd - jh) + 1e-5 * np.abs(jh) + 1e-7)
        assert tg.pagerank(backend="device", direction=direction) == pytest.approx(
            jg.pagerank(backend="host", direction=direction), rel=1e-5, abs=1e-7)


def test_fixpoints_on_jax_csr():
    """The port's fixpoints on JAX's own CSR arrays, carried across by
    graph/convert.py: the same BFS, components, PageRank and shortest
    path as JAX on them."""
    for device_built in (False, True):
        r = np.random.default_rng(15)
        n, e = 110, 600
        s, d = r.integers(0, n, e), r.integers(0, n, e)
        w = r.uniform(0.5, 2.0, e).astype(np.float32)
        jg = (JaxGraph.from_device_edges(s, d, num_nodes=n, weights=w)
              if device_built else JaxGraph.from_edges(s, d, w))
        for direction in DIRECTIONS:
            jg.csr(direction)
        tg = graph_from_numpy(graph_to_numpy(jg), device=CPU)
        assert tg.device_native == jg.device_native == device_built
        for direction in DIRECTIONS:
            assert_csr_equal(jg.csr(direction), built(tg, direction))
        start = jg.nodes.id_of(0)
        for direction in DIRECTIONS:
            for jx, tx in zip(jg.bfs(start, direction=direction,
                                     backend="device", as_array=True),
                              tg.bfs(start, direction=direction,
                                     backend="device", as_array=True)):
                np.testing.assert_array_equal(tx, jx)
            np.testing.assert_allclose(
                tg.pagerank(direction=direction, backend="device",
                            as_array=True),
                jg.pagerank(direction=direction, backend="host",
                            as_array=True), rtol=1e-5, atol=1e-7)
            t = jg.nodes.id_of(n // 2)
            assert tg.shortest_path(start, t, direction=direction,
                                    backend="device")[1] == pytest.approx(
                jg.shortest_path(start, t, direction=direction,
                                 backend="device")[1], rel=1e-5)
        np.testing.assert_array_equal(
            tg.connected_components(backend="device", as_array=True),
            jg.connected_components(backend="device", as_array=True))


def test_convert_round_trip_and_validation(rng):
    n, e = 80, 300
    s, d = rng.integers(0, n, e), rng.integers(0, n, e)
    tg = Graph.from_edges([f"v{x}" for x in s], [f"v{x}" for x in d],
                          device=CPU)
    tg.csr("reverse")
    state = graph_to_numpy(tg)
    back = graph_from_numpy(state, device=CPU)
    assert back.nodes.ids == tg.nodes.ids and not back.device_native
    assert_csr_equal(tg.csr("reverse"), back._rev)
    assert back._fwd is None and back.bfs("v3") == tg.bfs("v3")
    td = Graph.from_device_edges(s, d, num_nodes=n, device=CPU)
    td.csr("forward")
    back = graph_from_numpy(graph_to_numpy(td), device=CPU)
    assert back.device_native and td.device_native  # export downloads nothing
    assert_csr_equal(td.csr("forward"), back._fwd)
    bad = dict(state, reverse_offsets=state["reverse_offsets"][::-1].copy())
    with pytest.raises(ValueError, match="offsets"):
        graph_from_numpy(bad, device=CPU)
    bad = dict(state, dst=state["dst"] + n)
    with pytest.raises(ValueError, match="outside"):
        graph_from_numpy(bad, device=CPU)


def test_pull_fixpoints_match_jax():
    """seeded_bfs_depths_pull, multi_source_distances_pull and
    connected_components_pull (the merged 'both' CSR) on JAX's CSR arrays
    give JAX's results."""
    r = np.random.default_rng(16)
    n, e = 100, 500
    s, d = r.integers(0, n, e), r.integers(0, n, e)
    w = r.uniform(0.5, 2.0, e).astype(np.float32)
    jg = JaxGraph.from_edges(s, d, w)
    jc, jb = jg.csr("reverse"), jg.csr("both")
    tg = graph_from_numpy(graph_to_numpy(jg), device=CPU)
    tc, tb = tg._rev, tg._both
    init = np.full(jg.num_nodes, 2**30, np.int32)
    init[[0, 5, 9]] = [0, 2, 1]
    np.testing.assert_array_equal(
        trv.seeded_bfs_depths_pull(tc.offsets, tc.dst, torch.from_numpy(init),
                                   jg.num_nodes).numpy(),
        np.asarray(jtrv.seeded_bfs_depths_pull(jc.offsets, jc.dst,
                                               jnp.asarray(init),
                                               jg.num_nodes)))
    srcs = np.array([0, 3, 17], np.int32)
    np.testing.assert_allclose(
        trv.multi_source_distances_pull(tc.offsets, tc.dst, tc.w(),
                                        torch.from_numpy(srcs),
                                        jg.num_nodes).numpy(),
        np.asarray(jtrv.multi_source_distances_pull(
            jc.offsets, jc.dst, jc.w(), jnp.asarray(srcs), jg.num_nodes)),
        rtol=1e-6)
    np.testing.assert_array_equal(
        trv.connected_components_pull(tb.offsets, tb.dst, jg.num_nodes).numpy(),
        np.asarray(jtrv.connected_components_pull(jb.offsets, jb.dst,
                                                  jg.num_nodes)))


def test_csr_patch_positions_matches_jax():
    """A delta of deletes by position and inserts applied to a padded
    CSR: the port's arrays equal JAX's."""
    r = np.random.default_rng(17)
    n, e = 60, 200
    jg = JaxGraph.from_edges(r.integers(0, n, e), r.integers(0, n, e),
                             r.random(e).astype(np.float32))
    c = jg.csr("forward")
    v, cap = jg.num_nodes, c.capacity
    del_pos = np.full(8, cap, np.int32)
    del_pos[:5] = r.choice(e, 5, replace=False)
    del_src = np.where(del_pos < cap,
                       np.asarray(c.src)[np.minimum(del_pos, cap - 1)],
                       v).astype(np.int32)
    ins_src = np.full(6, v, np.int32)
    ins_src[:4] = np.sort(r.integers(0, v, 4))
    ins_dst = np.where(ins_src < v, r.integers(0, v, 6), v).astype(np.int32)
    ins_w = r.random(6).astype(np.float32)
    args = (c.offsets, c.src, c.dst, c.weights, del_pos, del_src, ins_src,
            ins_dst, ins_w)
    want = jcore.csr_patch_positions(*map(jnp.asarray, args), num_nodes=v)
    got = core.csr_patch_positions(
        *(torch.from_numpy(np.array(a)) for a in args), num_nodes=v)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_device_backend_never_runs_the_host_engine(rng, monkeypatch):
    """backend='device' runs every fixpoint on the graph's device: the
    host kernels are never called, even on a tiny graph."""
    def boom(*a, **k):
        raise AssertionError("host engine called under backend='device'")

    for name in ("graph_bfs", "graph_components", "graph_pagerank",
                 "graph_sssp"):
        monkeypatch.setattr(native, name, boom)
    mg, _ = random_graph(rng, n=30, p=0.1, weighted=True)
    start = mg.nodes.id_of(0)
    mg.bfs(start, backend="device")
    mg.connected_components(backend="device")
    mg.pagerank(backend="device", weighted=True)
    mg.shortest_path(start, mg.nodes.id_of(1), backend="device")


def test_graph_defaults_to_the_card():
    """Graph.from_edges runs on the card unless the caller asks for the
    CPU: without one it raises and names device='cpu'."""
    if torch.cuda.is_available():
        assert Graph.from_edges([0], [1]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Graph.from_edges([0], [1])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Graph.from_device_edges(np.array([0]), np.array([1]), num_nodes=2)


def test_centrality_and_community_methods_answer():
    """Graph has degree, betweenness, edge_betweenness, closeness, leiden
    and modularity, and each answers on the CPU, on both engines where it
    routes."""
    # a triangle 0-1-2 with 3 hanging off 2, undirected by default
    mg = Graph.from_edges([0, 1, 2, 2], [1, 2, 0, 3], device=CPU)
    for backend in ("host", "device"):
        assert mg.betweenness(backend=backend) == pytest.approx(
            {0: 0.0, 1: 0.0, 2: 2.0, 3: 0.0})
        assert mg.edge_betweenness(backend=backend)[(2, 3)] == pytest.approx(3.0)
        assert mg.closeness(backend=backend)[2] == pytest.approx(1.0)
        labels, q = mg.leiden(backend=backend)
        assert set(labels) == {0, 1, 2, 3}
        assert mg.modularity(labels) == pytest.approx(q)
    assert mg.degree() == {0: 2.0, 1: 2.0, 2: 3.0, 3: 1.0}


def test_graph_modules_import_no_jax():
    res = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import sys
        import muninn_tpu_torch
        from muninn_tpu_torch import Graph, GraphCache, pairwise_distances, select
        from muninn_tpu_torch.graph import (adjacency, api, centrality,
                                            community, convert, core, pagerank,
                                            routing, selector, traversal)
        from muninn_tpu_torch.ops import segments
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "muninn_tpu")]
        assert not bad, bad
    """)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
