"""Cross-backend agreement in the port: its native host kernels against its
device fixpoints (CPU tensors).

Mirrors the cases of tests/test_host_graph.py that this slice's methods
cover (BFS, max depth, shortest path, components, PageRank), its two
routing cases and ``test_randomized_topology_agreement``, each keeping
only the calls the port has: JAX's versions also call betweenness,
closeness and Leiden (test_host_graph.py:215-221, :267-275), which come
with centrality and communities. The routing spy takes the operation's
ceiling, which the port's ``Graph`` passes.
"""

import numpy as np
import pytest

from muninn_tpu_torch.graph import Graph


@pytest.fixture
def g(rng):
    n, e = 120, 600
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    w = rng.uniform(0.5, 2.0, keep.sum()).astype(np.float32)
    return Graph.from_edges(
        [f"n{s}" for s in src[keep]], [f"n{d}" for d in dst[keep]], w,
        device="cpu",
    )


def _start(g):
    return g.nodes.id_of(0)


def test_bfs_agreement(g):
    for direction in ("forward", "reverse", "both"):
        h = g.bfs(_start(g), direction=direction, backend="host")
        d = g.bfs(_start(g), direction=direction, backend="device")
        assert h == d


def test_bfs_max_depth_agreement(g):
    h = g.bfs(_start(g), max_depth=2, backend="host")
    d = g.bfs(_start(g), max_depth=2, backend="device")
    assert h == d


def test_shortest_path_agreement(g):
    ids = [g.nodes.id_of(i) for i in range(0, g.num_nodes, 7)]
    for t in ids[1:6]:
        for weighted in (False, True):
            ph, dh = g.shortest_path(
                _start(g), t, weighted=weighted, backend="host"
            )
            pd, dd = g.shortest_path(
                _start(g), t, weighted=weighted, backend="device"
            )
            assert np.isclose(dh, dd, rtol=1e-5, atol=1e-5) or (
                dh == dd == float("inf")
            )
            if ph:
                assert ph[0] == _start(g) and ph[-1] == t
                assert pd[0] == _start(g) and pd[-1] == t


def test_components_agreement(g):
    assert g.connected_components(backend="host") == g.connected_components(
        backend="device"
    )


def test_pagerank_agreement(g):
    for weighted in (False, True):
        for direction in ("forward", "both"):
            h = g.pagerank(weighted=weighted, direction=direction,
                           backend="host")
            d = g.pagerank(weighted=weighted, direction=direction,
                           backend="device")
            hv = np.array([h[k] for k in sorted(h)])
            dv = np.array([d[k] for k in sorted(d)])
            np.testing.assert_allclose(hv, dv, rtol=2e-4, atol=1e-7)


def test_auto_routes_small_to_host(g, monkeypatch):
    # a tiny graph must not touch the device: poison the device CSR path
    def boom(*a, **k):
        raise AssertionError("device CSR built for a small-graph op")

    monkeypatch.setattr(type(g), "csr", boom)
    g.bfs(_start(g))
    g.pagerank()
    g.connected_components()
    g.shortest_path(_start(g), g.nodes.id_of(1))


def test_reference_envelope_routes_host(monkeypatch):
    """Every ported analytic at the reference's LARGEST published point
    (10k nodes, ER-5) routes to the host engine."""
    import muninn_tpu_torch.graph.api as api
    import muninn_tpu_torch.graph.routing as routing

    rng = np.random.default_rng(5)
    n, e = 10_000, 50_000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    g = Graph.from_edges(src.tolist(), dst.tolist(), device="cpu")

    decisions = []
    orig = routing.use_host

    def spy(backend, host_seconds, ceiling=None):
        r = orig(backend, host_seconds, ceiling)
        decisions.append((backend, host_seconds, r))
        return r

    monkeypatch.setattr(routing, "use_host", spy)
    monkeypatch.setattr(api, "use_host", spy)

    s = int(src[0])
    g.bfs(s)
    g.pagerank()
    g.connected_components()
    g.shortest_path(s, int(dst[-1]))
    assert len(decisions) == 4, "routing spy not consulted by every op"
    routed_device = [d for d in decisions if d[0] == "auto" and not d[2]]
    assert not routed_device, routed_device


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_randomized_topology_agreement(seed):
    """Random graphs of varying density/size (incl. multi-edges and
    self-loops as generated): host and device backends agree on every
    ported analytic."""
    r = np.random.default_rng(seed)
    v = int(r.integers(8, 50))
    e = int(r.integers(v, 5 * v))
    src = r.integers(0, v, e)
    dst = r.integers(0, v, e)
    w = r.uniform(0.1, 5.0, e).astype(np.float32) if seed % 2 else None
    g = Graph.from_edges([f"n{s}" for s in src], [f"n{d}" for d in dst], w,
                         device="cpu")
    start = f"n{src[0]}"

    bh = {n: dep for n, dep, _p in g.bfs(start, backend="host")}
    bd = {n: dep for n, dep, _p in g.bfs(start, backend="device")}
    assert bh == bd

    ch, cd = (g.connected_components(backend=b) for b in ("host", "device"))

    def part(m):
        comp = {}
        for n, (cid, _sz) in m.items():
            comp.setdefault(cid, set()).add(n)
        return sorted(map(frozenset, comp.values()), key=sorted)
    assert part(ch) == part(cd)

    ph, pd = (g.pagerank(backend=b) for b in ("host", "device"))
    assert set(ph) == set(pd)
    assert all(abs(ph[n] - pd[n]) < 1e-3 for n in ph)

    end = f"n{dst[-1]}"
    sph = g.shortest_path(start, end, backend="host")
    spd = g.shortest_path(start, end, backend="device")
    if sph is None or np.isinf(sph[1]):
        assert spd is None or np.isinf(spd[1])
    else:
        assert abs(sph[1] - spd[1]) < 1e-3
