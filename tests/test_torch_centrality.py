"""The port's centrality (``muninn_tpu_torch.graph.centrality`` and its
``Graph`` methods) on CPU tensors: against networkx, and against
``muninn_tpu.graph.centrality`` on the same seeded edges.

Mirrors tests/test_graph.py's degree, betweenness (undirected, directed,
weighted), edge-betweenness, closeness (plain and weighted), sampling and
edgeless cases, each with ``backend="auto"`` (these small graphs route to
the host engine) and ``backend="device"`` (the batched fixpoints). Then the
differentials: the deduplicated COO and the Brandes CSRs array for array,
Bellman-Ford distances bitwise, ``_brandes_batch`` within rtol 1e-5, and
betweenness, edge betweenness and closeness through ``Graph`` on the device
engine of both packages within rtol 1e-5, atol 1e-6 (betweenness also
within that of JAX's all-double host engine, and from JAX's device path no
farther than that plus its own distance from the host engine: see
``_close``); a result is the same at any batch size.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from muninn_tpu.graph import Graph as JaxGraph
from muninn_tpu.graph import centrality as jctr
from muninn_tpu.graph import traversal as jtrv
from muninn_tpu_torch import native
from muninn_tpu_torch.graph import Graph
from muninn_tpu_torch.graph import centrality as ctr
from muninn_tpu_torch.graph import traversal as trv

CPU = "cpu"
BACKENDS = ("auto", "device")
RTOL, ATOL = 1e-5, 1e-6


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


def test_degree(rng):
    mg, g = random_graph(rng, n=40, p=0.1, weighted=True)
    out_deg = mg.degree(direction="forward", weighted=True)
    for n in g.nodes():
        want = sum(d["weight"] for _, _, d in g.out_edges(n, data=True))
        assert out_deg[f"n{n}"] == pytest.approx(want, rel=1e-5)
    tot = mg.degree(direction="both", normalized=True)
    for n in g.nodes():
        want = (g.in_degree(n) + g.out_degree(n)) / (g.number_of_nodes() - 1)
        # normalization uses our node count (= nodes appearing in edges)
        want = want * (g.number_of_nodes() - 1) / (mg.num_nodes - 1)
        assert tot[f"n{n}"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_betweenness_undirected_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=30, p=0.12)
    got = mg.betweenness(direction="both", normalized=True, backend=backend)
    want = nx.betweenness_centrality(g.to_undirected(), normalized=True)
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=1e-4), f"node {k}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_betweenness_directed_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=25, p=0.12)
    got = mg.betweenness(direction="forward", normalized=True, backend=backend)
    want = nx.betweenness_centrality(g, normalized=True)
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=1e-4), f"node {k}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_betweenness_weighted_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=25, p=0.15, weighted=True)
    got = mg.betweenness(direction="forward", weighted=True, normalized=False,
                         backend=backend)
    want = nx.betweenness_centrality(g, weight="weight", normalized=False)
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=1e-3), f"node {k}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_edge_betweenness_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=25, p=0.12)
    got = mg.edge_betweenness(direction="forward", normalized=False,
                              backend=backend)
    want = nx.edge_betweenness_centrality(g, normalized=False)
    for (u, v), val in want.items():
        assert got[(f"n{u}", f"n{v}")] == pytest.approx(val, abs=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_closeness_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=40, p=0.1)
    got = mg.closeness(direction="forward", normalized=True, backend=backend)
    want = nx.closeness_centrality(g)  # incoming distance, WF improved
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=1e-4), f"node {k}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_closeness_weighted_matches_networkx(rng, backend):
    mg, g = random_graph(rng, n=30, p=0.15, weighted=True)
    got = mg.closeness(direction="forward", weighted=True, normalized=True,
                       backend=backend)
    want = nx.closeness_centrality(g, distance="weight")
    for k, v in want.items():
        assert got[f"n{k}"] == pytest.approx(v, abs=1e-4), f"node {k}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_betweenness_sampling_approximates(rng, backend):
    mg, _ = random_graph(rng, n=60, p=0.08)
    exact = mg.betweenness(direction="both", normalized=True, backend=backend)
    approx = mg.betweenness(direction="both", normalized=True,
                            sample_sources=40, seed=3, backend=backend)
    e = np.array([exact[k] for k in sorted(exact)])
    a = np.array([approx[k] for k in sorted(approx)])
    if e.std() > 0 and a.std() > 0:
        assert np.corrcoef(e, a)[0, 1] > 0.9


@pytest.mark.parametrize("backend", BACKENDS)
def test_centrality_on_edgeless_graph(backend):
    """Edgeless graphs return zero centralities instead of crashing in
    dedupe_parallel_edges (empty-run broadcast)."""
    g = Graph.from_edges([], [], device=CPU)
    assert g.betweenness(backend=backend) == {}
    g2 = Graph.from_edges([0, 1], [0, 1], device=CPU)  # nodes exist
    g2._src = np.zeros(0, np.int32)  # simulate filtered-empty COO
    g2._dst = np.zeros(0, np.int32)
    g2._w = np.zeros(0, np.float32)
    bc = g2.betweenness(backend=backend)
    assert bc and all(v == 0.0 for v in bc.values())
    assert g2.edge_betweenness(backend=backend) == {}
    assert all(v == 0.0 for v in g2.closeness(backend=backend).values())


# ───────────── against muninn_tpu.graph.centrality ─────────────


def _coo(seed, n=80, e=500, weighted=True):
    """Seeded edges with self-loops and parallel duplicates as drawn."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(0, n, e).astype(np.int32)
    src[10:20], dst[10:20] = src[0], dst[0]
    w = (r.uniform(0.1, 5.0, e) if weighted else np.ones(e)).astype(np.float32)
    return src, dst, w, n


@pytest.mark.parametrize("seed", [0, 1])
def test_dedupe_matches_jax(seed):
    src, dst, w, n = _coo(seed)
    want = jctr.dedupe_parallel_edges(src, dst, w, n)
    got = ctr.dedupe_parallel_edges(src, dst, w, n)
    dev = ctr.dedupe_parallel_edges_device(
        *(torch.from_numpy(a) for a in (src, dst, w)), n)
    for a, b, c in zip(got, want, dev):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c.numpy(), b)


@pytest.mark.parametrize("weighted", [False, True])
def test_brandes_csrs_and_distances_match_jax(weighted):
    """The device engine's CSR pair equals JAX's (and the host counting
    sort's) array for array, and its Bellman-Ford distances are JAX's
    bitwise."""
    s, d, w = jctr.dedupe_parallel_edges(*_coo(2, weighted=weighted))
    n = 80
    j = jctr._sorted_pair(s, d, w, n)
    t = ctr._sorted_pair(*(torch.from_numpy(a) for a in (s, d, w)), n)
    e = len(s)
    for a, b in zip(t[:6], j[:6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:len(a)])
    assert t[6] == j[6]
    for flip, off in ((0, t[0]), (1, t[3])):
        a, b = (d, s) if flip else (s, d)
        hoff, _, hd, hw = native.csr_build(a, b, w, n)
        np.testing.assert_array_equal(off.numpy(), hoff)
        np.testing.assert_array_equal(t[3 * flip + 1].numpy(), hd)
        np.testing.assert_array_equal(t[3 * flip + 2].numpy(), hw)
    sources = np.array([0, 5, 17, 33, 79], np.int32)
    want = np.asarray(jtrv.multi_source_distances_pull(
        j[3], j[4], j[5], jnp.asarray(sources), n))
    got = trv.multi_source_distances_pull(t[3], t[4], t[5],
                                          torch.from_numpy(sources), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert e == int(t[0][-1])


@pytest.mark.parametrize("want_edge", [False, True])
def test_brandes_batch_matches_jax(want_edge):
    s, d, w = jctr.dedupe_parallel_edges(*_coo(3))
    n = 80
    j = jctr._sorted_pair(s, d, w, n)
    sources = np.arange(0, n, 3, dtype=np.int32)
    jn, je = jctr._brandes_batch(*j[:6], jnp.asarray(sources), n,
                                 want_edge=want_edge)
    tn, te = ctr._brandes_batch(*(torch.tensor(np.asarray(a))
                                  for a in j[:6]),
                                torch.from_numpy(sources), n,
                                want_edge=want_edge)
    assert tn.dtype == torch.float64
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL,
                               atol=ATOL)


def _pair(seed, weighted, n=70, e=400):
    src, dst, w, n = _coo(seed, n, e, weighted)
    ids = [f"v{i}" for i in range(n)]
    s = [ids[i] for i in src]
    d = [ids[i] for i in dst]
    wts = w if weighted else None
    return Graph.from_edges(s, d, wts, device=CPU), JaxGraph.from_edges(s, d, wts)


def _close(a: dict, b: dict, exact: dict | None = None):
    """``a`` within RTOL/ATOL of ``b``. With ``exact`` (JAX's all-double
    host engine on the same sources), ``a`` must lie within RTOL/ATOL of
    it, and from ``b`` no farther than RTOL/ATOL plus ``b``'s own distance
    from it: JAX's device Brandes sums sigma and delta by a float32 prefix
    whose error reaches 1.4e-5 relative here (ROADMAP queue 3), where the
    port's float64 prefix stays near 1e-7."""
    assert set(a) == set(b)
    keys = sorted(a)
    av, bv = (np.array([m[k] for k in keys], np.float64) for m in (a, b))
    if exact is None:
        np.testing.assert_allclose(av, bv, rtol=RTOL, atol=ATOL)
        return
    ev = np.array([exact[k] for k in keys], np.float64)
    np.testing.assert_allclose(av, ev, rtol=RTOL, atol=ATOL)
    assert (np.abs(av - bv)
            <= RTOL * np.abs(bv) + ATOL + np.abs(bv - ev)).all()


@pytest.mark.parametrize("direction", ["both", "forward", "reverse"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sample", [None, 16])
def test_betweenness_matches_jax_device(direction, weighted, sample):
    ours, ref = _pair(4, weighted)
    for normalized in (False, True):
        kw = dict(direction=direction, weighted=weighted, normalized=normalized,
                  sample_sources=sample, seed=7)
        _close(ours.betweenness(backend="device", **kw),
               ref.betweenness(backend="device", **kw),
               ref.betweenness(backend="host", **kw))


@pytest.mark.parametrize("direction", ["both", "forward"])
@pytest.mark.parametrize("sample", [None, 16])
def test_edge_betweenness_matches_jax_device(direction, sample):
    ours, ref = _pair(5, True)
    kw = dict(direction=direction, weighted=True, sample_sources=sample,
              seed=2)
    _close(ours.edge_betweenness(backend="device", **kw),
           ref.edge_betweenness(backend="device", **kw),
           ref.edge_betweenness(backend="host", **kw))


@pytest.mark.parametrize("direction", ["both", "forward", "reverse"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_closeness_matches_jax_device(direction, weighted, normalized):
    ours, ref = _pair(6, weighted)
    kw = dict(direction=direction, weighted=weighted, normalized=normalized,
              backend="device")
    _close(ours.closeness(**kw), ref.closeness(**kw))


def test_degree_matches_jax():
    ours, ref = _pair(8, True)
    for direction in ("forward", "reverse", "both"):
        for weighted in (False, True):
            kw = dict(direction=direction, weighted=weighted, normalized=True)
            _close(ours.degree(**kw), ref.degree(**kw))


def test_results_do_not_depend_on_the_batch():
    """Each source stops on its own and sums in source order: batch 1 and
    batch 64 give the same bits, sampled and not."""
    s, d, w = ctr.dedupe_parallel_edges(*_coo(9, n=90, e=700))
    t = [torch.from_numpy(a) for a in (s, d, w)]
    for sample in (None, 40):
        one = ctr.betweenness(*t, 90, want_edge=True, sample_sources=sample,
                              batch=1, backend="device")
        many = ctr.betweenness(*t, 90, want_edge=True, sample_sources=sample,
                               batch=64, backend="device")
        for a, b in zip(one, many):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        ctr.closeness(*t, 90, batch=1, backend="device"),
        ctr.closeness(*t, 90, batch=64, backend="device"))


def test_device_built_graph_matches_host_built(rng):
    """A from_device_edges graph runs betweenness (dedupe and both CSRs on
    its device, its host mirrors never touched), closeness and degree to
    the host-built graph's results."""
    src, dst, w, n = _coo(10, n=60, e=300)
    host = Graph.from_edges(np.arange(n), np.arange(n), device=CPU)
    host = Graph(host.nodes, src, dst, w, device=CPU)
    dev = Graph.from_device_edges(torch.from_numpy(src), torch.from_numpy(dst),
                                  num_nodes=n, weights=torch.from_numpy(w))
    for kw in (dict(weighted=True), dict(direction="forward", sample_sources=20)):
        assert dev.betweenness(backend="device", **kw) == host.betweenness(
            backend="device", **kw)
    assert dev.closeness(weighted=True) == host.closeness(
        weighted=True, backend="device")
    assert dev.degree(weighted=True) == pytest.approx(host.degree(weighted=True))
    assert dev.device_native


def test_batch_fits_the_budget():
    cpu = torch.device(CPU)
    assert ctr.source_batch(64, 100, 10, cpu) == 64
    per = 10**6 * ctr._SOURCE_EDGE_BYTES + 10**5 * ctr._SOURCE_NODE_BYTES
    assert ctr.source_batch(64, 10**6, 10**5, cpu) == ctr._CPU_BUDGET // per
    assert ctr.source_batch(64, 10**12, 10, cpu) == 1
