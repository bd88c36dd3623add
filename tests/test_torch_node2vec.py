"""The port's Node2Vec (``muninn_tpu_torch.models.node2vec``) on CPU tensors:
tests/test_node2vec.py's nine cases on the port, and differentials against
``muninn_tpu.models.node2vec`` on the same seeded inputs.

The two packages draw from different random streams (``torch.Generator``
against ``jax.random``), so walks are held by statistics: the one-step law
of the truncated rejection sampler in closed form, for both packages. The
deterministic sub-steps are held exactly or within float32 rounding: the
walk-table prep, both binary searches (also at the port's trimmed iteration
count against JAX's 32), the negative table, and the SGNS update fed JAX's
own negatives. The host route runs the same C++ in both packages.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.graph import Graph as JaxGraph
from muninn_tpu.models import node2vec as jn2v
from muninn_tpu_torch import native
from muninn_tpu_torch.graph import Graph, routing
from muninn_tpu_torch.graph.convert import graph_from_numpy, graph_to_numpy
from muninn_tpu_torch.index.flat import FlatIndex
from muninn_tpu_torch.models import node2vec as n2v
from muninn_tpu_torch.models.node2vec import (
    _row_sorted_cumw,
    biased_walks,
    build_negative_table,
    node2vec_train,
)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
# the one-step law: 5 binomial standard deviations + 0.002
LAW_SIGMAS = 5.0
LAW_SLACK = 0.002


def gen(seed: int) -> torch.Generator:
    g = torch.Generator(device=CPU)
    g.manual_seed(seed)
    return g


def line_graph(n=6, graph_cls=Graph, **kw):
    src = [f"v{i}" for i in range(n - 1)]
    dst = [f"v{i+1}" for i in range(n - 1)]
    return graph_cls.from_edges(src, dst, **kw)


def clique_edges(k=8):
    edges = []
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                edges.append((f"v{base+i}", f"v{base+j}"))
    edges.append(("v0", f"v{k}"))
    return tuple(zip(*edges))


def two_cliques(k=8):
    return Graph.from_edges(*clique_edges(k), device=CPU)


def separation(ids, emb, k=8):
    """Mean cosine within the two cliques minus across them."""
    idx = {n: i for i, n in enumerate(ids)}
    a = [idx[f"v{i}"] for i in range(k)]
    b = [idx[f"v{i}"] for i in range(k, 2 * k)]
    sims = emb @ emb.T
    intra = (sims[np.ix_(a, a)].mean() + sims[np.ix_(b, b)].mean()) / 2
    return intra - sims[np.ix_(a, b)].mean()


def _walk_arrays(g):
    """tests/test_node2vec.py's walk tables: a host lexsort and a global
    float64 cumsum (exact at these sizes)."""
    c = g.csr("both")
    off = c.offsets.numpy()
    dst = c.dst.numpy()
    w = c.w().numpy()
    order = np.lexsort((dst, c.s().numpy()))
    dst, w = dst[order], w[order]
    cumw = np.cumsum(w, dtype=np.float64).astype(np.float32)
    return torch.from_numpy(off), torch.from_numpy(dst), torch.from_numpy(cumw)


# ───────────── tests/test_node2vec.py's cases, on the port ─────────────


def test_walks_follow_edges(rng):
    g = two_cliques()
    off, dst, cumw = _walk_arrays(g)
    starts = torch.arange(g.num_nodes, dtype=torch.int32)
    walks = biased_walks(gen(0), off, dst, cumw, starts, g.num_nodes, 10,
                         1.0, 1.0).numpy()
    assert walks.shape == (g.num_nodes, 11) and walks.dtype == np.int32
    edge_set = set()
    offn, dstn = off.numpy(), dst.numpy()
    for v in range(g.num_nodes):
        for e in range(offn[v], offn[v + 1]):
            edge_set.add((v, int(dstn[e])))
    for row in walks:
        for a, b in zip(row, row[1:]):
            assert (int(a), int(b)) in edge_set


def test_walks_p_bias_controls_backtracking(rng):
    g = line_graph(30, device=CPU)
    off, dst, cumw = _walk_arrays(g)
    starts = torch.full((2000,), 15, dtype=torch.int32)

    def backtrack_rate(p, q, seed):
        w = biased_walks(gen(seed), off, dst, cumw, starts, g.num_nodes, 8,
                         p, q).numpy()
        return (w[:, 2:] == w[:, :-2]).mean()

    low_p = backtrack_rate(0.25, 1.0, 1)
    high_p = backtrack_rate(4.0, 1.0, 1)
    assert low_p > high_p + 0.1, (low_p, high_p)


def test_negative_table_proportional(rng):
    deg = np.array([1, 10, 100], np.float64)
    table = build_negative_table(deg, size=10000)
    counts = np.bincount(table, minlength=3).astype(float)
    want = deg ** 0.75
    want = want / want.sum()
    got = counts / counts.sum()
    np.testing.assert_allclose(got, want, atol=0.02)


def test_node2vec_separates_cliques(rng):
    g = two_cliques(8)
    ids, emb = node2vec_train(
        g, dim=16, num_walks=6, walk_length=12, window=4,
        neg_samples=4, epochs=4, seed=2, walk_batch=64, sgns_chunk=64,
    )
    assert separation(ids, emb) > 0.1
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_node2vec_writes_to_index(rng, backend):
    g = two_cliques(6)
    out = FlatIndex(8, "cosine", device=CPU)
    ids, emb = node2vec_train(
        g, dim=8, num_walks=3, walk_length=8, epochs=2, seed=4,
        walk_batch=32, sgns_chunk=32, output_index=out, backend=backend,
    )
    assert len(out) == g.num_nodes
    got, _ = out.search(emb[0], k=1)
    assert got[0] == 1


def test_node2vec_dim_cap():
    g = line_graph(4, device=CPU)
    with pytest.raises(ValueError):
        node2vec_train(g, dim=2048)


def test_row_sorted_cumw_is_row_local(rng):
    """Per-row prefix sums reset at row starts and rows come out
    dst-sorted (a global cumsum loses unit-weight resolution past 2^24
    total weight)."""
    n, e = 50, 400
    s = rng.integers(0, n, e)
    d = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) + 0.1
    g = Graph.from_edges(s, d, w, device=CPU)
    c = g.csr("both")
    dst_sorted, cumw = _row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets,
                                        c.max_deg)
    off = c.offsets.numpy()
    ds = dst_sorted.numpy()
    cw = cumw.numpy()
    hs, hd, hw = g.host_coo("both")
    for v in range(n):
        lo, hi = off[v], off[v + 1]
        if hi == lo:
            continue
        row = ds[lo:hi]
        assert (np.diff(row) >= 0).all()
        want = np.sort(hw[hs == v].astype(np.float64))
        got = np.sort(np.diff(np.concatenate([[0.0], cw[lo:hi]])))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert cw[lo] <= hw[hs == v].max() + 1e-6


def test_negative_table_covers_all_nodes_beyond_size():
    v = 5000
    tab = build_negative_table(np.ones(v), size=1000)
    assert tab.shape == (1000,)
    assert tab.min() >= 0 and tab.max() >= v - 10
    assert len(np.unique(tab // 500)) == 10
    deg = np.ones(100)
    deg[7] = 1000.0
    tab2 = build_negative_table(deg, size=1000)
    assert (tab2 == 7).mean() > 0.2


def test_weighted_draw_matches_edge_weights_exactly():
    """At p=q=1 the next-step distribution from a hub equals edge weight /
    total weight: the row-local cumw sampler end to end."""
    src = ["h"] * 9 + [f"n{i}" for i in range(1, 10)]
    dst = [f"n{i}" for i in range(1, 10)] + ["h"] * 9
    w = np.concatenate(
        [np.arange(1, 10, dtype=np.float32), np.ones(9, np.float32)])
    g = Graph.from_edges(src, dst, w, device=CPU)
    c = g.csr()
    hub = g.node_index("h")
    dstj, cumw = _row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets, c.max_deg)
    starts = torch.full((2048,), hub, dtype=torch.int32)
    counts = np.zeros(g.num_nodes)
    for rep in range(5):
        walks = biased_walks(gen(rep), c.offsets, dstj, cumw, starts,
                             g.num_nodes, 1, 1.0, 1.0)
        for t in walks.numpy()[:, 1]:
            if t != hub:
                counts[t] += 1
    n_draws = counts.sum()
    assert n_draws == 5 * 2048
    for i in range(1, 10):
        emp = counts[g.node_index(f"n{i}")] / n_draws
        exp = i / 45.0
        assert abs(emp - exp) < 0.015 + 0.25 * exp, (i, emp, exp)


# ───────────── differentials against muninn_tpu ─────────────


def multigraph_edges(rng, n=40, e=300):
    """Random weighted edges with parallel edges, self-loops and an
    isolated node (n - 1 never appears)."""
    s = rng.integers(0, n - 1, e)
    d = rng.integers(0, n - 1, e)
    s[:20], d[:20] = s[20:40], d[20:40]          # parallel edges
    d[40:45] = s[40:45]                          # self-loops
    w = rng.uniform(0.1, 3.0, e).astype(np.float32)
    return s, d, w


@pytest.mark.parametrize("weighted", [False, True])
def test_row_sorted_cumw_matches_jax(rng, weighted):
    s, d, w = multigraph_edges(rng)
    jg = JaxGraph.from_edges(s, d, w if weighted else None)
    jg.csr("forward")
    g = graph_from_numpy(graph_to_numpy(jg), device=CPU)
    jc, c = jg.csr("both"), g.csr("both")
    jd, jw = jn2v._row_sorted_cumw(jc.s(), jc.dst, jc.w(), jc.offsets,
                                   jc.max_deg)
    pd, pw = _row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets, c.max_deg)
    np.testing.assert_array_equal(c.offsets.numpy(), np.asarray(jc.offsets))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)


def search_rows(rng):
    """Sorted rows (some empty, many with duplicates) packed CSR-style,
    padded like a CSR's tail; returns (offsets, values, max_deg)."""
    lens = rng.integers(0, 40, 64)
    lens[::7] = 0
    rows = [np.sort(rng.integers(0, 30, k)) for k in lens]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    vals = np.concatenate(rows + [np.full(5, 99)]).astype(np.int32)
    return off, vals, int(lens.max())


@pytest.mark.parametrize("trim", [False, True])
def test_searchsorted_segment_matches_jax(rng, trim):
    off, vals, max_deg = search_rows(rng)
    # per-row inclusive prefix sums of positive weights
    w = rng.uniform(0.1, 2.0, len(vals)).astype(np.float32)
    cumw = np.zeros_like(w)
    for v in range(len(off) - 1):
        cumw[off[v]:off[v + 1]] = np.cumsum(w[off[v]:off[v + 1]])
    cumw[off[-1]:] = np.cumsum(w[off[-1]:])
    u = rng.integers(0, len(off) - 1, 4000)
    lo, hi = off[u], off[u + 1]
    total = cumw[np.maximum(hi - 1, 0)]
    # inside the row's range, at its edges, and beyond its total
    target = (rng.uniform(-0.1, 1.1, len(u)) * total).astype(np.float32)
    target[:50] = cumw[np.minimum(lo[:50], len(cumw) - 1)]
    want = np.asarray(jn2v._searchsorted_segment(
        jnp.asarray(cumw), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(target), len(off) - 1))
    iters = n2v.search_iters(max_deg if trim else None)
    assert iters == (max_deg.bit_length() + 1 if trim else 32)
    got = n2v._searchsorted_segment(
        torch.from_numpy(cumw), torch.from_numpy(lo).long(),
        torch.from_numpy(hi).long(), torch.from_numpy(target), iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("trim", [False, True])
def test_is_neighbor_matches_jax(rng, trim):
    off, vals, max_deg = search_rows(rng)
    u = rng.integers(0, len(off) - 1, 4000)
    # candidates in the row's value range, outside it, and row members
    c = rng.integers(-3, 35, len(u))
    for i in range(0, len(u), 3):
        if off[u[i] + 1] > off[u[i]]:
            c[i] = vals[rng.integers(off[u[i]], off[u[i] + 1])]
    want = np.asarray(jn2v._is_neighbor(
        jnp.asarray(vals), jnp.asarray(off), jnp.asarray(u),
        jnp.asarray(c.astype(np.int32)), len(off) - 1))
    assert want.any() and not want.all()
    got = n2v._is_neighbor(
        torch.from_numpy(vals), torch.from_numpy(off).long(),
        torch.from_numpy(u), torch.from_numpy(c),
        n2v.search_iters(max_deg if trim else None))
    np.testing.assert_array_equal(got.numpy(), want)


def test_trimmed_search_walks_equal_full_search(rng):
    """The same generator gives the same walks with the trimmed search and
    with JAX's 32 iterations, on a graph with parallel edges, self-loops
    and a dead end."""
    s, d, w = multigraph_edges(rng)
    g = Graph.from_edges(s, d, w, device=CPU)
    c = g.csr("both")
    dst_s, cumw = _row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets, c.max_deg)
    starts = torch.arange(g.num_nodes, dtype=torch.int32).repeat(20)
    walks = [biased_walks(gen(3), c.offsets, dst_s, cumw, starts,
                          g.num_nodes, 12, 0.5, 2.0, max_deg=md)
             for md in (c.max_deg, None)]
    assert n2v.search_iters(c.max_deg) < n2v.SEARCH_ITERS
    assert torch.equal(walks[0], walks[1])


@pytest.mark.parametrize("degrees", [
    np.array([1, 10, 100]), np.arange(5000) % 7, np.zeros(30),
    np.concatenate([np.zeros(10), np.full(200_000, 3)]),
], ids=["three", "5000-mod7", "all-zero", "beyond-table"])
def test_negative_table_matches_jax(degrees):
    np.testing.assert_array_equal(build_negative_table(degrees),
                                  jn2v.build_negative_table(degrees))


def sgns_inputs(rng, v=30, w_count=8, l1=11, dim=12):
    syn0 = rng.normal(0, 0.3, (v, dim)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (v, dim)).astype(np.float32)
    walks = rng.integers(0, v, (w_count, l1)).astype(np.int32)
    table = build_negative_table(rng.integers(1, 20, v), size=1000)
    return syn0, syn1, walks, table


def jax_negatives(key, table, pcount, k):
    """The negatives JAX's ``_sgns_update`` draws with ``key``."""
    return np.array(jnp.asarray(table)[
        jax.random.randint(key, (pcount, k), 0, table.shape[0])])


@pytest.mark.parametrize("window", [3, 12])
def test_sgns_update_matches_jax_with_its_negatives(rng, window):
    syn0, syn1, walks, table = sgns_inputs(rng)
    key = jax.random.PRNGKey(5)
    k_neg, lr = 4, 0.05
    j0, j1 = jn2v._sgns_update(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(walks),
        jnp.asarray(table), key, jnp.float32(lr), window, k_neg)
    pcount = n2v._pair_count(*walks.shape, window)
    negs = jax_negatives(key, table, pcount, k_neg)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    p0, p1 = n2v._sgns_apply(t0, t1, torch.from_numpy(walks),
                             torch.from_numpy(negs), lr, window)
    assert p0 is t0 and p1 is t1  # in place
    assert np.abs(np.asarray(j0) - syn0).max() > 1e-3  # the step moved rows
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=0, atol=1e-5)


def test_sgns_walk_batch_matches_jax_with_its_negatives(rng, monkeypatch):
    syn0, syn1, walks, table = sgns_inputs(rng, w_count=16)
    chunk, window, k_neg, lr = 4, 5, 5, 0.025
    key = jax.random.PRNGKey(9)
    j0, j1 = jn2v.sgns_walk_batch(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(walks),
        jnp.asarray(table), key, jnp.float32(lr), window, k_neg, chunk)
    # each chunk's key as JAX's scan splits it
    pcount = n2v._pair_count(chunk, walks.shape[1], window)
    negs, k = [], key
    for _ in range(walks.shape[0] // chunk):
        k, kc = jax.random.split(k)
        negs.append(torch.from_numpy(jax_negatives(kc, table, pcount, k_neg)))
    monkeypatch.setattr(n2v, "_draw_negatives",
                        lambda tab, g, p, kk: negs.pop(0))
    p0, p1 = n2v.sgns_walk_batch(
        torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
        torch.from_numpy(walks), torch.from_numpy(table), gen(0), lr, window,
        k_neg, chunk)
    assert not negs
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=0, atol=1e-5)


def law_graph():
    """12 nodes, 30 distinct weighted undirected edges, no self-loops."""
    r = np.random.default_rng(12)
    pairs = set()
    while len(pairs) < 30:
        a, b = sorted(r.integers(0, 12, 2))
        if a != b:
            pairs.add((int(a), int(b)))
    s, d = map(np.array, zip(*sorted(pairs)))
    return s, d, r.uniform(0.5, 3.0, len(s)).astype(np.float32)


def one_step_law(nbrs, p, q, prev, cur, rounds=4):
    """{c: P(c)} of the truncated rejection sampler: ``rounds`` weighted
    draws, each accepted with a = bias/max_bias, else round 0's draw."""
    row = nbrs[cur]
    tot = sum(row.values())
    max_bias = max(1 / p, 1.0, 1 / q)
    pi = {c: wt / tot for c, wt in row.items()}
    a = {c: (1 / p if c == prev else 1.0 if c in nbrs[prev] else 1 / q)
         / max_bias for c in row}
    acc = sum(pi[c] * a[c] for c in row)
    return {c: pi[c] * a[c] * (1 - (1 - acc) ** rounds) / acc
            + pi[c] * (1 - a[c]) * (1 - acc) ** (rounds - 1) for c in row}


def check_law(walks, nbrs, p, q):
    groups = {}
    for s0, f, c in walks:
        groups.setdefault((int(s0), int(f)), []).append(int(c))
    worst = 0.0
    for (s0, f), cs in groups.items():
        law = one_step_law(nbrs, p, q, s0, f)
        n = len(cs)
        counts = np.bincount(cs, minlength=12)
        assert set(np.nonzero(counts)[0]) <= set(law)
        for c, pc in law.items():
            dev = abs(counts[c] / n - pc)
            tol = LAW_SIGMAS * np.sqrt(pc * (1 - pc) / n) + LAW_SLACK
            assert dev <= tol, ((s0, f, c), counts[c] / n, pc, n)
            worst = max(worst, dev / tol)
    return worst


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.25, 4.0), (4.0, 0.25)])
def test_walk_one_step_law(package, pq):
    """100k walkers of walk_length 2 from every node: the second hop given
    (start, first hop) follows the closed form, in both packages."""
    p, q = pq
    s, d, w = law_graph()
    nbrs = {v: {} for v in range(12)}
    for a, b, wt in zip(s, d, w):
        nbrs[a][b] = nbrs[a].get(b, 0.0) + float(wt)
        nbrs[b][a] = nbrs[b].get(a, 0.0) + float(wt)
    starts = np.arange(100_000, dtype=np.int32) % 12
    if package == "port":
        g = Graph.from_edges(s, d, w, device=CPU)
        c = g.csr("both")
        dst_s, cumw = _row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets,
                                       c.max_deg)
        walks = biased_walks(gen(7), c.offsets, dst_s, cumw,
                             torch.from_numpy(starts), 12, 2, p, q,
                             max_deg=c.max_deg).numpy()
    else:
        jg = JaxGraph.from_edges(s, d, w)
        c = jg.csr("both")
        dst_s, cumw = jn2v._row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets,
                                            c.max_deg)
        walks = np.asarray(jn2v.biased_walks(
            jax.random.PRNGKey(7), c.offsets, dst_s, cumw,
            jnp.asarray(starts), 12, 2, p, q))
    assert walks.shape == (100_000, 3)
    assert check_law(walks, nbrs, p, q) <= 1.0


def treatment_graph(n=2000, seed=0):
    """The node2vec treatment's graph (benchmarks/harness/treatments.py:
    488-508): Erdos-Renyi, mean degree 5."""
    r = np.random.default_rng(seed)
    return r.integers(0, n, 5 * n), r.integers(0, n, 5 * n)


TREATMENT = dict(dim=32, num_walks=2, walk_length=20, epochs=1,
                 walk_batch=1024, sgns_chunk=256)


@pytest.mark.skipif(not native.graph_available(), reason="no host engine")
def test_host_route_matches_jax():
    s, d = treatment_graph(300)
    jids, jemb = jn2v.node2vec_train(JaxGraph.from_edges(s, d), seed=3,
                                     backend="host", **TREATMENT)
    ids, emb = node2vec_train(Graph.from_edges(s, d, device=CPU), seed=3,
                              backend="host", **TREATMENT)
    assert ids == jids
    np.testing.assert_array_equal(emb, jemb)


@pytest.mark.skipif(not native.graph_available(), reason="no host engine")
def test_auto_routes_by_the_host_estimate(monkeypatch):
    """At the treatment's 2k-node point ``auto`` takes the host trainer;
    with the estimate above the ceiling it takes the device route."""
    est = n2v.host_estimate_s(2000, 32, 2, 20, 5, 5, 1)
    assert est <= routing.HOST_N2V_SECONDS
    assert n2v.host_estimate_s(1_000_000, 64, 2, 80, 5, 5, 1) > (
        routing.HOST_N2V_SECONDS)
    g = Graph.from_edges(*treatment_graph(2000), device=CPU)
    runs = {b: node2vec_train(g, seed=1, backend=b, **TREATMENT)[1]
            for b in ("auto", "host", "device")}
    np.testing.assert_array_equal(runs["auto"], runs["host"])
    assert not np.allclose(runs["host"], runs["device"])
    monkeypatch.setattr(routing, "HOST_N2V_SECONDS", est * 0.99)
    np.testing.assert_array_equal(
        node2vec_train(g, seed=1, backend="auto", **TREATMENT)[1],
        runs["device"])


def test_two_cliques_in_both_packages():
    """JAX's clique case in both packages (``auto``: the host trainer at
    this size): the same node ids, each separating the cliques, each
    writing rows 1..V into its flat index."""
    kw = dict(dim=16, num_walks=6, walk_length=12, window=4, neg_samples=4,
              epochs=4, seed=2, walk_batch=64, sgns_chunk=64)
    from muninn_tpu.index.flat import FlatIndex as JaxFlatIndex

    jout = JaxFlatIndex(16, "cosine", use_pallas=False)
    out = FlatIndex(16, "cosine", device=CPU)
    jids, jemb = jn2v.node2vec_train(JaxGraph.from_edges(*clique_edges()),
                                     output_index=jout, **kw)
    ids, emb = node2vec_train(two_cliques(), output_index=out, **kw)
    assert ids == jids
    assert separation(ids, emb) > 0.1 and separation(jids, jemb) > 0.1
    for index, e in ((out, emb), (jout, jemb)):
        assert len(index) == len(ids)
        got, _ = index.search(e, k=1)
        np.testing.assert_array_equal(np.asarray(got)[:, 0],
                                      np.arange(1, len(ids) + 1))


def test_device_route_separates_cliques_on_average():
    """The device trainer (JAX's count-normalised step) separates the
    cliques by about 0.12 on average at JAX's clique settings, in both
    packages, with a wide spread from seed to seed: the mean over eight
    seeds must pass 0.1."""
    kw = dict(dim=16, num_walks=6, walk_length=12, window=4, neg_samples=4,
              epochs=4, walk_batch=64, sgns_chunk=64, backend="device")
    seps = [separation(*node2vec_train(two_cliques(), seed=seed, **kw))
            for seed in range(8)]
    assert np.mean(seps) > 0.1, seps


def test_device_graph_with_parallel_edges_trains():
    """A ``from_device_edges`` graph keeps parallel edges and self-loops in
    its 'both' CSR; the device route walks it and trains finite unit
    rows."""
    rng = np.random.default_rng(4)
    s, d, _ = multigraph_edges(rng)
    g = Graph.from_device_edges(torch.from_numpy(s.astype(np.int32)),
                                torch.from_numpy(d.astype(np.int32)),
                                num_nodes=40)
    ids, emb = node2vec_train(g, dim=8, num_walks=2, walk_length=10,
                              epochs=1, seed=0, backend="device")
    assert ids == list(range(40)) and emb.shape == (40, 8)
    assert np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)


def test_node2vec_modules_import_no_jax():
    res = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import sys
        import muninn_tpu_torch
        from muninn_tpu_torch import node2vec_train
        from muninn_tpu_torch.models import node2vec
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "muninn_tpu")]
        assert not bad, bad
    """)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("chunk, collapsed", [(2, True), (64, False)])
def test_count_normalised_step_collapses_rows_in_both_packages(chunk,
                                                               collapsed):
    """JAX's count-normalised SGNS step (``_sgns_update``), which the port
    copies: where a chunk of walker rows holds a node about once (2-walker
    chunks over 2,000 nodes here, as 256-walker chunks over 1M nodes in
    chip_smoke.py's phase 19), every row drifts onto one direction, in
    both packages alike; 64-walker chunks over the same graph do not."""
    r = np.random.default_rng(0)
    n, block = 2000, 100
    s = r.integers(0, n, 10 * n)
    d = np.where(r.random(10 * n) < 0.9,
                 s // block * block + r.integers(0, block, 10 * n),
                 r.integers(0, n, 10 * n))
    kw = dict(dim=64, p=0.5, q=2.0, walk_length=40, window=5, neg_samples=5,
              num_walks=2, epochs=1, seed=0, walk_batch=1 << 20,
              sgns_chunk=chunk, backend="device")
    norms = [float(np.linalg.norm(train(graph, **kw)[1].mean(0)))
             for train, graph in (
                 (node2vec_train, Graph.from_edges(s, d, device=CPU)),
                 (jn2v.node2vec_train, JaxGraph.from_edges(s, d)))]
    if collapsed:
        assert min(norms) > 0.95, norms
    else:
        assert max(norms) < 0.1, norms
    assert abs(norms[0] - norms[1]) < 0.02, norms
