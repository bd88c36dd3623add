"""The port's Leiden and modularity (``muninn_tpu_torch.graph.community``)
on CPU tensors, against ``muninn_tpu.graph.community`` on the same seeded
inputs.

The sub-steps are held exactly: ``_best_moves`` on the same communities,
restriction, degrees and community sums gives the same targets and gains
within 1e-6; ``_aggregate`` and ``_renumber`` the same arrays; modularity
within 1e-6. The device engine's damping subset comes from a torch
generator, which cannot reproduce JAX's PRNG stream, so the whole Leiden is
held by quality (JAX's two planted-community cases of tests/test_graph.py;
its Q at least JAX's device Q - 0.05), and by determinism (one seed, the
same labels and Q).
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from muninn_tpu.graph import Graph as JaxGraph
from muninn_tpu.graph import community as jcm
from muninn_tpu_torch.graph import Graph
from muninn_tpu_torch.graph import community as cm

CPU = "cpu"
BACKENDS = ("auto", "device")


def _planted(seed, blocks=4, size=20, p_in=0.5, p_out=0.03, weighted=True):
    """A planted partition as a both-direction COO (each edge twice)."""
    g = nx.planted_partition_graph(blocks, size, p_in, p_out, seed=seed)
    e = np.array(g.edges(), np.int32).reshape(-1, 2)
    r = np.random.default_rng(seed)
    w = (r.uniform(0.5, 2.0, len(e)) if weighted
         else np.ones(len(e))).astype(np.float32)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return src, dst, np.concatenate([w, w]), blocks * size


# ───────────── tests/test_graph.py's Leiden cases ─────────────


@pytest.mark.parametrize("backend", BACKENDS)
def test_leiden_finds_planted_communities(backend):
    # two dense cliques with one bridge
    edges = []
    for base in (0, 10):
        for i in range(10):
            for j in range(i + 1, 10):
                edges.append((f"v{base+i}", f"v{base+j}"))
    edges.append(("v0", "v10"))
    src, dst = zip(*edges)
    mg = Graph.from_edges(src, dst, device=CPU)
    labels, q = mg.leiden(seed=1, backend=backend)
    left = {labels[f"v{i}"] for i in range(10)}
    right = {labels[f"v{i}"] for i in range(10, 20)}
    assert len(left) == 1 and len(right) == 1
    assert left != right
    assert q > 0.4


@pytest.mark.parametrize("backend", BACKENDS)
def test_leiden_modularity_reasonable_on_random_modular_graph(backend):
    g = nx.planted_partition_graph(4, 20, 0.6, 0.02, seed=7)
    src = [f"n{u}" for u, v in g.edges()]
    dst = [f"n{v}" for u, v in g.edges()]
    mg = Graph.from_edges(src, dst, device=CPU)
    labels, q = mg.leiden(seed=2, backend=backend)
    # networkx greedy modularity as a baseline to match/beat
    base = nx.algorithms.community.modularity(
        g, nx.algorithms.community.greedy_modularity_communities(g)
    )
    assert q >= base - 0.03, f"leiden Q={q} vs greedy {base}"


# ───────────── sub-steps against muninn_tpu.graph.community ─────────────


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("restricted", [False, True])
def test_best_moves_matches_jax(seed, restricted):
    src, dst, w, n = _planted(seed)
    r = np.random.default_rng(seed + 10)
    comm = r.integers(0, 12, n).astype(np.int32)  # some shared labels
    restrict = (r.integers(0, 3, n) if restricted
                else np.zeros(n)).astype(np.int32)
    k = np.zeros(n, np.float64)
    np.add.at(k, src, w)
    k = k.astype(np.float32)
    sig = np.zeros(n, np.float64)
    np.add.at(sig, comm, k)
    sig = sig.astype(np.float32)
    m = np.float32(w.sum(dtype=np.float64) / 2.0)
    jg, jt = jcm._best_moves(*map(jnp.asarray, (src, dst, w, comm, k, sig)),
                             jnp.float32(m), jnp.float32(1.0),
                             jnp.asarray(restrict), n)
    tg, tt = cm._best_moves(*map(torch.from_numpy,
                                 (src, dst, w, comm, k, sig)),
                            float(m), 1.0, torch.from_numpy(restrict), n)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jg = np.asarray(jg)
    assert (np.isfinite(jg) == torch.isfinite(tg).numpy()).all()
    fin = np.isfinite(jg)
    np.testing.assert_allclose(tg.numpy()[fin], jg[fin], rtol=0, atol=1e-6)
    assert (tg.numpy()[~fin] == jg[~fin]).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_aggregate_and_renumber_match_jax(seed):
    src, dst, w, n = _planted(seed)
    r = np.random.default_rng(seed)
    labels = r.choice([3, 9, 14, 40, 41], n).astype(np.int32)
    want = jcm._renumber(labels)
    got = cm._renumber(torch.from_numpy(labels))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ja = jcm._aggregate(src, dst, w, want)
    ta = cm._aggregate(*map(torch.from_numpy, (src, dst, w, want)))
    for a, b in zip(ta, ja):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_modularity_matches_jax(gamma):
    src, dst, w, n = _planted(4)
    labels = np.arange(n, dtype=np.int32) // 20
    assert cm.modularity(src, dst, w, labels, gamma) == pytest.approx(
        jcm.modularity(src, dst, w, labels, gamma), abs=1e-6)
    t = [torch.from_numpy(a) for a in (src, dst, w, labels)]
    assert cm.modularity(*t, gamma) == pytest.approx(
        jcm.modularity(src, dst, w, labels, gamma), abs=1e-6)


# ───────────── the whole Leiden ─────────────


def _pair(seed, weighted):
    src, dst, w, n = _planted(seed, blocks=5, size=24, weighted=weighted)
    half = len(src) // 2
    ids = [f"x{i}" for i in range(n)]
    s, d = [ids[i] for i in src[:half]], [ids[i] for i in dst[:half]]
    wts = w[:half] if weighted else None
    return Graph.from_edges(s, d, wts, device=CPU), JaxGraph.from_edges(s, d, wts)


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("weighted", [False, True])
def test_device_leiden_is_deterministic_and_as_good_as_jax(seed, weighted):
    ours, ref = _pair(seed, weighted)
    a, qa = ours.leiden(seed=seed, backend="device")
    b, qb = ours.leiden(seed=seed, backend="device")
    assert a == b and qa == qb
    _, qj = ref.leiden(seed=seed, backend="device")
    assert qa >= qj - 0.05, (qa, qj)
    assert ours.modularity(a) == pytest.approx(qa, abs=1e-6)
    assert ref.modularity(a) == pytest.approx(qa, abs=1e-6)
    # the labels are renumbered 0..c-1
    assert sorted(set(a.values())) == list(range(len(set(a.values()))))


def test_leiden_array_form_and_device_graph():
    """as_array gives the index-aligned labels; a from_device_edges graph
    runs Leiden and modularity on its device COO, its host mirrors never
    touched, to the host-built graph's result."""
    src, dst, w, n = _planted(8)
    half = len(src) // 2
    host = Graph(Graph.from_edges(np.arange(n), np.arange(n),
                                  device=CPU).nodes,
                 src[:half], dst[:half], w[:half], device=CPU)
    dev = Graph.from_device_edges(torch.from_numpy(src[:half]),
                                  torch.from_numpy(dst[:half]), num_nodes=n,
                                  weights=torch.from_numpy(w[:half]))
    lh, qh = host.leiden(seed=3, backend="device", as_array=True)
    ld, qd = dev.leiden(seed=3, backend="device", as_array=True)
    assert lh.dtype == np.int32 and lh.shape == (n,)
    np.testing.assert_array_equal(ld, lh)
    assert qd == qh
    assert dev.modularity(ld) == pytest.approx(qd, abs=1e-6)
    assert dev.device_native


def test_leiden_on_an_edgeless_graph():
    g = Graph.from_edges([0, 1], [0, 1], device=CPU)
    g._src = np.zeros(0, np.int32)
    g._dst = np.zeros(0, np.int32)
    g._w = np.zeros(0, np.float32)
    labels, q = g.leiden(backend="device")
    assert labels == {0: 0, 1: 1} and q == 0.0
