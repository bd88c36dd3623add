"""The port's selector DSL (``muninn_tpu_torch.graph.selector``) on CPU
tensors, against the documented reference semantics (docs/graph-select.md
example graph: A->B, Y->E, B->C, C->D, C->E, E->F) and against
``muninn_tpu.graph.selector``.

Mirrors all 19 cases of tests/test_selector.py, the cases on the example
graph on each route (host engine and device fixpoints), then random graphs
and expressions where the port's ``select`` equals JAX's row for row on
the host route and on the device route.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest

from muninn_tpu.graph import Graph as JaxGraph
from muninn_tpu.graph.selector import select as jax_select
from muninn_tpu_torch.graph import Graph, select
from muninn_tpu_torch.graph.selector import SelectorError, parse_selector

ROUTES = ("host", "device")


def _route(g, route):
    """Force every BFS of ``g``'s selector onto one engine."""
    g._use_host = lambda *a, **k: route == "host"
    return g


@pytest.fixture(params=ROUTES)
def deps(request):
    edges = [("A", "B"), ("Y", "E"), ("B", "C"), ("C", "D"), ("C", "E"), ("E", "F")]
    src, dst = zip(*edges)
    return _route(Graph.from_edges(src, dst, device="cpu"), request.param)


def nodes_of(rows):
    return {n for n, _, _ in rows}


def test_plain_node(deps):
    assert nodes_of(select(deps, "C")) == {"C"}


def test_ancestors(deps):
    assert nodes_of(select(deps, "+C")) == {"A", "B", "C"}


def test_descendants(deps):
    assert nodes_of(select(deps, "C+")) == {"C", "D", "E", "F"}


def test_depth_limited(deps):
    assert nodes_of(select(deps, "1+C")) == {"B", "C"}
    assert nodes_of(select(deps, "C+1")) == {"C", "D", "E"}
    assert nodes_of(select(deps, "1+C+1")) == {"B", "C", "D", "E"}


def test_unlimited_both(deps):
    assert nodes_of(select(deps, "+C+")) == {"A", "B", "C", "D", "E", "F"}


def test_closure(deps):
    assert nodes_of(select(deps, "@C")) == {"A", "B", "C", "D", "E", "F", "Y"}


def test_union(deps):
    assert nodes_of(select(deps, "D B")) == {"D", "B"}


def test_intersection_common_ancestors(deps):
    assert nodes_of(select(deps, "+D,+E")) == {"A", "B", "C"}


def test_complement(deps):
    assert nodes_of(select(deps, "not C+")) == {"A", "B", "Y"}


def test_mixed_precedence(deps):
    # +A B+ = (+A) ∪ (B+)
    assert nodes_of(select(deps, "+A B+")) == {"A", "B", "C", "D", "E", "F"}


def test_depths_and_directions(deps):
    rows = {n: (d, dir_) for n, d, dir_ in select(deps, "2+C+2")}
    assert rows["C"] == (0, "self")
    assert rows["B"] == (1, "ancestor")
    assert rows["A"] == (2, "ancestor")
    assert rows["D"] == (1, "descendant")
    assert rows["E"] == (1, "descendant")
    assert rows["F"] == (2, "descendant")


def test_parse_errors():
    with pytest.raises(SelectorError):
        parse_selector("")
    with pytest.raises(SelectorError):
        parse_selector("@+C")
    with pytest.raises(SelectorError):
        parse_selector(",")


def test_unknown_node_empty(deps):
    assert select(deps, "ZZZ") == []


def test_closure_includes_ancestor_of_descendant_direction(deps):
    rows = {n: dir_ for n, _, dir_ in select(deps, "@C")}
    assert rows["Y"] == "closure"
    assert rows["D"] == "descendant"


def test_documented_precedence_example(deps):
    # docs/graph-select.md precedence: "X,Y not Z" parses as
    # (X ∩ Y) ∪ (not Z)
    got = nodes_of(select(deps, "+C,+D not E"))
    intersect = {"A", "B", "C"}            # +C ∩ +D
    complement = {"A", "B", "C", "D", "F", "Y"}  # not E
    assert got == intersect | complement


def test_intersection_requires_both(deps):
    assert nodes_of(select(deps, "C,D")) == set()  # disjoint singletons


def test_closure_depths_match_bruteforce():
    """Closure depth = min over descendants v of (down[v] + hops_rev(v,u));
    the seeded multi-source BFS must agree with an explicit per-descendant
    walk on a random DAG."""
    import numpy as np
    import networkx as nx

    rng = np.random.default_rng(7)
    n = 60
    g_nx = nx.gnp_random_graph(n, 0.06, seed=3, directed=True)
    dag_edges = [(u, v) for u, v in g_nx.edges() if u < v]
    if not dag_edges:
        dag_edges = [(0, 1)]
    src = [f"n{u}" for u, _ in dag_edges]
    dst = [f"n{v}" for _, v in dag_edges]
    g = Graph.from_edges(src, dst, device="cpu")

    start = src[0]
    rows = {node: (d, direction) for node, d, direction in select(g, f"@{start}")}

    # brute force with networkx
    dg = nx.DiGraph(dag_edges)
    s = int(start[1:])
    down = nx.single_source_shortest_path_length(dg, s)
    closure: dict = {}
    for v, dv in down.items():
        up = nx.single_source_shortest_path_length(dg.reverse(copy=False), v)
        for u, du in up.items():
            tot = dv + du
            if u not in closure or tot < closure[u]:
                closure[u] = tot
    assert set(rows) == {f"n{u}" for u in closure}
    for u, tot in closure.items():
        # descendants report their down-depth (direction wins over the
        # possibly-shorter down-then-up path); pure closure nodes report
        # the min over descendants of (down[v] + hops_rev(v, u))
        want = down[u] if u in down else tot
        assert rows[f"n{u}"][0] == want, (u, rows[f"n{u}"], want)


def test_selector_host_and_device_paths_agree(rng):
    """Selector BFS closures route host/device like every other graph
    analytic; both paths must return identical (depth, direction)
    maps — including the seeded multi-source closure."""
    n = 120
    src = rng.integers(0, n, 400).tolist()
    dst = rng.integers(0, n, 400).tolist()
    g_host = _route(Graph.from_edges(src, dst, device="cpu"), "host")
    g_dev = _route(Graph.from_edges(src, dst, device="cpu"), "device")

    for sel in (f"@{src[0]}", f"2+{src[1]}+2", f"+{src[2]}", f"{src[3]}+1"):
        rows_h = select(g_host, sel)
        rows_d = select(g_dev, sel)
        assert rows_h == rows_d, sel


def test_selector_random_expressions_match_bruteforce_oracle():
    import numpy as np

    """Differential fuzz representative: random selectors evaluated
    against an independent python-set oracle of the documented
    semantics (docs/graph-select.md operator table). A 60-expression
    soak of this ran clean; three graphs x four expressions stay in CI."""
    rng = np.random.default_rng(29)

    def bfs_set(adj, start, depth):
        out, frontier, d = {start}, {start}, 0
        while frontier and (depth is None or d < depth):
            nxt = set()
            for u in frontier:
                nxt |= adj.get(u, set())
            nxt -= out
            out |= nxt
            frontier = nxt
            d += 1
        return out

    def atom_set(fwd, rev, a):
        ident, up, down, closure = a
        if closure:
            desc = bfs_set(fwd, ident, None)
            out = set(desc)
            for n in desc:
                out |= bfs_set(rev, n, None)
            return out
        out = {ident}
        if up is not None:
            out |= bfs_set(rev, ident, None if up < 0 else up)
        if down is not None:
            out |= bfs_set(fwd, ident, None if down < 0 else down)
        return out

    def render(a):
        ident, up, down, closure = a
        if closure:
            return "@" + ident
        s = ident
        if up is not None:
            s = ("+" if up < 0 else f"{up}+") + s
        if down is not None:
            s = s + ("+" if down < 0 else f"+{down}")
        return s

    for _graph_i in range(3):
        v = int(rng.integers(8, 30))
        e = int(rng.integers(v, 4 * v))
        src = rng.integers(0, v, e)
        dst = rng.integers(0, v, e)
        names = [f"m{i}" for i in range(v)]
        g = Graph.from_edges([names[i] for i in src], [names[i] for i in dst],
                             device="cpu")
        present = sorted({names[i] for i in src} | {names[i] for i in dst})
        fwd, rev = {}, {}
        for a, b in zip(src, dst):
            fwd.setdefault(names[a], set()).add(names[b])
            rev.setdefault(names[b], set()).add(names[a])

        def rand_atom():
            ident = str(rng.choice(present))
            if rng.random() < 0.2:
                return (ident, None, None, True)
            up = int(rng.choice([-1, 1, 2])) if rng.random() < 0.5 else None
            down = int(rng.choice([-1, 1, 2])) if rng.random() < 0.5 else None
            return (ident, up, down, False)

        for _expr_i in range(4):
            terms = []
            for _ in range(int(rng.integers(1, 4))):
                negated = rng.random() < 0.25
                atoms = [rand_atom()
                         for _ in range(1 if negated else int(rng.integers(1, 3)))]
                terms.append((atoms, negated))
            text = " ".join(
                ("not " if neg else "") + ",".join(render(a) for a in atoms)
                for atoms, neg in terms
            )
            want = set()
            allnodes = set(present)
            for atoms, neg in terms:
                tset = allnodes.copy()
                for a in atoms:
                    tset &= atom_set(fwd, rev, a)
                want |= (allnodes - tset) if neg else tset
            got = {r[0] for r in select(g, text)}
            assert got == want, (text, sorted(got ^ want)[:10])


# ───────────── against muninn_tpu.graph.selector ─────────────


def _random_expression(r, present):
    def atom():
        ident = str(r.choice(present))
        if r.random() < 0.2:
            return "@" + ident
        up = r.choice(["", "+", "1+", "2+"])
        down = r.choice(["", "+", "+1", "+3"])
        return up + ident + down

    terms = []
    for _ in range(int(r.integers(1, 4))):
        if r.random() < 0.25:
            terms.append("not " + atom())
        else:
            terms.append(",".join(atom() for _ in range(int(r.integers(1, 3)))))
    return " ".join(terms)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_select_matches_jax_row_for_row(seed, route):
    """Random graphs (self-loops and parallel edges as drawn, int ids and
    string ids) and random expressions: the port's rows equal JAX's, depth
    and direction included, with both packages on the same route."""
    r = np.random.default_rng(seed)
    v = int(r.integers(10, 60))
    e = int(r.integers(v, 4 * v))
    src = r.integers(0, v, e)
    dst = r.integers(0, v, e)
    if seed % 2:
        src, dst = [f"m{i}" for i in src], [f"m{i}" for i in dst]
    else:
        src, dst = src.tolist(), dst.tolist()
    ours = _route(Graph.from_edges(src, dst, device="cpu"), route)
    ref = _route(JaxGraph.from_edges(src, dst), route)
    present = sorted({str(x) for x in src} | {str(x) for x in dst})
    for _ in range(8):
        text = _random_expression(r, present)
        assert select(ours, text) == jax_select(ref, text), text
