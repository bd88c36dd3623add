"""dbt-style node-selector DSL.

Re-implementation of the reference's selector
(``src/graph_selector_parse.c`` recursive-descent parser +
``src/graph_selector_eval.c`` bit-vector NodeSet evaluator,
grammar per ``docs/graph-select.md``):

    expression := term ( SPACE term )*          -- union
    term       := "not" atom                    -- complement
                | atom ( "," atom )*            -- intersection
    atom       := [ "@" ] [ INT "+" ] ident [ "+" [ INT ] ]

Atom semantics (``docs/graph-select.md`` operator table):
``node`` self; ``+node`` self+ancestors; ``node+`` self+descendants;
``N+node+M`` depth-limited both ways; ``@node`` descendants plus all
their ancestors (transitive build closure).

Evaluation runs a BFS per anchor (ancestors = reverse direction,
descendants = forward) on the host engine or the device fixpoints, routed
by ``Graph._use_host`` with BFS's measured ceiling, and combines the
resulting depth maps as sets — the analogue of the reference's bit-vector
closures (``src/graph_selector_eval.c:153-232``). The port's copy of
``muninn_tpu.graph.selector``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

from muninn_tpu_torch import native
from muninn_tpu_torch.graph import routing
from muninn_tpu_torch.graph.traversal import bfs_pull, seeded_bfs_depths_pull

_IDENT_RE = re.compile(r"[A-Za-z0-9_.\-]+")


class SelectorError(ValueError):
    pass


@dataclass
class Atom:
    ident: str
    up: int | None = None      # None = no ancestors; -1 = unlimited; N = depth
    down: int | None = None
    closure: bool = False      # @ prefix


@dataclass
class Term:
    atoms: list = field(default_factory=list)  # intersection of atoms
    negated: bool = False


@dataclass
class Expression:
    terms: list = field(default_factory=list)  # union of terms


# ───────────────────────── parser ─────────────────────────


class _Parser:
    """Recursive descent over the selector grammar."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _skip_ws(self):
        while self._peek() == " ":
            self.pos += 1

    def parse(self) -> Expression:
        expr = Expression()
        self._skip_ws()
        if not self._peek():
            raise SelectorError("empty selector")
        while self.pos < len(self.text):
            expr.terms.append(self._term())
            self._skip_ws()
        return expr

    def _term(self) -> Term:
        term = Term()
        if self.text[self.pos :].startswith("not ") or self.text[self.pos :] == "not":
            self.pos += 3
            self._skip_ws()
            term.negated = True
            term.atoms.append(self._atom())
            return term
        term.atoms.append(self._atom())
        while self._peek() == ",":
            self.pos += 1
            term.atoms.append(self._atom())
        return term

    def _atom(self) -> Atom:
        a = Atom(ident="")
        if self._peek() == "@":
            a.closure = True
            self.pos += 1
        # optional "N+" or "+" prefix
        m = re.match(r"(\d+)\+", self.text[self.pos :])
        if m:
            a.up = int(m.group(1))
            self.pos += m.end()
        elif self._peek() == "+":
            a.up = -1
            self.pos += 1
        m = _IDENT_RE.match(self.text, self.pos)
        if not m:
            raise SelectorError(
                f"expected identifier at position {self.pos} in {self.text!r}"
            )
        a.ident = m.group(0)
        self.pos = m.end()
        # optional "+" / "+M" suffix
        if self._peek() == "+":
            self.pos += 1
            m = re.match(r"\d+", self.text[self.pos :])
            if m:
                a.down = int(m.group(0))
                self.pos += m.end()
            else:
                a.down = -1
        if a.closure and (a.up is not None or a.down is not None):
            raise SelectorError("@closure cannot combine with +depth specs")
        return a


def parse_selector(text: str) -> Expression:
    return _Parser(text).parse()


# ───────────────────────── evaluator ─────────────────────────


_UNREACHED = 2**30


def _depths(graph, direction: str, start: int, max_depth: int,
            host: bool) -> np.ndarray:
    """BFS depths along ``direction`` ('forward' = descendants), on the host
    engine or the device fixpoint. The pull form: traversal along
    ``direction`` consumes the OPPOSITE direction's CSR (whose rows are each
    node's in-edges along it)."""
    if host:
        off, _, dd, _ = graph.host_csr(direction)
        depth, _ = native.graph_bfs(off, dd, start, max_depth)
        return np.asarray(depth)
    opp = {"forward": "reverse", "reverse": "forward"}[direction]
    c = graph.csr(opp)
    depth, _ = bfs_pull(c.offsets, c.dst, start, graph.num_nodes, max_depth)
    return depth.cpu().numpy()


def _seeded_bfs_host(off, dst, seed_depth: np.ndarray) -> np.ndarray:
    """Multi-source BFS with heterogeneous entry depths (Dial buckets):
    depth[u] = min over seeds v of seed_depth[v] + hops(v, u). The host
    form of ``seeded_bfs_depths_pull``."""
    depth = np.asarray(seed_depth, np.int64).copy()
    buckets: dict[int, list[int]] = {}
    for v in np.nonzero(depth < _UNREACHED)[0]:
        buckets.setdefault(int(depth[v]), []).append(int(v))
    while buckets:
        d = min(buckets)
        for v in buckets.pop(d):
            if depth[v] != d:
                continue  # relaxed to a smaller depth already
            for e in range(off[v], off[v + 1]):
                u = int(dst[e])
                if depth[u] > d + 1:
                    depth[u] = d + 1
                    buckets.setdefault(d + 1, []).append(u)
    return depth


def _eval_atom(graph, a: Atom) -> dict[int, tuple[int, str]]:
    """Returns node_idx -> (depth, direction)."""
    idx = graph.nodes.find(a.ident)
    if idx is None and a.ident.lstrip("-").isdigit():
        # graphs built from integer edge lists intern int ids; selector
        # text like "@5" should still resolve (the reference's SQL
        # surface is untyped text, so "5" matches INTEGER 5 there)
        idx = graph.nodes.find(int(a.ident))
    if idx is None:
        return {}
    n = graph.num_nodes
    out: dict[int, tuple[int, str]] = {idx: (0, "self")}

    def add(depths: np.ndarray, direction: str):
        reached = np.nonzero(depths < 2**30)[0]
        for v in reached:
            d = int(depths[v])
            if v == idx:
                continue
            if int(v) not in out or d < out[int(v)][0]:
                out[int(v)] = (d, direction)

    host = graph._use_host("auto", routing.COST_BFS_EDGE * graph.num_edges,
                           routing.HOST_SECONDS_BFS)

    if a.closure:
        # descendants, then ancestors of every descendant (including
        # self). The per-descendant ancestor walks collapse into ONE
        # seeded multi-source BFS on the reverse graph: seeding each
        # descendant v at depth down[v] yields exactly
        # min_v(down[v] + hops_rev(v, u)) per node u.
        down = _depths(graph, "forward", idx, n, host)
        add(down, "descendant")
        if host:
            roff, _, rdd, _ = graph.host_csr("reverse")
            up = _seeded_bfs_host(roff, rdd, down)
        else:
            fwd = graph.csr("forward")  # pull CSR of the reverse graph
            up = seeded_bfs_depths_pull(
                fwd.offsets, fwd.dst,
                torch.from_numpy(down).to(fwd.offsets.device), n,
            ).cpu().numpy()
        for u in np.nonzero(up < _UNREACHED)[0]:
            if int(u) not in out:
                out[int(u)] = (int(up[u]), "closure")
        return out

    if a.up is not None:
        md = n if a.up < 0 else a.up
        up = _depths(graph, "reverse", idx, md, host)
        add(up, "ancestor")
    if a.down is not None:
        md = n if a.down < 0 else a.down
        down = _depths(graph, "forward", idx, md, host)
        add(down, "descendant")
    return out


def evaluate_selector(graph, expr: Expression) -> dict[int, tuple[int, str]]:
    n = graph.num_nodes
    union: dict[int, tuple[int, str]] = {}
    for term in expr.terms:
        sets = [_eval_atom(graph, a) for a in term.atoms]
        if term.negated:
            excluded = set(sets[0].keys())
            members = {
                v: (0, "self") for v in range(n) if v not in excluded
            }
        else:
            common = set(sets[0].keys())
            for s in sets[1:]:
                common &= set(s.keys())
            members = {}
            for v in common:
                best = min((s[v] for s in sets), key=lambda t: t[0])
                members[v] = best
        for v, (d, direction) in members.items():
            if v not in union or d < union[v][0]:
                union[v] = (d, direction)
    return union


def select(graph, selector: str):
    """Evaluate a selector over a Graph. Returns rows
    ``(node_id, depth, direction)`` sorted by (depth, node) — the TVF
    output contract (``docs/graph-select.md``)."""
    expr = parse_selector(selector)
    result = evaluate_selector(graph, expr)
    rows = [
        (graph.nodes.id_of(v), d, direction)
        for v, (d, direction) in result.items()
    ]
    rows.sort(key=lambda r: (r[1], str(r[0])))
    return rows
