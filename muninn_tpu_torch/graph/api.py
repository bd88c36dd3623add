"""Public graph-analytics API: the port's ``Graph``.

The Python-call surface replacing the reference's SQL TVFs
(``graph_bfs``, ``graph_dfs``, ``graph_shortest_path``,
``graph_components``, ``graph_pagerank`` — ``src/graph_tvf.c``), as in
``muninn_tpu.graph.api``. Hidden-column SQL parameters become keyword
arguments; results come back as numpy arrays / lists aligned to original
node ids instead of SQL rows. Centrality (``degree``, ``betweenness``,
``edge_betweenness``, ``closeness``) and communities (``leiden``,
``modularity``) are not ported yet, and this class does not define them.

Backend routing
---------------
Every analytics method takes ``backend='auto'|'host'|'device'``. 'auto'
routes each op to whichever engine is faster at the workload's size (the
native C++ kernels, ``native/src/muninn_graph.cpp``, or the device
fixpoints, by the measured crossovers in ``graph.routing``); a graph whose
edges live only on the device stays there. 'device' runs the fixpoints on
the graph's device (the card, or the CPU for a graph built with
``device="cpu"``) and never falls back to the host. Both engines produce
the same results (same tie-breaks, same epsilon rules).
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import native
from muninn_tpu_torch.graph import core
from muninn_tpu_torch.graph import routing
from muninn_tpu_torch.graph import traversal as trv
from muninn_tpu_torch.graph.pagerank import pagerank_sorted
from muninn_tpu_torch.graph.routing import use_host
from muninn_tpu_torch.ops.segments import bincount_chunked, seg_sum

#: traversal along a direction pulls over the opposite CSR's rows
_OPP = {"forward": "reverse", "reverse": "forward", "both": "both"}


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array; from the card through pinned memory, since a
    copy into pageable memory runs at a fraction of the link's rate."""
    if t.device.type != "cuda":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


class Graph(core.Graph):
    """Graph with analytics methods. Construct via ``Graph.from_edges`` or
    ``Graph.from_device_edges``.

    ``direction`` arguments follow the reference semantics
    (``src/graph_load.c:215-245``): 'forward' traverses src->dst,
    'reverse' traverses dst->src, 'both' treats edges as undirected.
    """

    def _use_host(self, backend: str, work: float,
                  ceiling: float | None = None) -> bool:
        if backend == "auto" and self.device_native:
            # a graph whose edges live only on the device (from_device_edges,
            # host mirrors never materialized): the host engine would first
            # download the whole edge list; 'auto' stays on the device, and
            # backend='host' opts into the download
            return False
        return use_host(backend, work, ceiling)

    # ── traversal ──

    def bfs(self, start, max_depth: int | None = None,
            direction: str = "forward", backend: str = "auto",
            as_array: bool = False):
        """Breadth-first traversal. Returns list of (node, depth, parent)
        ordered by (depth, node index), parent None for the root —
        the reference TVF's output columns (``src/graph_tvf.c:230-416``).
        ``as_array=True`` instead returns the raw ``(depth, parent)``
        index-aligned int32 numpy arrays (depth >= 2**30 == unreached), the
        shape to ask for at device scale.
        """
        s = self.node_index(start)
        md = max_depth if max_depth is not None else self.num_nodes
        if self._use_host(backend, routing.COST_BFS_EDGE * self.num_edges,
                          routing.HOST_SECONDS_BFS):
            off, _, dd, _ = self.host_csr(direction)
            depth, parent = native.graph_bfs(off, dd, s, md)
        else:
            # pull form: traversal along `direction` reduces over the
            # OPPOSITE CSR (its rows are each node's in-edges)
            c = self.csr(_OPP[direction])
            depth, parent = trv.bfs_pull(c.offsets, c.dst, s,
                                         self.num_nodes, md)
            depth, parent = _host(depth), _host(parent)
        if as_array:
            return depth, parent
        reached = np.nonzero(depth < 2**30)[0]
        order = reached[np.lexsort((reached, depth[reached]))]
        id_of = self.nodes.id_of
        return [
            (id_of(v), d, id_of(p) if p >= 0 else None)
            for v, d, p in zip(
                order.tolist(),
                depth[order].tolist(),
                parent[order].tolist(),
            )
        ]

    def dfs(self, start, max_depth: int | None = None,
            direction: str = "forward"):
        """Depth-first traversal order (node, depth, parent). DFS is an
        inherently sequential enumeration — always host (C++ kernel
        when available, python fallback otherwise; identical order)."""
        s = self.node_index(start)
        md = max_depth if max_depth is not None else self.num_nodes
        off, _, dd, _ = self.host_csr(direction)
        res = native.graph_dfs(off, dd, s, md)
        if res is None:
            rows = trv.dfs_host(off, dd, s, md)
            order = [r[0] for r in rows]
            depth = [r[1] for r in rows]
            parent = [r[2] for r in rows]
        else:
            order, depth, parent = (a.tolist() for a in res)
        id_of = self.nodes.id_of
        return [
            (id_of(v), d, id_of(p) if p >= 0 else None)
            for v, d, p in zip(order, depth, parent)
        ]

    def shortest_path(
        self, start, end, *, weighted: bool | None = None,
        direction: str = "forward", backend: str = "auto",
    ):
        """Shortest path. Returns (path list of node ids, distance) or
        ([], inf) when unreachable. ``weighted`` defaults to whether
        weights were supplied (the reference picks BFS vs Dijkstra by
        the weight_col argument, ``src/graph_tvf.c:472-753``)."""
        s = self.node_index(start)
        t = self.node_index(end)
        if weighted is None:
            weighted = self.has_weights
        if self._use_host(backend, routing.COST_SSSP_EDGE * self.num_edges,
                          routing.HOST_SECONDS_SSSP):
            hs, hd, hw = self.host_coo(direction)
            w = hw if weighted else np.ones_like(hw)
            dist, parent = native.graph_sssp(hs, hd, w, self.num_nodes, s)
        else:
            c = self.csr(_OPP[direction])  # pull CSR
            w = (c.w() if weighted
                 else torch.ones(c.capacity, device=c.dst.device))
            dist, parent = trv.sssp_with_parents_pull(
                c.offsets, c.dst, w, s, self.num_nodes)
            dist, parent = _host(dist), _host(parent)
        if not np.isfinite(dist[t]):
            return [], float("inf")
        path_idx = trv.reconstruct_path(parent, s, t)
        return [self.nodes.id_of(i) for i in path_idx], float(dist[t])

    def connected_components(self, backend: str = "auto",
                             as_array: bool = False):
        """Returns dict node_id -> (component_id, component_size);
        component ids are 0..k-1 renumbered by first appearance
        (``src/graph_tvf.c:1204-1360``). Undirected semantics (the
        reference's union-find ignores direction). ``as_array=True``
        returns the index-aligned renumbered label array instead (sizes
        are one ``np.bincount`` away) — the device-scale shape."""
        if self._use_host(
            backend, routing.COST_COMPONENTS_EDGE * self.num_edges,
            routing.HOST_SECONDS_COMPONENTS,
        ):
            comp = native.graph_components(
                self._src, self._dst, self.num_nodes
            )
            _, inv = np.unique(comp, return_inverse=True)
        else:
            # undirected neighbourhood min over the fwd+rev CSR pair: the
            # merged 'both' CSR's fixpoint at half its resident memory
            cf = self.csr("forward")
            cr = self.csr("reverse")
            comp = trv.connected_components_2csr(
                cf.offsets, cf.dst, cr.offsets, cr.dst, self.num_nodes,
            )
            # renumbered where the labels are (np.unique's sorted order)
            inv = _host(torch.unique(comp, return_inverse=True)[1].int())
        if as_array:
            return inv.astype(np.int32)
        sizes = np.bincount(inv)
        id_of = self.nodes.id_of
        return {
            id_of(i): cs
            for i, cs in enumerate(zip(inv.tolist(), sizes[inv].tolist()))
        }

    # ── spectral / iterative ──

    def pagerank(
        self, damping: float = 0.85, iterations: int = 20,
        *, weighted: bool = False, direction: str = "forward",
        backend: str = "auto", as_array: bool = False,
    ):
        """PageRank with dangling redistribution; defaults match the
        reference (damping=0.85, iterations=20,
        ``src/graph_tvf.c:1631-1717``). Returns node_id -> rank, or the
        index-aligned float32 array with ``as_array=True`` (device-scale
        shape)."""
        e_dir = self.num_edges * (2 if direction == "both" else 1)
        if self._use_host(
            backend, routing.COST_PAGERANK_EDGE_ITER * e_dir * iterations,
            routing.HOST_SECONDS_PAGERANK,
        ):
            hs, hd, hw = self.host_coo(direction)
            deg = np.zeros(self.num_nodes, np.float32)
            if weighted:
                np.add.at(deg, hs, hw)
            else:
                np.add.at(deg, hs, 1.0)
            rank = native.graph_pagerank(
                hs, hd, hw, deg, damping, iterations, weighted
            )
            if as_array:
                return np.asarray(rank, np.float32)
            id_of = self.nodes.id_of
            return {id_of(i): r
                    for i, r in enumerate(np.asarray(rank).tolist())}
        # the pull iterates over TARGET-sorted edges (the opposite
        # direction's CSR), where per-node sums are prefix window sums
        cr = self.csr(_OPP[direction])
        cached = {
            "forward": self._fwd, "reverse": self._rev, "both": self._both,
        }[direction]
        if cached is None and self.device_native:
            # out-degrees WITHOUT building the direction CSR (whose only
            # role here is degrees): cr's value array holds exactly the
            # source endpoints, so a bincount over it gives the same sums
            deg = bincount_chunked(
                cr.dst, cr.weights if weighted else None,
                self.num_nodes, cr.capacity,
            )
        else:
            c = self.csr(direction)
            # weighted out-degree: the direction CSR groups edges by src,
            # so per-node weight sums are segment sums (pads carry w=0)
            deg = (seg_sum(c.w(), c.offsets) if weighted
                   else c.degrees().float())
        # unweighted: never touches the weights (a device CSR has none)
        w_arg = cr.w() if weighted else cr.dst.new_zeros(1, dtype=torch.float32)
        rank = _host(pagerank_sorted(
            cr.offsets, cr.dst, w_arg, deg, self.num_nodes,
            damping, iterations, weighted,
        ))
        if as_array:
            return rank
        id_of = self.nodes.id_of
        return {id_of(i): r for i, r in enumerate(rank.tolist())}
