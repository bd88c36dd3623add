"""Public graph-analytics API: the port's ``Graph``.

The Python-call surface replacing the reference's SQL TVFs
(``graph_bfs``, ``graph_dfs``, ``graph_shortest_path``,
``graph_components``, ``graph_pagerank`` — ``src/graph_tvf.c``;
``graph_degree``/``graph_node_betweenness``/``graph_edge_betweenness``/
``graph_closeness`` — ``src/graph_centrality.c``; ``graph_leiden`` —
``src/graph_community.c``), as in ``muninn_tpu.graph.api``. Hidden-column
SQL parameters become keyword arguments; results come back as numpy arrays
/ lists aligned to original node ids instead of SQL rows.

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
from muninn_tpu_torch.graph import centrality as ctr
from muninn_tpu_torch.graph import community as cmty
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

    def _device_coo(self, direction: str, weighted: bool = True):
        """(src, dst, w) of ``direction`` as tensors on the graph's device:
        the device COO of a device-built graph (nothing crosses to the
        host), else the host mirrors uploaded. 'both' doubles each edge;
        ``weighted=False`` gives unit weights."""
        if self.device_native:
            e = self._e_dev
            js, jd, jw = self._dev_coo
            s, d = js[:e], jd[:e]
            w = jw[:e] if jw is not None else torch.ones(e, device=js.device)
        else:
            s, d, w = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                       for a in (self._src, self._dst, self._w))
        if not weighted:
            w = torch.ones_like(w)
        if direction == "reverse":
            return d, s, w
        if direction == "both":
            return torch.cat([s, d]), torch.cat([d, s]), torch.cat([w, w])
        return s, d, w

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

    # ── centrality ──

    def degree(
        self, *, direction: str = "both", weighted: bool = False,
        normalized: bool = False,
    ) -> dict:
        """Degree centrality (``src/graph_centrality.c:667-680``), summed
        where the edges are: on the device for a device-built graph, on the
        host mirrors otherwise (as in JAX)."""
        coo = (self._device_coo("forward") if self.device_native
               else (self._src, self._dst, self._w))
        vals = ctr.degree_centrality(
            *coo, self.num_nodes,
            direction=direction, weighted=weighted, normalized=normalized,
        )
        id_of = self.nodes.id_of
        return {id_of(i): v for i, v in enumerate(vals.tolist())}

    def _brandes(self, direction, weighted, want_edge, normalized,
                 sample_sources, auto_approx_threshold, seed, backend):
        """Brandes on the deduplicated COO of ``direction``, routed by
        ``_use_host``: (node_cb, edge_cb or None, src, dst) with the
        deduplicated endpoints as numpy."""
        n = self.num_nodes
        e_dir = self.num_edges * (2 if direction == "both" else 1)
        n_src = ctr.n_sources(n, sample_sources, auto_approx_threshold)
        if self._use_host(backend,
                          ctr.brandes_host_seconds(n_src, e_dir, weighted),
                          routing.HOST_SECONDS_BRANDES):
            hs, hd, hw = self.host_coo(direction)
            w = hw if weighted else np.ones(len(hs), np.float32)
            s, d, w = ctr.dedupe_parallel_edges(hs, hd, w, n)
            engine = "host"
        else:
            s, d, w = ctr.dedupe_parallel_edges_device(
                *self._device_coo(direction, weighted), n)
            engine = "device"
        cb, eb = ctr.betweenness(
            s, d, w, n,
            undirected=(direction == "both"), normalized=normalized,
            want_edge=want_edge, sample_sources=sample_sources,
            auto_approx_threshold=auto_approx_threshold, seed=seed,
            backend=engine, weighted_alg=weighted,
        )
        return cb, eb, ctr._np(s), ctr._np(d)

    def betweenness(
        self, *, normalized: bool = False, direction: str = "both",
        weighted: bool = False, sample_sources: int | None = None,
        auto_approx_threshold: int = ctr.DEFAULT_APPROX_THRESHOLD,
        seed: int = 0, backend: str = "auto", as_array: bool = False,
    ):
        """Brandes node betweenness (``src/graph_centrality.c:393-512``).
        sqrt(N)-source sampling above ``auto_approx_threshold``. Returns
        node_id -> value, or the index-aligned float32 array with
        ``as_array=True``."""
        cb, _, _, _ = self._brandes(
            direction, weighted, False, normalized, sample_sources,
            auto_approx_threshold, seed, backend)
        if as_array:
            return cb
        id_of = self.nodes.id_of
        return {id_of(i): v for i, v in enumerate(cb.tolist())}

    def edge_betweenness(
        self, *, normalized: bool = False, direction: str = "both",
        weighted: bool = False, sample_sources: int | None = None,
        auto_approx_threshold: int = ctr.DEFAULT_APPROX_THRESHOLD,
        seed: int = 0, backend: str = "auto",
    ) -> dict:
        """Edge betweenness keyed by (src_id, dst_id). For 'both', the
        two orientations of an input edge are combined."""
        _, eb, srcs, dsts = self._brandes(
            direction, weighted, True, normalized, sample_sources,
            auto_approx_threshold, seed, backend)
        out: dict = {}
        id_of = self.nodes.id_of
        for s, d, v in zip(srcs.tolist(), dsts.tolist(), eb.tolist()):
            if direction == "both":
                key = (id_of(min(s, d)), id_of(max(s, d)))
            else:
                key = (id_of(s), id_of(d))
            out[key] = out.get(key, 0.0) + v
        return out

    def closeness(
        self, *, normalized: bool = True, direction: str = "both",
        weighted: bool = False, backend: str = "auto",
        as_array: bool = False,
    ):
        """Closeness with Wasserman-Faust correction when normalized
        (``src/graph_centrality.c:1404-1434``). For directed graphs the
        standard definition uses *incoming* distances, so 'forward' here
        measures distance from the node along edge direction."""
        eff_dir = (
            "both" if direction == "both"
            else ("reverse" if direction == "forward" else "forward")
        )
        n = self.num_nodes
        e_dir = self.num_edges * (2 if direction == "both" else 1)
        if self._use_host(backend,
                          ctr.closeness_host_seconds(n, e_dir, weighted),
                          routing.HOST_SECONDS_CLOSENESS):
            hs, hd, hw = self.host_coo(eff_dir)
            coo = (hs, hd, hw if weighted else np.ones(len(hs), np.float32))
            engine = "host"
        else:
            coo = self._device_coo(eff_dir, weighted)
            engine = "device"
        vals = ctr.closeness(*coo, n, normalized=normalized, backend=engine,
                             weighted_alg=weighted)
        if as_array:
            return vals
        id_of = self.nodes.id_of
        return {id_of(i): v for i, v in enumerate(vals.tolist())}

    # ── communities ──

    def leiden(
        self, *, resolution: float = 1.0, seed: int = 0,
        max_rounds: int = 100, backend: str = "auto",
        as_array: bool = False,
    ):
        """Leiden communities. Returns (node_id -> community_id,
        modularity) — the reference TVF emits (node, community_id,
        modularity) rows (``src/graph_community.c``); with
        ``as_array=True`` the index-aligned int32 labels instead of the
        dict."""
        if self._use_host(backend, routing.COST_LEIDEN_EDGE * 2
                          * max(self.num_edges, 1),
                          routing.HOST_SECONDS_LEIDEN):
            coo, engine = self.host_coo("both"), "host"
        else:
            coo, engine = self._device_coo("both"), "device"
        labels, q = cmty.leiden(
            *coo, self.num_nodes, resolution=resolution, seed=seed,
            max_rounds=max_rounds, backend=engine,
        )
        if as_array:
            return labels, float(q)
        id_of = self.nodes.id_of
        return {id_of(i): lab for i, lab in enumerate(labels.tolist())}, float(q)

    def modularity(self, labels, resolution: float = 1.0) -> float:
        """Q of a partition: ``labels`` maps node_id -> community, or is
        the index-aligned label array. Computed on the graph's device."""
        if isinstance(labels, dict):
            labels = np.array(
                [labels[self.nodes.id_of(i)] for i in range(self.num_nodes)],
                np.int32,
            )
        return cmty.modularity(*self._device_coo("both"), labels, resolution)
