"""GraphCache — persistent CSR cache with a delta log.

Re-design of the reference's ``graph_adjacency`` virtual table
(``src/graph_adjacency.c``): there, AFTER-INSERT/DELETE/UPDATE triggers
append to a ``_delta`` shadow table and the next read lazily applies
them — incremental if ``delta <= max(10, E/10)``, full rebuild
otherwise (``:1011-1034``), with blocked-CSR storage so only affected
4096-node blocks are rewritten.

Here the edge store is a host numpy COO + interned node registry; the
device CSR (on the cache's ``device``, the card unless the caller asks for
the CPU) is derived lazily and patched in place by a small delta. The same
freshness policy applies (it decides *host merge strategy*: in-place
append/filter vs full re-sort); persistence writes the COO in fixed-size
blocks, rewriting only the blocks a delta dirtied, plus the JSONL delta log
replayed on load (``io/checkpoint.DeltaLog``). The port's copy of
``muninn_tpu.graph.adjacency``; its checkpoints are JAX's, byte for byte.
"""

from __future__ import annotations

import json
import os
import zlib
from pathlib import Path

import numpy as np
import torch

from muninn_tpu_torch.graph.api import Graph
from muninn_tpu_torch.graph.core import (
    DeviceCsr,
    NodeTable,
    csr_patch_positions,
)
from muninn_tpu_torch.index.store import resolve_device
from muninn_tpu_torch.io.checkpoint import (
    DeltaLog,
    _read_manifest,
    _write_manifest,
)
from muninn_tpu_torch.native import csr_apply_delta


class GraphCache:
    """Mutable edge store + cached analytics ``Graph``.

    API mirrors the reference's command surface: mutations queue
    deltas; ``graph()`` (any read) ensures freshness; ``rebuild()`` /
    ``incremental_rebuild()`` are the explicit commands
    (``INSERT INTO g(g) VALUES('rebuild')``, ``src/graph_adjacency.c:9-15``).
    """

    #: incremental threshold: delta <= max(10, E/10) (reference :1028)
    INCREMENTAL_FRACTION = 0.1
    INCREMENTAL_MIN = 10

    #: edges per persisted block (the reference's 4096-node CSR blocks,
    #: graph_csr.c:341-478; only dirty blocks are rewritten on save)
    BLOCK_EDGES = 131072

    def __init__(self, *, weighted: bool = False, log_path: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.nodes = NodeTable()
        self._src = np.zeros(0, np.int32)
        self._dst = np.zeros(0, np.int32)
        self._w = np.zeros(0, np.float32)
        self.weighted = weighted
        self.generation = 0
        self._graph: Graph | None = None
        self._pending: list[dict] = []
        self._mirror: dict[str, tuple] = {}
        self._mirror_perm: dict[str, np.ndarray] = {}
        self._log = DeltaLog(log_path) if log_path else None
        # persisted block layout: lengths per saved block (None until a
        # save/load establishes one), dirty block indices, and how many
        # node ids the save directory already holds (ids are append-only)
        self._block_lens: list[int] | None = None
        self._dirty_blocks: set[int] = set()
        self._saved_nodes = 0
        self._nodes_crc = 0  # running crc32 of nodes.jsonl bytes
        self._saved_dir: Path | None = None

    # ── construction ──

    @classmethod
    def from_edges(cls, src_ids, dst_ids, weights=None, **kw) -> "GraphCache":
        """Bulk construction: interns through ``Graph.from_edges`` (which
        has the vectorized integer fast path) instead of queuing one
        delta record per edge — at 10M edges the per-record queue costs
        minutes, the vectorized path seconds."""
        gc = cls(weighted=weights is not None, **kw)
        if not isinstance(src_ids, np.ndarray):
            src_a = np.asarray(src_ids)
            src_ids = src_a if np.issubdtype(src_a.dtype, np.integer) else src_ids
        if not isinstance(dst_ids, np.ndarray):
            dst_a = np.asarray(dst_ids)
            dst_ids = dst_a if np.issubdtype(dst_a.dtype, np.integer) else dst_ids
        g = Graph.from_edges(src_ids, dst_ids, weights, device=gc.device)
        gc.nodes = g.nodes
        gc._src = np.asarray(g._src, np.int32)
        gc._dst = np.asarray(g._dst, np.int32)
        gc._w = np.asarray(g._w, np.float32)
        gc.generation = 1
        if gc._log is not None:
            ids = gc.nodes.ids
            gc._log.append_many(
                {"op": "insert", "src": ids[s], "dst": ids[d], "w": float(ww)}
                for s, d, ww in zip(
                    gc._src.tolist(), gc._dst.tolist(), gc._w.tolist()
                )
            )
        return gc

    # ── mutation (the trigger role) ──

    def add_edges(self, src_ids, dst_ids, weights=None) -> None:
        src_ids = list(src_ids)
        dst_ids = list(dst_ids)
        if len(src_ids) != len(dst_ids):
            raise ValueError("src/dst length mismatch")
        w = (
            list(np.asarray(weights, np.float32))
            if weights is not None
            else [1.0] * len(src_ids)
        )
        for s, d, ww in zip(src_ids, dst_ids, w):
            rec = {"op": "insert", "src": s, "dst": d, "w": float(ww)}
            self._pending.append(rec)
            if self._log is not None:
                self._log.append(**rec)

    def remove_edges(self, src_ids, dst_ids) -> None:
        for s, d in zip(list(src_ids), list(dst_ids)):
            rec = {"op": "delete", "src": s, "dst": d}
            self._pending.append(rec)
            if self._log is not None:
                self._log.append(**rec)

    @property
    def delta_count(self) -> int:
        return len(self._pending)

    @property
    def num_edges(self) -> int:
        return len(self._src)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    # ── freshness (src/graph_adjacency.c:1011-1034) ──

    def _ensure_fresh(self) -> None:
        if not self._pending:
            return
        if self.generation == 0:
            self.rebuild()
        elif self.delta_count <= max(
            self.INCREMENTAL_MIN, int(self.num_edges * self.INCREMENTAL_FRACTION)
        ):
            self.incremental_rebuild()
        else:
            self.rebuild()

    def rebuild(self) -> None:
        """Full rebuild: apply every pending delta, re-sort, refresh the
        device CSR lazily (the SAVEPOINT-wrapped full path, :565-637)."""
        self._apply_pending()
        self.generation += 1
        self._graph = None
        self._mirror = {}
        self._mirror_perm = {}

    def incremental_rebuild(self) -> None:
        """Incremental rebuild: O(delta) instead of O(E).

        The reference rewrites only affected 4096-node CSR blocks
        (src/graph_adjacency.c:649-1005); here the *device-resident* CSR
        arrays are patched with one position-mask + stable-sort pass per
        materialized direction (``core.csr_patch_positions``) — no host
        re-sort, no full re-upload. Falls back to a full rebuild when the delta
        introduces new nodes (node-count growth changes every kernel's
        shapes), when a direction's capacity bucket would overflow, or
        when no device CSR exists yet.
        """
        if not self._pending:
            return
        g = self._graph
        fwd = getattr(g, "_fwd", None) if g is not None else None
        rev = getattr(g, "_rev", None) if g is not None else None
        if g is None or (fwd is None and rev is None):
            self.rebuild()
            return
        # build the mirror for a materialized direction up front: the
        # net-delta pass then answers existence queries with O(degree)
        # mirror lookups instead of an O(E) scan
        if fwd is not None:
            self._mirror_for(g, "_fwd")
        elif rev is not None:
            self._mirror_for(g, "_rev")
        net = self._net_delta()
        if net is None:
            self.rebuild()
            return
        ins_s, ins_d, ins_w, del_s, del_d = net
        # plan position-level patches against the PRE-batch mirrors
        plans = {}
        ok = True
        if fwd is not None:
            plans["_fwd"] = self._plan_patch(
                g, "_fwd", ins_s, ins_d, ins_w, del_s, del_d
            )
            ok &= plans["_fwd"] is not None
        if ok and rev is not None:
            plans["_rev"] = self._plan_patch(
                g, "_rev", ins_d, ins_s, ins_w, del_d, del_s
            )
            ok &= plans["_rev"] is not None
        # host arrays: the mirror plan already knows every deleted
        # position, so the COO updates by one masked copy + append —
        # no O(E) in-order replay scan (that scan alone cost ~1.8s per
        # mixed 1k delta at 10M edges in round 2)
        if ok and plans:
            attr0 = "_fwd" if "_fwd" in plans else "_rev"
            mirror_del = plans[attr0][0]
            coo_del = np.sort(self._mirror_perm[attr0][mirror_del])
            if len(coo_del):
                self._src = np.delete(self._src, coo_del)
                self._dst = np.delete(self._dst, coo_del)
                self._w = np.delete(self._w, coo_del)
            if len(ins_s):
                # net inserts are in pending order — identical to the
                # sequential replay's appended tail
                self._src = np.concatenate([self._src, ins_s])
                self._dst = np.concatenate([self._dst, ins_d])
                self._w = np.concatenate([self._w, ins_w])
            self._note_removed(coo_del)
            self._note_inserts(len(ins_s))
            self._pending = []
        else:
            self._apply_pending()  # exact in-order replay fallback
        g._src, g._dst, g._w = self._src, self._dst, self._w
        g._host_csr = {}  # host CSR cache follows the host arrays
        if ok:
            for attr, plan in plans.items():
                if getattr(g, attr) is not None:
                    self._apply_patch(g, attr, plan)
        else:
            g._fwd = g._rev = None
            self._mirror = {}
            self._mirror_perm = {}
        # 'both' re-derives from fwd+rev by a device merge on next read
        g._both = None
        self.generation += 1

    def _net_delta(self):
        """Net effect of the pending batch for device application:
        same-batch insert+delete pairs cancel (the in-order fresh-queue
        logic), leaving deletes that target pre-existing edges plus
        appended inserts — an order-independent form that matches the
        sequential host replay exactly. Returns None when the batch
        creates new nodes (device shapes would change)."""
        from collections import deque

        # live-edge multiplicity for every (s, d) key this batch
        # deletes: O(degree) mirror lookups when a direction mirror
        # exists (the incremental path guarantees one), else one
        # vectorized O(E) scan
        del_keys = []
        for r in self._pending:
            if r["op"] == "delete":
                s = self.nodes.find(r["src"])
                d = self.nodes.find(r["dst"])
                if s is not None and d is not None:
                    del_keys.append((s, d))
        existing_count: dict[tuple[int, int], int] = {}
        if del_keys and ("_fwd" in self._mirror or "_rev" in self._mirror):
            flip = "_fwd" not in self._mirror
            h_src, h_dst, h_w, h_off = self._mirror["_fwd" if not flip else "_rev"]
            for s, d in del_keys:
                key = (s, d)
                if key in existing_count:
                    continue
                a, b = (d, s) if flip else (s, d)
                lo, hi = int(h_off[a]), int(h_off[a + 1])
                existing_count[key] = int(np.count_nonzero(h_dst[lo:hi] == b))
        elif del_keys:
            v1 = len(self.nodes) + 1
            pack = self._src.astype(np.int64) * v1 + self._dst
            want = np.unique(
                np.array([s * v1 + d for s, d in del_keys], np.int64)
            )
            hit = pack[np.isin(pack, want)]
            vals, cnt = np.unique(hit, return_counts=True)
            existing_count = {
                (int(k // v1), int(k % v1)): int(c)
                for k, c in zip(vals, cnt)
            }

        ins: list[tuple[int, int, float]] = []
        ins_rem: list[bool] = []
        fresh: dict[tuple[int, int], deque] = {}
        dels: list[tuple[int, int]] = []
        dels_per_key: dict[tuple[int, int], int] = {}
        for r in self._pending:
            if r["op"] == "insert":
                s = self.nodes.find(r["src"])
                d = self.nodes.find(r["dst"])
                if s is None or d is None:
                    return None  # new node -> full rebuild
                fresh.setdefault((s, d), deque()).append(len(ins))
                ins.append((s, d, float(r.get("w", 1.0))))
                ins_rem.append(False)
            else:
                s = self.nodes.find(r["src"])
                d = self.nodes.find(r["dst"])
                if s is None or d is None:
                    continue
                q = fresh.get((s, d))
                # a delete consumes a same-batch insert only when no
                # pre-existing edge matches first (host replay scans
                # existing edges before fresh ones)
                prior = dels_per_key.get((s, d), 0)
                if q and existing_count.get((s, d), 0) <= prior:
                    ins_rem[q.popleft()] = True
                else:
                    dels.append((s, d))
                    dels_per_key[(s, d)] = prior + 1
        live = [t for t, r in zip(ins, ins_rem) if not r]
        ins_s = np.array([t[0] for t in live], np.int32)
        ins_d = np.array([t[1] for t in live], np.int32)
        ins_w = np.array([t[2] for t in live], np.float32)
        del_s = np.array([t[0] for t in dels], np.int32)
        del_d = np.array([t[1] for t in dels], np.int32)
        return ins_s, ins_d, ins_w, del_s, del_d

    def _plan_patch(self, g, attr: str, ins_s, ins_d, ins_w, del_s, del_d):
        """Plan one direction's patch against its PRE-batch host mirror:
        the mirror is bit-identical to the device CSR order, so each
        delete's first live (src, dst) occurrence is an O(degree) host
        lookup and the device never key-matches. Returns None when the
        capacity bucket would overflow (caller falls back to rebuild)."""
        c = getattr(g, attr)
        if c.e_valid + len(ins_s) > c.capacity:
            return None
        h_src, h_dst, h_w, h_off = self._mirror_for(g, attr)
        taken: dict[tuple[int, int], int] = {}
        del_pos = []
        for s_, d_ in zip(del_s.tolist(), del_d.tolist()):
            lo, hi = int(h_off[s_]), int(h_off[s_ + 1])
            idxs = np.nonzero(h_dst[lo:hi] == d_)[0]
            k = taken.get((s_, d_), 0)
            if k < len(idxs):
                del_pos.append(lo + int(idxs[k]))
                taken[(s_, d_)] = k + 1
            # else: delete of a nonexistent edge — a no-op, like replay
        order = np.argsort(ins_s, kind="stable")
        return (
            np.asarray(del_pos, np.int64),
            ins_s[order], ins_d[order], ins_w[order], order,
        )

    def _mirror_for(self, g, attr: str):
        """Host mirror (src, dst, w, offsets) of one device direction,
        in exactly the device CSR order; built once, patched in step.
        ``self._mirror_perm[attr]`` maps each mirror position to its COO
        index (the stable counting sort's permutation) — the delete
        fast path uses it to turn mirror-position deletes into COO
        deletes without an O(E) replay scan."""
        m = self._mirror.get(attr)
        if m is None:
            # the device CSR itself, downloaded: it is the host counting
            # sort of the COO (``core.build_csr_arrays``), or was patched in step
            # with this mirror, so it has the order by construction (the
            # host's counting sort of 10M edges takes about a second)
            c = getattr(g, attr)
            e = c.e_valid
            m = tuple(t[:e].cpu().numpy() for t in (c.s(), c.dst, c.w())) + (
                c.offsets.cpu().numpy(),)
            self._mirror[attr] = m
            # the stable sort's permutation (np.argsort(a, kind="stable")),
            # sorted on the cache's device, where a merge sort of 10M keys
            # on the host takes about a second
            a = g._src if attr == "_fwd" else g._dst
            self._mirror_perm[attr] = torch.sort(
                torch.from_numpy(a).to(self.device), stable=True
            )[1].cpu().numpy()
        return m

    def _apply_patch(self, g, attr: str, plan) -> None:
        del_pos, pis, pid, piw, ins_order = plan
        c = getattr(g, attr)
        v = self.num_nodes
        h_src, h_dst, h_w, h_off = self._mirror[attr]

        def up(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(c.dst.device)

        off, ss, dd, ww, _ = csr_patch_positions(
            c.offsets, c.s(), c.dst, c.w(),
            up(del_pos, np.int32), up(h_src[del_pos], np.int32),
            up(pis, np.int32), up(pid, np.int32), up(piw, np.float32),
            num_nodes=v,
        )
        # patch the mirror the same way (np.delete keeps order; inserts
        # land after existing equal-src edges, in rank order — exactly
        # the device sort's (src, rank) key)
        h_src2 = np.delete(h_src, del_pos)
        h_dst2 = np.delete(h_dst, del_pos)
        h_w2 = np.delete(h_w, del_pos)
        ipos = np.searchsorted(h_src2, pis, side="right")
        h_src3 = np.insert(h_src2, ipos, pis)
        h_dst3 = np.insert(h_dst2, ipos, pid)
        h_w3 = np.insert(h_w2, ipos, piw)
        counts = np.bincount(h_src3, minlength=v)
        h_off3 = np.zeros(v + 1, np.int32)
        np.cumsum(counts, out=h_off3[1:])
        self._mirror[attr] = (h_src3, h_dst3, h_w3, h_off3)

        # the host mirror already knows the EXACT new max degree (no
        # device read)
        max_deg = int(counts.max()) if v else 1
        setattr(g, attr, DeviceCsr(
            off, ss, dd, ww, len(self._src), max(max_deg, 1)
        ))

        # keep the mirror->COO permutation in lockstep: surviving COO
        # positions shift down past deletions; inserts append to the COO
        # tail in PENDING order (ins_order maps sorted insert -> rank)
        perm = self._mirror_perm[attr]
        gone = np.zeros(len(perm), np.int64)
        gone[perm[del_pos]] = 1
        perm2 = np.delete(perm, del_pos)
        # each survivor's shift: the deleted COO positions before it (a
        # gather from one cumulative count, not a binary search per edge)
        perm2 = perm2 - np.cumsum(gone)[perm2]
        e_kept = len(perm2)
        self._mirror_perm[attr] = np.insert(
            perm2, ipos, e_kept + ins_order.astype(np.int64)
        )

    def _apply_pending(self) -> None:
        """Replay queued deltas IN ORDER; a delete removes only the
        first live matching (src, dst) occurrence, so 'delete then
        re-insert' within one batch keeps the edge and parallel
        duplicate edges survive single deletes (reference
        graph_csr.c:219-247 sequential apply)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        if all(r["op"] == "insert" for r in pending):
            # insert-only: vectorized append (no per-edge replay)
            si = self.nodes.intern_many([r["src"] for r in pending])
            di = self.nodes.intern_many([r["dst"] for r in pending])
            wi = np.array([r.get("w", 1.0) for r in pending], np.float32)
            self._src = np.concatenate([self._src, si.astype(np.int32)])
            self._dst = np.concatenate([self._dst, di.astype(np.int32)])
            self._w = np.concatenate([self._w, wi])
            self._note_inserts(len(si))
            return
        nd = len(pending)
        d_src = np.full(nd, -1, np.int32)
        d_dst = np.full(nd, -1, np.int32)
        d_w = np.ones(nd, np.float32)
        d_op = np.zeros(nd, np.uint8)
        ins_pos = [i for i, r in enumerate(pending) if r["op"] == "insert"]
        if ins_pos:
            si = self.nodes.intern_many([pending[i]["src"] for i in ins_pos])
            di = self.nodes.intern_many([pending[i]["dst"] for i in ins_pos])
            for j, i in enumerate(ins_pos):
                d_src[i] = si[j]
                d_dst[i] = di[j]
                d_w[i] = pending[i].get("w", 1.0)
        for i, r in enumerate(pending):
            if r["op"] == "delete":
                d_op[i] = 1
                s = self.nodes.find(r["src"])
                d = self.nodes.find(r["dst"])
                if s is not None and d is not None:
                    d_src[i] = s
                    d_dst[i] = d
        old_e = len(self._src)
        self._src, self._dst, self._w, removed_pos = csr_apply_delta(
            self._src, self._dst, self._w, d_src, d_dst, d_w, d_op,
            return_removed=True,
        )
        self._note_removed(removed_pos)
        self._note_inserts(len(self._src) - (old_e - len(removed_pos)))

    # ── block layout bookkeeping (dirty tracking for save()) ──

    def _note_inserts(self, n: int) -> None:
        """Inserts append to (and dirty) the tail block; oversized tails
        split so steady-state blocks stay near BLOCK_EDGES."""
        if self._block_lens is None or n == 0:
            return
        if not self._block_lens:
            self._block_lens.append(0)
        self._block_lens[-1] += n
        self._dirty_blocks.add(len(self._block_lens) - 1)
        while self._block_lens[-1] > 2 * self.BLOCK_EDGES:
            tail = self._block_lens.pop()
            self._block_lens.append(self.BLOCK_EDGES)
            self._block_lens.append(tail - self.BLOCK_EDGES)
            self._dirty_blocks.add(len(self._block_lens) - 2)
            self._dirty_blocks.add(len(self._block_lens) - 1)

    def _note_removed(self, removed_pos: np.ndarray) -> None:
        """A removed edge shrinks only its owning block (relative order
        inside every other block is untouched, so concatenation of the
        blocks still equals the compacted COO)."""
        if self._block_lens is None or len(removed_pos) == 0:
            return
        bounds = np.cumsum(self._block_lens)
        bi = np.searchsorted(bounds, removed_pos, side="right")
        for b, c in zip(*np.unique(bi, return_counts=True)):
            self._block_lens[int(b)] -= int(c)
            self._dirty_blocks.add(int(b))

    # ── reads ──

    def graph(self) -> Graph:
        """The analytics view; lazily refreshed (the reference's
        ``graph_data_load_from_adjacency`` fast path, :1414-1573). Built
        by ``__new__`` over this cache's arrays, with every attribute
        ``Graph.__init__`` sets: host-built (no device COO), on the
        cache's device."""
        self._ensure_fresh()
        if self._graph is None:
            g = Graph.__new__(Graph)
            g.nodes = self.nodes
            g.device = self.device
            g._src = self._src.copy()
            g._dst = self._dst.copy()
            g._w = self._w.copy()
            g.has_weights = self.weighted
            g._fwd = g._rev = g._both = None
            g._host_csr = {}
            g._dev_coo = None
            g._e_dev = 0
            self._graph = g
        return self._graph

    def degrees(self) -> dict:
        """node -> (in_degree, out_degree, weighted_in, weighted_out) —
        the VT's query columns (``src/graph_adjacency.h:11-12``)."""
        self._ensure_fresh()
        n = self.num_nodes
        ind = np.zeros(n, np.int64)
        outd = np.zeros(n, np.int64)
        win = np.zeros(n, np.float64)
        wout = np.zeros(n, np.float64)
        np.add.at(outd, self._src, 1)
        np.add.at(ind, self._dst, 1)
        np.add.at(wout, self._src, self._w)
        np.add.at(win, self._dst, self._w)
        return {
            self.nodes.id_of(i): (int(ind[i]), int(outd[i]), float(win[i]), float(wout[i]))
            for i in range(n)
        }

    # ── persistence ──

    def save(self, path: str | os.PathLike) -> None:
        """Block-granular checkpoint (``src/graph_csr.c:341-478`` role):
        the edge COO persists as fixed-capacity blocks and only blocks
        dirtied since the previous save to the SAME directory are
        rewritten — save-after-small-delta is O(delta) on disk. Node ids
        are append-only, so only fresh ids append to ``nodes.jsonl``.
        """
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        self._ensure_fresh()
        # dirty tracking is only valid against the directory this
        # instance last saved to / loaded from
        fresh_layout = (
            self._block_lens is None or p.resolve() != self._saved_dir
        )
        if fresh_layout:
            # (re)chunk into BLOCK_EDGES-sized blocks and write them all
            e = len(self._src)
            nb = max(1, -(-e // self.BLOCK_EDGES))
            self._block_lens = [
                min(self.BLOCK_EDGES, e - i * self.BLOCK_EDGES)
                for i in range(nb)
            ]
            self._dirty_blocks = set(range(nb))
            self._saved_nodes = 0
            self._nodes_crc = 0
            (p / "nodes.jsonl").unlink(missing_ok=True)
        bounds = np.concatenate([[0], np.cumsum(self._block_lens)])
        for b in sorted(self._dirty_blocks):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            np.savez(
                p / f"block_{b:05d}.npz",
                src=self._src[lo:hi], dst=self._dst[lo:hi], w=self._w[lo:hi],
            )
        # drop stale higher-numbered block files from earlier layouts
        for f in p.glob("block_*.npz"):
            if int(f.stem.split("_")[1]) >= len(self._block_lens):
                f.unlink()
        (p / "arrays.npz").unlink(missing_ok=True)  # pre-block format
        if self._saved_nodes < len(self.nodes):
            blob = "".join(
                json.dumps(self.nodes.id_of(i)) + "\n"
                for i in range(self._saved_nodes, len(self.nodes))
            ).encode("utf-8")
            with open(p / "nodes.jsonl", "ab") as f:
                f.write(blob)
            # incremental crc keeps save O(delta); zip CRCs protect the
            # block files but nodes.jsonl needs its own integrity check
            self._nodes_crc = zlib.crc32(blob, self._nodes_crc)
            self._saved_nodes = len(self.nodes)
        _write_manifest(
            p, "graph_cache",
            {
                "generation": self.generation,
                "weighted": self.weighted,
                "block_lens": self._block_lens,
                "num_nodes": len(self.nodes),
                "nodes_crc32": self._nodes_crc,
            },
        )
        self._dirty_blocks = set()
        self._saved_dir = p.resolve()
        if self._log is not None:
            self._log.clear()

    @classmethod
    def load(cls, path: str | os.PathLike, log_path: str | None = None,
             device: str | torch.device = "cuda") -> "GraphCache":
        p = Path(path)
        m = _read_manifest(p, "graph_cache")
        gc = cls(weighted=m["weighted"], device=device)
        if (p / "arrays.npz").exists():  # pre-block format
            z = np.load(p / "arrays.npz")
            gc._src, gc._dst, gc._w = z["src"], z["dst"], z["w"]
        else:
            lens = m["block_lens"]
            parts = [np.load(p / f"block_{b:05d}.npz") for b in range(len(lens))]
            for b, (z, ln) in enumerate(zip(parts, lens)):
                if len(z["src"]) != ln:
                    raise ValueError(
                        f"block {b} length {len(z['src'])} != manifest {ln}"
                    )
            gc._src = np.concatenate([z["src"] for z in parts])
            gc._dst = np.concatenate([z["dst"] for z in parts])
            gc._w = np.concatenate([z["w"] for z in parts])
            gc._block_lens = list(lens)
        if (p / "nodes.jsonl").exists():
            raw = (p / "nodes.jsonl").read_bytes()
            want_crc = m.get("nodes_crc32")  # absent in older checkpoints
            if want_crc is not None and zlib.crc32(raw) != want_crc:
                raise ValueError(
                    "nodes.jsonl is corrupt (crc32 mismatch vs manifest)"
                )
            gc._nodes_crc = zlib.crc32(raw)
            for line in raw.decode("utf-8").splitlines():
                gc.nodes.find_or_add(json.loads(line))
        else:  # pre-block format
            for i in json.loads((p / "nodes.json").read_text()):
                gc.nodes.find_or_add(i)
        gc._saved_nodes = len(gc.nodes)
        gc._saved_dir = p.resolve()
        gc.generation = m["generation"]
        if log_path:
            gc._log = DeltaLog(log_path)
            for rec in gc._log.replay():
                gc._pending.append(rec)
            if gc._pending:
                gc.rebuild()
        return gc
