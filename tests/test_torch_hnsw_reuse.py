"""Slot reuse and the kept search tables of muninn_tpu_torch's HNSW index
under steady churn, on the CPU.

``VectorStore(reuse_slots=True)`` takes freed slots again, lowest first;
``HnswIndex`` does so by default, for its slots and its upper-level rows,
so that delete-then-insert churn keeps the capacity and the high
watermark. A write keeps the bf16 / int8 shadows and the packed neighbour
table: it patches the shadow rows it wrote and marks the rows whose
neighbours changed, which the next search re-gathers. The tests hold the
answers to float64 exact search over the live rows, the patched table to a
whole re-gather bit for bit, and the write path's spans and host reads.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest
import torch

from muninn_tpu_torch import HnswIndex, tracing
from muninn_tpu_torch.index.convert import hnsw_index_from_numpy, hnsw_index_to_numpy
from muninn_tpu_torch.index.store import VectorStore

D = 16


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_store_reuses_freed_slots_lowest_first():
    """50 rounds of remove-n / add-n: each add takes the freed slots,
    lowest first, and appends only the rest; capacity, ``slot``, ``ids_of``
    and the live count stay right. Without reuse the store appends."""
    rng = np.random.default_rng(0)
    st = VectorStore(4, 256, 64, device="cpu", reuse_slots=True)
    plain = VectorStore(4, 256, 64, device="cpu")
    ids = np.arange(200, dtype=np.int64) * 3 + 1
    st.add(ids, np.zeros((200, 4), np.float32))
    live = {int(i): s for s, i in enumerate(ids)}
    next_id = 10_000
    for r in range(50):
        n = int(rng.integers(1, 40))
        gone = rng.choice(sorted(live), n, replace=False)
        freed = np.sort(st.remove(gone))
        np.testing.assert_array_equal(freed, np.sort([live.pop(int(g)) for g in gone]))
        new = np.arange(next_id, next_id + n + (r % 3), dtype=np.int64)
        next_id += len(new)
        vecs = rng.standard_normal((len(new), 4)).astype(np.float32)
        want_hw = st.high_watermark + (r % 3)
        slots = st.add(new, vecs)
        np.testing.assert_array_equal(slots[:n], freed)
        np.testing.assert_array_equal(slots[n:], np.arange(want_hw - r % 3, want_hw))
        assert st.high_watermark == want_hw and st.capacity == 256
        live.update(zip(new.tolist(), slots.tolist()))
        assert len(st) == len(live)
        for i, s in live.items():
            assert st.slot(i) == s
        all_ids = np.array(sorted(live))
        np.testing.assert_array_equal(st.ids_of(st.slots_of(all_ids)), all_ids)
        np.testing.assert_array_equal(st.vectors[slots].numpy(), vecs)
        assert st.valid[slots].all() and int(st.valid.sum()) == len(live)
    plain.add(np.arange(10), np.zeros((10, 4), np.float32))
    plain.remove(np.array([2, 3]))
    np.testing.assert_array_equal(plain.add(np.array([20, 21]), np.zeros((2, 4))),
                                  [10, 11])


def _no_stale_edges(idx) -> bool:
    valid = idx.store.valid.numpy()
    rows = idx.neighbors0.numpy()[valid]
    return not ((rows >= 0) & ~valid[np.maximum(rows, 0)]).any()


def _exact(q, live: dict, k: int):
    keys = np.array(sorted(live))
    mat = np.stack([live[i] for i in keys.tolist()]).astype(np.float64)
    d = ((q.astype(np.float64)[:, None, :] - mat[None]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return keys[order], np.take_along_axis(d, order, 1), keys, mat


def test_steady_churn_keeps_slots_bounded_and_answers_exact():
    """20 rounds of delete, upsert (the same ids under new rows) and insert
    at a steady live count: capacity and high watermark stay where the
    build left them, and after every round no deleted id comes back, every
    distance is the float64 distance of its row (1e-5 relative), no live
    edge points at a dead slot, and recall@10 against the float64 exact
    top-10 over that round's live rows is at least 0.9 (0.97-0.99 read
    here at ef 48)."""
    rng = np.random.default_rng(1)
    idx = HnswIndex(D, "l2", m=6, ef_construction=40, wave_size=64,
                    capacity=2048, seed=5, device="cpu")
    x = _rows(rng, 1200)
    idx.insert(np.arange(1200), x)
    idx.exact_small_n = 0
    live = dict(zip(range(1200), x))
    cap, hw, hi = idx.store.capacity, idx.store.high_watermark, idx._hi_count
    next_id = 1200
    for _ in range(20):
        alive = np.array(sorted(live))
        pick = rng.choice(alive, 96, replace=False)
        ups, gone = pick[:48], pick[48:]
        idx.delete(pick)
        new = np.arange(next_id, next_id + 48)
        next_id += 48
        put = np.concatenate([ups, new])
        vecs = _rows(rng, len(put))
        idx.insert(put, vecs)
        for i in pick.tolist():
            del live[i]
        live.update(zip(put.tolist(), vecs))
        assert (idx.store.capacity, idx.store.high_watermark) == (cap, hw)
        assert len(idx) == len(live) and idx._hi_count <= hi + 64
        assert _no_stale_edges(idx)
        q = _rows(rng, 40)
        got, gd = idx.search(q, k=10, ef_search=48)
        truth, _, keys, mat = _exact(q, live, 10)
        assert not np.isin(got, gone).any() and (got >= 0).all()
        rows = np.searchsorted(keys, got)
        d64 = ((q.astype(np.float64)[:, None, :] - mat[rows]) ** 2).sum(-1)
        np.testing.assert_allclose(gd, d64, rtol=1e-5, atol=1e-6)
        hits = sum(len(set(a) & set(b)) for a, b in zip(got.tolist(), truth.tolist()))
        assert hits / truth.size >= 0.9


def _whole(idx):
    """The packed table and scales as one whole gather would build them."""
    nb = idx.neighbors0.clamp(min=0).long()
    if idx.tables.quant == "int8":
        vi, sc = idx.tables.vecs8()
        return vi[nb], sc[nb]
    return idx.tables.vecs16()[nb], None


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [2, 3])
def test_patched_packed_table_equals_a_whole_gather(quant, seed):
    """Waves, deletes and upserts in any order (slot 0 freed and taken
    again among them), with packing forced on the CPU: after each write the
    next search re-gathers only the marked rows, and the table and its
    scales equal a whole gather of the shadow bit for bit, the shadows a
    whole conversion of the store; the answers equal those after
    ``pack_neighbors()``. A write that grows the capacity drops the tables,
    which are then built whole."""
    rng = np.random.default_rng(seed)
    idx = HnswIndex(D, "cosine", m=4, ef_construction=32, wave_size=64,
                    capacity=1024, seed=seed, device="cpu")
    x = _rows(rng, 700)
    idx.insert(np.arange(700), x)
    idx.exact_small_n = 0
    idx.search_quant = quant
    idx.pack_neighbors()
    live = set(range(700))
    next_id = 700
    q = _rows(rng, 30)
    steps = ["delete0", "wave", "delete", "upsert", "wave", "delete", "upsert",
             "grow", "upsert"]
    for step in steps:
        if step == "delete0":
            gone = idx.store.ids_of(np.array([0]))
            idx.delete(gone)
            live -= set(gone.tolist())
        elif step in ("wave", "grow"):
            n = 120 if step == "wave" else idx.store.capacity - len(idx) + 10
            new = np.arange(next_id, next_id + n)
            next_id += n
            idx.insert(new, _rows(rng, n))
            live |= set(new.tolist())
        else:
            pick = rng.choice(sorted(live), 90, replace=False)
            idx.delete(pick)
            if step == "upsert":
                idx.insert(pick, _rows(rng, len(pick)))
            else:
                live -= set(pick.tolist())
        if step == "grow":
            assert idx.store.capacity > 1024 and idx.tables.packed is None
            idx.pack_neighbors()
        elif step == "delete0":
            assert idx.tables.dirty_rows is not None
        got = idx.search(q, k=8, ef_search=32)
        assert idx.tables.dirty_rows is None
        packed, scales = _whole(idx)
        assert torch.equal(idx.tables.packed, packed)
        if quant == "int8":
            assert torch.equal(idx.tables.scales, scales)
            vi, sc = idx.tables.vecs8()
            from muninn_tpu_torch.ops.distance import quantize_rows_int8
            wi, ws = quantize_rows_int8(idx.store.vectors)
            assert torch.equal(vi, wi) and torch.equal(sc, ws)
        else:
            assert torch.equal(idx.tables.vecs16(), idx.store.vectors.bfloat16())
        idx.pack_neighbors()
        again = idx.search(q, k=8, ef_search=32)
        np.testing.assert_array_equal(got[0], again[0])
        np.testing.assert_array_equal(got[1], again[1])
    assert idx.store.slot(next_id - 1) is not None and 0 in idx.store._slot_of.values()


def _profiled(fn):
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.spans(), prof


@pytest.fixture()
def churned():
    rng = np.random.default_rng(4)
    idx = HnswIndex(D, "l2", m=6, ef_construction=32, wave_size=64,
                    capacity=2048, seed=4, device="cpu")
    idx.insert(np.arange(1000), _rows(rng, 1000))
    idx.exact_small_n = 0
    idx.pack_neighbors()
    return idx, rng


def test_search_after_no_write_adds_no_op_or_read(churned):
    """With no write since the table was built or patched, the packed table
    is handed back without an operation or a host read, and the search's
    reads are its steps and downloads alone; the first search after a write
    re-gathers once, the next one not again."""
    idx, rng = churned
    q = _rows(rng, 20)
    for _ in range(2):
        tracing.reset_host_syncs()
        packed, spans, prof = _profiled(idx.tables.pack)
        assert packed is idx.tables.packed and not prof.events() and not spans
        assert not any(tracing.HOST_SYNCS.values())
        _, spans, _ = _profiled(lambda: idx.search(q, 10, ef_search=32))
        (root,) = [s for s in spans if s.name == "index.search"]
        (beam,) = [s for s in spans if s.name == "hnsw.beam"]
        assert root.attrs["host_syncs"] == beam.attrs["steps"] + 2
        assert not [s for s in spans if s.name == "hnsw.repack"]
    idx.delete(np.arange(10))
    n_dirty = int(idx.tables.dirty_rows.shape[0])
    _, spans, _ = _profiled(lambda: idx.search(q, 10, ef_search=32))
    (repack,) = [s for s in spans if s.name == "hnsw.repack"]
    assert repack.attrs == {"rows": n_dirty, "whole": 0} and n_dirty >= 10
    _, spans, _ = _profiled(lambda: idx.search(q, 10, ef_search=32))
    assert not [s for s in spans if s.name == "hnsw.repack"]


def test_write_spans_and_host_reads(churned):
    """Under a profiler: ``index.insert`` and ``index.delete`` are requests
    of their own with the store's state when they end; a wave holds
    ``store.register`` (its reused slots) and ``hnsw.prune``; a delete
    holds ``hnsw.repair`` (on the CPU the eager engine, which reads the
    wave's two counts once) and reads through its own ``HOST_SYNCS`` sites,
    which its ``host_syncs`` counts."""
    idx, rng = churned
    tracing.reset_host_syncs()
    _, spans, _ = _profiled(lambda: idx.delete(np.arange(50)))
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "index.delete" and root.attrs["rows"] == 50
    assert {s.request for s in spans} == {root.request}
    assert [s.name for s in spans if s.parent == root.id] == ["hnsw.repair"]
    assert root.attrs["live"] == 950 and root.attrs["high_watermark"] == 1000
    assert root.attrs["capacity"] == idx.store.capacity
    (repair,) = [s for s in spans if s.name == "hnsw.repair"]
    assert repair.attrs["engine"] == "eager"  # the CPU's repair
    assert tracing.HOST_SYNCS["hnsw_delete_counts"] == 1
    assert root.attrs["host_syncs"] == sum(tracing.HOST_SYNCS.values())

    ep = idx.store.ids_of(np.array([idx.entry_point]))
    tracing.reset_host_syncs()
    idx.delete(ep)
    assert tracing.HOST_SYNCS["hnsw_entry_rescan"] == 1

    _, spans, _ = _profiled(lambda: idx.insert(np.arange(2000, 2080),
                                               _rows(rng, 80)))
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "index.insert" and root.attrs["rows"] == 80
    waves = [s for s in spans if s.name == "hnsw.wave"]
    assert [w.attrs["rows"] for w in waves] == [64, 16]
    regs = [s for s in spans if s.name == "store.register"]
    assert [r.parent for r in regs] == [w.id for w in waves]
    assert [r.attrs["reused"] for r in regs] == [51, 0]
    assert regs[1].attrs["grew"] == 0 and regs[1].attrs["live"] == 1029
    assert regs[1].attrs["high_watermark"] == 1029
    assert root.attrs["high_watermark"] == 1029 and root.attrs["live"] == 1029
    prunes = [s for s in spans if s.name == "hnsw.prune"]
    assert [p.parent for p in prunes] == [w.id for w in waves]
    assert all(p.attrs["rows"] > 0 for p in prunes)


class _ListQueue:
    """Queued promotions as a list of waves: each insert wave's promoted
    slots and levels appended, each delete's slots filtered out of every
    queued wave."""

    def __init__(self):
        self.waves = []

    def inserted(self, idx, ids):
        sl = idx.store.slots_of(ids).astype(np.int32)
        lv = idx.levels[sl]
        self.waves.append((sl[lv >= 1], lv[lv >= 1]))

    def deleted(self, slots):
        self.waves = [(sl[~np.isin(sl, slots)], lv[~np.isin(sl, slots)])
                      for sl, lv in self.waves]

    def get(self):
        none = [np.zeros(0, np.int32)]
        return (np.concatenate([sl for sl, _ in self.waves] or none),
                np.concatenate([lv for _, lv in self.waves] or none))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_long_churn_queues_promotions_as_a_list_would(metric):
    """48 rounds of one delete wave and one insert wave at a steady live
    count, 8 of each delete's 48 ids rows whose promotion is still queued,
    upserted, so that the round's wave takes their slots back: after every
    write the queued promotions equal ``_ListQueue``'s, in order (a slot
    deleted and promoted again goes to the end), and never outnumber the
    live promoted rows. Every 16 rounds the index and a twin fed the same writes, whose
    flush reads the list, wire their upper levels: ``hi_index`` and
    ``hi_neighbors`` are equal. The last writes' spans carry the queue's
    length as ``queued``."""
    rng = np.random.default_rng(12)
    kw = dict(m=4, ef_construction=32, wave_size=64, capacity=1024, seed=9,
              device="cpu")
    idx, twin = HnswIndex(D, metric, **kw), HnswIndex(D, metric, **kw)
    model = _ListQueue()
    twin._queued_promotions = model.get
    x = _rows(rng, 400)
    for t in (idx, twin):
        t.insert(np.arange(400), x)  # bulk: nothing queued
    live, next_id, requeued = set(range(400)), 400, 0

    def check():
        got, want = idx._queued_promotions(), model.get()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) <= np.count_nonzero(idx.levels >= 1)
        return got[0]

    for r in range(48):
        queued = idx.store.ids_of(check())
        hot = rng.choice(queued, min(len(queued), 8), replace=False)
        rest = np.setdiff1d(np.array(sorted(live)), hot)
        pick = np.concatenate([hot, rng.choice(rest, 48 - len(hot), replace=False)])
        ups, new = pick[:24], np.arange(next_id, next_id + 24)
        next_id += 24
        put, vecs = np.concatenate([ups, new]), _rows(rng, 48)
        dead = idx.store.slots_of(pick)
        was_queued = dead[idx._hi_queued[dead] >= 0]
        last, roots = r == 47, {}

        def write(name, fn):
            # the last round's writes under a profiler, the index's spans kept
            if last:
                _, spans, _ = _profiled(lambda: fn(idx))
                (roots[name],) = [s for s in spans if s.name == name]
            else:
                fn(idx)
            fn(twin)

        write("index.delete", lambda t: t.delete(pick))
        model.deleted(dead)
        queued = check()
        if last:
            assert roots["index.delete"].attrs["queued"] == len(queued) > 0
        write("index.insert", lambda t: t.insert(put, vecs))
        model.inserted(idx, put)
        live.difference_update(pick.tolist())
        live.update(put.tolist())
        queued = check()
        requeued += np.isin(model.waves[-1][0], was_queued).sum()
        assert idx.store.high_watermark == 400 and len(idx) == 400
        if last:
            assert roots["index.insert"].attrs["queued"] == len(queued) > 0
        if r % 16 == 15:
            for t in (idx, twin):
                t._flush_hi_wiring()
            model.waves = []
            assert not len(check())
            assert torch.equal(idx.hi_index, twin.hi_index)
            assert torch.equal(idx.hi_neighbors, twin.hi_neighbors)
    assert requeued > 0  # slots taken back while queued were queued again


@pytest.mark.parametrize("reuse", [True, False])
def test_checkpoint_state_rebuilds_the_free_lists(reuse):
    """A state carried through ``hnsw_index_to_numpy`` after deletes: with
    reuse the loaded index takes the freed slots and upper-level rows first,
    lowest first; without, it appends as the JAX package does."""
    rng = np.random.default_rng(6)
    idx = HnswIndex(D, "l2", m=4, wave_size=64, capacity=1024, seed=6,
                    device="cpu")
    idx.insert(np.arange(600), _rows(rng, 600))
    idx.delete(np.arange(0, 600, 7))
    state = hnsw_index_to_numpy(idx)
    t = hnsw_index_from_numpy(state, device="cpu", reuse_slots=reuse)
    freed = np.flatnonzero(state["ids"][:600] < 0)
    hi_used = state["hi_index"][state["hi_index"] >= 0]
    hi_freed = np.setdiff1d(np.arange(state["hi_count"]), hi_used)
    assert len(hi_freed) > 0
    if reuse:
        np.testing.assert_array_equal(t.store._free, freed)
        np.testing.assert_array_equal(t._hi_free, hi_freed)
    else:
        assert len(t.store._free) == 0 and len(t._hi_free) == 0
    t.insert(np.arange(1000, 1030), _rows(rng, 30))
    slots = t.store.slots_of(np.arange(1000, 1030))
    want = freed[:30] if reuse else np.arange(600, 630)
    np.testing.assert_array_equal(np.sort(slots), want)


def test_bulk_build_into_an_emptied_index_takes_its_slots_again():
    """An index emptied by deletes and bulk-built again takes slots 0.. on:
    the high watermark stays, and no live edge points at a dead slot."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    idx = HnswIndex(8, "l2", m=4, wave_size=32, device="cpu")
    idx.insert(np.arange(300), x)
    hi = idx._hi_count
    idx.delete(np.arange(300))
    assert len(idx) == 0 and idx.entry_point == -1
    idx.insert(np.arange(300), x + 0.01)
    assert len(idx) == 300 and idx.store.high_watermark == 300
    assert idx._hi_count <= hi + 32
    valid = idx.store.valid.numpy()
    rows = idx.neighbors0.numpy()[valid]
    assert valid[:300].all() and not ((rows >= 0) & ~valid[np.maximum(rows, 0)]).any()


@pytest.mark.parametrize("reuse", [True, False])
def test_delete_with_nothing_to_refill_from(reuse):
    """A tight cluster whose rows point only at each other, and one row
    beside it that points into it: deleting the whole cluster leaves no
    repair pool. With reuse the row drops its edges to the freed slots,
    which the next wave takes; without (the JAX package's way) it keeps
    them, and the slots stay dead."""
    rng = np.random.default_rng(8)
    near = rng.standard_normal((150, 8)).astype(np.float32)
    far = np.zeros((9, 8), np.float32)
    far[:, 0] = 50.0
    far += 0.01 * rng.standard_normal((9, 8)).astype(np.float32)
    side = np.zeros((1, 8), np.float32)
    side[0, 0] = 30.0
    idx = HnswIndex(8, "l2", m=4, wave_size=32, device="cpu", reuse_slots=reuse)
    idx.insert(np.arange(160), np.concatenate([near, far, side]))
    cluster = idx.store.slots_of(np.arange(150, 159))
    nb = idx.neighbors0.numpy()
    assert np.isin(nb[cluster], cluster).all()  # no edge out of the cluster
    assert np.isin(nb[idx.store.slot(159)], cluster).any()
    idx.delete(np.arange(150, 159))
    row = idx.neighbors0.numpy()[idx.store.slot(159)]
    assert np.isin(row, cluster).any() != reuse
    assert _no_stale_edges(idx) == reuse
    idx.insert(np.arange(200, 209), _rows(rng, 9)[:, :8] + 10.0)
    taken = np.sort(idx.store.slots_of(np.arange(200, 209)))
    assert np.array_equal(taken, np.sort(cluster)) == reuse
