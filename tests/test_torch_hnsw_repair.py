"""The repair of an HNSW delete wave: its lists made on the device, the
gate of its engine, and the ``delete_repair`` kernel.

On the CPU: ``_delete_lists`` against the numpy sets the delete formerly
read back to the host (``np.nonzero``, ``np.isin``, ``np.unique``), in the
same order; a delete against the former host path, table for table (an
empty pool, the entry point deleted, rows whose every edge dies, slot reuse
on and off); ``repair_engine``'s pick and the kernel wrapper's refusals.

On the card (marked ``card``; they skip without one): the kernel's graph
against the eager repair's, bit for bit, on seeded l2 and cosine tables,
waves of 1, 64 and 2,048 deletes; the wave's lists and the launch make no
call that waits on the card. The file imports no JAX, so on the
machine with the card it runs without the suite's conftest:
``python -m pytest tests/test_torch_hnsw_repair.py --noconftest -q -p no:cacheprovider``.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from muninn_tpu_torch import HnswIndex, tracing
from muninn_tpu_torch.index import hnsw as hnsw_mod
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops import delete_repair as dr


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100 machine")
    return torch.device("cuda")


def _rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ── the lists ──


def _numpy_lists(nb, slots):
    """The former host path's sets: the rows pointing at a deleted slot and
    the deleted rows' neighbours, both without the deleted slots."""
    dead = np.zeros(nb.shape[0], bool)
    dead[slots] = True
    refs = ((nb >= 0) & dead[np.maximum(nb, 0)]).any(axis=1)
    aff = np.nonzero(refs)[0]
    aff = aff[~np.isin(aff, slots)]
    pool = np.unique(nb[slots])
    pool = pool[(pool >= 0) & ~np.isin(pool, slots)]
    return aff, pool


def _table(seed, cap=300, m0=8, live=250):
    """A seeded neighbour table: live rows with -1 tails, the rest empty."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, live, size=(cap, m0)).astype(np.int32)
    nb[rng.random((cap, m0)) < 0.2] = -1
    nb[live:] = -1
    return nb


def _lists_case(name):
    nb = _table(7)
    rng = np.random.default_rng(8)
    if name == "random":
        slots = rng.choice(250, 30, replace=False)
    elif name == "one":
        slots = np.array([17])
    elif name == "empty_pool":  # the deleted rows point nowhere
        slots = np.array([3, 40, 41])
        nb[slots] = -1
    elif name == "every_edge_dies":  # row 5 points only at deleted slots
        nb[5] = [9, 10, 11, -1, 12, -1, 9, 13]
        slots = np.array([9, 10, 11, 12, 13, 200])
    else:  # "all": every live row deleted, so no row is left to repair
        slots = np.arange(250)
    return nb, np.sort(slots)


@pytest.mark.parametrize("name", ["random", "one", "empty_pool",
                                  "every_edge_dies", "all"])
def test_delete_lists_equal_the_numpy_sets(name):
    nb, slots = _lists_case(name)
    cap, m0 = nb.shape
    nb_t = torch.as_tensor(nb)
    slots_t = torch.as_tensor(slots, dtype=torch.long)
    dead = torch.zeros(cap, dtype=torch.bool)
    dead[slots_t] = True
    refs, aff, pool, counts = hnsw_mod._delete_lists(nb_t, slots_t, dead, m0)
    want_aff, want_pool = _numpy_lists(nb, slots)
    n_aff, n_pool = counts.tolist()
    assert (n_aff, n_pool) == (len(want_aff), len(want_pool))
    assert aff.dtype == pool.dtype == torch.int64
    assert aff.shape == (cap,) and pool.shape == (min(cap, len(slots) * m0),)
    np.testing.assert_array_equal(aff[:n_aff].numpy(), want_aff)
    np.testing.assert_array_equal(pool[:n_pool].numpy(), want_pool)
    assert (aff[n_aff:] == -1).all() and (pool[n_pool:] == -1).all()
    np.testing.assert_array_equal(np.nonzero(refs.numpy())[0], want_aff)
    if name == "empty_pool":
        assert n_pool == 0 < n_aff
    if name == "every_edge_dies":
        assert 5 in want_aff
    if name == "all":
        assert n_aff == n_pool == 0


# ── the delete against the former host path ──


def _former_delete_wave(self, ids):
    """The delete wave as it read its lists back to the host before they
    stayed on the device: the reference of the CPU path."""
    slots = self.store.unregister(ids)
    self.levels[slots] = -1
    hi_rows = self._hi_index_np[slots]
    hi_rows = hi_rows[hi_rows >= 0]
    self._hi_index_np[slots] = -1
    self._hi_queued[slots] = -1
    self.tables.promotions_changed()
    dev = self.device
    slots_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
    self.store.valid[slots_t] = False
    dmask = torch.zeros(self.neighbors0.shape[0], dtype=torch.bool, device=dev)
    dmask[slots_t] = True
    nb = self.neighbors0
    refs_dead = ((nb >= 0) & dmask[nb.clamp(min=0).long()]).any(dim=1)
    aff = np.nonzero(refs_dead.cpu().numpy())[0]
    aff = aff[~np.isin(aff, slots)]
    pool = np.unique(nb[slots_t].cpu().numpy())
    pool = pool[(pool >= 0) & ~np.isin(pool, slots)]
    aff_t = torch.as_tensor(aff, dtype=torch.long, device=dev)
    if len(aff) and len(pool):
        kk = min(self.m0 + 1, len(hnsw_mod.pow2_pad(pool)))
        pool_t = torch.as_tensor(pool, dtype=torch.long, device=dev)
        pv = self.store.vectors[pool_t]
        for s in range(0, len(aff), hnsw_mod._REPAIR_ROWS):
            self._repair_rows(aff_t[s : s + hnsw_mod._REPAIR_ROWS], pool_t, pv,
                              dmask, kk)
    elif len(aff) and self.store.reuse_slots:
        self._drop_dead_edges(aff_t, dmask)
    self.neighbors0[slots_t] = -1
    self.dists0[slots_t] = float("inf")
    hn = self.hi_neighbors
    self.hi_neighbors = torch.where(
        (hn >= 0) & dmask[hn.clamp(min=0).long()], -1, hn)
    self.hi_index[slots_t] = -1
    if self.store.reuse_slots and len(hi_rows):
        held = hi_rows[hi_rows < self.hi_neighbors.shape[0]]
        self.hi_neighbors[torch.as_tensor(held, dtype=torch.long, device=dev)] = -1
        self._hi_free = np.union1d(self._hi_free, hi_rows).astype(np.int32)
    self.tables.neighbours_changed(aff_t)
    self.tables.neighbours_changed(slots_t)
    if self.entry_point in set(slots.tolist()):
        self._rescan_entry_point()


def _assert_same_state(a, b):
    for name in ("neighbors0", "dists0", "hi_neighbors", "hi_index"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.store.valid, b.store.valid)
    assert (a.entry_point, a.max_level) == (b.entry_point, b.max_level)
    np.testing.assert_array_equal(a.levels, b.levels)
    np.testing.assert_array_equal(a._hi_free, b._hi_free)
    np.testing.assert_array_equal(a._hi_queued, b._hi_queued)
    if a.tables.dirty is not None or b.tables.dirty is not None:
        assert torch.equal(a.tables.dirty, b.tables.dirty)


def _index(metric, reuse, device="cpu", n=700, d=16, m=4, wave=64, seed=5):
    idx = HnswIndex(d, metric, m=m, ef_construction=40, wave_size=wave,
                    capacity=max(1024, 2 * n), seed=seed, device=device,
                    reuse_slots=reuse)
    x = _rows(n, d, seed)
    idx.insert(np.arange(n // 2), x[: n // 2])  # bulk
    idx.insert(np.arange(n // 2, n), x[n // 2 :])  # waves
    return idx


def _deletes(idx, case):
    """Ids of a seeded delete: several waves with the entry point; a row
    whose every edge dies; the deleted rows emptied first, so the pool is
    empty."""
    rng = np.random.default_rng(11)
    ids = idx.store.ids_of(np.arange(idx.store.high_watermark))
    if case == "entry_point":
        ep = idx.store.ids_of(np.array([idx.entry_point]))
        return np.unique(np.concatenate([ep, rng.choice(ids, 150, replace=False)]))
    if case == "every_edge_dies":
        row = idx.neighbors0[3].numpy()
        return idx.store.ids_of(row[row >= 0])
    return rng.choice(ids, 20, replace=False)  # "empty_pool"


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("case", ["entry_point", "every_edge_dies", "empty_pool"])
def test_delete_equals_the_former_host_path(metric, reuse, case, monkeypatch):
    idx = _index(metric, reuse)
    idx.pack_neighbors()  # a kept table, so the dirty marks are compared too
    ids = _deletes(idx, case)
    if case == "empty_pool":  # the deleted rows point nowhere; others at them
        slots = idx.store.slots_of(ids)
        idx.neighbors0[torch.as_tensor(slots)] = -1
        idx.dists0[torch.as_tensor(slots)] = float("inf")
    twin = copy.deepcopy(idx)
    tracing.reset_host_syncs()
    idx.delete(ids)
    assert tracing.HOST_SYNCS["hnsw_delete_counts"] == -(-len(ids) // idx.wave_size)
    monkeypatch.setattr(HnswIndex, "_delete_wave", _former_delete_wave)
    twin.delete(ids)
    _assert_same_state(idx, twin)
    if case == "every_edge_dies":
        row = idx.neighbors0[3]
        assert (row >= 0).any() and idx.store.valid[row[row >= 0].long()].all()


def test_delete_matches_on_a_multi_wave_bulk_table(monkeypatch):
    """Several waves of a few hundred deletes over a bulk-built table, l2,
    slot reuse on, then a wave that takes freed slots and a second
    delete."""
    idx = _index("l2", True, n=1600, d=24, m=8, wave=256)
    twin = copy.deepcopy(idx)
    rng = np.random.default_rng(2)
    ids = rng.choice(1600, 700, replace=False)
    more = _rows(100, 24, 9)
    for t, path in ((idx, None), (twin, _former_delete_wave)):
        if path is not None:
            monkeypatch.setattr(HnswIndex, "_delete_wave", path)
        t.delete(ids[:600])
        t.insert(np.arange(5000, 5100), more)
        t.delete(ids[600:])
    _assert_same_state(idx, twin)


# ── the gate and the wrapper's refusals ──


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device, dtype, kk, want", [
    (CUDA, torch.float32, 33, "kernel"),          # the churn cell: M 16
    (CUDA, torch.float32, dr.MAX_KK, "kernel"),   # at the limit
    (CUDA, torch.float32, dr.MAX_KK + 1, "eager"),
    (CUDA, torch.bfloat16, 33, "eager"),
    (CUDA, torch.int8, 33, "eager"),
    (CPU, torch.float32, 33, "eager"),
])
def test_repair_engine_picks_by_inputs(device, dtype, kk, want):
    store = SimpleNamespace(device=device, dtype=dtype)
    assert dr.repair_engine(store, kk) == want


def _wrapper_args(device="cpu", dtype=torch.float32, kk=9, cap=64, m=8):
    vec = torch.zeros((cap, 16), dtype=dtype, device=device)
    aff = torch.full((cap,), -1, dtype=torch.int64, device=device)
    pool = torch.full((8,), -1, dtype=torch.int64, device=device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    dead = torch.zeros(cap, dtype=torch.bool, device=device)
    nb = torch.full((cap, m), -1, dtype=torch.int32, device=device)
    nd = torch.full((cap, m), float("inf"), device=device)
    return (vec, aff, pool, counts, dead, nb, nd, kk, "l2", False)


@pytest.mark.parametrize("change, match", [
    ({}, "CUDA tensors"),
    ({"dtype": torch.bfloat16}, "float32 store"),
    ({"kk": dr.MAX_KK + 1}, "kk <="),
    ({"kk": 0}, "kk <="),
    ({"kk": dr.MAX_KK, "m": dr.MAX_MERGE - dr.MAX_KK + 1}, "edges and candidates"),
])
def test_wrapper_refuses(change, match):
    with pytest.raises(ValueError, match=match):
        dr.delete_repair_cuda(*_wrapper_args(**change))


# ── on the card ──


@pytest.mark.card
@pytest.mark.parametrize("change, match", [
    ({"dtype": torch.bfloat16}, "float32 store"),
    ({"kk": dr.MAX_KK + 1}, "kk <="),
])
def test_wrapper_refuses_on_the_card(card, change, match):
    n0 = _build.LAUNCHES["delete_repair"]
    with pytest.raises(ValueError, match=match):
        dr.delete_repair_cuda(*_wrapper_args(device=card, **change))
    assert _build.LAUNCHES["delete_repair"] == n0


# (deletes, d, metric, reuse): one delete at d = 30, where torch reduces a
# row norm alike at any row count, since a one-id wave may repair fewer
# than 16 rows in the eager path (whose norms of fewer rows than 16 of
# more than 32 features may round otherwise); its pool (the deleted row's
# neighbours) is smaller than kk
CARD_CASES = [(1, 30, "l2", True), (1, 30, "cosine", True),
              (64, 384, "l2", True), (64, 384, "cosine", False),
              (2048, 384, "l2", True), (2048, 384, "cosine", True)]


@pytest.mark.card
@pytest.mark.parametrize("n_del, d, metric, reuse", CARD_CASES)
def test_kernel_repair_equals_eager_bit_for_bit(card, n_del, d, metric, reuse,
                                               monkeypatch):
    n = 12_000
    idx = HnswIndex(d, metric, m=16, ef_construction=64, wave_size=2048,
                    capacity=16_384, seed=4, device=card, reuse_slots=reuse)
    x = _rows(n, d, 4)
    idx.insert(np.arange(n - 2048), x[: n - 2048])  # bulk
    idx.insert(np.arange(n - 2048, n), x[n - 2048 :])  # one wave
    ids = np.random.default_rng(n_del).choice(n, n_del, replace=False)
    twin = copy.deepcopy(idx)
    slots_t = torch.as_tensor(idx.store.slots_of(ids), device=card)
    dead = torch.zeros(idx.neighbors0.shape[0], dtype=torch.bool, device=card)
    dead[slots_t] = True
    _, _, _, counts = hnsw_mod._delete_lists(idx.neighbors0, slots_t, dead, idx.m0)
    n_aff, n_pool = counts.tolist()
    if n_del == 1:
        assert n_pool < idx.m0 + 1  # a pool smaller than kk
    _build.reset_launches()
    tracing.reset_host_syncs()
    idx.delete(ids)
    assert _build.LAUNCHES["delete_repair"] == 1
    assert _build.LAUNCHES["flat_topk"] == 0
    assert tracing.HOST_SYNCS["hnsw_delete_counts"] == 0
    monkeypatch.setattr(hnsw_mod, "repair_engine", lambda *a: "eager")
    twin.delete(ids)
    torch.cuda.synchronize()
    assert tracing.HOST_SYNCS["hnsw_delete_counts"] == 1
    _assert_same_state(idx, twin)
    assert n_aff > 0


@pytest.mark.card
def test_lists_and_launch_do_not_synchronise(card):
    """The wave's lists and the kernel's launch make no call that waits on
    the card (torch's sync debug mode raises on one)."""
    idx = HnswIndex(64, "l2", m=16, capacity=8192, seed=6, device=card)
    idx.insert(np.arange(6000), _rows(6000, 64, 6))
    slots = torch.as_tensor(idx.store.slots_of(np.arange(0, 6000, 7)),
                            dtype=torch.long, device=card)
    dead = torch.zeros(idx.neighbors0.shape[0], dtype=torch.bool, device=card)
    dead.index_fill_(0, slots, True)
    dr._library()  # the build and load, before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, aff, pool, counts = hnsw_mod._delete_lists(idx.neighbors0, slots, dead,
                                                      idx.m0)
        dr.delete_repair_cuda(idx.store.vectors[: idx.store.high_watermark], aff,
                              pool, counts, dead, idx.neighbors0, idx.dists0,
                              idx.m0 + 1, "l2", keep_if_empty=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

