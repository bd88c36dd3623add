"""The search tables and the route decision of muninn_tpu_torch's HNSW index,
on the CPU.

``index.hnsw_tables.SearchTables`` owns what a search derives from the store
and the graph (the bf16 / int8 shadows, the packed neighbour table and its
marks, the ``search_degree`` slices, the routing pool and its rows); the
write paths only tell it what happened. After each kind of write the kept
tables equal tables built whole from the index as it stands.
``HnswIndex._choose_route`` alone picks the engine of a search; for each
combination of knobs that names one of today's engines it names it, and the
search gives, bit for bit, what that engine's query path gives when it is
composed from the module's own steps. The file imports no JAX.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest
import torch

from muninn_tpu_torch import HnswIndex
from muninn_tpu_torch.index import hnsw as hnsw_mod
from muninn_tpu_torch.index.hnsw_tables import SearchTables
from muninn_tpu_torch.ops.beam_loop import beam_loop
from muninn_tpu_torch.ops.distance import gathered_distances, quantize_rows_int8
from muninn_tpu_torch.ops.topk import sorted_topk_unique

D = 16


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index(seed=6, n=1200, metric="l2"):
    rng = np.random.default_rng(seed)
    idx = HnswIndex(D, metric, m=4, ef_construction=32, wave_size=64,
                    capacity=2048, seed=seed, device="cpu")
    idx.insert(np.arange(n), _rows(rng, n))
    idx.exact_small_n = 0
    return idx, rng


# ── the tables after each kind of write ──

def _write(idx, rng, case):
    n = len(idx)
    if case == "bulk":  # emptied, then built in bulk again
        idx.delete(idx.store.ids_of(np.nonzero(idx.store.valid.numpy())[0]))
        idx.insert(np.arange(10_000, 10_000 + n), _rows(rng, n))
    elif case == "wave":
        idx.insert(np.arange(20_000, 20_100), _rows(rng, 100))
    elif case == "delete":
        idx.delete(rng.choice(n, 100, replace=False))
    elif case == "grow":
        extra = idx.store.capacity - n + 50
        idx.insert(np.arange(30_000, 30_000 + extra), _rows(rng, extra))
        assert idx.store.capacity > 2048
    elif case == "quant":
        idx.search_quant = "int8"
    elif case == "degree":
        idx.search_degree = 6


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "rows"])
@pytest.mark.parametrize("case", ["bulk", "wave", "delete", "grow", "quant",
                                  "degree"])
def test_tables_after_a_write_equal_a_whole_rebuild(case, packed):
    """Every table in use (both shadows, the slices at ``search_degree`` 5,
    the pool and its rows, and the packed table where one is kept), then
    one kind of write and a search: the kept tables equal a
    ``SearchTables`` of the same index built whole, bit for bit. A bulk
    build and a growth of the capacity drop the tables, which are then
    gathered whole."""
    idx, rng = _index()
    t = idx.tables
    idx.search_degree = 5
    t.vecs8()
    if packed:
        idx.pack_neighbors()
    q = _rows(rng, 20)
    idx.search(q, 8, ef_search=24)
    assert t.v16 is not None and t.slices is not None and t.pool_rows is not None
    _write(idx, rng, case)
    if case in ("bulk", "grow"):
        assert t.packed is None and t.v16 is None and t.v8 is None
    idx.search(q, 8, ef_search=24)

    whole = SearchTables(idx)
    assert torch.equal(t.vecs16(), idx.store.vectors.bfloat16())
    if t.v8 is not None:
        wi, ws = quantize_rows_int8(idx.store.vectors)
        assert torch.equal(t.v8[0], wi) and torch.equal(t.v8[1], ws)
    pool = t.pool()
    assert torch.equal(pool, whole.pool())
    assert torch.equal(t.pool_vectors(pool), whole.pool_vectors(pool))
    got, want = t.pack(), None
    if packed:  # a kept table re-gathers; a dropped one is gathered whole
        got, want = t.pack(force=True), whole.pack(force=True)
        assert torch.equal(got, want) and _equal(t.scales, whole.scales)
        assert t.quant == whole.quant == idx.search_quant
    assert got is None or packed
    cut = t.degree(got, t.scales if packed else None)
    for a, b in zip(cut, whole.degree(want, whole.scales if packed else None)):
        assert _equal(a, b)
    assert cut[0].shape[1] == idx.search_degree


# ── the route decision ──

def _parent_path(idx, q, k, ef, engine):
    """The query path of each engine composed from the module's steps, as
    the index ran it before one body ran every route."""
    t, st, metric = idx.tables, idx.store, idx.metric
    r = min(idx.route_entries, ef)
    pool = t.pool()
    qt = torch.as_tensor(q)
    if engine == "rows":
        if pool is None:
            entry = torch.full((len(q), 1), idx.entry_point, dtype=torch.int32)
        else:
            entry = hnsw_mod._route(qt, pool, st.vectors[pool.clamp(min=0).long()],
                                    metric, r, exact=True)
        rows = t.vecs16() if idx.search_bf16 else st.vectors
        bd, bi = hnsw_mod._beam_search_level0(qt, entry, rows, idx.neighbors0,
                                              metric, ef, idx.expand)
        if idx.search_bf16:
            d = gathered_distances(qt, st.vectors[bi.clamp(min=0).long()], metric)
            bd, order = torch.sort(torch.where(bi >= 0, d, torch.inf), dim=1,
                                   stable=True)
            bi = torch.gather(bi, 1, order)
        ok = (bi >= 0) & st.valid[bi.clamp(min=0).long()]
        return sorted_topk_unique(torch.where(ok, bd, torch.inf),
                                  torch.where(ok, bi, -1), k)
    entry = hnsw_mod._route(qt, pool, t.pool_vectors(pool), metric, r)
    mi = -(-ef // idx.expand) + 1
    int8 = idx.search_quant == "int8"
    rows, scales = t.vecs8() if int8 else (t.vecs16(), None)
    packed = t.pack()
    nb, packed, ps = t.degree(packed, t.scales if packed is not None else None)
    if engine == "whole":
        e_d = gathered_distances(qt, rows[entry.clamp(min=0).long()].float(), metric)
        init_d = torch.full((len(q), ef), torch.inf)
        init_i = torch.full((len(q), ef), -1, dtype=torch.int32)
        init_d[:, :r] = torch.where(entry >= 0, e_d, torch.inf)
        init_i[:, :r] = entry
        _, bi = beam_loop(qt, init_d, init_i, packed, nb, metric, ef, idx.expand,
                          0, mi)
    else:
        topm = min(idx.beam_topm, nb.shape[1]) if packed is not None and ps is None else 0
        _, bi = hnsw_mod._beam_search_level0(
            qt, entry, rows, nb, metric, ef, idx.expand, max_iters=mi,
            packed=packed, scales=scales, pscales=ps, topm=topm,
            engine="kernel" if engine == "kernel" else "eager")
    return hnsw_mod._rescore_topk(qt, st.vectors, st.valid, bi, metric, k)


ROUTES = [  # (name, knobs, pack first, want)
    ("rows_bf16", {}, False, "eager"),
    ("packed_bf16", {}, True, "eager"),
    ("rows_int8", {"search_quant": "int8"}, False, "eager"),
    ("packed_int8", {"search_quant": "int8"}, True, "eager"),
    ("topm", {"beam_topm": 4}, True, "topm"),
    ("topm_over_r0", {"beam_topm": 100}, True, "topm"),
    ("topm_int8", {"search_quant": "int8", "beam_topm": 4}, True, "eager"),
    ("whole_force", {"beam_whole": "force"}, False, "whole"),
    ("whole_true_cpu", {"beam_whole": True}, True, "eager"),
    ("whole_force_int8", {"search_quant": "int8", "beam_whole": "force"}, False, "eager"),
    ("whole_degree", {"beam_whole": "force", "search_degree": 6}, False, "whole"),
    ("kernel_protocol", {}, True, "kernel"),
    ("f32", {"search_bf16": False}, False, "rows"),
    ("no_pool_bf16", {}, False, "rows"),
    ("no_pool_f32", {"search_bf16": False}, False, "rows"),
]


@pytest.mark.parametrize("name, knobs, pack, want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_names_the_engine_and_answers_as_its_path(name, knobs, pack, want,
                                                        monkeypatch):
    """Each knob combination names its engine, and the search equals that
    engine's query path bit for bit (the kernel's flag protocol is forced on
    the CPU, where its wrapper runs the plain step)."""
    idx, rng = _index(metric="cosine")
    if name.startswith("no_pool"):
        idx.delete(idx.store.ids_of(np.nonzero(idx.levels >= 1)[0]))
        assert idx.tables.pool() is None
    for key, val in knobs.items():
        setattr(idx, key, val)
    if pack:
        idx.pack_neighbors()
    if name == "kernel_protocol":
        monkeypatch.setattr(hnsw_mod, "step_engine", lambda *a: "kernel")
    q = _rows(rng, 30)
    assert idx._choose_route(24).engine == want
    d, s = idx.search_device(q, 10, 24)
    wd, ws = _parent_path(idx, q, 10, 24, want)
    assert torch.equal(s, ws)
    assert torch.equal(d.view(torch.int32), wd.view(torch.int32))
    assert (s >= 0).all()


def test_tables_follow_their_index_and_never_keep_it_alive():
    """The tables hold their index weakly: a dropped index is freed at once,
    as before the tables had an object of their own; a deep copy of the
    index, or one through pickle, gets tables over the copy, whose search
    equals the original's."""
    import copy
    import gc
    import pickle
    import weakref

    idx, rng = _index(n=900)
    q = _rows(rng, 12)
    want = idx.search(q, 5, ef_search=16)
    for twin in (copy.deepcopy(idx), pickle.loads(pickle.dumps(idx))):
        assert twin.tables.index is twin and idx.tables.index is idx
        got = twin.search(q, 5, ef_search=16)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    gc.disable()
    try:
        ref = weakref.ref(twin)
        del twin
        assert ref() is None
    finally:
        gc.enable()
