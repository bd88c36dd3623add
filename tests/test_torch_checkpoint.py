"""muninn_tpu_torch.io.checkpoint against muninn_tpu.io.checkpoint on the CPU.

A checkpoint of each index kind written by one package loads in the other
and searches alike: flat (its precision mode kept), quantized, HNSW after
insert waves and deletes, and IVF (bf16 and int8 blocks, a bf16 store,
unbuilt, with pending rows). Each pair returns identical ids (except at
float64 ties of the two rows for the query) and distances within 1e-5.
Then the port's side of ``tests/test_persistence.py``: a kind mismatch
raises, ``DeltaLog`` skips a torn final line and raises on a torn middle
one, and a corrupted checkpoint loads to identical results or raises.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json
import shutil

import numpy as np
import pytest

from muninn_tpu.index.flat import FlatIndex as JaxFlatIndex
from muninn_tpu.index.flat import QuantizedFlatIndex as JaxQuantizedFlatIndex
from muninn_tpu.index.hnsw import HnswIndex as JaxHnswIndex
from muninn_tpu.index.ivf import IvfIndex as JaxIvfIndex
from muninn_tpu.io import checkpoint as jck
from muninn_tpu_torch import FlatIndex, HnswIndex, IvfIndex, QuantizedFlatIndex
from muninn_tpu_torch.io import checkpoint as tck

D = 16


def _rows(seed, n, d=D):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dist64(a, b, metric):
    a, b = a.astype(np.float64), b.astype(np.float64)
    dots = (a * b).sum(-1)
    if metric == "l2":
        return ((a - b) ** 2).sum(-1)
    if metric == "inner_product":
        return -dots
    return 1.0 - dots / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_same(got, want, q, x, metric):
    """Ids equal except where both are float64 ties for the query; distances
    within 1e-5."""
    (gi, gd), (wi, wd) = got, (np.asarray(want[0]), np.asarray(want[1]))
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-6)
    b, c = np.nonzero(gi != wi)
    if len(b):
        assert (gi[b, c] >= 0).all() and (wi[b, c] >= 0).all()
        dg = _dist64(q[b], x[gi[b, c]], metric)
        dw = _dist64(q[b], x[wi[b, c]], metric)
        assert np.all(np.abs(dg - dw) <= 1e-6 * (1 + np.abs(dw)))


def _on_cpu(idx):
    assert idx.store.vectors.device.type == "cpu"
    return idx


def _cross(tmp_path, kind, j, t, search, q, x, metric):
    """JAX's checkpoint into the port, and the port's into JAX: each loaded
    index searches as the one saved."""
    jsave, jload = getattr(jck, f"save_{kind}"), getattr(jck, f"load_{kind}")
    tsave, tload = getattr(tck, f"save_{kind}"), getattr(tck, f"load_{kind}")
    jsave(j, tmp_path / "jax")
    tj = _on_cpu(tload(tmp_path / "jax", device="cpu"))
    _assert_same(search(tj), search(j), q, x, metric)
    tsave(t, tmp_path / "port")
    jt = jload(tmp_path / "port")
    _assert_same(search(t), search(jt), q, x, metric)
    return tj, jt


@pytest.mark.parametrize("precision", ["highest", "int8_rescored"])
def test_flat_crosses_both_ways_in_its_precision_mode(tmp_path, precision):
    x, q = _rows(1, 300), _rows(2, 20)
    j = JaxFlatIndex(D, "cosine", precision=precision)
    t = _on_cpu(FlatIndex(D, "cosine", precision=precision, device="cpu"))
    for idx in (j, t):
        idx.insert(np.arange(300), x)
        idx.delete([3, 50, 299])
        idx.rescore_r = 24
    tj, jt = _cross(tmp_path, "flat", j, t, lambda i: i.search(q, k=5), q, x,
                    "cosine")
    for idx in (tj, jt):
        assert idx.precision == precision and idx.rescore_r == 24
    assert len(tj) == len(jt) == 297


def test_quantized_crosses_both_ways(tmp_path):
    x, q = _rows(3, 200), _rows(4, 20)
    j = JaxQuantizedFlatIndex(D, "cosine")
    t = _on_cpu(QuantizedFlatIndex(D, "cosine", device="cpu"))
    for idx in (j, t):
        idx.insert(np.arange(200), x)
        idx.delete([5, 7])
    tj, _ = _cross(tmp_path, "quantized", j, t, lambda i: i.search(q, k=5), q, x,
                   "cosine")
    tj.insert([900], x[:1])  # the loaded store's maps work
    assert len(tj) == 199


def test_hnsw_after_waves_and_deletes_crosses_both_ways(tmp_path):
    """Both sides build in waves (exact candidates, f32 search) and delete;
    the port's save flushes its queued upper-level wiring."""
    x, q = _rows(5, 420), _rows(6, 30)
    j = JaxHnswIndex(D, "cosine", m=6, ef_construction=40, wave_size=64,
                     capacity=256, seed=3)
    t = HnswIndex(D, "cosine", m=6, ef_construction=40, wave_size=64,
                  capacity=256, seed=3, device="cpu")
    for idx in (j, t):
        idx.build_precision = "highest"
        idx.search_bf16 = False
        idx.insert(np.arange(300), x[:300])
        idx.insert(np.arange(300, 420), x[300:])
        idx.delete(np.arange(0, 420, 9))
    # the port's queue, in order, is JAX's queued waves one after another
    ts, tl = t._queued_promotions()
    assert len(ts)
    for got, part in ((ts, 0), (tl, 1)):
        np.testing.assert_array_equal(
            got, np.concatenate([np.asarray(w[part]) for w in j._hi_pending]))

    def search(idx):
        idx.exact_small_n = 0
        idx.search_bf16 = False
        return idx.search(q, k=5, ef_search=24)

    tj, jt = _cross(tmp_path, "hnsw", j, t, search, q, x, "cosine")
    assert not len(t._queued_promotions()[0])
    ids = search(tj)[0]
    assert not np.isin(ids, np.arange(0, 420, 9)).any()


def _ivf_pair(case, metric):
    x = _rows(7, 1500)
    quant = "int8" if case == "int8" else "bf16"
    kw = dict(cluster_size=32, nprobe=4, rescore_r=16, seed=2, quant=quant)
    j = JaxIvfIndex(D, metric, **kw)
    t = IvfIndex(D, metric, device="cpu", **kw)
    if case == "bf16_store":
        import jax.numpy as jnp
        import torch

        j = JaxIvfIndex(D, metric, store_dtype=jnp.bfloat16, **kw)
        t = IvfIndex(D, metric, device="cpu", store_dtype=torch.bfloat16, **kw)
    n = 300 if case == "unbuilt" else 1500
    for idx in (j, t):
        idx.insert(np.arange(n), x[:n])
        if case == "pending":
            idx.load_rows(np.arange(2000, 2100), _rows(8, 100))
        idx.delete(np.arange(0, n, 11))
    assert (t.centroids is None) == (case == "unbuilt")
    assert (t._pending_count >= 100) == (case in ("pending", "unbuilt"))
    return j, t, np.concatenate([x, np.zeros((500, D), np.float32), _rows(8, 100)])


@pytest.mark.parametrize("case", ["bf16", "int8", "bf16_store", "unbuilt", "pending"])
def test_ivf_crosses_both_ways(tmp_path, case):
    """Each side builds its own index (its own k-means draw), so each pair
    is the saved index against its loaded copy in the other package."""
    metric = "cosine"
    j, t, x = _ivf_pair(case, metric)
    q = x[:40] + 0.05 * np.random.default_rng(9).standard_normal((40, D)).astype(np.float32)
    tj, jt = _cross(tmp_path, "ivf", j, t, lambda i: i.search(q, k=7), q, x,
                    metric)
    assert tj.quant == t.quant and tj.nlist == j.nlist
    assert tj.store.vectors.dtype == t.store.vectors.dtype
    # the loaded index goes on churning in both regions
    tj.insert([5000], x[1:2])
    tj.delete([1])
    ids, _ = tj.search(x[1], k=3)
    assert 5000 in ids and 1 not in ids


def test_kind_mismatch_raises(tmp_path):
    idx = FlatIndex(8, "l2", device="cpu")
    idx.insert([1], np.zeros((1, 8), np.float32))
    tck.save_flat(idx, tmp_path / "x")
    with pytest.raises(ValueError, match="expected hnsw"):
        tck.load_hnsw(tmp_path / "x", device="cpu")
    with pytest.raises(ValueError, match="expected ivf"):
        jck.load_ivf(tmp_path / "x")


def test_delta_log_tolerates_torn_tail(tmp_path):
    """A torn final line is skipped; a torn line anywhere else raises; the
    JAX package's log replays the port's records."""
    log = tck.DeltaLog(tmp_path / "delta.jsonl")
    log.append("insert", id=1)
    log.append_many([{"op": "insert", "id": 2}, {"op": "delete", "id": 1}])
    assert len(log) == 3
    with open(log.path, "a") as f:
        f.write('{"op": "ins')
    assert [r["id"] for r in log.replay()] == [1, 2, 1]
    assert list(jck.DeltaLog(log.path).replay()) == list(log.replay())
    lines = log.path.read_text().splitlines()
    log.path.write_text("\n".join([lines[0], '{"broken', lines[1]]) + "\n")
    with pytest.raises(json.JSONDecodeError):
        list(log.replay())
    log.clear()
    assert len(log) == 0 and list(log.replay()) == []


def test_checkpoint_corruption_never_silently_corrupts(rng, tmp_path):
    """A corrupted checkpoint directory (a file truncated, four bytes
    flipped, or a file removed) either loads to identical results or
    raises, for flat, HNSW and IVF."""
    dim, n = 16, 700
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(n)
    q = vecs[:8]
    builds = {
        "flat": lambda: FlatIndex(dim, "cosine", capacity=1024, device="cpu"),
        "hnsw": lambda: HnswIndex(dim, "cosine", m=6, ef_construction=48,
                                  device="cpu"),
        "ivf": lambda: IvfIndex(dim, "cosine", cluster_size=64, device="cpu"),
    }
    for kind, mk in builds.items():
        save, load = getattr(tck, f"save_{kind}"), getattr(tck, f"load_{kind}")
        idx = _on_cpu(mk())
        idx.insert(ids, vecs)
        want, _ = idx.search(q, k=5)
        ref = tmp_path / f"{kind}_ref"
        save(idx, ref)
        assert np.array_equal(want, load(ref, device="cpu").search(q, k=5)[0])
        files = sorted(p for p in ref.rglob("*") if p.is_file())
        for r in range(6):
            work = tmp_path / f"{kind}_w{r}"
            shutil.copytree(ref, work)
            victim = work / str(
                rng.choice([str(f.relative_to(ref)) for f in files]))
            data = victim.read_bytes()
            op = r % 3
            if op == 0:
                victim.write_bytes(data[: int(rng.integers(0, len(data)))])
            elif op == 1:
                b = bytearray(data)
                for _ in range(4):
                    b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
                victim.write_bytes(bytes(b))
            else:
                victim.unlink()
            try:
                got, _ = load(work, device="cpu").search(q, k=5)
            except Exception:
                continue  # a clean failure
            assert np.array_equal(want, got), f"{kind} r={r}: silent corruption"
