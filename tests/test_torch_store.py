"""muninn_tpu_torch.index.store.VectorStore against muninn_tpu's on the CPU:
the same sequence of appends, deletes and growth through both stores must
leave the same state. The store only moves values, so the state must be
equal, not close."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest
import torch

from muninn_tpu.index.store import VectorStore as JaxStore
from muninn_tpu_torch.index.store import VectorStore


def _assert_same_state(ts, js):
    hw = js.high_watermark
    assert ts.high_watermark == hw
    assert len(ts) == len(js)
    assert ts.capacity == js.capacity
    np.testing.assert_array_equal(ts.vectors[:hw].numpy(),
                                  np.asarray(js.vectors[:hw]))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts._id_of, js._id_of)
    assert ts._slot_of == js._slot_of


@pytest.mark.parametrize(
    "capacity,pad_multiple,batches",
    [(1024, 1024, (300, 900, 10)),     # grows 1024 -> 2048 on the 2nd batch
     (16, 8, (5, 20, 40)),             # doubles twice, rounded to 8
     (8, 8, (0, 3))],                  # an empty batch is a legal no-op
)
def test_store_matches_jax_through_appends_deletes_growth(
        capacity, pad_multiple, batches):
    rng = np.random.default_rng(capacity + sum(batches))
    d = 12
    ts = VectorStore(d, capacity, pad_multiple, device="cpu")
    js = JaxStore(d, capacity, pad_multiple)
    next_id = 1000
    for n in batches:
        ids = np.arange(next_id, next_id + n, dtype=np.int64) * 7
        next_id += n
        vecs = rng.standard_normal((n, d)).astype(np.float32)
        np.testing.assert_array_equal(ts.add(ids, vecs), js.add(ids, vecs))
        _assert_same_state(ts, js)
        if n >= 3:
            dead = ids[[0, n // 2, n - 1]]
            np.testing.assert_array_equal(ts.remove(dead), js.remove(dead))
            _assert_same_state(ts, js)
    probe = np.array([-1, 0, ts.high_watermark - 1], np.int32)
    np.testing.assert_array_equal(ts.ids_of(probe), js.ids_of(probe))


def test_store_register_unregister_match_jax():
    ts, js = VectorStore(4, 8, 8, device="cpu"), JaxStore(4, 8, 8)
    ids = np.array([5, 9, 11], np.int64)
    np.testing.assert_array_equal(ts.register(ids, reserve_extra=20),
                                  js.register(ids, reserve_extra=20))
    assert ts.capacity == js.capacity
    np.testing.assert_array_equal(ts.unregister(ids[:1]), js.unregister(ids[:1]))
    assert ts._slot_of == js._slot_of and len(ts) == len(js)
    np.testing.assert_array_equal(ts._id_of, js._id_of)


def test_store_lookups():
    ts = VectorStore(3, 8, 8, device="cpu")
    vecs = np.arange(6, dtype=np.float32).reshape(2, 3)
    ts.add(np.array([40, 41]), vecs)
    assert ts.slot(41) == 1 and ts.slot(99) is None
    np.testing.assert_array_equal(ts.slots_of([41, 40]), [1, 0])
    np.testing.assert_array_equal(ts.get_vector(41), vecs[1])
    ts.remove(np.array([41]))
    assert ts.get_vector(41) is None
    assert ts.vectors.dtype == torch.float32 and ts.valid.dtype == torch.bool


def test_store_duplicate_and_unknown_ids_raise_like_jax():
    for store in (VectorStore(4, 8, 8, device="cpu"), JaxStore(4, 8, 8)):
        store.add(np.array([1, 2]), np.zeros((2, 4), np.float32))
        with pytest.raises(ValueError, match="duplicate id 1"):
            store.add(np.array([1]), np.zeros((1, 4), np.float32))
        with pytest.raises(ValueError, match="within batch"):
            store.add(np.array([3, 3]), np.zeros((2, 4), np.float32))
        with pytest.raises(KeyError):
            store.remove(np.array([77]))
        assert len(store) == 2 and store.high_watermark == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.bfloat16])
def test_store_dtype_decides_row_scales(dtype):
    """int8 storage always carries one f32 scale per row, grown with the
    store; f32 and bf16 storage carry none; any other dtype is refused."""
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        VectorStore(4, 8, 8, device="cpu", dtype=torch.float16)
    ts = VectorStore(4, 8, 8, device="cpu", dtype=dtype)
    ts.add(np.arange(20), np.ones((20, 4), np.float32))
    assert ts.vectors.dtype == dtype and ts.capacity == 32
    if dtype == torch.int8:
        assert ts.scales.dtype == torch.float32 and ts.scales.shape == (32,)
    else:
        assert ts.scales is None


def test_store_restore_rebuilds_from_id_of():
    rng = np.random.default_rng(8)
    src = VectorStore(5, 8, 8, device="cpu")
    src.add(np.arange(20) + 100, rng.standard_normal((20, 5)).astype(np.float32))
    src.remove(np.array([100, 107, 119]))
    hw = src.high_watermark
    dst = VectorStore(5, 8, 8, device="cpu")
    dst.restore(src.vectors[:hw].numpy(), src._id_of[:hw])
    assert dst.high_watermark == hw and len(dst) == len(src) == 17
    assert dst._slot_of == src._slot_of
    np.testing.assert_array_equal(dst.valid[:hw].numpy(), src.valid[:hw].numpy())
    with pytest.raises(ValueError, match="duplicate"):
        dst.restore(np.zeros((2, 5), np.float32), np.array([4, 4]))
    with pytest.raises(ValueError, match="shape"):
        dst.restore(np.zeros((2, 4), np.float32), np.array([4, 5]))


def test_bf16_store_matches_jax():
    """A bf16 store rounds rows to nearest even as JAX's does (equal bit
    patterns through appends, deletes and growth) and reads them back as
    f32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    ts = VectorStore(6, 8, 8, device="cpu", dtype=torch.bfloat16)
    js = JaxStore(6, 8, 8, dtype=jnp.bfloat16)
    for lo, n in ((0, 5), (5, 30)):
        vecs = rng.standard_normal((n, 6)).astype(np.float32)
        ids = np.arange(lo, lo + n)
        np.testing.assert_array_equal(ts.add(ids, vecs), js.add(ids, vecs))
    ts.remove(np.array([3, 20]))
    js.remove(np.array([3, 20]))
    assert ts.capacity == js.capacity and ts.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.vectors.view(torch.int16).numpy(),
                                  np.asarray(js.vectors).view(np.int16))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    row = ts.get_vector(7)
    assert row.dtype == np.float32
    np.testing.assert_array_equal(row, np.asarray(js.vectors[7], np.float32))
