"""muninn_tpu_torch.ops.gather.gather_rows against muninn_tpu's Pallas row
gather on the CPU.

The same seeded numpy table and indices go through ``gather_rows`` (its
plain version on CPU tensors) and JAX's ``gather_rows(interpret=True)``, as
``tests/test_topk.py:104-116`` runs it; both must equal ``table[idx]`` bit
for bit. JAX's kernel takes M in multiples of its row block, so a ragged M
is padded at the call site and sliced, as its docstring asks.
"""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muninn_tpu.ops.pallas_gather import gather_rows as jax_gather_rows
from muninn_tpu_torch.ops import _build
from muninn_tpu_torch.ops.gather import gather_rows, gather_rows_cuda, gather_rows_plain


def _table(rng, n, d, dtype):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "int8":
        return torch.from_numpy(np.clip(np.round(x * 40), -127, 127).astype(np.int8))
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d,m", [(128, 256), (100, 77), (384, 1)])
def test_gather_rows_equals_jax_and_indexing(dtype, d, m):
    """Bitwise equal to ``table[idx]`` and to JAX's kernel, for any d
    (unaligned 100 included) and ragged M."""
    rng = np.random.default_rng(d + m)
    n = 300
    table = _table(rng, n, d, dtype)
    idx = rng.integers(0, n, m).astype(np.int32)
    got = gather_rows(table, torch.from_numpy(idx))
    assert got.dtype == table.dtype and got.shape == (m, d)
    assert torch.equal(got, table[torch.from_numpy(idx).long()])
    rb = 64
    pad = (-m) % rb
    jt = jnp.asarray(table.float().numpy()).astype(
        {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype])
    want = jax_gather_rows(jt, jnp.asarray(np.pad(idx, (0, pad))), rb=rb,
                           interpret=True)[:m]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_gather_rows_empty_and_refusals():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    empty = gather_rows(table, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 3) and empty.dtype == torch.float32
    for bad in ([4], [-1]):
        with pytest.raises(IndexError, match=r"outside \[0, 4\)"):
            gather_rows_plain(table, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="table \\[N, d\\] and idx \\[M\\]"):
        gather_rows(table[0], torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        gather_rows(table.double(), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_rows_cuda(table, torch.zeros(2, dtype=torch.int32))
    assert _build.LAUNCHES["gather_rows"] == 0


@pytest.mark.parametrize("m", [7, 65537])
def test_gather_rows_ragged_m(m):
    """M off any row block (7, and one past 64 Ki): bitwise ``table[idx]``
    on every type; at M = 7 also JAX's kernel, padded to its row block."""
    rng = np.random.default_rng(m)
    for dtype in ("float32", "bfloat16", "int8"):
        table = _table(rng, 997, 100, dtype)
        idx = rng.integers(0, 997, m).astype(np.int32)
        got = gather_rows(table, torch.from_numpy(idx))
        want = table.view(torch.uint8 if dtype == "int8" else torch.int16
                          if dtype == "bfloat16" else torch.int32)
        assert got.shape == (m, 100) and got.dtype == table.dtype
        assert torch.equal(got.view(want.dtype), want[torch.from_numpy(idx).long()])
        if m == 7:
            jt = jnp.asarray(table.float().numpy()).astype(
                {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype])
            ref = jax_gather_rows(jt, jnp.asarray(np.pad(idx, (0, 64 - m))), rb=64,
                                  interpret=True)[:m]
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref).astype(np.float32))
