"""Segment reductions over edge arrays sorted by segment (a CSR's rows).

The port's copy of ``muninn_tpu.ops.segments``, with the same functions and
contracts. Consumers pass the CSR's own ``offsets [V+1]``; the values lie
sorted by segment in ``[..., e_pad]`` arrays whose tail past ``offsets[V]``
is padding that no segment covers.

The torch forms differ from the JAX ones where the JAX forms work around
the TPU:

- **min/max** is one ``scatter_reduce_`` (``amin``/``amax``) of each value
  into its segment's slot. A min or max of int32 or float values is exact
  in any order, so the result is the shift-doubling scan's, at any pass
  count: ``n_passes`` is accepted for the contract and never limits the
  reduction. Segment ids come from ``offsets`` (:func:`seg_ids`), once per
  topology; ``seg_pos`` is accepted for the contract. The padding is
  sliced off first: sent to one spare slot, every pad would contend for
  the same word.
- **sum** is a window difference of one float64 prefix sum,
  ``seg[v] = S[off[v+1]] - S[off[v]]``, rounded to the values' dtype once.
  float64 keeps the absolute error near 1e-16 of the total, so a segment's
  sum is good to about one f32 rounding however long the array (a float32
  prefix would lose about 1e-7 of the total in every segment, which is most
  of a PageRank share at a million nodes). The order of the additions is
  fixed by the array, not by a scheduler.
- The **chunked** forms keep their contracts (``chunk`` must divide
  ``e_pad``; ``vals_fn(cstart)`` gives ``[chunk]`` values) and reduce chunk
  by chunk; the port's fixpoints do not need them.

Node ids pass through no float32 (exact only up to 2**24): ids and
positions stay int32 or int64.
"""

from __future__ import annotations

import math

import torch


#: rows at least this long get a 1-D prefix scan each (see :func:`seg_sum`)
LONG_ROW = 1 << 20


def n_passes_for(max_segment_len: int) -> int:
    """Shift-doubling pass count covering segments up to
    ``max_segment_len`` (the JAX contract; the port's reductions are exact
    at any count)."""
    return max(1, math.ceil(math.log2(max(int(max_segment_len), 2))))


def seg_positions(offsets: torch.Tensor, e_pad: int) -> torch.Tensor:
    """int32 [e_pad]: each position's offset within its segment (pads get
    positions continuing past the last segment)."""
    pos = torch.arange(e_pad, dtype=torch.int32, device=offsets.device)
    node = torch.searchsorted(offsets, pos, right=True, out_int32=True) - 1
    node = node.clamp_(0, offsets.shape[0] - 2)
    return pos - offsets.index_select(0, node)


def seg_ids(offsets: torch.Tensor) -> torch.Tensor:
    """int64 [E]: the segment (node) id of each of the ``E = offsets[V]``
    positions the segments cover — the index of a ``scatter_reduce_``.
    Reads ``offsets[V]`` on the host once; computed once per topology."""
    e = int(offsets[-1])
    return torch.repeat_interleave(
        torch.arange(offsets.shape[0] - 1, device=offsets.device),
        torch.diff(offsets.long()), output_size=e,
    )


def seg_min_by_ids(vals: torch.Tensor, ids: torch.Tensor, num_nodes: int,
                   identity) -> torch.Tensor:
    """Per-segment min of ``vals[..., E]`` by the segment ids of
    :func:`seg_ids` (the padding past ``offsets[V]`` sliced off, so no
    slot takes every pad's value); empty segments get ``identity``. The
    form the fixpoints call, their ids hoisted out of the loop."""
    return _seg_reduce(vals, ids, num_nodes, "amin", identity)


def _seg_reduce(vals: torch.Tensor, ids: torch.Tensor, num_nodes: int,
                reduce: str, identity) -> torch.Tensor:
    out = torch.full((*vals.shape[:-1], num_nodes), identity,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, ids.expand(vals.shape), vals, reduce)


def seg_sum(vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``vals[..., e_pad]`` sorted by segment (pads
    must be 0). Returns ``[..., V]`` in ``vals``' dtype: window differences
    of one float64 (int64 for integers) prefix sum."""
    acc = torch.float64 if vals.is_floating_point() else torch.int64
    # pre[..., i] = S[i + 1]. Long rows take one 1-D scan each: on the card
    # the batched scan (``tensor_kernel_scan_innermost_dim``) runs at a few
    # percent of the memory rate on rows of millions (Brandes' [S, E]
    # sweeps), while on short rows one batched launch beats S launches
    if vals.dim() > 1 and vals.shape[-1] >= LONG_ROW:
        pre = torch.empty(vals.shape, dtype=acc, device=vals.device)
        for row, out in zip(vals.flatten(0, -2), pre.flatten(0, -2)):
            torch.cumsum(row, 0, dtype=acc, out=out)
    else:
        pre = torch.cumsum(vals, dim=-1, dtype=acc)

    def prefix_at(pos):                          # S[pos], S[0] = 0
        return torch.where(pos > 0, pre[..., (pos - 1).clamp_(min=0)], 0)

    off = offsets.long()
    return (prefix_at(off[1:]) - prefix_at(off[:-1])).to(vals.dtype)


def seg_min(vals: torch.Tensor, seg_pos: torch.Tensor, offsets: torch.Tensor,
            identity, n_passes: int = 24) -> torch.Tensor:
    """Per-segment min of ``vals[..., e_pad]``; empty segments get
    ``identity``. ``seg_pos`` and ``n_passes`` are the JAX contract's; the
    reduction is exact whatever they are."""
    ids = seg_ids(offsets)
    return seg_min_by_ids(vals[..., :ids.shape[0]], ids,
                          offsets.shape[0] - 1, identity)


def seg_max(vals: torch.Tensor, seg_pos: torch.Tensor, offsets: torch.Tensor,
            identity, n_passes: int = 24) -> torch.Tensor:
    """Per-segment max, as :func:`seg_min`."""
    ids = seg_ids(offsets)
    return _seg_reduce(vals[..., :ids.shape[0]], ids, offsets.shape[0] - 1,
                       "amax", identity)


# ───────────── chunked forms ─────────────


def spos_dtype_for(n_passes: int):
    """Smallest int dtype that can hold the clipped in-segment positions of
    :func:`seg_positions_chunked` (clipped to ``2**n_passes - 1``)."""
    cap = (1 << n_passes) - 1
    if cap <= 255:
        return torch.uint8, cap
    if cap <= 32767:
        return torch.int16, cap
    return torch.int32, cap


def _check_chunking(e_pad: int, chunk: int) -> None:
    """The chunked reducers iterate ``e_pad // chunk`` full slices; a
    remainder would be silently dropped, so it is refused."""
    if chunk <= 0 or e_pad % chunk != 0:
        raise ValueError(
            f"chunked segment reduce needs chunk | e_pad, got "
            f"e_pad={e_pad} chunk={chunk}"
        )


def seg_positions_chunked(offsets: torch.Tensor, e_pad: int, chunk: int,
                          n_passes: int) -> torch.Tensor:
    """Compact-dtype :func:`seg_positions`, computed in ``[chunk]`` slices;
    values clip to ``2**n_passes - 1``."""
    dt, cap = spos_dtype_for(n_passes)
    _check_chunking(e_pad, chunk)
    out = torch.empty(e_pad, dtype=dt, device=offsets.device)
    for cstart in range(0, e_pad, chunk):
        pos = torch.arange(cstart, cstart + chunk, dtype=torch.int32,
                           device=offsets.device)
        node = torch.searchsorted(offsets, pos, right=True, out_int32=True) - 1
        node = node.clamp_(0, offsets.shape[0] - 2)
        out[cstart:cstart + chunk] = torch.clamp(
            pos - offsets.index_select(0, node), max=cap).to(dt)
    return out


def seg_reduce_chunked(vals_fn, spos: torch.Tensor, offsets: torch.Tensor,
                       identity, n_passes: int, chunk: int, combine,
                       dtype: torch.dtype) -> torch.Tensor:
    """Per-segment ``combine``-reduce (``torch.minimum`` or
    ``torch.maximum``) over a long sorted edge array, ``[chunk]`` values at
    a time: ``vals_fn(cstart)`` gives the values from edge position
    ``cstart``. ``spos`` (from :func:`seg_positions_chunked`) sets
    ``e_pad``. Returns [V]."""
    reduce = {torch.minimum: "amin", torch.maximum: "amax"}.get(combine)
    if reduce is None:
        raise ValueError("combine must be torch.minimum or torch.maximum")
    e_pad = spos.shape[0]
    _check_chunking(e_pad, chunk)
    ids = seg_ids(offsets)  # the padding past offsets[V] takes no part
    acc = torch.full((offsets.shape[0] - 1,), identity, dtype=dtype,
                     device=offsets.device)
    for cstart in range(0, ids.shape[0], chunk):
        idc = ids[cstart:cstart + chunk]
        acc.scatter_reduce_(0, idc, vals_fn(cstart)[:idc.shape[0]].to(dtype),
                            reduce)
    return acc


def seg_sum_chunked(vals_fn, offsets: torch.Tensor, e_pad: int,
                    chunk: int) -> torch.Tensor:
    """Per-segment f32 sums in ``[chunk]`` slices (see
    :func:`seg_reduce_chunked`; pads must yield 0): each chunk's in-chunk
    window sums of one float64 prefix, accumulated in float64 across
    chunks and rounded once."""
    _check_chunking(e_pad, chunk)
    acc = torch.zeros(offsets.shape[0] - 1, dtype=torch.float64,
                      device=offsets.device)
    for cstart in range(0, e_pad, chunk):
        pre = torch.cumsum(vals_fn(cstart), 0, dtype=torch.float64)
        pre = torch.cat([pre.new_zeros(1), pre])
        lo = (offsets[:-1].long() - cstart).clamp_(0, chunk)
        hi = (offsets[1:].long() - cstart).clamp_(0, chunk)
        acc += pre[hi] - pre[lo]
    return acc.float()


def bincount_chunked(vals: torch.Tensor, w: torch.Tensor | None,
                     num_bins: int, chunk: int) -> torch.Tensor:
    """Weighted f32 bincount over a long padded id array in ``[chunk]``
    slices. Out-of-range ids (pads = ``num_bins``) are dropped. ``w=None``
    counts occurrences.

    Gives PageRank its out-degrees straight from the opposite direction's
    CSR values (its ``dst`` holds exactly the source endpoints), so the
    direction CSR is never built for degrees alone."""
    e_pad = vals.shape[0]
    chunk = min(chunk, e_pad)
    _check_chunking(e_pad, chunk)
    acc = torch.zeros(num_bins, dtype=torch.float64, device=vals.device)
    for cstart in range(0, e_pad, chunk):
        v = vals[cstart:cstart + chunk].long()
        live = (v >= 0) & (v < num_bins)
        add = (live.double() if w is None
               else torch.where(live, w[cstart:cstart + chunk].double(), 0.0))
        # a pad adds 0 to a bin of its own position's, not to one shared
        # slot whose word every pad would contend for
        spread = torch.arange(cstart, cstart + chunk,
                              device=vals.device) % num_bins
        acc.index_add_(0, torch.where(live, v, spread), add)
    return acc.float()
