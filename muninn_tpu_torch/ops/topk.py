"""Masked top-k and sorted merge, the PyTorch port of
``muninn_tpu/ops/topk.py``.

Convention throughout: distances are "smaller = better"; invalid slots
carry ``inf`` distance and id ``-1``.
"""

from __future__ import annotations

import torch

INVALID_ID = -1


def masked_topk(
    dists: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of ``dists [..., N]`` with optional validity ``mask``.

    Returns ``(top_dists [..., k], top_ids [..., k])`` sorted ascending;
    masked-out or out-of-range slots come back as ``(inf, -1)``. ``ids``
    (optional, aligned with the last axis) replaces positional indices.
    """
    n = dists.shape[-1]
    d = dists.float()
    if mask is not None:
        d = torch.where(mask, d, torch.full_like(d, float("inf")))
    kk = min(k, n)
    top_d, top_idx = torch.topk(d, kk, dim=-1, largest=False, sorted=True)
    if ids is None:
        top_ids = top_idx.to(torch.int32)
    else:
        top_ids = torch.gather(
            ids.expand(dists.shape), -1, top_idx
        ).to(torch.int32)
    top_ids = torch.where(
        torch.isinf(top_d), torch.full_like(top_ids, INVALID_ID), top_ids
    )
    if kk < k:  # pad to the requested k with invalid slots
        pad = (0, k - kk)
        top_d = torch.nn.functional.pad(top_d, pad, value=float("inf"))
        top_ids = torch.nn.functional.pad(top_ids, pad, value=INVALID_ID)
    return top_d, top_ids


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row (last axis), ascending, equal
    values in order of position, as ``lax.top_k`` of the negated row orders
    them (``torch.topk`` leaves the order of ties open). Returns
    ``(values, positions int64)``."""
    vals, pos = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]


def smallest_k_select(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``smallest_k`` of the rows of a 2-D ``x`` by ``torch.topk`` instead
    of a sort of each whole row, for wide rows: the same values and
    positions. ``torch.topk`` keeps every entry below the k-th value; a row
    where it kept some but not all of the entries equal to that value may
    have kept later positions than the first, and only such rows are
    sorted whole. Reads one flag back to the host."""
    if k >= x.shape[-1]:
        return smallest_k(x, k)
    vals, pos = torch.topk(x, k, dim=-1, largest=False, sorted=True)
    order = torch.argsort(pos, dim=-1)  # by position, then stably by value
    vals, pos = torch.gather(vals, -1, order), torch.gather(pos, -1, order)
    order = torch.sort(vals, dim=-1, stable=True).indices
    vals, pos = torch.gather(vals, -1, order), torch.gather(pos, -1, order)
    kth = vals[:, -1:]
    cut = (x == kth).sum(dim=-1) != (vals == kth).sum(dim=-1)
    if bool(cut.any()):
        vals[cut], pos[cut] = smallest_k(x[cut], k)
    return vals, pos


def _dedup_ids(
    dists: torch.Tensor, ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Invalidate duplicate ids, keeping the best occurrence: sort by
    (id, dist); a slot whose id equals its sorted predecessor's becomes
    ``(inf, -1)``."""
    order = torch.sort(dists, dim=-1, stable=True).indices
    order = torch.gather(
        order, -1,
        torch.sort(torch.gather(ids, -1, order), dim=-1, stable=True).indices,
    )
    sd = torch.gather(dists, -1, order)
    si = torch.gather(ids, -1, order)
    prev = torch.cat([torch.full_like(si[..., :1], -2), si[..., :-1]], dim=-1)
    dup = (si == prev) & (si != INVALID_ID)
    sd = torch.where(dup, torch.full_like(sd, float("inf")), sd)
    si = torch.where(dup, torch.full_like(si, INVALID_ID), si)
    return sd, si


def merge_topk(
    dists_a: torch.Tensor,
    ids_a: torch.Tensor,
    dists_b: torch.Tensor,
    ids_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted-ascending (dist, id) sets along the last axis,
    keeping the ``ka`` smallest (the width of set ``a``). An id present in
    both sets survives once, with its best distance."""
    ka = dists_a.shape[-1]
    d, i = _dedup_ids(
        torch.cat([dists_a, dists_b], dim=-1), torch.cat([ids_a, ids_b], dim=-1)
    )
    order = torch.sort(d, dim=-1, stable=True).indices
    d = torch.gather(d, -1, order)
    i = torch.gather(i, -1, order)
    return d[..., :ka], i[..., :ka]


def merge_topk_flagged(
    dists_a: torch.Tensor,
    ids_a: torch.Tensor,
    flags_a: torch.Tensor,
    dists_b: torch.Tensor,
    ids_b: torch.Tensor,
    flags_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``merge_topk`` with a boolean payload carried through the sort
    (``muninn_tpu/ops/topk.py:109-145``): the ``ka`` smallest of the two
    (dist, id, flag) sets, ascending. Of an id present more than once the
    occurrence with flag True survives, the closest among those (the beam
    search's rule: an expanded entry never reverts to unexpanded); the
    others become ``(inf, -1, False)``."""
    ka = dists_a.shape[-1]
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    f = torch.cat([flags_a, flags_b], dim=-1)
    # lexsort by (id, ~flag, dist): stable sorts, the minor key first
    order = torch.sort(d, dim=-1, stable=True).indices
    for key in ((~f).to(torch.int32), i):
        order = torch.gather(order, -1, torch.sort(
            torch.gather(key, -1, order), dim=-1, stable=True).indices)
    sd, si, sf = (torch.gather(x, -1, order) for x in (d, i, f))
    prev = torch.cat([torch.full_like(si[..., :1], -2), si[..., :-1]], dim=-1)
    dup = (si == prev) & (si != INVALID_ID)
    sd = torch.where(dup, torch.full_like(sd, float("inf")), sd)
    si = torch.where(dup, torch.full_like(si, INVALID_ID), si)
    sf = sf & ~dup
    order = torch.sort(sd, dim=-1, stable=True).indices
    sd, si, sf = (torch.gather(x, -1, order) for x in (sd, si, sf))
    return sd[..., :ka], si[..., :ka], sf[..., :ka]


def sorted_topk_unique(
    dists: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (dist, id) pairs ascending by distance after id-dedup and keep
    k. Always width ``k``: fewer candidates than k leave an
    ``(inf, -1)``-padded tail."""
    d, i = _dedup_ids(dists, ids)
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    d = torch.gather(d, -1, order)
    i = torch.gather(i, -1, order)
    short = k - d.shape[-1]
    if short > 0:
        d = torch.nn.functional.pad(d, (0, short), value=float("inf"))
        i = torch.nn.functional.pad(i, (0, short), value=INVALID_ID)
    return d, i
