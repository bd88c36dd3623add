"""The plain reference that decides ``correct``: exact top-k in float64
over the rows and queries the benchmark made, and the comparison of the
program's answers with it.

Plain PyTorch and numpy; it imports nothing of ``muninn_tpu_torch`` and
takes nothing the program made: the caller hands it the generated rows and
queries, and the program's answers (external ids mapped back to rows by
the benchmark's own id table, and the distances returned) only to judge
them. It runs after the window, in blocks of queries and rows, on the run's
device.

Each answer is judged against the rows that were live when it was given:
an engine whose requests write rows hands the caller the live set of each
state it reports, and the caller judges each state's answers against that
state's exact top-k (``tally``) and pools the states (``pool``). An answer
given from an older state than its request reports is wrong by these same
numbers: a row deleted since is an id no live row has, a row added since is
a miss, and a row given a new vector since is a distance off its row.

The numbers (``judge``), each held to the limit its traffic file gives:

- ``bad_rows``: answers with an id that no row has, an id twice, a
  distance that is not finite, or distances out of ascending order;
- ``dist_err``: the widest gap between a returned distance and the float64
  distance of the row returned with it;
- ``rank_gap``: the widest amount by which the float64 distance of the row
  returned at rank r exceeds the reference's r-th smallest (exact
  guarantees: 0 up to rounding and ties);
- ``miss_at_<k>``: the share of the reference's top-k that the answers
  miss, pooled over every answer judged (1 - recall@k).
"""

from __future__ import annotations

import numpy as np
import torch

EPS_NORM = 1e-30


def _norms(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1).clamp(min=EPS_NORM)


def distances64(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """``[U, M]`` float64 distances of queries ``q [U, d]`` to rows
    ``x [M, d]`` (both float64)."""
    dots = q @ x.T
    if metric == "cosine":
        return 1.0 - dots / (_norms(q)[:, None] * _norms(x)[None, :])
    if metric == "inner_product":
        return -dots
    if metric == "l2":
        return ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                - 2.0 * dots).clamp(min=0.0)
    raise ValueError(f"unknown metric {metric!r}")


def row_distances64(q: torch.Tensor, rows: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """``[A, k]`` float64 distances of each query ``q [A, d]`` to its own
    rows ``rows [A, k, d]``."""
    dots = torch.einsum("ad,akd->ak", q, rows)
    if metric == "cosine":
        return 1.0 - dots / (_norms(q)[:, None] * _norms(rows))
    if metric == "inner_product":
        return -dots
    if metric == "l2":
        return ((q[:, None, :] - rows) ** 2).sum(-1)
    raise ValueError(f"unknown metric {metric!r}")


def blocked_topk(q: torch.Tensor, x: torch.Tensor, k: int, score,
                 x_block: int = 65536):
    """The ``k`` smallest ``score(q, rows)`` of each query over ``x``, a
    block of rows at a time: ``(values [U, k], rows [U, k] int64)``,
    ascending."""
    best_v = best_i = None
    for xs in range(0, x.shape[0], x_block):
        v = score(q, x[xs : xs + x_block])
        ids = torch.arange(xs, xs + v.shape[1], device=x.device).expand_as(v)
        if best_v is not None:
            v, ids = torch.cat([best_v, v], 1), torch.cat([best_i, ids], 1)
        best_v, pos = torch.topk(v, min(k, v.shape[1]), dim=1, largest=False)
        best_i = torch.gather(ids, 1, pos)
    return best_v, best_i


def exact_topk(q: np.ndarray, x: torch.Tensor, k: int, metric: str,
               q_block: int = 2048, x_block: int = 65536):
    """The exact top-k of each query ``q [U, d]`` (float32, host) over the
    rows ``x [N, d]`` (float32, on the run's device), ranked in float64.
    Returns ``(dists [U, k] float64, rows [U, k] int64)`` tensors on
    ``x``'s device, ascending."""
    out_d, out_i = [], []
    for qs in range(0, len(q), q_block):
        qb = torch.from_numpy(q[qs : qs + q_block]).to(x.device, torch.float64)
        d, i = blocked_topk(qb, x, k, lambda a, b: distances64(a, b.double(), metric),
                            x_block)
        out_d.append(d)
        out_i.append(i)
    if not out_d:
        return (torch.zeros((0, k), dtype=torch.float64, device=x.device),
                torch.zeros((0, k), dtype=torch.int64, device=x.device))
    return torch.cat(out_d), torch.cat(out_i)


def tally(q: np.ndarray, x: torch.Tensor, which: np.ndarray,
          ans_rows: np.ndarray, ans_d: np.ndarray, ref_d: torch.Tensor,
          ref_rows: torch.Tensor, metric: str, block: int = 1024) -> dict:
    """What ``A`` answers over one live set add to the numbers: answer
    ``a`` is to query ``q[which[a]]``, its rows ``ans_rows[a]`` (-1: an id
    no live row has) and distances ``ans_d[a]``; ``ref_d``, ``ref_rows``
    are ``exact_topk`` of ``q`` over ``x``. Returns ``{"bad_rows",
    "dist_err", "rank_gap", "hits", "answers"}``: the widest gaps over the
    answers that are not bad, and the reference rows found."""
    dev = x.device
    a_n, k = ans_rows.shape
    srt = np.sort(ans_rows, axis=1)
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    finite = np.isfinite(ans_d)
    desc = (np.diff(np.where(finite, ans_d, np.inf), axis=1) < 0).any(1)
    bad = (ans_rows < 0).any(1) | dup | ~finite.all(1) | desc
    dist_err = rank_gap = 0.0
    hits = 0
    for s in range(0, a_n, block):
        sl = slice(s, s + block)
        w = torch.from_numpy(which[sl]).to(dev)
        rr = torch.from_numpy(ans_rows[sl]).to(dev)
        known = rr >= 0
        qb = torch.from_numpy(q[which[sl]]).to(dev, torch.float64)
        d64 = row_distances64(qb, x[rr.clamp(min=0)].double(), metric)
        ad = torch.from_numpy(ans_d[sl]).to(dev, torch.float64)
        ok = known & torch.isfinite(ad)
        if bool(ok.any()):
            dist_err = max(dist_err, float((ad - d64).abs()[ok].max()))
        good = torch.from_numpy(~bad[sl]).to(dev)
        if bool(good.any()):
            gap = (d64 - ref_d[w])[good]
            rank_gap = max(rank_gap, float(gap.max()))
        # each reference row found counts once, however often it is returned
        hits += int((ref_rows[w][:, :, None] == rr[:, None, :]).any(2).sum())
    return {"bad_rows": int(bad.sum()), "dist_err": dist_err,
            "rank_gap": rank_gap, "hits": hits, "answers": a_n}


def pool(tallies: list[dict], k: int) -> dict:
    """The numbers of a run from the ``tally`` of each live state: bad
    answers summed, the widest ``dist_err`` and ``rank_gap``, and
    ``miss_at_<k>`` over every answer judged (reference rows missed over
    answers x k, not a mean of the states' shares)."""
    answers = sum(t["answers"] for t in tallies)
    hits = sum(t["hits"] for t in tallies)
    return {"bad_rows": sum(t["bad_rows"] for t in tallies),
            "dist_err": max([0.0, *(t["dist_err"] for t in tallies)]),
            "rank_gap": max([0.0, *(t["rank_gap"] for t in tallies)]),
            f"miss_at_{k}": 1.0 - hits / max(answers * k, 1)}


def judge(q: np.ndarray, x: torch.Tensor, which: np.ndarray,
          ans_rows: np.ndarray, ans_d: np.ndarray, ref_d: torch.Tensor,
          ref_rows: torch.Tensor, metric: str, block: int = 1024) -> dict:
    """The numbers of ``A`` answers over one live set (``tally``'s
    arguments): ``{"bad_rows", "dist_err", "rank_gap", "miss_at_<k>"}``
    (the last three over the answers that are not bad, with ``miss`` over
    all)."""
    return pool([tally(q, x, which, ans_rows, ans_d, ref_d, ref_rows, metric,
                       block)], ans_rows.shape[1])
