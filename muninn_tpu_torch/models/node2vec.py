"""Node2Vec: batched p/q-biased random walks and SGNS on the graph's device.

The port's copy of ``muninn_tpu.models.node2vec`` (a re-design of the
reference's ``src/node2vec.c``), with the same semantics. The JAX module has
no Pallas kernel, so this one is plain torch:

- **Walks.** All walkers advance together. A step draws a weighted
  neighbour for every walker (a binary search of the row's per-row weight
  prefix sums) and applies the second-order p/q bias by rejection sampling:
  a candidate c from cur is accepted with probability bias(c)/max_bias,
  where bias is 1/p if c is prev, 1 if c is a neighbour of prev (a binary
  search of prev's dst-sorted row) and 1/q otherwise. ``rejection_rounds``
  rounds; the first accepted candidate wins, and with none accepted the
  walker takes the first round's candidate. p = q = 1 is DeepWalk.
- **SGNS.** (center, context) pairs come from the walk rows by window
  shifts, negatives from a unigram^0.75 table of ``NEG_TABLE_SIZE``
  entries, and each chunk of walker rows is one gather, sigmoid and
  scatter-add step, each row's update divided by its occurrences in the
  chunk. The learning rate decays linearly to a floor.

Where the port differs from JAX, the results do not:

- random draws come from a ``torch.Generator`` on the graph's device,
  seeded by ``seed``; its streams differ from ``jax.random``'s, so walks
  and embeddings agree with JAX's in distribution, not bit for bit;
- a step's rejection rounds are drawn and searched together, as ``[R, W]``
  arrays (JAX loops over them);
- a binary search stops after ``max_deg.bit_length() + 1`` iterations,
  where JAX runs 32: a row holds at most ``max_deg`` entries, the interval
  at least halves each iteration, and once it is empty the bound moves at
  most once more (:func:`search_iters`).

On a CUDA graph every step runs on the card; ``index_add_`` of float32
there is atomic, so two runs differ in the last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from muninn_tpu_torch import native
from muninn_tpu_torch.graph import routing
from muninn_tpu_torch.graph.routing import use_host
from muninn_tpu_torch.ops.segments import n_passes_for, seg_positions

NEG_TABLE_SIZE = 100_000  # matches reference, src/node2vec.c:274-303
#: JAX's fixed binary-search iteration count (E < 2**31)
SEARCH_ITERS = 32


# ───────────────────────── walks ─────────────────────────


def _row_sorted_cumw(src, dst, w, offsets, max_deg: int):
    """Walk-table prep from a (src-sorted, padded) CSR: sort each row by
    dst (two stable sorts == lexsort(dst within src); pads src=V stay last)
    and compute PER-ROW inclusive float32 prefix sums of the weights by
    shift doubling over in-row positions. Row-local sums stay
    f32-accurate at any edge count: a global cumsum loses edge-weight
    resolution once the running total passes 2^24."""
    o1 = torch.sort(dst, stable=True).indices
    o2 = torch.sort(src.index_select(0, o1), stable=True).indices
    order = o1.index_select(0, o2)
    del o1, o2
    # the stable re-sort keeps src groups in their CSR ranges, so offsets
    # still delimit rows; pads (src=V, w=0) stay last and sum only each other
    x = w.index_select(0, order)
    e_pad = x.shape[0]
    spos = seg_positions(offsets, e_pad)
    for j in range(n_passes_for(max_deg)):
        sh = 1 << j
        if sh >= e_pad:
            break
        prev = torch.cat([x.new_zeros(sh), x[:-sh]])
        x = torch.where(spos >= sh, x + prev, x)
    return dst.index_select(0, order), x


def search_iters(max_deg: int | None) -> int:
    """Binary-search iterations that give JAX's 32-iteration answer over
    rows of at most ``max_deg`` entries: the interval [lo, hi) at least
    halves each iteration, so it is empty after ``max_deg.bit_length()``,
    and an empty one moves ``lo`` at most once more (to hi + 1, a fixed
    point). ``None`` gives JAX's 32."""
    if max_deg is None:
        return SEARCH_ITERS
    return min(SEARCH_ITERS, int(max_deg).bit_length() + 1)


def _searchsorted_segment(arr, lo, hi, target, iters: int = SEARCH_ITERS):
    """Vectorized binary search, JAX's loop lane by lane: the smallest e in
    [lo, hi) with ``arr[e] >= target`` (lo, hi int64, any shape; reads
    clamped into ``arr``, as JAX's gathers clamp)."""
    last = arr.shape[0] - 1
    for _ in range(iters):
        mid = (lo + hi) // 2
        go_right = arr[mid.clamp(0, last)] < target
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _is_neighbor(sorted_dst, offsets, u, c, iters: int = SEARCH_ITERS):
    """Membership of c in N(u), by binary search over u's sorted CSR row
    (replaces the reference's linear scan, :154-161). ``offsets`` int64;
    rows may hold a node twice."""
    lo0 = offsets[u]
    hi0 = offsets[u + 1]
    lo = _searchsorted_segment(sorted_dst, lo0, hi0, c, iters)
    found = (lo < hi0) & (lo >= lo0)
    val = sorted_dst[lo.clamp(0, sorted_dst.shape[0] - 1)]
    return found & (val == c)


def biased_walks(
    gen: torch.Generator,
    offsets: torch.Tensor,   # [V+1] int32 (row-sorted CSR, dst ascending)
    dst: torch.Tensor,       # [E] int32
    cumw: torch.Tensor,      # [E] f32 per-row inclusive weight prefix sums
    starts: torch.Tensor,    # [W] int32 start nodes
    num_nodes: int,
    walk_length: int,
    p: float,
    q: float,
    rejection_rounds: int = 4,
    max_deg: int | None = None,
) -> torch.Tensor:
    """Second-order walks [W, walk_length+1] int32, on ``starts``' device.
    Dead ends (deg 0) repeat in place, mirroring the reference's early walk
    termination. ``max_deg`` (the CSR's longest row, or a bound on it)
    shortens the binary searches to :func:`search_iters`; None searches as
    JAX does. Draws come from ``gen``."""
    if rejection_rounds < 1:
        raise ValueError("rejection_rounds must be >= 1")
    dev = starts.device
    w_count = starts.shape[0]
    inv_p = 1.0 / p
    inv_q = 1.0 / q
    max_bias = max(inv_p, 1.0, inv_q)
    iters = search_iters(max_deg)
    off = offsets.long()
    last = dst.shape[0] - 1

    def sample_neighbor(cur, u):
        """Weighted neighbour draw for each walker at cur (cumw is
        row-local, so the draw is base-free and f32-exact)."""
        lo = off[cur]
        hi = off[cur + 1]
        total = cumw[(hi - 1).clamp(min=0)]
        target = u * total.clamp(min=1e-30)
        e = _searchsorted_segment(cumw, lo, hi, target, iters)
        e = torch.minimum(torch.maximum(e, lo), torch.maximum(hi - 1, lo))
        cand = dst[e.clamp(0, last)].long()
        return torch.where(hi > lo, cand, cur)

    out = torch.empty((max(walk_length, 1) + 1, w_count), dtype=torch.int32,
                      device=dev)
    prev = starts.long()
    # first hop: plain weighted draw (no prev yet)
    cur = sample_neighbor(
        prev, torch.rand(w_count, generator=gen, device=dev))
    out[0] = prev
    out[1] = cur
    shape = (rejection_rounds, w_count)
    for t in range(2, walk_length + 1):
        u = torch.rand((2,) + shape, generator=gen, device=dev)
        cand = sample_neighbor(cur.expand(shape), u[0])          # [R, W]
        prev_r = prev.expand(shape)
        bias = torch.where(
            cand == prev_r, inv_p,
            torch.where(_is_neighbor(dst, off, prev_r, cand, iters), 1.0,
                        inv_q))
        ok = u[1] < bias / max_bias
        # the first accepted round; none accepted -> round 0 (JAX's
        # fallback draw repeats round 0's key)
        pick = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
        prev, cur = cur, cand.gather(0, pick)[0]
        out[t] = cur
    return out.T.contiguous()


# ───────────────────────── SGNS ─────────────────────────


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def build_negative_table(
    degrees: np.ndarray, size: int = NEG_TABLE_SIZE, power: float = 0.75
) -> np.ndarray:
    """Unigram^0.75 sampling table (src/node2vec.c:274-303).

    Built by inverse-CDF stratification (size evenly spaced quantiles of
    the cumulative p^0.75 mass) rather than the reference's repeat-and
    -truncate: with V > size, per-node `max(count, 1)` repeats truncate
    to the FIRST `size` nodes — at 1M nodes only ids < ~100k would ever
    be drawn as negatives, silently skewing every embedding."""
    p = np.maximum(degrees.astype(np.float64), 0) ** power
    if p.sum() <= 0:
        p = np.ones_like(p)
    cdf = np.cumsum(p)
    q = (np.arange(size, dtype=np.float64) + 0.5) / size * cdf[-1]
    return np.searchsorted(cdf, q, side="right").astype(np.int32)


def _pairs(walks: torch.Tensor, window: int):
    """(center, context) int64 [P] of every window offset 1..window:
    centres ``a`` then ``b`` per offset, concatenated in JAX's order."""
    l1 = walks.shape[1]
    centers, contexts = [], []
    for off in range(1, window + 1):
        if off >= l1:
            break
        a = walks[:, :-off].reshape(-1)
        b = walks[:, off:].reshape(-1)
        centers += [a, b]
        contexts += [b, a]
    return torch.cat(centers).long(), torch.cat(contexts).long()


def _pair_count(w_count: int, l1: int, window: int) -> int:
    """P of :func:`_pairs` for ``w_count`` walks of ``l1`` nodes."""
    return sum(2 * w_count * (l1 - off)
               for off in range(1, min(window, l1 - 1) + 1))


def _draw_negatives(neg_table: torch.Tensor, gen: torch.Generator,
                    pcount: int, neg_samples: int) -> torch.Tensor:
    """[P, K] negatives: ``neg_table`` at uniform random positions."""
    pos = torch.randint(0, neg_table.shape[0], (pcount, neg_samples),
                        generator=gen, device=neg_table.device)
    return neg_table[pos]


def _sgns_apply(syn0, syn1, walks, negs, lr: float, window: int):
    """The SGNS update of one walk chunk with the given negatives
    ``negs [P, K]``, in place: every (center, context) pair's gradient
    from the pre-update rows, each row's summed update divided by its
    occurrences in the chunk (JAX's normalisation), three scatter-adds.
    Returns (syn0, syn1)."""
    center, context = _pairs(walks, window)
    negs = negs.long()
    v = syn0[center]                                  # [P, D]
    upos = syn1[context]                              # [P, D]
    uneg = syn1[negs]                                 # [P, K, D]
    pos_logit = (v * upos).sum(-1)                    # [P]
    neg_logit = (v[:, None, :] * uneg).sum(-1)        # [P, K]
    gpos = torch.sigmoid(pos_logit) - 1.0
    gneg = torch.sigmoid(neg_logit)
    dv = gpos[:, None] * upos + (gneg[:, :, None] * uneg).sum(1)
    dupos = gpos[:, None] * v
    duneg = gneg[:, :, None] * v[:, None, :]
    del uneg
    vcount = syn0.shape[0]
    negs_flat = negs.reshape(-1)
    cnt0 = torch.bincount(center, minlength=vcount)
    cnt1 = (torch.bincount(context, minlength=vcount)
            + torch.bincount(negs_flat, minlength=vcount))
    dv = dv / cnt0[center].clamp(min=1)[:, None]
    dupos = dupos / cnt1[context].clamp(min=1)[:, None]
    duneg = duneg / cnt1[negs].clamp(min=1)[:, :, None]
    syn0.index_add_(0, center, dv, alpha=-lr)
    syn1.index_add_(0, context, dupos, alpha=-lr)
    syn1.index_add_(0, negs_flat, duneg.reshape(-1, v.shape[-1]), alpha=-lr)
    return syn0, syn1


def _sgns_update(syn0, syn1, walks, neg_table, gen, lr: float, window: int,
                 neg_samples: int):
    """Draw the chunk's negatives, then :func:`_sgns_apply`."""
    pcount = _pair_count(walks.shape[0], walks.shape[1], window)
    negs = _draw_negatives(neg_table, gen, pcount, neg_samples)
    return _sgns_apply(syn0, syn1, walks, negs, lr, window)


def sgns_step(syn0, syn1, walks, neg_table, gen, lr: float, window: int,
              neg_samples: int):
    """One SGNS update over a walk batch, in place (the single-chunk form
    of :func:`sgns_walk_batch`)."""
    return _sgns_update(syn0, syn1, walks, neg_table, gen, lr, window,
                        neg_samples)


def sgns_walk_batch(syn0, syn1, walks, neg_table, gen, lr: float,
                    window: int, neg_samples: int, chunk: int):
    """SGNS over a whole walk batch, chunk by chunk of walker rows
    (bounds the [P, K, D] peak), in place. ``walks.shape[0] % chunk``
    must be 0."""
    w = walks.shape[0]
    if w % chunk:
        raise ValueError(f"walk rows {w} are not a multiple of chunk {chunk}")
    for s in range(0, w, chunk):
        _sgns_update(syn0, syn1, walks[s:s + chunk], neg_table, gen, lr,
                     window, neg_samples)
    return syn0, syn1


# ───────────────────────── training ─────────────────────────


def host_estimate_s(v_count: int, dim: int, num_walks: int, walk_length: int,
                    window: int, neg_samples: int, epochs: int) -> float:
    """The host trainer's estimated seconds: its (pair x dim) units times
    ``routing.COST_SGNS_PAIR_DIM``."""
    return (
        float(epochs) * num_walks * max(v_count, 1) * walk_length
        * 2 * window * (neg_samples + 1) * dim
    ) * routing.COST_SGNS_PAIR_DIM


def _finish(graph, emb: np.ndarray, output_index):
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.maximum(norms, 1e-12)
    node_ids = list(graph.nodes.ids)
    if output_index is not None:
        output_index.insert(np.arange(1, graph.num_nodes + 1), emb)
    return node_ids, emb


def node2vec_train(
    graph,
    dim: int = 64,
    *,
    p: float = 1.0,
    q: float = 1.0,
    num_walks: int = 10,
    walk_length: int = 80,
    window: int = 5,
    neg_samples: int = 5,
    learning_rate: float = 0.025,
    epochs: int = 5,
    seed: int = 1,
    walk_batch: int = 4096,
    sgns_chunk: int = 256,
    output_index=None,
    backend: str = "auto",
):
    """Train Node2Vec embeddings over an (undirected) graph.

    Mirrors ``node2vec_train(edge_table, src, dst, output, dim, p, q,
    num_walks, walk_length, window, neg_samples, lr, epochs)``
    (``src/node2vec.c:399-590``, ``docs/api.md:568-600``) as keyword
    arguments. ``graph`` is a ``muninn_tpu_torch.Graph``; edges are treated
    as undirected like the reference's loader (``:112-138``). The device
    route runs on the graph's device; ``backend`` is 'auto' (the host
    trainer while ``graph.routing`` estimates it at most
    ``HOST_N2V_SECONDS``), 'host' or 'device'.

    Returns (node_ids list, embeddings f32 [V, dim] L2-normalized numpy).
    If ``output_index`` (an ``HnswIndex`` or ``FlatIndex``) is given,
    embeddings are inserted with ids 1..V in node-interning order — the
    reference writes rowid = i + 1 (``:539-585``).
    """
    if dim > 1024:
        raise ValueError("dim must be <= 1024 (reference cap)")
    v_count = graph.num_nodes
    est = host_estimate_s(v_count, dim, num_walks, walk_length, window,
                          neg_samples, epochs)
    if v_count and use_host(backend, est, ceiling=routing.HOST_N2V_SECONDS):
        hs, hd, hw = graph.host_coo("both")
        emb = native.node2vec_train_host(
            hs, hd, hw, v_count, dim, p, q, num_walks, walk_length,
            window, neg_samples, learning_rate, epochs, seed,
        )
        if emb is not None:
            return _finish(graph, emb, output_index)
    c = graph.csr("both")
    dev = c.dst.device
    dst_s, cumw = _row_sorted_cumw(c.s(), c.dst, c.w(), c.offsets, c.max_deg)
    neg_table = torch.as_tensor(
        build_negative_table(c.degrees().cpu().numpy()), device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    syn0 = (torch.rand((v_count, dim), generator=gen, device=dev) - 0.5) * (
        1.0 / dim)
    syn1 = torch.zeros((v_count, dim), dtype=torch.float32, device=dev)
    lr_floor = learning_rate * 1e-4
    total_steps = max(epochs * num_walks, 1)
    # every walker batch has one shape: pow2 of v_count capped at
    # walk_batch; a short batch is topped up with random starts (unbiased
    # in expectation, unlike wrapping, which would oversample the first
    # nodes)
    wb = min(walk_batch, _pow2_at_least(v_count))
    for step_i in range(epochs * num_walks):
        lr = max(learning_rate * (1.0 - step_i / total_steps), lr_floor)
        for s in range(0, v_count, wb):
            starts = torch.arange(s, min(s + wb, v_count), dtype=torch.int32,
                                  device=dev)
            short = wb - starts.shape[0]
            if short > 0:
                starts = torch.cat([starts, torch.randint(
                    0, v_count, (short,), generator=gen, device=dev,
                    dtype=torch.int32)])
            walks = biased_walks(gen, c.offsets, dst_s, cumw, starts, v_count,
                                 walk_length, p, q, max_deg=c.max_deg)
            chunk = min(sgns_chunk, walks.shape[0])
            pad = (-walks.shape[0]) % chunk
            if pad:  # a harmless repeat of a few walkers
                walks = torch.cat([walks, walks[:pad]])
            sgns_walk_batch(syn0, syn1, walks, neg_table, gen, lr, window,
                            neg_samples, chunk)
    return _finish(graph, syn0.cpu().numpy(), output_index)
