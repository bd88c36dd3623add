"""Where the port's Node2Vec spends its time on one CUDA card, and where its
host trainer and device route cross over.

    python3 tools/probes/node2vec_probe.py [--out PATH] [--no-routing]
        [--no-phase] [--index]

- The node2vec treatment (``benchmarks/harness/treatments.py:488-508``:
  Erdos-Renyi at mean degree 5, dim 32, 2 walks of 20 a node, 1 epoch,
  walker batches of 1,024) at 500 to 64,000 nodes: the host trainer against
  the device route, the median of 3 calls after a warm call each
  (``chip_smoke.n2v_route_times``), the host's cost per (pair x dim) unit
  and the node count where the device catches up, interpolated between the
  two sizes around it. ``graph/routing.py``'s ``COST_SGNS_PAIR_DIM`` and
  ``HOST_N2V_SECONDS`` come from here.
  Skipped with ``--no-routing``.
- Unless ``--no-phase``: ``chip_smoke.node2vec_phase``, phase 19 at
  BASELINE.json configs[3] (1M nodes, embeddings into ``HnswIndex``), with
  its profiles of one walk batch and of 64 SGNS chunks.
- With ``--index``: ``HnswIndex`` at 1M x 64 cosine rows, built in bf16
  (the default) or f32 (``build_precision="highest"``) and searched with
  bf16 guidance or in f32 (``search_bf16``), the share of 2,048 sampled
  rows whose own id comes first at ef 20 (the default for k=10), 64, 128
  and 256, over three sets of rows: random unit rows; a cone of them (one
  shared unit direction plus 0.035 times a random unit row, normalised:
  the norm of the mean row near phase 19's); and phase 19's embeddings.
  Also the singular values of those embeddings around their mean row.

With ``--out``, writes the whole record there as JSON. Every line names the
card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SIZES = (500, 1_000, 2_000, 4_000, 8_000, 16_000, 32_000, 64_000)


def units(n: int) -> float:
    """The host trainer's (pair x dim) units at the treatment's settings."""
    tr = cs.N2V_TREATMENT
    return (tr["epochs"] * tr["num_walks"] * n * tr["walk_length"]
            * 2 * 5 * (5 + 1) * tr["dim"])


def crossover(rows: list[dict]) -> float | None:
    """The node count where device time first falls to host time, by
    log-log interpolation of the ratio between the two sizes around it."""
    for a, b in zip(rows, rows[1:]):
        ra = math.log(a["device_s"] / a["host_s"])
        rb = math.log(b["device_s"] / b["host_s"])
        if ra > 0 >= rb:
            t = ra / (ra - rb)
            return math.exp(math.log(a["nodes"])
                            + t * (math.log(b["nodes"]) - math.log(a["nodes"])))
    return None


def self_retrieval(name: str, x, configs, qrows) -> list[dict]:
    """Each (build_precision, search_bf16) index over ``x``: its insert
    seconds and the share of ``qrows`` found first, by ef."""
    from muninn_tpu_torch import HnswIndex

    n = x.shape[0]
    rows = []
    for build, bf16 in configs:
        idx = HnswIndex(x.shape[1], "cosine")
        idx.build_precision = build
        idx.search_bf16 = bf16
        _, insert_s = cs.timed_s(lambda: idx.insert(np.arange(1, n + 1), x))
        found = {}
        for ef in (None, 64, 128, 256):
            ids, _ = idx.search(x[qrows], k=10, ef_search=ef)
            found[ef or 20] = float((ids[:, 0] == qrows + 1).mean())
        rows.append({"rows": name, "build_precision": build,
                     "search_bf16": bf16, "insert_s": insert_s,
                     "self_first_by_ef": found})
        print(rows[-1], flush=True)
        del idx
        torch.cuda.empty_cache()
    return rows


def index_study() -> dict:
    """``--index``: see the module docstring."""
    from muninn_tpu_torch.graph import Graph
    from muninn_tpu_torch.models import node2vec as n2v

    n, dim = cs.N2V_NODES, cs.N2V_TRAIN["dim"]
    r = np.random.default_rng(0)
    qrows = np.sort(r.choice(n, cs.N2V_SELF_QUERIES, replace=False))
    every = (("default", True), ("highest", True), ("highest", False))
    base = cs.unit_rows(r.standard_normal((n, dim), dtype=np.float32))
    out = {"random": self_retrieval("random", base, every, qrows)}
    lead = cs.unit_rows(r.standard_normal((1, dim), dtype=np.float32))
    cone = cs.unit_rows(lead + 0.035 * base)
    out["cone_mean_row_norm"] = float(np.linalg.norm(cone.mean(0)))
    out["cone"] = self_retrieval("cone", cone, every, qrows)
    del base, cone
    src, dst = cs.planted_edges(n, cs.N2V_EDGES, seed=19)
    g = Graph.from_device_edges(src, dst, num_nodes=n)
    _, emb = n2v.node2vec_train(g, **cs.N2V_TRAIN)
    del g, src, dst
    out["node2vec_mean_row_norm"] = float(np.linalg.norm(emb.mean(0)))
    res = torch.from_numpy(emb - emb.mean(0)).cuda()
    sv = torch.linalg.svdvals(res[:200_000])
    out["node2vec_residual_singular_values"] = [float(v) for v in sv[:8]]
    out["node2vec_residual_top5_share"] = float((sv[:5] ** 2).sum()
                                                / (sv ** 2).sum())
    del res
    out["node2vec"] = self_retrieval("node2vec", emb, every, qrows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--no-routing", action="store_true")
    ap.add_argument("--no-phase", action="store_true")
    ap.add_argument("--index", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("node2vec_probe: no CUDA device", file=sys.stderr)
        return 2
    from muninn_tpu_torch import native

    card = cs.card_line()
    print(card, flush=True)
    if not native.graph_available():
        print("node2vec_probe: the host engine did not build", file=sys.stderr)
        return 1
    out = {"card": card}
    if not args.no_routing:
        rows = []
        for n in SIZES:
            r = cs.n2v_route_times(n)
            r["host_s_per_unit"] = r["host_s"] / units(n)
            rows.append(r)
            print(f"{card}: treatment at {n:,} nodes: host"
                  f" {r['host_s'] * 1e3:.2f} ms"
                  f" ({r['host_s_per_unit'] * 1e9:.3f} ns a pair x dim unit),"
                  f" device {r['device_s'] * 1e3:.2f} ms; auto ->"
                  f" {'host' if r['auto_host'] else 'device'}", flush=True)
        out.update(routing=rows, crossover_nodes=crossover(rows))
        print(f"{card}: the device catches up near {out['crossover_nodes']}"
              " nodes", flush=True)
    if not args.no_phase:
        out["phase"] = cs.node2vec_phase()
        print(json.dumps({"node2vec": out["phase"]}), flush=True)
    if args.index:
        out["index"] = index_study()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
