"""muninn-tpu on PyTorch and CUDA: the port of ``muninn_tpu`` to one NVIDIA
H100.

The port goes slice by slice beside the JAX package, which stays the
reference. So far it carries:

- flat KNN: ``FlatIndex`` insert, delete and search at
  ``precision="highest"`` (exact), ``"default"``/``"bfloat16"`` (bf16
  operands), ``"int8_rescored"`` and ``"proj_rescored"`` (an int8 retrieve,
  then an exact f32 rescore), and ``QuantizedFlatIndex`` (int8 storage),
  through the hand-written CUDA kernel ``csrc/flat_topk.cu`` (f32, bf16 and
  int8 operand modes);
- HNSW: ``HnswIndex`` bulk build, insert waves (MN-RU prune, deferred
  upper-level wiring), delete with repair, and search (exact routing, a
  bf16 or int8-guided beam over packed neighbour blocks, exact rescore;
  f32 routing and beam with ``search_bf16 = False``), through
  ``csrc/flat_topk.cu``, ``csrc/flat_topk_mma.cu`` and
  ``csrc/beam_dots.cu``; with bf16 guidance also
  the top-m beam (``beam_topm``, the top-m mode of ``csrc/beam_dots.cu``)
  and the whole beam in one kernel (``beam_whole``, ``csrc/beam_loop.cu``);
- IVF: ``IvfIndex`` build (k-means, balanced cluster blocks of bf16 or
  int8 rows), insert, delete and search (probe selection through
  ``csrc/flat_topk_mma.cu``, block scoring through ``csrc/beam_dots.cu``,
  exact f32 rescore, an exactly scanned pending region);
- checkpoints: ``io.checkpoint`` saves and loads every index kind above in
  the JAX package's format, in both directions, with ``DeltaLog``;
- the row gather ``ops.gather.gather_rows`` (``csrc/gather_rows.cu``),
  which no production path calls, as in the JAX package;
- graph analytics: ``Graph`` (``graph/``) from edge lists or from edges
  already on the card (``from_device_edges``), its CSR in every direction,
  BFS, DFS, shortest paths, connected components, PageRank, degree,
  betweenness (node and edge), closeness, Leiden and modularity as device
  fixpoints and sweeps over ``ops.segments`` (plain torch: the JAX package
  has no Pallas kernel there) or, where ``graph.routing``'s measured
  crossovers say the host is faster, on the port's own copy of the native
  C++ host engine (``native/``, built with g++ at first use into
  ``build/native/``); the node selector ``select``; ``GraphCache``, the
  mutable edge store (delta queue, incremental device-CSR patches,
  block-granular checkpoints in the JAX package's format);
  ``graph.convert`` carries a graph's or a cache's state across from
  either package;
- Node2Vec: ``node2vec_train`` (``models/node2vec.py``), p/q-biased walks
  and SGNS on the graph's device (plain torch: the JAX package has no
  Pallas kernel there), or the host engine's trainer below
  ``graph.routing``'s measured crossover; the embeddings go into an
  ``HnswIndex`` or ``FlatIndex`` when one is given;
- ``pairwise_distances`` (``ops.distance``);
- ``tracing``: spans of every index's ``search`` (recorded only under
  ``torch.profiler``, as ``muninn:`` ranges too) and the counters of kernel
  launches and host reads.

Indexes and graphs live on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``. On a CUDA device every kernel wrapper launches its
kernel; on the CPU it runs its plain PyTorch version. The package imports
``torch`` and numpy, never ``jax`` and never ``muninn_tpu``.
"""

__version__ = "0.9.0"

from muninn_tpu_torch.ops.distance import (  # noqa: F401
    Metric,
    pairwise_distances,
    parse_metric,
)
from muninn_tpu_torch.index.flat import FlatIndex, QuantizedFlatIndex  # noqa: F401
from muninn_tpu_torch.index.hnsw import HnswIndex  # noqa: F401
from muninn_tpu_torch.index.ivf import IvfIndex  # noqa: F401
from muninn_tpu_torch.graph import Graph, GraphCache, select  # noqa: F401
from muninn_tpu_torch.models.node2vec import node2vec_train  # noqa: F401

__all__ = ["Metric", "parse_metric", "pairwise_distances", "FlatIndex",
           "QuantizedFlatIndex", "HnswIndex", "IvfIndex", "Graph",
           "GraphCache", "select", "node2vec_train", "__version__"]
