"""Graph analytics over a device-resident CSR: the port of
``muninn_tpu.graph`` (the reference's src/graph_load.c, src/graph_csr.c,
src/graph_tvf.c, src/graph_centrality.c, src/graph_community.c,
src/graph_adjacency.c and src/graph_selector_*.c).

It carries ``Graph`` with BFS, DFS, shortest paths, connected components,
PageRank, degree, betweenness (node and edge), closeness, Leiden and
modularity; the node selector ``select``; and ``GraphCache``, the mutable
edge store with its delta queue, incremental device-CSR patches and
block-granular checkpoints. Each analytic runs on the graph's device (the
card unless the caller asks for the CPU) or on the port's C++ host engine,
by ``routing``'s measured crossovers.
"""

from muninn_tpu_torch.graph.adjacency import GraphCache
from muninn_tpu_torch.graph.api import Graph
from muninn_tpu_torch.graph.core import NodeTable, DeviceCsr
from muninn_tpu_torch.graph.selector import select

__all__ = ["Graph", "GraphCache", "NodeTable", "DeviceCsr", "select"]
