"""Graph analytics over a device-resident CSR: the port of
``muninn_tpu.graph`` (the reference's src/graph_load.c, src/graph_csr.c and
src/graph_tvf.c).

So far it carries ``Graph`` with BFS, DFS, shortest paths, connected
components and PageRank; centrality, communities, the selector and
``GraphCache`` are not ported yet.
"""

from muninn_tpu_torch.graph.api import Graph
from muninn_tpu_torch.graph.core import NodeTable, DeviceCsr

__all__ = ["Graph", "NodeTable", "DeviceCsr"]
