from .engine import Graph, PregelEngine, VertexProgram, rmat_graph
from .programs import PageRank, SSSP

__all__ = ["Graph", "PregelEngine", "VertexProgram", "rmat_graph", "PageRank", "SSSP"]
