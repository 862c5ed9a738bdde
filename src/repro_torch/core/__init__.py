"""Structure-aware graph processing, ported to PyTorch (see ``repro.core``).

Public API:
    Graph construction  : graph.powerlaw_graph / core_periphery_graph /
                          uniform_graph / from_edges / load_coo
    Vertex programs     : algorithms.pagerank / sssp / bfs / cc
    Engines             : engine.StructureAwareEngine (paper),
                          baseline.BaselineEngine (Gemini-style)
"""
from repro_torch.core import algorithms, degrees, graph, metrics, partition
from repro_torch.core.baseline import BaselineEngine
from repro_torch.core.engine import EngineConfig, RunResult, \
    StructureAwareEngine

__all__ = [
    "algorithms", "degrees", "graph", "metrics", "partition",
    "BaselineEngine", "EngineConfig", "RunResult", "StructureAwareEngine",
]
