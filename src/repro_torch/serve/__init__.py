"""Query-serving subsystem (port of ``repro.serve``): batched multi-source
sessions over a live streaming graph (lanes, epoch pinning, activity
priority admission), on the card through the lane sweep kernel."""
from repro_torch.core.algorithms import (LANE_FAMILIES, LaneProgram,
                                         k_personalized_pagerank,
                                         k_source_bfs, k_source_sssp)
from repro_torch.serve.lanes import LaneEngine, LaneResult
from repro_torch.serve.service import Query, QueryResult, QueryService

__all__ = [
    "LANE_FAMILIES", "LaneProgram", "k_source_bfs", "k_source_sssp",
    "k_personalized_pagerank", "LaneEngine", "LaneResult", "Query",
    "QueryResult", "QueryService",
]
