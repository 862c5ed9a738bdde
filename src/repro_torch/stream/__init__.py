"""Streaming-graph subsystem (port of ``repro.stream``): edge-delta
ingestion over the structure-aware engine, with dirty-(sub-)block re-heat
and warm reconvergence on the card."""
from repro_torch.stream.delta import DeltaBatch, synthetic_stream
from repro_torch.stream.engine import (EpochState, StreamBatchReport,
                                       StreamConfig, StreamingEngine)

__all__ = ["DeltaBatch", "synthetic_stream", "EpochState",
           "StreamBatchReport", "StreamConfig", "StreamingEngine"]
