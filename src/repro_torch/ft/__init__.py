"""Fault-tolerance bookkeeping (port of ``repro.ft``)."""
from repro_torch.ft.straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
