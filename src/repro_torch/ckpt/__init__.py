"""Checkpointing (port of ``repro.ckpt``): the atomic, async, keep-N
manager under epoch persistence (:mod:`repro_torch.ooc.snapshot`)."""
from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
