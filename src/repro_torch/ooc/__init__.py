"""Out-of-core block tier and epoch persistence (port of ``repro.ooc``).

  * :mod:`repro_torch.ooc.store`: :class:`SpillStore`, per-block residency
    over the unified tiled layout. Device memory is a fixed budget of
    resident block slots (``EngineConfig.resident_blocks``); cold blocks'
    edge tile rows are evicted to a host cache or npz segments and fetched
    back before the schedule touches them, so a run under a budget is
    bitwise the fully resident one.
  * :mod:`repro_torch.ooc.prefetch`: the activity-directed policy. The host
    scheduler twin predicts the next superstep's schedule, demand sets are
    protected, and retired/calm blocks (the paper's cold partition) are
    the eviction candidates.
  * :mod:`repro_torch.ooc.snapshot`: :class:`GraphCheckpoint`, epoch
    persistence over :class:`repro_torch.ckpt.manager.CheckpointManager`;
    ``StreamingEngine.save_epoch``/``restore`` restart a served graph warm
    from its last fixpoint.
"""
from repro_torch.ooc.snapshot import GraphCheckpoint
from repro_torch.ooc.store import SpillStore

__all__ = ["GraphCheckpoint", "SpillStore"]
