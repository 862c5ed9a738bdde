"""Epoch persistence: serialize a StreamingEngine epoch, restart warm; port
of ``repro.ooc.snapshot``.

A :class:`GraphCheckpoint` rides on
:class:`repro_torch.ckpt.manager.CheckpointManager` (atomic tmp+rename
publish, async writer, keep-N GC) and captures one epoch of a
:class:`repro_torch.stream.StreamingEngine`, in the reference's tree and
meta (``FORMAT``), so an epoch written by either package loads in the
other:

  * the live base edge set in ORIGINAL vertex ids (the COO truth from
    ``EdgeStore.live_base``, a tuple: the checkpoint's treedef round trip
    runs on every save and restore);
  * the converged fixpoint values (original ids);
  * the tile-row mirror, the PSD/calm activity state, the partition order,
    degrees, block-coupling counts and aux: the epoch's audit record.

Restore (``StreamingEngine.restore``) rebuilds the epoch's geometry from
the checkpointed COO (``build_plan`` is a pure function of the edge set and
config, the path every overflow batch takes) and warm-starts from the
checkpointed values: the verification pass re-heats every block once, but
from a fixpoint the deltas die at once. Restore reads only the COO and the
values, so a checkpoint written under one residency budget restores under
any other.

Snapshots capture fixpoints: ``StreamingEngine`` reconverges at the end of
every ingest, so ``save_epoch`` between batches is consistent. Under a
budget the tile truth comes from the host mirror (``MutableTiledState``),
which spilling never touches: saving never pages spilled blocks back in.
"""
from __future__ import annotations

import numpy as np

from repro_torch.ckpt.manager import CheckpointManager

FORMAT = "graph-epoch-v1"


class GraphCheckpoint:
    """Epoch checkpoint store for a StreamingEngine (see module doc)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.manager = CheckpointManager(directory, keep=keep,
                                         async_write=async_write)

    # -- write ---------------------------------------------------------------
    def save(self, streaming, step: int | None = None) -> int:
        """Serialize the engine's current epoch. ``step`` defaults to the
        epoch counter (one checkpoint per ingest generation)."""
        eng = streaming.engine
        plan = eng.plan
        ps, pd, w = streaming.store.live_base()
        step = streaming.epoch if step is None else int(step)
        psd = (eng.last_psd if eng.last_psd is not None
               else np.zeros((plan.num_blocks, eng.config.subblocks),
                             np.float32))
        calm = (eng.last_calm if eng.last_calm is not None
                else np.zeros_like(psd, dtype=np.int32))
        tiles = streaming.tiles
        tree = {
            # original-id COO truth, a TUPLE (the treedef round trip)
            "edges": (plan.order[ps].astype(np.int64),
                      plan.order[pd].astype(np.int64),
                      np.asarray(w, dtype=np.float32)),
            "values": np.asarray(streaming.values),
            "plan": {"order": plan.order.astype(np.int64)},
            "tiles": {"src": tiles.src, "dst_local": tiles.dstl,
                      "w": tiles.w, "valid": tiles.valid,
                      "fill": tiles.fill, "live": tiles.live},
            "state": {"psd": np.asarray(psd, np.float32),
                      "calm": np.asarray(calm, np.int32)},
            "degrees": {"out": streaming.out_deg, "in": streaming.in_deg},
            "coupling": streaming.W,
            "aux": streaming._aux,
        }
        self.manager.save(step, tree, extra_meta={
            "format": FORMAT, "epoch": int(streaming.epoch),
            "n": int(streaming.n),
            "num_blocks": int(plan.num_blocks),
            "block_size": int(plan.block_size),
            "subblocks": int(eng.config.subblocks),
            "program": type(streaming.program).__name__})
        return step

    def wait(self) -> None:
        self.manager.wait()

    # -- read ----------------------------------------------------------------
    def load(self, step: int | None = None) -> tuple[dict, dict]:
        """(tree, meta) of the requested (default: latest) epoch."""
        tree, meta = self.manager.restore(step)
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{self.manager.dir} step {meta.get('step')} is not a "
                f"graph epoch checkpoint (format={meta.get('format')!r})")
        return tree, meta
