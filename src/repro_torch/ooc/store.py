"""SpillStore: per-block residency over the unified tiled layout; port of
``repro.ooc.store``.

Device memory is modelled as a fixed budget of resident block slots
(``EngineConfig.resident_blocks``). A non-resident block's edge tile rows
are really gone from the card: eviction zeroes them in place
(``StructureAwareEngine.clear_edge_rows``) and refreshes the sweep kernel's
run table of the evicted blocks, so their run counts and vertex spans are
empty. Their payload lives in a host cache and/or per-block npz segments
(written by an async single-writer thread in the style of
``repro_torch.ckpt.manager``). The engine demand-fetches every block its
predicted schedule needs before it enqueues the superstep, so the schedule
never changes: a run under a budget is bitwise the fully resident one in
values and algorithmic counters (tests/test_torch_ooc.py).

What spills: the per-block EDGE tile rows (src, dst_local, w, valid; the
O(m) state) with their coverage and run table, which are derived from them.
Vertex values, PSD/calm and aux stay resident: the sweeps pull
``values[src]`` graph-wide, and the activity state is what the prefetch
policy steers by.

Payload source of truth, in priority order:

  1. ``row_source``: a host oracle (the streaming engine wires
     ``MutableTiledState.rows2d`` here), current under ingest;
  2. the host payload cache captured at eviction time (read back from the
     card with ``.cpu()``);
  3. the npz disk segment (with a ``directory`` no host cache is kept,
     ``keep_host`` is False: the graphs-bigger-than-RAM tier). A store with
     a ``row_source`` writes its segments but never reads them.

``on_evict`` fires before the device rows are zeroed, so the serve layer
can preserve pinned epochs (``StreamingEngine.snapshot``); ``materialize``
fills the holes of a copy of the edge state for such pins, refreshing the
copy's run table, without changing residency or the live state.

With a :mod:`repro_torch.obs` recorder installed, evictions and fetches
emit ``spill_evict`` and ``prefetch`` spans (cat ``ooc``, args ``blocks``
and ``bytes``).
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.ooc import prefetch as policy


class _AsyncSegmentWriter:
    """Single daemon writer draining (block, payload) jobs to atomic npz
    segments (tmp + rename, the checkpoint manager's discipline, per block).
    ``wait`` drains the queue; readers call it before reading a segment
    that might still be in flight. ``close`` drains it and stops the
    thread."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def path(self, block: int) -> str:
        return os.path.join(self.dir, f"blk_{block:06d}.npz")

    def submit(self, block: int, payload: dict) -> None:
        if self._closed:
            raise RuntimeError("the spill segment writer is closed")
        self._q.put((block, payload))

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:  # close(): every earlier job is written
                    return
                block, payload = job
                final = self.path(block)
                tmp = final + ".tmp.npz"
                np.savez(tmp, **payload)
                os.replace(tmp, final)  # atomic publish
            finally:
                self._q.task_done()

    def wait(self) -> None:
        self._q.join()

    def close(self) -> None:
        """Write what is queued, then stop the thread (idempotent)."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join()


class SpillStore:
    """Residency tracker and spill tier for one engine epoch."""

    PAYLOAD_FIELDS = ("src", "dst_local", "w", "valid")

    def __init__(self, engine, budget: int, directory: str | None = None):
        plan = engine.plan
        self.engine = engine
        self.num_blocks = int(plan.num_blocks)
        self.budget = int(budget)
        min_budget = int(engine.config.width) + 2  # slate + pad + host pad
        if self.budget < min_budget:
            raise ValueError(
                f"resident_blocks={self.budget} cannot hold one dispatch: "
                f"need >= width + 2 = {min_budget} slots (the scheduled "
                "slate plus the pinned pad blocks)")
        self.resident = np.ones(self.num_blocks, dtype=bool)
        # the pad block fills every slot past the take counts and the host
        # loop pads its slates with block 0: both stay resident
        self.pinned = np.zeros(self.num_blocks, dtype=bool)
        self.pinned[[0, engine.pad_id]] = True
        self.floor = engine._psd_floor()
        self.retire_after = int(engine.config.retire_after)
        ts = plan.unified.tile_start.astype(np.int64)
        tc = plan.unified.tile_cnt.astype(np.int64)
        self._rows = [np.arange(ts[b], ts[b] + tc[b], dtype=np.int64)
                      for b in range(self.num_blocks)]
        self.row_source = None  # callable(rows) -> payload dict, or None
        self.on_evict = None  # pre-invalidation hook (epoch-pin preservation)
        self._cache: dict[int, dict] = {}
        self._writer = (_AsyncSegmentWriter(directory)
                        if directory is not None else None)
        self.keep_host = self._writer is None  # a directory is the tier
        self._zero_counters()

    # -- accounting ----------------------------------------------------------
    def _zero_counters(self) -> None:
        self.spill_evictions = 0
        self.bytes_spilled = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.bytes_fetched = 0

    def begin_run(self) -> None:
        """Reset the per-run counters (residency persists across runs: the
        out-of-core steady state)."""
        self._zero_counters()

    def flush_metrics(self, metrics) -> None:
        metrics.spill_evictions += self.spill_evictions
        metrics.bytes_spilled += self.bytes_spilled
        metrics.prefetch_hits += self.prefetch_hits
        metrics.prefetch_misses += self.prefetch_misses
        metrics.bytes_fetched += self.bytes_fetched

    @property
    def spilled_blocks(self) -> np.ndarray:
        return np.flatnonzero(~self.resident)

    def block_rows(self, block: int) -> np.ndarray:
        return self._rows[block]

    def _payload_bytes(self, rows: int) -> int:
        # 4 B src + 4 B dst offset + 4 B w + 1 B valid per slot
        tile = int(self.engine.plan.unified.src.shape[1])
        return rows * tile * 13

    # -- payload plumbing ----------------------------------------------------
    def _gather_device(self, rows: np.ndarray) -> dict:
        """Read tile rows back off the card (engines without a host oracle
        capture the payload at eviction time)."""
        ed = self.engine.edge_state
        r = torch.as_tensor(rows).to(ed.src.device)
        return {"src": ed.src[r].cpu().numpy(),
                "dst_local": ed.dstl[r].cpu().numpy(),
                "w": ed.w[r].cpu().numpy(),
                "valid": ed.valid[r].cpu().numpy()}

    def _capture(self, blocks: np.ndarray) -> list:
        """The payloads of blocks about to be evicted, one dict a block:
        from the host oracle, else read off the card in one gather."""
        if self.row_source is not None:
            return [self.row_source(self._rows[int(b)]) for b in blocks]
        sizes = [self._rows[int(b)].size for b in blocks]
        got = self._gather_device(
            np.concatenate([self._rows[int(b)] for b in blocks]))
        cuts = np.cumsum(sizes)[:-1]
        return [dict(zip(got, parts)) for parts in
                zip(*(np.split(a, cuts) for a in got.values()))]

    def _payload_of(self, block: int) -> dict:
        """A spilled block's tile rows, from truth > cache > disk segment."""
        if self.row_source is not None:
            return self.row_source(self._rows[block])
        payload = self._cache.get(block)
        if payload is not None:
            return payload
        if self._writer is None:
            raise KeyError(f"no spill payload for block {block}")
        self._writer.wait()  # the segment may still be in flight
        with np.load(self._writer.path(block)) as z:
            return {k: z[k] for k in self.PAYLOAD_FIELDS}

    def _payloads(self, blocks: np.ndarray) -> tuple[np.ndarray, dict]:
        """(rows, payload) of the blocks, concatenated in the given order."""
        parts = [self._payload_of(int(b)) for b in blocks]
        rows = np.concatenate([self._rows[int(b)] for b in blocks])
        return rows, {f: np.concatenate([p[f] for p in parts])
                      for f in self.PAYLOAD_FIELDS}

    # -- residency transitions ----------------------------------------------
    def evict(self, blocks: np.ndarray) -> None:
        """Move blocks' tile rows off the card: capture the payload, stage
        the disk segment (async), then zero the rows on the card and empty
        the blocks' run table: the rows are really gone, not just masked in
        host bookkeeping."""
        blocks = np.asarray(blocks, dtype=np.int64)
        blocks = blocks[self.resident[blocks] & ~self.pinned[blocks]]
        if blocks.size == 0:
            return
        with obs_trace.span("spill_evict", cat="ooc",
                            blocks=int(blocks.size)) as sp:
            if self.on_evict is not None:
                self.on_evict()  # pins copy the epoch before rows vanish
            all_rows = []
            spilled0 = self.bytes_spilled
            keep = self.row_source is None or self._writer is not None
            payloads = self._capture(blocks) if keep else [None] * blocks.size
            for b, payload in zip(blocks.tolist(), payloads):
                rows = self._rows[b]
                if keep:
                    if self.keep_host:
                        self._cache[b] = payload
                    if self._writer is not None:
                        self._writer.submit(b, payload)
                self.resident[b] = False
                self.bytes_spilled += self._payload_bytes(rows.size)
                all_rows.append(rows)
            self.spill_evictions += int(blocks.size)
            self.engine.clear_edge_rows(np.concatenate(all_rows))
            sp.set(bytes=int(self.bytes_spilled - spilled0))

    def fetch(self, blocks: np.ndarray) -> None:
        """Copy blocks' true tile rows back into the live edge state (their
        run table refreshed) and mark them resident."""
        blocks = np.asarray(blocks, dtype=np.int64)
        blocks = blocks[~self.resident[blocks]]
        if blocks.size == 0:
            return
        with obs_trace.span("prefetch", cat="ooc",
                            blocks=int(blocks.size)) as sp:
            rows, payload = self._payloads(blocks)
            for b in blocks:
                self.resident[int(b)] = True
                self._cache.pop(int(b), None)
            fetched = self.engine.update_edge_rows(rows, **payload)
            self.bytes_fetched += fetched
            sp.set(bytes=int(fetched))

    # -- the per-superstep / per-boundary driver entry points ---------------
    def admit(self, need: np.ndarray, psd_blk: np.ndarray,
              calm_blk: np.ndarray | None) -> None:
        """Make the demand set resident before the superstep runs, evicting
        the calmest unprotected residents if the budget is full. It also
        enforces the budget itself (the first admit of a fresh engine spills
        the initial fully resident state down to the slot count). Counts
        hits (needed and already resident) and misses (demand fetches the
        prefetcher failed to stage)."""
        need = np.asarray(need, dtype=np.int64)
        have = self.resident[need]
        self.prefetch_hits += int(have.sum())
        self.prefetch_misses += int(need.size - have.sum())
        missing = need[~have]
        protect = self.pinned.copy()
        protect[need] = True
        over = int(self.resident.sum()) + int(missing.size) - self.budget
        if over > 0:
            victims = policy.rank_victims(
                psd_blk, policy.fold_calm(calm_blk), self.resident, protect,
                self.retire_after, retired_only=False)
            self.evict(victims[:over])
        if missing.size:
            self.fetch(missing)

    def prefetch_boundary(self, need_next: np.ndarray, psd_blk: np.ndarray,
                          calm_blk: np.ndarray | None) -> int:
        """Repartition-boundary prefetch: stage the predicted next demand
        plus the hottest non-resident blocks beyond it, filling free slots
        first and then swapping out RETIRED residents only (a speculative
        fetch never evicts the live active set). Returns the number of
        blocks staged."""
        calm_blk = policy.fold_calm(calm_blk)
        need_next = np.asarray(need_next, dtype=np.int64)
        protect = self.pinned.copy()
        protect[need_next] = True
        cand = policy.rank_fetch_candidates(psd_blk, self.resident,
                                            self.floor)
        # demand first (free, exact), then speculation by PSD rank
        cand = np.concatenate(
            [need_next[~self.resident[need_next]],
             cand[~np.isin(cand, need_next)]])
        staged: list[int] = []
        free = self.budget - int(self.resident.sum())
        victims = policy.rank_victims(psd_blk, calm_blk, self.resident,
                                      protect, self.retire_after,
                                      retired_only=True)
        vi = 0
        for b in cand:
            if free > 0:
                free -= 1
            elif vi < victims.size:
                self.evict(victims[vi:vi + 1])
                vi += 1
            else:
                break
            staged.append(int(b))
        if staged:
            self.fetch(np.asarray(staged, dtype=np.int64))
        return len(staged)

    # -- epoch-pin support ---------------------------------------------------
    def materialize(self, ed):
        """Fill the spilled holes of ``ed``, a COPY of the live edge state
        (``edge_snapshot``'s clone of all twelve fields), with the true tile
        rows and refresh the copy's run table of those blocks: what a pinned
        epoch reads, so snapshot isolation survives eviction. Residency and
        the live state are unchanged."""
        blocks = self.spilled_blocks
        if blocks.size:
            rows, payload = self._payloads(blocks)
            self.engine.fill_edge_rows(ed, rows, **payload)
        return ed

    def wait(self) -> None:
        """Drain the async segment writer (tests, clean shutdown)."""
        if self._writer is not None:
            self._writer.wait()

    def close(self) -> None:
        """Drain and stop the async segment writer: every segment is on
        disk once it returns, so the directory may go. Call it when the
        store is done with (an epoch rebuild replaces the engine, or at
        teardown); a later eviction raises, while reads still work."""
        if self._writer is not None:
            self._writer.close()
