"""Incremental mutation of the engine's edge state; numpy copy of
``repro.stream.apply``.

Two host-side structures cooperate, both living in the PERMUTED vertex
space of the current engine epoch:

  * :class:`EdgeStore` — the growable COO multiset of the BASE graph (the
    truth), bucketed per destination AND per source block so a dirty
    block's in-edge list (plus its mirror rows under symmetrization, and
    the out-neighbour lookup behind aux-dirty marking) can be re-gathered
    without a global sort or scan. Deletes are lazy (an alive mask);
    buckets compact opportunistically on gather, and the arrays themselves
    compact between batches once dead rows outnumber live ones.
  * :class:`MutableTiledState` — the mutable mirror of the engine's
    slack-padded :class:`TiledStorage`. A small insert APPENDS at a block's
    watermark into the spare invalid slots; a delete KILLS its slots in
    place (masked holes, no data movement); a block whose watermark hits
    capacity is REBUILT (= compacted) from the EdgeStore truth — per-block,
    vectorised, never a global rebuild. Every mutation records the tile
    rows it touched, so the device commit uploads exactly those rows
    (``StructureAwareEngine.update_edge_rows``) instead of the full
    arrays. Only when a rebuild itself overflows a block's build-time
    capacity does the caller fall back to a full plan rebuild.

Symmetrized programs (CC) never match mirrored edge copies individually —
a mirror slot of (s, d) is signature-identical to a base slot of (d, s),
so in-place kills would be ambiguous. Any block whose base or mirror
in-edges could change is instead rebuilt from the base truth (base rows by
dst-bucket + mirrored rows by src-bucket), which makes the incremental
state equal ``symmetrize(mutated base)`` by construction.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.partition import TiledStorage


class EdgeStore:
    """Growable base-graph COO multiset in permuted ids + block buckets."""

    def __init__(self, psrc: np.ndarray, pdst: np.ndarray, w: np.ndarray,
                 n: int, num_blocks: int, block_size: int, symmetric: bool):
        m0 = int(psrc.size)
        cap = max(2 * m0, 1024)
        self.n = n
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.symmetric = symmetric
        self.psrc = np.zeros(cap, dtype=np.int64)
        self.pdst = np.zeros(cap, dtype=np.int64)
        self.w = np.zeros(cap, dtype=np.float32)
        self.alive = np.zeros(cap, dtype=bool)
        self.psrc[:m0] = psrc
        self.pdst[:m0] = pdst
        self.w[:m0] = w
        self.alive[:m0] = True
        self.m = m0  # high-water mark
        self.n_live = m0
        self.by_dst = self._bucket(self.pdst[:m0])
        # by-src buckets serve the symmetric mirror gather AND the
        # aux-dirty out-neighbour lookup, so they are always maintained
        self.by_src = self._bucket(self.psrc[:m0])

    def _bucket(self, keys: np.ndarray) -> list[np.ndarray]:
        order = np.argsort(keys // self.block_size, kind="stable")
        bounds = np.searchsorted(keys[order] // self.block_size,
                                 np.arange(self.num_blocks + 1))
        return [order[bounds[b]:bounds[b + 1]].astype(np.int64)
                for b in range(self.num_blocks)]

    def _grow(self, need: int) -> None:
        cap = self.psrc.size
        if self.m + need <= cap:
            return
        new_cap = max(2 * cap, self.m + need)
        for name in ("psrc", "pdst", "w", "alive"):
            a = getattr(self, name)
            b = np.zeros(new_cap, dtype=a.dtype)
            b[:self.m] = a[:self.m]
            setattr(self, name, b)

    def _bucket_live(self, buckets: list[np.ndarray],
                     b: int) -> np.ndarray:
        """Live ids of one bucket, compacting it in passing."""
        ids = buckets[b]
        ids = ids[self.alive[ids]]
        buckets[b] = ids
        return ids

    def kill_pairs(self, kpsrc: np.ndarray,
                   kpdst: np.ndarray) -> np.ndarray:
        """Mark ALL live copies of the given (src, dst) pairs dead; returns
        the killed copy ids (for degree / coupling / reset bookkeeping).

        Pair-granular BY DESIGN, not by accident: :class:`DeltaBatch`
        deletes are (src, dst) pairs and the cold oracle
        (``delta.apply_to_coo``) drops every parallel copy of a deleted
        pair, so killing all live copies here is exactly what keeps the
        incremental multiset equal to the cold truth (pinned by
        tests/test_stream.py::test_multi_copy_delete_kills_all_copies).
        Only the dst-buckets of the deleted pairs are scanned — O(edges of
        the touched blocks), not O(m)."""
        if kpsrc.size == 0 or self.m == 0:
            return np.empty(0, dtype=np.int64)
        dkeys = np.unique(kpsrc * self.n + kpdst)
        cand = [self._bucket_live(self.by_dst, int(b))
                for b in np.unique(kpdst // self.block_size)]
        cand = (np.concatenate(cand) if cand
                else np.empty(0, dtype=np.int64))
        keys = self.psrc[cand] * self.n + self.pdst[cand]
        ids = cand[np.isin(keys, dkeys)]
        self.alive[ids] = False
        self.n_live -= ids.size
        return ids

    def maybe_compact(self, max_dead_frac: float = 0.5) -> bool:
        """Reclaim dead rows once they outnumber the live ones: a
        long-lived engine under steady insert/delete churn must not grow
        its arrays (and its scan costs) without bound. Invalidates all
        previously-returned ids — the streaming engine calls this at the
        very END of ``ingest``, after every use of the batch's killed /
        inserted ids (degree bumps, tile kills, gather-based rebuilds,
        reset bookkeeping) has completed."""
        dead = self.m - self.n_live
        if self.m < 1024 or dead <= self.n_live * max_dead_frac:
            return False
        live = np.flatnonzero(self.alive[:self.m])
        k = live.size
        for name in ("psrc", "pdst", "w"):
            a = getattr(self, name)
            a[:k] = a[live]
        self.alive[:k] = True
        self.alive[k:self.m] = False
        self.m = k
        self.by_dst = self._bucket(self.pdst[:k])
        self.by_src = self._bucket(self.psrc[:k])
        return True

    def insert(self, ipsrc: np.ndarray, ipdst: np.ndarray,
               iw: np.ndarray) -> np.ndarray:
        """Append insert copies; returns their ids."""
        k = int(ipsrc.size)
        if k == 0:
            return np.empty(0, dtype=np.int64)
        self._grow(k)
        ids = np.arange(self.m, self.m + k, dtype=np.int64)
        self.psrc[ids] = ipsrc
        self.pdst[ids] = ipdst
        self.w[ids] = iw
        self.alive[ids] = True
        self.m += k
        self.n_live += k
        for buckets, keys in ((self.by_dst, ipdst),
                              (self.by_src, ipsrc)):
            kb = keys // self.block_size
            for b in np.unique(kb):
                buckets[int(b)] = np.concatenate(
                    [buckets[int(b)], ids[kb == b]])
        return ids

    def gather_block(self, b: int) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """All live in-edges of block b as (src, dst_local, w) — base rows
        plus mirrored rows for symmetric engines. Compacts the buckets."""
        lo = b * self.block_size
        ids = self._bucket_live(self.by_dst, b)
        esrc, edst, ew = self.psrc[ids], self.pdst[ids], self.w[ids]
        if self.symmetric:
            mid = self._bucket_live(self.by_src, b)
            esrc = np.concatenate([esrc, self.pdst[mid]])
            edst = np.concatenate([edst, self.psrc[mid]])
            ew = np.concatenate([ew, self.w[mid]])
        return (esrc.astype(np.int32), (edst - lo).astype(np.int32), ew)

    def out_blocks_of(self, vertices: np.ndarray) -> np.ndarray:
        """Destination blocks of the live INTERNAL out-edges of the given
        vertices — the blocks whose aggregates silently change when those
        sources' aux (e.g. out-degree) changes. Same bucket scan as
        :meth:`successors`, reduced to distinct destination blocks."""
        return np.unique(self.successors(vertices)[1] // self.block_size)

    def successors(self, vertices: np.ndarray) -> tuple[np.ndarray,
                                                        np.ndarray,
                                                        np.ndarray]:
        """Live INTERNAL out-edges of the given (permuted) vertices as
        (src, dst, w) triples — the frontier-closure oracle behind
        ``reset_on_delete_frontier``. Served from the by-src buckets (plus
        reversed base in-edges when symmetric): the per-hop cost is the
        edges of the frontier's own blocks, and no O(m) CSR is ever
        rebuilt per delete batch."""
        vertices = np.asarray(vertices, dtype=np.int64)
        e64, ef = np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32)
        if vertices.size == 0 or self.m == 0:
            return e64, e64, ef
        srcs: list[np.ndarray] = []
        dsts: list[np.ndarray] = []
        ws: list[np.ndarray] = []
        for b in np.unique(vertices // self.block_size):
            ids = self._bucket_live(self.by_src, int(b))
            sel = ids[np.isin(self.psrc[ids], vertices)]
            if sel.size:
                srcs.append(self.psrc[sel])
                dsts.append(self.pdst[sel])
                ws.append(self.w[sel])
            if self.symmetric:
                # mirrored out-edges of v are its reversed base in-edges
                mid = self._bucket_live(self.by_dst, int(b))
                msel = mid[np.isin(self.pdst[mid], vertices)]
                if msel.size:
                    srcs.append(self.pdst[msel])
                    dsts.append(self.psrc[msel])
                    ws.append(self.w[msel])
        if not srcs:
            return e64, e64, ef
        return (np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(ws))

    def out_block_mass(self, vertices: np.ndarray, mass: np.ndarray,
                       subblocks: int = 1) -> np.ndarray:
        """(num_blocks,) per-destination-block sum of ``mass[i]`` over the
        live internal out-edges of ``vertices[i]`` — the data behind the
        aux staleness bump: when a source's aux changes, the bound on the
        message-delta mass entering each downstream block. With
        ``subblocks`` the sum is resolved per destination sub-range —
        (num_blocks, S) — at the same bucket-scan cost (the destination
        id is already in hand). Scans only the src-buckets of the
        vertices' own blocks, not the whole edge set."""
        shape = (self.num_blocks if subblocks == 1
                 else (self.num_blocks, subblocks))
        out = np.zeros(shape, dtype=np.float64)
        vertices = np.asarray(vertices, dtype=np.int64)
        if vertices.size == 0 or self.m == 0:
            return out
        order = np.argsort(vertices, kind="stable")
        sv, sm = vertices[order], np.asarray(mass, np.float64)[order]
        c = self.block_size
        ksub = c // max(subblocks, 1)

        def add(ids: np.ndarray, key: np.ndarray, tgt: np.ndarray) -> None:
            pos = np.minimum(np.searchsorted(sv, key[ids]), sv.size - 1)
            hit = sv[pos] == key[ids]
            if hit.any():
                t = tgt[ids[hit]]
                at = (t // c if subblocks == 1
                      else (t // c, (t % c) // ksub))
                np.add.at(out, at, sm[pos[hit]])

        for b in np.unique(vertices // c):
            add(self._bucket_live(self.by_src, int(b)), self.psrc,
                self.pdst)
            if self.symmetric:
                add(self._bucket_live(self.by_dst, int(b)), self.pdst,
                    self.psrc)
        return out

    def live_base(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The live base multiset (permuted ids)."""
        live = self.alive[:self.m]
        return (self.psrc[:self.m][live], self.pdst[:self.m][live],
                self.w[:self.m][live])


class MutableTiledState:
    """Mutable host mirror of one epoch's slack-padded TiledStorage.

    Invariant: block b's live edges occupy VALID slots inside the watermark
    prefix ``[slot_lo[b], slot_lo[b] + fill[b])`` of its flattened tile run
    ``[slot_lo[b], slot_lo[b] + cap[b])``; everything past the watermark is
    masked invalid. In-place kills leave masked holes behind (``live[b]``
    <= ``fill[b]``), appends land at the watermark, and ``rebuild`` (also
    the compaction path when the watermark hits capacity while holes
    remain) squashes the run back to a dense prefix.

    Every mutation marks the tile rows it touched in ``row_dirty``;
    ``pop_dirty_rows`` drains them so the device commit scatters exactly
    the changed rows instead of re-uploading the whole arrays.
    """

    def __init__(self, store: TiledStorage):
        self.tile = store.tile
        self.num_blocks = store.num_blocks
        self.shape2d = store.src.shape
        self.src = store.src.reshape(-1).copy()
        self.dstl = store.dst_local.reshape(-1).copy()
        self.w = store.w.reshape(-1).copy()
        self.valid = store.valid.reshape(-1).copy()
        self.slot_lo = store.tile_start.astype(np.int64) * self.tile
        self.cap = store.tile_cnt.astype(np.int64) * self.tile
        self.fill = np.asarray(store.edges, dtype=np.int64).copy()
        self.live = self.fill.copy()  # valid slots per block (fill - holes)
        self.row_dirty = np.zeros(self.shape2d[0], dtype=bool)

    def _mark_rows(self, slot_lo: int, slot_hi: int) -> None:
        if slot_hi > slot_lo:
            self.row_dirty[slot_lo // self.tile:
                           -(-slot_hi // self.tile)] = True

    def pop_dirty_rows(self) -> np.ndarray:
        """Tile rows touched since the last drain (sorted, unique)."""
        rows = np.flatnonzero(self.row_dirty)
        self.row_dirty[rows] = False
        return rows

    def append(self, b: int, asrc: np.ndarray, adstl: np.ndarray,
               aw: np.ndarray) -> bool:
        """In-place append at block b's watermark; False when the watermark
        would pass capacity (caller then compacts via ``rebuild``)."""
        k = int(asrc.size)
        if self.fill[b] + k > self.cap[b]:
            return False
        lo = int(self.slot_lo[b] + self.fill[b])
        self.src[lo:lo + k] = asrc
        self.dstl[lo:lo + k] = adstl
        self.w[lo:lo + k] = aw
        self.valid[lo:lo + k] = True
        self.fill[b] += k
        self.live[b] += k
        self._mark_rows(lo, lo + k)
        return True

    def kill(self, b: int, ksrc: np.ndarray, kdstl: np.ndarray) -> int:
        """Invalidate every live slot of block b matching one of the given
        (src, dst_local) pairs — pair-granular, all parallel copies, no
        data movement; only the rows holding killed slots become dirty.
        NON-SYMMETRIC layouts only: a mirror slot of (s, d) is
        signature-identical to a base slot of (d, s), so symmetric callers
        must rebuild the block from truth instead."""
        lo, hi = int(self.slot_lo[b]), int(self.slot_lo[b] + self.fill[b])
        if ksrc.size == 0 or hi == lo:
            return 0
        sig = (self.src[lo:hi].astype(np.int64) << 32) | self.dstl[lo:hi]
        ksig = (np.asarray(ksrc, np.int64) << 32) | np.asarray(kdstl,
                                                              np.int64)
        hit = self.valid[lo:hi] & np.isin(sig, ksig)
        idx = lo + np.flatnonzero(hit)
        self.valid[idx] = False
        self.live[b] -= idx.size
        self.row_dirty[np.unique(idx // self.tile)] = True
        return int(idx.size)

    def rebuild(self, b: int, esrc: np.ndarray, edstl: np.ndarray,
                ew: np.ndarray) -> bool:
        """Rewrite block b's tile run from truth (squashing any holes);
        False on overflow of the run's build-time capacity. Only slots up
        to max(old watermark, k) can differ from the device copy — the
        slack beyond both was invalid on both sides all along — so only
        those rows are marked dirty."""
        k = int(esrc.size)
        if k > self.cap[b]:
            return False
        lo = int(self.slot_lo[b])
        hi = int(max(self.fill[b], k))
        self.src[lo:lo + k] = esrc
        self.dstl[lo:lo + k] = edstl
        self.w[lo:lo + k] = ew
        self.valid[lo:lo + k] = True
        self.valid[lo + k:lo + hi] = False
        self.fill[b] = k
        self.live[b] = k
        self._mark_rows(lo, lo + hi)
        return True

    def rows2d(self, rows: np.ndarray) -> dict:
        """Gathered (len(rows), TILE) payload of the given tile rows — the
        host->device scatter payload, O(touched rows), never O(n_tiles)."""
        return {"src": self.src.reshape(self.shape2d)[rows],
                "dst_local": self.dstl.reshape(self.shape2d)[rows],
                "w": self.w.reshape(self.shape2d)[rows],
                "valid": self.valid.reshape(self.shape2d)[rows]}
