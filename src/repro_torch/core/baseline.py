"""Gemini-style synchronous baseline (the system class the paper compares
against: full BSP sweeps, static partitions, every block loaded every
iteration); port of ``repro.core.baseline``.

Same vertex-program interface, same convergence test (SUM of per-block mean
SD-delta < T2), same metric accounting, and the same sweep kernel as the
structure-aware engine — so the comparison isolates the paper's
contribution (structure-aware scheduling), not implementation differences.

Each iteration is one full sweep of all blocks from one snapshot: the
kernel reads ``values`` and writes the next iterate into a second buffer,
and the two swap (no copy). The host reads the PSD vector every
iteration, as the reference does.

A ``frontier`` mode only *counts* loads for blocks actually touched by the
frontier (Gemini's sparse/dense dual mode); compute is still the full sweep.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithms import VertexProgram
from repro_torch.core.engine import (EngineConfig, RunResult, check_config,
                                     edge_data, make_tiled_processor,
                                     resolve_device)
from repro_torch.core.graph import Graph, symmetrize
from repro_torch.core.metrics import Metrics, Timer, block_io_bytes
from repro_torch.core.partition import build_tiled_storage
from repro_torch.kernels.block_sweep import MAX_SLOTS


class BaselineEngine:
    def __init__(self, graph: Graph, program: VertexProgram,
                 config: EngineConfig = EngineConfig(), frontier: bool = True,
                 device="cuda"):
        check_config(config)
        self.device = resolve_device(device)
        self.program = program
        self.config = config
        self.frontier = frontier
        g = symmetrize(graph) if program.needs_symmetric else graph
        self.graph = g
        # Identical chunking (without the AD sort) => identical block
        # accounting units: plain id-order chunks, as a static
        # chunk-partitioned system uses.
        c = config.block_size
        self.num_blocks = max(-(-g.n // c), 1)
        self.store = build_tiled_storage(g, c, self.num_blocks)
        vals0, aux0 = program.init(g)
        self._values_len = self.num_blocks * c
        self.values0 = np.concatenate(
            [vals0, np.zeros(self._values_len - g.n, dtype=vals0.dtype)])
        self._ed = edge_data(self.store, aux0, c, self._values_len,
                             subblocks=1, device=self.device)
        self._process_one, _ = make_tiled_processor(program, self._ed, c,
                                                    g.n, g.n)

    def _step(self, values, out, psd, dmax):
        """One full sweep of every block from ``values`` into ``out``, in
        slates of at most the kernel's slot count (each slate reads the
        same snapshot, so slate boundaries change nothing)."""
        nb = self.num_blocks
        for at in range(0, nb, MAX_SLOTS):
            rows = torch.arange(at, min(at + MAX_SLOTS, nb),
                                dtype=torch.int32, device=self.device)
            ok = torch.ones(rows.numel(), dtype=torch.bool,
                            device=self.device)
            self._process_one(self._ed, values, psd, dmax, rows, ok,
                              out=out)

    def run(self, max_iterations: int | None = None) -> RunResult:
        cfg = self.config
        dev = self.device
        max_it = max_iterations or cfg.max_iterations
        values = torch.as_tensor(self.values0).to(dev).clone()
        nxt = torch.empty_like(values)
        psd = torch.zeros((self.num_blocks, 1), dtype=torch.float32,
                          device=dev)
        dmax = torch.zeros_like(psd)
        metrics = Metrics()
        history = []
        syncs = 0
        # frontier accounting: which blocks would a sparse engine touch?
        frontier_mask = np.ones(self.graph.n, dtype=bool)
        block_of = np.arange(self.graph.n) // cfg.block_size
        bytes_per_block = self._bytes_per_block()

        with Timer() as t:
            it = 0
            while it < max_it:
                self._step(values, nxt, psd, dmax)
                nchanged = (self.program.sd_delta(values, nxt) > 0).sum()
                values, nxt = nxt, values
                psd_host = psd.cpu().numpy()[:, 0]
                syncs += 1
                metrics.updates += self.graph.n
                metrics.edges_processed += self.graph.m
                if self.frontier:
                    touched = np.unique(block_of[frontier_mask])
                else:
                    touched = np.arange(self.num_blocks)
                metrics.block_loads += int(touched.size)
                metrics.bytes_loaded += int(bytes_per_block[touched].sum())
                history.append({"iteration": it,
                                "psd_sum": float(psd_host.sum()),
                                "active": int(nchanged),
                                "scheduled": int(touched.size)})
                it += 1
                if float(psd_host.sum()) < cfg.t2:
                    metrics.converged = True
                    break
                # next frontier: vertices with changed in-neighbours
                if self.frontier:
                    frontier_mask = psd_host[block_of] > 0
        metrics.iterations = it
        metrics.wall_time_s = t.elapsed
        return RunResult(values=values.cpu().numpy()[:self.graph.n],
                         metrics=metrics, history=history,
                         host_syncs=syncs + 1)

    def _bytes_per_block(self) -> np.ndarray:
        """Edges per id-order block via indptr differences; shared cost
        model (metrics.block_io_bytes) with the structure-aware engine."""
        c = self.config.block_size
        idx = np.arange(0, self.graph.n, c)
        idx = np.append(idx, self.graph.n)
        edges = np.diff(self.graph.in_indptr[idx])
        if edges.size < self.num_blocks:
            edges = np.pad(edges, (0, self.num_blocks - edges.size))
        return block_io_bytes(edges[:self.num_blocks], c)
