"""The port on the card: the CUDA sweep kernel against its plain version,
and whole runs on the card against the same runs on the CPU. These tests
need an NVIDIA card and nvcc; elsewhere they skip. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.baseline import BaselineEngine
from repro_torch.core.engine import EngineConfig, StructureAwareEngine
from repro_torch.kernels import block_sweep as kb

pytestmark = pytest.mark.cuda
CFG = EngineConfig(block_size=128, width=8, t2=1e-9)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _graph(prog):
    if prog == "pagerank":
        return G.core_periphery_graph(6000, 8, seed=1, chords=1)
    return G.powerlaw_graph(6000, 8, seed=2, weighted=prog == "sssp")


@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_kernel_matches_plain(card, prog):
    eng = StructureAwareEngine(_graph(prog), A.REGISTRY[prog](), CFG)
    ed, c, P = eng._ed, CFG.block_size, eng.plan.num_blocks
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    rng = np.random.default_rng(0)
    values = rng.uniform(0.0, 1e-3, eng._values_len).astype(np.float32)
    rows = np.arange(P, dtype=np.int32)
    ok = rng.random(P) < 0.7
    kw = dict(block_size=c, n_live=eng.plan.n_live)
    gv = torch.from_numpy(values).cuda()
    gp, gd = torch.zeros(P, 1).cuda(), torch.zeros(P, 1).cuda()
    kb.block_sweep(eng.program, eng.plan.graph.n, ed, gv,
                   torch.from_numpy(rows).cuda(), torch.from_numpy(ok).cuda(),
                   gp, gd, kb.make_scratch(ed, c), **kw)
    cv = torch.from_numpy(values.copy())
    cp, cd = torch.zeros(P, 1), torch.zeros(P, 1)
    kb.block_sweep_ref(eng.program, eng.plan.graph.n, ed_cpu, cv,
                       torch.from_numpy(rows), torch.from_numpy(ok), cp, cd,
                       kb.make_scratch(ed_cpu, c), **kw)
    torch.cuda.synchronize()
    assert torch.equal(gv.cpu(), cv)
    assert torch.equal(gp.cpu(), cp) and torch.equal(gd.cpu(), cd)


@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_run_on_card_matches_cpu(card, prog):
    g, program = _graph(prog), A.REGISTRY[prog]()
    kb.block_sweep.launches = 0
    gpu = StructureAwareEngine(g, program, CFG).run()
    assert kb.block_sweep.launches > 0
    cpu = StructureAwareEngine(g, program, CFG, device="cpu").run()
    assert np.array_equal(gpu.values, cpu.values)
    assert gpu.metrics.iterations == cpu.metrics.iterations
    assert gpu.metrics.updates == cpu.metrics.updates
    base = BaselineEngine(g, program, CFG).run()
    base_cpu = BaselineEngine(g, program, CFG, device="cpu").run()
    assert np.array_equal(base.values, base_cpu.values)
