"""Shared helpers for the port's parity tests (tests/test_torch_*.py): hand
a reference engine's state to the port as numpy arrays, and keep torch to
one intra-op thread (the plain versions run many small ops, which a thread
pool only slows down)."""
import numpy as np
import pytest
import torch

from repro_torch.interop import engine_from_arrays


def reference_arrays(eng) -> dict:
    """The reference StructureAwareEngine's state, as the arrays
    ``repro_torch.interop.engine_from_arrays`` takes."""
    p, u = eng.plan, eng.plan.unified
    is_hot = np.zeros(p.num_blocks, dtype=bool)
    is_hot[:p.barrier_block] = True
    return dict(order=p.order, inv=p.inv, n_live=p.n_live, src=u.src,
                dst_local=u.dst_local, w=u.w, valid=u.valid,
                tile_start=u.tile_start, tile_cnt=u.tile_cnt, edges=u.edges,
                values0=np.asarray(eng.values0), aux=np.asarray(eng.aux),
                coupling=np.asarray(eng._coupling), is_hot=is_hot)


def port_engine(eng, program, config):
    """The port's engine on the CPU over the reference engine's state."""
    return engine_from_arrays(program, config, reference_arrays(eng),
                              device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
