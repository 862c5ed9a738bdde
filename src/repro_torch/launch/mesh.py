"""Production mesh builders; port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the initialized default group (NCCL on the cards, gloo
on the CPU, the ``fake`` backend in the dry run, ``launch/dryrun.py``),
built with ``init_device_mesh`` and named by ``mesh_dim_names``.

Topology: one pod = 16 x 16 = 256 devices; multi-pod = 2 pods over the
slower inter-pod links. Axes: "pod" (slow) > "data" (DP / ZeRO) > "model"
(TP / EP / SP). The production meshes need a world of 256 or 512 ranks,
which only the dry run's fake group has.

The sharding rules (``launch/sharding.py``) read only a mesh's axis names
and sizes; :class:`MeshShape` carries those without a process group, for
rules evaluated away from any group (tests, abstract layouts).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's ``shape`` and ``mesh_dim_names``, without its ranks."""

    shape: tuple
    mesh_dim_names: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: int | None = None) -> int:
        if mesh_dim is not None:
            return self.shape[mesh_dim]
        n = 1
        for s in self.shape:
            n *= s
        return n

    def get_coordinate(self) -> list:
        """Rank 0's coordinate: the layout's first shard."""
        return [0] * len(self.shape)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over ranks 0..prod(shape)-1 of
    the default group (the reference's ``jax.make_mesh``)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    s = production_shape(multi_pod=multi_pod)
    return make_mesh(s.shape, s.mesh_dim_names, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the default group -> a ("data", "model") mesh of
    (world // model, model) (tests, training on one host)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world of "
                         f"{n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, axis) -> int:
    """The product of the sizes of ``axis`` (a name or a tuple of them)."""
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return size


def _rank_main(rank: int, nproc: int, tmp: str, device_type: str, fn,
               args: tuple) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)  # small ops: one thread per rank
        backend = "gloo"
    dist.init_process_group(backend, rank=rank, world_size=nproc,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 nproc))
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, nproc: int, device_type: str = "cuda", args: tuple = (),
              timeout: float = 600.0) -> list:
    """``fn(rank, *args)`` on each of ``nproc`` spawned ranks of a default
    group over a FileStore in a temporary directory (gloo on the CPU, NCCL
    on ``cuda``, rank r on ``cuda:r``); ``fn`` and ``args`` are pickled by
    reference, as ``torch.multiprocessing`` spawns. Returns the ranks'
    results in rank order. Raises ``TimeoutError`` (after killing the
    ranks) when they outlast ``timeout`` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(nproc, tmp, device_type, fn, args),
                                 nprocs=nproc, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{nproc} ranks still running after "
                                   f"{timeout} s")
        out = []
        for r in range(nproc):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
