"""The port's checkpoint manager (``repro_torch.ckpt.manager``) on the CPU:
the five properties of tests/test_train_ckpt_ft.py's checkpointing tests
(round trip, keep-N and latest, async and atomic, treedef container types,
the stale-tmp sweep), and checkpoints read across the two packages in both
directions (the same on-disk format)."""
import json
import os

import numpy as np
import pytest

from repro.ckpt.manager import CheckpointManager as JManager
from repro_torch.ckpt import CheckpointManager


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": np.arange(6).reshape(2, 3),
            "nested": {"b": np.ones(4, np.float32)}}
    mgr.save(5, tree, extra_meta={"note": "x"})
    got, meta = mgr.restore()
    assert meta["step"] == 5 and meta["note"] == "x"
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["nested"]["b"], tree["nested"]["b"])


def test_ckpt_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": np.array([s])})
    assert mgr.list_steps() == [3, 4] and mgr.latest_step() == 4
    got, meta = mgr.restore()
    assert meta["step"] == 4 and got["x"][0] == 4


def test_ckpt_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    mgr.save(1, {"x": np.zeros(1000)})
    mgr.wait()
    names = os.listdir(tmp_path)
    assert "step_00000001" in names
    assert not any(n.endswith(".tmp") for n in names)


def test_ckpt_async_save_copies_its_leaves(tmp_path):
    """An async save holds the tree as it was at the call: the caller may
    change its arrays in place (an ingest does) before the write ends."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    x = np.arange(200_000, dtype=np.int64)
    mgr.save(1, {"x": x, "n": np.int32(7)})
    x[:] = -1
    mgr.wait()
    got, _ = mgr.restore()
    np.testing.assert_array_equal(got["x"], np.arange(200_000))
    assert got["n"].dtype == np.int32 and got["n"] == 7


def test_ckpt_treedef_container_types(tmp_path):
    """list/tuple nodes come back as lists/tuples (the recorded treedef,
    not the key-only dict fallback), and leaf dtypes survive."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"edges": (np.arange(3, dtype=np.int64),
                      np.arange(3, dtype=np.int64),
                      np.ones(3, np.float32)),
            "hist": [np.zeros(2), {"inner": (np.int32(7), [np.float32(1.5)])}],
            "step": np.int32(11)}
    mgr.save(1, tree)
    got, meta = mgr.restore()
    assert isinstance(got["edges"], tuple) and len(got["edges"]) == 3
    assert isinstance(got["hist"], list)
    assert isinstance(got["hist"][1]["inner"], tuple)
    assert isinstance(got["hist"][1]["inner"][1], list)
    assert got["edges"][2].dtype == np.float32
    assert got["step"].dtype == np.int32
    assert got["hist"][1]["inner"][0].dtype == np.int32
    np.testing.assert_array_equal(got["edges"][0], tree["edges"][0])
    # pre-treedef checkpoints (no spec in meta) still restore, dict-shaped
    meta_path = os.path.join(str(tmp_path), "step_00000001", "meta.json")
    with open(meta_path) as f:
        m = json.load(f)
    del m["treedef"]
    with open(meta_path, "w") as f:
        json.dump(m, f)
    old, _ = mgr.restore()
    assert isinstance(old["edges"], dict)  # the fallback loses containers
    np.testing.assert_array_equal(old["edges"]["0"], tree["edges"][0])


def test_ckpt_stale_tmp_sweep_crash_recovery(tmp_path):
    """A crash mid-write leaves step_*.tmp garbage; a fresh manager sweeps
    it, and the half-written tmp is never visible as a step."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"x": np.array([1.0])})
    stale = os.path.join(str(tmp_path), "step_00000002.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "arrays.npz"), "w") as f:
        f.write("partial")
    assert mgr.list_steps() == [1]
    got, meta = mgr.restore()
    assert meta["step"] == 1
    mgr2 = CheckpointManager(str(tmp_path), async_write=False)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    mgr2.save(2, {"x": np.array([2.0])})
    got, meta = mgr2.restore()
    assert meta["step"] == 2 and got["x"][0] == 2.0


def test_restore_onto_a_mesh_waits_for_the_mesh(tmp_path):
    """``restore(shardings=..., mesh=...)`` lays each leaf out on the mesh
    (here a gloo world of one, a (1, 1) mesh): DTensors with the given
    placements holding the saved values, nested containers kept."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_write=False)
    tree = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
            "n": {"y": np.arange(5, dtype=np.int32)}}
    mgr.save(1, tree)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_host_mesh(model=1, device_type="cpu")
        shard = (Replicate(), Shard(1))
        got, meta = mgr.restore(
            shardings={"x": shard, "n": {"y": (Shard(0), Replicate())}},
            mesh=mesh)
        assert meta["step"] == 1 and isinstance(got["x"], DTensor)
        assert tuple(got["x"].placements) == shard
        assert torch.equal(got["x"].full_tensor(),
                           torch.from_numpy(tree["x"]))
        assert torch.equal(got["n"]["y"].full_tensor(),
                           torch.from_numpy(tree["n"]["y"]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint written by either manager restores in the other with
    the same tree (containers, dtypes, values) and meta."""
    tree = {"edges": (np.arange(5, dtype=np.int64),
                      np.arange(5, dtype=np.int64)[::-1].copy(),
                      np.linspace(0, 1, 5).astype(np.float32)),
            "state": {"psd": np.ones((3, 2), np.float32),
                      "calm": np.zeros((3, 2), np.int32)},
            "hist": [np.int32(4), [np.float64(2.5)]]}
    managers = {"reference": JManager, "port": CheckpointManager}
    write = managers[writer](str(tmp_path), async_write=True)
    write.save(7, tree, extra_meta={"format": "graph-epoch-v1", "n": 5})
    write.wait()
    results = [m(str(tmp_path), async_write=False).restore()
               for m in managers.values()]
    (jt, jm), (tt, tm) = results
    assert jm == tm and tm["step"] == 7 and tm["n"] == 5
    for got in (jt, tt):
        assert isinstance(got["edges"], tuple)
        assert isinstance(got["hist"], list)
        assert isinstance(got["hist"][1], list)
        for a, b in zip(got["edges"], tree["edges"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got["state"]["calm"].dtype == np.int32
        assert got["hist"][0].dtype == np.int32
        np.testing.assert_array_equal(got["state"]["psd"],
                                      tree["state"]["psd"])
