"""Fault-tolerant checkpointing: atomic, async, keep-N; port of
``repro.ckpt.manager``, free of JAX.

Layout: <dir>/step_<k>/arrays.npz + meta.json, written to a tmp dir and
renamed (atomic on POSIX) so a crash mid-write never corrupts the latest
checkpoint. Arrays are stored logically unsharded with their tree structure
(``treedef``) and flat storage ``keys`` in meta, the reference's format
byte for byte: a checkpoint written by either package restores in the
other.

``restore(..., shardings=..., mesh=...)`` lays the restored tree out on a
device mesh, as the reference's ``reshard``: each leaf, read whole, goes
through ``distribute_tensor`` with its placements, so any mesh takes any
checkpoint (a smaller one than the mesh that saved it: an elastic resize).
Saving takes host arrays: a sharded state is gathered first
(``interop.train_state_to_arrays``). Training reuses this manager.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np

SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _treedef(tree):
    """JSON-able structure spec: the shape of the tree with leaves replaced
    by their flat storage keys. Recorded in meta.json so restore can rebuild
    the ORIGINAL container types: the key-only _unflatten turns list/tuple
    nodes into string-keyed dicts."""
    def spec(node, prefix=""):
        if isinstance(node, dict):
            return {"t": "dict",
                    "items": {k: spec(v, f"{prefix}{k}{SEP}")
                              for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            return {"t": "list" if isinstance(node, list) else "tuple",
                    "items": [spec(v, f"{prefix}{i}{SEP}")
                              for i, v in enumerate(node)]}
        return {"t": "leaf", "key": prefix[:-1]}
    return spec(tree)


def _from_treedef(spec, flat: dict):
    t = spec["t"]
    if t == "dict":
        return {k: _from_treedef(v, flat) for k, v in spec["items"].items()}
    if t in ("list", "tuple"):
        items = [_from_treedef(v, flat) for v in spec["items"]]
        return items if t == "list" else tuple(items)
    return flat[spec["key"]]


def _unflatten(flat: dict):
    """Key-only fallback for checkpoints written before the treedef was
    recorded: every interior node comes back as a dict (list/tuple
    structure is unrecoverable from the keys alone)."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def reshard(tree, shardings, mesh):
    """A host-side tree laid out on ``mesh``: each numpy leaf a DTensor by
    the placements at the same place in ``shardings``."""
    if isinstance(tree, dict):
        return {k: reshard(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [reshard(v, s, mesh) for v, s in zip(tree, shardings)]
        return out if isinstance(tree, list) else tuple(out)
    import torch
    from torch.distributed.tensor import distribute_tensor
    t = torch.from_numpy(np.array(tree, copy=True))
    if mesh.device_type != "cpu":
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, list(shardings))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)
        # sweep stale tmp dirs left by a crash mid-write: the published
        # step_* dirs are complete by construction (tmp -> rename), so a
        # leftover *.tmp is garbage and must not shadow a future write to
        # the same step
        for name in os.listdir(directory):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree, extra_meta: dict | None = None):
        # np.asarray keeps leaf dtypes (numpy scalar dtypes too: an np.int32
        # step must not come back int64); only plain python scalars fall
        # back to the platform default. An async write copies the leaves,
        # so a caller may change its arrays in place before it finishes.
        leaf = ((lambda v: np.array(v, copy=True)) if self.async_write
                else np.asarray)
        flat = {k: leaf(v) for k, v in _flatten(tree).items()}
        meta = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys()),
                "treedef": _treedef(tree), **(extra_meta or {})}
        self.wait()  # one in-flight write at a time
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write(self, step: int, flat: dict, meta: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, shardings=None, mesh=None):
        """Returns (tree, meta), the leaves as numpy arrays; with
        ``shardings`` (a tree of the checkpoint's structure whose leaves
        are DTensor placements) and ``mesh`` (a ``DeviceMesh``), the leaves
        as DTensors laid out on ``mesh`` (:func:`reshard`)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        # rebuild the original container types from the recorded treedef;
        # pre-treedef checkpoints fall back to the key-only dict shape
        spec = meta.get("treedef")
        tree = (_from_treedef(spec, flat) if spec is not None
                else _unflatten(flat))
        if shardings is not None:
            tree = reshard(tree, shardings, mesh)
        return tree, meta
