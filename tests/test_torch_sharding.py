"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``) for all ten archs at their
published shapes, on the production meshes (16, 16) and (2, 16, 16) and a
(4, 2) host mesh: every parameter's placements are the reference's
``PartitionSpec`` (the stacked layer axis's leading entry dropped), for
``param_specs``, ``zero1_specs`` and ``state_specs``, ``embed_d_shard`` on
and off; ``batch_specs``, ``cache_sharding`` (long_500k's batch-1 rule
too) and ``logits_spec`` for every shape. The reference runs in a
subprocess with 512 forced host devices (tests/test_distributed.py's
way), the port's rules on ``MeshShape``s, which carry a mesh's names and
sizes without ranks. Also: the abstract ``input_specs``/``cache_specs``
(meta tensors) against the reference's ``ShapeDtypeStruct``s,
``cast_weights_once`` bitwise on and off and against the reference with
the lever on, and DTensor's rule for ``aten::mm.dtype`` (the down
projection's card route) on fake CUDA DTensors over a fake group of 8
ranks."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as JC
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "host4x2": ((4, 2), ("data", "model"))}

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.launch import sharding as S
from repro.models import model as M
from repro.models.config import SHAPES
MESHES = json.loads(sys.argv[1])

def spec(ns):
    return [list(e) if isinstance(e, tuple) else e for e in ns.spec]

def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): spec(ns)
            for path, ns in jax.tree_util.tree_leaves_with_path(tree)}

out = {}
devs = np.array(jax.devices())
for mname, (shape, axes) in MESHES.items():
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), tuple(axes))
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch)
        ps = jax.eval_shape(lambda: M.init_params(cfg, jax.random.PRNGKey(0)))
        for dshard in (False, True):
            state = {"params": ps, "opt": {"m": ps, "v": ps,
                     "step": jax.ShapeDtypeStruct((), jnp.int32)}}
            st = S.state_specs(state, mesh, embed_d_shard=dshard)
            out[f"{mname}/{arch}/{dshard}/params"] = flat(st["params"])
            out[f"{mname}/{arch}/{dshard}/m"] = flat(st["opt"]["m"])
            out[f"{mname}/{arch}/{dshard}/step"] = spec(st["opt"]["step"])
        for sname, shp in SHAPES.items():
            key = f"{mname}/{arch}/{sname}"
            out[key + "/batch"] = flat(S.batch_specs(cfg, shp, mesh))
            cache = configs.cache_specs(cfg, shp)
            out[key + "/cache"] = flat(S.cache_sharding(cfg, shp, mesh,
                                                        cache))
            out[key + "/logits2"] = spec(S.logits_spec(cfg, shp, mesh))
            out[key + "/logits3"] = spec(S.logits_spec(cfg, shp, mesh, 3))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "PYTHONPATH": os.path.join(ROOT, "src"),
           "PATH": "/usr/bin:/bin:/usr/local/bin", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        json.dumps(MESHES)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


def _mesh(name):
    return MeshShape(*MESHES[name])


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _ref_path(name: str) -> tuple[str, bool]:
    """The reference's leaf of a port parameter, and whether it is stacked
    (a layer stack's (L, ...) leaf)."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        return "/".join([parts[0], *parts[2:]]), True
    return name, False


def _zero1_rule(base, shape, data):
    """The ZeRO-1 rule on the unstacked dims: "data" on the largest
    still-unsharded dim that divides by it and holds data x 8."""
    spec = list(base) + [None] * (len(shape) - len(base))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % data == 0 and shape[i] >= data * 8:
            spec[i] = "data"
            break
    return tuple(spec)


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_param_and_state_specs_match_reference(reference, arch):
    model = TM.Model(TC.get(arch), "meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    moved = 0
    for mname in MESHES:
        mesh = _mesh(mname)
        data = mesh.shape[mesh.mesh_dim_names.index("data")]
        for dshard in (False, True):
            key = f"{mname}/{arch}/{dshard}"
            got = SH.state_specs({"params": model}, mesh,
                                 embed_d_shard=dshard)
            assert got["params"] == SH.param_specs(model, mesh, dshard)
            assert got["opt"]["m"] == got["opt"]["v"] == SH.zero1_specs(
                model, mesh, dshard)
            assert got["opt"]["step"] == SH.to_placements(
                _spec(reference[key + "/step"]), mesh)
            for name, shape in shapes.items():
                path, stacked = _ref_path(name)
                p = _spec(reference[key + "/params"][path])
                m = _spec(reference[key + "/m"][path])
                if stacked:
                    assert p[:1] in ((), (None,)), (name, p)
                    p = p[1:]
                    if m[:1] == ("data",):
                        # the reference's ZeRO-1 took the layer axis, which
                        # the port's unstacked leaf does not have
                        moved += 1
                        m = _zero1_rule(p, shape, data)
                    else:
                        m = m[1:]
                assert got["params"][name] == SH.to_placements(p, mesh), \
                    (key, name)
                assert got["opt"]["m"][name] == SH.to_placements(m, mesh), \
                    (key, name)
    # the reference shards some layer stacks' moments on their layer axis
    # at the (4, 2) mesh (data x 8 = 32 layers); the port's differ there
    assert moved < len(shapes) * len(MESHES) * 2


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_batch_cache_and_logits_specs_match_reference(reference, arch):
    cfg = TC.get(arch)
    for mname in MESHES:
        mesh = _mesh(mname)
        for sname, shape in TC.SHAPES.items():
            key = f"{mname}/{arch}/{sname}"
            got = SH.batch_specs(cfg, shape, mesh)
            want = reference[key + "/batch"]
            assert set(got) == set(want)
            for leaf, spec in want.items():
                assert got[leaf] == SH.to_placements(_spec(spec), mesh), \
                    (key, leaf)
            cache = TC.cache_specs(cfg, shape)
            got = SH.cache_sharding(cfg, shape, mesh, cache)
            want = reference[key + "/cache"]
            assert set(got) == set(want)
            for leaf, spec in want.items():
                assert got[leaf] == SH.to_placements(_spec(spec), mesh), \
                    (key, leaf)
            for nd in (2, 3):
                assert SH.logits_spec(cfg, shape, mesh, nd) == \
                    SH.to_placements(_spec(reference[f"{key}/logits{nd}"]),
                                     mesh)


def test_to_placements():
    """A spec's axes become ``Shard`` on their mesh dims, a tuple's axes
    nested on one dim; every other mesh dim ``Replicate``."""
    mesh = _mesh("pod2x16x16")
    assert SH.to_placements((), mesh) == (Replicate(),) * 3
    assert SH.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.to_placements((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert SH.local_shape((40, 8), _mesh("host4x2"),
                          (Shard(0), Shard(1))) == (10, 4)  # rank 0's
    long = TC.SHAPES["long_500k"]
    cache = TC.cache_specs(TC.get("mamba2_2p7b"), long)
    assert cache["ssm_state"].device.type == "meta"


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_abstract_input_and_cache_specs_match_reference(arch):
    """``concrete=False`` gives meta tensors of the reference's
    ``ShapeDtypeStruct`` shapes and dtypes, for every shape."""
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    for sname in TC.SHAPES:
        want = JC.input_specs(jcfg, JC.SHAPES[sname])
        got = TC.input_specs(tcfg, TC.SHAPES[sname])
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape, (sname, k)
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
        want = JC.cache_specs(jcfg, JC.SHAPES[sname])
        got = TC.cache_specs(tcfg, TC.SHAPES[sname])
        assert set(got) == set(want)
        for k, w in want.items():
            if k == "pos":
                continue
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape, (sname, k)
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ["llama3p2_1b", "mamba2_2p7b",
                                  "granite_moe_3b_a800m", "whisper_base"])
def test_cast_weights_once_matches_reference(arch):
    """With the lever on, the port's bf16 logits are bitwise its own with
    the lever off, and within the reference's bf16 bar of the reference's
    forward with the lever on (its layers cast before the scan)."""
    jcfg = dataclasses.replace(JC.reduced(JC.get(arch)),
                               cast_weights_once=True)
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jcfg, jax.random.PRNGKey(4)))
    if jcfg.has_attention:
        tree = jax.tree.map(np.array, tree)
        rng = np.random.default_rng(5)
        for stack, grp in (("layers", "attn"), ("layers", "cross"),
                           ("enc_layers", "attn")):
            if grp in tree.get(stack, {}):
                wo = tree[stack][grp]["wo"]
                wo[...] = rng.normal(size=wo.shape) * wo.shape[1] ** -0.5
    on = ArchConfig(**dataclasses.asdict(jcfg))
    off = dataclasses.replace(on, cast_weights_once=False)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, jcfg.vocab_size, (2, 32), dtype=np.int32)
    batch = {"tokens": tok}
    if jcfg.is_encdec:
        batch["frames"] = rng.normal(size=(2, 24, jcfg.d_model)).astype(
            np.float32)
    params = lm_params_from_arrays(on, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = TM.forward(params, on, tb)[0]
    assert torch.equal(got, TM.forward(params, off, tb)[0])
    want = JM.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      remat=False)[0]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


MM_DTYPE = """
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import local_shape
from repro_torch.models.layers import register_mm_dtype_sharding
fake_world(8)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cuda")
fm = FakeTensorMode(allow_non_fake_inputs=True)

def fake(shape, pl):
    loc = local_shape(shape, mesh, pl)
    with fm:
        t = torch.empty(loc, dtype=torch.bfloat16, device="cuda")
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=(shape[1], 1))

a = fake((64, 32), [Replicate(), Shard(0), Shard(1)])
b = fake((32, 16), [Replicate(), Replicate(), Shard(0)])
with fm:
    try:
        torch.mm(a, b, out_dtype=torch.float32)
        print("no error without the rule")
    except NotImplementedError as e:
        print("raises:", "mm.dtype" in str(e))
    register_mm_dtype_sharding()
    with FlopCounterMode(display=False) as fc:
        c = torch.mm(a, b, out_dtype=torch.float32)
    print("device", c.to_local().device.type, "dtype", c.dtype,
          "shape", tuple(c.shape), "local", tuple(c.to_local().shape),
          "placements", [str(p) for p in c.placements],
          "flops", fc.get_total_flops())
"""


def test_mm_dtype_has_a_sharding_strategy():
    """DTensor has no rule for ``aten::mm.dtype``: on fake CUDA DTensors
    over a fake group of 8 ranks the op raises until the port registers
    one, then gives f32 out of bf16 operands, laid out as ``aten::mm``
    would (rows over data, the contraction's partial over model), counted
    by ``FlopCounterMode`` as the global 2 M N K."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(MM_DTYPE)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ,
                                          PYTHONPATH=os.path.join(ROOT,
                                                                  "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "raises: True"
    assert lines[1] == ("device cuda dtype torch.float32 shape (64, 16) "
                        "local (32, 16) placements ['R', 'S(0)', "
                        "'P(sum)'] flops " + str(2 * 64 * 32 * 16))
