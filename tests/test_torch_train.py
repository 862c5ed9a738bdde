"""The port's LM training path against the reference's: one train step,
microbatches, remat, checkpoint resume within and across the packages,
expert rebalancing, and the driver (``repro_torch.train``,
``.launch.train``, ``.interop.train_state_*``) against ``repro.train``
and ``repro.launch.train`` on the same weights and batches.

Both packages start from the reference's ``init_params`` handed to the port
by ``interop.train_state_from_arrays`` (with every ``wo`` redrawn nonzero:
the reference's skip-init zero ``wo`` would hide attention from the loss
and give its weights zero gradients), on ``SyntheticLM`` batches (a vlm's
seeded patches, whisper's seeded frames), at ``configs.reduced``. Bars:

* one step at f32 (``dtype="float32"``): loss, ce and lr at rtol 1e-5,
  grad_norm at 1e-5, every parameter, ``m`` and ``v`` after the update at
  rtol 1e-5 plus atol 1e-4 for the parameters (a tenth of the lr: at step
  1 Adam moves each weight by about lr * sign(g), so a gradient that sum
  order puts on the other side of zero would move it 2 lr; the largest gap
  seen is 2.6e-5, no flip) and 1e-5 times the leaf's largest magnitude
  for the moments (a gradient element that sums cancelling terms, such
  as an embedding row over its token's positions, differs by up to 1e-4
  of itself across sum orders); at bf16 the reference's own bar, 5e-2, on the loss and
  the parameters; the MoE's ``expert_load`` bitwise at f32, and at bf16
  the same total with each expert's count within 2% of it (the compiled
  reference routes a near tie to another expert than its own op-by-op
  execution does, ``tests/test_torch_models.py``'s SPREAD);
* ``micro=1`` against ``micro=4`` inside the port at the reference test's
  bars (ce 1e-4, grad_norm 1e-3, params rtol 5e-2 atol 5e-3), and the
  port's ``micro=4`` against the reference's at the f32 bars above;
* the four remat policies: bitwise equal gradients, and the backward
  recomputes exactly the products that a policy does not keep;
* a dropped MoE assignment's gradient: exactly 0;
* resume: bitwise inside the port; across the packages, both ways, the
  reference's bar (rtol 1e-5, f32) on the loss, and the one-step bar on
  the parameters (rtol 1e-5, atol 1e-4: after six Adam steps a gradient
  element near zero carries its sum-order difference into the update);
* ``permute_expert_axis``: bitwise the reference's permutation through
  ``train_state_to_arrays``; ``ExpertRebalancer``: identical decisions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro import configs as JC
from repro.ckpt import CheckpointManager as JCkpt
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.optim import AdamWConfig as JAdamW
from repro.train import expert_balance as JEB
from repro.train.step import make_train_step as jmake_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.interop import (train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import expert_balance as TEB
from repro_torch.train.step import (init_state, loss_fn,
                                    make_train_step)

FAMILIES = ["llama3p2_1b", "granite_moe_3b_a800m", "mamba2_2p7b",
            "hymba_1p5b", "phi3_vision_4p2b", "whisper_base"]
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
ENC_S = 24  # whisper's frames: another length than the text
F32 = dict(rtol=1e-5)
P_ATOL = 1e-4


def _cfg(name, dtype="float32", **kw):
    return dataclasses.replace(JC.reduced(JC.get(name)), dtype=dtype, **kw)


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def _ref_state(cfg, seed=0):
    """The reference's train state as numpy, every wo redrawn."""
    params = jax.tree.map(np.asarray,
                          JM.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for stack in ("layers", "enc_layers"):
        for grp in ("attn", "cross"):
            if grp in params.get(stack, {}):
                w = params[stack][grp]["wo"]
                params[stack][grp]["wo"] = (rng.normal(size=w.shape)
                                            * w.shape[1] ** -0.5
                                            ).astype(np.float32)
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params,
            "opt": {"m": zeros, "v": jax.tree.map(np.copy, zeros),
                    "step": np.asarray(0, np.int32)}}


def _jax_state(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(cfg, step=0, seq=32, batch=4, seed=1):
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batch(step)
    if cfg.num_patches:
        b["patches"] = np.random.default_rng(2).normal(
            size=(batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = np.random.default_rng(3).normal(
            size=(batch, ENC_S, cfg.d_model)).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_states_close(got, want, p_tol, m_rtol=1e-5):
    """Port state (as the reference's arrays) against the reference's:
    params at ``p_tol``, the moments at ``m_rtol`` plus 1e-5 of the leaf's
    largest magnitude."""
    g, w = _leaves(got), _leaves(_np_tree(want))
    assert g.keys() == w.keys()
    for k in w:
        if "['opt']" in k and "step" not in k:
            np.testing.assert_allclose(
                g[k], w[k], rtol=m_rtol,
                atol=1e-5 * float(np.abs(w[k]).max()), err_msg=k)
        elif "step" in k:
            assert int(g[k]) == int(w[k])
        else:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **p_tol)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if np.asarray(x).dtype != np.int32
                        else np.asarray(x), tree)


def _one_step(name, dtype, micro=1):
    cfg = _cfg(name, dtype)
    tree = _ref_state(cfg)
    b = _batch(cfg)
    js, jm = jax.jit(jmake_step(cfg, JAdamW(**OPT),
                                num_microbatches=micro))(
        _jax_state(tree), {k: jnp.asarray(v) for k, v in b.items()})
    pcfg = _port_cfg(cfg)
    state = train_state_from_arrays(pcfg, tree, device="cpu")
    ts, tm = make_train_step(pcfg, AdamWConfig(**OPT),
                             num_microbatches=micro)(state, _torch_batch(b))
    return cfg, (js, jm), (train_state_to_arrays(pcfg, ts), tm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_reference(name, dtype):
    cfg, (js, jm), (ts, tm) = _one_step(name, dtype)
    assert set(tm) == set(jm)
    if dtype == "float32":
        for k in ("loss", "ce", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                       **F32)
        _assert_states_close(ts, js, dict(rtol=1e-5, atol=P_ATOL))
    else:
        for k in ("loss", "ce", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=5e-2, atol=5e-2, err_msg=k)
        g, w = _leaves(ts["params"]), _leaves(_np_tree(js["params"]))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-2, atol=5e-2,
                                       err_msg=k)
    if cfg.num_experts:
        got, want = tm["expert_load"].numpy(), np.asarray(jm["expert_load"])
        if dtype == "float32":
            np.testing.assert_array_equal(got, want)
        else:  # compiled XLA flips near ties (tests/test_torch_models.py)
            assert got.sum() == want.sum()
            assert np.abs(got - want).max() <= 0.02 * want.sum()


def test_microbatch_equivalence():
    """micro=1 and micro=4 inside the port, at the reference test's bars
    (tests/test_train_ckpt_ft.py, bf16)."""
    cfg = _port_cfg(_cfg("llama3p2_1b", "bfloat16"))
    b = _torch_batch(SyntheticLM(cfg.vocab_size, 32, 8, seed=1).batch(0))
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    out = []
    for micro in (1, 4):
        state = init_state(cfg, torch.Generator().manual_seed(3))
        out.append(make_train_step(cfg, opt, num_microbatches=micro)(state,
                                                                     b))
    (s1, m1), (s4, m4) = out
    np.testing.assert_allclose(float(m1["ce"]), float(m4["ce"]), rtol=1e-4)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m4["grad_norm"]), rtol=1e-3)
    for (n, x), y in zip(s1["params"].named_parameters(),
                         s4["params"].parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=5e-2, atol=5e-3, err_msg=n)


@pytest.mark.parametrize("name", ["llama3p2_1b", "granite_moe_3b_a800m"])
def test_microbatches_match_reference(name):
    """micro=4 in both packages: the gradients summed from zero in row-block
    order and divided once, the loss and aux the blocks' means."""
    cfg, (js, jm), (ts, tm) = _one_step(name, "float32", micro=4)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **F32)
    _assert_states_close(ts, js, dict(rtol=1e-5, atol=P_ATOL))
    if cfg.num_experts:  # the blocks' mean of the per-block loads
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))


def test_use_kernel_raises():
    cfg = _port_cfg(_cfg("llama3p2_1b"))
    with pytest.raises(NotImplementedError, match="backward kernel"):
        make_train_step(cfg, AdamWConfig(), use_kernel=True)
    state = init_state(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Pallas"):
        loss_fn(state["params"], cfg,
                _torch_batch(SyntheticLM(128, 8, 1).batch(0)),
                use_kernel=True)


class _Count(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.ops:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_policies_bitwise(name, dtype):
    """The gradients under none, full, save_dots and save_all_dots are
    bitwise equal. The products the backward runs show what each policy
    keeps: ``full`` recomputes every product of the layers, ``save_dots``
    none of the unbatched ones (mm), ``save_all_dots`` none at all."""
    base = _port_cfg(_cfg(name, dtype))
    tree = _ref_state(_cfg(name, dtype), seed=4)
    model = train_state_from_arrays(base, tree, device="cpu")["params"]
    batch = _torch_batch(_batch(base, seq=16, batch=2))
    grads, ops = {}, {}
    for policy in TM.REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat_policy=policy)
        loss, _ = loss_fn(model, cfg, batch)
        with _Count() as c:
            grads[policy] = torch.autograd.grad(
                loss, list(model.parameters()), materialize_grads=True)
        ops[policy] = c.ops
    for policy, gs in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], gs)), \
            policy
    none, full = ops["none"], ops["full"]
    assert full["mm"] > none["mm"]  # every layer has an unbatched product
    assert ops["save_dots"]["mm"] == none["mm"]
    assert ops["save_all_dots"] == none
    assert ops["save_dots"]["bmm"] == full["bmm"]


def test_dropped_assignment_gradient_is_zero():
    """At capacity factor 0.25 most (token, slot) assignments drop: a token
    whose every assignment dropped has an output of exactly 0 and a
    gradient of exactly 0 (its buffer row C is never read back), and the
    gradients of x and every weight agree with the reference's (f32,
    rtol 1e-5)."""
    rng = np.random.default_rng(9)
    b, s, d, e, f, k = 2, 32, 16, 4, 8, 2
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.5,
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) * 0.3,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) * 0.3,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) * 0.3}
    ct = rng.normal(size=(b, s, d)).astype(np.float32)
    kw = dict(num_experts=e, top_k=k, capacity_factor=0.25)

    def jloss(x, p):
        y, _ = JMoE.moe_ffn(x, p, **kw)
        return jnp.sum(y * ct)
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    y, _ = TMoE.moe_ffn(tx, tp, **kw)
    gx, *gp = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                  [tx, *tp.values()])
    _, _, _, eidx = TMoE.route(tx.detach(), tp["router"].detach(),
                               num_experts=e, top_k=k)
    cap = TMoE.capacity(s, k, e, 0.25)
    _, row = TMoE._group_dispatch(tx.detach(), eidx, e, cap)
    dropped = (row % (cap + 1) == cap).all(-1)  # (B, S) every slot dropped
    assert 0 < int(dropped.sum()) < b * s
    assert torch.all(y.detach()[dropped] == 0)
    assert torch.all(gx[dropped] == 0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    for (n, _), g in zip(p.items(), gp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def _run(step, state, data, steps):
    m = None
    for i in steps:
        state, m = step(state, _torch_batch(data.batch(i)))
    return state, m


def test_resume_equivalence_in_port(tmp_path):
    """6 steps straight == 3 steps, checkpoint, restore, 3 more: bitwise."""
    cfg = _port_cfg(_cfg("llama3p2_1b", "bfloat16"))
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=7)
    step = make_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                            total_steps=10))
    s6, m6 = _run(step, init_state(cfg, torch.Generator().manual_seed(9)),
                  data, range(6))
    s3, _ = _run(step, init_state(cfg, torch.Generator().manual_seed(9)),
                 data, range(3))
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, train_state_to_arrays(cfg, s3))
    tree, meta = mgr.restore()
    sr, mr = _run(step, train_state_from_arrays(cfg, tree, device="cpu"),
                  data, range(meta["step"], 6))
    assert float(mr["loss"]) == float(m6["loss"])
    for a, b in zip(s6["params"].parameters(), sr["params"].parameters()):
        assert torch.equal(a, b)
    for mom in ("m", "v"):
        assert all(torch.equal(s6["opt"][mom][k], sr["opt"][mom][k])
                   for k in s6["opt"][mom])


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_packages(tmp_path, first):
    """One package trains 3 steps and saves with its CheckpointManager, the
    other restores and trains 3 more; the result matches the restoring
    package's 6 straight (f32, rtol 1e-5)."""
    cfg = _cfg("llama3p2_1b", "float32")
    pcfg = _port_cfg(cfg)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=7)
    tree = _ref_state(cfg, seed=9)
    jstep = jax.jit(jmake_step(cfg, JAdamW(**OPT)))
    tstep = make_train_step(pcfg, AdamWConfig(**OPT))

    def jrun(state, steps):
        m = None
        for i in steps:
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in
                                     data.batch(i).items()})
        return state, m

    if first == "reference":
        js, _ = jrun(_jax_state(tree), range(3))
        JCkpt(str(tmp_path), async_write=False).save(3, js)
        restored, meta = CheckpointManager(str(tmp_path)).restore()
        got, gm = _run(tstep, train_state_from_arrays(pcfg, restored,
                                                      device="cpu"),
                       data, range(meta["step"], 6))
        got = train_state_to_arrays(pcfg, got)
        want, wm = _run(tstep, train_state_from_arrays(pcfg, tree,
                                                       device="cpu"),
                        data, range(6))
        want = train_state_to_arrays(pcfg, want)
    else:
        ts, _ = _run(tstep, train_state_from_arrays(pcfg, tree,
                                                    device="cpu"), data,
                     range(3))
        CheckpointManager(str(tmp_path), async_write=False).save(
            3, train_state_to_arrays(pcfg, ts))
        restored, meta = JCkpt(str(tmp_path)).restore()
        restored = jax.tree.map(jnp.asarray, restored)
        restored["opt"]["step"] = jnp.asarray(restored["opt"]["step"],
                                              jnp.int32)
        got, gm = jrun(restored, range(meta["step"], 6))
        want, wm = jrun(_jax_state(tree), range(6))
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5)
    g, w = _leaves(_np_tree(got["params"])), _leaves(_np_tree(want["params"]))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=P_ATOL,
                                   err_msg=k)


def test_permute_expert_axis_matches_reference():
    cfg = _cfg("granite_moe_3b_a800m", pad_experts_to=6)
    pcfg = _port_cfg(cfg)
    tree = _ref_state(cfg, seed=5)
    rng = np.random.default_rng(6)
    for key in ("m", "v"):  # distinct moments, so a mixed-up axis shows
        tree["opt"][key] = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32),
            tree["opt"][key])
    # the real experts permuted among themselves: a padded expert moved
    # below num_experts would be routed (the reference's too)
    perm = np.concatenate([rng.permutation(cfg.num_experts),
                           np.arange(cfg.num_experts, cfg.experts_eff)])
    state = train_state_from_arrays(pcfg, tree, device="cpu")
    b = _torch_batch(_batch(cfg))
    with torch.no_grad():
        before, _ = loss_fn(state["params"], pcfg, b)
    TEB.permute_expert_axis(state["params"], perm)
    for mom in ("m", "v"):
        state["opt"][mom] = TEB.permute_expert_axis(state["opt"][mom], perm)
    got = train_state_to_arrays(pcfg, state)
    want = {"params": JEB.permute_expert_axis(tree["params"], perm),
            "opt": {mom: JEB.permute_expert_axis(tree["opt"][mom], perm)
                    for mom in ("m", "v")}}
    g, w = _leaves(got), _leaves(want)
    for k in w:
        assert np.array_equal(g[k], np.asarray(w[k])), k
    with torch.no_grad():
        after, _ = loss_fn(state["params"], pcfg, b)
    # function-preserving up to the combine's ascending-expert sum order
    np.testing.assert_allclose(float(after), float(before), rtol=1e-5)


def test_expert_rebalancer_decisions_match_reference():
    rng = np.random.default_rng(12)
    kw = dict(num_experts=16, num_shards=4, interval=5)
    ours, ref = TEB.ExpertRebalancer(**kw), JEB.ExpertRebalancer(**kw)
    hot = rng.permutation(16)[:3]
    moves = 0
    for step in range(1, 120):
        load = rng.poisson(50, 16).astype(np.float64)
        load[hot] *= 1 + (step % 7)  # a skewed, shifting load
        a, b = ours.observe(load, step), ref.observe(load, step)
        assert (a is None) == (b is None), step
        if a is not None:
            assert np.array_equal(a, b)
            moves += 1
    assert moves > 0 and ours.moves == ref.moves
    np.testing.assert_array_equal(ours.load_ema, ref.load_ema)
    assert (ours.next_at, ours.interval) == (ref.next_at, ref.interval)


ARGS = ["--reduced", "--steps", "6", "--batch", "2", "--seq", "16",
        "--log-every", "1", "--device", "cpu", "--lr", "1e-3"]


def test_launch_train_fail_at_and_resume(tmp_path, capsys):
    straight = launch_train.main(ARGS + ["--ckpt-dir",
                                         str(tmp_path / "straight")])
    crash = ARGS + ["--ckpt-dir", str(tmp_path / "crash")]
    with pytest.raises(SystemExit) as exc:
        launch_train.main(crash + ["--fail-at", "3"])
    assert exc.value.code == 42
    resumed = launch_train.main(crash)
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(straight) == 6 and resumed == straight[3:]
    # a model axis needs a group of ranks (--nproc): one process has none
    with pytest.raises(ValueError, match="--nproc"):
        launch_train.main(ARGS + ["--model-axis", "2"])


def test_launch_train_expert_rebalance_runs(capsys):
    losses = launch_train.main(["--arch", "granite_moe_3b_a800m",
                                "--expert-rebalance", *ARGS])
    assert len(losses) == 6 and np.all(np.isfinite(losses))


def test_loss_decreases():
    """The synthetic affine-recurrence task is learnable: a solid drop in
    60 steps (the reference's test runs 150 at seq 64)."""
    cfg = _port_cfg(_cfg("llama3p2_1b", "bfloat16"))
    data = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    step = make_train_step(cfg, AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                            total_steps=60))
    state = init_state(cfg, torch.Generator().manual_seed(0))
    losses = []
    for i in range(60):
        state, m = step(state, _torch_batch(data.batch(i)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < 0.8 * np.mean(losses[:5]), \
        (losses[:5], losses[-5:])
