"""The port's training substrate against the reference's: the synthetic
data pipeline, the straggler monitor, AdamW with its cosine schedule, and
int8 error-feedback compression (``repro_torch.data``, ``.ft``,
``.optim``) against ``repro.data``, ``repro.ft`` and ``repro.optim`` on the
same numpy inputs.

Bars:

* ``SyntheticLM`` batches and shards, ``StragglerMonitor`` outputs, and
  ``int8_encode``'s ``q``: bitwise;
* ``cosine_lr`` at every step from 0 to ``total_steps``: bitwise in the
  warmup, then within one f32 ulp of the cosine (XLA's ``cos`` and
  torch's round apart by one) times its amplitude, plus one rounding;
* ``adamw_update`` on a multi-leaf tree (clip on and off, with decay):
  params, ``m`` and ``v`` at rtol 1e-6 plus an atol of 1e-6 times the
  leaf's largest magnitude (the bitwise share is printed). With the clip
  on, the scale carries the global norm's sum-order ulp, and ``m = b1 m +
  (1 - b1) g`` cancels where g turns sign, so that error is relative to
  the leaf, not to the element;
  ``grad_norm`` at rtol 1e-6; the reference's closed-form case at 1e-5,
  as the reference's own test;
* ``ef_compress_psum`` on gloo: a world of one against the reference's
  formula bitwise (its ``psum`` over one device is the identity), four
  ranks against the numpy mean of the four dequantised inputs at rtol
  1e-6 (the all-reduce's sum order is gloo's).
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_parity import one_torch_thread  # noqa: F401

from repro.data import SyntheticLM as JData
from repro.ft import StragglerMonitor as JMonitor
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.data import SyntheticLM
from repro_torch.ft import StragglerMonitor
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_lr, ef_compress_psum, int8_decode,
                               int8_encode)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 128, 64, 8),
                                                  (7, 129024, 33, 3)])
def test_synthetic_lm_bitwise(seed, vocab, seq, batch):
    ours, ref = (cls(vocab, seq, batch, seed=seed)
                 for cls in (SyntheticLM, JData))
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    if batch % 2 == 0:
        for host in range(2):
            a, b = ours.build_shard(5, host, 2), ref.build_shard(5, host, 2)
            assert all(np.array_equal(a[k], b[k]) for k in b)


def test_straggler_monitor_bitwise():
    rng = np.random.default_rng(3)
    times = rng.gamma(4.0, 0.05, 200)
    times[rng.random(200) < 0.08] *= 6.0  # seeded straggler bursts
    ours = StragglerMonitor(deadline_factor=2.0, evict_after=2)
    ref = JMonitor(deadline_factor=2.0, evict_after=2)
    outs = [(ours.observe(float(t)), ref.observe(float(t))) for t in times]
    assert all(a == b for a, b in outs)
    assert (ours.ema, ours.events, ours.consecutive) == (
        ref.ema, ref.events, ref.consecutive)
    assert ours.events > 0 and any(a["evict"] for a, _ in outs)


def test_cosine_lr_within_an_ulp_of_the_cosine():
    """Bitwise through the warmup; after it, XLA's ``cos`` and torch's
    round apart by at most one f32 ulp, and the lr by at most that ulp
    times the amplitude ``0.5 * (peak - min)`` plus one rounding: near
    ``total_steps`` ``1 + cos`` cancels, so the lr's own ulps there grow
    (5 at step 197 of 200)."""
    kw = dict(peak_lr=3e-4, min_lr=3e-5, warmup_steps=20, total_steps=200)
    ours, ref = AdamWConfig(**kw), JAdamW(**kw)
    got = np.array([float(cosine_lr(ours, s, device="cpu"))
                    for s in range(201)], np.float32)
    want = np.array([float(jadamw.cosine_lr(ref, s)) for s in range(201)],
                    np.float32)
    assert np.array_equal(got[:21], want[:21])
    t = np.clip((np.arange(201, dtype=np.float32) - 20) / np.float32(180),
                0, 1).astype(np.float32)
    cj = np.asarray(jnp.cos(jnp.pi * jnp.asarray(t)))
    ct = torch.cos(torch.pi * torch.from_numpy(t)).numpy()
    assert np.abs(cj.view(np.int32) - ct.view(np.int32)).max() <= 1
    amp = 0.5 * (kw["peak_lr"] - kw["min_lr"])
    bound = amp * 2.0 ** -23 + np.spacing(want)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    # a tensor step (the optimizer's) gives the same as an int
    assert float(cosine_lr(ours, torch.tensor(57, dtype=torch.int32))) == \
        float(cosine_lr(ours, 57, device="cpu"))


def _tree(rng):
    shapes = {"embed": (64, 16), "layers.0.w": (16, 24),
              "layers.0.ln": (16,), "layers.1.w": (16, 24),
              "layers.1.ln": (16,), "ln_f": (16,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (1e9, 0.1), (0.5, 0.0)],
                         ids=["clip", "no-clip", "clip-no-decay"])
def test_adamw_update_matches_reference(clip, wd):
    rng = np.random.default_rng(11)
    p0 = _tree(rng)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=wd, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jadamw.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = adamw_init(tp)
    shares = []
    for _ in range(4):  # the bias corrections and the schedule move
        g = {k: (rng.normal(size=v.shape) * 3).astype(np.float32)
             for k, v in p0.items()}
        jp, jst, jm = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
            JAdamW(**kw))
        tp, tst, tm = adamw_update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, tst, tp,
                                   AdamWConfig(**kw))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(tst["step"]) == int(jst["step"])
        for name in p0:
            for got, want in ((tp[name], jp[name]), (tst["m"][name],
                                                     jst["m"][name]),
                              (tst["v"][name], jst["v"][name])):
                got, want = got.numpy(), np.asarray(want)
                np.testing.assert_allclose(
                    got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                    err_msg=name)
                shares.append(np.mean(got == want))
    print(f"adamw clip={clip} wd={wd}: bitwise share "
          f"{np.mean(shares):.4f}")


def test_adamw_math_vs_closed_form():
    """The reference's own closed-form case (tests/test_train_ckpt_ft.py),
    on the port."""
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, clip_norm=1e9)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.1, 0.2])}
    st = adamw_init(p)
    new_p, st, _ = adamw_update(g, st, p, cfg)
    m = 0.1 * np.array([0.1, 0.2])
    v = 0.05 * np.array([0.1, 0.2]) ** 2
    mhat, vhat = m / 0.1, v / 0.05
    lr = float(cosine_lr(cfg, 1, device="cpu"))
    want = np.array([1.0, -2.0]) - lr * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1


def test_int8_encode_bitwise():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=1000).astype(np.float32),
              # exact halves of the scale: round half to even on both sides
              np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0],
                       np.float32)):
        q, s = int8_encode(torch.from_numpy(x))
        jq, js = jcomp.int8_encode(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(int8_decode(q, s).numpy(),
                                      np.asarray(jcomp.int8_decode(jq, js)))
        err = np.abs(int8_decode(q, s).numpy() - x)
        assert err.max() <= float(s) * 0.5 + 1e-7


def _ef_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return ({"a": rng.normal(size=(8, 5)).astype(np.float32),
             "b": (rng.normal(size=33) * 1e-3).astype(np.float32)},
            {"a": (rng.normal(size=(8, 5)) * 1e-2).astype(np.float32),
             "b": (rng.normal(size=33) * 1e-5).astype(np.float32)})


def _ef_reference(g, r):
    """The reference's ``ef_compress_psum`` per leaf, its psum over one
    device being the identity (and n = 1)."""
    gf = jnp.asarray(g) + jnp.asarray(r)
    q, s = jcomp.int8_encode(gf)
    deq = jcomp.int8_decode(q, s)
    return np.asarray(deq / 1.0), np.asarray(gf - deq)


def test_ef_compress_psum_world_of_one(tmp_path):
    g, r = _ef_inputs(0)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        out, res = ef_compress_psum(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in r.items()})
    finally:
        dist.destroy_process_group()
    for k in g:
        want, want_r = _ef_reference(g[k], r[k])
        assert np.array_equal(out[k].numpy(), want), k
        assert np.array_equal(res[k].numpy(), want_r), k


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[3])
    from test_torch_optim import _ef_inputs
    from repro_torch.optim import ef_compress_psum
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", rank=rank, world_size=4,
                            store=dist.FileStore(tmp + "/store", 4))
    g, r = _ef_inputs(rank)
    out, res = ef_compress_psum(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()})
    dist.barrier()
    dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **{f"out_{k}": v.numpy()
             for k, v in out.items()},
             **{f"res_{k}": v.numpy() for k, v in res.items()})
""")


def test_ef_compress_psum_four_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(tmp_path), os.path.join(ROOT, "tests")],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
    deq, gfs = {}, {}
    for rank in range(4):
        g, r = _ef_inputs(rank)
        for k in g:
            gf = g[k] + r[k]
            scale = np.float32(np.abs(gf).max() / np.float32(127.0)
                               + np.float32(1e-12))
            q = np.clip(np.round(gf / scale), -127, 127)
            deq.setdefault(k, []).append(q.astype(np.float32) * scale)
            gfs.setdefault(k, []).append(gf)
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for k in deq:
            np.testing.assert_allclose(got[f"out_{k}"],
                                       np.mean(deq[k], axis=0), rtol=1e-6,
                                       atol=1e-9)
            # each rank keeps its own residual: what quantization lost
            np.testing.assert_array_equal(
                got[f"res_{k}"], gfs[k][rank] - deq[k][rank])
