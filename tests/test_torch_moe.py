"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same inputs.

Both get the same numpy draws: x, the router, the experts (and shared
experts), in f32 or cast to bf16 first, as the reference's model casts the
whole ``moe`` subtree. The bar: f32 outputs within 1e-5 (the expert
products' sum order is the only difference), bf16 within 2e-2 (the
reference's bf16 einsums and the port's bmm round the same products,
summed in other orders), the router's top-k indices equal to the
reference's ``lax.top_k`` of its own softmax, and the aux losses and loads
within the f32 bar (loads exactly)."""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.models import moe as JMOE
from repro_torch.models import moe as TMOE

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _params(rng, d, e, fe, shared=0, router_scale=1.0):
    p = {"router": rng.normal(size=(d, e)) * router_scale,
         "w_gate": rng.normal(size=(e, d, fe)) * d ** -0.5,
         "w_up": rng.normal(size=(e, d, fe)) * d ** -0.5,
         "w_down": rng.normal(size=(e, fe, d)) * fe ** -0.5}
    if shared:
        fs = shared * fe
        p.update(shared_gate=rng.normal(size=(d, fs)) * d ** -0.5,
                 shared_up=rng.normal(size=(d, fs)) * d ** -0.5,
                 shared_down=rng.normal(size=(fs, d)) * fs ** -0.5)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(x, params, dtype):
    """(jax x, jax params, torch x, torch params) in ``dtype``."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    return (jnp.asarray(x, jd), {k: jnp.asarray(v, jd)
                                 for k, v in params.items()},
            torch.from_numpy(x).to(td),
            {k: torch.from_numpy(v).to(td) for k, v in params.items()})


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _reference_topk(jx, router, top_k, real):
    """The reference's routing, as its moe_ffn computes it."""
    logits = jx.astype(jnp.float32) @ router.astype(jnp.float32)
    e = router.shape[-1]
    if real < e:
        logits = jnp.where(jnp.arange(e)[None, None] >= real, -1e30, logits)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), top_k)[1])


def _check(x, params, dtype, **kw):
    """moe_ffn of both packages on the same inputs: outputs, top-k indices
    and aux; returns the port's (y, aux, eidx)."""
    jx, jp, tx, tp = _both(x, params, dtype)
    want, jaux = JMOE.moe_ffn(jx, jp, **kw)
    got, aux = TMOE.moe_ffn(tx, tp, **kw)
    real = kw.get("num_real_experts") or kw["num_experts"]
    eidx = TMOE.route(tx, tp["router"], num_experts=kw["num_experts"],
                      top_k=kw["top_k"], num_real_experts=real)[3]
    assert np.array_equal(eidx.numpy(), _reference_topk(
        jx, jp["router"], kw["top_k"], real))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(_f32(aux[key]), _f32(jaux[key]),
                                   rtol=1e-5, atol=1e-5)
    assert np.array_equal(_f32(aux["expert_load"]),
                          _f32(jaux["expert_load"]))
    return got, aux, eidx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
@pytest.mark.parametrize("shared", [0, 2])
def test_moe_ffn_matches_reference(dtype, cf, shared):
    """Three groups of 48 tokens, 8 experts top-2 (capacity 12, 15 and 24
    rows: the first two drop), with and without shared experts."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 48, 32)).astype(np.float32)
    _check(x, _params(rng, 32, 8, 16, shared), dtype, num_experts=8,
           top_k=2, capacity_factor=cf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_with_padded_experts_matches_reference(dtype):
    """6 real experts padded to 8 (zero weights and router columns, as
    ``init_params`` pads them): padded experts are never routed, carry no
    load, and the output equals the reference's."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 40, 32)).astype(np.float32)
    params = _params(rng, 32, 8, 16)
    for key in ("w_gate", "w_up", "w_down"):
        params[key][6:] = 0.0
    params["router"][:, 6:] = 0.0
    _, aux, eidx = _check(x, params, dtype, num_experts=8, top_k=3,
                          num_real_experts=6)
    assert int(eidx.max()) < 6 and not aux["expert_load"][6:].any()


def test_moe_routing_invariants():
    """The reference's test_moe_routing_invariants on the port: no drops
    at cf = 8, every token routed to k experts, lb_loss at least 1."""
    rng = np.random.default_rng(0)
    d, e, fe, k = 16, 8, 8, 2
    x = torch.from_numpy(rng.normal(size=(2, 32, d)).astype(np.float32))
    params = {
        "router": rng.normal(size=(d, e)).astype(np.float32),
        "w_gate": rng.normal(size=(e, d, fe)).astype(np.float32),
        "w_up": rng.normal(size=(e, d, fe)).astype(np.float32),
        "w_down": rng.normal(size=(e, fe, d)).astype(np.float32) * 0.1,
    }
    y, aux = TMOE.moe_ffn(x, {k_: torch.from_numpy(v)
                              for k_, v in params.items()},
                          num_experts=e, top_k=k, capacity_factor=8.0)
    assert y.shape == x.shape
    assert float(aux["expert_load"].sum()) == 2 * 32 * k
    assert float(aux["lb_loss"]) >= 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_drops_and_ties_match_reference(dtype):
    """The reference's test_moe_capacity_drops_are_bounded, held against
    the reference: a zero router ties all 4 experts for every token, the
    ties go to the lowest ids (experts 0 and 1, as ``lax.top_k``), and at
    cf = 1 each of them takes 32 of the 64 tokens: tokens 32-63 drop from
    both and read back exactly 0."""
    rng = np.random.default_rng(1)
    d, e, k = 8, 4, 2
    x = rng.normal(size=(1, 64, d)).astype(np.float32)
    params = {"router": np.zeros((d, e), np.float32),
              "w_gate": rng.normal(size=(e, d, 8)).astype(np.float32),
              "w_up": rng.normal(size=(e, d, 8)).astype(np.float32),
              "w_down": rng.normal(size=(e, 8, d)).astype(np.float32)}
    y, aux, eidx = _check(x, params, dtype, num_experts=e, top_k=k,
                          capacity_factor=1.0)
    assert torch.all(eidx == torch.tensor([0, 1]))
    assert torch.isfinite(y).all() and y[0, :32].abs().sum() > 0
    assert not y[0, 32:].any()
    assert aux["expert_load"].tolist() == [64.0, 64.0, 0.0, 0.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_tie_goes_to_the_lower_expert(dtype):
    """Experts 1 and 3 have the same router column: their probabilities are
    equal for every token. Expert 0's column is large, so it always leads,
    and the second slot goes to the tie: expert 1, the lower id, as
    ``lax.top_k`` breaks ties (``torch.topk`` does not say)."""
    rng = np.random.default_rng(2)
    d, e = 16, 4
    x = np.abs(rng.normal(size=(2, 24, d))).astype(np.float32)
    params = _params(rng, d, e, 8)
    col = np.abs(rng.normal(size=d)).astype(np.float32)
    params["router"][:, 0] = 3.0 * col
    params["router"][:, 1] = params["router"][:, 3] = col
    params["router"][:, 2] = -col
    _, _, eidx = _check(x, params, dtype, num_experts=e, top_k=2,
                        capacity_factor=4.0)
    assert torch.all(eidx == torch.tensor([0, 1]))


def test_permuted_experts_give_the_permuted_routing():
    """Within the port: experts (and router columns) reordered by a
    permutation route each token to the same experts under their new ids,
    in the same order, and the output stays within the f32 bar (the
    combine adds in ascending expert id, so the order of its adds moves
    with the ids: not bitwise)."""
    rng = np.random.default_rng(3)
    d, e, k = 32, 8, 3
    x = torch.from_numpy(rng.normal(size=(2, 40, d)).astype(np.float32))
    params = {k_: torch.from_numpy(v)
              for k_, v in _params(rng, d, e, 16, shared=1).items()}
    perm = torch.from_numpy(rng.permutation(e))  # new expert i = old perm[i]
    moved = dict(params, router=params["router"][:, perm],
                 **{k_: params[k_][perm] for k_ in ("w_gate", "w_up",
                                                    "w_down")})
    kw = dict(num_experts=e, top_k=k, capacity_factor=1.0)
    y0, aux0 = TMOE.moe_ffn(x, params, **kw)
    y1, aux1 = TMOE.moe_ffn(x, moved, **kw)
    e0 = TMOE.route(x, params["router"], num_experts=e, top_k=k)[3]
    e1 = TMOE.route(x, moved["router"], num_experts=e, top_k=k)[3]
    assert torch.equal(perm[e1], e0)
    assert torch.equal(aux1["expert_load"], aux0["expert_load"][perm])
    np.testing.assert_allclose(_f32(y1), _f32(y0), rtol=1e-5, atol=1e-5)


def test_expert_activity_and_rebalance_plan_equal_reference():
    rng = np.random.default_rng(4)
    for e, shards in ((8, 4), (40, 8), (64, 16)):
        ema, now = rng.uniform(0, 50, e), rng.uniform(0, 50, e)
        for a, b in zip(TMOE.expert_activity(ema, now),
                        JMOE.expert_activity(ema, now)):
            assert np.array_equal(a, b)
        act = rng.pareto(1.5, e)
        assert np.array_equal(TMOE.rebalance_plan(act, shards),
                              JMOE.rebalance_plan(act, shards))
    plan = TMOE.rebalance_plan(np.array([100.0, 90, 80, 70, 1, 1, 1, 1]),
                               num_shards=4)
    assert len(set((plan // 2)[:4])) == 4


def test_dispatch_makes_no_host_sync():
    """What would make the card wait for the host is absent from the
    dispatch path: no .item(), .tolist(), .cpu(), .numpy(), nonzero,
    bincount (its CUDA path reads the largest id back) or boolean-mask
    indexing."""
    banned = {"item", "tolist", "cpu", "numpy", "nonzero", "bincount",
              "masked_select", "unique"}
    for fn in (TMOE.route, TMOE._group_dispatch, TMOE._group_combine,
               TMOE.moe_ffn):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        names = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert not names & banned, (fn.__name__, names & banned)
