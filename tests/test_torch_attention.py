"""The port's attention paths and layer math against the reference's, on the
same inputs (numpy draws from a seed, handed to both packages).

* Kernel 4: ``repro_torch.kernels.flash_attention.flash_attention`` on the
  CPU (its plain version) against the reference's Pallas kernel in
  interpret mode (``repro.kernels.ops.flash_attention``, as
  ``tests/test_kernels.py`` runs it) and against its quadratic oracle
  ``repro.kernels.ref.attention``, at that test's shapes plus GQA groups 5
  and 8, causal and full: f32 at 2e-5, bf16 at 2e-2 (the reference test's
  tolerances). The port's oracle ``attention`` is held to the same.
* The roundings of kernel 4's bf16 tensor-core route
  (``_torch_parity.emulate_flash_tc``: bf16 products summed in f32, the
  scale after the product, P rounded to bf16 for P v) against the same two
  reference functions, at bf16 2e-2, D = 64 and 128, GQA groups 4 and 5,
  causal and full.
* ``full_attention``, ``chunked_attention`` (S = 2048, as
  ``test_chunked_attention_matches_full``), ``decode_attention`` and
  ``update_cache`` against ``repro.models.attention``, f32 at 2e-5.
* ``rms_norm``, ``apply_rope`` (with a position offset) and ``swiglu``
  against ``repro.models.layers``: f32 at 1e-5; bf16 at 2e-2 (swiglu's
  absolute bar scaled to its output: the two frameworks round the d_ff
  intermediate at other places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import emulate_flash_tc
from _torch_parity import one_torch_thread  # noqa: F401

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JAttn
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TAttn
from repro_torch.models import layers as TL

FLASH_SHAPES = [(1, 4, 2, 256, 64), (2, 8, 4, 128, 128), (1, 2, 1, 512, 64),
                (1, 8, 8, 128, 64), (1, 10, 2, 256, 128), (1, 8, 1, 128, 128)]


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    ("float32" or "bfloat16"): rounded to bf16 once, by JAX."""
    j = jnp.asarray(np.asarray(a, np.float32), dtype=jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


@pytest.mark.parametrize("b,hq,hkv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(b, hq, hkv, s, d, causal, dtype):
    rng = np.random.default_rng(hq * 1000 + s + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(b, h, s, d)), dtype) for h in (hq, hkv, hkv))
    got = FA.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (b, hq, s, d)
    tol = _tol(dtype)
    pallas = _np(jops.flash_attention(jq, jk, jv, causal=causal))
    oracle = _np(jref.attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(_np(got), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), oracle, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(FA.attention(tq, tk, tv, causal=causal)), oracle, rtol=tol,
        atol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d", [(1, 8, 2, 256, 64),
                                           (1, 10, 2, 384, 64),
                                           (1, 4, 1, 256, 128),
                                           (1, 5, 1, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_roundings_match_reference(b, hq, hkv, s, d, causal):
    rng = np.random.default_rng(hq * 100 + s + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(b, h, s, d)), "bfloat16")
        for h in (hq, hkv, hkv))
    got = emulate_flash_tc(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, s, d)
    pallas = _np(jops.flash_attention(jq, jk, jv, causal=causal))
    oracle = _np(jref.attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(_np(got), pallas, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), oracle, rtol=2e-2, atol=2e-2)


def test_tensor_core_route_takes_the_models_views_in_place():
    """The bf16 route's TMA reads a tensor through its strides when the last
    one is 1 and the others are whole 16-byte units: the model's transposed
    (B, S, H, D) projections pass; other layouts are made contiguous."""
    x = torch.zeros(2, 256, 10, 64, dtype=torch.bfloat16)
    assert FA._strides_ok(x.transpose(1, 2))
    assert FA._strides_ok(x.transpose(1, 2).contiguous())
    assert not FA._strides_ok(x.transpose(1, 3))  # D not the unit stride
    assert not FA._strides_ok(torch.zeros(2, 10, 256, 68)[..., 2:66])


def test_flash_attention_needs_a_multiple_of_128():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="S % 128"):
        FA.flash_attention(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_reference(causal):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 40, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    want = JAttn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    got = TAttn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_chunked_attention_matches_reference():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 2048, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    want = JAttn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TAttn.chunked_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    full = TAttn.full_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(full), rtol=2e-5, atol=2e-5)


def test_decode_attention_and_update_cache_match_reference():
    rng = np.random.default_rng(3)
    kc, vc = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
              for _ in range(2))
    nk, nv = (rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
              for _ in range(2))
    jk, jv = JAttn.update_cache(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(nk), jnp.asarray(nv), 7)
    tk, tv = TAttn.update_cache(torch.from_numpy(kc.copy()),
                                torch.from_numpy(vc.copy()),
                                torch.from_numpy(nk), torch.from_numpy(nv), 7)
    assert np.array_equal(_np(tk), _np(jk)) and np.array_equal(_np(tv),
                                                               _np(jv))
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    for pos in (0, 9, 39):
        want = JAttn.decode_attention(jnp.asarray(q), jk, jv, pos)
        got = TAttn.decode_attention(torch.from_numpy(q), tk, tv, pos)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(4)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    jx, tx = _pair(rng.normal(size=(3, 5, 64)) * 3.0, dtype)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(tx, torch.from_numpy(w))),
        _np(JL.rms_norm(jx, jnp.asarray(w))), **tol)
    # RoPE at positions with an offset, the split-half form
    jr, tr = _pair(rng.normal(size=(2, 10, 4, 16)), dtype)
    pos = np.arange(10, dtype=np.int32)[None] + 37
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            _np(TL.apply_rope(tr, torch.from_numpy(pos), theta)),
            _np(JL.apply_rope(jr, jnp.asarray(pos), theta)), **tol)
    # at the model's init scale; in bf16 the two frameworks round the
    # (B, S, d_ff) intermediate at other places, so the bar is one bf16
    # rounding of the output's scale
    wg, wu, wd = (_pair(rng.normal(size=shp) * shp[0] ** -0.5, dtype)
                  for shp in ((64, 96), (64, 96), (96, 64)))
    got = TL.swiglu(tx, wg[1], wu[1], wd[1])
    want = _np(JL.swiglu(jx, wg[0], wu[0], wd[0]))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * np.abs(want).max())


def test_initializers_take_a_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = TL.dense_init(g1, (256, 128))
    assert torch.equal(a, TL.dense_init(g2, (256, 128)))
    assert abs(float(a.std()) - 256 ** -0.5) < 0.01
    e = TL.embed_init(g1, (512, 64))
    assert abs(float(e.std()) - 0.02) < 0.002
