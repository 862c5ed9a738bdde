"""The port's SSD pieces against the reference's, on the same inputs (numpy
draws from a seed, handed to both packages).

* Kernel 5: ``repro_torch.kernels.ssd_scan.ssd_intra_chunk`` on the CPU (its
  plain version) against the reference's Pallas kernel in interpret mode
  (``repro.kernels.ops.ssd_intra_chunk``, as ``tests/test_kernels.py`` runs
  it) at that test's three shapes plus one at the model's Q = 256, at its
  tolerance (rtol=1e-5, atol=1e-4 * max|y|); the heads form (b and c shared
  by the heads) against the same kernel on the flattened cells.
* ``ssd_chunked`` on both routes (the einsum, and ``use_kernel``) against
  the reference's ``ssd_chunked`` and its sequential oracle
  ``repro.kernels.ref.ssd_scan`` at ``tests/test_kernels.py``'s bar
  (rtol=1e-4, atol=1e-4 * max|y|), final states included.
* ``ssd_decode_step`` continuing a prefill, and ``causal_conv`` streaming,
  against the reference's functions (rtol = atol = 1e-4 and 1e-5).
* A decay that overflows above the diagonal: exp(l_q - l_s) is inf there,
  and both routes and the kernel's plain version stay finite and agree
  with the reference.
* Kernel 5's arithmetic (3xTF32 on the tensor cores), re-enacted on the
  CPU by ``_torch_parity.emulate_ssd_tc``, against the plain version and
  the Pallas kernel at the kernel's bar (rtol=1e-5, atol=1e-4 * max|y|):
  the reference test's three shapes, and heads-form inputs drawn as the
  model draws them (exp overflows above the diagonal), with a ragged Q and
  an N that is 4 mod 8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import emulate_ssd_tc
from _torch_parity import one_torch_thread  # noqa: F401

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as K5
from repro_torch.models import ssm as TS

# (G, Q, N, P): tests/test_kernels.py's three, then the model's chunk
INTRA_SHAPES = [(4, 64, 32, 16), (2, 128, 128, 64), (6, 128, 64, 128),
                (2, 256, 16, 64)]
# (B, S, H, P, N, chunk): tests/test_kernels.py's three, then the model's
CHUNKED_SHAPES = [(2, 256, 4, 16, 32, 64), (1, 128, 2, 8, 16, 128),
                  (2, 512, 3, 32, 64, 128), (1, 512, 5, 16, 16, 256)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _intra_inputs(rng, g, q, n, p, h=None, decay=0.1):
    lead = (g, q) if h is None else (g, q, h)
    c = rng.normal(size=(g, q, n)).astype(np.float32)
    b = rng.normal(size=(g, q, n)).astype(np.float32)
    u = rng.normal(size=lead + (p,)).astype(np.float32)
    ld = np.cumsum(rng.uniform(-decay, 0, size=lead).astype(np.float32),
                   axis=1)
    return c, b, u, ld


def _close(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * 10 * float(np.abs(want).max()))


@pytest.mark.parametrize("g,q,n,p", INTRA_SHAPES)
def test_intra_chunk_matches_pallas(g, q, n, p):
    c, b, u, ld = _intra_inputs(np.random.default_rng(g * q + n + p),
                                g, q, n, p)
    want = jops.ssd_intra_chunk(*map(jnp.asarray, (c, b, u, ld)))
    got = K5.ssd_intra_chunk(*map(torch.from_numpy, (c, b, u, ld)))
    assert got.shape == (g, q, p) and got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_intra_chunk_heads_form_shares_b_and_c():
    """The heads form equals the reference signature on the cells with b
    and c repeated per head, and keeps u's dtype (bf16 in, bf16 out)."""
    g, q, n, p, h = 3, 128, 32, 16, 5
    c, b, u, ld = _intra_inputs(np.random.default_rng(7), g, q, n, p, h=h)
    flat = [np.repeat(c, h, 0), np.repeat(b, h, 0),
            u.transpose(0, 2, 1, 3).reshape(g * h, q, p),
            ld.transpose(0, 2, 1).reshape(g * h, q)]
    want = jops.ssd_intra_chunk(*map(jnp.asarray, flat))
    want = np.asarray(want).reshape(g, h, q, p).transpose(0, 2, 1, 3)
    got = K5.ssd_intra_chunk(*map(torch.from_numpy, (c, b, u, ld)))
    assert got.shape == (g, q, h, p)
    _close(got, want, 1e-5)
    tc, tb, tu, tl = map(torch.from_numpy, (c, b, u, ld))
    got16 = K5.ssd_intra_chunk(tc, tb, tu.bfloat16(), tl)
    assert got16.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs c, b"):
        K5.ssd_intra_chunk(tc, tb, tu, tl[..., 0])


def _ssd_inputs(rng, bsz, s, h, p, n, a_hi=2.0, dt_hi=0.1):
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    a_log = rng.uniform(0, a_hi, size=(h,)).astype(np.float32)
    b = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, n)).astype(np.float32)
    dt = rng.uniform(1e-3, dt_hi, (bsz, s, h)).astype(np.float32)
    return x, a_log, b, c, dt


@pytest.mark.parametrize("bsz,s,h,p,n,chunk", CHUNKED_SHAPES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_reference(bsz, s, h, p, n, chunk, use_kernel):
    args = _ssd_inputs(np.random.default_rng(s + h + p), bsz, s, h, p, n)
    jy, jstate = JS.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                                return_state=True)
    oracle = jref.ssd_scan(*map(jnp.asarray, args))
    ty, tstate = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                                return_state=True, use_kernel=use_kernel)
    assert ty.shape == (bsz, s, h, p) and tstate.dtype == torch.float32
    scale = float(np.abs(_np(oracle)).max())
    for want in (jy, oracle):
        np.testing.assert_allclose(_np(ty), _np(want), rtol=1e-4,
                                   atol=1e-4 * scale)
    np.testing.assert_allclose(_np(tstate), _np(jstate), rtol=1e-4,
                               atol=1e-4 * float(np.abs(_np(jstate)).max()))


def test_ssd_chunked_keeps_the_input_dtype():
    args = _ssd_inputs(np.random.default_rng(3), 1, 64, 2, 8, 16)
    x = torch.from_numpy(args[0]).bfloat16()
    rest = [torch.from_numpy(a) for a in args[1:]]
    y = TS.ssd_chunked(x, *rest, chunk=32)
    want = JS.ssd_chunked(jnp.asarray(args[0], jnp.bfloat16),
                          *map(jnp.asarray, args[1:]), chunk=32)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(want), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="not divisible"):
        TS.ssd_chunked(x[:, :48], *[a[:, :48] if a.dim() > 1 else a
                                    for a in rest], chunk=32)


def test_ssd_decode_continues_prefill():
    """The reference's test_ssd_decode_continues_prefill on both packages:
    each decode step and the carried state against the reference's."""
    x, a_log, b, c, dt = _ssd_inputs(np.random.default_rng(5), 1, 64, 2, 8,
                                     16)
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, a=a_log, b=b, c=c, dt=dt).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    ty, tstate = TS.ssd_chunked(t["x"][:, :32], t["a"], t["b"][:, :32],
                                t["c"][:, :32], t["dt"][:, :32], chunk=32,
                                return_state=True)
    _, jstate = JS.ssd_chunked(j["x"][:, :32], j["a"], j["b"][:, :32],
                               j["c"][:, :32], j["dt"][:, :32], chunk=32,
                               return_state=True)
    ys = []
    for s in range(32, 64):
        tstate, y = TS.ssd_decode_step(tstate, t["x"][:, s], t["a"],
                                       t["b"][:, s], t["c"][:, s],
                                       t["dt"][:, s])
        jstate, jy = JS.ssd_decode_step(jstate, j["x"][:, s], j["a"],
                                        j["b"][:, s], j["c"][:, s],
                                        j["dt"][:, s])
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-4, atol=1e-4)
        ys.append(y)
    np.testing.assert_allclose(_np(tstate), _np(jstate), rtol=1e-4,
                               atol=1e-4)
    full = TS.ssd_chunked(t["x"], t["a"], t["b"], t["c"], t["dt"], chunk=32)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(full[:, 32:]),
                               rtol=1e-4, atol=1e-4)


def test_causal_conv_streaming():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    jfull, jcache = JS.causal_conv(jnp.asarray(x), jnp.asarray(w))
    full, cache = TS.causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(_np(full), _np(jfull), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache), _np(jcache), rtol=1e-5,
                               atol=1e-5)
    cache = torch.zeros(2, 3, 6)
    outs = []
    for s in range(16):
        o, cache = TS.causal_conv(torch.from_numpy(x[:, s:s + 1]),
                                  torch.from_numpy(w), cache)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(jfull),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache), x[:, -3:], rtol=0, atol=0)


def test_overflowing_decay_stays_finite():
    """Mamba2's decay rates (A up to 16, dt up to 1) make exp(l_q - l_s)
    overflow to inf above the diagonal of a 256-step chunk. The decay is
    selected there, never multiplied: both routes and the kernel's plain
    version stay finite and agree with the reference."""
    args = _ssd_inputs(np.random.default_rng(11), 1, 256, 3, 16, 16,
                       a_hi=np.log(16.0), dt_hi=1.0)
    x, a_log, _, _, dt = args
    ld = np.cumsum(dt * -np.exp(a_log), axis=1)
    assert ld[0, -1].min() < -89.0  # exp(-ld) overflows f32 above the diagonal
    jy = JS.ssd_chunked(*map(jnp.asarray, args), chunk=256)
    assert np.isfinite(_np(jy)).all()
    for use_kernel in (False, True):
        ty = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=256,
                            use_kernel=use_kernel)
        assert torch.isfinite(ty).all()
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(_np(jy)).max()))
    c, b, u, ld = _intra_inputs(np.random.default_rng(12), 2, 256, 16, 16,
                                decay=1.0)
    want = jops.ssd_intra_chunk(*map(jnp.asarray, (c, b, u, ld)))
    got = K5.ssd_intra_chunk(*map(torch.from_numpy, (c, b, u, ld)))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-5)


def _model_intra_inputs(rng, g, q, n, h, p):
    """Heads-form inputs drawn as the model draws them (chip_smoke.py's
    ``ssd_inputs``): c, b, x normal; dt = softplus(normal + dt_bias), the
    bias the inverse softplus of a log-uniform dt in [1e-3, 1e-1] per head;
    A uniform in [1, 16]; u = x dt and ld the cumsum of dt * -A."""
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), h))
    a = rng.uniform(1.0, 16.0, h)
    dt = np.logaddexp(0.0, rng.normal(size=(g, q, h)) + np.log(np.expm1(dt0)))
    ld = np.cumsum(dt * -a, axis=1).astype(np.float32)
    u = (rng.normal(size=(g, q, h, p)) * dt[..., None]).astype(np.float32)
    c, b = (rng.normal(size=(g, q, n)).astype(np.float32) for _ in range(2))
    return c, b, u, ld


@pytest.mark.parametrize("g,q,n,p", INTRA_SHAPES[:3])
def test_tensor_core_emulation_one_head(g, q, n, p):
    """The 3xTF32 split of both products keeps the f32 bar on the
    reference test's shapes, against the plain version and the Pallas
    kernel."""
    c, b, u, ld = _intra_inputs(np.random.default_rng(g * q + n + p),
                                g, q, n, p)
    got = emulate_ssd_tc(*map(torch.from_numpy, (c, b, u, ld)))
    assert got.shape == (g, q, p) and torch.isfinite(got).all()
    _close(got, K5.ssd_intra_chunk_ref(*map(torch.from_numpy,
                                            (c, b, u, ld))), 1e-5)
    _close(got, jops.ssd_intra_chunk(*map(jnp.asarray, (c, b, u, ld))),
           1e-5)


@pytest.mark.parametrize("g,q,n,h,p", [(2, 256, 16, 8, 16),
                                       (2, 256, 20, 8, 32),
                                       (3, 100, 36, 4, 16)])
def test_tensor_core_emulation_heads_form(g, q, n, h, p):
    """The same on heads-form inputs drawn as the model draws them, where
    exp(l_q - l_s) overflows above the diagonal (Q = 256), with an N that
    is 4 mod 8 (the kernel's zero-padded k-step) and a ragged Q = 100."""
    c, b, u, ld = _model_intra_inputs(np.random.default_rng(q + n + h), g,
                                      q, n, h, p)
    if q == 256:
        assert (-ld[:, -1]).max() > 88.7  # exp overflows above the diagonal
    got = emulate_ssd_tc(*map(torch.from_numpy, (c, b, u, ld)))
    assert got.shape == (g, q, h, p) and torch.isfinite(got).all()
    _close(got, K5.ssd_intra_chunk_ref(*map(torch.from_numpy,
                                            (c, b, u, ld))), 1e-5)
    flat = [np.repeat(c, h, 0), np.repeat(b, h, 0),
            u.transpose(0, 2, 1, 3).reshape(g * h, q, p),
            ld.transpose(0, 2, 1).reshape(g * h, q)]
    want = np.asarray(jops.ssd_intra_chunk(*map(jnp.asarray, flat)))
    _close(got, want.reshape(g, h, q, p).transpose(0, 2, 1, 3), 1e-5)
