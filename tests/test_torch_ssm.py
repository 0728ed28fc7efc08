"""The port's chunked linear RNN and Mamba2 block (``repro_torch.models.
ssm``) against the reference's (``repro.models.ssm``), on the same numpy
inputs and the reference's Mamba2 weights carried across by
``convert.params_from_jax`` (zamba2-7b reduced: d_model 64, 2 heads of
64, ssm_state 16).

Tolerances: the scan and its step-by-step oracle within ``atol=rtol=1e-4``
(the reference's own, ``tests/test_linear_rnn.py``); the Mamba2 block in
float32 within 1e-4 where the scan's sums are its only difference and
1e-5 otherwise (the causal conv; one decode step); bf16 within 3e-2 (the
reference's bf16 tolerance).  In bf16 the port's block equals the
reference's: ``ssm.silu`` rounds as ``jax.nn.silu`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import SCAN_TOL, TOL, both, close, world
from repro.models import ssm as rssm
from repro_torch.models import ssm

ARCH = "zamba2-7b"
DTYPES = ("float32", "bfloat16")


def _rnn_inputs(seed, b, s, h, dk, dv, decay=(0.3, 0.3)):
    """q, k, v, log_a ≤ 0, scale as ``tests/test_linear_rnn.py`` makes
    them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    log_a = -np.abs(rng.normal(*decay, size=(b, s, h))).astype(np.float32)
    scale = rng.uniform(0.1, 1.0, size=(b, s, h)).astype(np.float32)
    return q, k, v, log_a, scale


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ----------------------------------------------------------------------
# The chunked scan.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(16, 8), (16, 16), (10, 4), (7, 8),
                                     (130, 32)])
def test_chunked_linear_rnn_matches_reference(s, chunk):
    """Lengths that are whole chunks, ragged ones, and s < chunk."""
    xs = _rnn_inputs(s * 10 + chunk, 2, s, 3, 4, 5)
    y, st = ssm.chunked_linear_rnn(*_t(*xs), chunk=chunk)
    ry, rst = rssm.chunked_linear_rnn(*xs, chunk=chunk)
    oy, ost = rssm.reference_linear_rnn(*xs)
    assert y.shape == ry.shape and st.shape == rst.shape
    assert st.dtype == torch.float32
    for want_y, want_st in ((ry, rst), (oy, ost)):
        close(y, want_y, SCAN_TOL)
        close(st, want_st, SCAN_TOL)
    # The port's own oracle is the reference's, step for step.
    py, pst = ssm.reference_linear_rnn(*_t(*xs))
    close(py, oy, TOL["float32"])
    close(pst, ost, TOL["float32"])


def test_initial_state_carries():
    """A sequence split in two with the state carried equals one pass,
    and equals the reference's split."""
    xs = _rnn_inputs(5, 2, 12, 2, 4, 4)
    head = [x[:, :5] for x in xs]
    rest = [x[:, 5:] for x in xs]
    y_full, st_full = ssm.chunked_linear_rnn(*_t(*xs), chunk=4)
    y1, st1 = ssm.chunked_linear_rnn(*_t(*head), chunk=4)
    y2, st2 = ssm.chunked_linear_rnn(*_t(*rest), chunk=4, init_state=st1)
    close(torch.cat([y1, y2], 1), y_full, SCAN_TOL)
    close(st2, st_full, SCAN_TOL)
    _, rst1 = rssm.chunked_linear_rnn(*head, chunk=4)
    ry2, rst2 = rssm.chunked_linear_rnn(*rest, chunk=4, init_state=rst1)
    close(y2, ry2, SCAN_TOL)
    close(st2, rst2, SCAN_TOL)


def test_decay_mask_yields_no_nan():
    """log_a of about −50 a step: within a chunk exp(cum_i − cum_j) above
    the diagonal overflows to inf, which the mask must select away
    (a 0/1 multiply would give inf · 0 = NaN)."""
    xs = _rnn_inputs(9, 2, 40, 2, 4, 3, decay=(50.0, 5.0))
    y, st = ssm.chunked_linear_rnn(*_t(*xs), chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    oy, ost = rssm.reference_linear_rnn(*xs)
    close(y, oy, SCAN_TOL)
    close(st, ost, SCAN_TOL)


def test_linear_rnn_decode_matches_reference():
    xs = _rnn_inputs(3, 2, 1, 3, 4, 5)
    state = np.random.default_rng(4).normal(size=(2, 3, 4, 5)).astype(
        np.float32)
    args = [x[:, 0] for x in xs]
    y, st = ssm.linear_rnn_decode(*_t(*args), torch.from_numpy(state))
    ry, rst = rssm.linear_rnn_decode(*args, state)
    close(y, ry, TOL["float32"])
    close(st, rst, TOL["float32"])


# ----------------------------------------------------------------------
# Mamba2, with the reference's weights.
# ----------------------------------------------------------------------
def _mamba(dtype, group=0, layer=0):
    """(port Mamba2 module, reference params, cfg) of one layer."""
    cfg, _, params, model = world(ARCH, dtype)
    ref = jax.tree.map(lambda a: a[group, layer],
                       params["mamba_groups"])["mamba"]
    return model.mamba_groups[group][layer].mamba, ref, cfg


def _kw(cfg):
    return dict(d_model=cfg.d_model, n_state=cfg.ssm_state)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    mod, ref, cfg = _mamba(dtype)
    d_inner = 2 * cfg.d_model
    xt, xj = both((2, 9, d_inner), dtype, seed=1)
    st = sj = None
    if with_state:
        st, sj = both((2, ssm.MAMBA_CONV - 1, d_inner), dtype, seed=2)
    y, new = ssm._causal_conv(xt, mod.conv, st)
    ry, rnew = rssm._causal_conv(xj, ref["conv"], sj)
    assert y.dtype == xt.dtype and new.shape == rnew.shape
    close(y, ry, TOL[dtype])
    close(new, rnew, dict(atol=0, rtol=0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,chunk", [(12, 128), (20, 8)])
def test_mamba2_block_matches_reference(dtype, s, chunk):
    """The whole sequence, from zero states and from a carried ssm
    state; outputs and both final states."""
    mod, ref, cfg = _mamba(dtype, 1, 1)
    xt, xj = both((2, s, cfg.d_model), dtype, seed=s)
    tol = SCAN_TOL if dtype == "float32" else TOL[dtype]
    h = 2 * cfg.d_model // ssm.MAMBA_HEADDIM
    st0 = np.random.default_rng(7).normal(
        size=(2, h, cfg.ssm_state, ssm.MAMBA_HEADDIM)).astype(np.float32)
    for init in (None, st0):
        y, st, cv = ssm.mamba2_block(
            mod, xt, chunk=chunk, return_conv_state=True,
            ssm_state=None if init is None else torch.from_numpy(init),
            **_kw(cfg))
        ry, rst, rcv = rssm.mamba2_block(
            ref, xj, chunk=chunk, return_conv_state=True,
            ssm_state=None if init is None else jnp.asarray(init),
            **_kw(cfg))
        assert y.dtype == xt.dtype and st.dtype == torch.float32
        close(y, ry, tol)
        close(st, rst, tol)
        close(cv, rcv, tol)
    # Without return_conv_state: (y, ssm state) only.
    assert len(ssm.mamba2_block(mod, xt, chunk=chunk, **_kw(cfg))) == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_matches_reference(dtype):
    mod, ref, cfg = _mamba(dtype)
    xt, xj = both((2, 1, cfg.d_model), dtype, seed=3)
    h = 2 * cfg.d_model // ssm.MAMBA_HEADDIM
    st = np.random.default_rng(8).normal(
        size=(2, h, cfg.ssm_state, ssm.MAMBA_HEADDIM)).astype(np.float32)
    cvt, cvj = both((2, ssm.MAMBA_CONV - 1, 2 * cfg.d_model), dtype, seed=4)
    y, nst, ncv = ssm.mamba2_decode(mod, xt, torch.from_numpy(st), cvt,
                                    **_kw(cfg))
    ry, rst, rcv = rssm.mamba2_decode(ref, xj, jnp.asarray(st), cvj,
                                      **_kw(cfg))
    for a, b in ((y, ry), (nst, rst), (ncv, rcv)):
        assert tuple(a.shape) == b.shape
        close(a, b, TOL[dtype])


def test_mamba2_block_equals_its_decode_steps():
    """``tests/test_linear_rnn.py``'s parity on the port: the block over
    S tokens equals S decode steps from the zero states."""
    mod, _, cfg = _mamba("float32")
    xt, _ = both((2, 6, cfg.d_model), "float32", seed=6)
    y_blk, st_blk, cv_blk = ssm.mamba2_block(mod, xt, chunk=4,
                                             return_conv_state=True,
                                             **_kw(cfg))
    st, cv = ssm.mamba2_init_state(2, cfg.d_model, cfg.ssm_state,
                                   torch.float32, device="cpu")
    ys = []
    for t in range(6):
        y, st, cv = ssm.mamba2_decode(mod, xt[:, t:t + 1], st, cv,
                                      **_kw(cfg))
        ys.append(y)
    close(torch.cat(ys, 1), y_blk, dict(atol=1e-4, rtol=1e-3))
    close(st, st_blk, dict(atol=1e-4, rtol=1e-3))
    close(cv, cv_blk, TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_init_state_and_param_count_equal_reference(dtype):
    cfg, _, _, _ = world(ARCH, dtype)
    got = ssm.mamba2_init_state(3, cfg.d_model, cfg.ssm_state,
                                getattr(torch, dtype), device="cpu")
    want = rssm.mamba2_init_state(3, cfg.d_model, cfg.ssm_state,
                                  jnp.dtype(dtype))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and not a.any()
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    for d, n in ((cfg.d_model, cfg.ssm_state), (3584, 64)):
        assert ssm.mamba2_param_count(d, n) == rssm.mamba2_param_count(d, n)
    mod = ssm.Mamba2(cfg.d_model, cfg.ssm_state, dtype=torch.float32,
                     device="meta")
    assert sum(p.numel() for p in mod.parameters()) == \
        ssm.mamba2_param_count(cfg.d_model, cfg.ssm_state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_equals_reference(dtype):
    """``ssm.silu``'s gradient is ``jax.nn.silu``'s, also below x ≈ −88,
    where exp(−x) overflows: autograd through the forward's own steps
    gave NaN there (0 · inf), the reference 0.  Values and gradients
    agree to within one rounding of the dtype (bf16: exactly, as
    measured); denormals count as 0 (XLA flushes them)."""
    v = np.array([-100.0, -88.5, -50.0, -3.0, 0.0, 0.7, 3.0, 100.0],
                 np.float32)
    x = torch.from_numpy(v).to(getattr(torch, dtype)).requires_grad_()
    y = ssm.silu(x)
    y.backward(torch.ones_like(y))
    jx = jnp.asarray(v, jnp.dtype(dtype))
    want_y = np.asarray(jax.nn.silu(jx), np.float32)
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jax.nn.silu(a)))(jx),
                        np.float32)
    got_g = x.grad.float().numpy()
    assert np.isfinite(got_g).all()
    tol = dict(rtol=1e-6, atol=1e-30) if dtype == "float32" else dict(
        rtol=0, atol=1e-30)
    np.testing.assert_allclose(y.detach().float().numpy(), want_y, **tol)
    np.testing.assert_allclose(got_g, want_g, **tol)
