"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's (``repro.models.xlstm``), on the same numpy inputs and the
reference's mLSTM and sLSTM weights carried across by
``convert.params_from_jax`` (xlstm-350m reduced: d_model 64, 4 heads of
16), and the group norm both use.

Tolerances: float32 within ``atol=rtol=1e-5`` (the mLSTM's chunked scan
within its own 1e-4, ``tests/test_linear_rnn.py``); bf16 within 3e-2,
the reference's bf16 tolerance (``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import SCAN_TOL, TOL, both, close, world
from repro.models import layers as rlayers
from repro.models import xlstm as rxlstm
from repro_torch.models import layers, xlstm

ARCH = "xlstm-350m"
DTYPES = ("float32", "bfloat16")


def _mlstm(dtype, group=0, layer=0):
    cfg, _, params, model = world(ARCH, dtype)
    ref = jax.tree.map(lambda a: a[group, layer], params["mlstm"])["mlstm"]
    return model.mlstm[group][layer].mlstm, ref, cfg


def _slstm(dtype, group=0):
    cfg, _, params, model = world(ARCH, dtype)
    ref = jax.tree.map(lambda a: a[group], params["slstm"])["slstm"]
    return model.slstm[group].slstm, ref, cfg


def _carry(cfg, b, seed):
    """A random sLSTM carry (h, c, n, m) of (B, H, Dh) float32, n > 0."""
    dh = cfg.d_model // cfg.num_heads
    rng = np.random.default_rng(seed)
    h, c, m = (rng.normal(size=(b, cfg.num_heads, dh)).astype(np.float32)
               for _ in range(3))
    n = np.abs(rng.normal(size=h.shape)).astype(np.float32) + 0.5
    return (h, c, n, m)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 4])
def test_groupnorm_matches_reference(dtype, groups):
    xt, xj = both((2, 5, 64), dtype, seed=groups, scale=3.0)
    close(layers.groupnorm(xt, groups), rlayers.groupnorm(xj, groups),
          TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,chunk,carried", [(12, 128, False),
                                             (20, 8, False), (20, 8, True)])
def test_mlstm_block_matches_reference(dtype, s, chunk, carried):
    mod, ref, cfg = _mlstm(dtype)
    xt, xj = both((2, s, cfg.d_model), dtype, seed=s)
    st = None
    if carried:
        dh = cfg.d_model // cfg.num_heads
        st = np.random.default_rng(3).normal(
            size=(2, cfg.num_heads, dh, dh + 1)).astype(np.float32)
    y, new = xlstm.mlstm_block(mod, xt, num_heads=cfg.num_heads,
                               chunk=chunk,
                               state=None if st is None else
                               torch.from_numpy(st))
    ry, rnew = rxlstm.mlstm_block(ref, xj, num_heads=cfg.num_heads,
                                  chunk=chunk,
                                  state=None if st is None else
                                  jnp.asarray(st))
    tol = SCAN_TOL if dtype == "float32" else TOL[dtype]
    assert y.dtype == xt.dtype and new.dtype == torch.float32
    close(y, ry, tol)
    close(new, rnew, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_matches_reference(dtype):
    mod, ref, cfg = _mlstm(dtype)
    dh = cfg.d_model // cfg.num_heads
    xt, xj = both((2, 1, cfg.d_model), dtype, seed=5)
    st = np.random.default_rng(6).normal(
        size=(2, cfg.num_heads, dh, dh + 1)).astype(np.float32)
    y, new = xlstm.mlstm_decode(mod, xt, torch.from_numpy(st),
                                num_heads=cfg.num_heads)
    ry, rnew = rxlstm.mlstm_decode(ref, xj, jnp.asarray(st),
                                   num_heads=cfg.num_heads)
    close(y, ry, TOL[dtype])
    close(new, rnew, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_cell_matches_reference(dtype):
    mod, ref, cfg = _slstm(dtype)
    xw = np.random.default_rng(7).normal(
        size=(2, 4 * cfg.d_model)).astype(np.float32)
    carry = _carry(cfg, 2, 8)
    got = xlstm.slstm_cell(mod, torch.from_numpy(xw),
                           tuple(map(torch.from_numpy, carry)),
                           cfg.num_heads)
    want = rxlstm.slstm_cell(ref, jnp.asarray(xw),
                             tuple(map(jnp.asarray, carry)), cfg.num_heads)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        close(a, b, TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True])
def test_slstm_block_matches_reference(dtype, carried):
    mod, ref, cfg = _slstm(dtype, 1)
    xt, xj = both((2, 9, cfg.d_model), dtype, seed=9)
    carry = _carry(cfg, 2, 10) if carried else None
    y, got = xlstm.slstm_block(
        mod, xt, num_heads=cfg.num_heads,
        carry=None if carry is None else tuple(map(torch.from_numpy, carry)))
    ry, want = rxlstm.slstm_block(
        ref, xj, num_heads=cfg.num_heads,
        carry=None if carry is None else tuple(map(jnp.asarray, carry)))
    assert y.dtype == xt.dtype
    close(y, ry, TOL[dtype])
    for a, b in zip(got, want):
        close(a, b, TOL["float32"] if dtype == "float32" else TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_decode_matches_reference(dtype):
    mod, ref, cfg = _slstm(dtype)
    xt, xj = both((2, 1, cfg.d_model), dtype, seed=11)
    carry = _carry(cfg, 2, 12)
    y, got = xlstm.slstm_decode(mod, xt, tuple(map(torch.from_numpy, carry)),
                                num_heads=cfg.num_heads)
    ry, want = rxlstm.slstm_decode(ref, xj, tuple(map(jnp.asarray, carry)),
                                   num_heads=cfg.num_heads)
    close(y, ry, TOL[dtype])
    for a, b in zip(got, want):
        close(a, b, TOL[dtype])


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_equals_its_decode_steps(block):
    """``tests/test_linear_rnn.py``'s parity on the port: the block over
    S tokens equals S decode steps from the initial state."""
    cfg, _, _, model = world(ARCH, "float32")
    xt, _ = both((2, 5, cfg.d_model), "float32", seed=13)
    h = cfg.num_heads
    if block == "mlstm":
        mod = model.mlstm[0][0].mlstm
        y_blk, st_blk = xlstm.mlstm_block(mod, xt, num_heads=h, chunk=2)
        st = xlstm.mlstm_init_state(2, cfg.d_model, h, device="cpu")
        step = xlstm.mlstm_decode
    else:
        mod = model.slstm[0].slstm
        y_blk, st_blk = xlstm.slstm_block(mod, xt, num_heads=h)
        st = xlstm.slstm_init_state(2, cfg.d_model, h, device="cpu")
        step = xlstm.slstm_decode
    ys = []
    for t in range(5):
        y, st = step(mod, xt[:, t:t + 1], st, num_heads=h)
        ys.append(y)
    close(torch.cat(ys, 1), y_blk, dict(atol=1e-4, rtol=1e-3))
    if block == "mlstm":
        st, st_blk = (st,), (st_blk,)
    for a, b in zip(st, st_blk):
        close(a, b, dict(atol=1e-4, rtol=1e-3))


def test_init_states_equal_reference():
    cfg, _, _, _ = world(ARCH, "float32")
    d, h = cfg.d_model, cfg.num_heads
    got = xlstm.mlstm_init_state(3, d, h, device="cpu")
    want = rxlstm.mlstm_init_state(3, d, h)
    assert tuple(got.shape) == want.shape and not got.any()
    for a, b in zip(xlstm.slstm_init_state(3, d, h, device="cpu"),
                    rxlstm.slstm_init_state(3, d, h)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        close(a, b, dict(atol=0, rtol=0))
