"""The port's flash-attention wrapper and its plain version against the
reference's Pallas kernel (interpret mode) and its jnp oracle, on the
same numpy inputs.

Tolerances: float32 ``atol=1e-5``, the reference's own for its kernel
against its oracle (``tests/test_kernels.py``): the same online softmax in
float32, with sums taken in another order.  bf16 ``atol=2**-6``: both
sides compute in float32 from the same bf16 inputs and round once to
bf16, so they differ by at most one bf16 step (2^-7 relative), which is
below 2^-6 for outputs under 4 in magnitude (averages of standard normal
values).

The CUDA kernel takes head dims 16, 32, 64 and 128 only, and so does the
wrapper on every device; where the reference's test shapes use hd = 8,
these use 16.  The kernel itself is held against the plain version on the
card by ``chip_smoke.py`` (phase kernels).

The bf16 CUDA kernel rounds its probabilities to bf16 before the value
product; ``_emulate_bf16_kernel`` repeats that arithmetic in plain torch,
and ``test_bf16_kernel_rounding_within_stated_tolerance`` holds it against
the reference within ``chip_smoke.py``'s ``FLASH_TOL[bfloat16]``, so the
tolerance the card's check uses is shown to follow from the rounding.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flashattn_pallas, flashattn_ref
from repro_torch.kernels import distthresh as dt
from repro_torch.kernels.flashattn import (NEG_INF, flashattn,
                                           flashattn_plain)

F32_ATOL = 1e-5
BF16_ATOL = 2 ** -6


def _inputs(rng, bkv, g, s, t, hd):
    q = rng.normal(size=(bkv * g, s, hd)).astype(np.float32)
    k = rng.normal(size=(bkv, t, hd)).astype(np.float32)
    v = rng.normal(size=(bkv, t, hd)).astype(np.float32)
    return q, k, v


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("bkv,g,s,t,hd,bq,bk", [
    (2, 2, 16, 16, 16, 8, 8),
    (1, 4, 32, 32, 16, 16, 8),
    (2, 1, 8, 16, 16, 8, 8),        # windowed: S < T
    (1, 2, 64, 64, 32, 32, 32),
])
def test_plain_matches_pallas_and_ref(bkv, g, s, t, hd, bq, bk):
    rng = np.random.default_rng(bkv * 100 + s)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    want_pallas = np.asarray(flashattn_pallas(q, k, v, g=g, blk_q=bq,
                                              blk_k=bk))
    want_ref = np.asarray(flashattn_ref(q, k, v, g=g))
    got = flashattn_plain(*_torch(q, k, v), g=g).numpy()
    np.testing.assert_allclose(got, want_pallas, atol=F32_ATOL)
    np.testing.assert_allclose(got, want_ref, atol=F32_ATOL)


@pytest.mark.parametrize("g,hd", [(1, 16), (4, 64)])
def test_plain_bf16_matches_pallas(g, hd):
    rng = np.random.default_rng(3)
    q, k, v = _inputs(rng, 2, g, 16, 16, hd)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flashattn_pallas(jq, jk, jv, g=g, blk_q=8, blk_k=8),
                      np.float32)
    got = flashattn_plain(*_torch(q, k, v, dtype=torch.bfloat16), g=g)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("bkv,g,s,t,hd", [
    (2, 2, 13, 13, 16),             # S = T, not a multiple of any block
    (1, 3, 7, 29, 32),              # windowed and ragged
    (2, 4, 70, 200, 64),            # several ragged KV blocks
    (1, 1, 65, 130, 128),
])
def test_plain_matches_ref_at_ragged_lengths(bkv, g, s, t, hd):
    """Lengths the Pallas kernel cannot take (it needs block multiples)."""
    rng = np.random.default_rng(s * 7 + t)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    want = np.asarray(flashattn_ref(q, k, v, g=g))
    got = flashattn_plain(*_torch(q, k, v), g=g).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(5)
    q, k, v = _torch(*_inputs(rng, 2, 2, 20, 33, 16))
    before = dt.LAUNCHES["flashattn"]
    got = flashattn(q, k, v, g=2)
    assert torch.equal(got, flashattn_plain(q, k, v, g=2))
    assert torch.equal(flashattn(q, k, v, g=2, device="cpu"), got)
    assert dt.LAUNCHES["flashattn"] == before


@pytest.mark.parametrize("case,err", [
    ("hd8", ValueError), ("s_gt_t", ValueError), ("bad_g", ValueError),
    ("mixed_dtype", TypeError), ("f16", TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, err):
    rng = np.random.default_rng(0)
    shapes = {"hd8": (1, 2, 8, 8, 8), "s_gt_t": (1, 2, 9, 8, 16)}
    q, k, v = _torch(*_inputs(rng, *shapes.get(case, (1, 2, 8, 8, 16))))
    g = 3 if case == "bad_g" else 2
    if case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    if case == "f16":
        q, k, v = (x.half() for x in (q, k, v))
    with pytest.raises(err):
        flashattn(q, k, v, g=g)
    with pytest.raises(err):
        flashattn_plain(q, k, v, g=g)


def test_wrapper_refuses_tensor_on_other_device():
    q = torch.zeros((2, 8, 16), device="meta")
    k = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="but device=cpu"):
        flashattn(q, k, k, g=2, device="cpu")


def _chip_smoke_bf16_tol():
    """``chip_smoke.py``'s (rtol, atol, vtol) for bf16 flash outputs."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_TOL[torch.bfloat16]


def _emulate_bf16_kernel(q, k, v, g):
    """The bf16 CUDA kernel's arithmetic in plain torch: float32 scores of
    the bf16 q and k, scaled after the product by 1/sqrt(hd)·log2(e) in
    float32; an online softmax over 64-key tiles in the log2 domain (the
    −1e30 sentinel on masked scores); each probability rounded to bf16
    before the value product, the row sums of the unrounded float32 ones;
    the output divided by max(l, 1e-30) and rounded to bf16."""
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    scale_log2 = np.float32(np.float32(1.0 / np.sqrt(hd))
                            * np.float32(np.log2(np.e)))
    qf = q.float().reshape(bkv, g, s, hd)
    q_pos = (t - s) + torch.arange(s)
    m = torch.full((bkv, g, s), NEG_INF)
    l = torch.zeros((bkv, g, s))
    acc = torch.zeros((bkv, g, s, hd))
    for k0 in range(0, t, 64):
        kb, vb = k[:, k0:k0 + 64].float(), v[:, k0:k0 + 64].float()
        sc = torch.einsum("bgsh,bth->bgst", qf, kb) * float(scale_log2)
        mask = (k0 + torch.arange(kb.shape[1]))[None, :] <= q_pos[:, None]
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp2(sc - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgst,bth->bgsh", p.to(torch.bfloat16).float(), vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(bh, s, hd).to(torch.bfloat16)


@pytest.mark.parametrize("bkv,g,s,t,hd,pallas", [
    (2, 1, 64, 64, 16, True),
    (1, 4, 64, 128, 32, True),       # windowed: S < T
    (2, 4, 128, 128, 64, True),
    (1, 1, 64, 64, 128, True),
    (1, 4, 77, 77, 64, False),       # ragged: no Pallas block divides it
    (1, 1, 45, 333, 128, False),     # ragged and windowed
    (2, 4, 70, 200, 16, False),
    (1, 1, 100, 1000, 32, False),
])
def test_bf16_kernel_rounding_within_stated_tolerance(bkv, g, s, t, hd,
                                                      pallas):
    """|kernel − reference| <= rtol·max(|a|, |b|) + atol + vtol·max|v| of
    the row's KV head, on the bf16-rounded inputs."""
    rtol, atol, vtol = _chip_smoke_bf16_tol()
    rng = np.random.default_rng(1000 * hd + 10 * g + s)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    got = _emulate_bf16_kernel(tq, tk, tv, g).float().numpy()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    wants = [np.asarray(flashattn_ref(jq, jk, jv, g=g), np.float32)]
    if pallas:
        wants.append(np.asarray(flashattn_pallas(
            jq, jk, jv, g=g, blk_q=32, blk_k=32), np.float32))
    vmax = np.abs(tv.float().numpy()).max(axis=(1, 2)).repeat(g)
    for want in wants:
        tol = (rtol * np.maximum(np.abs(got), np.abs(want)) + atol
               + vtol * vmax[:, None, None])
        assert (np.abs(got - want) <= tol).all(), float(
            np.abs(got - want).max())
