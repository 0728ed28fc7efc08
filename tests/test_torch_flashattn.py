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

The CUDA kernel takes head dims 16, 32, 64, 112 (zamba2-7b's) and 128
only, and so does the wrapper on every device; where the reference's test
shapes use hd = 8, these use 16.  The kernel itself is held against the plain version on the
card by ``chip_smoke.py`` (phase kernels).

The bf16 CUDA kernel rounds its probabilities to bf16 before the value
product; ``_emulate_bf16_kernel`` repeats that arithmetic in plain torch,
and ``test_bf16_kernel_rounding_within_stated_tolerance`` holds it against
the reference within ``chip_smoke.py``'s ``FLASH_TOL[bfloat16]``, so the
tolerance the card's check uses is shown to follow from the rounding.
"""
import importlib.util
import pathlib

import jax
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
    (2, 1, 32, 32, 112, 16, 16),    # zamba2-7b's head dim, g 1
    (1, 2, 16, 32, 112, 8, 16),     # windowed, g 2
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


@pytest.mark.parametrize("g,hd", [(1, 16), (4, 64), (1, 112)])
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
    (2, 1, 77, 77, 112),
    (1, 1, 45, 333, 112),
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


def _chip_smoke():
    """``chip_smoke.py``, loaded by path for its tolerance constants."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke_bf16_tol():
    """``chip_smoke.py``'s (rtol, atol, vtol) for bf16 flash outputs."""
    return _chip_smoke().FLASH_TOL[torch.bfloat16]


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
    (2, 1, 64, 64, 112, True),       # zamba2-7b's head dim
    (1, 1, 77, 77, 112, False),
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


# ----------------------------------------------------------------------
# The backward: ``flashattn_bwd_plain`` (the CUDA backward's plain twin)
# against ``jax.vjp`` of the reference's flash attention (its custom VJP,
# ``_flash_bwd``) and of its naive oracle; ``FlashAttention`` on the CPU.
# ----------------------------------------------------------------------
#: The reference's own bound for its flash gradients against the naive
#: ones (``tests/test_models.py::test_flash_gradients_match_naive``).
GRAD_ATOL = 2e-4


def _to_kernel_layout(q, k, v, do):
    """(B, S, KVH, G, hd) / (B, T, KVH, hd) numpy → the kernel's (BH, S,
    hd) / (BKV, T, hd) torch layout."""
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    qf = torch.from_numpy(q).permute(0, 2, 3, 1, 4).reshape(b * kvh * g, s,
                                                             hd)
    kf, vf = (torch.from_numpy(x).permute(0, 2, 1, 3).reshape(b * kvh, t, hd)
              for x in (k, v))
    dof = torch.from_numpy(do).permute(0, 2, 3, 1, 4).reshape(
        b * kvh * g, s, hd)
    return [x.contiguous() for x in (qf, kf, vf, dof)]


def _from_kernel_layout(dq, dk, dv, shape_q, shape_k):
    b, s, kvh, g, hd = shape_q
    t = shape_k[1]
    return (dq.reshape(b, kvh, g, s, hd).permute(0, 3, 1, 2, 4).numpy(),
            dk.reshape(b, kvh, t, hd).permute(0, 2, 1, 3).numpy(),
            dv.reshape(b, kvh, t, hd).permute(0, 2, 1, 3).numpy())


@pytest.mark.parametrize("b,s,t,kvh,g,hd", [
    (2, 13, 29, 2, 3, 16),          # ragged, windowed, g 3
    (1, 70, 130, 1, 1, 32),         # several KV blocks, g 1
    (2, 45, 45, 2, 1, 64),
    (1, 20, 77, 1, 3, 112),
])
def test_bwd_plain_matches_reference_vjp(b, s, t, kvh, g, hd):
    from repro.models.attention import (chunked_causal_attention,
                                        naive_causal_attention)
    from repro_torch.kernels.flashattn import (flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    rng = np.random.default_rng(s * 31 + t)
    q = rng.normal(size=(b, s, kvh, g, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, kvh, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=q.shape).astype(np.float32)
    qf, kf, vf, dof = _to_kernel_layout(q, k, v, do)
    o, lse = flashattn_fwd_plain(qf, kf, vf, g=g)
    got = _from_kernel_layout(*flashattn_bwd_plain(qf, kf, vf, o, lse, dof,
                                                   g=g), q.shape, k.shape)
    for fn in (lambda q, k, v: chunked_causal_attention(q, k, v, 32),
               naive_causal_attention):
        _, vjp = jax.vjp(fn, q, k, v)
        for a, w in zip(got, vjp(do)):
            np.testing.assert_allclose(a, np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.parametrize("s,t,g", [(16, 16, 1), (7, 29, 2)])
def test_fwd_plain_lse_matches_reference(s, t, g):
    """The plain forward's lse is the reference's ``_flash_fwd_loop``
    residual m + log(max(l, 1e-30))."""
    from repro.models.attention import _flash_fwd_loop
    from repro_torch.kernels.flashattn import flashattn_fwd_plain
    rng = np.random.default_rng(t)
    q = rng.normal(size=(2, s, 2, g, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, t, 2, 16)).astype(np.float32)
            for _ in range(2))
    _, want = _flash_fwd_loop(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              8)
    qf, kf, vf, _ = _to_kernel_layout(q, k, v, q)
    _, lse = flashattn_fwd_plain(qf, kf, vf, g=g)
    assert lse.dtype == torch.float32 and lse.shape == (2 * 2 * g, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(-1, s),
                               atol=F32_ATOL)


def test_flash_attention_function_on_cpu_is_the_plain_pair():
    from repro_torch.kernels.flashattn import (FlashAttention,
                                               flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    rng = np.random.default_rng(11)
    q, k, v = _torch(*_inputs(rng, 2, 3, 17, 40, 32))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    before = {n: dt.LAUNCHES[n] for n in dt.LAUNCHES}
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FlashAttention.apply(*leaves, 3)
    o, lse = flashattn_fwd_plain(q, k, v, g=3)
    assert torch.equal(out.detach(), o)
    out.backward(do)
    for got, want in zip(leaves, flashattn_bwd_plain(q, k, v, o, lse, do,
                                                     g=3)):
        assert torch.equal(got.grad, want)
    assert dict(dt.LAUNCHES) == before


def test_flash_attention_directional_derivatives():
    """``FlashAttention``'s gradient against central differences of its
    forward at float32: ⟨∇f, u⟩ for f = Σ o · w and a random direction
    u, step 1e-2 (the difference quotient's error is O(1e-4) relative
    from the third derivative and ~1e-5 from float32 rounding), held to
    2e-3 relative."""
    from repro_torch.kernels.flashattn import FlashAttention, flashattn_plain
    rng = np.random.default_rng(12)
    q, k, v = _torch(*_inputs(rng, 1, 2, 9, 21, 16))
    w = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (FlashAttention.apply(*leaves, 2) * w).sum().backward()
    eps = 1e-2
    for i in range(3):
        u = [torch.zeros_like(x) for x in (q, k, v)]
        u[i] = torch.from_numpy(rng.normal(size=u[i].shape).astype(
            np.float32))
        plus = [x + eps * d for x, d in zip((q, k, v), u)]
        minus = [x - eps * d for x, d in zip((q, k, v), u)]
        fd = float(((flashattn_plain(*plus, g=2) - flashattn_plain(
            *minus, g=2)) * w).sum()) / (2 * eps)
        an = float((leaves[i].grad * u[i]).sum())
        assert abs(fd - an) <= 2e-3 * max(abs(an), 1.0), (i, fd, an)


def test_bwd_refuses_bad_residuals():
    from repro_torch.kernels.flashattn import flashattn_bwd
    rng = np.random.default_rng(0)
    q, k, v = _torch(*_inputs(rng, 1, 2, 8, 8, 16))
    lse = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="lse"):
        flashattn_bwd(q, k, v, q, lse.double(), q, g=2)
    with pytest.raises(ValueError, match="lse"):
        flashattn_bwd(q, k, v, q, lse[:, :4], q, g=2)
    with pytest.raises(ValueError, match="o and do"):
        flashattn_bwd(q, k, v, q[:, :4], lse, q, g=2)
    with pytest.raises(ValueError, match="head dim"):
        q8, k8, v8 = _torch(*_inputs(rng, 1, 2, 8, 8, 8))
        flashattn_bwd(q8, k8, v8, q8, lse, q8, g=2)


def test_attention_uses_flash_function_only_for_gradients(monkeypatch):
    """``chunked_causal_attention`` calls the serving kernel (no lse)
    unless a gradient is wanted, then ``FlashAttention``."""
    from repro_torch.models import attention
    calls = []
    real_fn, real_apply = attention.flashattn, attention.FlashAttention.apply
    monkeypatch.setattr(attention, "flashattn", lambda *a, **kw: (
        calls.append("serve"), real_fn(*a, **kw))[1])
    monkeypatch.setattr(attention.FlashAttention, "apply", lambda *a: (
        calls.append("grad"), real_apply(*a))[1])
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 5, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 5, 2, 16)).astype(np.float32))
    attention.chunked_causal_attention(q, k, k)
    attention.chunked_causal_attention(q.requires_grad_(), k, k)
    with torch.no_grad():
        attention.chunked_causal_attention(q, k, k)
    assert calls == ["serve", "grad", "serve"]


# ----------------------------------------------------------------------
# The bf16 backward kernels' rounding: ``_emulate_bf16_bwd_kernel``
# repeats the tensor-core kernels' arithmetic in plain torch, held to
# ``chip_smoke.py``'s ``BWD_TOL[bfloat16]`` against the plain backward and
# the reference's ``_flash_bwd``; with p and ds rounded once to bf16 (as
# ``scaled_dot_product_attention``'s backward does) instead of as hi + lo
# pairs, the same check must fail, so the tolerance tells the two apart.
# ----------------------------------------------------------------------
def _chip_smoke_bwd_tol():
    """``chip_smoke.py``'s (rtol, frac) for bf16 flash gradients."""
    return _chip_smoke().BWD_TOL[torch.bfloat16]


def _bf16_parts(x, pairs: bool):
    """x (float32) as the bf16 operands the kernel feeds the tensor cores:
    [hi, lo] with hi = bf16(x), lo = bf16(x − hi), or [bf16(x)]."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if pairs else [hi]


def _emulate_bf16_bwd_kernel(q, k, v, o, lse, do, g, *, pairs=True):
    """The bf16 backward kernels' arithmetic in plain torch: delta =
    rowsum(do · o) in float32; float32 S = q kᵀ and dP = do vᵀ of the
    bf16 inputs; p = exp2(S·scale·log2(e) − lse·log2(e)) under the causal
    mask; ds = p (dP − delta) scale; p and ds as hi + lo bf16 pairs
    (``pairs``) or rounded once to bf16, each part a float32-summed
    product; dq, dk, dv rounded once to bf16."""
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    scale = np.float32(1.0 / np.sqrt(hd))
    log2e = np.float32(np.log2(np.e))
    qf = q.float().reshape(bkv, g, s, hd)
    dof = do.float().reshape(bkv, g, s, hd)
    kf, vf = k.float(), v.float()
    delta = (dof * o.float().reshape(bkv, g, s, hd)).sum(dim=-1)
    lse2 = lse.float().reshape(bkv, g, s) * float(log2e)
    sc = torch.einsum("bgsh,bth->bgst", qf, kf)
    dp = torch.einsum("bgsh,bth->bgst", dof, vf)
    mask = torch.arange(t)[None, :] <= ((t - s) + torch.arange(s))[:, None]
    p = torch.where(mask, torch.exp2(sc * float(scale * log2e)
                                     - lse2[..., None]), 0.0)
    ds = p * (dp - delta[..., None]) * float(scale)
    p_parts, ds_parts = _bf16_parts(p, pairs), _bf16_parts(ds, pairs)
    dq = sum(torch.einsum("bgst,bth->bgsh", x, kf) for x in ds_parts)
    dk = sum(torch.einsum("bgst,bgsh->bth", x, qf) for x in ds_parts)
    dv = sum(torch.einsum("bgst,bgsh->bth", x, dof) for x in p_parts)
    return (dq.reshape(bh, s, hd).to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _worst_over_bwd_tol(got, want) -> float:
    """max |a − b| / (rtol·max(|a|, |b|) + frac·max|b|) over dq, dk, dv,
    as ``chip_smoke.bwd_close`` applies ``BWD_TOL``."""
    rtol, frac = _chip_smoke_bwd_tol()
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        tol = rtol * np.maximum(np.abs(a), np.abs(b)) + frac * np.abs(b).max()
        worst = max(worst, float((np.abs(a - b) / tol).max()))
    return worst


def _bf16_bwd_inputs(bkv, g, s, t, hd):
    rng = np.random.default_rng(7000 + 100 * hd + 10 * g + s)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    do = rng.normal(size=q.shape).astype(np.float32)
    return _torch(q, k, v, do, dtype=torch.bfloat16)


@pytest.mark.parametrize("against", ["plain", "reference"])
@pytest.mark.parametrize("bkv,g,s,t,hd", [
    (2, 1, 64, 64, 16),
    (2, 4, 128, 128, 64),
    (1, 4, 77, 77, 64),              # ragged
    (1, 1, 45, 333, 128),            # ragged and windowed
    (1, 1, 77, 77, 112),             # zamba2-7b's head dim
    (2, 4, 200, 200, 32),
])
def test_bf16_bwd_kernel_rounding_within_stated_tolerance(bkv, g, s, t, hd,
                                                          against):
    """The hi + lo emulation within ``BWD_TOL[bfloat16]`` of the plain
    backward (on the plain forward's bf16 o and lse, as the card's check
    feeds both sides), and of the reference's ``_flash_bwd`` through
    ``jax.vjp`` (float32 inputs holding the bf16 values; the emulation
    then takes the reference forward's float32 o and lse)."""
    from repro.models.attention import (_flash_fwd_loop,
                                        chunked_causal_attention)
    from repro_torch.kernels.flashattn import (flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    tq, tk, tv, tdo = _bf16_bwd_inputs(bkv, g, s, t, hd)
    if against == "plain":
        o, lse = flashattn_fwd_plain(tq, tk, tv, g=g)
        want = flashattn_bwd_plain(tq, tk, tv, o, lse, tdo, g=g)
        got = _emulate_bf16_bwd_kernel(tq, tk, tv, o, lse, tdo, g)
        want = [x.float().numpy() for x in want]
    else:
        # The reference's (B, S, KVH, G, hd) layout with B = 1, KVH = bkv.
        shape_q, shape_k = (1, s, bkv, g, hd), (1, t, bkv, hd)
        q5, k4, v4 = _from_kernel_layout(tq.float(), tk.float(), tv.float(),
                                         shape_q, shape_k)
        do5 = _from_kernel_layout(tdo.float(), tk.float(), tv.float(),
                                  shape_q, shape_k)[0]
        o_ref, lse_ref = _flash_fwd_loop(jnp.asarray(q5), jnp.asarray(k4),
                                         jnp.asarray(v4), 64)
        _, vjp = jax.vjp(lambda q, k, v: chunked_causal_attention(q, k, v, 64),
                         q5, k4, v4)
        dq5, dk4, dv4 = (np.array(x) for x in vjp(jnp.asarray(do5)))
        want = [x.numpy() for x in _to_kernel_layout(dq5, dk4, dv4, dq5)[:3]]
        got = _emulate_bf16_bwd_kernel(
            tq, tk, tv, torch.from_numpy(np.array(o_ref)).reshape(
                bkv * g, s, hd),
            torch.from_numpy(np.array(lse_ref)).reshape(bkv * g, s), tdo, g)
    worst = _worst_over_bwd_tol([x.float().numpy() for x in got], want)
    assert worst <= 1.0, worst


def test_bf16_bwd_single_rounding_breaks_stated_tolerance():
    """Negative control: p and ds rounded once to bf16 miss ``BWD_TOL``
    by far (tens of times) where the hi + lo pairs pass."""
    from repro_torch.kernels.flashattn import (flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    tq, tk, tv, tdo = _bf16_bwd_inputs(2, 4, 128, 128, 64)
    o, lse = flashattn_fwd_plain(tq, tk, tv, g=4)
    want = [x.float().numpy()
            for x in flashattn_bwd_plain(tq, tk, tv, o, lse, tdo, g=4)]
    worst = {pairs: _worst_over_bwd_tol(
        [x.float().numpy() for x in _emulate_bf16_bwd_kernel(
            tq, tk, tv, o, lse, tdo, 4, pairs=pairs)], want)
        for pairs in (True, False)}
    assert worst[True] <= 1.0 and worst[False] > 10.0, worst


def test_bwd_wrapper_refuses_misaligned_bf16_tensors():
    """The bf16 kernels' TMA copies need 16-byte aligned starts: a
    contiguous view 2 bytes past an aligned address (``do.contiguous()``
    of an offset view) is refused by name."""
    from repro_torch.kernels.flashattn import _aligned
    fresh = torch.zeros((4, 16), dtype=torch.bfloat16)
    view = torch.zeros(65, dtype=torch.bfloat16)[1:].view(4, 16)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    _aligned(q=fresh, do=fresh)
    with pytest.raises(ValueError, match=r"bf16 do must start at 16-byte"):
        _aligned(q=fresh, do=view)
