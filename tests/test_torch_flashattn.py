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
The float32 kernels do each product as three TF32 products of split
operands; ``_emulate_f32_kernel`` and ``_emulate_f32_bwd_kernel`` repeat
that in plain torch, over the kernels' tiles and query items with an
accumulator each (``_tc_mm``, which also models the tensor cores'
accumulate as a truncation per k-step), within ``FLASH_TOL[float32]``
and ``BWD_TOL[float32]``.  The negative controls: one TF32 product per
product misses both by more than ten times, and one accumulator over a
KV head's whole dK/dV sum misses ``BWD_TOL[float32]``.
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
def _chip_smoke_bwd_tol(dtype=torch.bfloat16):
    """``chip_smoke.py``'s (rtol, frac) for flash gradients of ``dtype``."""
    return _chip_smoke().BWD_TOL[dtype]


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


def _worst_over_bwd_tol(got, want, dtype=torch.bfloat16) -> float:
    """max |a − b| / (rtol·max(|a|, |b|) + frac·max|b|) over dq, dk, dv,
    as ``chip_smoke.bwd_close`` applies ``BWD_TOL[dtype]``."""
    rtol, frac = _chip_smoke_bwd_tol(dtype)
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


# ----------------------------------------------------------------------
# The float32 kernels: each product three TF32 products.
# ----------------------------------------------------------------------
def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the float32 bits plus half a unit of
    the 13 dropped bits, then those bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_parts(x, three: bool):
    """x (float32) as the TF32 operands the kernels feed the tensor cores:
    [hi, lo] with hi = tf32(x), lo = tf32(x − hi), or [tf32(x)]."""
    hi = _tf32(x)
    return [hi, _tf32(x - hi)] if three else [hi]


def _rz(x):
    """float64 x rounded toward zero to float32."""
    r = x.to(torch.float32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _tc_mm(a, b, three: bool, acc=None):
    """a @ b (float32, contracting a's last dim with b's second to last)
    as one ``wgmma`` accumulator takes it: per k-step of 8, the products
    lo·hi, hi·lo and hi·hi of the split operands (``three``) or tf32(a)·
    tf32(b), each k-step's 8 products added to the accumulator exactly and
    the sum truncated toward zero to float32.  The truncation is a model
    of the tensor cores' accumulate (their alignment and rounding of the
    sum are not documented; this one rounds each k-step once, toward
    zero), chosen because it reproduces what the first float32 design
    showed on the card: one accumulator over a long sum drifts past
    ``BWD_TOL[float32]`` (``test_f32_bwd_long_accumulator_breaks_
    stated_tolerance``).  ``acc`` continues an accumulator; None starts
    one at zero."""
    n = a.shape[-1]
    pad = -n % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, *al), (bh, *bl) = _tf32_parts(a, three), _tf32_parts(b, three)
    terms = [(al[0], bh), (ah, bl[0]), (ah, bh)] if three else [(ah, bh)]
    for k0 in range(0, n + pad, 8):
        for x, y in terms:
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = _rz(part if acc is None else acc.double() + part)
    return acc


def _f32_key_tile(hd: int) -> int:
    """Keys per tile of the float32 forward kernel (``FwdF32::kBK``)."""
    return 64 if hd <= 64 else 32


def _emulate_f32_kernel(q, k, v, g, *, three=True):
    """The float32 forward kernel's arithmetic in plain torch: q scaled by
    1/sqrt(hd) in float32, then split; per key tile of the kernel's
    height, S = (q scale) kᵀ and the tile's P V each in an accumulator of
    their own (``_tc_mm``: three TF32 products per k-step, or one);
    the online softmax in float32 (−1e30 on masked scores, exp of s − m);
    row sums of the float32 p; O = O corr + P V in float32; O divided by
    max(l, 1e-30)."""
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    tile = _f32_key_tile(hd)
    qs = (q * float(np.float32(1.0 / np.sqrt(hd)))).reshape(bkv, g, s, hd)
    q_pos = (t - s) + torch.arange(s)
    m = torch.full((bkv, g, s), NEG_INF)
    l = torch.zeros((bkv, g, s))
    acc = torch.zeros((bkv, g, s, hd))
    for k0 in range(0, t, tile):
        kb, vb = k[:, None, k0:k0 + tile], v[:, None, k0:k0 + tile]
        sc = _tc_mm(qs, kb.transpose(-1, -2), three)
        mask = (k0 + torch.arange(kb.shape[2]))[None, :] <= q_pos[:, None]
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _tc_mm(p, vb, three)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(bh, s, hd)


def _worst_over_flash_tol(got, want, v, g) -> float:
    """max |a − b| / (rtol·max(|a|, |b|) + atol + vtol·max|v|), as
    ``chip_smoke.flash_close`` applies ``FLASH_TOL[float32]``."""
    rtol, atol, vtol = _chip_smoke().FLASH_TOL[torch.float32]
    vmax = np.abs(v).max(axis=(1, 2)).repeat(g)[:, None, None]
    tol = rtol * np.maximum(np.abs(got), np.abs(want)) + atol + vtol * vmax
    return float((np.abs(got - want) / tol).max())


@pytest.mark.parametrize("bkv,g,s,t,hd,pallas", [
    (2, 1, 64, 64, 16, True),
    (1, 2, 64, 128, 32, True),       # windowed: S < T
    (2, 4, 128, 128, 64, True),
    (1, 1, 64, 64, 128, True),
    (2, 1, 64, 64, 112, True),       # zamba2-7b's head dim
    (1, 4, 77, 77, 64, False),       # ragged: no Pallas block divides it
    (1, 2, 45, 333, 128, False),     # ragged and windowed
    (2, 4, 70, 200, 16, False),
    (1, 1, 100, 1000, 32, False),
    (1, 2, 77, 77, 112, False),
])
def test_f32_kernel_rounding_within_stated_tolerance(bkv, g, s, t, hd,
                                                     pallas):
    """The three-TF32 emulation within ``FLASH_TOL[float32]`` of the
    reference's oracle and, where its blocks divide S and T, of its Pallas
    kernel (interpret mode)."""
    rng = np.random.default_rng(3000 + 100 * hd + 10 * g + s)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    got = _emulate_f32_kernel(*_torch(q, k, v), g).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    wants = [np.asarray(flashattn_ref(jq, jk, jv, g=g))]
    if pallas:
        wants.append(np.asarray(flashattn_pallas(jq, jk, jv, g=g, blk_q=32,
                                                 blk_k=32)))
    for want in wants:
        worst = _worst_over_flash_tol(got, want, v, g)
        assert worst <= 1.0, worst


def test_f32_single_tf32_breaks_stated_tolerance():
    """Negative control: one TF32 product per float32 product misses
    ``FLASH_TOL[float32]`` by more than ten times where three pass."""
    rng = np.random.default_rng(31)
    q, k, v = _inputs(rng, 1, 4, 256, 256, 64)
    want = np.asarray(flashattn_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                    g=4))
    worst = {three: _worst_over_flash_tol(
        _emulate_f32_kernel(*_torch(q, k, v), 4, three=three).numpy(),
        want, v, 4) for three in (True, False)}
    assert worst[True] <= 1.0 and worst[False] > 10.0, worst


def _f32_bwd_tiles(hd: int) -> tuple[int, int]:
    """(query rows per dK/dV item, ``DkdvF32::kBQ``; keys per dQ tile,
    ``DqF32::kBK``) of the float32 backward kernels."""
    return (64, 64) if hd <= 64 else (16, 16)


def _emulate_f32_bwd_kernel(q, k, v, o, lse, do, g, *, three=True,
                            per_item=True):
    """The float32 backward kernels' arithmetic in plain torch: delta =
    rowsum(do · o); p = exp(S − lse) under the causal mask, ds = p (dP −
    delta) scale, with S = (q scale) kᵀ and dP = do vᵀ in accumulators of
    their own (``_tc_mm``, three TF32 products or one), each in its
    kernel's operand order (dK/dV takes k and v as A, dQ takes q and do).
    dK/dV walks its KV head's g query heads and, for each, the query
    items of ``_f32_bwd_tiles`` rows: each item's pᵀ do and dsᵀ q (q
    unscaled) go to an accumulator of their own, added to dv and dk in
    float32, or with ``per_item=False`` all items to one accumulator (the
    first design, which missed ``BWD_TOL[float32]`` on the card).  dQ
    walks its key tiles, each tile's ds k in an accumulator of its own
    added to dq in float32.  Items and tiles wholly outside the mask add
    exact zeros, so every KV head walks them all."""
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    bq, bk = _f32_bwd_tiles(hd)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf = q.reshape(bkv, g, s, hd)
    qs = qf * scale
    dof = do.reshape(bkv, g, s, hd)
    delta = (dof * o.reshape(bkv, g, s, hd)).sum(dim=-1)[..., None]
    lse = lse.reshape(bkv, g, s)[..., None]
    mask = torch.arange(t)[None, :] <= ((t - s) + torch.arange(s))[:, None]
    k4, v4 = k[:, None], v[:, None]

    def probs(sc, dp):
        p = torch.where(mask, torch.exp(sc - lse), 0.0)
        return p, p * (dp - delta) * scale

    # dK/dV: Sᵀ = k (q scale)ᵀ and dPᵀ = v doᵀ, then per item.
    p, ds = probs(_tc_mm(k4, qs.transpose(-1, -2), three).transpose(-1, -2),
                  _tc_mm(v4, dof.transpose(-1, -2), three).transpose(-1, -2))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    long_k = long_v = None
    for h in range(g):
        for i0 in range(0, s, bq):
            rows = slice(i0, i0 + bq)
            pt = p[:, h, rows].transpose(-1, -2)
            dst = ds[:, h, rows].transpose(-1, -2)
            if per_item:
                dv = dv + _tc_mm(pt, dof[:, h, rows], three)
                dk = dk + _tc_mm(dst, qf[:, h, rows], three)
            else:
                long_v = _tc_mm(pt, dof[:, h, rows], three, long_v)
                long_k = _tc_mm(dst, qf[:, h, rows], three, long_k)
    if not per_item:
        dk, dv = long_k, long_v
    # dQ: S = (q scale) kᵀ and dP = do vᵀ, then per key tile.
    _, ds = probs(_tc_mm(qs, k4.transpose(-1, -2), three),
                  _tc_mm(dof, v4.transpose(-1, -2), three))
    dq = torch.zeros_like(qf)
    for k0 in range(0, t, bk):
        dq = dq + _tc_mm(ds[..., k0:k0 + bk], k4[:, :, k0:k0 + bk], three)
    return dq.reshape(bh, s, hd), dk, dv


def _f32_bwd_inputs(bkv, g, s, t, hd):
    rng = np.random.default_rng(9000 + 100 * hd + 10 * g + s)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    do = rng.normal(size=q.shape).astype(np.float32)
    return _torch(q, k, v, do)


@pytest.mark.parametrize("against", ["plain", "reference"])
@pytest.mark.parametrize("bkv,g,s,t,hd", [
    (2, 1, 64, 64, 16),
    (2, 4, 128, 128, 64),
    (1, 2, 77, 77, 64),              # ragged
    (1, 1, 45, 333, 128),            # ragged and windowed
    (1, 4, 77, 77, 112),             # zamba2-7b's head dim
    (2, 2, 200, 200, 32),
])
def test_f32_bwd_kernel_rounding_within_stated_tolerance(bkv, g, s, t, hd,
                                                         against):
    """The three-TF32 emulation within ``BWD_TOL[float32]`` of the plain
    backward (on the plain forward's o and lse) and of the reference's
    ``_flash_bwd`` through ``jax.vjp`` (on the reference forward's o and
    lse)."""
    from repro.models.attention import (_flash_fwd_loop,
                                        chunked_causal_attention)
    from repro_torch.kernels.flashattn import (flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    tq, tk, tv, tdo = _f32_bwd_inputs(bkv, g, s, t, hd)
    if against == "plain":
        o, lse = flashattn_fwd_plain(tq, tk, tv, g=g)
        want = [x.numpy() for x in
                flashattn_bwd_plain(tq, tk, tv, o, lse, tdo, g=g)]
    else:
        shape_q, shape_k = (1, s, bkv, g, hd), (1, t, bkv, hd)
        q5, k4, v4 = _from_kernel_layout(tq, tk, tv, shape_q, shape_k)
        do5 = _from_kernel_layout(tdo, tk, tv, shape_q, shape_k)[0]
        o_ref, lse_ref = _flash_fwd_loop(jnp.asarray(q5), jnp.asarray(k4),
                                         jnp.asarray(v4), 64)
        _, vjp = jax.vjp(lambda q, k, v: chunked_causal_attention(q, k, v, 64),
                         q5, k4, v4)
        dq5, dk4, dv4 = (np.array(x) for x in vjp(jnp.asarray(do5)))
        want = [x.numpy() for x in _to_kernel_layout(dq5, dk4, dv4, dq5)[:3]]
        o = torch.from_numpy(np.array(o_ref)).reshape(bkv * g, s, hd)
        lse = torch.from_numpy(np.array(lse_ref)).reshape(bkv * g, s)
    got = _emulate_f32_bwd_kernel(tq, tk, tv, o, lse, tdo, g)
    worst = _worst_over_bwd_tol([x.numpy() for x in got], want,
                                torch.float32)
    assert worst <= 1.0, worst


def test_f32_bwd_single_tf32_breaks_stated_tolerance():
    """Negative control: one TF32 product per float32 product misses
    ``BWD_TOL[float32]`` by more than ten times where three pass."""
    from repro_torch.kernels.flashattn import (flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    tq, tk, tv, tdo = _f32_bwd_inputs(2, 4, 128, 128, 64)
    o, lse = flashattn_fwd_plain(tq, tk, tv, g=4)
    want = [x.numpy()
            for x in flashattn_bwd_plain(tq, tk, tv, o, lse, tdo, g=4)]
    worst = {three: _worst_over_bwd_tol(
        [x.numpy() for x in _emulate_f32_bwd_kernel(
            tq, tk, tv, o, lse, tdo, 4, three=three)], want, torch.float32)
        for three in (True, False)}
    assert worst[True] <= 1.0 and worst[False] > 10.0, worst


def test_f32_bwd_long_accumulator_breaks_stated_tolerance():
    """Negative control: dK and dV summed over all of a KV head's 2,048
    query rows in one accumulator, under ``_tc_mm``'s truncating model,
    miss ``BWD_TOL[float32]`` (about 2× here; the first design on the
    card read 1.16–4.22× at S = T = 1,000), where one accumulator per
    query item passes."""
    from repro_torch.kernels.flashattn import (flashattn_bwd_plain,
                                               flashattn_fwd_plain)
    tq, tk, tv, tdo = _f32_bwd_inputs(1, 4, 512, 512, 64)
    o, lse = flashattn_fwd_plain(tq, tk, tv, g=4)
    want = flashattn_bwd_plain(tq, tk, tv, o, lse, tdo, g=4)
    worst = {}
    for per_item in (True, False):
        got = _emulate_f32_bwd_kernel(tq, tk, tv, o, lse, tdo, 4,
                                      per_item=per_item)
        worst[per_item] = _worst_over_bwd_tol(
            [x.numpy() for x in got[1:]], [x.numpy() for x in want[1:]],
            torch.float32)
    assert worst[True] <= 1.0 and worst[False] > 1.0, worst


def test_tf32_rounding_is_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits, rounding half a unit up in
    magnitude (``cvt.rna``), and ``hi + lo`` keeps about 21 bits."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0]
    y = torch.from_numpy(np.random.default_rng(5).normal(size=4096)
                         .astype(np.float32))
    hi, lo = _tf32_parts(y, True)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -20


@pytest.mark.parametrize("fn", ["fwd", "bwd"])
def test_wrapper_refuses_misaligned_f32_tensors(fn):
    """The float32 kernels load their tiles by TMA too: the launch path
    refuses a float32 view 4 bytes past an aligned start by name, before
    any build or launch."""
    from repro_torch.kernels.flashattn import _launch_bwd, _launch_fwd
    q = torch.zeros((2, 16, 16))
    view = torch.zeros(2 * 16 * 16 + 1)[1:].view(2, 16, 16)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match=r"float32 k must start at 16-byte"):
        if fn == "fwd":
            _launch_fwd(q, view, q, 1, dev, True)
        else:
            lse = torch.zeros((2, 16))
            _launch_bwd(q, view, q, q, lse, q, 1, dev)
