"""Causal GQA flash attention for Hopper: the wrapper and its plain version.

:func:`flashattn` replaces the reference's Pallas TPU kernel
``flashattn_pallas`` (``repro/kernels/flashattn.py``) with the hand-written
CUDA kernel in ``csrc/flashattn.cu`` (``LAUNCHES["flashattn"]``).  Layout
and masking are the TPU kernel's: q (BH, S, hd) with BH = BKV·g, k and v
(BKV, T, hd); query head ``bh`` reads KV head ``bh // g``; query row ``i``
sits at key position ``(T - S) + i`` and sees the keys at or before it.
Softmax in float32 (scores scaled by ``1/sqrt(hd)``, the finite sentinel
−1e30 on masked scores), output in q's dtype.

The wrapper picks one of two kernels by dtype, with no fallback between
them, both on the tensor cores (``wgmma`` products fed by TMA copies).
bfloat16: the two products take bf16 operands with float32 sums; the
probabilities are rounded to bf16 before the value product, as
``scaled_dot_product_attention`` does, so its outputs differ from
:func:`flashattn_plain`'s by up to about ``2**-9 * max|v|`` of the KV
head beyond their own bf16 rounding (``chip_smoke.py``'s ``FLASH_TOL``).
float32: each product is three TF32 products of split operands (``hi =
tf32(x)``, ``lo = tf32(x − hi)``; hi·hi + hi·lo + lo·hi, each exact in
float32, with float32 sums), about 21 of float32's 24 bits, where the
reference's float32 products keep all 24.  ``chip_smoke.py`` reads 0.26
of ``FLASH_TOL[float32]`` at worst on an H100;
``tests/test_torch_flashattn.py`` emulates the kernel on the CPU, with
its key tiles and a model of the tensor cores' accumulate, at 0.16 of
it at worst over the tests' shapes, and one TF32 product misses it by
10–71×.

Differences from the TPU kernel, none visible in the results:

* no padding: S and T are any lengths with ``S <= T`` (the TPU kernel
  wanted multiples of its blocks; a query row with no key at or before it
  has no causal meaning, so ``S > T`` is refused);
* ``hd`` is one of :data:`HEAD_DIMS` (a template parameter of the kernels),
  f32 or bf16, q, k and v of one dtype; the tensors start 16-byte
  aligned (TMA's rule; every fresh allocation does), and so does the
  backward's do.

The gradient: :func:`flashattn_fwd` also returns each row's
log-sum-exp, and :func:`flashattn_bwd` is the hand-written backward (three
CUDA launches, ``BWD_KERNELS``; the reference's backward is jnp, the
custom VJP ``_flash_bwd`` of ``repro/models/attention.py``, with no
Pallas kernel).  :class:`FlashAttention` ties them into an
``autograd.Function`` that saves (q, k, v, o, lse).  The backward
recomputes the probabilities in float32 from q, k and lse, as the
reference does, although a bf16 forward rounded them to bf16 before its
value product.  One difference: delta = rowsum(do · o) reads the output
in q's dtype, where the reference keeps its float32 output as the
residual (the same in float32).

The backward's two routes, again by dtype and with no fallback, each two
tensor-core kernels (``wgmma`` fed by TMA, as the forward): dK/dV, one
block per KV head's 64-key tile walking its group's query heads and
tiles, and dQ, one block per 64-row query tile walking its key tiles, so
each sum runs in one block in a fixed order (no atomics: two calls give
the same bits).  bfloat16: the scores and dO·vᵀ are exact products of
the bf16 inputs with float32 sums; p and ds enter the value products as
hi + lo bf16 pairs (``hi = bf16(x)``, ``lo = bf16(x − hi)``, about 16
bits), where ``scaled_dot_product_attention``'s backward rounds them to
bf16 once, which would miss ``chip_smoke.py``'s ``BWD_TOL`` by tens of
times; ten products of 2·hd flops per causal pair against the bound's
five (S and dP in both kernels, each value product twice).  float32:
every product three TF32 products, as the forward's, and each tile's or
query item's value product in an accumulator of its own, added to the
sum in float32 (one accumulator over a KV head's whole sum drifted past
``BWD_TOL[float32]`` on the card): 0.61 of ``BWD_TOL[float32]`` at
worst on an H100, 0.38 in the CPU emulation, and one TF32 product
misses it by 84–192×.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (:func:`flashattn_plain`,
:func:`flashattn_fwd_plain`, :func:`flashattn_bwd_plain`), the same
function in plain PyTorch; on a ``meta`` tensor (a dry run,
``roofline.dryrun``) it returns empty outputs of the right shapes.  There
is no fallback from one to the other.  Each wrapper declares its work
(``roofline.kernels``) to a ``roofline.opcount`` counter, on every
device alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._launch import count_launch, ptr, raise_on, stream
from repro_torch.roofline import kernels as costs
from repro_torch.roofline.opcount import declare

NEG_INF = -1e30
#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 112, 128)
#: Query rows per CUDA block, and keys per KV tile of the kernel and of
#: the plain version's online-softmax loop.
BLOCK_Q = BLOCK_K = 64
#: The kernel's grid has one y index per query tile.
MAX_S = 65535 * BLOCK_Q
#: The backward's kernels, in launch order, by their ``LAUNCHES`` names.
BWD_KERNELS = ("flashattn_bwd_delta", "flashattn_bwd_dkdv",
               "flashattn_bwd_dq")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: int):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q must be (BH, S, hd), k and v (BKV, T, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, hd = q.shape
    bkv, t, hd_k = k.shape
    if g < 1 or bh != bkv * g or hd_k != hd:
        raise ValueError(f"BH={bh} must be BKV={bkv} × g={g}, and k's head "
                         f"dim {hd_k} q's {hd}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if s > t:
        raise ValueError(f"S={s} > T={t}: the first {s - t} query rows "
                         f"would have no key at or before them")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}/{k.device}/{v.device}")


def flashattn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, g: int,
              device=None) -> torch.Tensor:
    """Causal attention ``softmax(q kᵀ / sqrt(hd) + mask) v`` per query
    head, as the module docstring lays out; returns (BH, S, hd) in q's
    dtype.  ``device`` (default: the tensors' device, resolved as every
    entry point resolves it) must be where the tensors lie."""
    return _forward(q, k, v, g, device, with_lse=False)[0]


def flashattn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  g: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flashattn` that also returns each query row's log-sum-exp
    ``m + log(max(l, 1e-30))``, float32 (BH, S): the residual the backward
    recomputes the probabilities from."""
    return _forward(q, k, v, g, device, with_lse=True)


def _on(q: torch.Tensor, device) -> torch.device:
    dev = q.device if device is None else resolve_device(device)
    if q.device != dev:
        raise ValueError(f"tensors on {q.device}, but device={dev}")
    return dev


def _contiguous(**xs: torch.Tensor) -> None:
    for what, x in xs.items():
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _aligned(**xs: torch.Tensor) -> None:
    """The kernels' TMA copies need 16-byte aligned starts (both dtypes;
    the tensors share one)."""
    bad = [what for what, x in xs.items() if x.data_ptr() % 16]
    if bad:
        dtype = next(iter(xs.values())).dtype
        name = "bf16" if dtype == torch.bfloat16 else "float32"
        raise ValueError(f"{name} {', '.join(bad)} must start at 16-byte "
                         f"aligned addresses (the kernels' TMA copies "
                         f"need it)")


def _forward(q, k, v, g: int, device, *, with_lse: bool):
    _check(q, k, v, g)
    dev = _on(q, device)
    with declare("flashattn", lambda: costs.flash_fwd_cost(
            q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2],
            q.dtype, with_lse)):
        if dev.type == "meta":                # shapes alone
            return torch.empty_like(q), (torch.empty(
                q.shape[:2], dtype=torch.float32, device=dev)
                if with_lse else None)
        if dev.type != "cuda":
            return flashattn_fwd_plain(q, k, v, g=g) if with_lse else (
                flashattn_plain(q, k, v, g=g), None)
        return _launch_fwd(q, k, v, g, dev, with_lse)


def _launch_fwd(q, k, v, g: int, dev, with_lse: bool):
    bh, s, hd = q.shape
    t = k.shape[1]
    if s > MAX_S:
        raise ValueError(f"S={s} above the kernel's {MAX_S}")
    _contiguous(q=q, k=k, v=v)
    _aligned(q=q, k=k, v=v)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=dev)
           if with_lse else None)
    if bh and s:
        from repro_torch.kernels import _build
        lib = _build.load()
        launch = lib.flashattn_bf16_launch if bf16 else \
            lib.flashattn_f32_launch
        err = launch(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), bh, s, t,
                     hd, g, float(_scale(hd)), stream(dev))
        raise_on(err, "flashattn")
        count_launch("flashattn")
    return out, lse


def flashattn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  g: int, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flashattn`'s output ``o`` under the
    upstream gradient ``do`` (like ``o``), from the forward's ``lse``: dq
    like q, dk and dv like k, in their dtype.  On the card: three CUDA
    launches (``LAUNCHES["flashattn_bwd_delta"]``, ``["flashattn_bwd_dkdv"]``
    and ``["flashattn_bwd_dq"]``), the tensor-core kernels of q's dtype,
    as the module docstring lays out; on the CPU
    :func:`flashattn_bwd_plain`."""
    _check_bwd(q, k, v, o, lse, do, g)
    dev = _on(q, device)
    with declare("flashattn_bwd", lambda: costs.flash_bwd_cost(
            q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2],
            q.dtype)):
        if dev.type == "meta":                # shapes alone
            return tuple(torch.empty_like(x) for x in (q, k, v))
        if dev.type != "cuda":
            return flashattn_bwd_plain(q, k, v, o, lse, do, g=g)
        return _launch_bwd(q, k, v, o, lse, do, g, dev)


def _launch_bwd(q, k, v, o, lse, do, g: int, dev):
    bh, s, hd = q.shape
    t = k.shape[1]
    if s > MAX_S or t > MAX_S:
        raise ValueError(f"S={s} or T={t} above the kernels' {MAX_S}")
    _contiguous(q=q, k=k, v=v, o=o, lse=lse, do=do)
    _aligned(q=q, k=k, v=v, do=do)
    bf16 = q.dtype == torch.bfloat16
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((bh, s), dtype=torch.float32, device=dev)
    if bh and s:
        from repro_torch.kernels import _build
        lib = _build.load()
        launch = lib.flashattn_bwd_bf16_launch if bf16 else \
            lib.flashattn_bwd_f32_launch
        err = launch(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(do),
                     ptr(delta), ptr(dq), ptr(dk), ptr(dv), bh, s, t, hd, g,
                     float(_scale(hd)), stream(dev))
        raise_on(err, "flashattn_bwd")
        for name in BWD_KERNELS:
            count_launch(name)
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def _check_bwd(q, k, v, o, lse, do, g: int) -> None:
    _check(q, k, v, g)
    if o.shape != q.shape or do.shape != q.shape or not (
            o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o and do must be q's {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:2])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not q.device == o.device == lse.device == do.device:
        raise ValueError(f"q, o, lse, do on {q.device}/{o.device}/"
                         f"{lse.device}/{do.device}")


def _scale(hd: int) -> np.float32:
    """``1/sqrt(hd)`` rounded to float32, as the reference scales q."""
    return np.float32(1.0 / np.sqrt(hd))


def flashattn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    g: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`flashattn`: the online-softmax loop
    of the reference's ``_flash_fwd_loop`` over KV blocks of
    :data:`BLOCK_K` keys, in float32."""
    return flashattn_fwd_plain(q, k, v, g=g)[0]


def flashattn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flashattn_fwd`: (:func:`flashattn_plain`'s
    output, its loop's ``m + log(max(l, 1e-30))``)."""
    _check(q, k, v, g)
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    q32 = (q.float() * float(_scale(hd))).reshape(bkv, g, s, hd)
    q_pos = (t - s) + torch.arange(s, device=q.device)
    m = torch.full((bkv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bkv, g, s, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        kb = k[:, k0:k0 + BLOCK_K].float()
        vb = v[:, k0:k0 + BLOCK_K].float()
        k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
        scores = torch.einsum("bgsh,bth->bgst", q32, kb)
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgst,bth->bgsh", p, vb)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = acc / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.reshape(bh, s, hd).to(q.dtype), lse.reshape(bh, s)


def flashattn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, g: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flashattn_bwd`: the reference's
    ``_flash_bwd`` chunk loop over KV blocks of :data:`BLOCK_K` keys, in
    float32: delta = rowsum(do · o); per block, p = exp(scores − lse)
    under the causal mask, dv = pᵀ do, ds = p (do vᵀ − delta) / sqrt(hd),
    dq += ds k, dk = dsᵀ q."""
    _check_bwd(q, k, v, o, lse, do, g)
    bh, s, hd = q.shape
    bkv, t, _ = k.shape
    scale = float(_scale(hd))
    q32 = q.float().reshape(bkv, g, s, hd)
    do32 = do.float().reshape(bkv, g, s, hd)
    delta = (do32 * o.float().reshape(bkv, g, s, hd)).sum(dim=-1)
    lse = lse.reshape(bkv, g, s)
    q_pos = (t - s) + torch.arange(s, device=q.device)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    for k0 in range(0, t, BLOCK_K):
        kb = k[:, k0:k0 + BLOCK_K].float()
        vb = v[:, k0:k0 + BLOCK_K].float()
        k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
        scores = torch.einsum("bgsh,bth->bgst", q32 * scale, kb)
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        p = torch.exp(scores - lse[..., None])
        dvs.append(torch.einsum("bgst,bgsh->bth", p, do32))
        dp = torch.einsum("bgsh,bth->bgst", do32, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bgst,bth->bgsh", ds, kb)
        dks.append(torch.einsum("bgst,bgsh->bth", ds, q32))
    if not dks:                               # T = 0
        return (dq.reshape(bh, s, hd).to(q.dtype), torch.zeros_like(k),
                torch.zeros_like(v))
    return (dq.reshape(bh, s, hd).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """:func:`flashattn` with a gradient: ``forward`` runs
    :func:`flashattn_fwd` and saves (q, k, v, o, lse), ``backward``
    :func:`flashattn_bwd` (the reference's ``custom_vjp``, ``_flash_fwd``
    and ``_flash_bwd``).  ``FlashAttention.apply(q, k, v, g)``."""

    @staticmethod
    def forward(ctx, q, k, v, g):
        o, lse = flashattn_fwd(q, k, v, g=g)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.g = g
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flashattn_bwd(q, k, v, o, lse, do.contiguous(), g=ctx.g)
        return dq, dk, dv, None


__all__ = ["BLOCK_K", "BLOCK_Q", "BWD_KERNELS", "FlashAttention",
           "HEAD_DIMS", "NEG_INF", "flashattn", "flashattn_bwd",
           "flashattn_bwd_plain", "flashattn_fwd", "flashattn_fwd_plain",
           "flashattn_plain"]
