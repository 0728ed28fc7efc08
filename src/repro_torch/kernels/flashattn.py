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
them: float32 runs a kernel that does the reference's float32 arithmetic
on the CUDA cores; bfloat16 runs a tensor-core kernel (``wgmma`` products
fed by TMA copies) whose two products take bf16 operands with float32
sums: the probabilities are rounded to bf16 before the value product, as
``scaled_dot_product_attention`` does, so its outputs differ from
:func:`flashattn_plain`'s by up to about ``2**-9 * max|v|`` of the KV
head beyond their own bf16 rounding (``chip_smoke.py``'s ``FLASH_TOL``).

Differences from the TPU kernel, none visible in the results:

* no padding: S and T are any lengths with ``S <= T`` (the TPU kernel
  wanted multiples of its blocks; a query row with no key at or before it
  has no causal meaning, so ``S > T`` is refused);
* ``hd`` is one of :data:`HEAD_DIMS` (a template parameter of the kernels),
  f32 or bf16, q, k and v of one dtype; bf16 tensors start 16-byte
  aligned (TMA's rule; every fresh allocation does).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`flashattn_plain`, the same function in plain
PyTorch.  There is no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._launch import count_launch, ptr, raise_on, stream

NEG_INF = -1e30
#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 112, 128)
#: Query rows per CUDA block, and keys per KV tile of the kernel and of
#: the plain version's online-softmax loop.
BLOCK_Q = BLOCK_K = 64
#: The kernel's grid has one y index per query tile.
MAX_S = 65535 * BLOCK_Q


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
    _check(q, k, v, g)
    dev = q.device if device is None else resolve_device(device)
    if q.device != dev:
        raise ValueError(f"tensors on {q.device}, but device={dev}")
    if dev.type != "cuda":
        return flashattn_plain(q, k, v, g=g)
    bh, s, hd = q.shape
    t = k.shape[1]
    if s > MAX_S:
        raise ValueError(f"S={s} above the kernel's {MAX_S}")
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("bf16 q, k, v must start at 16-byte aligned "
                         "addresses (the kernel's TMA copies need it)")
    out = torch.empty_like(q)
    if bh and s:
        from repro_torch.kernels import _build
        lib = _build.load()
        launch = lib.flashattn_bf16_launch if bf16 else \
            lib.flashattn_f32_launch
        err = launch(ptr(q), ptr(k), ptr(v), ptr(out), bh, s, t, hd, g,
                     float(_scale(hd)), stream(dev))
        raise_on(err, "flashattn")
        count_launch("flashattn")
    return out


def _scale(hd: int) -> np.float32:
    """``1/sqrt(hd)`` rounded to float32, as the reference scales q."""
    return np.float32(1.0 / np.sqrt(hd))


def flashattn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    g: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`flashattn`: the online-softmax loop
    of the reference's ``_flash_fwd_loop`` over KV blocks of
    :data:`BLOCK_K` keys, in float32."""
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
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(bh, s, hd).to(q.dtype)


__all__ = ["BLOCK_K", "BLOCK_Q", "HEAD_DIMS", "NEG_INF", "flashattn",
           "flashattn_plain"]
