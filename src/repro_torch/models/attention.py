"""Attention (the reference's ``repro/models/attention.py``): GQA with
RoPE, causal prefill attention through the flash kernel, KV-cache decode.

GQA layout as the reference's: queries (B, S, KVH, G, hd) with
H = KVH·G, keys and values (B, T, KVH, hd), so repeated KV heads never
materialize.  Prefill attention (:func:`chunked_causal_attention`) runs
the hand-written CUDA kernel ``kernels.flashattn`` on the card, the
reference's Pallas TPU kernel's counterpart.  Decode attention stays plain
PyTorch, as the reference computes it with ``einsum`` and ``softmax``
outside any kernel.

Not ported: the reference's ``shardctx.constrain`` calls (no-ops outside
a mesh context; the device-mesh version comes with ``launch/``), KV-head
replication for tensor parallelism (``kv_repeat``, a launcher setting),
and the custom VJP (the backward belongs to training).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.flashattn import NEG_INF, flashattn
from repro_torch.models.layers import RMSNorm, apply_rope, linear


class Attention(nn.Module):
    """wq (H·hd, D), wk and wv (KVH·hd, D), wo (D, H·hd); optional per-head
    q/k RMSNorm."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, qk_norm: bool = False, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = linear(d_model, num_heads * head_dim, **kw)
        self.wk = linear(d_model, num_kv_heads * head_dim, **kw)
        self.wv = linear(d_model, num_kv_heads * head_dim, **kw)
        self.wo = linear(num_heads * head_dim, d_model, **kw)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, **kw)
            self.k_norm = RMSNorm(head_dim, **kw)


def _project_qkv(attn: Attention, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                 rope_theta: float, qk_norm: bool):
    b, s, _ = x.shape
    g = num_heads // num_kv_heads
    q = attn.wq(x).reshape(b, s, num_kv_heads, g, head_dim)
    k = attn.wk(x).reshape(b, s, num_kv_heads, head_dim)
    v = attn.wv(x).reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    q = apply_rope(q.reshape(b, s, num_kv_heads * g, head_dim), positions,
                   rope_theta).reshape(b, s, num_kv_heads, g, head_dim)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Causal attention with queries aligned to the end of the key range.

    q: (B, S, KVH, G, hd); k, v: (B, T, KVH, hd) → (B, S, KVH, G, hd) in
    q's dtype.  Reshapes to the kernel's (B·KVH·G, S, hd) / (B·KVH, T, hd)
    layout (one copy each way) and calls :func:`kernels.flashattn.flashattn`
    on the tensors' device.
    """
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * kvh * g, s, hd)
    kf = k.permute(0, 2, 1, 3).reshape(b * kvh, t, hd)
    vf = v.permute(0, 2, 1, 3).reshape(b * kvh, t, hd)
    o = flashattn(qf.contiguous(), kf.contiguous(), vf.contiguous(), g=g)
    return o.reshape(b, kvh, g, s, hd).permute(0, 3, 1, 2, 4)


def naive_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Reference implementation (materializes the full scores); tests
    only."""
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    scores = torch.einsum("bsngh,btnh->bngst", q.float() * scale, k.float())
    q_pos = (t - s) + torch.arange(s, device=q.device)
    mask = torch.arange(t, device=q.device)[None, :] <= q_pos[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", p, v.float())
    return out.to(q.dtype)


def attention_block(attn: Attention, x: torch.Tensor,
                    positions: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    qk_norm: bool = False, return_kv: bool = False):
    """Full causal self-attention over x (B, S, D) → (B, S, D); with
    ``return_kv`` also the (k, v) projections (B, S, KVH, hd), which
    prefill writes into the decode cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(attn, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, qk_norm)
    o = chunked_causal_attention(q, k, v).reshape(b, s, num_heads * head_dim)
    out = attn.wo(o)
    if return_kv:
        return out, (k, v)
    return out


# ----------------------------------------------------------------------
# KV-cache decode
# ----------------------------------------------------------------------
def make_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, device) -> dict:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(attn: Attention, x: torch.Tensor, cache: dict,
                     pos: int, *, num_heads: int, num_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     qk_norm: bool = False) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, D), cache k/v (B, T, KVH, hd), ``pos``
    the new token's position.

    Writes the new KV at ``pos`` *in place* (the reference returns an
    updated copy; the port saves the copy of the whole cache each step)
    and attends over cache[0:pos+1] by masking the rest.  Returns (out,
    the same cache dict).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(attn, x, num_heads, num_kv_heads,
                                   head_dim, positions, rope_theta, qk_norm)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    t = k.shape[1]
    scale = float(np.float32(1.0 / np.sqrt(head_dim)))
    scores = torch.einsum("bsngh,btnh->bngst", q.float() * scale, k.float())
    mask = torch.arange(t, device=x.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bngst,btnh->bsngh", p, v.float())
    o = o.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    return attn.wo(o), cache


__all__ = ["Attention", "attention_block", "attention_decode",
           "chunked_causal_attention", "make_kv_cache",
           "naive_causal_attention"]
