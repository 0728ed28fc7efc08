"""Attention (the reference's ``repro/models/attention.py``): GQA with
RoPE, causal prefill attention through the flash kernel, KV-cache decode.

GQA layout as the reference's: queries (B, S, KVH, G, hd) with
H = KVH·G, keys and values (B, T, KVH, hd), so repeated KV heads never
materialize.  Prefill attention (:func:`chunked_causal_attention`) runs
the hand-written CUDA kernel ``kernels.flashattn`` on the card, the
reference's Pallas TPU kernel's counterpart.  Where a gradient is wanted
(grad mode on and q, k or v requiring one), the same kernel runs through
``kernels.flashattn.FlashAttention``, the reference's custom VJP: it
saves (q, k, v, o, lse) and its backward is the hand-written backward
kernel, which recomputes the probability tiles.  Decode attention stays
plain PyTorch, as the reference computes it with ``einsum`` and
``softmax`` outside any kernel.

KV-head replication (``kv_repeat``, the reference's Megatron GQA trick
for tensor parallelism, :func:`kv_replication_for`): each K/V head is
repeated r times and the queries regroup into KVH·r groups of G/r, so
the kernel sees G/r query heads per KV head; prefill forces r = 1, so
the decode cache holds the true KV heads.

On a device mesh (``models.shardctx``), q, k, v and the attention
output are laid out at the reference's ``constrain`` sites, and the
kernel, which takes no DTensor, runs on each rank's heads through
``shardctx.local`` (``local_map``): heads shard over ``model`` where
their count divides it, and are replicated where it does not.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.flashattn import NEG_INF, FlashAttention, flashattn
from repro_torch.models import shardctx
from repro_torch.models.layers import RMSNorm, apply_rope, linear


def kv_replication_for(num_heads: int, num_kv_heads: int, tp: int) -> int:
    """Minimal KV-head replication r (dividing the group size) such that
    kv_heads·r shards over a tp-way axis (e.g. kv 8, TP 16 ⇒ r 2); 1 when
    none does."""
    g = num_heads // num_kv_heads
    if num_kv_heads % tp == 0:
        return 1
    for r in range(2, g + 1):
        if g % r == 0 and (num_kv_heads * r) % tp == 0:
            return r
    return 1


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
                 rope_theta: float, qk_norm: bool, kv_repeat: int = 1):
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
    if kv_repeat > 1:
        # each KV head r times in a row (jnp.repeat), queries regrouped
        if g % kv_repeat:
            raise ValueError(f"kv_repeat={kv_repeat} does not divide the "
                             f"group size {g}")
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
        q = q.reshape(b, s, num_kv_heads * kv_repeat, g // kv_repeat,
                      head_dim)
    q = shardctx.constrain(q, ("batch", "q_seq", "heads", None, None))
    k = shardctx.constrain(k, ("batch", "kv_seq", "heads", None))
    v = shardctx.constrain(v, ("batch", "kv_seq", "heads", None))
    return q, k, v


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Causal attention with queries aligned to the end of the key range.

    q: (B, S, KVH, G, hd); k, v: (B, T, KVH, hd) → (B, S, KVH, G, hd) in
    q's dtype, through the flash kernel (:func:`_flash`); on a mesh, on
    each rank's batch and heads."""
    return shardctx.local(_flash, (q, k, v),
                          (("batch", "q_seq", "heads", None, None),
                           ("batch", "kv_seq", "heads", None),
                           ("batch", "kv_seq", "heads", None)), (0,))


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """:func:`chunked_causal_attention` on plain tensors: reshapes to the
    kernel's (B·KVH·G, S, hd) / (B·KVH, T, hd) layout (one copy each
    way) and calls :func:`kernels.flashattn.flashattn` on the tensors'
    device, or ``FlashAttention`` (its gradient through the backward
    kernel) when one is wanted."""
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * kvh * g, s, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * kvh, t, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * kvh, t, hd).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = FlashAttention.apply(qf, kf, vf, g)
    else:
        o = flashattn(qf, kf, vf, g=g)
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
                    qk_norm: bool = False, kv_repeat: int = 1,
                    return_kv: bool = False):
    """Full causal self-attention over x (B, S, D) → (B, S, D), with each
    KV head replicated ``kv_repeat`` times; with ``return_kv`` also the
    (k, v) projections (B, S, KVH, hd), which prefill writes into the
    decode cache (``kv_repeat`` is then 1: the cache holds the true KV
    heads)."""
    b, s, _ = x.shape
    if return_kv:
        kv_repeat = 1
    q, k, v = _project_qkv(attn, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, qk_norm, kv_repeat)
    o = chunked_causal_attention(q, k, v).reshape(b, s, num_heads * head_dim)
    o = shardctx.constrain(o, ("batch", "seq", "heads"))
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
           "chunked_causal_attention", "kv_replication_for", "make_kv_cache",
           "naive_causal_attention"]
