"""Decoder-only LM (the reference's ``repro/models/transformer.py``) for
the ``attn`` block pattern: the dense GQA transformers (granite-3-2b,
starcoder2-3b, nemotron-4-15b, minicpm-2b, chameleon-34b's backbone), the
mixture-of-experts ones (qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b; the
layer's FFN is ``models.moe``), and embedding inputs (musicgen-large,
``input_mode="embeddings"``: ``batch["embeddings"]`` (B, S, D) in place
of tokens, (B, D) per decode step, cast to the model dtype without
``embed_scale``; the token table is built all the same, as the reference
builds it).

The parameters live in an ``nn.Module`` (:class:`LM`) whose layers are an
``nn.ModuleList`` of per-layer modules (the reference stacks them on a
leading L axis and scans); ``forward``, ``prefill``, ``init_cache`` and
``decode_step`` are functions over it with the reference's signatures and
returns.  The decode cache is the reference's dict of (L, B, max_len,
KVH, hd) tensors, written in place by ``decode_step``.

Not ported yet (ROADMAP A.13): the ``xlstm`` and ``zamba`` block
patterns and KV-head replication (``kv_replication != 1``, a launcher
setting), which raise ``NotImplementedError``, and training's loss.
:func:`param_count` counts every configuration, as the reference does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models.layers import MLP, Embedding, RMSNorm, mlp_param_count
from repro_torch.models.moe import MoE, moe_apply

#: Mamba2's head width and causal-conv width (the reference's
#: ``repro/models/ssm.py``), for :func:`param_count` only.
MAMBA_HEADDIM = 64
MAMBA_CONV = 4


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg: ModelConfig) -> None:
    unported = []
    if cfg.block_pattern != "attn":
        unported.append(f"block_pattern={cfg.block_pattern!r}")
    if cfg.kv_replication != 1:
        unported.append("KV-head replication (a launcher setting)")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet (ROADMAP "
            f"A.13); the port runs the attn block pattern")


class AttnLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        kw = dict(dtype=_dtype(cfg), device=device)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.attn = attention.Attention(
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, qk_norm=cfg.qk_norm, **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        if cfg.is_moe:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.num_experts, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)


class LM(nn.Module):
    """The parameters of one model, uninitialised (see :func:`init_params`
    and ``convert.params_from_jax``); ``device`` is resolved as every
    entry point resolves it."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        # Shapes first (on the meta device), then storage on `dev`: no
        # layer spends time or random numbers on an init that is
        # overwritten.
        meta = torch.device("meta")
        kw = dict(dtype=_dtype(cfg), device=meta)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab_size, cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.head = Embedding(cfg.padded_vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(AttnLayer(cfg, device=meta)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, **kw)
        self.to_empty(device=dev)
        self.requires_grad_(False)          # serving only: no backward yet

    @property
    def device(self) -> torch.device:
        return self.final_ln.scale.device

    def output_head(self) -> Embedding:
        return self.embed if self.cfg.tie_embeddings else self.head


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> LM:
    """Random weights from ``generator`` (a generator of ``device``),
    distributed as the reference's ``init_params``: projections, routers
    and expert weights normal / sqrt(fan_in), embedding tables normal ×
    0.02, norm scales 1.  The numbers differ from the reference's
    (``jax.random`` is another generator); ``convert.params_from_jax``
    carries the reference's own weights."""
    model = LM(cfg, device=device)
    for name, p in model.named_parameters():
        if name.endswith(".table"):
            std = 0.02
        elif name.endswith(".router"):      # (d_model, E)
            std = p.shape[0] ** -0.5
        elif p.dim() in (2, 3):             # (d_out, d_in); (E, d_in, d_out)
            std = p.shape[1] ** -0.5
        else:
            p.fill_(1.0)
            continue
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)
    return model


# ======================================================================
# forward
# ======================================================================
def _layer(cfg: ModelConfig, layer: AttnLayer, x: torch.Tensor,
           positions: torch.Tensor, *, return_kv: bool = False):
    h = attention.attention_block(
        layer.attn, layer.ln1(x), positions, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, return_kv=return_kv)
    if return_kv:
        h, kv = h
    x = x + h * cfg.residual_scale
    h, aux = _ffn(cfg, layer, x)
    x = x + h * cfg.residual_scale
    return (x, aux, kv) if return_kv else (x, aux)


def _ffn(cfg: ModelConfig, layer: AttnLayer, x: torch.Tensor):
    """The layer's MLP or MoE on ln2(x): (h, MoE aux loss or None)."""
    if cfg.is_moe:
        return moe_apply(layer.moe, layer.ln2(x),
                         num_experts=cfg.num_experts,
                         experts_per_token=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
    return layer.mlp(layer.ln2(x)), None


def _embed(cfg: ModelConfig, model: LM, inputs) -> torch.Tensor:
    """The first hidden state: embeddings (..., D) cast to the model
    dtype, or tokens (...) embedded and scaled."""
    x = torch.as_tensor(inputs, device=model.device)
    if cfg.input_mode == "embeddings":
        return x.to(_dtype(cfg))
    return model.embed(x) * cfg.embed_scale


def _batch_inputs(cfg: ModelConfig, batch: dict):
    return batch["embeddings" if cfg.input_mode == "embeddings"
                 else "tokens"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _logits(cfg: ModelConfig, model: LM, x: torch.Tensor) -> torch.Tensor:
    x = model.final_ln(x)
    return model.output_head().unembed(x, cfg.vocab_size)[
        ..., :cfg.vocab_size]


def forward(cfg: ModelConfig, model: LM, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V) float32, the layers' summed MoE auxiliary loss,
    float32: 0 without experts).  ``batch["tokens"]`` (B, S) ints, or
    ``batch["embeddings"]`` (B, S, D) for ``input_mode="embeddings"``."""
    _check_supported(cfg)
    x = _embed(cfg, model, _batch_inputs(cfg, batch))
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, a = _layer(cfg, layer, x, positions)
        if a is not None:
            aux = aux + a
    return _logits(cfg, model, x), aux


# ======================================================================
# prefill (serve) path: forward + cache construction
# ======================================================================
def prefill(cfg: ModelConfig, model: LM, batch: dict, max_len: int, *,
            last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model: (logits (B, S, V) float32, decode
    cache positioned after the prompt).  ``max_len`` sizes the KV buffers;
    ``last_only`` keeps only the final position's logits (B, 1, V).
    ``batch`` as :func:`forward` takes it."""
    _check_supported(cfg)
    x = _embed(cfg, model, _batch_inputs(cfg, batch))
    b, s = x.shape[:2]
    if max_len < s:
        raise ValueError(f"max_len={max_len} below the prompt length {s}")
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, layer in enumerate(model.layers):
        x, _, (k, v) = _layer(cfg, layer, x, positions, return_kv=True)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, model, x), cache


# ======================================================================
# decode (serve) path
# ======================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Zeroed decode cache: k and v (L, B, max_len, KVH, hd)."""
    _check_supported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}


def decode_step(cfg: ModelConfig, model: LM, cache: dict, inputs,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One-token decode.  ``inputs`` (B,) tokens, or (B, D) embeddings
    for ``input_mode="embeddings"``; ``pos`` the position the new KV is
    written at.  Returns (logits (B, V) float32, the cache), which is
    updated in place."""
    _check_supported(cfg)
    pos = int(pos)
    if not 0 <= pos < cache["k"].shape[2]:
        raise ValueError(f"pos={pos} outside the cache's "
                         f"{cache['k'].shape[2]} positions")
    x = _embed(cfg, model, inputs)[:, None]
    for i, layer in enumerate(model.layers):
        h, _ = attention.attention_decode(
            layer.attn, layer.ln1(x), {"k": cache["k"][i],
                                       "v": cache["v"][i]}, pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm)
        x = x + h * cfg.residual_scale
        x = x + _ffn(cfg, layer, x)[0] * cfg.residual_scale
    return _logits(cfg, model, x)[:, 0], cache


# ======================================================================
# parameter counting (the reference's arithmetic; norm scales excluded)
# ======================================================================
def _attn_layer_params(cfg: ModelConfig, active_only: bool) -> int:
    hd = cfg.resolved_head_dim
    n = (cfg.d_model * cfg.num_heads * hd                # wq
         + 2 * cfg.d_model * cfg.num_kv_heads * hd       # wk, wv
         + cfg.num_heads * hd * cfg.d_model)             # wo
    if cfg.is_moe:
        experts = cfg.experts_per_token if active_only else cfg.num_experts
        n += experts * 3 * cfg.d_model * cfg.d_ff + cfg.d_model * cfg.num_experts
    else:
        n += mlp_param_count(cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return n


def _mamba2_param_count(d_model: int, ssm_state: int) -> int:
    d_inner = 2 * d_model
    h = d_inner // MAMBA_HEADDIM
    return (d_model * (2 * d_inner + 2 * ssm_state + h)
            + MAMBA_CONV * d_inner + 3 * h + d_inner + d_inner * d_model)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    n = cfg.padded_vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.block_pattern == "attn":
        n += cfg.num_layers * _attn_layer_params(cfg, active_only)
    elif cfg.block_pattern == "xlstm":
        k = cfg.xlstm_slstm_every or 8
        g, m_per = cfg.num_layers // k, k - 1
        dh = d // cfg.num_heads
        mlstm = 5 * d * d + 2 * cfg.num_heads * d
        slstm = 4 * d * d + cfg.num_heads * dh * 4 * dh + d * d
        n += g * (m_per * mlstm + slstm)
    elif cfg.block_pattern == "zamba":
        every = cfg.shared_attn_every or 6
        g, tail = cfg.num_layers // every, cfg.num_layers % every
        n += (g * every + tail) * _mamba2_param_count(d, cfg.ssm_state)
        n += _attn_layer_params(cfg, active_only)   # shared: counted once
    return n


__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params",
           "param_count", "prefill"]
