"""Decoder-only LM (the reference's ``repro/models/transformer.py``) with
its three block patterns:

* ``attn`` — the dense GQA transformers (granite-3-2b, starcoder2-3b,
  nemotron-4-15b, minicpm-2b, chameleon-34b's backbone), the
  mixture-of-experts ones (qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b; the
  layer's FFN is ``models.moe``), and embedding inputs (musicgen-large,
  ``input_mode="embeddings"``: ``batch["embeddings"]`` (B, S, D) in place
  of tokens, (B, D) per decode step, cast to the model dtype without
  ``embed_scale``; the token table is built all the same, as the reference
  builds it).
* ``zamba`` — zamba2-7b: a Mamba2 backbone (``models.ssm``) in groups of
  ``shared_attn_every`` layers, each group followed by ONE weight-shared
  attention + MLP block (the reference's simplification: no
  per-application LoRA), then the leftover Mamba2 layers.
* ``xlstm`` — xlstm-350m: groups of (k − 1) mLSTM layers and one sLSTM
  layer (``models.xlstm``; xLSTM[7:1], k = 8).

The parameters live in an ``nn.Module`` (:class:`LM`): the reference
stacks layers on leading axes and scans, the port holds an
``nn.ModuleList`` per stack (``layers``; ``mamba_groups`` of
``mamba_tail`` and ``shared_attn``; ``mlstm`` of lists and ``slstm``).
``forward``, ``prefill``, ``init_cache`` and ``decode_step`` are
functions over it with the reference's signatures and returns.  The
decode cache is the reference's dict for the pattern (``k``/``v``;
``ssm``, ``conv``, ``attn_k``, ``attn_v``, ``ssm_tail``, ``conv_tail``;
``mlstm`` and the ``slstm`` tuple (h, c, n, m)), of the same shapes,
written in place by ``decode_step``.

The parameters require gradients, as any ``nn.Module``'s do:
:func:`forward` and :func:`loss_fn` (training's loss, with the logits
streamed through ``layers.chunked_cross_entropy``) are differentiable,
and with ``remat`` each block that the reference's ``_trunk`` wraps in
``jax.checkpoint`` runs under ``torch.utils.checkpoint`` (its activations
recomputed in the backward): every attention layer of ``attn``, every
Mamba2 layer of ``zamba`` (not the shared block), every mLSTM layer of
``xlstm`` (not the sLSTM).  :func:`prefill` and :func:`decode_step` run
under ``torch.no_grad()`` and build no graph.

KV-head replication (``cfg.kv_replication``, a launcher setting for
tensor parallelism) applies where the reference applies it: in
:func:`forward` and :func:`loss_fn`; :func:`prefill` keeps r = 1, so the
decode cache holds the true KV heads.  On a device mesh
(``models.shardctx.activation_sharding``) the hidden state is laid out
at the reference's ``constrain`` sites.  :func:`param_count` counts
every configuration, as the reference does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, shardctx, ssm, xlstm
from repro_torch.models.layers import (MLP, Embedding, RMSNorm,
                                       chunked_cross_entropy, mlp_param_count)
from repro_torch.models.moe import MoE, moe_apply

#: Weight of the layers' summed MoE load-balance loss in :func:`loss_fn`.
MOE_AUX_COEF = 0.01


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _xlstm_group_sizes(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_groups, mlstm_per_group, group_len) for the xlstm pattern."""
    k = cfg.xlstm_slstm_every or 8
    if cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} xlstm layers are "
                         f"not a whole number of groups of {k}")
    return cfg.num_layers // k, k - 1, k


def _zamba_group_sizes(cfg: ModelConfig) -> tuple[int, int]:
    """(num_groups, tail_layers): layers = groups·every + tail."""
    every = cfg.shared_attn_every or 6
    return cfg.num_layers // every, cfg.num_layers % every


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


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        kw = dict(dtype=_dtype(cfg), device=device)
        self.ln = RMSNorm(cfg.d_model, **kw)
        self.mamba = ssm.Mamba2(cfg.d_model, cfg.ssm_state, **kw)


class MLSTMLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        kw = dict(dtype=_dtype(cfg), device=device)
        self.ln = RMSNorm(cfg.d_model, **kw)
        self.mlstm = xlstm.MLSTM(cfg.d_model, cfg.num_heads, **kw)


class SLSTMLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        kw = dict(dtype=_dtype(cfg), device=device)
        self.ln = RMSNorm(cfg.d_model, **kw)
        self.slstm = xlstm.SLSTM(cfg.d_model, cfg.num_heads, **kw)


def _layers(layer_cls, cfg: ModelConfig, n: int, device) -> nn.ModuleList:
    return nn.ModuleList(layer_cls(cfg, device=device) for _ in range(n))


class LM(nn.Module):
    """The parameters of one model, uninitialised (see :func:`init_params`
    and ``convert.params_from_jax``); ``device`` is resolved as every
    entry point resolves it, or ``"meta"`` for shapes and dtypes alone
    (:func:`param_specs`)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else \
            resolve_device(device)
        # Shapes first (on the meta device), then storage on `dev`: no
        # layer spends time or random numbers on an init that is
        # overwritten.
        meta = torch.device("meta")
        kw = dict(dtype=_dtype(cfg), device=meta)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab_size, cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.head = Embedding(cfg.padded_vocab_size, cfg.d_model, **kw)
        if cfg.block_pattern == "attn":
            self.layers = _layers(AttnLayer, cfg, cfg.num_layers, meta)
        elif cfg.block_pattern == "zamba":
            g, tail = _zamba_group_sizes(cfg)
            every = cfg.shared_attn_every or 6
            self.mamba_groups = nn.ModuleList(
                _layers(MambaLayer, cfg, every, meta) for _ in range(g))
            self.mamba_tail = _layers(MambaLayer, cfg, tail, meta)
            self.shared_attn = AttnLayer(cfg, device=meta)
        elif cfg.block_pattern == "xlstm":
            g, m_per, _ = _xlstm_group_sizes(cfg)
            self.mlstm = nn.ModuleList(
                _layers(MLSTMLayer, cfg, m_per, meta) for _ in range(g))
            self.slstm = _layers(SLSTMLayer, cfg, g, meta)
        else:
            raise ValueError(f"unknown block_pattern {cfg.block_pattern!r}")
        self.final_ln = RMSNorm(cfg.d_model, **kw)
        self.to_empty(device=dev)

    @property
    def device(self) -> torch.device:
        return self.final_ln.scale.device

    def output_head(self) -> Embedding:
        return self.embed if self.cfg.tie_embeddings else self.head


def param_specs(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The parameters by name as meta-device tensors of their shapes and
    dtypes: no storage is allocated."""
    return {n: p.detach() for n, p in
            LM(cfg, device="meta").named_parameters()}


#: Parameters that :func:`init_params` draws otherwise than the general
#: rule, by the end of their name: (std of a normal draw, or None for a
#: constant, that constant).  As the reference's ``mamba2_init``,
#: ``mlstm_init`` and ``slstm_init``.
_INIT = {
    ".table": (0.02, None),
    "mamba.conv": (0.1, None),
    "mamba.A_log": (None, 0.0),             # A = −exp(A_log) = −1
    "mamba.dt_bias": (None, 0.0),
    "mamba.D": (None, 1.0),
    ".f_bias": (None, 3.0),                 # forget gates start remembering
}


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> LM:
    """Random weights from ``generator`` (a generator of ``device``),
    distributed as the reference's ``init_params``: projections, routers,
    expert and recurrent weights normal / sqrt(fan_in), embedding tables
    normal × 0.02, Mamba2's conv normal × 0.1, its ``A_log`` and
    ``dt_bias`` 0 and ``D`` 1, the xLSTM forget biases 3, norm scales 1.
    The numbers differ from the reference's (``jax.random`` is another
    generator); ``convert.params_from_jax`` carries the reference's own
    weights."""
    model = LM(cfg, device=device)
    for name, p in model.named_parameters():
        rule = next((r for end, r in _INIT.items() if name.endswith(end)),
                    None)
        if rule is not None:
            std, const = rule
        elif name.endswith(".router"):      # (d_model, E)
            std, const = p.shape[0] ** -0.5, None
        elif p.dim() in (2, 3):   # (d_out, d_in); (E or H, d_in, d_out)
            std, const = p.shape[1] ** -0.5, None
        else:
            std, const = None, 1.0
        if std is None:
            p.fill_(const)
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32) * std)
    return model


# ======================================================================
# forward
# ======================================================================
def _layer(cfg: ModelConfig, layer: AttnLayer, x: torch.Tensor,
           positions: torch.Tensor, *, return_kv: bool = False):
    x = shardctx.constrain(x, ("batch", "seq", None))
    h = attention.attention_block(
        layer.attn, layer.ln1(x), positions, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        kv_repeat=cfg.kv_replication, return_kv=return_kv)
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


def _mamba(cfg: ModelConfig, layer: MambaLayer, x: torch.Tensor,
           cache: dict | None, keys: tuple[str, str], at: tuple):
    """One Mamba2 layer with its residual over the whole sequence; with a
    ``cache``, its final ssm and conv states land in ``cache[keys[0]][at]``
    and ``cache[keys[1]][at]``."""
    y, st, cv = ssm.mamba2_block(layer.mamba, layer.ln(x),
                                 d_model=cfg.d_model, n_state=cfg.ssm_state,
                                 return_conv_state=True)
    if cache is not None:
        cache[keys[0]][at] = st
        cache[keys[1]][at] = cv
    return x + y


def _blocks(cfg: ModelConfig, model: LM, x: torch.Tensor,
            positions: torch.Tensor, cache: dict | None = None, *,
            remat: bool = False):
    """Every block over x (B, S, D) → (x, the layers' summed MoE aux loss
    float32); with a ``cache`` (prefill), each attention block's k and v
    and each recurrent layer's final state are written into it.  With
    ``remat`` (training), the blocks the reference's ``_trunk``
    checkpoints run under ``torch.utils.checkpoint``."""
    s = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = cache is not None
    k_buf, v_buf = _kv_bufs(cfg, cache)

    def run(fn, *args):
        if remat:
            return shardctx.checkpoint(fn, *args)
        return fn(*args)

    def attn(layer, x, i, rematted):
        nonlocal aux
        if rematted and not kv:
            out = run(_layer, cfg, layer, x, positions)
        else:
            out = _layer(cfg, layer, x, positions, return_kv=kv)
        if out[1] is not None:
            aux = aux + out[1]
        if kv:
            k_buf[i, :, :s], v_buf[i, :, :s] = out[2]
        return out[0]

    if cfg.block_pattern == "attn":
        for i, layer in enumerate(model.layers):
            x = attn(layer, x, i, True)
    elif cfg.block_pattern == "zamba":
        for gi, group in enumerate(model.mamba_groups):
            for li, layer in enumerate(group):
                x = run(_mamba, cfg, layer, x, cache, ("ssm", "conv"),
                        (gi, li))
            x = attn(model.shared_attn, x, gi, False)
        for ti, layer in enumerate(model.mamba_tail):
            x = run(_mamba, cfg, layer, x, cache, ("ssm_tail", "conv_tail"),
                    ti)
    else:                                   # xlstm
        for gi, (group, slayer) in enumerate(zip(model.mlstm, model.slstm)):
            for li, layer in enumerate(group):
                if kv:
                    y, st = xlstm.mlstm_block(layer.mlstm, layer.ln(x),
                                              num_heads=cfg.num_heads)
                    cache["mlstm"][gi, li] = st
                    x = x + y
                else:
                    x = run(_mlstm, cfg, layer, x)
            y, carry = xlstm.slstm_block(slayer.slstm, slayer.ln(x),
                                         num_heads=cfg.num_heads)
            x = x + y
            if kv:
                for buf, val in zip(cache["slstm"], carry):
                    buf[gi] = val
    return x, aux


def _mlstm(cfg: ModelConfig, layer: MLSTMLayer, x: torch.Tensor
           ) -> torch.Tensor:
    """One mLSTM layer with its residual over the whole sequence."""
    return x + xlstm.mlstm_block(layer.mlstm, layer.ln(x),
                                 num_heads=cfg.num_heads)[0]


def _kv_bufs(cfg: ModelConfig, cache: dict | None):
    """The pattern's (k, v) cache buffers, or (None, None) without a
    cache or an attention block."""
    if cache is None or cfg.block_pattern == "xlstm":
        return None, None
    if cfg.block_pattern == "zamba":
        return cache["attn_k"], cache["attn_v"]
    return cache["k"], cache["v"]


def forward(cfg: ModelConfig, model: LM, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V) float32, the layers' summed MoE auxiliary loss,
    float32: 0 without experts).  ``batch["tokens"]`` (B, S) ints, or
    ``batch["embeddings"]`` (B, S, D) for ``input_mode="embeddings"``."""
    x = shardctx.constrain(_embed(cfg, model, _batch_inputs(cfg, batch)),
                           ("batch", "seq", None))
    b, s = x.shape[:2]
    x, aux = _blocks(cfg, model, x, _positions(b, s, x.device), remat=remat)
    return _logits(cfg, model, x), aux


def loss_fn(cfg: ModelConfig, model: LM, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Training loss with streamed (never materialised) logits: (ce +
    ``MOE_AUX_COEF`` · moe_aux, {"ce", "moe_aux"}), float32 scalars.
    ``batch`` as :func:`forward` takes it, plus ``batch["labels"]`` (B, S)
    ints."""
    x = shardctx.constrain(_embed(cfg, model, _batch_inputs(cfg, batch)),
                           ("batch", "seq", None))
    b, s = x.shape[:2]
    x, aux = _blocks(cfg, model, x, _positions(b, s, x.device), remat=remat)
    x = model.final_ln(x)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    ce = chunked_cross_entropy(model.output_head(), x, labels,
                               true_vocab=cfg.vocab_size)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "moe_aux": aux}


# ======================================================================
# prefill (serve) path: forward + cache construction
# ======================================================================
@torch.no_grad()
def prefill(cfg: ModelConfig, model: LM, batch: dict, max_len: int, *,
            last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model: (logits (B, S, V) float32, decode
    cache positioned after the prompt).  ``max_len`` sizes the KV buffers
    (recurrent states are position-free); ``last_only`` keeps only the
    final position's logits (B, 1, V).  ``batch`` as :func:`forward`
    takes it."""
    x = shardctx.constrain(_embed(cfg, model, _batch_inputs(cfg, batch)),
                           ("batch", "seq", None))
    b, s = x.shape[:2]
    if max_len < s:
        raise ValueError(f"max_len={max_len} below the prompt length {s}")
    cache = init_cache(cfg, b, max_len, device=x.device)
    x, _ = _blocks(cfg, model, x, _positions(b, s, x.device), cache)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, model, x), cache


# ======================================================================
# decode (serve) path
# ======================================================================
def _stacked(x: torch.Tensor, *lead: int) -> torch.Tensor:
    """``x`` repeated over leading axes ``lead``, as a tensor of its own."""
    return x.expand(*lead, *x.shape).contiguous()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """The reference's decode cache for the block pattern, zeroed (the
    sLSTM stabiliser m at −1e30): ``attn`` k and v (L, B, max_len, KVH,
    hd); ``zamba`` ssm (g, every, B, H, N, 64) float32, conv (g, every, B,
    3, d_inner), attn_k and attn_v (g, B, max_len, KVH, hd), and
    ssm_tail, conv_tail over the tail layers; ``xlstm`` mlstm (g, k − 1,
    B, H, Dh, Dh + 1) float32 and slstm, the tuple (h, c, n, m) of (g, B,
    H, Dh) float32.  ``device="meta"`` gives the shapes and dtypes
    alone."""
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    if cfg.block_pattern == "attn":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.block_pattern == "zamba":
        g, tail = _zamba_group_sizes(cfg)
        every = cfg.shared_attn_every or 6
        s0, c0 = ssm.mamba2_init_state(batch, cfg.d_model, cfg.ssm_state, dt,
                                       device=dev)
        kv = (g, batch, max_len, cfg.num_kv_heads, hd)
        cache = {"ssm": _stacked(s0, g, every),
                 "conv": _stacked(c0, g, every),
                 "attn_k": torch.zeros(kv, dtype=dt, device=dev),
                 "attn_v": torch.zeros(kv, dtype=dt, device=dev)}
        if tail:
            cache["ssm_tail"] = _stacked(s0, tail)
            cache["conv_tail"] = _stacked(c0, tail)
        return cache
    g, m_per, _ = _xlstm_group_sizes(cfg)
    m0 = xlstm.mlstm_init_state(batch, cfg.d_model, cfg.num_heads,
                                device=dev)
    return {"mlstm": _stacked(m0, g, m_per),
            "slstm": tuple(_stacked(x, g) for x in xlstm.slstm_init_state(
                batch, cfg.d_model, cfg.num_heads, device=dev))}


def _attn_decode(cfg: ModelConfig, layer: AttnLayer, x: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, pos: int) -> torch.Tensor:
    h, _ = attention.attention_decode(
        layer.attn, layer.ln1(x), {"k": k, "v": v}, pos,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm)
    x = x + h * cfg.residual_scale
    return x + _ffn(cfg, layer, x)[0] * cfg.residual_scale


def _mamba_decode(cfg: ModelConfig, layer: MambaLayer, x: torch.Tensor,
                  cache: dict, keys: tuple[str, str], at) -> torch.Tensor:
    y, st, cv = ssm.mamba2_decode(layer.mamba, layer.ln(x),
                                  cache[keys[0]][at], cache[keys[1]][at],
                                  d_model=cfg.d_model, n_state=cfg.ssm_state)
    cache[keys[0]][at] = st
    cache[keys[1]][at] = cv
    return x + y


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: LM, cache: dict, inputs,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One-token decode.  ``inputs`` (B,) tokens, or (B, D) embeddings
    for ``input_mode="embeddings"``; ``pos`` the position the new KV is
    written at (recurrent states are position-free).  Returns (logits (B,
    V) float32, the cache), which is updated in place."""
    pos = int(pos)
    k_buf, v_buf = _kv_bufs(cfg, cache)
    if k_buf is not None and not 0 <= pos < k_buf.shape[2]:
        raise ValueError(f"pos={pos} outside the cache's "
                         f"{k_buf.shape[2]} positions")
    x = _embed(cfg, model, inputs)[:, None]
    if cfg.block_pattern == "attn":
        for i, layer in enumerate(model.layers):
            x = _attn_decode(cfg, layer, x, k_buf[i], v_buf[i], pos)
    elif cfg.block_pattern == "zamba":
        for gi, group in enumerate(model.mamba_groups):
            for li, layer in enumerate(group):
                x = _mamba_decode(cfg, layer, x, cache, ("ssm", "conv"),
                                  (gi, li))
            x = _attn_decode(cfg, model.shared_attn, x, k_buf[gi],
                             v_buf[gi], pos)
        for ti, layer in enumerate(model.mamba_tail):
            x = _mamba_decode(cfg, layer, x, cache,
                              ("ssm_tail", "conv_tail"), ti)
    else:                                   # xlstm
        for gi, (group, slayer) in enumerate(zip(model.mlstm, model.slstm)):
            for li, layer in enumerate(group):
                y, st = xlstm.mlstm_decode(layer.mlstm, layer.ln(x),
                                           cache["mlstm"][gi, li],
                                           num_heads=cfg.num_heads)
                cache["mlstm"][gi, li] = st
                x = x + y
            y, carry = xlstm.slstm_decode(
                slayer.slstm, slayer.ln(x),
                tuple(buf[gi] for buf in cache["slstm"]),
                num_heads=cfg.num_heads)
            for buf, val in zip(cache["slstm"], carry):
                buf[gi] = val
            x = x + y
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


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The reference's count: norm scales (and the xLSTM forget biases)
    left out."""
    d = cfg.d_model
    n = cfg.padded_vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.block_pattern == "attn":
        n += cfg.num_layers * _attn_layer_params(cfg, active_only)
    elif cfg.block_pattern == "xlstm":
        g, m_per, _ = _xlstm_group_sizes(cfg)
        dh = d // cfg.num_heads
        mlstm = 5 * d * d + 2 * cfg.num_heads * d
        slstm = 4 * d * d + cfg.num_heads * dh * 4 * dh + d * d
        n += g * (m_per * mlstm + slstm)
    elif cfg.block_pattern == "zamba":
        g, tail = _zamba_group_sizes(cfg)
        every = cfg.shared_attn_every or 6
        n += (g * every + tail) * ssm.mamba2_param_count(d, cfg.ssm_state)
        n += _attn_layer_params(cfg, active_only)   # shared: counted once
    return n


__all__ = ["LM", "MOE_AUX_COEF", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "param_count", "param_specs", "prefill"]
