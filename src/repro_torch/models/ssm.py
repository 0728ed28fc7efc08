"""State-space / linear-RNN sequence mixing (the reference's
``repro/models/ssm.py``): the chunked gated linear recurrence and Mamba2.

:func:`chunked_linear_rnn` runs any recurrence of the form::

    state_t = a_t · state_{t-1} + scale_t · (k_t ⊗ v_t)       # (Dk, Dv)
    y_t     = q_tᵀ · state_t

with a scalar decay ``a_t ∈ (0, 1]`` per (token, head).  Mamba2 (a =
exp(Δ·A), scale = Δ, q = C, k = B, v = x) and the xLSTM mLSTM cell
(``models.xlstm``) are both instances.  Within a chunk of L tokens the
recurrence is a dense L×L masked product; across chunks a short loop
carries the state, so memory grows as S·L, never S².  The reference runs
one chunk per step of a ``lax.scan``; here the intra-chunk products of
all chunks run as one batched product each, and only the state's carry
(two operations a chunk) is a Python loop.  Every product is the
reference's, in float32, with sums in another order.

All math in float32; outputs in the inputs' dtype.  Nothing here reads a
value on the host: padding and the chunk count come from shapes.  The
products are plain PyTorch (``torch.einsum``), as the reference leaves
them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import shardctx
from repro_torch.models.layers import linear

#: Mamba2's head width and causal-conv width.
MAMBA_HEADDIM = 64
MAMBA_CONV = 4


def chunked_linear_rnn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_a: torch.Tensor, scale: torch.Tensor, *,
                       chunk: int = 128,
                       init_state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the gated linear recurrence over a whole sequence.

    q, k (B, S, H, Dk); v (B, S, H, Dv); log_a (B, S, H), the log decay
    per token and head (≤ 0); scale (B, S, H); ``init_state`` an optional
    (B, H, Dk, Dv) starting state.  Returns (y (B, S, H, Dv) in q's dtype,
    the final state (B, H, Dk, Dv) float32).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    orig_dtype = q.dtype
    nc = -(-s // chunk)
    pad = nc * chunk - s
    f32 = torch.float32

    def chunks(x):
        # (B, S, H, ...) → float32 (B, nc, L, H, ...), zero past S.
        x = x.to(f32)
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        return x.reshape(b, nc, chunk, *x.shape[2:])

    qc, kc, vc, la, sc = map(chunks, (q, k, v, log_a, scale))
    if init_state is None:
        state = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
    else:
        state = init_state.to(f32)

    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]   # (L, L, 1): i ≥ j
    cum = la.cumsum(dim=2)                                     # (B, nc, L, H)
    # Intra-chunk: the decay from j to i is exp(cum_i − cum_j).  Above
    # the diagonal it overflows to inf, so it is masked by selection
    # (inf · 0 would be NaN).
    ddiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, L, L, H)
    decay = torch.where(causal, torch.exp(ddiff), 0.0)
    del ddiff
    scores = torch.einsum("bcihd,bcjhd->bcijh", qc, kc)
    m = scores * decay * sc[:, :, None]
    del scores, decay
    y_intra = torch.einsum("bcijh,bcjhv->bcihv", m, vc)
    del m
    # Each chunk's own contribution to the state it hands on, and the
    # decay of the state it received.
    w = torch.exp(cum[:, :, -1:] - cum) * sc                   # (B, nc, L, H)
    s_chunk = torch.einsum("bcjh,bcjhd,bcjhv->bchdv", w, kc, vc)
    tot = torch.exp(cum[:, :, -1])                             # (B, nc, H)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * tot[:, c, :, None, None] + s_chunk[:, c]
    # Inter-chunk: the carried state's contribution.
    y_inter = torch.einsum("bcihd,bchdv->bcihv",
                           qc * torch.exp(cum)[..., None],
                           torch.stack(starts, dim=1))
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, dv)[:, :s]
    return y.to(orig_dtype), state


def linear_rnn_decode(q, k, v, log_a, scale, state):
    """One token of the recurrence: q, k (B, H, Dk), v (B, H, Dv), log_a
    and scale (B, H), state (B, H, Dk, Dv) float32.  Returns (y (B, H, Dv)
    in q's dtype, the new state)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    kv = torch.einsum("bhd,bhv->bhdv", k.to(f32), v.to(f32))
    state_new = state * a + kv * scale.to(f32)[..., None, None]
    y = torch.einsum("bhd,bhdv->bhv", q.to(f32), state_new)
    return y.to(q.dtype), state_new


def reference_linear_rnn(q, k, v, log_a, scale, init_state=None):
    """Step-by-step oracle of :func:`chunked_linear_rnn` (tests)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32,
                         device=q.device)
             if init_state is None else init_state.to(torch.float32))
    ys = []
    for t in range(s):
        y, state = linear_rnn_decode(
            q[:, t].float(), k[:, t].float(), v[:, t].float(), log_a[:, t],
            scale[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1).to(q.dtype), state


# ----------------------------------------------------------------------
# Mamba2 block
# ----------------------------------------------------------------------
class Mamba2(nn.Module):
    """in_proj (2·d_inner + 2·N + H, D) → [x, z, B, C, dt]; conv (K,
    d_inner), depthwise; ``A_log``, ``D`` and ``dt_bias`` (H,) float32
    whatever the model dtype, as the reference keeps them; norm_scale
    (d_inner,); out_proj (D, d_inner).  d_inner = 2·D, H = d_inner / 64."""

    def __init__(self, d_model: int, ssm_state: int, *, dtype, device):
        super().__init__()
        d_inner = 2 * d_model
        h = d_inner // MAMBA_HEADDIM
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = linear(d_model, 2 * d_inner + 2 * ssm_state + h, **kw)
        self.conv = nn.Parameter(torch.empty(MAMBA_CONV, d_inner, **kw))
        self.A_log = nn.Parameter(torch.empty(h, **f32))
        self.D = nn.Parameter(torch.empty(h, **f32))
        self.dt_bias = nn.Parameter(torch.empty(h, **f32))
        self.norm_scale = nn.Parameter(torch.empty(d_inner, **kw))
        self.out_proj = linear(d_inner, d_model, **kw)


class _SiLU(torch.autograd.Function):
    """The forward's stepwise arithmetic with ``jax.nn.silu``'s gradient,
    g·s + (g·x)·s·(1 − s) for s = logistic(x), in x's dtype.  Autograd
    through the forward's own steps would multiply 0 by exp(−x) = inf
    below x ≈ −88 and return NaN where the reference returns 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = 1 / (1 + torch.exp(-x))
        return g * s + g * x * s * (1 - s)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1 / (1 + exp(−x))`` with every operation in x's dtype, as
    the reference's ``jax.nn.silu`` (``x · logistic(x)``) evaluates it:
    in bf16 each of the four steps rounds.  ``F.silu`` rounds once, which
    moves a Mamba2 output by a bf16 step per layer."""
    return _SiLU.apply(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time: x (B, S, C), w (K, C).  The
    reference's sum of K shifted products, in x's dtype and in its order.
    Returns (y, the trailing K − 1 inputs: the next call's state)."""
    kk = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], kk - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(kk))
    return y, xp[:, -(kk - 1):]


def _mamba2_inner(params: Mamba2, xin, ssm_state, conv_state, *, d_model,
                  n_state, chunk, decode):
    d_inner = 2 * d_model
    h = d_inner // MAMBA_HEADDIM
    proj = params.in_proj(xin)
    x, z, bmat, cmat, dt = torch.split(
        proj, [d_inner, d_inner, n_state, n_state, h], dim=-1)
    x = shardctx.constrain(x, ("batch",) + (None,) * (x.ndim - 2) + ("ffn",))
    x, conv_state = _causal_conv(x, params.conv, conv_state)
    x = silu(x)
    b_, s_ = x.shape[:2]
    xh = x.reshape(b_, s_, h, MAMBA_HEADDIM)
    if not decode:
        xh = shardctx.constrain(xh, ("batch", "seq", "state", None))
    dt = F.softplus(dt.float() + params.dt_bias)               # (B, S, H)
    a = -torch.exp(params.A_log)                               # (H,) negative
    log_a = dt * a
    # B and C shared across heads (a single group).
    k = bmat[:, :, None, :].expand(b_, s_, h, n_state)
    q = cmat[:, :, None, :].expand(b_, s_, h, n_state)
    if decode:
        y, ssm_state = linear_rnn_decode(
            q[:, 0], k[:, 0], xh[:, 0], log_a[:, 0], dt[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, ssm_state = chunked_linear_rnn(q, k, xh, log_a, dt, chunk=chunk,
                                          init_state=ssm_state)
    y = y + xh * params.D[None, None, :, None]                 # float32
    y = y.reshape(b_, s_, d_inner)
    y = shardctx.constrain(y, ("batch",) + (None,) * (y.ndim - 2) + ("ffn",))
    # Gated RMSNorm (Mamba2's norm before out_proj), in float32.
    y = y * silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-6)
         * params.norm_scale.float()).to(xin.dtype)
    return params.out_proj(y), ssm_state, conv_state


def mamba2_block(params: Mamba2, x: torch.Tensor, *, d_model: int,
                 n_state: int, chunk: int = 128,
                 ssm_state: torch.Tensor | None = None,
                 return_conv_state: bool = False):
    """Full-sequence Mamba2 mixing: x (B, S, D) → (y, final ssm state[,
    final conv state])."""
    y, ssm_state, conv_state = _mamba2_inner(
        params, x, ssm_state, None, d_model=d_model, n_state=n_state,
        chunk=chunk, decode=False)
    if return_conv_state:
        return y, ssm_state, conv_state
    return y, ssm_state


def mamba2_decode(params: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, *, d_model: int, n_state: int):
    """One token: x (B, 1, D), states as :func:`mamba2_init_state` makes
    them.  Returns (y, ssm state, conv state)."""
    return _mamba2_inner(params, x, ssm_state, conv_state, d_model=d_model,
                         n_state=n_state, chunk=1, decode=True)


def mamba2_init_state(batch: int, d_model: int, n_state: int, dtype, *,
                      device):
    """Zero states: ssm (B, H, N, 64) float32, conv (B, K − 1, d_inner)."""
    d_inner = 2 * d_model
    h = d_inner // MAMBA_HEADDIM
    return (torch.zeros((batch, h, n_state, MAMBA_HEADDIM),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, MAMBA_CONV - 1, d_inner), dtype=dtype,
                        device=device))


def mamba2_param_count(d_model: int, ssm_state: int) -> int:
    d_inner = 2 * d_model
    h = d_inner // MAMBA_HEADDIM
    return (d_model * (2 * d_inner + 2 * ssm_state + h)
            + MAMBA_CONV * d_inner + 3 * h + d_inner + d_inner * d_model)


__all__ = ["MAMBA_CONV", "MAMBA_HEADDIM", "Mamba2", "chunked_linear_rnn",
           "linear_rnn_decode", "mamba2_block", "mamba2_decode",
           "mamba2_init_state", "mamba2_param_count", "reference_linear_rnn",
           "silu"]
