"""xLSTM blocks (the reference's ``repro/models/xlstm.py``): mLSTM (matrix
memory) and sLSTM (scalar memory).

mLSTM is a gated linear recurrence over an outer-product memory::

    C_t = f_t · C_{t−1} + i_t · (k_t ⊗ v_t)        # (Dh, Dh) per head
    n_t = f_t · n_{t−1} + i_t · k_t                # normaliser
    y_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, 1)

which is :func:`models.ssm.chunked_linear_rnn`'s recurrence with a scalar
decay per head; the normaliser rides along as one extra value channel.
The gates are sigmoids, as in the reference (its note: the paper's
exponential input gate with a running max is replaced there).

sLSTM has a nonlinear recurrence (the per-head recurrent weights R act on
h_{t−1}), so it runs step by step: a Python loop over time, in float32,
with the paper's exponential gating and its m_t stabiliser (starting at
−1e30).  Nothing here reads a value on the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import shardctx
from repro_torch.models.layers import groupnorm, linear
from repro_torch.models.ssm import chunked_linear_rnn, linear_rnn_decode, silu


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------
class MLSTM(nn.Module):
    """wq, wk, wv, wgate, wo (D, D); wif (2H, D) float32 (input and forget
    gate pre-activations, computed in float32); f_bias (H,) float32."""

    def __init__(self, d_model: int, num_heads: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        for name in ("wq", "wk", "wv", "wgate", "wo"):
            setattr(self, name, linear(d_model, d_model, **kw))
        self.wif = linear(d_model, 2 * num_heads, dtype=torch.float32,
                          device=device)
        self.f_bias = nn.Parameter(torch.empty(num_heads, dtype=torch.float32,
                                               device=device))


def _qk_scale(dh: int, dtype) -> float:
    """sqrt(dh) rounded to float32 and then to the model dtype, as the
    reference divides q by it."""
    return float(torch.tensor(float(np.float32(np.sqrt(dh)))).to(dtype))


def _mlstm_qkvif(params: MLSTM, x: torch.Tensor, num_heads: int):
    b, s, d = x.shape
    dh = d // num_heads
    q = params.wq(x).reshape(b, s, num_heads, dh) / _qk_scale(dh, x.dtype)
    k = params.wk(x).reshape(b, s, num_heads, dh)
    v = params.wv(x).reshape(b, s, num_heads, dh)
    # few heads (4): the key/query feature dim shards over "model" instead
    q = shardctx.constrain(q, ("batch", "seq", None, "state"))
    k = shardctx.constrain(k, ("batch", "seq", None, "state"))
    gif = params.wif(x.float())                                # (B, S, 2H)
    i_raw, f_raw = gif.chunk(2, dim=-1)
    log_a = F.logsigmoid(f_raw + params.f_bias)                # (B, S, H)
    scale = torch.sigmoid(i_raw)
    return q, k, v, log_a, scale


def _mlstm_out(params: MLSTM, x, y_aug, num_heads: int):
    """The normalised read-out, group norm, output gate and projection."""
    b, s, d = x.shape
    dh = d // num_heads
    y, n = y_aug[..., :dh], y_aug[..., dh:]
    y = y / n.abs().clamp_min(1.0)
    y = groupnorm(y.reshape(b, s, d), num_heads)
    # The gate's product stays float32 through the SiLU, then rounds.
    gate = silu(F.linear(x.float(), params.wgate.weight.float())).to(
        x.dtype)
    return params.wo(y * gate)


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    """v with a channel of ones appended: the normaliser's value."""
    return torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)


def mlstm_block(params: MLSTM, x: torch.Tensor, *, num_heads: int,
                chunk: int = 128, state: torch.Tensor | None = None):
    """x (B, S, D) → (y (B, S, D), final state (B, H, Dh, Dh + 1))."""
    q, k, v, log_a, scale = _mlstm_qkvif(params, x, num_heads)
    y_aug, state = chunked_linear_rnn(q, k, _with_ones(v), log_a, scale,
                                      chunk=chunk, init_state=state)
    return _mlstm_out(params, x, y_aug, num_heads), state


def mlstm_decode(params: MLSTM, x: torch.Tensor, state: torch.Tensor, *,
                 num_heads: int):
    """One token: x (B, 1, D), state (B, H, Dh, Dh + 1)."""
    q, k, v, log_a, scale = _mlstm_qkvif(params, x, num_heads)
    y_aug, state = linear_rnn_decode(q[:, 0], k[:, 0], _with_ones(v)[:, 0],
                                     log_a[:, 0], scale[:, 0], state)
    return _mlstm_out(params, x, y_aug[:, None], num_heads), state


def mlstm_init_state(batch: int, d_model: int, num_heads: int, *, device):
    dh = d_model // num_heads
    return torch.zeros((batch, num_heads, dh, dh + 1), dtype=torch.float32,
                       device=device)


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------
class SLSTM(nn.Module):
    """w (4D, D), the input pre-activations (computed in float32); r (H,
    Dh, 4Dh) float32, block-diagonal recurrent weights; wo (D, D); f_bias
    (H, Dh) float32."""

    def __init__(self, d_model: int, num_heads: int, *, dtype, device):
        super().__init__()
        dh = d_model // num_heads
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.w = linear(d_model, 4 * d_model, **kw)
        self.r = nn.Parameter(torch.empty(num_heads, dh, 4 * dh, **f32))
        self.wo = linear(d_model, d_model, **kw)
        self.f_bias = nn.Parameter(torch.empty(num_heads, dh, **f32))


def slstm_cell(params: SLSTM, xw_t: torch.Tensor, carry, num_heads: int):
    """One time step: xw_t (B, 4D) float32 input pre-activations, carry
    (h, c, n, m), each (B, H, Dh) float32."""
    h, c, n, m = carry
    b, _, dh = h.shape
    rec = torch.einsum("bhd,hde->bhe", h, params.r)            # (B, H, 4Dh)
    pre = xw_t.reshape(b, num_heads, 4 * dh) + rec
    z_r, i_r, f_r, o_r = pre.chunk(4, dim=-1)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    log_f = F.logsigmoid(f_r + params.f_bias)
    log_i = i_r
    m_new = torch.maximum(log_f + m, log_i)                    # stabiliser
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / n_new.abs().clamp_min(1.0)
    return (h_new, c_new, n_new, m_new)


def _slstm_out(params: SLSTM, hs: torch.Tensor, x: torch.Tensor,
               num_heads: int):
    b, s, d = x.shape
    y = hs.reshape(b, s, d).to(x.dtype)
    return params.wo(groupnorm(y, num_heads))


def slstm_block(params: SLSTM, x: torch.Tensor, *, num_heads: int,
                carry=None):
    """x (B, S, D) → (y, final carry), one step at a time."""
    b, s, d = x.shape
    xw = F.linear(x.float(), params.w.weight.float())          # (B, S, 4D)
    if carry is None:
        carry = slstm_init_state(b, d, num_heads, device=x.device)
    hs = []
    for t in range(s):
        carry = slstm_cell(params, xw[:, t], carry, num_heads)
        hs.append(carry[0])
    return _slstm_out(params, torch.stack(hs, dim=1), x, num_heads), carry


def slstm_decode(params: SLSTM, x: torch.Tensor, carry, *, num_heads: int):
    """One token: x (B, 1, D), carry as :func:`slstm_init_state`."""
    xw = F.linear(x.float(), params.w.weight.float())[:, 0]
    carry = slstm_cell(params, xw, carry, num_heads)
    return _slstm_out(params, carry[0][:, None], x, num_heads), carry


def slstm_init_state(batch: int, d_model: int, num_heads: int, *, device):
    """(h, c, n, m), each (B, H, Dh) float32: zeros, and m at −1e30."""
    dh = d_model // num_heads
    z = torch.zeros((batch, num_heads, dh), dtype=torch.float32,
                    device=device)
    return (z, z.clone(), z.clone(), torch.full_like(z, -1e30))


__all__ = ["MLSTM", "SLSTM", "mlstm_block", "mlstm_decode",
           "mlstm_init_state", "slstm_block", "slstm_cell", "slstm_decode",
           "slstm_init_state"]
