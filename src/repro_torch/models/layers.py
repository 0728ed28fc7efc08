"""Shared building blocks of the LM (the reference's
``repro/models/layers.py``), as ``nn.Module``s and functions on tensors.

Numerics follow the reference: norms and RoPE compute in float32 and cast
back; every projection multiplies in the model dtype with float32
accumulation (``torch.matmul`` on bf16 accumulates in float32 and rounds
once, as the reference's ``preferred_element_type=float32`` followed by a
cast); logits come out in float32.  Training's losses
(``cross_entropy``, ``chunked_cross_entropy``) are not ported here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

MLP_TYPES = ("swiglu", "gelu", "relu2")


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps)
        return (out * self.scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  The head splits into
    two halves (not interleaved pairs), rotated in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def linear(d_in: int, d_out: int, *, dtype, device) -> nn.Linear:
    """A bias-free projection; its weight is (d_out, d_in), the transpose
    of the reference's (d_in, d_out) ``w``."""
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype, device=device)


class MLP(nn.Module):
    """``swiglu``: down(silu(gate x) · up x); ``gelu`` (tanh approximation,
    ``jax.nn.gelu``'s default) and ``relu2`` (squared ReLU): down(f(up x))."""

    def __init__(self, d_model: int, d_ff: int, mlp_type: str, *, dtype,
                 device):
        super().__init__()
        if mlp_type not in MLP_TYPES:
            raise ValueError(f"unknown mlp_type {mlp_type}")
        self.mlp_type = mlp_type
        kw = dict(dtype=dtype, device=device)
        if mlp_type == "swiglu":
            self.gate = linear(d_model, d_ff, **kw)
        self.up = linear(d_model, d_ff, **kw)
        self.down = linear(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_type == "swiglu":
            h = F.silu(self.gate(x)) * self.up(x)
        elif self.mlp_type == "relu2":
            h = torch.square(F.relu(self.up(x)))
        else:
            h = F.gelu(self.up(x), approximate="tanh")
        return self.down(h)


def mlp_param_count(d_model: int, d_ff: int, mlp_type: str) -> int:
    return d_model * d_ff * (3 if mlp_type == "swiglu" else 2)


class Embedding(nn.Module):
    """The (padded vocab, d_model) token table; also the output head (the
    table is tied to it, or a second ``Embedding`` is)."""

    def __init__(self, vocab: int, d_model: int, *, dtype, device):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, dtype=dtype,
                                              device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.table)

    def unembed(self, x: torch.Tensor,
                true_vocab: int | None = None) -> torch.Tensor:
        """Float32 logits (..., V_padded), float32 accumulation of the
        model-dtype product; pad columns set to −1e30 when ``true_vocab``
        is given, so argmax and sampling never pick them."""
        logits = torch.matmul(x.float(), self.table.float().T)
        vp = self.table.shape[0]
        if true_vocab is not None and true_vocab < vp:
            logits[..., true_vocab:] = -1e30
        return logits


__all__ = ["MLP", "MLP_TYPES", "Embedding", "RMSNorm", "apply_rope",
           "linear", "mlp_param_count", "rope_frequencies"]
