"""Gradient compression with error feedback (the reference's
``repro/train/compress.py``): the codecs of a data-parallel all-reduce.

Quantizing a gradient biases the update; error feedback keeps a residual
``e`` per leaf so that the quantization error re-enters the next step::

    u   = g + e
    q   = quantize(u)
    e'  = u − dequantize(q)

Two codecs: ``bf16`` (2 bytes, no scale) and ``int8`` (1 byte and a
float32 scale per leaf), with the reference's arithmetic.  The
reference's ``make_compressed_allreduce`` wraps them in a ``shard_map``
psum over a device mesh; it comes with the port's mesh (ROADMAP A.13 item
6, ``launch/mesh.py``).
"""
from __future__ import annotations

import torch


def init_error_state(grads: dict) -> dict:
    """A float32 zero residual per leaf of ``grads`` (a dict of
    tensors)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def _quantize(u: torch.Tensor, codec: str):
    if codec == "bf16":
        return u.to(torch.bfloat16), None
    if codec == "int8":
        scale = torch.clamp(torch.max(torch.abs(u)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(u / scale), -127, 127).to(torch.int8)
        return q, scale
    raise ValueError(codec)


def _dequantize(q: torch.Tensor, scale, codec: str) -> torch.Tensor:
    if codec == "bf16":
        return q.to(torch.float32)
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, e: torch.Tensor, codec: str):
    """→ (payload, its scale or None, the new residual)."""
    u = g.to(torch.float32) + e
    q, scale = _quantize(u, codec)
    return q, scale, u - _dequantize(q, scale, codec)


__all__ = ["compress_leaf", "init_error_state"]
