"""Gradient compression with error feedback (the reference's
``repro/train/compress.py``): the codecs of a data-parallel all-reduce.

Quantizing a gradient biases the update; error feedback keeps a residual
``e`` per leaf so that the quantization error re-enters the next step::

    u   = g + e
    q   = quantize(u)
    e'  = u − dequantize(q)

Two codecs: ``bf16`` (2 bytes, no scale) and ``int8`` (1 byte and a
float32 scale per leaf), with the reference's arithmetic.
:func:`make_compressed_allreduce` runs them over the data-parallel axes
of a device mesh, as the reference's ``shard_map`` psum does: each rank
compresses its own slice, and the dequantized payloads are summed by
``all_reduce`` over the axes' process groups.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.launch.mesh import axis_sizes


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


def make_compressed_allreduce(mesh, axes: Sequence[str],
                              codec: str = "bf16"):
    """``(grads, err) -> (mean, err')`` over the ``axes`` of ``mesh`` (a
    ``DeviceMesh``), for dicts of tensors.

    As the reference's: each leaf is a DTensor with a leading "shard"
    dimension of size ∏ |axes| — shard k's gradient and residual —
    sharded over ``axes``, so each rank holds its (1, ...) slice.  The
    mean over the shards comes back replicated, without the leading dim;
    the new residuals keep it, laid out as ``err``'s."""
    axes = tuple(axes)
    sizes = axis_sizes(mesh)
    nshards = 1
    for a in axes:
        nshards *= sizes[a]

    def one(g: DTensor, e: DTensor):
        q, scale, e_new = compress_leaf(g.to_local()[0], e.to_local()[0],
                                        codec)
        total = _dequantize(q, scale, codec)
        for a in axes:
            dist.all_reduce(total, group=mesh.get_group(a))
        mean = DTensor.from_local(total / nshards, mesh,
                                  [Replicate()] * mesh.ndim,
                                  run_check=False)
        return mean, DTensor.from_local(e_new[None], mesh, e.placements,
                                        run_check=False)

    def allreduce(grads: dict, err: dict) -> tuple[dict, dict]:
        out = {n: one(g, err[n]) for n, g in grads.items()}
        return ({n: o[0] for n, o in out.items()},
                {n: o[1] for n, o in out.items()})
    return allreduce


__all__ = ["compress_leaf", "init_error_state", "make_compressed_allreduce"]
