"""Sharding rules (the reference's ``repro/launch/sharding.py``):
parameters, optimizer state, inputs, decode caches.

Parameter rule (FSDP + TP, uniform across architectures), as the
reference states it:

* leading *stack* dimensions (layers / groups) are never sharded;
* of the remaining dims, the largest is sharded over ``model`` (tensor /
  expert parallelism) and, with ``fsdp``, the second largest over
  ``data`` — both only if the dim divides by and is at least the axis
  size;
* embedding and head tables are vocab-parallel over ``model``; MoE expert
  weights (E, ·, ·) expert-parallel over ``model``;
* 1-D parameters are replicated, and nothing is sharded over ``pod``.

Batch rule: the batch dim over ("pod", "data") when it divides.  Decode
caches: the KV time dim over ``model``, recurrent-state head dims over
``model``; at batch 1, the KV time dim over every axis.

Every rule returns the reference's ``PartitionSpec`` as a plain tuple,
one entry per tensor dim: None, an axis name, or a tuple of two or more
axis names (a one-axis tuple becomes the name, as ``PartitionSpec``
normalises it).
:func:`to_placements` turns such a tuple into DTensor placements over a
``DeviceMesh``, and :func:`place` puts tensors and a model's parameters
there.

The port's layout is not the reference's: the reference holds each stack
of layers as one array with leading stack dims, and dense weights as
(d_in, d_out); the port holds one entry per layer, and ``nn.Linear``'s
(d_out, d_in).  So :func:`param_spec` evaluates the reference's rule
(:func:`reference_param_spec`) on the reference's path and shape of a
port parameter, then maps the result back: the stack dims dropped, the
two dims of a transposed weight swapped.  The path, stack dims and
transposition come from ``models.convert.reference_location``, the table
that also carries the reference's weights across, so the two cannot
drift.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import (axis_names, axis_sizes, data_axes,
                                     to_placements)
from repro_torch.models import convert

#: Reference pytree path prefixes → number of leading stacked dims.
_STACK_DIMS = {"layers": 1, "mlstm": 2, "slstm": 1,
               "mamba_groups": 2, "mamba_tail": 1}


def reference_param_spec(path, shape: tuple[int, ...], mesh, *,
                         fsdp: bool = False) -> tuple:
    """The reference's ``param_spec`` on a reference parameter path (a
    sequence of key names) and its stacked shape.

    ``fsdp=False`` (live parameters): TP over ``model`` only.
    ``fsdp=True`` (optimizer master/m/v, the gradient accumulator):
    additionally over ``data`` (ZeRO-2)."""
    names = [str(n) for n in path]
    stack = 0
    for n in names:
        if n in _STACK_DIMS:
            stack = _STACK_DIMS[n]
            break
    sizes = axis_sizes(mesh)
    body = shape[stack:]
    spec: list = [None] * len(shape)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    if any(n in ("embed", "head") for n in names) and len(body) == 2:
        spec[stack + 0] = "model" if body[0] % model_n == 0 else None
        if fsdp and body[1] % data_n == 0 and data_n > 1:
            spec[stack + 1] = "data"
        return tuple(spec)
    if "moe" in names and len(body) == 3:
        spec[stack + 0] = "model" if body[0] % model_n == 0 else None
        if fsdp:
            rest = [stack + 1, stack + 2]
            for dim_i in sorted(rest, key=lambda i: -shape[i]):
                if shape[dim_i] % data_n == 0 and data_n > 1:
                    spec[dim_i] = "data"
                    break
        return tuple(spec)
    if len(body) >= 2:
        order = [int(i) for i in np.argsort(body)[::-1]]   # largest first
        model_dim = next((i for i in order
                          if model_n > 1 and body[i] % model_n == 0
                          and body[i] >= model_n), None)
        if model_dim is not None:
            spec[stack + model_dim] = "model"
        if fsdp:
            data_dim = next((i for i in order
                             if i != model_dim and data_n > 1
                             and body[i] % data_n == 0 and body[i] >= data_n),
                            None)
            if data_dim is not None:
                spec[stack + data_dim] = "data"
    return tuple(spec)


def param_spec(name: str, shape, mesh, *, fsdp: bool = False) -> tuple:
    """The spec of the port's parameter ``name`` of shape ``shape``: the
    reference's rule on the reference's path and shape, mapped onto the
    port's layout."""
    path, lead, transposed = convert.reference_location(name)
    body = tuple(shape)[::-1] if transposed else tuple(shape)
    stack = next((_STACK_DIMS[n] for n in path if n in _STACK_DIMS), 0)
    if stack != lead:
        raise ValueError(f"{name}: the rule stacks {stack} dims of "
                         f"{'/'.join(path)}, the conversion {lead}")
    spec = reference_param_spec(path, (1,) * lead + body, mesh,
                                fsdp=fsdp)[lead:]
    return spec[::-1] if transposed else spec


def _shape(x) -> tuple[int, ...]:
    return tuple(x.shape)


def param_shardings(cfg: ModelConfig, mesh, specs, *,
                    fsdp: bool = False) -> dict[str, tuple]:
    """``{name: spec}`` for a dict of parameters by name (tensors or
    meta tensors, e.g. ``transformer.param_specs(cfg)``)."""
    return {n: param_spec(n, _shape(p), mesh, fsdp=fsdp)
            for n, p in specs.items()}


def grad_specs(cfg: ModelConfig, mesh, param_spec_tree) -> dict[str, tuple]:
    """Specs of the float32 gradient accumulator (ZeRO-2: data + model)."""
    return param_shardings(cfg, mesh, param_spec_tree, fsdp=True)


def train_state_shardings(cfg: ModelConfig, mesh, state_specs) -> dict:
    """Specs of the train state (``train.step.train_state_specs``): the
    live parameters TP-only, the moments and master ZeRO-2, ``count``
    replicated."""
    opt = state_specs["opt"]
    return {"params": param_shardings(cfg, mesh, state_specs["params"]),
            "opt": {k: param_shardings(cfg, mesh, opt[k], fsdp=True)
                    for k in ("m", "v", "master")} | {"count": ()}}


# ----------------------------------------------------------------------
# activations / inputs
# ----------------------------------------------------------------------
def _ways(mesh, axes) -> int:
    if not axes:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return int(np.prod([sizes[a] for a in axes]))


def _spec(*entries) -> tuple:
    """A spec tuple as ``PartitionSpec(*entries)`` holds it: a one-axis
    tuple entry is the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def batch_axis(mesh, b: int):
    """The data axes when they divide the batch ``b``, else None."""
    axes = data_axes(mesh)
    ways = _ways(mesh, axes)
    return axes if (b % max(ways, 1) == 0 and b >= ways) else None


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    ba = batch_axis(mesh, shape.global_batch)
    if shape.kind == "decode":
        tok = _spec(ba) if ba else ()
        if cfg.input_mode == "embeddings":
            tok = _spec(ba, None) if ba else (None, None)
        return {"inputs": tok}
    if cfg.input_mode == "embeddings":
        return {"embeddings": _spec(ba, None, None) if ba
                else (None, None, None),
                "labels": _spec(ba, None) if ba else (None, None)}
    spec = _spec(ba, None) if ba else (None, None)
    return {"tokens": spec, "labels": spec}


def input_structs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins for the step inputs (no allocation)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        if cfg.input_mode == "embeddings":
            return {"inputs": meta((b, cfg.d_model), dt)}
        return {"inputs": meta((b,), torch.int32)}
    if cfg.input_mode == "embeddings":
        return {"embeddings": meta((b, s, cfg.d_model), dt),
                "labels": meta((b, s), torch.int32)}
    return {"tokens": meta((b, s), torch.int32),
            "labels": meta((b, s), torch.int32)}


# ----------------------------------------------------------------------
# decode caches
# ----------------------------------------------------------------------
def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    cache_specs) -> dict:
    """Specs for the decode cache (``transformer.init_cache``'s dict, or
    any objects of its shapes), leaf by leaf; the ``slstm`` tuple gives a
    tuple of specs."""
    b = shape.global_batch
    ba = batch_axis(mesh, b)
    model_n = axis_sizes(mesh).get("model", 1)

    def one(name: str, leaf) -> tuple:
        shp = _shape(leaf)
        spec: list = [None] * len(shp)
        if name in ("k", "v", "attn_k", "attn_v"):
            # (L/G, B, T, KVH, hd)
            if ba:
                spec[1] = ba
                spec[2] = "model"
            else:   # batch 1, long context: context-parallel over all axes
                spec[2] = axis_names(mesh)
        elif name in ("ssm", "ssm_tail"):
            # (..., B, H, N, P): heads over model
            if ba and b % _ways(mesh, ba) == 0:
                spec[-4] = ba
            if shp[-3] % model_n == 0 and model_n > 1:
                spec[-3] = "model"
        elif name in ("conv", "conv_tail"):
            # (..., B, K-1, d_inner)
            if ba:
                spec[-3] = ba
            if shp[-1] % model_n == 0 and model_n > 1:
                spec[-1] = "model"
        elif name == "mlstm":
            # (G, m, B, H, dh, dh+1)
            if ba:
                spec[2] = ba
            if shp[-2] % model_n == 0 and model_n > 1:
                spec[-2] = "model"
        elif name == "slstm":
            # tuple leaves (G, B, H, dh)
            if ba:
                spec[1] = ba
        return _spec(*spec)

    return {name: tuple(one(name, x) for x in leaf)
            if isinstance(leaf, tuple) else one(name, leaf)
            for name, leaf in cache_specs.items()}


# ----------------------------------------------------------------------
# placement on a DeviceMesh
# ----------------------------------------------------------------------
def place_tensor(x: torch.Tensor, spec: tuple, mesh) -> DTensor:
    """``x`` (the full tensor, the same on every rank) as a DTensor laid
    out by ``spec``; a DTensor is redistributed."""
    placements = to_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x.detach(), mesh, placements)


def place_module(module: nn.Module, specs: Mapping[str, tuple], mesh
                 ) -> nn.Module:
    """Replace each parameter of ``module`` by a DTensor parameter laid
    out by ``specs[name]`` (in place; the module is returned)."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, nn.Parameter(place_tensor(p.data, specs[name],
                                                     mesh),
                                        requires_grad=p.requires_grad))
    return module


def place(tree, shardings, mesh):
    """A nested dict of tensors and modules (a train state) laid out by
    the matching tree of specs (:func:`train_state_shardings`): tensors
    become DTensors, modules get DTensor parameters in place."""
    if isinstance(tree, nn.Module):
        return place_module(tree, shardings, mesh)
    if isinstance(tree, Mapping):
        return {k: place(v, shardings[k], mesh) for k, v in tree.items()}
    return place_tensor(tree, shardings, mesh)


__all__ = ["batch_axis", "cache_shardings", "grad_specs", "input_shardings",
           "input_structs", "param_shardings", "param_spec", "place",
           "place_module", "place_tensor", "reference_param_spec",
           "to_placements", "train_state_shardings"]
