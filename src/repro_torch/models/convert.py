"""Carry the reference's parameters across to the port.

The reference keeps a model's parameters as a pytree: ``embed/table``,
``head/table`` when the embeddings are not tied, ``final_ln/scale``, and
the blocks' weights stacked on leading axes: ``layers`` (L, ...) for the
``attn`` pattern; ``mamba_groups`` (g, every, ...), ``mamba_tail`` (tail,
...) and the unstacked ``shared_attn`` for ``zamba``; ``mlstm`` (g, k − 1,
...) and ``slstm`` (g, ...) for ``xlstm``.  Every dense weight is (d_in,
d_out).  :func:`params_from_jax` turns such a tree of numpy arrays
(``jax.tree.map(np.asarray, params)``) into the state dict of
:class:`repro_torch.models.transformer.LM`, one entry per layer, and
transposes each dense weight to the (d_out, d_in) that ``nn.Linear``
holds.  A mixture-of-experts layer's ``moe/{gate,up,down}`` keep their
(E, d_in, d_out) layout, sLSTM's recurrent ``r`` its (H, Dh, 4Dh).  The
parameters the reference keeps in float32 whatever the model dtype stay
float32 (:data:`_FLOAT32`: the MoE router, Mamba2's ``A_log``, ``D`` and
``dt_bias``, the xLSTM gate weights ``wif`` and ``r`` and both forget
biases): rounding them would move the routing or the decays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

#: (path in one stacked reference layer, name in the port's layer module,
#: dense weight to transpose), per kind of layer.  Paths absent from a
#: model are skipped.
_LAYER_KEYS = (
    (("ln1", "scale"), "ln1.scale", False),
    (("attn", "wq"), "attn.wq.weight", True),
    (("attn", "wk"), "attn.wk.weight", True),
    (("attn", "wv"), "attn.wv.weight", True),
    (("attn", "wo"), "attn.wo.weight", True),
    (("attn", "q_norm", "scale"), "attn.q_norm.scale", False),
    (("attn", "k_norm", "scale"), "attn.k_norm.scale", False),
    (("ln2", "scale"), "ln2.scale", False),
    (("mlp", "gate", "w"), "mlp.gate.weight", True),
    (("mlp", "up", "w"), "mlp.up.weight", True),
    (("mlp", "down", "w"), "mlp.down.weight", True),
    (("moe", "router"), "moe.router", False),
    (("moe", "gate"), "moe.gate", False),
    (("moe", "up"), "moe.up", False),
    (("moe", "down"), "moe.down", False),
)
_MAMBA_KEYS = ((("ln", "scale"), "ln.scale", False),) + tuple(
    (("mamba", k), f"mamba.{k}" + (".weight" if t else ""), t)
    for k, t in (("in_proj", True), ("conv", False), ("A_log", False),
                 ("D", False), ("dt_bias", False), ("norm_scale", False),
                 ("out_proj", True)))
_MLSTM_KEYS = ((("ln", "scale"), "ln.scale", False),) + tuple(
    (("mlstm", k), f"mlstm.{k}" + (".weight" if t else ""), t)
    for k, t in (("wq", True), ("wk", True), ("wv", True), ("wif", True),
                 ("wgate", True), ("wo", True), ("f_bias", False)))
_SLSTM_KEYS = ((("ln", "scale"), "ln.scale", False),) + tuple(
    (("slstm", k), f"slstm.{k}" + (".weight" if t else ""), t)
    for k, t in (("w", True), ("r", False), ("wo", True),
                 ("f_bias", False)))
#: Layer parameters held in float32 in every model.
_FLOAT32 = {"moe.router", "mamba.A_log", "mamba.D", "mamba.dt_bias",
            "mlstm.wif.weight", "mlstm.f_bias", "slstm.r", "slstm.f_bias"}


#: Stacks of layers: port prefix → (its key table, its number of
#: leading stack dims in the reference).
_STACKS = {"layers": (_LAYER_KEYS, 1), "shared_attn": (_LAYER_KEYS, 0),
           "mamba_groups": (_MAMBA_KEYS, 2), "mamba_tail": (_MAMBA_KEYS, 1),
           "mlstm": (_MLSTM_KEYS, 2), "slstm": (_SLSTM_KEYS, 1)}
#: Unstacked tables and norms: port name → reference path.
_TOP = {"embed.table": ("embed", "table"), "head.table": ("head", "table"),
        "final_ln.scale": ("final_ln", "scale")}


def reference_location(name: str) -> tuple[tuple[str, ...], int, bool]:
    """(reference path, number of leading stack dims, transposed) of the
    port's parameter ``name``: ``layers.3.attn.wq.weight`` is layer 3 of
    the reference's ``layers/attn/wq`` (L, d_in, d_out), so
    ``(("layers", "attn", "wq"), 1, True)``.  The layer indices are the
    name's first ``lead`` integers after the prefix.
    :func:`params_from_jax` and ``launch.sharding.param_spec`` both read
    this table."""
    if name in _TOP:
        return _TOP[name], 0, False
    prefix, _, rest = name.partition(".")
    if prefix not in _STACKS:
        raise KeyError(f"{name}: not a parameter of the port's LM")
    keys, lead = _STACKS[prefix]
    local = rest.split(".", lead)[lead] if lead else rest
    for path, port_name, transpose in keys:
        if port_name == local:
            return (prefix, *path), lead, transpose
    raise KeyError(f"{name}: not a parameter of the port's LM")


def _get(tree, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def params_from_jax(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors in ``cfg.dtype``, the
    :data:`_FLOAT32` ones in float32) for the reference's parameter tree
    ``tree`` of numpy arrays; load it with ``LM(cfg,
    device=...).load_state_dict(...)``.  Each entry is found by
    :func:`reference_location`."""
    model_dtype = getattr(torch, cfg.dtype)

    def tensor(a, dtype=model_dtype) -> torch.Tensor:
        # numpy has no bfloat16: go through float32, which holds every
        # bfloat16 value exactly (a copy: the reference's arrays are
        # read-only).
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)

    state, used = {}, {}
    for name in transformer.param_specs(cfg):
        path, lead, transpose = reference_location(name)
        stacked = _get(tree, path)
        if stacked is None:
            raise KeyError(f"{name}: the reference has no {'/'.join(path)}")
        at = tuple(int(i) for i in name.split(".")[1:1 + lead])
        if any(i >= n for i, n in zip(at, stacked.shape)):
            raise ValueError(f"{'/'.join(path)} is stacked "
                             f"{stacked.shape[:lead]}, not past {at}")
        used.setdefault(path, (stacked.shape[:lead], set()))[1].add(at)
        local = name.split(".", 1 + lead)[-1]
        w = tensor(stacked[at],
                   torch.float32 if local in _FLOAT32 else model_dtype)
        state[name] = w.T.contiguous() if transpose else w
    for path, (lead_shape, seen) in used.items():
        if len(seen) != int(np.prod(lead_shape, dtype=np.int64)):
            raise ValueError(f"{'/'.join(path)} is stacked {lead_shape}, "
                             f"not {len(seen)}")
    return state


def train_state_from_jax(cfg: ModelConfig, state, *, device="cuda") -> dict:
    """The port's train state (``train.step``'s ``{"params": LM, "opt":
    {"m", "v", "master", "count"}}``) on ``device`` for the reference's
    ``{"params", "opt": {"m", "v", "master", "count"}}`` of numpy arrays:
    the parameters as :func:`params_from_jax` carries them, ``m``, ``v``
    and ``master`` float32 whatever the model dtype, ``count`` int32."""
    model = transformer.LM(cfg, device=device)
    model.load_state_dict(params_from_jax(cfg, state["params"]))
    f32 = dataclasses.replace(cfg, dtype="float32")
    dev = model.device
    opt = {k: {n: t.to(dev) for n, t in params_from_jax(
        f32, state["opt"][k]).items()} for k in ("m", "v", "master")}
    opt["count"] = torch.tensor(int(np.asarray(state["opt"]["count"])),
                                dtype=torch.int32, device=dev)
    return {"params": model, "opt": opt}


__all__ = ["params_from_jax", "reference_location",
           "train_state_from_jax"]
