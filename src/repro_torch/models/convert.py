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
    device=...).load_state_dict(...)``."""
    model_dtype = getattr(torch, cfg.dtype)

    def tensor(a, dtype=model_dtype) -> torch.Tensor:
        # numpy has no bfloat16: go through float32, which holds every
        # bfloat16 value exactly (a copy: the reference's arrays are
        # read-only).
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)

    state = {"embed.table": tensor(tree["embed"]["table"]),
             "final_ln.scale": tensor(tree["final_ln"]["scale"])}
    if not cfg.tie_embeddings:
        state["head.table"] = tensor(tree["head"]["table"])

    def carry(prefix: str, keys, lead: tuple[int, ...]):
        # Each layer of the stack tree[prefix], stacked on `lead` axes,
        # to the state dict entries "{prefix}.{i}[.{j}].{name}".
        for path, name, transpose in keys:
            stacked = _get(tree[prefix], path)
            if stacked is None:
                continue
            if stacked.shape[:len(lead)] != lead:
                raise ValueError(f"{prefix}/{'/'.join(path)} is stacked "
                                 f"{stacked.shape[:len(lead)]}, not {lead}")
            dtype = torch.float32 if name in _FLOAT32 else model_dtype
            for at in np.ndindex(*lead):
                w = tensor(stacked[at], dtype)
                key = ".".join([prefix, *map(str, at), name])
                state[key] = w.T.contiguous() if transpose else w

    if cfg.block_pattern == "attn":
        carry("layers", _LAYER_KEYS, (cfg.num_layers,))
    elif cfg.block_pattern == "zamba":
        g, tail = transformer._zamba_group_sizes(cfg)
        carry("mamba_groups", _MAMBA_KEYS, (g, cfg.shared_attn_every or 6))
        if tail:
            carry("mamba_tail", _MAMBA_KEYS, (tail,))
        carry("shared_attn", _LAYER_KEYS, ())
    else:
        g, m_per, _ = transformer._xlstm_group_sizes(cfg)
        carry("mlstm", _MLSTM_KEYS, (g, m_per))
        carry("slstm", _SLSTM_KEYS, (g,))
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


__all__ = ["params_from_jax", "train_state_from_jax"]
