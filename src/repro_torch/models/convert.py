"""Carry the reference's parameters across to the port.

The reference keeps a model's parameters as a pytree: the per-layer
weights stacked on a leading L axis under ``layers``, ``embed/table``,
``head/table`` when the embeddings are not tied, and ``final_ln/scale``;
every dense weight is (d_in, d_out).  :func:`params_from_jax` turns such a
tree of numpy arrays (``jax.tree.map(np.asarray, params)``) into the state
dict of :class:`repro_torch.models.transformer.LM`, transposing each dense
weight to the (d_out, d_in) that ``nn.Linear`` holds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

#: (path in one stacked reference layer, name in the port's layer module,
#: dense weight to transpose).
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
)


def _get(tree, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def params_from_jax(cfg: ModelConfig, tree) -> dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors in ``cfg.dtype``) for the
    reference's parameter tree ``tree`` of numpy arrays; load it with
    ``LM(cfg, device=...).load_state_dict(...)``."""
    dtype = getattr(torch, cfg.dtype)

    def tensor(a) -> torch.Tensor:
        # numpy has no bfloat16: go through float32, which holds every
        # bfloat16 value exactly (a copy: the reference's arrays are
        # read-only).
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)

    state = {"embed.table": tensor(tree["embed"]["table"]),
             "final_ln.scale": tensor(tree["final_ln"]["scale"])}
    if not cfg.tie_embeddings:
        state["head.table"] = tensor(tree["head"]["table"])
    for path, name, transpose in _LAYER_KEYS:
        stacked = _get(tree["layers"], path)
        if stacked is None:
            continue
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{'/'.join(path)} holds "
                             f"{stacked.shape[0]} layers, not "
                             f"{cfg.num_layers}")
        for i in range(cfg.num_layers):
            w = tensor(stacked[i])
            state[f"layers.{i}.{name}"] = w.T.contiguous() if transpose else w
    return state


__all__ = ["params_from_jax"]
