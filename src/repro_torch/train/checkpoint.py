"""Atomic checkpoints in the reference's on-disk format (the reference's
``repro/train/checkpoint.py``).

Layout: one directory per step::

    <root>/step_00000042/
        manifest.json        # step, user meta, and per leaf: name, file,
                             # shape, dtype
        leaf_00000.npy ...   # one file per leaf

A state is a nested dict of tensors (or numpy arrays, or Python
numbers); an ``nn.Module`` in it stands for the dict of its named
parameters.  Leaves go in the order JAX flattens a nested dict (sorted
keys) and are named as ``jax.tree_util.keystr`` names them
(``['opt']['m']['layers.0.attn.wq.weight']``); bfloat16, which numpy
lacks, is stored as its ``uint16`` bits with the dtype ``"bfloat16"``.
So either package restores what the other wrote of the same nested dict.

Writes go to ``<root>/.tmp.step_00000042`` and are published by
``os.replace``, so a crash mid-save never leaves a listed step half
written; ``keep`` bounds the steps kept.  :func:`restore` places the
leaves on ``device``; the reference's elastic ``shardings`` argument
comes with the port's mesh (ROADMAP A.13 item 6).
"""
from __future__ import annotations

import copy
import json
import os
import re
import shutil
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device


def _children(tree):
    """The sorted (key, subtree) pairs of a dict or module, or None for a
    leaf."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return [(k, tree[k]) for k in sorted(tree)]
    return None


def _flatten(tree, path: str = "") -> list[tuple[str, object]]:
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [leaf for k, sub in kids
            for leaf in _flatten(sub, f"{path}[{k!r}]")]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(root: str, step: int, state, *, meta: dict | None = None,
         keep: int = 3) -> str:
    """Atomically persist ``state`` under ``root/step_<step>``; then keep
    only the newest ``keep`` steps (all, if ``keep`` <= 0)."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f".tmp.step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten(state)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _garbage_collect(root, keep)
    return final


def _garbage_collect(root: str, keep: int) -> None:
    steps = all_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


def all_steps(root: str) -> list[int]:
    """The published steps under ``root``, ascending (never a ``.tmp``
    one)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d{8})", name)
        if m and os.path.exists(os.path.join(root, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _empty_clone(module: nn.Module, device: torch.device) -> nn.Module:
    """A copy of ``module`` whose parameters are new, uninitialised
    tensors on ``device`` (the module's own storage is not copied)."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                requires_grad=p.requires_grad)
            for p in module.parameters()}
    clone = copy.deepcopy(module, memo)
    return clone.to_empty(device=device)


def _build(like, leaves, device: torch.device):
    """``like``'s structure over the next of ``leaves`` (an iterator of
    tensors already on ``device``): dicts with sorted keys, a module as a
    fresh module holding the loaded parameters."""
    if isinstance(like, nn.Module):
        clone = _empty_clone(like, device)
        with torch.no_grad():
            for _, p in _children(clone):
                p.copy_(next(leaves))
        return clone
    kids = _children(like)
    if kids is None:
        return next(leaves)
    return {k: _build(sub, leaves, device) for k, sub in kids}


def restore(root: str, like, *, step: int | None = None, device=None
            ) -> tuple[object, int, dict]:
    """Load a checkpoint into the structure of ``like`` (a nested dict of
    tensors or modules, as :func:`save` takes; only its structure and
    names are used).  The leaves land on ``device``, resolved as every
    entry point resolves it: the card unless ``device="cpu"`` is passed,
    and an error when CUDA is absent.  Returns (state, step, meta)."""
    dev = resolve_device("cuda" if device is None else device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = [name for name, _ in _flatten(like)]
    saved = [e["name"] for e in manifest["leaves"]]
    if names != saved:
        raise ValueError(f"checkpoint {path} holds {len(saved)} leaves "
                         f"that do not match the {len(names)} of `like`")
    leaves = (_load(path, e).to(dev) for e in manifest["leaves"])
    return _build(like, leaves, dev), manifest["step"], manifest["meta"]


__all__ = ["all_steps", "latest_step", "restore", "save"]
