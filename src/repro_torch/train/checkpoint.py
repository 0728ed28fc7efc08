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
leaves on ``device``, or, with ``shardings`` and ``mesh``, lays them out
over a device mesh (the reference's elastic reshard: a checkpoint holds
the global arrays, so any mesh restores it, whatever mesh saved it).
:func:`save` of a state of DTensors gathers each leaf on every rank (a
collective), and rank 0 alone writes while the others wait for its
outcome, which it broadcasts: a write that fails raises on every rank.
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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.launch.sharding import place_module, place_tensor


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


def _gathered(leaves):
    """(name, leaf) with each DTensor leaf gathered whole (a collective:
    every rank of its mesh makes the same calls in the same order)."""
    for name, leaf in leaves:
        if isinstance(leaf, DTensor):
            leaf = leaf.detach().full_tensor()
        yield name, leaf


def save(root: str, step: int, state, *, meta: dict | None = None,
         keep: int = 3) -> str:
    """Atomically persist ``state`` under ``root/step_<step>``; then keep
    only the newest ``keep`` steps (all, if ``keep`` <= 0).  A state
    holding DTensors is saved by every rank of the default process group
    together: each gathers the leaves, rank 0 writes, and the others wait
    for its outcome; a failed write raises on every rank."""
    leaves = _flatten(state)
    if not any(isinstance(leaf, DTensor) for _, leaf in leaves):
        return _write(root, step, ((name, *_to_numpy(leaf))
                                   for name, leaf in leaves), meta, keep)
    final = os.path.join(root, f"step_{step:08d}")
    gathers = _gathered(leaves)
    error = None
    if dist.get_rank() == 0:
        try:
            _write(root, step, ((name, *_to_numpy(leaf))
                                for name, leaf in gathers), meta, keep)
        except Exception as e:      # raised below, after the other ranks
            error = e               # have made their gathers and heard
    for _ in gathers:               # the gathers rank 0 did not reach
        pass
    outcome = [None if error is None else repr(error)]
    dist.broadcast_object_list(outcome, src=0)
    if error is not None:
        raise error
    if outcome[0] is not None:
        raise RuntimeError(f"rank 0 failed to write {final}: {outcome[0]}")
    return final


def _write(root: str, step: int, arrays, meta: dict | None,
           keep: int) -> str:
    final = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f".tmp.step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": []}
    for i, (name, arr, dtype) in enumerate(arrays):
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
    plain tensors of their global shapes on ``device`` (the module's own
    storage is not copied)."""
    memo = {id(p): nn.Parameter(torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"),
                                requires_grad=p.requires_grad)
            for p in module.parameters()}
    clone = copy.deepcopy(module, memo)
    return clone.to_empty(device=device)


def _build(like, leaves, device: torch.device, shardings=None, mesh=None):
    """``like``'s structure over the next of ``leaves`` (an iterator of
    tensors already on ``device``): dicts with sorted keys, a module as a
    fresh module holding the loaded parameters; each laid out over
    ``mesh`` by the matching spec of ``shardings`` when it is given."""
    if isinstance(like, nn.Module):
        clone = _empty_clone(like, device)
        with torch.no_grad():
            for _, p in _children(clone):
                p.copy_(next(leaves))
        return clone if shardings is None else place_module(
            clone, shardings, mesh)
    kids = _children(like)
    if kids is None:
        leaf = next(leaves)
        return leaf if shardings is None else place_tensor(leaf, shardings,
                                                           mesh)
    return {k: _build(sub, leaves, device,
                      None if shardings is None else shardings[k], mesh)
            for k, sub in kids}


def restore(root: str, like, *, step: int | None = None, device=None,
            shardings=None, mesh=None) -> tuple[object, int, dict]:
    """Load a checkpoint into the structure of ``like`` (a nested dict of
    tensors or modules, as :func:`save` takes; only its structure and
    names are used).  The leaves land on ``device``, resolved as every
    entry point resolves it: the card unless ``device="cpu"`` is passed,
    and an error when CUDA is absent.  With ``shardings`` (the matching
    tree of specs, e.g. ``launch.sharding.train_state_shardings``) and
    ``mesh`` (a ``DeviceMesh`` on that device), every leaf, and every
    parameter of a module, becomes a DTensor laid out on ``mesh``: the
    reference's elastic placement; every rank of the mesh calls it.
    Returns (state, step, meta)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore: shardings and mesh go together")
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
    return (_build(like, leaves, dev, shardings, mesh), manifest["step"],
            manifest["meta"])


__all__ = ["all_steps", "latest_step", "restore", "save"]
