"""AdamW with float32 master weights and LR schedules (the reference's
``repro/train/optimizer.py``): cosine, WSD and constant.

WSD (warmup–stable–decay) is MiniCPM's schedule (arXiv:2404.06395): linear
warmup, a long constant plateau, a short decay tail.

State layout: ``{"m", "v", "master", "count"}``, where ``m``, ``v`` and
``master`` map each parameter's name to a float32 tensor (``master`` the
float32 copy of the possibly bf16 parameter) and ``count`` is an int32
scalar tensor.  :func:`apply_updates` clips by the pre-clip global norm,
corrects the moments' bias by ``count``, decays the master weights, and
casts the new master into each parameter, so repeated training does not
depend on the storage dtype.

Unlike the reference, which returns new trees, the update is made in
place (parameters, moments, master and count), and the same objects are
returned.  The arithmetic is the reference's, leaf by leaf, in float32;
``torch._foreach_*`` runs it over groups of leaves (the reference's
optimizer is plain jnp, outside any kernel).

On a device mesh the leaves may be DTensors (``launch.sharding.place``):
the global norm all-reduces each leaf's sum of squares, and the
elementwise update runs on each rank's shards of the gradient (laid out
as its moments first), moments and master; each parameter then takes
its master in its own layout (an all-gather over ``data`` for ZeRO-2
masters and TP-only parameters).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | wsd | constant
    wsd_decay_frac: float = 0.1    # last 10% of steps decay


def schedule_fn(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The learning rate at a step ``count`` (an int tensor or int), a
    float32 scalar tensor on ``count``'s device."""
    if cfg.schedule not in ("cosine", "wsd", "constant"):
        raise ValueError(cfg.schedule)

    def fn(count) -> torch.Tensor:
        step = torch.as_tensor(count).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            return cfg.lr * warm
        if cfg.schedule == "cosine":
            frac = torch.clamp((step - cfg.warmup_steps)
                               / max(cfg.total_steps - cfg.warmup_steps, 1),
                               0.0, 1.0)
            return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        frac = torch.clamp((step - decay_start)
                           / max(cfg.total_steps - decay_start, 1),
                           0.0, 1.0)
        # stable plateau, then a linear-in-sqrt decay tail
        return cfg.lr * warm * (1.0 - frac) ** 0.5
    return fn


def _named(params) -> dict[str, torch.Tensor]:
    """``params`` (an ``nn.Module`` or a dict of tensors) as a dict from
    name to tensor."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@torch.no_grad()
def init_state(params) -> dict:
    """Zero float32 moments, the float32 master copy of every parameter,
    and ``count`` 0 (int32), on the parameters' devices."""
    named = _named(params)
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "master": {n: p.detach().to(torch.float32, copy=True)
                       for n, p in named.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(named))}


def _device(named: dict) -> torch.device:
    return next(iter(named.values())).device if named else torch.device(
        "cpu")


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf (a dict of tensors, or a sequence), in
    float32; a DTensor leaf's sum is all-reduced over its mesh, so the
    norm is a plain tensor, the same on every rank."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else "cpu")
    for x in leaves:
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = total + (sq.full_tensor() if isinstance(sq, DTensor)
                         else sq)
    return torch.sqrt(total)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage: in-place updates land
    in the DTensor), a plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def _laid_as(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` in the layout of the state leaf ``like``."""
    if isinstance(like, DTensor) and tuple(g.placements) != tuple(
            like.placements):
        return g.redistribute(like.device_mesh, like.placements)
    return g


def _assign(p: torch.Tensor, master: torch.Tensor) -> None:
    """``p`` ← ``master`` cast to ``p``'s dtype, in ``p``'s layout."""
    if isinstance(p, DTensor):
        master = master.redistribute(p.device_mesh, p.placements)
    p.copy_(master)


#: Elements of float32 scratch per group of leaves in
#: :func:`apply_updates` (three such copies live at once).
_GROUP_NUMEL = 1 << 26


def _groups(names: list[str], named: dict) -> list[list[str]]:
    out, cur, n = [], [], 0
    for name in names:
        cur.append(name)
        n += named[name].numel()
        if n >= _GROUP_NUMEL:
            out.append(cur)
            cur, n = [], 0
    return out + ([cur] if cur else [])


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads: dict, state: dict
                  ) -> tuple[object, dict, dict]:
    """One AdamW step, in place: ``params`` (module or dict of tensors)
    get the new master weights cast to their dtype, ``state``'s moments,
    master and count are updated.  ``grads`` maps each parameter's name to
    its gradient (any float dtype).  Returns (params, state, metrics:
    ``lr`` and the pre-clip ``grad_norm``, float32 scalar tensors)."""
    named = _named(params)
    names = list(named)
    count = state["count"]
    count += 1
    lr = schedule_fn(cfg)(_local(count))
    gnorm = global_norm([grads[n] for n in names])
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = _local(count).to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, step)
    bc2 = 1 - torch.pow(cfg.b2, step)
    for group in _groups(names, named):
        g = [_local(_laid_as(grads[n], state["m"][n]).to(torch.float32,
                                                          copy=True))
             for n in group]
        m = [_local(state["m"][n]) for n in group]
        v = [_local(state["v"][n]) for n in group]
        w = [_local(state["master"][n]) for n in group]
        torch._foreach_mul_(g, scale)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        del g
        delta = torch._foreach_div(m, bc1)              # m̂
        denom = torch._foreach_div(v, bc2)              # v̂
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(delta, denom)
        del denom
        torch._foreach_add_(delta, w, alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(w, delta)
        del delta
        for n in group:
            _assign(named[n], state["master"][n])
    return params, state, {"lr": lr, "grad_norm": gnorm}


__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "schedule_fn"]
