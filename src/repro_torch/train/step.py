"""The train step (the reference's ``repro/train/step.py``): microbatched
gradient accumulation, activation rematerialisation and the AdamW update.

``make_train_step(cfg, opt_cfg, microbatches=...)`` returns ``(state,
batch) -> (state, metrics)``.  ``state`` = ``{"params": the model (a
``models.transformer.LM``), "opt": the AdamW state}`` with float32 master
weights; the step updates it in place and returns it (the reference
returns a new tree).  ``batch`` holds ``tokens`` (or ``embeddings``) and
``labels``, as numpy arrays or tensors; they are moved to the model's
device.  ``metrics`` are float32 scalar tensors on that device: ``ce``,
``moe_aux``, ``loss``, ``lr`` and the pre-clip ``grad_norm``.

Gradients come from ``torch.autograd.grad`` in each parameter's dtype,
as ``jax.value_and_grad`` gives them.  With ``microbatches > 1`` the batch
is cut into that many equal slices along its first axis; each slice's
gradient is cast to float32 and added in order, then divided by the
count, and the loss and ``moe_aux`` are averaged, as the reference's
``lax.scan`` does (its ``ce`` is then the averaged loss, as there).

On a device mesh, the state is placed by
``launch.sharding.train_state_shardings`` (``launch.sharding.place``) and
the step runs inside ``models.shardctx.activation_sharding(mesh)``, as the
reference's runs under ``jax.set_mesh``.  ``grad_specs``
(``launch.sharding.grad_specs``, ZeRO-2) then lays each gradient out over
``data`` and ``model`` before it is used or added, and the float32
accumulator too, as the reference's ``with_sharding_constraint`` does.
The metrics come back as plain tensors, the same on every rank.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import place_tensor
from repro_torch.models import shardctx, transformer
from repro_torch.train import optimizer as opt_lib


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device="cuda") -> dict:
    """Random parameters from ``generator`` (``transformer.init_params``)
    and a fresh AdamW state, on ``device``."""
    model = transformer.init_params(cfg, generator=generator, device=device)
    return {"params": model, "opt": opt_lib.init_state(model)}


def train_state_specs(cfg: ModelConfig) -> dict:
    """The train state's tensors as meta-device tensors of their shapes
    and dtypes (no allocation): ``params`` by name, ``m``, ``v`` and
    ``master`` float32, ``count`` int32."""
    pspecs = transformer.param_specs(cfg)

    def f32():
        return {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for n, p in pspecs.items()}
    return {"params": pspecs,
            "opt": {"m": f32(), "v": f32(), "master": f32(),
                    "count": torch.empty((), dtype=torch.int32,
                                         device="meta")}}


def _grads(loss: torch.Tensor, names: list[str], params: list) -> dict:
    """d loss / d params by name, in each parameter's dtype; a parameter
    the loss does not reach gets zeros, as JAX gives it."""
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, got)}


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    grad_specs=None):
    """The step function for ``cfg`` and ``opt_cfg``.  ``grad_specs``
    (``{name: spec}``, ``launch.sharding.grad_specs``) pins each
    gradient's layout on the mesh of the ``activation_sharding`` context
    the step runs in."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")

    def loss(model, mb):
        return transformer.loss_fn(cfg, model, mb, remat=remat)

    def layout(names: list[str]):
        """(name, gradient, dtype) → the gradient, cast to ``dtype`` and
        laid out by ``grad_specs``; without them, the gradient as it is
        (an in-place add into float32 casts it as it reads it)."""
        if grad_specs is None:
            return lambda nm, g, dtype=None: g
        mesh = shardctx.current_mesh()
        if mesh is None:
            raise ValueError("grad_specs lay gradients out on a mesh: run "
                             "the step inside shardctx.activation_sharding")
        missing = set(names) - set(grad_specs)
        if missing:
            raise ValueError(f"grad_specs lack {len(missing)} parameters, "
                             f"e.g. {sorted(missing)[0]}")
        return lambda nm, g, dtype=None: place_tensor(
            g if dtype is None else g.to(dtype), grad_specs[nm], mesh)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        names, params = map(list, zip(*model.named_parameters()))
        lay = layout(names)
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if microbatches == 1:
            l, metrics = loss(model, batch)
            grads = {nm: lay(nm, g)
                     for nm, g in _grads(l, names, params).items()}
            l = l.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} is not a multiple of "
                                 f"microbatches={microbatches}")
            n = b // microbatches
            grads = {nm: lay(nm, torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device))
                     for nm, p in zip(names, params)}
            l = torch.zeros((), dtype=torch.float32, device=model.device)
            aux = torch.zeros_like(l)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                li, mi = loss(model, mb)
                # Each microbatch's gradient is laid out before it is
                # added (ZeRO-2: reduce-scattered in float32), and the
                # in-place add keeps the accumulator's layout.
                for nm, g in _grads(li, names, params).items():
                    grads[nm] += lay(nm, g, torch.float32)
                l = l + li.detach()
                aux = aux + mi["moe_aux"].detach()
            torch._foreach_div_(list(grads.values()), microbatches)
            l = l / microbatches
            metrics = {"ce": l, "moe_aux": aux / microbatches}
        _, _, opt_metrics = opt_lib.apply_updates(opt_cfg, model, grads,
                                                  state["opt"])
        metrics = {**metrics, "loss": l, **opt_metrics}
        return state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


__all__ = ["init_train_state", "make_train_step", "train_state_specs"]
