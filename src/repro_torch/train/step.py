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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
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


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    grad_specs=None):
    """The step function for ``cfg`` and ``opt_cfg``.  ``grad_specs`` (the
    reference's sharding of the gradient accumulator over a device mesh)
    is not ported yet and must be None."""
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs: the gradient accumulator's sharding needs the "
            "device mesh, not ported yet (ROADMAP A.13 item 6)")
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")

    def loss(model, mb):
        return transformer.loss_fn(cfg, model, mb, remat=remat)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        names, params = map(list, zip(*model.named_parameters()))
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if microbatches == 1:
            l, metrics = loss(model, batch)
            grads = _grads(l, names, params)
            l = l.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} is not a multiple of "
                                 f"microbatches={microbatches}")
            n = b // microbatches
            grads = {nm: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                     for nm, p in zip(names, params)}
            l = torch.zeros((), dtype=torch.float32, device=model.device)
            aux = torch.zeros_like(l)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                li, mi = loss(model, mb)
                for nm, g in _grads(li, names, params).items():
                    grads[nm] += g
                l = l + li.detach()
                aux = aux + mi["moe_aux"].detach()
            torch._foreach_div_(list(grads.values()), microbatches)
            l = l / microbatches
            metrics = {"ce": l, "moe_aux": aux / microbatches}
        _, _, opt_metrics = opt_lib.apply_updates(opt_cfg, model, grads,
                                                  state["opt"])
        return state, {**metrics, "loss": l, **opt_metrics}

    return train_step


__all__ = ["init_train_state", "make_train_step", "train_state_specs"]
