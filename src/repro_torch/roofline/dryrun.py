"""Dry runs of the LLM paths on the ``meta`` device: the counterpart of
the reference's dry-run records, which ``benchmarks/roofline_report.py``
reads from ``results/dryrun/*.json``.

The reference lowers and compiles a step on ``jax.ShapeDtypeStruct``s and
parses the HLO.  :func:`dry_run` builds the model on the ``meta`` device
(shapes and dtypes, no storage), runs the step there under
``opcount.CostCounter`` and prices the counts with ``analysis.HW``: the
prefill, one decode step, or the training loss forward and backward under
the config's remat.  The kernel wrappers return empty ``meta`` outputs
and declare their costs, as on the card; no number is computed.
"""
from __future__ import annotations

import time

import torch

from repro_torch.roofline import opcount
from repro_torch.roofline.analysis import (HW, _COLLECTIVES,
                                           compute_seconds, roofline_report,
                                           tensor_bytes)

KINDS = ("prefill", "decode", "train")
META = torch.device("meta")


def _inputs(cfg, batch: int, seq: int | None) -> dict:
    """Meta inputs of ``batch`` rows of ``seq`` positions (or one decode
    position when ``seq`` is None)."""
    shape = (batch,) if seq is None else (batch, seq)
    if cfg.input_mode == "embeddings":
        return {"embeddings": torch.empty((*shape, cfg.d_model),
                                          dtype=getattr(torch, cfg.dtype),
                                          device=META)}
    return {"tokens": torch.zeros(shape, dtype=torch.int64, device=META)}


def _nbytes(tensors) -> int:
    return sum(tensor_bytes(t.shape, t.dtype) for t in tensors)


def state_bytes(cfg, kind: str, batch: int, max_len: int) -> int:
    """Bytes of the state a step holds, from the parameters' shapes: the
    parameters; for ``train`` also AdamW's float32 m, v and master copy
    and its step count; for ``decode`` the cache.  No activations."""
    from repro_torch.models import transformer
    from repro_torch.train import step
    if kind == "train":
        specs = step.train_state_specs(cfg)
        return _nbytes([*specs["params"].values(),
                        *(t for k in ("m", "v", "master")
                          for t in specs["opt"][k].values()),
                        specs["opt"]["count"]])
    n = _nbytes(transformer.param_specs(cfg).values())
    if kind == "decode":
        cache = transformer.init_cache(cfg, batch, max_len, device=META)
        n += _nbytes(x for v in cache.values()
                     for x in (v if isinstance(v, tuple) else (v,)))
    return n


def _run(cfg, model, kind: str, batch: int, seq: int, max_len: int,
         remat: bool) -> None:
    from repro_torch.models import transformer
    if kind == "prefill":
        transformer.prefill(cfg, model, _inputs(cfg, batch, seq), max_len,
                            last_only=True)
    elif kind == "decode":
        cache = transformer.init_cache(cfg, batch, max_len, device=META)
        inputs = _inputs(cfg, batch, None)
        transformer.decode_step(cfg, model, cache,
                                next(iter(inputs.values())),
                                min(seq, max_len - 1))
    else:
        b = {**_inputs(cfg, batch, seq),
             "labels": torch.zeros((batch, seq), dtype=torch.int64,
                                   device=META)}
        loss, _ = transformer.loss_fn(cfg, model, b, remat=remat)
        torch.autograd.grad(loss, list(model.parameters()),
                            allow_unused=True)


def dry_run(cfg, kind: str, batch: int, seq: int, *,
            max_len: int | None = None, remat: bool = True,
            hw: dict = HW) -> dict:
    """The record of one (config, step kind, batch × seq) cell on one
    card: ``kind`` ``"prefill"`` (``batch`` prompts of ``seq`` tokens,
    the cache sized ``max_len``, default ``seq``, the last position's
    logits as the engine keeps them), ``"decode"`` (one step over a cache
    of ``max_len`` positions, at position ``seq``, or ``max_len`` − 1 if
    that is past it) or ``"train"`` (``loss_fn`` forward and backward at
    ``remat``).  Keys as the reference's dry-run records: ``arch``,
    ``shape``, ``mesh`` (``"1"``), ``chips``, ``status``, ``roofline``
    (``analysis.RooflineTerms`` under ``hw``), ``memory`` and
    ``compile_s`` (here the seconds the count took); plus the counts
    (``cost``, ``flops_by_dtype``, ``collectives_per_device``, the
    ``kernels`` declared) and ``compute_s_by_dtype``, the compute term
    with each dtype's FLOPs at its own peak (``analysis.PEAKS``)."""
    from repro_torch.models import transformer
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    max_len = seq if max_len is None else max_len
    tokens = batch if kind == "decode" else batch * seq
    t0 = time.perf_counter()
    model = transformer.LM(cfg, device="meta")
    with opcount.CostCounter() as counter:
        _run(cfg, model, kind, batch, seq, max_len, remat)
    costs = counter.costs()
    compile_s = time.perf_counter() - t0
    terms = roofline_report(
        per_device_flops=costs.flops, per_device_bytes=costs.traffic_bytes,
        per_device_collective_bytes=costs.collective_bytes["total"],
        chips=1, n_active_params=cfg.active_param_count(), tokens=tokens,
        kind=kind, hw=hw)
    rec = {"arch": cfg.name, "shape": f"{kind}_{batch}x{seq}", "mesh": "1",
           "chips": 1, "status": "ok", "kind": kind, "batch": batch,
           "seq": seq, "max_len": max_len, "tokens": tokens,
           "compile_s": compile_s,
           "cost": {"flops_per_device": costs.flops,
                    "traffic_bytes_per_device": costs.traffic_bytes},
           "flops_by_dtype": costs.flops_by_dtype,
           "collectives_per_device": {k: costs.collective_bytes[k]
                                      for k in (*_COLLECTIVES, "total")},
           "kernels": costs.kernels,
           "compute_s_by_dtype": compute_seconds(costs.flops_by_dtype, hw),
           "roofline": terms.as_dict(),
           "memory": {"peak_estimate_bytes": state_bytes(cfg, kind, batch,
                                                         max_len),
                      "counts": "state only: parameters (train: + AdamW "
                                "m, v, master; decode: + cache); no "
                                "activations"}}
    if costs.warnings:
        rec["count_warnings"] = costs.warnings[:10]
    return rec


__all__ = ["KINDS", "dry_run", "state_bytes"]
