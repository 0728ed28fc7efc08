"""The loss swing of granite-3-2b at full width, in both packages.

With a 2-step warmup to lr 3e-3, the port's granite-3-2b loss rises
within four AdamW steps (on the H100, at 40 layers in bf16, to 17.55;
``chip_train_sweep.py``).  Here the reference trains at the same width:
granite-3-2b at full width (d_model 2,048, 32 heads over 8 KV heads,
d_ff 8,192, the 49,155-token vocabulary) and 2 layers, float32, from the
reference's initial state carried across by
``convert.train_state_from_jax``, on the reference's ``TokenPipeline``
batches, four steps at lr 3e-3 after a 2-step warmup.

* At 2 × 32 tokens both packages swing, and their losses and gradient
  norms agree within ``tests/test_torch_train.py``'s ``CAP`` at every
  step: the swing belongs to the model and the learning rate.
* At 4 × 8 tokens the loss swings to 20.0, and free-running, the port's
  fourth loss misses the reference's by about ``CAP`` (1.16e-4 relative
  at two torch threads).  The test shows that gap is float32 rounding
  carried through the swing: the reference, restarted from the port's
  state after step 1, lands within ``CAP`` of the port at every later
  step; and at step 4, given the reference's own state, the port
  computes the reference's loss within ``CAP``.

``pytest -s`` prints each test's losses as one JSON line.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.data.tokens import TokenPipelineConfig as RefPipelineConfig
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib
from test_torch_train import CAP

ARCH = "granite-3-2b"
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=50)
STEPS = 4


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads: the port's steps take as long as with eight
    alone, and leave the cores to the reference's XLA pool and to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """Both packages' configurations and step functions, and the
    reference's initial train state."""
    cfg = dataclasses.replace(ARCHS[ARCH], num_layers=2, dtype="float32")
    rcfg = dataclasses.replace(REF_ARCHS[ARCH], num_layers=2,
                               dtype="float32")
    assert (cfg.d_model, cfg.vocab_size) == (2048, 49_155)
    return {"cfg": cfg,
            "ref_state": ref_step.init_train_state(rcfg,
                                                   jax.random.PRNGKey(0)),
            "ref_fn": jax.jit(ref_step.make_train_step(
                rcfg, ref_opt.AdamWConfig(**OPT))),
            "port_fn": step_lib.make_train_step(
                cfg, opt_lib.AdamWConfig(**OPT))}


def _batches(cfg, seq, batch):
    pipe = RefPipeline(RefPipelineConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch))
    return [pipe.global_batch_at(i) for i in range(STEPS)]


def _port_state(cfg, ref_state):
    return convert.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, ref_state), device="cpu")


def _to_reference(state, like):
    """The port's train state as the reference's tree of numpy arrays,
    shaped like ``like``: each parameter and AdamW moment written back
    where ``convert.reference_location`` says it came from."""
    out = jax.tree.map(np.array, like)

    def put(tree, name, t):
        path, lead, transpose = convert.reference_location(name)
        for key in path:
            tree = tree[key]
        at = tuple(int(i) for i in name.split(".")[1:1 + lead])
        v = t.detach().to(torch.float32).numpy()
        tree[at] = v.T if transpose else v
    for name, t in state["params"].state_dict().items():
        put(out["params"], name, t)
    for k in ("m", "v", "master"):
        for name, t in state["opt"][k].items():
            put(out["opt"][k], name, t)
    out["opt"]["count"] = np.asarray(int(state["opt"]["count"]), np.int32)
    return out


def _close(got, want, label):
    for k in ("loss", "grad_norm"):
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) / w <= CAP[k], (label, k, g, w)


def test_full_width_loss_swing_equals_reference(start):
    cfg, fn, port_fn = start["cfg"], start["ref_fn"], start["port_fn"]
    ref_state = start["ref_state"]
    state = _port_state(cfg, ref_state)
    ref_loss, port_loss = [], []
    for i, batch in enumerate(_batches(cfg, 32, 2)):
        ref_state, rm = fn(ref_state, batch)
        state, pm = port_fn(state, batch)
        ref_loss.append(float(rm["loss"]))
        port_loss.append(float(pm["loss"]))
        _close(pm, rm, ("step", i))
    print(json.dumps({"tokens": "2x32", "ref": ref_loss, "port": port_loss}))
    # The swing: a later loss well above the first, in both packages.
    assert max(ref_loss[1:]) > ref_loss[0] + 1.0, ref_loss
    assert max(port_loss[1:]) > port_loss[0] + 1.0, port_loss


def test_short_batch_swing_gap_is_rounding(start):
    cfg, fn, port_fn = start["cfg"], start["ref_fn"], start["port_fn"]
    ref0 = start["ref_state"]
    batches = _batches(cfg, 8, 4)
    # The port, free-running; its state after step 1 goes back to the
    # reference's layout.
    state = _port_state(cfg, ref0)
    port, after_one = [], None
    for i, batch in enumerate(batches):
        state, pm = port_fn(state, batch)
        port.append({k: float(pm[k]) for k in ("loss", "grad_norm")})
        if i == 0:
            after_one = _to_reference(state, ref0)
    del state
    # The reference, free-running; at step 4 the port takes the same step
    # from the reference's own state.
    ref, rs, same_state = [], ref0, None
    for i, batch in enumerate(batches):
        if i == STEPS - 1:
            _, same_state = port_fn(_port_state(cfg, rs), batch)
        rs, rm = fn(rs, batch)
        ref.append({k: float(rm[k]) for k in ("loss", "grad_norm")})
    del rs
    # The reference restarted from the port's state after step 1.
    restart, rs = [ref[0]], after_one
    del after_one
    for batch in batches[1:]:
        rs, rm = fn(rs, batch)
        restart.append({k: float(rm[k]) for k in ("loss", "grad_norm")})
    del rs
    print(json.dumps({"tokens": "4x8", "ref": [r["loss"] for r in ref],
                      "port": [p["loss"] for p in port],
                      "ref_from_port_step1": [r["loss"] for r in restart],
                      "port_from_ref_step4": float(same_state["loss"])}))
    _close(port[0], ref[0], "step 0, one state")
    for i in range(1, STEPS):
        _close(port[i], restart[i], ("restarted reference", i))
    _close(same_state, ref[-1], "step 3 from the reference's state")
    assert max(r["loss"] for r in ref[1:]) > ref[0]["loss"] + 1.0, ref
    assert max(p["loss"] for p in port[1:]) > port[0]["loss"] + 1.0, port
