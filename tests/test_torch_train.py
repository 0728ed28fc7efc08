"""The port's training substrate (``repro_torch.train``) against the
reference's ``repro.train`` on the same numpy inputs: AdamW and its
schedules, the train step (one and three steps, microbatches),
checkpoints in the shared on-disk format, and gradient compression.

Tolerances, float32 unless stated:

* Schedules, ``global_norm``, ``apply_updates``: the same float32
  operations on the same inputs, leaf by leaf: within 1e-6 relative.
* The train step, from the reference's own state carried across by
  ``convert.train_state_from_jax``: the reference's step taken once more
  from weights moved by one float32 rounding (each multiplied by 1 ±
  2^-23) shows how far rounding alone carries each quantity (the
  control).  The loss and gradient norm (relative) and ``m`` and ``v``
  (relative to each leaf's largest reference moment) must stay within
  ``SPREAD_FACTOR`` times the control's spread or a floor, and never
  beyond ``CAP``, which is below what one wrong update gives.  Adam's
  first steps are sign-like, so a gradient coordinate near zero whose
  sign differs between two float32 computations moves a master weight
  by up to 2·lr: the master weights more than 0.05·lr from the
  reference's may number at most ``SPREAD_FACTOR`` times the control's
  (none for the attention models, whose masters all stay within
  0.02·lr; a wrong update moves most of a leaf that far).  Reduced
  zamba2-7b is ill-conditioned: one rounding moves its gradient norm by
  9e-5 after one step and by 12 % after three, with 293 master
  coordinates flipped and its moments 38 % apart, so three steps cannot
  tell a wrong update from rounding there; it is compared after one
  step only, the other four after one and after three.
* Microbatches 1 against 4: the reference's own test's bounds (loss
  within 1e-4 relative, master weights within 2.5·lr).
* Checkpoints: bit for bit.  Compression: the codecs' arithmetic is the
  same float32 operations, so payloads, scales and residuals are equal.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.data.tokens import TokenPipelineConfig as RefPipelineConfig
from repro.train import checkpoint as ref_ckpt
from repro.train import compress as ref_compress
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import ARCHS
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels import distthresh as dt
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compress
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

CPU = "cpu"
STEP_ARCHS = ["granite-3-2b", "starcoder2-3b", "qwen3-moe-30b-a3b",
              "zamba2-7b", "xlstm-350m"]
SPREAD_FACTOR = 10.0
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: Floors of the step comparison: the master weights absolute; the loss
#: and gradient norm relative; m and v relative to each leaf's largest.
FLOOR = {"m": 1e-5, "v": 1e-5, "master": 0.05 * OPT["lr"], "loss": 1e-6,
         "grad_norm": 1e-5}
#: Ceilings on the spread-scaled tolerances, in FLOOR's units.
CAP = {"m": 1e-2, "v": 1e-2, "loss": 1e-4, "grad_norm": 1e-2}
#: Steps (0-based) after which each architecture's state is compared.
CHECKED_STEPS = {"zamba2-7b": (0,)}


def _f32(arch: str):
    return (dataclasses.replace(ARCHS[arch].reduced(), dtype="float32"),
            dataclasses.replace(REF_ARCHS[arch].reduced(), dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------
# Optimizer.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_equals_reference(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule,
              wsd_decay_frac=0.2)
    fn = opt_lib.schedule_fn(opt_lib.AdamWConfig(**kw))
    ref = ref_opt.schedule_fn(ref_opt.AdamWConfig(**kw))
    for count in range(0, 111):
        got = fn(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-7)


def test_schedule_shapes():
    """The reference's own shape checks, on the port's schedules."""
    cos = opt_lib.schedule_fn(opt_lib.AdamWConfig(
        lr=1.0, warmup_steps=10, total_steps=100, schedule="cosine"))
    assert float(cos(0)) == pytest.approx(0.0)
    assert float(cos(10)) == pytest.approx(1.0)
    assert float(cos(100)) == pytest.approx(0.0, abs=1e-6)
    assert float(cos(55)) == pytest.approx(0.5, abs=0.02)
    wsd = opt_lib.schedule_fn(opt_lib.AdamWConfig(
        lr=1.0, warmup_steps=10, total_steps=100, schedule="wsd",
        wsd_decay_frac=0.2))
    assert float(wsd(40)) == pytest.approx(1.0)
    assert float(wsd(79)) == pytest.approx(1.0)
    assert float(wsd(90)) < 1.0
    assert float(wsd(100)) == pytest.approx(0.0, abs=1e-3)
    const = opt_lib.schedule_fn(opt_lib.AdamWConfig(
        lr=2.0, warmup_steps=4, schedule="constant"))
    assert [float(const(c)) for c in (0, 2, 4, 1000)] == [0.0, 1.0, 2.0, 2.0]
    with pytest.raises(ValueError):
        opt_lib.schedule_fn(opt_lib.AdamWConfig(schedule="linear"))


def _tree(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)).astype(dtype),
            "b": {"c": rng.normal(size=(7,)).astype(dtype),
                  "d": rng.normal(size=(2, 2, 5)).astype(dtype)}}


def _flat(tree, prefix=""):
    """A nested dict as the flat {name: torch tensor} the port's optimizer
    takes (sorted keys, as the reference flattens it)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = torch.from_numpy(np.array(v, np.float32))
    return out


def test_global_norm_equals_reference():
    g = _tree(1)
    want = float(ref_opt.global_norm(g))
    assert float(opt_lib.global_norm(_flat(g))) == pytest.approx(
        want, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_equals_reference(dtype):
    """Three AdamW steps (the first clipped) on the same parameters and
    gradients: parameters, moments, master, count, lr and the pre-clip
    norm."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)),
                          _tree(0))
    state = ref_opt.init_state(params)
    tp = {n: t.to(getattr(torch, dtype)) for n, t in _flat(params).items()}
    tstate = opt_lib.init_state(tp)
    for i in range(3):
        grads = jax.tree.map(lambda a: a * (30.0 if i == 0 else 1.0),
                             _tree(10 + i))
        params, state, m = ref_opt.apply_updates(
            ref_opt.AdamWConfig(**cfg), params, grads, state)
        tp, tstate, tm = opt_lib.apply_updates(
            opt_lib.AdamWConfig(**cfg), tp, _flat(grads), tstate)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(m["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(m["lr"]), rel=1e-6)
        assert int(tstate["count"]) == int(state["count"]) == i + 1
        for k in ("m", "v", "master"):
            for n, want in _flat(_np(state[k])).items():
                got = tstate[k][n]
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-7)
        for n, want in _flat(_np(params)).items():
            # New parameters are the master cast to their dtype; one
            # float32 rounding of the master may cross a bf16 boundary.
            assert tp[n].dtype == getattr(torch, dtype)
            assert torch.equal(tp[n], tstate["master"][n].to(tp[n].dtype))
            np.testing.assert_allclose(
                tp[n].float().numpy(), want.numpy(),
                rtol=1e-6 if dtype == "float32" else 2.0 ** -8)


def test_grad_clip_reports_preclip_norm():
    params = {"w": torch.ones(4)}
    state = opt_lib.init_state(params)
    _, _, metrics = opt_lib.apply_updates(
        opt_lib.AdamWConfig(lr=0.0, grad_clip=1.0, weight_decay=0.0),
        params, {"w": torch.full((4,), 1e6)}, state)
    assert float(metrics["grad_norm"]) > 1e5


# ----------------------------------------------------------------------
# The train step against the reference's.
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_step(arch: str, microbatches: int = 1):
    _, rcfg = _f32(arch)
    return jax.jit(ref_step.make_train_step(
        rcfg, ref_opt.AdamWConfig(**OPT), microbatches=microbatches))


def _perturbed(state):
    """The reference's state with every weight moved by one float32
    rounding (× (1 ± 2^-23), seeded signs) and a fresh optimizer."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: (np.asarray(x) * (1 + 2.0 ** -23 * rng.choice(
            [-1, 1], size=np.shape(x)))).astype(np.float32),
        state["params"])
    return {"params": params, "opt": ref_opt.init_state(params)}


def _opt_leaves(cfg, ref_state) -> dict:
    """The reference state's m, v and master by the port's names."""
    return convert.train_state_from_jax(cfg, _np(ref_state),
                                        device=CPU)["opt"]


def _max_rel_diff(a: dict, b: dict) -> float:
    """The largest difference of ``a`` from ``b``, each leaf's relative
    to its largest ``|b|``."""
    return max(float((a[n] - b[n]).abs().max()
                     / b[n].abs().max().clamp_min(1e-30)) for n in a)


def _n_beyond(a: dict, b: dict, limit: float) -> int:
    """How many coordinates of ``a`` lie more than ``limit`` from
    ``b``'s."""
    return sum(int(((a[n] - b[n]).abs() > limit).sum()) for n in a)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    """One and three steps of the port's ``make_train_step`` from
    ``train_state_from_jax`` of the reference's initial state, against
    the reference's jitted step on the same batches."""
    cfg, rcfg = _f32(arch)
    ref_state = ref_step.init_train_state(rcfg, jax.random.PRNGKey(0))
    control = _perturbed(ref_state)
    state = convert.train_state_from_jax(cfg, _np(ref_state), device=CPU)
    pipe = RefPipeline(RefPipelineConfig(vocab_size=cfg.vocab_size,
                                         seq_len=16, global_batch=8))
    ref_fn = _ref_step(arch)
    port_fn = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(**OPT))
    for i in range(3):
        batch = pipe.global_batch_at(i)
        ref_state, rm = ref_fn(ref_state, batch)
        control, cm = ref_fn(control, batch)
        state, pm = port_fn(state, batch)
        if i not in CHECKED_STEPS.get(arch, (0, 2)):
            continue
        assert int(state["opt"]["count"]) == int(ref_state["opt"]["count"])
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        for k in ("loss", "grad_norm", "ce", "moe_aux"):
            assert pm[k].dtype == torch.float32
        for k in ("loss", "grad_norm"):
            want = float(rm[k])
            spread = abs(float(cm[k]) - want) / want
            tol = min(max(FLOOR[k], SPREAD_FACTOR * spread), CAP[k])
            assert abs(float(pm[k]) - want) / want <= tol, (k, i)
        want, ctl = _opt_leaves(cfg, ref_state), _opt_leaves(cfg, control)
        for k in ("m", "v"):
            tol = min(max(FLOOR[k], SPREAD_FACTOR
                          * _max_rel_diff(ctl[k], want[k])), CAP[k])
            got = _max_rel_diff(state["opt"][k], want[k])
            assert got <= tol, (k, i, got, tol)
        flipped = _n_beyond(state["opt"]["master"], want["master"],
                            FLOOR["master"])
        allowed = SPREAD_FACTOR * _n_beyond(ctl["master"], want["master"],
                                            FLOOR["master"])
        assert flipped <= allowed, ("master", i, flipped, allowed)


def test_microbatches_1_and_4_agree():
    """The reference's ``test_microbatch_equivalence`` on the port, and
    the port's microbatched step against the reference's."""
    cfg, rcfg = _f32("starcoder2-3b")
    pipe = RefPipeline(RefPipelineConfig(vocab_size=cfg.vocab_size,
                                         seq_len=16, global_batch=8))
    batch = pipe.global_batch_at(0)
    ref0 = ref_step.init_train_state(rcfg, jax.random.PRNGKey(0))
    masters, losses = [], []
    for mb in (1, 4):
        state = convert.train_state_from_jax(cfg, _np(ref0), device=CPU)
        state, m = step_lib.make_train_step(
            cfg, opt_lib.AdamWConfig(**OPT), microbatches=mb)(state, batch)
        masters.append(state["opt"]["master"])
        losses.append(float(m["loss"]))
        if mb == 4:
            ref_state, rm = _ref_step("starcoder2-3b", 4)(ref0, batch)
            assert float(m["ce"]) == pytest.approx(float(rm["ce"]),
                                                   rel=1e-5)
            assert float(m["grad_norm"]) == pytest.approx(
                float(rm["grad_norm"]), rel=1e-5)
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    for n in masters[0]:
        np.testing.assert_allclose(masters[0][n].numpy(),
                                   masters[1][n].numpy(),
                                   atol=2.5 * OPT["lr"])


def test_loss_decreases():
    """The reference's ``test_loss_decreases``: granite-3-2b reduced (bf16),
    six steps at lr 3e-3 on the port's own token pipeline."""
    cfg = ARCHS["granite-3-2b"].reduced()
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=50))
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))
    losses = []
    for i in range(6):
        state, m = step(state, pipe.global_batch_at(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert int(state["opt"]["count"]) == 6


def test_step_refusals():
    cfg = ARCHS["granite-3-2b"].reduced()
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    even = np.zeros((2, 8), np.int32)
    with pytest.raises(ValueError, match="activation_sharding"):
        step_lib.make_train_step(cfg, opt_lib.AdamWConfig(), grad_specs={})(
            state, {"tokens": even, "labels": even})
    toks = np.zeros((3, 8), np.int32)
    with pytest.raises(ValueError, match="multiple"):
        step_lib.make_train_step(cfg, opt_lib.AdamWConfig(),
                                 microbatches=2)(
            state, {"tokens": toks, "labels": toks})


def test_train_state_specs_allocate_nothing():
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    specs = step_lib.train_state_specs(cfg)
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    named = dict(state["params"].named_parameters())
    assert list(specs["params"]) == list(named)
    for n, p in named.items():
        s = specs["params"][n]
        assert s.device.type == "meta"
        assert (s.shape, s.dtype) == (p.shape, p.dtype)
        for k in ("m", "v", "master"):
            t = specs["opt"][k][n]
            assert t.device.type == "meta" and t.dtype == torch.float32
            assert state["opt"][k][n].shape == p.shape
    assert specs["opt"]["count"].dtype == torch.int32
    assert specs["opt"]["count"].shape == ()


def test_train_state_from_jax_keeps_float32_moments():
    """bf16 model: parameters in bf16 (the float32 ones as ``convert``
    keeps them), m, v and master float32, count int32."""
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    rcfg = REF_ARCHS["qwen3-moe-30b-a3b"].reduced()
    ref = ref_step.init_train_state(rcfg, jax.random.PRNGKey(0))
    ref["opt"]["count"] = jnp.int32(5)
    state = convert.train_state_from_jax(cfg, _np(ref), device=CPU)
    params = dict(state["params"].named_parameters())
    assert params["layers.0.attn.wq.weight"].dtype == torch.bfloat16
    assert params["layers.0.moe.router"].dtype == torch.float32
    for k in ("m", "v", "master"):
        assert set(state["opt"][k]) == set(params)
        assert all(t.dtype == torch.float32
                   for t in state["opt"][k].values())
    np.testing.assert_array_equal(
        state["opt"]["master"]["layers.1.attn.wo.weight"].numpy(),
        np.asarray(ref["opt"]["master"]["layers"]["attn"]["wo"][1]).T)
    assert state["opt"]["count"].dtype == torch.int32
    assert int(state["opt"]["count"]) == 5


# ----------------------------------------------------------------------
# Checkpoints.
# ----------------------------------------------------------------------
def _mixed_state():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 3, 5).to(torch.bfloat16)},
            "n": torch.tensor(7, dtype=torch.int32)}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])


def test_roundtrip_and_gc(tmp_path):
    root = str(tmp_path)
    state = _mixed_state()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(root, step, state, meta={"step": step}, keep=3)
    assert ckpt.all_steps(root) == [3, 4, 5]
    assert ckpt.latest_step(root) == 5
    restored, step, meta = ckpt.restore(root, state, device=CPU)
    assert step == 5 and meta == {"step": 5}
    _assert_same(restored, state)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names == ["['a']", "['b']['c']", "['n']"]


def test_no_partial_checkpoint_visible(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, ".tmp.step_00000009"))
    ckpt.save(root, 1, {"a": torch.zeros(2)})
    assert ckpt.all_steps(root) == [1]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), {"a": torch.zeros(2)},
                     device=CPU)


def test_restore_specific_step_and_refuse_other_structure(tmp_path):
    root = str(tmp_path)
    for step in (1, 2):
        ckpt.save(root, step, {"a": torch.full((2,), float(step))})
    restored, step, _ = ckpt.restore(root, {"a": torch.zeros(2)}, step=1,
                                    device=CPU)
    assert step == 1
    assert torch.equal(restored["a"], torch.ones(2))
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore(root, {"b": torch.zeros(2)}, device=CPU)


def test_each_package_restores_the_others_checkpoint(tmp_path):
    state = _mixed_state()
    ref_state = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                 "b": {"c": jnp.linspace(-2, 3, 5).astype(jnp.bfloat16)},
                 "n": jnp.int32(7)}
    ckpt.save(str(tmp_path / "port"), 3, state, meta={"by": "port"})
    got, step, meta = ref_ckpt.restore(str(tmp_path / "port"), ref_state)
    assert step == 3 and meta == {"by": "port"}
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    ref_ckpt.save(str(tmp_path / "ref"), 4, ref_state, meta={"by": "ref"})
    got, step, meta = ckpt.restore(str(tmp_path / "ref"), state,
                                     device=CPU)
    assert step == 4 and meta == {"by": "ref"}
    _assert_same(got, state)


def test_train_state_resume_bitexact(tmp_path):
    """Crash and restart: the resumed run equals the uninterrupted one bit
    for bit (the reference's test holds it within 1e-6)."""
    cfg = ARCHS["granite-3-2b"].reduced()
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20))
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    for i in range(2):
        state, _ = step(state, pipe.global_batch_at(i))
    ckpt.save(str(tmp_path), 2, state)
    for i in range(2, 4):
        state, _ = step(state, pipe.global_batch_at(i))
    resumed, at, _ = ckpt.restore(str(tmp_path), state, device=CPU)
    assert isinstance(resumed["params"], T.LM)
    assert resumed["params"] is not state["params"]
    for i in range(at, 4):
        resumed, _ = step(resumed, pipe.global_batch_at(i))
    for n, w in state["opt"]["master"].items():
        assert torch.equal(resumed["opt"]["master"][n], w), n
    for (n, p), (_, q) in zip(state["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(p, q), n


# ----------------------------------------------------------------------
# Gradient compression.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compress_leaf_equals_reference(codec):
    rng = np.random.default_rng(2)
    g = rng.normal(size=(37,)).astype(np.float32)
    e = (rng.normal(size=(37,)) * 1e-3).astype(np.float32)
    q, scale, e_new = compress.compress_leaf(torch.from_numpy(g),
                                             torch.from_numpy(e), codec)
    rq, rscale, re_new = ref_compress.compress_leaf(jnp.asarray(g),
                                                    jnp.asarray(e), codec)
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(rq, np.float32))
    assert str(q.dtype).split(".")[-1] == str(rq.dtype)
    if codec == "int8":
        assert float(scale) == float(rscale)
    else:
        assert scale is None and rscale is None
    np.testing.assert_array_equal(e_new.numpy(), np.asarray(re_new))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_error_feedback_unbiased(codec):
    """Accumulated compressed means converge to the true mean."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                         .astype(np.float32))
    e = compress.init_error_state({"g": g})["g"]
    acc = torch.zeros_like(g)
    steps = 50
    for _ in range(steps):
        q, scale, e = compress.compress_leaf(g, e, codec)
        acc += compress._dequantize(q, scale, codec)
    np.testing.assert_allclose((acc / steps).numpy(), g.numpy(), atol=5e-3)


def test_train_step_on_cpu_launches_nothing():
    before = dict(dt.LAUNCHES)
    cfg = ARCHS["granite-3-2b"].reduced()
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    toks = np.ones((2, 8), np.int32)
    step_lib.make_train_step(cfg, opt_lib.AdamWConfig())(
        state, {"tokens": toks, "labels": toks})
    assert dict(dt.LAUNCHES) == before
