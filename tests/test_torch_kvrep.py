"""KV-head replication (``cfg.kv_replication``) in the port against the
reference, on the reference's weights carried across by
``convert.params_from_jax`` and batches made with numpy from a seed.

* ``kv_replication_for``: the reference's cases and its whole grid.
* ``forward`` and ``loss_fn`` at r = 2 on reduced granite-3-2b (4 heads
  over 2 KV heads: the kernel sees g 1) and qwen3-moe-30b-a3b, float32
  and bf16, against the reference at r = 2: within
  ``tests/_torch_models.TOL`` (float32 1e-5, bf16 3e-2, as
  ``test_torch_llm.py`` holds ``forward``); the loss within 1e-6
  relative in float32.  And invariant to r in float32 within 1e-4, the
  reference's own bound (``tests/test_models.py``).
* The gradients at r = 2 within ``test_torch_loss.py``'s 2e-5 of each
  parameter's largest reference value.
* ``prefill`` and ``decode_step`` under r = 2 equal to r = 1 bit for bit:
  prefill forces r = 1, so the cache holds the true KV heads.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as rattention
from repro.models import transformer as RT
from repro_torch.configs import ARCHS
from repro_torch.models import attention, convert
from repro_torch.models import transformer as T

from _torch_models import TOL, close

ARCHS_R2 = ["granite-3-2b", "qwen3-moe-30b-a3b"]
DTYPES = ["float32", "bfloat16"]
#: The reference's own bound on the r-invariance (``tests/test_models.py``).
INVARIANCE_TOL = 1e-4
#: ``test_torch_loss.py``'s bound for the attention models' gradients.
GRAD_TOL = 2e-5


def _world(arch: str, dtype: str, r: int):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype,
                              kv_replication=r)
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), dtype=dtype,
                               kv_replication=r)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return cfg, rcfg, params, model


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_kv_replication_for_matches_reference():
    """The reference's cases (``tests/test_models.py``), then its whole
    grid of head counts and TP widths."""
    cases = {(32, 8, 16): 2, (32, 4, 16): 4, (32, 32, 16): 1,
             (24, 2, 16): 1, (48, 8, 16): 2}
    for args, want in cases.items():
        assert attention.kv_replication_for(*args) == want
    for h in (4, 8, 12, 16, 24, 32, 48, 64):
        for kvh in (1, 2, 4, 8, 16, 32):
            if h % kvh:
                continue
            for tp in (1, 2, 4, 8, 16):
                assert attention.kv_replication_for(h, kvh, tp) == \
                    rattention.kv_replication_for(h, kvh, tp), (h, kvh, tp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS_R2)
def test_forward_at_r2_matches_reference(arch, dtype):
    cfg, rcfg, params, model = _world(arch, dtype, 2)
    batch = _batch(cfg)
    want, want_aux = RT.forward(rcfg, params, {"tokens": batch["tokens"]})
    with torch.no_grad():
        got, aux = T.forward(cfg, model, _torch({"tokens": batch["tokens"]}))
    close(got, want, TOL[dtype])
    close(aux, want_aux, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS_R2)
def test_loss_fn_at_r2_matches_reference(arch, dtype):
    cfg, rcfg, params, model = _world(arch, dtype, 2)
    batch = _batch(cfg, seed=1)
    want, want_m = RT.loss_fn(rcfg, params, batch, remat=True)
    with torch.no_grad():
        got, got_m = T.loss_fn(cfg, model, _torch(batch), remat=True)
    rel = 1e-6 if dtype == "float32" else TOL[dtype]["rtol"]
    assert float(got) == pytest.approx(float(want), rel=rel)
    assert float(got_m["ce"]) == pytest.approx(float(want_m["ce"]), rel=rel)


@pytest.mark.parametrize("arch", ARCHS_R2)
def test_output_invariant_to_r(arch):
    """The reference's ``test_kv_replication_math_invariant`` on the port:
    r is a layout setting, the function is the same."""
    cfg, _, _, model = _world(arch, "float32", 1)
    cfg2 = dataclasses.replace(cfg, kv_replication=2)
    tokens = _torch(_batch(cfg))["tokens"]
    with torch.no_grad():
        base, _ = T.forward(cfg, model, {"tokens": tokens})
        rep, _ = T.forward(cfg2, model, {"tokens": tokens})
        l1, _ = T.loss_fn(cfg, model, _torch(_batch(cfg)))
        l2, _ = T.loss_fn(cfg2, model, _torch(_batch(cfg)))
    np.testing.assert_allclose(rep.numpy(), base.numpy(),
                               atol=INVARIANCE_TOL)
    assert float(l2) == pytest.approx(float(l1), abs=INVARIANCE_TOL)


@pytest.mark.parametrize("arch", ARCHS_R2)
def test_gradients_at_r2_match_reference(arch):
    cfg, rcfg, params, model = _world(arch, "float32", 2)
    batch = _batch(cfg, seed=2)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b, remat=True), has_aux=True))(
        params, batch)
    loss, _ = T.loss_fn(cfg, model, _torch(batch), remat=True)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    ref = convert.params_from_jax(cfg, jax.tree.map(np.asarray, want_g))
    for n, g in zip(names, grads):
        scale = float(ref[n].abs().max())
        err = float((g - ref[n]).abs().max())
        assert err <= GRAD_TOL * scale, (n, err, scale)


@pytest.mark.parametrize("arch", ARCHS_R2)
def test_prefill_and_decode_ignore_r(arch):
    """Prefill forces r = 1: the cache holds the true KV heads, and the
    logits of prefill and of a decode step are those of r = 1."""
    cfg, _, _, model = _world(arch, "float32", 1)
    cfg2 = dataclasses.replace(cfg, kv_replication=2)
    tokens = _torch(_batch(cfg))["tokens"]
    out = []
    for c in (cfg, cfg2):
        logits, cache = T.prefill(c, model, {"tokens": tokens}, 20)
        assert cache["k"].shape == (cfg.num_layers, 2, 20, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
        step, cache = T.decode_step(c, model, cache, tokens[:, 0], 16)
        out.append((logits, step, cache["k"], cache["v"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_replication_must_divide_the_group():
    """r must divide the group size, as the reference asserts."""
    cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"].reduced(),
                              dtype="float32", kv_replication=3)
    model = T.LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="kv_repeat=3"):
        T.forward(cfg, model, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.long)})
