"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the reference's ``repro.models.moe``, on the reference's own weights
carried across by ``convert.params_from_jax`` and inputs made with numpy
from a seed; reduced configs (4 experts, top-2, d 64).

Tolerances are ``tests/test_torch_llm.py``'s: ``atol=rtol=1e-5`` in
float32 (the same arithmetic in another summation order) and 3e-2 in
bf16.  The bf16 layer rounds the gate and up products to bf16 before the
SiLU, as the port's dense MLP does, where the reference keeps them in
float32: a few bf16 steps on outputs of magnitude about 1.  Routing runs
in float32 in both, so the load-balance loss agrees within 1e-6 in both
dtypes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import moe as rmoe
from repro.models import transformer as RT
from repro_torch.configs import ARCHS
from repro_torch.models import convert, moe
from repro_torch.models import transformer as T

CPU = "cpu"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
MOE_ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
DTYPES = ("float32", "bfloat16")


@functools.lru_cache(maxsize=None)
def _world(arch, dtype, capacity_factor=None):
    """(port cfg, ref cfg, ref params, port model) on one seed."""
    kw = dict(dtype=dtype)
    if capacity_factor is not None:
        kw["capacity_factor"] = capacity_factor
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **kw)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    model = T.LM(cfg, device=CPU)
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return cfg, rcfg, params, model


def _ref_moe(params, i=0):
    return jax.tree.map(lambda a: a[i], params["layers"])["moe"]


def _x(cfg, shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, cfg.dtype)),
            jnp.asarray(x, jnp.dtype(cfg.dtype)))


def _kw(cfg, capacity_factor):
    return dict(num_experts=cfg.num_experts,
                experts_per_token=cfg.experts_per_token,
                capacity_factor=capacity_factor)


def _both(cfg, params, model, xt, xj, capacity_factor, layer=0):
    got = moe.moe_apply(model.layers[layer].moe, xt,
                        **_kw(cfg, capacity_factor))
    want = rmoe.moe_apply(_ref_moe(params, layer), xj,
                          **_kw(cfg, capacity_factor))
    return got, want


def _dropped(cfg, model, xt, capacity_factor) -> int:
    """Assignments past their expert's capacity, from the port's
    routing."""
    _, _, _, slot, cap = moe.route(
        model.layers[0].moe.router, xt.reshape(-1, cfg.d_model),
        **_kw(cfg, capacity_factor))
    return int((slot == cfg.num_experts * cap).sum())


# ----------------------------------------------------------------------
# moe_apply against the reference.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, dtype, capacity_factor):
    """64 tokens: at 8.0 every assignment fits; at 0.5 the buffer holds
    half of the 128 assignments, so drops are certain."""
    cfg, _, params, model = _world(arch, dtype)
    xt, xj = _x(cfg, (2, 32, cfg.d_model), seed=1)
    dropped = _dropped(cfg, model, xt, capacity_factor)
    if capacity_factor == 8.0:
        assert dropped == 0
    else:
        assert dropped >= 1
    (y, aux), (want_y, want_aux) = _both(cfg, params, model, xt, xj,
                                         capacity_factor)
    assert y.dtype == xt.dtype and tuple(y.shape) == want_y.shape
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y, np.float32), **TOL[dtype])
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_route_to_the_lower_expert_first(dtype):
    """An all-zero row gives E equal probabilities: jax's ``top_k`` takes
    experts 0..k-1, in that order, and so must the port.  A router with
    two equal columns ties those two experts on every row."""
    cfg, _, params, model = _world("qwen3-moe-30b-a3b", dtype)
    k = cfg.experts_per_token
    xt, xj = _x(cfg, (2, 8, cfg.d_model), seed=2)
    xt[0, 3] = 0
    xj = xj.at[0, 3].set(0)
    _, _, experts, _, _ = moe.route(model.layers[0].moe.router,
                                    xt.reshape(-1, cfg.d_model),
                                    **_kw(cfg, 1.25))
    assert experts[3].tolist() == list(range(k))
    (y, aux), (want_y, want_aux) = _both(cfg, params, model, xt, xj, 1.25)
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y, np.float32), **TOL[dtype])
    assert abs(float(aux) - float(want_aux)) <= 1e-6

    # experts 1 and 2 tied on every row: where both fit in the top k,
    # expert 1 comes first; where one fits, it is expert 1
    tied = moe.MoE(cfg.d_model, cfg.d_ff, cfg.num_experts,
                   dtype=xt.dtype, device=CPU).requires_grad_(False)
    tied.load_state_dict(model.layers[0].moe.state_dict())
    tied.router[:, 2] = tied.router[:, 1]
    ref = dict(_ref_moe(params))
    ref["router"] = ref["router"].at[:, 2].set(ref["router"][:, 1])
    _, _, experts, _, _ = moe.route(tied.router, xt.reshape(-1, cfg.d_model),
                                    **_kw(cfg, 1.25))
    rows = [r for r in experts.tolist() if 1 in r or 2 in r]
    assert rows
    for r in rows:
        assert 1 in r and (2 not in r or r.index(1) < r.index(2)), r
    y, aux = moe.moe_apply(tied, xt, **_kw(cfg, 1.25))
    want_y, want_aux = rmoe.moe_apply(ref, xj, **_kw(cfg, 1.25))
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y, np.float32), **TOL[dtype])
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("tokens,k,e,cf,cap", [
    (8192, 8, 128, 1.25, 640),      # qwen3's prefill of 8 × 1,024 tokens
    (8, 8, 128, 1.25, 8),           # a qwen3 decode step of 8 tokens
    (64, 2, 4, 0.5, 16), (24, 2, 4, 1.25, 16), (13, 2, 4, 8.0, 56)])
def test_capacity(tokens, k, e, cf, cap):
    """The reference's capacity arithmetic (``moe.py:66-69``): tokens ·
    k · factor / E rounded up, at least 8, then up to a multiple of 8."""
    assert moe.capacity(tokens, k, e, cf) == cap


def test_moe_layer_reads_nothing_on_the_host(monkeypatch):
    """The layer never brings a value to the host (no ``item``,
    ``tolist``, ``nonzero``, boolean-mask indexing, Python truth or
    number of a tensor): on the card each would be a sync."""
    cfg, _, _, model = _world("qwen3-moe-30b-a3b", "bfloat16")
    xt, _ = _x(cfg, (2, 32, cfg.d_model), seed=3)

    def refuse(*args, **kwargs):
        raise AssertionError("host read inside the MoE layer")
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__", "__array__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    monkeypatch.setattr(torch, "masked_select", refuse)
    y, aux = moe.moe_apply(model.layers[0].moe, xt, **_kw(cfg, 0.5))
    monkeypatch.undo()
    assert torch.isfinite(y).all() and torch.isfinite(aux)


# ----------------------------------------------------------------------
# Parameters.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_shaped_as_converted_reference(arch):
    """In a bf16 model: the state dict of ``init_params`` has the shapes
    and dtypes of ``convert.params_from_jax`` on the reference's params
    (the router float32), and the expert weights' spread is
    1/sqrt(d_in), the reference's ``he_init``."""
    cfg = ARCHS[arch].reduced()
    assert cfg.dtype == "bfloat16"
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    ref = jax.tree.map(np.asarray, RT.init_params(REF_ARCHS[arch].reduced(),
                                                  jax.random.PRNGKey(0)))
    state = convert.params_from_jax(cfg, ref)
    mine = model.state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in mine.items()}
    layer = model.layers[0].moe
    assert layer.router.dtype == torch.float32
    assert layer.gate.dtype == torch.bfloat16
    for name in ("router", "gate", "up", "down"):
        p = getattr(layer, name).float()
        fan_in = p.shape[0] if name == "router" else p.shape[1]
        assert abs(float(p.std()) * fan_in ** 0.5 - 1) < 0.1, name
        want = np.asarray(ref["layers"]["moe"][name][0], np.float32)
        assert abs(float(want.std()) * fan_in ** 0.5 - 1) < 0.1, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_counts(arch):
    """The reference's counts at full size; the layer module holds
    exactly ``moe_param_count``'s parameters."""
    cfg = ARCHS[arch]
    assert moe.moe_param_count(cfg.d_model, cfg.d_ff, cfg.num_experts) == \
        rmoe.moe_param_count(cfg.d_model, cfg.d_ff, cfg.num_experts)
    assert moe.moe_active_param_count(
        cfg.d_model, cfg.d_ff, cfg.experts_per_token) == \
        rmoe.moe_active_param_count(cfg.d_model, cfg.d_ff,
                                    cfg.experts_per_token)
    layer = moe.MoE(cfg.d_model, cfg.d_ff, cfg.num_experts,
                    dtype=torch.bfloat16, device="meta")
    assert sum(p.numel() for p in layer.parameters()) == \
        moe.moe_param_count(cfg.d_model, cfg.d_ff, cfg.num_experts)


def test_router_stays_float32_through_convert():
    """A router weight that bf16 cannot hold arrives unrounded."""
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    ref = jax.tree.map(np.asarray, RT.init_params(
        REF_ARCHS["qwen3-moe-30b-a3b"].reduced(), jax.random.PRNGKey(0)))
    router = np.asarray(ref["layers"]["moe"]["router"])
    assert router.dtype == np.float32
    state = convert.params_from_jax(cfg, ref)
    got = state["layers.1.moe.router"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), router[1])
    assert not torch.equal(got, got.bfloat16().float())
    np.testing.assert_array_equal(
        state["layers.0.moe.down"].float().numpy(),
        np.asarray(ref["layers"]["moe"]["down"][0], np.float32))


# ----------------------------------------------------------------------
# The model: prefill then decode equals forward (the reference's
# tests/test_models.py::test_prefill_decode_match_forward).
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_match_forward(arch):
    """At ``capacity_factor`` 8.0 no token drops, so a 12-token prefill
    and a 1-token decode route as the 13-token forward does."""
    cfg, _, _, model = _world(arch, "bfloat16", 8.0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    logits_f, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    logits_p, cache = T.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                                max_len=16)
    np.testing.assert_allclose(logits_p.numpy(), logits_f.detach().numpy(), atol=3e-2)
    nxt = logits_p[:, -1].argmax(-1)
    lg_dec, _ = T.decode_step(cfg, model, cache, nxt, 12)
    toks2 = np.concatenate([toks, nxt.numpy()[:, None]], 1)
    lg_full, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(toks2)})
    np.testing.assert_allclose(lg_dec.numpy(), lg_full[:, -1].detach().numpy(),
                               atol=3e-2)
