"""The port's LLM serving path against the reference, on the reference's
own weights carried across by ``convert.params_from_jax`` and inputs made
with numpy from a seed.

Two dtypes per architecture (granite-3-2b and starcoder2-3b, reduced: the
swiglu and the gelu MLP):

* float32 (``dataclasses.replace(cfg, dtype="float32")``): the same
  float32 arithmetic in another summation order; ``atol=rtol=1e-5`` on
  values below 2 in magnitude (two layers of products over 64 to 128
  terms, each about 1e-7 relative apart; the logits differ by under 5e-7),
  and greedy tokens identical.
* bfloat16 (the configs' dtype): ``atol=3e-2``, the reference's own
  tolerance between its bf16 paths (``tests/test_models.py``): the two
  frameworks round intermediate bf16 values at different places; plus
  ``rtol=3e-2`` for the second layer's cached keys and values, of
  magnitude near 1, where a few bf16 steps (2^-8 to 2^-7 each) of the
  first layer's rounding add up.

Attention itself runs through ``kernels.flashattn``'s plain version here
(the tensors lie on the CPU); the CUDA kernel is held against it on the
card by ``chip_smoke.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import transformer as RT
from repro.serve import batcher as rbatcher
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import ARCHS
from repro_torch.models import attention, convert, layers
from repro_torch.models import transformer as T
from repro_torch.serve import batcher
from repro_torch.serve.engine import ServeEngine

CPU = "cpu"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
CASES = [(arch, dtype) for arch in ("granite-3-2b", "starcoder2-3b")
         for dtype in ("float32", "bfloat16")]


def _cfg(arch, dtype):
    return dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype)


def _ref_cfg(arch, dtype):
    return dataclasses.replace(REF_ARCHS[arch].reduced(), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _world(arch, dtype):
    """(port cfg, ref cfg, ref params, port model) on one seed."""
    cfg, rcfg = _cfg(arch, dtype), _ref_cfg(arch, dtype)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    model = T.LM(cfg, device=CPU)
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return cfg, rcfg, params, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _x(cfg, shape, seed=0):
    """The same activations in both frameworks (rounded once to the
    dtype, to nearest even in both)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, cfg.dtype)),
            jnp.asarray(x, jnp.dtype(cfg.dtype)))


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


# ----------------------------------------------------------------------
# Configs.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_reference(arch, reduced):
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b"])
def test_model_holds_param_count_plus_norm_scales(arch):
    """``param_count`` (the reference's arithmetic) leaves out the norm
    scales; the module holds exactly those on top."""
    cfg = ARCHS[arch].reduced()
    model = T.LM(cfg, device=CPU)
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + norms


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-350m",
                                  "zamba2-7b", "musicgen-large"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="A.13"):
        T.LM(ARCHS[arch].reduced(), device=CPU)


# ----------------------------------------------------------------------
# Layers, with the reference's weights.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype", CASES)
def test_rmsnorm(arch, dtype):
    cfg, _, params, model = _world(arch, dtype)
    xt, xj = _x(cfg, (2, 5, cfg.d_model))
    _close(model.layers[1].ln2(xt),
           rlayers.rmsnorm(_layer(params, 1)["ln2"], xj), dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_rope(arch, dtype):
    cfg = _cfg(arch, dtype)
    hd = cfg.resolved_head_dim
    xt, xj = _x(cfg, (2, 9, 3, hd), seed=1)
    pos = np.arange(9)[None].repeat(2, 0) + np.array([[0], [1000]])
    got = layers.apply_rope(xt, torch.from_numpy(pos), cfg.rope_theta)
    want = rlayers.apply_rope(xj, jnp.asarray(pos, jnp.int32),
                              cfg.rope_theta)
    _close(got, want, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_mlp(arch, dtype):
    cfg, _, params, model = _world(arch, dtype)
    xt, xj = _x(cfg, (2, 5, cfg.d_model), seed=2)
    _close(model.layers[0].mlp(xt),
           rlayers.mlp(_layer(params, 0)["mlp"], xj, cfg.mlp_type), dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_embed_and_unembed(arch, dtype):
    cfg, _, params, model = _world(arch, dtype)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    _close(model.embed(torch.from_numpy(tokens)),
           rlayers.embed(params["embed"], jnp.asarray(tokens)), dtype)
    xt, xj = _x(cfg, (2, 3, cfg.d_model), seed=3)
    got = model.output_head().unembed(xt, cfg.vocab_size)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    want = rlayers.unembed(head, xj, cfg.vocab_size)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got[..., cfg.vocab_size:] == -1e30).all()
    _close(got, want, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_attention_block(arch, dtype):
    cfg, _, params, model = _world(arch, dtype)
    xt, xj = _x(cfg, (2, 11, cfg.d_model), seed=4)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
              qk_norm=cfg.qk_norm, return_kv=True)
    pos = np.arange(11)[None].repeat(2, 0)
    got, (gk, gv) = attention.attention_block(
        model.layers[0].attn, xt, torch.from_numpy(pos), **kw)
    want, (wk, wv) = rattn.attention_block(
        _layer(params, 0)["attn"], xj, jnp.asarray(pos, jnp.int32), **kw)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        _close(a, b, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_attention_decode(arch, dtype):
    cfg, _, params, model = _world(arch, dtype)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kt, kj = _x(cfg, (2, 10, kvh, hd), seed=5)
    vt, vj = _x(cfg, (2, 10, kvh, hd), seed=6)
    xt, xj = _x(cfg, (2, 1, cfg.d_model), seed=7)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=kvh, head_dim=hd,
              rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    cache = {"k": kt.clone(), "v": vt.clone()}
    got, cache = attention.attention_decode(model.layers[1].attn, xt, cache,
                                            6, **kw)
    want, wcache = rattn.attention_decode(
        _layer(params, 1)["attn"], xj, {"k": kj, "v": vj}, jnp.int32(6),
        **kw)
    _close(got, want, dtype)
    for key in ("k", "v"):
        _close(cache[key], wcache[key], dtype)


@pytest.mark.parametrize("s,t,kvh,g,chunk", [
    (16, 16, 2, 3, 8), (32, 32, 4, 1, 16), (8, 24, 2, 2, 8)])
def test_chunked_causal_attention_matches_reference(s, t, kvh, g, chunk):
    """``tests/test_models.py``'s cases, at hd = 16 (the kernel's
    smallest head dim; those cases use 8)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, s, kvh, g, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, kvh, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, kvh, 16)).astype(np.float32)
    got = attention.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == q.shape
    ref = rattn.chunked_causal_attention(q, k, v, chunk)
    naive = rattn.naive_causal_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(naive), atol=1e-5)
    mine = attention.naive_causal_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(mine.numpy(), np.asarray(naive), atol=1e-5)


# ----------------------------------------------------------------------
# The model: forward, prefill, decode.
# ----------------------------------------------------------------------
def _tokens(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward(arch, dtype):
    cfg, rcfg, params, model = _world(arch, dtype)
    toks = _tokens(cfg)
    got, aux = T.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    want, _ = RT.forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, dtype)


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_then_decode(arch, dtype, last_only):
    cfg, rcfg, params, model = _world(arch, dtype)
    toks = _tokens(cfg)
    got, cache = T.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                           max_len=16, last_only=last_only)
    want, wcache = RT.prefill(rcfg, params, {"tokens": jnp.asarray(toks)},
                              max_len=16, last_only=last_only)
    assert tuple(got.shape) == want.shape
    _close(got, want, dtype)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == wcache[key].shape
        _close(cache[key], wcache[key], dtype)
    nxt = np.argmax(_np(want[:, -1]), -1).astype(np.int32)
    got, cache = T.decode_step(cfg, model, cache, torch.from_numpy(nxt), 12)
    want, wcache = RT.decode_step(rcfg, params, wcache, jnp.asarray(nxt),
                                  jnp.int32(12))
    _close(got, want, dtype)
    for key in ("k", "v"):
        _close(cache[key], wcache[key], dtype)


def test_init_params_is_seeded_and_shaped_as_reference():
    cfg = ARCHS["granite-3-2b"].reduced()
    a = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device=CPU)
    b = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device=CPU)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    ref = jax.tree.map(np.asarray, RT.init_params(
        REF_ARCHS["granite-3-2b"].reduced(), jax.random.PRNGKey(0)))
    state = convert.params_from_jax(cfg, ref)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert (a.layers[0].ln1.scale == 1).all()


# ----------------------------------------------------------------------
# Serving.
# ----------------------------------------------------------------------
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(10, 27))]


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b"])
def test_generate_greedy_equals_reference(arch):
    cfg, rcfg, params, model = _world(arch, "float32")
    got = ServeEngine(cfg, model, max_len=64, device=CPU).generate(
        PROMPTS, max_new_tokens=6)
    want = RefServeEngine(rcfg, params, max_len=64).generate(
        PROMPTS, max_new_tokens=6)
    assert got == want


def test_generation_runs_and_is_deterministic():
    """``tests/test_serve.py``'s checks, on the port."""
    cfg = ARCHS["starcoder2-3b"].reduced()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    eng = ServeEngine(cfg, model, max_len=64, device=CPU)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    o1 = eng.generate(prompts, max_new_tokens=4)
    o2 = eng.generate(prompts, max_new_tokens=4)
    assert o1 == o2
    assert [len(o) for o in o1] == [7, 9]
    assert all(0 <= t < cfg.vocab_size for o in o1 for t in o)
    s1 = eng.generate(prompts, max_new_tokens=4, temperature=1.0, seed=3)
    s2 = eng.generate(prompts, max_new_tokens=4, temperature=1.0, seed=3)
    assert s1 == s2 and [len(o) for o in s1] == [7, 9]
    assert all(0 <= t < cfg.vocab_size for o in s1 for t in o)


def test_serve_engine_refuses_model_on_other_device():
    cfg = ARCHS["granite-3-2b"].reduced()
    model = T.LM(cfg, device=CPU).to("meta")
    with pytest.raises(ValueError, match="model on meta"):
        ServeEngine(cfg, model, device=CPU)


def _requests(mod, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, list(rng.integers(1, 50, rng.integers(2, 30))),
                        max_new_tokens=4) for i in range(n)]


@pytest.mark.parametrize("alg,kw", [
    ("periodic", {"s": 8}),
    ("setsplit-fixed", {"num_batches": 5}),
    ("setsplit-max", {"max_size": 16}),
    ("greedysetsplit-min", {"bound": 4}),
    ("greedysetsplit-max", {"bound": 16}),
])
def test_batcher_equals_reference(alg, kw):
    reqs, rreqs = _requests(batcher), _requests(rbatcher)
    got = batcher.plan_batches(reqs, alg, **kw)
    assert got == rbatcher.plan_batches(rreqs, alg, **kw)
    assert sorted(i for b in got for i in b) == list(range(len(reqs)))
    assert batcher.padded_tokens(reqs, got) == rbatcher.padded_tokens(
        rreqs, got)


@pytest.mark.parametrize("theta,rate", [(10.0, 1e9), (1e-9, 1e3),
                                        (1e-3, 1e5)])
def test_pick_batch_size_equals_reference(theta, rate):
    got = batcher.pick_batch_size(_requests(batcher), theta, rate)
    want = rbatcher.pick_batch_size(_requests(rbatcher), theta, rate)
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for s in got[1]:
        assert got[1][s] == pytest.approx(want[1][s], rel=1e-12)
