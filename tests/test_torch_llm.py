"""The port's LLM serving path against the reference, on the reference's
own weights carried across by ``convert.params_from_jax`` and inputs made
with numpy from a seed.

Two dtypes per architecture (reduced: granite-3-2b and starcoder2-3b, the
swiglu and the gelu MLP; qwen3-moe-30b-a3b, mixture-of-experts layers
with ``qk_norm`` and ``rope_theta`` 1e6; musicgen-large, embedding
inputs; zamba2-7b, Mamba2 layers and a shared attention block; and
xlstm-350m, mLSTM and sLSTM layers):

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
* The recurrent patterns' caches hold the chunked scan's states, and in
  float32 are held to the scan's own ``atol=rtol=1e-4``
  (``tests/test_linear_rnn.py``).  zamba2-7b in bf16 cannot meet 3e-2
  against the reference, and neither can the reference against itself:
  on the same bf16 weights its bf16 result lies up to 0.038 (logits) and
  0.26 (shared-attention KV) from its float32 result, because one bf16
  step that an attention or scan output rounds differently (the two
  frameworks' float32 sums differ in order) is carried through every
  later Mamba2 layer.  So there each output is held to 3e-2 plus that
  spread, measured on the same inputs in the test: max |port − ref| ≤
  3e-2 + max |ref_bf16 − ref_f32|.  A Mamba2 block alone meets 3e-2
  exactly (``tests/test_torch_ssm.py``); xlstm-350m meets 3e-2.

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

from _torch_models import SCAN_TOL, TOL
from _torch_models import world as _world
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
DTYPES = ("float32", "bfloat16")
#: The dense token-input models (those with an ``mlp``).
CASES = [(arch, dtype) for arch in ("granite-3-2b", "starcoder2-3b")
         for dtype in DTYPES]
#: The attn-pattern models the port runs: the dense ones, MoE and
#: embedding inputs.
MODEL_CASES = CASES + [(arch, dtype) for arch in ("qwen3-moe-30b-a3b",
                                                  "musicgen-large")
                       for dtype in DTYPES]
#: The recurrent block patterns: zamba (Mamba2 + shared attention) and
#: xlstm.
RECURRENT = ("zamba2-7b", "xlstm-350m")
ALL_CASES = MODEL_CASES + [(arch, dtype) for arch in RECURRENT
                           for dtype in DTYPES]
#: Held in bf16 to 3e-2 plus the reference's own bf16-vs-f32 spread (the
#: module docstring).
SPREAD_ARCHS = ("zamba2-7b",)


def _cfg(arch, dtype):
    return dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype)


def _ref_cfg(arch, dtype):
    return dataclasses.replace(REF_ARCHS[arch].reduced(), dtype=dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _ref_f32(arch):
    """The reference in float32 on the bf16 model's weights: (cfg,
    params)."""
    _, rcfg, params, _ = _world(arch, "bfloat16")
    return (dataclasses.replace(rcfg, dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), params))


def _leaves(cache: dict) -> list:
    """A cache's tensors by sorted key, tuples (the sLSTM carry) opened."""
    return [x for k in sorted(cache) for x in
            (cache[k] if isinstance(cache[k], tuple) else (cache[k],))]


def _shapes(cache: dict) -> dict:
    return {k: tuple(tuple(x.shape) for x in v) if isinstance(v, tuple)
            else tuple(v.shape) for k, v in cache.items()}


def _close_model(arch, dtype, got, want, want_f32=None, *, state=False):
    """``got`` against the reference's ``want``: TOL, or for a recurrent
    model's float32 ``state`` the scan's tolerance, or for
    ``SPREAD_ARCHS`` in bf16 3e-2 plus the reference's own spread from
    ``want_f32`` (its float32 result on the same weights)."""
    if dtype == "bfloat16" and arch in SPREAD_ARCHS:
        spread = float(np.abs(_np(want) - _np(want_f32)).max())
        diff = float(np.abs(_np(got) - _np(want)).max())
        assert diff <= TOL[dtype]["atol"] + spread, (diff, spread)
    elif state and dtype == "float32" and arch in RECURRENT:
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)
    else:
        _close(got, want, dtype)


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


def _uncounted(cfg) -> int:
    """What ``param_count`` (the reference's arithmetic) leaves out: the
    RMSNorm scales (the final one; two per attention layer, and with
    ``qk_norm`` a q and a k norm of the head dim; one per Mamba2, mLSTM
    or sLSTM layer) and the xLSTM forget biases (H per mLSTM layer, D per
    sLSTM layer)."""
    d = cfg.d_model
    if cfg.block_pattern == "zamba":        # one shared attention layer
        return (cfg.num_layers + 2 + 1) * d
    if cfg.block_pattern == "xlstm":
        g = cfg.num_layers // cfg.xlstm_slstm_every
        m_per = cfg.xlstm_slstm_every - 1
        return (cfg.num_layers + 1) * d + g * m_per * cfg.num_heads + g * d
    norms = (2 * cfg.num_layers + 1) * d
    if cfg.qk_norm:
        norms += 2 * cfg.num_layers * cfg.resolved_head_dim
    return norms


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b",
                                  "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                                  "musicgen-large", "zamba2-7b",
                                  "xlstm-350m"])
def test_model_holds_param_count_plus_norm_scales(arch):
    """``param_count`` leaves out the norm scales (and the xLSTM forget
    biases); the module holds exactly those on top."""
    cfg = ARCHS[arch].reduced()
    model = T.LM(cfg, device=CPU)
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + _uncounted(cfg)


# ----------------------------------------------------------------------
# Layers, with the reference's weights.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_rmsnorm(arch, dtype):
    cfg, _, params, model = _world(arch, dtype)
    xt, xj = _x(cfg, (2, 5, cfg.d_model))
    _close(model.layers[1].ln2(xt),
           rlayers.rmsnorm(_layer(params, 1)["ln2"], xj), dtype)


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
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


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
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


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
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


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
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


def _inputs(cfg, b=2, s=12, seed=1):
    """The same model inputs for both: (port's, reference's) tokens (B, S)
    or, for ``input_mode="embeddings"``, float32 embeddings (B, S, D)
    (or (B, D) for ``s=None``, a decode step's)."""
    if cfg.input_mode == "embeddings":
        shape = (b, cfg.d_model) if s is None else (b, s, cfg.d_model)
        x = np.random.default_rng(seed).normal(size=shape).astype(
            np.float32)
    else:
        x = _tokens(cfg, b, s, seed)
    return torch.from_numpy(x), jnp.asarray(x)


def _batch(cfg, x):
    return {"embeddings" if cfg.input_mode == "embeddings" else "tokens": x}


@pytest.mark.parametrize("arch,dtype", ALL_CASES)
def test_forward(arch, dtype):
    """Logits, and the MoE auxiliary loss summed over the layers (0
    without experts)."""
    cfg, rcfg, params, model = _world(arch, dtype)
    xt, xj = _inputs(cfg)
    got, aux = T.forward(cfg, model, _batch(cfg, xt))
    want, want_aux = RT.forward(rcfg, params, _batch(cfg, xj))
    want_f32 = None
    if dtype == "bfloat16" and arch in SPREAD_ARCHS:
        want_f32, _ = RT.forward(*_ref_f32(arch), _batch(cfg, xj))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) > 0) == cfg.is_moe
    _close_model(arch, dtype, got, want, want_f32)
    _close(aux, want_aux, dtype)


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("arch,dtype", ALL_CASES)
def test_prefill_then_decode(arch, dtype, last_only):
    """Logits and every cache entry after the prefill and after one
    decode step; the cache's keys and shapes (and dtypes) are those of
    the reference's ``init_cache``."""
    cfg, rcfg, params, model = _world(arch, dtype)
    spread = dtype == "bfloat16" and arch in SPREAD_ARCHS
    xt, xj = _inputs(cfg)
    got, cache = T.prefill(cfg, model, _batch(cfg, xt), max_len=16,
                           last_only=last_only)
    want, wcache = RT.prefill(rcfg, params, _batch(cfg, xj), max_len=16,
                              last_only=last_only)
    w32 = c32 = None
    if spread:
        w32, c32 = RT.prefill(*_ref_f32(arch), _batch(cfg, xj), max_len=16,
                              last_only=last_only)
    assert tuple(got.shape) == want.shape
    assert _shapes(cache) == _shapes(wcache) == _shapes(
        RT.init_cache(rcfg, 2, 16))
    _close_model(arch, dtype, got, want, w32)

    def check_cache(cache, wcache, c32):
        for i, (a, b) in enumerate(zip(_leaves(cache), _leaves(wcache))):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            _close_model(arch, dtype, a, b,
                         None if c32 is None else _leaves(c32)[i],
                         state=True)
    check_cache(cache, wcache, c32)
    if cfg.input_mode == "embeddings":
        nt, nj = _inputs(cfg, s=None, seed=2)
    else:
        nxt = np.argmax(_np(want[:, -1]), -1).astype(np.int32)
        nt, nj = torch.from_numpy(nxt), jnp.asarray(nxt)
    got, cache = T.decode_step(cfg, model, cache, nt, 12)
    want, wcache = RT.decode_step(rcfg, params, wcache, nj, jnp.int32(12))
    if spread:
        w32, c32 = RT.decode_step(*_ref_f32(arch), c32, nj, jnp.int32(12))
    _close_model(arch, dtype, got, want, w32)
    check_cache(cache, wcache, c32)


def test_embedding_inputs_skip_the_table_and_its_scale():
    """musicgen's first hidden state is its embeddings in the model
    dtype: neither ``embed_scale`` nor the token table touches them."""
    cfg = dataclasses.replace(ARCHS["musicgen-large"].reduced(),
                              embed_scale=3.0)
    model = T.LM(cfg, device=CPU)
    xt, _ = _inputs(cfg)
    assert torch.equal(T._embed(cfg, model, xt), xt.to(torch.bfloat16))


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_draws_recurrent_layers_as_reference(dtype):
    """The reference's ``mamba2_init``: ``A_log`` and ``dt_bias`` 0, ``D``
    1, all float32, ``conv`` normal × 0.1 (not 1/sqrt(fan_in), the
    generic rule: 0.088 here, 0.012 at full width), ``norm_scale`` 1; its
    ``mlstm_init`` and ``slstm_init``: forget biases 3 and the gate and
    recurrent weights float32.  Shapes and dtypes equal ``convert``'s of
    the reference's own init."""
    gen = torch.Generator().manual_seed(0)
    for arch in RECURRENT:
        cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype)
        model = T.init_params(cfg, generator=gen, device=CPU)
        state = model.state_dict()
        ref = convert.params_from_jax(cfg, jax.tree.map(
            np.asarray, RT.init_params(_ref_cfg(arch, dtype),
                                       jax.random.PRNGKey(0))))
        assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} \
            == {k: (tuple(v.shape), v.dtype) for k, v in ref.items()}
        if arch == "zamba2-7b":
            mods = [lay.mamba for grp in model.mamba_groups for lay in grp]
            mods += [lay.mamba for lay in model.mamba_tail]
            for m in mods:
                for p, want in ((m.A_log, 0.0), (m.dt_bias, 0.0),
                                (m.D, 1.0)):
                    assert p.dtype == torch.float32 and (p == want).all()
                assert (m.norm_scale == 1).all()
            conv = torch.cat([m.conv.float().flatten() for m in mods])
            assert abs(float(conv.std()) - 0.1) < 0.005
            assert abs(float(conv.mean())) < 0.005
        else:
            for grp in model.mlstm:
                for lay in grp:
                    assert (lay.mlstm.f_bias == 3).all()
                    assert lay.mlstm.wif.weight.dtype == torch.float32
            for lay in model.slstm:
                assert (lay.slstm.f_bias == 3).all()
                assert lay.slstm.r.dtype == torch.float32
                dh = cfg.d_model // cfg.num_heads
                assert abs(float(lay.slstm.r.std()) * dh ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-7b",
                                  "xlstm-350m"])
def test_params_from_jax_keeps_float32_parameters(arch):
    """In a bf16 model every parameter ``convert._FLOAT32`` names stays
    float32 and equal to the reference's array (unrounded); every other
    is bf16."""
    cfg = ARCHS[arch].reduced()
    assert cfg.dtype == "bfloat16"
    params = jax.tree.map(np.asarray, RT.init_params(
        REF_ARCHS[arch].reduced(), jax.random.PRNGKey(0)))
    state = convert.params_from_jax(cfg, params)
    kept = {k for k in state
            if any(k.endswith("." + n) for n in convert._FLOAT32)}
    assert kept
    for k, v in state.items():
        assert v.dtype == (torch.float32 if k in kept else torch.bfloat16), k
    for k in kept:
        parts = k.split(".")
        tree, rest = params[parts[0]], parts[1:]
        idx = []
        while rest and rest[0].isdigit():
            idx.append(int(rest.pop(0)))
        for key in rest:
            if key != "weight":
                tree = tree[key]
        want = tree[tuple(idx)] if idx else tree
        got = state[k].numpy()
        assert np.array_equal(got.T if k.endswith(".weight") else got,
                              want), k


# ----------------------------------------------------------------------
# Serving.
# ----------------------------------------------------------------------
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(10, 27))]


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b",
                                  "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b", "xlstm-350m"])
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


def _no_graph(x) -> None:
    for t in (x if isinstance(x, (tuple, list)) else [x]):
        if isinstance(t, dict):
            for v in t.values():
                _no_graph(v)
        elif isinstance(t, torch.Tensor):
            assert not t.requires_grad and t.grad_fn is None


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b",
                                  "xlstm-350m"])
def test_serving_builds_no_graph(arch, monkeypatch):
    """The parameters require gradients (the model trains), yet
    ``prefill``, ``decode_step`` and ``ServeEngine.generate`` build no
    autograd graph: their outputs and caches carry no ``grad_fn``."""
    cfg = ARCHS[arch].reduced()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    assert all(p.requires_grad for p in model.parameters())
    toks = {"tokens": torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])}
    logits, cache = T.prefill(cfg, model, toks, max_len=8)
    _no_graph([logits, cache])
    step, cache = T.decode_step(cfg, model, cache, torch.tensor([1, 2]), 4)
    _no_graph([step, cache])
    seen = []
    for name in ("prefill", "decode_step"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _real=real, **kw: (
            seen.append(_real(*a, **kw)), seen[-1])[1])
    ServeEngine(cfg, model, max_len=16, device=CPU).generate(
        PROMPTS[:2], max_new_tokens=3)
    assert len(seen) == 4
    _no_graph(seen)


def test_generate_refuses_embedding_inputs():
    """musicgen takes embeddings, so there is no token to feed back; the
    reference's ``generate`` fails there with a ``KeyError``."""
    cfg, _, _, model = _world("musicgen-large", "float32")
    eng = ServeEngine(cfg, model, max_len=64, device=CPU)
    with pytest.raises(ValueError, match="embeddings"):
        eng.generate(PROMPTS, max_new_tokens=2)


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
