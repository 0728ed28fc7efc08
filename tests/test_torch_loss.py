"""The port's training losses and their gradients against the
reference's, on the reference's weights (``convert.params_from_jax``)
and batches made with numpy from a seed.

* ``cross_entropy`` and ``chunked_cross_entropy`` (a padded vocabulary
  and a ragged last chunk): the same float32 arithmetic, value and
  gradients within 1e-6 relative.
* ``transformer.loss_fn`` for every architecture at ``.reduced()`` in
  float32, with ``remat`` on and off, against ``jax.value_and_grad`` of
  the reference's ``loss_fn`` (the same ``remat``): the loss, ``ce`` and
  ``moe_aux`` within 1e-6 relative; each parameter's gradient within
  ``GRAD_TOL`` of its largest reference value.  The attention models'
  gradients differ by a few float32 roundings (≤ 2e-6 measured), held
  to 2e-5.  The recurrent patterns carry rounding further: xlstm-350m ≤
  4e-6 measured, held to 5e-5; zamba2-7b's gradient is ill-conditioned
  (multiplying each weight by 1 ± 1e-7 moves it by 1.7e-4 of its
  largest value, and the port lies 1.5e-4 from the reference), held to
  2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as rlayers
from repro.models import transformer as RT
from repro_torch.configs import ARCHS
from repro_torch.models import convert, layers
from repro_torch.models import transformer as T

ALL_ARCHS = sorted(ARCHS)
GRAD_TOL = {"zamba2-7b": 2e-3, "xlstm-350m": 5e-5}
GRAD_TOL_ATTN = 2e-5


def _cfgs(arch):
    return (dataclasses.replace(ARCHS[arch].reduced(), dtype="float32"),
            dataclasses.replace(REF_ARCHS[arch].reduced(), dtype="float32"))


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.normal(size=(b, s, cfg.d_model)
                                         ).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": labels}


def test_cross_entropy_equals_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want, want_g = jax.value_and_grad(rlayers.cross_entropy)(
        jnp.asarray(logits), labels)
    x = torch.from_numpy(logits).requires_grad_()
    got = layers.cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("s,chunk", [(11, 4), (8, 8), (5, 512)])
def test_chunked_cross_entropy_equals_reference(s, chunk):
    """A padded vocabulary (the table's 40 rows, 37 real) and a ragged
    last chunk: the value and the gradients of x and the table."""
    rng = np.random.default_rng(s)
    table = (rng.normal(size=(40, 16)) * 0.3).astype(np.float32)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    labels = rng.integers(0, 37, (2, s)).astype(np.int32)

    def ref(x, table):
        return rlayers.chunked_cross_entropy({"table": table}, x, labels,
                                             chunk=chunk, true_vocab=37)
    want, (gx, gt) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    head = layers.Embedding(40, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        head.table.copy_(torch.from_numpy(table))
    xt = torch.from_numpy(x).requires_grad_()
    got = layers.chunked_cross_entropy(head, xt, torch.from_numpy(labels),
                                       chunk=chunk, true_vocab=37)
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for a, b in ((xt.grad, gx), (head.table.grad, gt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))
    # The pad rows get no gradient: their logits are −1e30.
    assert torch.all(head.table.grad[37:] == 0)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_fn_and_gradients_equal_reference(arch, remat):
    cfg, rcfg = _cfgs(arch)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b, remat=remat), has_aux=True))(
        params, batch)
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    loss, metrics = T.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                              remat=remat)
    assert loss.dtype == metrics["ce"].dtype == torch.float32
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    assert float(metrics["ce"]) == pytest.approx(float(want_m["ce"]),
                                                 rel=1e-6)
    assert float(metrics["moe_aux"]) == pytest.approx(
        float(want_m["moe_aux"]), rel=1e-6, abs=1e-7)
    assert (float(metrics["moe_aux"]) > 0) == cfg.is_moe
    names, params_t = zip(*model.named_parameters())
    # An input-embeddings model never reads its token table: its
    # gradient is zero, as JAX gives it.
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params_t, torch.autograd.grad(loss, params_t, allow_unused=True))]
    ref = convert.params_from_jax(cfg, jax.tree.map(np.asarray, want_g))
    assert set(ref) == set(names)
    tol = GRAD_TOL.get(arch, GRAD_TOL_ATTN)
    for n, g in zip(names, grads):
        scale = float(ref[n].abs().max())
        err = float((g - ref[n]).abs().max())
        assert err <= tol * scale, (n, err, scale)


def test_forward_remat_and_unembed_mask_gradient():
    """``forward`` with and without remat gives the same logits, and the
    gradient through ``unembed``'s −1e30 pad columns (a vocabulary of 250
    in a table of 256) matches the reference's."""
    cfg, rcfg = (dataclasses.replace(c, vocab_size=250)
                 for c in _cfgs("granite-3-2b"))
    assert cfg.padded_vocab_size > cfg.vocab_size
    params = RT.init_params(rcfg, jax.random.PRNGKey(3))
    batch = _batch(cfg, seed=3)
    w = np.random.default_rng(4).normal(size=(2, 16, 250)).astype(
        np.float32)

    def ref(p):
        return jnp.sum(RT.forward(rcfg, p, batch)[0] * w)
    want_g = jax.grad(ref)(params)
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = T.forward(cfg, model, tb, remat=True)
    assert torch.equal(logits, T.forward(cfg, model, tb)[0])
    (logits * torch.from_numpy(w)).sum().backward()
    ref_g = convert.params_from_jax(cfg, jax.tree.map(np.asarray, want_g))
    for n, p in model.named_parameters():
        scale = float(ref_g[n].abs().max())
        assert float((p.grad - ref_g[n]).abs().max()) <= 2e-5 * scale, n
    assert torch.all(model.embed.table.grad[250:] == 0)
