"""The reduced models shared by the port's recurrent-block tests: the
reference's parameters (``init_params`` on ``PRNGKey(0)``) carried into
the port's ``LM`` by ``convert.params_from_jax``, and seeded activations
given to both frameworks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as RT
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import transformer as T

#: float32: the same arithmetic in another summation order; bf16: the
#: reference's own tolerance between its bf16 paths
#: (``tests/test_models.py``), as ``tests/test_torch_llm.py`` states it.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
#: The chunked scan against its step-by-step oracle: the reference's own
#: tolerance (``tests/test_linear_rnn.py``).
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def world(arch: str, dtype: str):
    """(port cfg, ref cfg, ref params, port model), reduced, on one seed."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype)
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), dtype=dtype)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return cfg, rcfg, params, model


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol: dict) -> None:
    np.testing.assert_allclose(np32(got), np32(want), **tol)


def both(shape, dtype: str, seed: int = 0, scale: float = 1.0):
    """The same seeded normal activations in both frameworks, rounded
    once to ``dtype`` (to nearest even in both)."""
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, jnp.dtype(dtype)))
