"""The port's flash-attention wrapper and its plain version against the
reference's Pallas kernel (interpret mode) and its jnp oracle, on the
same numpy inputs.

Tolerances: float32 ``atol=1e-5``, the reference's own for its kernel
against its oracle (``tests/test_kernels.py``): the same online softmax in
float32, with sums taken in another order.  bf16 ``atol=2**-6``: both
sides compute in float32 from the same bf16 inputs and round once to
bf16, so they differ by at most one bf16 step (2^-7 relative), which is
below 2^-6 for outputs under 4 in magnitude (averages of standard normal
values).

The CUDA kernel takes head dims 16, 32, 64 and 128 only, and so does the
wrapper on every device; where the reference's test shapes use hd = 8,
these use 16.  The kernel itself is held against the plain version on the
card by ``chip_smoke.py`` (phase kernels).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flashattn_pallas, flashattn_ref
from repro_torch.kernels import distthresh as dt
from repro_torch.kernels.flashattn import flashattn, flashattn_plain

F32_ATOL = 1e-5
BF16_ATOL = 2 ** -6


def _inputs(rng, bkv, g, s, t, hd):
    q = rng.normal(size=(bkv * g, s, hd)).astype(np.float32)
    k = rng.normal(size=(bkv, t, hd)).astype(np.float32)
    v = rng.normal(size=(bkv, t, hd)).astype(np.float32)
    return q, k, v


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("bkv,g,s,t,hd,bq,bk", [
    (2, 2, 16, 16, 16, 8, 8),
    (1, 4, 32, 32, 16, 16, 8),
    (2, 1, 8, 16, 16, 8, 8),        # windowed: S < T
    (1, 2, 64, 64, 32, 32, 32),
])
def test_plain_matches_pallas_and_ref(bkv, g, s, t, hd, bq, bk):
    rng = np.random.default_rng(bkv * 100 + s)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    want_pallas = np.asarray(flashattn_pallas(q, k, v, g=g, blk_q=bq,
                                              blk_k=bk))
    want_ref = np.asarray(flashattn_ref(q, k, v, g=g))
    got = flashattn_plain(*_torch(q, k, v), g=g).numpy()
    np.testing.assert_allclose(got, want_pallas, atol=F32_ATOL)
    np.testing.assert_allclose(got, want_ref, atol=F32_ATOL)


@pytest.mark.parametrize("g,hd", [(1, 16), (4, 64)])
def test_plain_bf16_matches_pallas(g, hd):
    rng = np.random.default_rng(3)
    q, k, v = _inputs(rng, 2, g, 16, 16, hd)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flashattn_pallas(jq, jk, jv, g=g, blk_q=8, blk_k=8),
                      np.float32)
    got = flashattn_plain(*_torch(q, k, v, dtype=torch.bfloat16), g=g)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("bkv,g,s,t,hd", [
    (2, 2, 13, 13, 16),             # S = T, not a multiple of any block
    (1, 3, 7, 29, 32),              # windowed and ragged
    (2, 4, 70, 200, 64),            # several ragged KV blocks
    (1, 1, 65, 130, 128),
])
def test_plain_matches_ref_at_ragged_lengths(bkv, g, s, t, hd):
    """Lengths the Pallas kernel cannot take (it needs block multiples)."""
    rng = np.random.default_rng(s * 7 + t)
    q, k, v = _inputs(rng, bkv, g, s, t, hd)
    want = np.asarray(flashattn_ref(q, k, v, g=g))
    got = flashattn_plain(*_torch(q, k, v), g=g).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(5)
    q, k, v = _torch(*_inputs(rng, 2, 2, 20, 33, 16))
    before = dt.LAUNCHES["flashattn"]
    got = flashattn(q, k, v, g=2)
    assert torch.equal(got, flashattn_plain(q, k, v, g=2))
    assert torch.equal(flashattn(q, k, v, g=2, device="cpu"), got)
    assert dt.LAUNCHES["flashattn"] == before


@pytest.mark.parametrize("case,err", [
    ("hd8", ValueError), ("s_gt_t", ValueError), ("bad_g", ValueError),
    ("mixed_dtype", TypeError), ("f16", TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, err):
    rng = np.random.default_rng(0)
    shapes = {"hd8": (1, 2, 8, 8, 8), "s_gt_t": (1, 2, 9, 8, 16)}
    q, k, v = _torch(*_inputs(rng, *shapes.get(case, (1, 2, 8, 8, 16))))
    g = 3 if case == "bad_g" else 2
    if case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    if case == "f16":
        q, k, v = (x.half() for x in (q, k, v))
    with pytest.raises(err):
        flashattn(q, k, v, g=g)
    with pytest.raises(err):
        flashattn_plain(q, k, v, g=g)


def test_wrapper_refuses_tensor_on_other_device():
    q = torch.zeros((2, 8, 16), device="meta")
    k = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="but device=cpu"):
        flashattn(q, k, k, g=2, device="cpu")
