"""The port's synthetic token pipeline (``repro_torch.data.tokens``)
against the reference's rule.

The two packages draw their streams from different generators (the
reference from ``jax.random``, the port from numpy), so the streams
differ and the tests compare the rule: determinism per (step, shard),
disjoint shards, labels shifted by one, the ``i % 8 == 7`` repetition,
the range and dtype, and the Zipf distribution of the draws (both
packages' empirical frequencies against the exact law, within a stated
number of standard errors)."""
import numpy as np
import pytest

from repro.data.tokens import TokenPipeline as RefPipeline
from repro.data.tokens import TokenPipelineConfig as RefConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig


def _draw(batch):
    """The (b, s + 1) draw a batch was cut from."""
    return np.concatenate([batch["tokens"], batch["labels"][:, -1:]], axis=1)


def test_deterministic_per_step_and_shard():
    cfg = TokenPipelineConfig(vocab_size=100, seq_len=8, global_batch=4,
                              num_shards=2, seed=3)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    for step, shard in ((17, 1), (0, 0), (5, 1)):
        a, b = p1.batch_at(step, shard), p2.batch_at(step, shard)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(p1.batch_at(step, shard)["tokens"],
                                      a["tokens"])
    assert not np.array_equal(p1.batch_at(1, 0)["tokens"],
                              p1.batch_at(2, 0)["tokens"])
    other = TokenPipeline(TokenPipelineConfig(
        vocab_size=100, seq_len=8, global_batch=4, num_shards=2, seed=4))
    assert not np.array_equal(other.batch_at(17, 1)["tokens"],
                              p1.batch_at(17, 1)["tokens"])


@pytest.mark.parametrize("pipeline,config", [
    (TokenPipeline, TokenPipelineConfig), (RefPipeline, RefConfig)],
    ids=["port", "reference"])
def test_shards_disjoint_and_global_batch(pipeline, config):
    p = pipeline(config(vocab_size=1000, seq_len=32, global_batch=4,
                        num_shards=2))
    a, b = p.batch_at(0, 0)["tokens"], p.batch_at(0, 1)["tokens"]
    assert not np.array_equal(a, b)
    g = p.global_batch_at(0)
    np.testing.assert_array_equal(g["tokens"], np.concatenate([a, b]))
    assert g["labels"].shape == (4, 32)


@pytest.mark.parametrize("pipeline,config", [
    (TokenPipeline, TokenPipelineConfig), (RefPipeline, RefConfig)],
    ids=["port", "reference"])
def test_labels_shifted_repeat_rule_range_dtype(pipeline, config):
    v, s = 50, 37
    batch = pipeline(config(vocab_size=v, seq_len=s, global_batch=3,
                            seed=9)).batch_at(4, 0)
    t, lab = batch["tokens"], batch["labels"]
    assert t.shape == lab.shape == (3, s)
    assert t.dtype == lab.dtype == np.int32
    np.testing.assert_array_equal(t[:, 1:], lab[:, :-1])
    draw = _draw(batch)
    for i in range(7, s + 1, 8):
        np.testing.assert_array_equal(draw[:, i], draw[:, i - 7])
    assert draw.min() >= 0 and draw.max() < v


def test_shard_out_of_range_raises():
    p = TokenPipeline(TokenPipelineConfig(vocab_size=10, seq_len=4,
                                          global_batch=4, num_shards=2))
    for shard in (-1, 2):
        with pytest.raises(ValueError, match="out of range"):
            p.batch_at(0, shard)
    with pytest.raises(ValueError, match="multiple"):
        TokenPipeline(TokenPipelineConfig(
            vocab_size=10, seq_len=4, global_batch=3,
            num_shards=2)).batch_at(0)


@pytest.mark.parametrize("pipeline,config", [
    (TokenPipeline, TokenPipelineConfig), (RefPipeline, RefConfig)],
    ids=["port", "reference"])
def test_draws_follow_the_zipf_law(pipeline, config):
    """The positions the repetition rule leaves free are drawn from p(r)
    ∝ 1/r: each token's frequency within 5 standard errors of it."""
    v, s, b = 20, 255, 64
    p = pipeline(config(vocab_size=v, seq_len=s, global_batch=b, seed=1))
    free = np.arange(s + 1) % 8 != 7
    draws = np.concatenate([_draw(p.batch_at(step))[:, free].ravel()
                            for step in range(4)])
    want = (1.0 / np.arange(1, v + 1)) / np.sum(1.0 / np.arange(1, v + 1))
    got = np.bincount(draws, minlength=v) / draws.size
    se = np.sqrt(want * (1 - want) / draws.size)
    assert np.all(np.abs(got - want) <= 5 * se), np.abs(got - want) / se
