"""Continuous-batching scheduler reusing the paper's batch algorithms (the
reference's ``repro/serve/batcher.py``, copied; only the imports differ).

The paper's core trade-off — per-invocation overhead Θ vs. wasteful
interactions from over-large batches (§6) — is exactly the LLM serving
batching trade-off: small batches pay dispatch/compile overhead per step,
large batches pay *padding waste* (every sequence is padded to the batch
max).  The mapping is mechanical:

    query segment        ↔ request (sorted by prompt length)
    temporal extent      ↔ [0, prompt_len]
    candidate count |E|  ↔ padded length  max(prompt_len in batch)
    numInts = |Q|·|E|    ↔ padded tokens = |batch|·max_len   (the waste)

so PERIODIC / SETSPLIT / GREEDYSETSPLIT run **unchanged** over a
duck-typed index whose ``num_candidates([t0, t1]) = ⌈t1⌉``: merging two
batches increases cost exactly by the padding the merge introduces.  The
§8 model's role (pick a good s) is played by :func:`pick_batch_size`,
which charges a measured per-invocation overhead Θ against padded-token
throughput.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import batching
from repro_torch.core.segments import SegmentArray


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


class PaddingCostIndex:
    """Duck-typed stand-in for TemporalBinIndex: candidates = padded length."""

    def num_candidates(self, qt0: float, qt1: float) -> int:
        return int(np.ceil(qt1))

    def num_candidates_batch(self, qt0, qt1) -> np.ndarray:
        return np.ceil(np.asarray(qt1)).astype(np.int64)

    def candidate_range_batch(self, qt0, qt1):
        last = np.ceil(np.asarray(qt1)).astype(np.int64) - 1
        return np.zeros_like(last), last


def requests_as_segments(requests: list[Request]) -> tuple[SegmentArray, np.ndarray]:
    """Encode requests as sortable 'query segments': ts = te = prompt_len.

    Returns (segments sorted by length, permutation into the request list).
    """
    lens = np.array([r.prompt_len for r in requests], np.float32)
    order = np.argsort(lens, kind="stable")
    z = np.zeros(len(requests), np.float32)
    segs = SegmentArray(z, z.copy(), z.copy(), z.copy(), z.copy(), z.copy(),
                        lens[order], lens[order],
                        seg_id=np.arange(len(requests), dtype=np.int32),
                        traj_id=np.asarray(order, dtype=np.int32))
    return segs, order


def plan_batches(requests: list[Request], algorithm: str = "greedysetsplit-min",
                 **params) -> list[list[int]]:
    """Partition requests into execution batches with a paper algorithm.

    Returns lists of request indices (into the original request list).
    """
    if not requests:
        return []
    segs, order = requests_as_segments(requests)
    idx = PaddingCostIndex()
    fn = batching.ALGORITHMS[algorithm]
    plan = fn(idx, segs, **params)
    return [[int(order[i]) for i in range(b.q_first, b.q_last + 1)]
            for b in plan.batches]


def padded_tokens(requests: list[Request], batches: list[list[int]]) -> int:
    """Total padded prompt tokens across batches (the waste metric)."""
    total = 0
    for batch in batches:
        mx = max(requests[i].prompt_len for i in batch)
        total += mx * len(batch)
    return total


def pick_batch_size(requests: list[Request], theta_seconds: float,
                    tokens_per_second: float,
                    candidates=(1, 2, 4, 8, 16, 32, 64)) -> tuple[int, dict]:
    """§8-style model: min over s of  Θ·ceil(N/s) + padded_tokens(s)/rate."""
    best_s, best_t, table = candidates[0], float("inf"), {}
    for s in candidates:
        batches = plan_batches(requests, "periodic", s=s)
        t = (theta_seconds * len(batches)
             + padded_tokens(requests, batches) / tokens_per_second)
        table[s] = t
        if t < best_t:
            best_s, best_t = s, t
    return best_s, table
