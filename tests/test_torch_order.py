"""The facade's rank into the caller's order (``api._caller_rank``) on the CPU.

``QueryResult.from_result_set`` ranks rows by one sort of int64 values,
``(q_caller * m + entry_idx) << b | row``, and falls back to the two-key
lexsort where those would pass int64.  Every column it returns must be
byte-equal, dtype included, to the lexsort transform written out below,
on the engine's kind of rows (distinct (query, entry) pairs, grouped by
64-query batch and shuffled within each) and on rows that tie, which the
row's position keeps in the lexsort's stable order.  Under
``torch.profiler`` the spans ``order.rank`` and ``order.rank_lexsort``
count the rank and its fallbacks, and land in the ``ExecStats`` given."""
import numpy as np
import pytest
import torch

from repro_torch.api import QueryResult
from repro_torch.core import trace
from repro_torch.core.executor import ExecStats, ResultSet

COLUMNS = ("entry_idx", "entry_traj", "entry_seg", "query_idx", "t_enter",
           "t_exit")


def lexsort_transform(rs: ResultSet, order):
    """The facade's transform before the one-key rank."""
    q_caller = rs.query_idx if order is None else order[rs.query_idx]
    rank = np.lexsort((rs.entry_idx, q_caller))
    return {"entry_idx": rs.entry_idx[rank], "entry_traj": rs.entry_traj[rank],
            "entry_seg": rs.entry_seg[rank], "query_idx": q_caller[rank],
            "t_enter": rs.t_enter[rank], "t_exit": rs.t_exit[rank]}


def engine_rows(n, *, num_queries=700, num_entries=695_000, seed=0,
                ties=0, entry_base=0, idx_dtype=np.int64):
    """``n`` rows of distinct (sorted query, entry) pairs as the compact
    kernel emits them (by 64-query batch, shuffled within); ``ties`` of
    them repeat another row's pair with other intervals."""
    rng = np.random.default_rng(seed)
    q = np.sort(rng.integers(0, num_queries, n))
    e = np.empty(n, np.int64)
    starts = np.searchsorted(q, np.arange(num_queries + 1))
    for i in range(num_queries):
        k = starts[i + 1] - starts[i]
        if k:
            e[starts[i]:starts[i + 1]] = rng.choice(num_entries, k,
                                                    replace=False)
    e += entry_base
    if ties:
        src = rng.choice(n, ties, replace=False)
        dst = rng.choice(np.setdiff1d(np.arange(n), src), ties,
                         replace=False)
        q[dst], e[dst] = q[src], e[src]
    perm = np.concatenate([rng.permutation(np.nonzero(q // 64 == b)[0])
                           for b in np.unique(q // 64)]) if n else q
    q, e = q[perm], e[perm]
    t0 = rng.uniform(0, 100, n).astype(np.float32)
    t1 = (t0 + rng.uniform(0, 5, n)).astype(np.float32)
    return ResultSet(e.astype(idx_dtype), (e // 400).astype(idx_dtype),
                     (e % 400).astype(idx_dtype), q.astype(idx_dtype), t0, t1)


#: name -> (ResultSet, order) builder
CASES = {
    "empty": lambda: (ResultSet.empty(), None),
    "one": lambda: (engine_rows(1), None),
    "one-order": lambda: (engine_rows(1), np.arange(700)[::-1].copy()),
    "4k": lambda: (engine_rows(4096), None),
    "4k-order": lambda: (engine_rows(4096, seed=1),
                         np.random.default_rng(1).permutation(700)),
    "200k": lambda: (engine_rows(200_000, seed=2), None),
    "200k-order": lambda: (engine_rows(200_000, seed=3),
                           np.random.default_rng(3).permutation(700)),
    "4k-int32": lambda: (engine_rows(4096, seed=4, idx_dtype=np.int32),
                         np.random.default_rng(4).permutation(700)
                         .astype(np.int32)),
    "ties": lambda: (engine_rows(4096, seed=5, ties=300), None),
    "ties-order": lambda: (engine_rows(4096, seed=6, ties=300),
                           np.random.default_rng(6).permutation(700)),
    "past-int64": lambda: (engine_rows(4096, seed=7, entry_base=3 ** 25),
                           np.random.default_rng(7).permutation(700)
                           * 3 ** 19),
    # (query, entry) needs 52 bits and the row 12 more: past int64 packed
    "past-int64-packed": lambda: (engine_rows(4096, seed=8,
                                              entry_base=3 ** 15),
                                  np.random.default_rng(8).permutation(700)
                                  * 3 ** 12),
    # 50 bits and 12: values up to 2**62 that fit
    "wide-fits": lambda: (engine_rows(4096, seed=9, entry_base=3 ** 15),
                          np.random.default_rng(9).permutation(700)
                          * 3 ** 10),
}
#: the cases whose rank is the lexsort's fallback
FALLBACK = {"past-int64", "past-int64-packed"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_are_the_lexsort_transforms_bytes(case):
    rs, order = CASES[case]()
    want = lexsort_transform(rs, order)
    got = QueryResult.from_result_set(rs, order=order, d=1.0,
                                      backend="kernel")
    for col in COLUMNS:
        a, b = getattr(got, col), want[col]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), col
        assert a.tobytes() == b.tobytes(), col


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    names = [e.name()[len(trace.PREFIX):]
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    return out, names


@pytest.mark.parametrize("case", ["4k-order", "ties", "wide-fits",
                                  "past-int64", "past-int64-packed"])
def test_spans_count_the_rank_and_its_fallbacks(case):
    rs, order = CASES[case]()
    stats = ExecStats(0.0, 0.0, [], spans={"plan.refine": (1, 0.5)})
    res, names = _profiled(lambda: QueryResult.from_result_set(
        rs, order=order, d=1.0, backend="kernel", stats=stats))
    fallbacks = int(case in FALLBACK)
    assert names.count("order.rank") == 1
    assert names.count("order.rank_lexsort") == fallbacks
    assert res.stats is stats
    calls = {k: c for k, (c, _) in stats.spans.items()}
    want = {"plan.refine": 1, "order.rank": 1}
    if fallbacks:
        want["order.rank_lexsort"] = 1
    assert calls == want
    assert stats.spans["plan.refine"] == (1, 0.5)


def test_no_profiler_no_spans():
    rs, order = CASES["ties"]()
    stats = ExecStats(0.0, 0.0, [])
    QueryResult.from_result_set(rs, order=order, d=1.0, backend="kernel",
                                stats=stats)
    assert stats.spans == {}
