"""The port's streaming path (``TrajectoryDB.query_stream`` through the
deadline scheduler) and its §8 performance model against the reference,
on one world made from the same numpy seed in both packages (800 random
entry segments, 96 queries, d = 4, periodic s = 16, 64 bins).

Rows: indices exact, intervals within ``rtol=1e-4, atol=1e-3``
(``tests/test_torch_api.py``).  Scheduler groups and the count-based
model inputs (exact β, per-epoch α) must equal the reference's exactly.
"""
import sys
import threading
import time

import numpy as np
import pytest

import repro.api as R
from conftest import random_segments
from repro.core import perfmodel as rperf
from repro.core.scheduler import DeadlineScheduler as RefScheduler
from repro_torch import state
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core import perfmodel
from repro_torch.core.batching import periodic
from repro_torch.core.scheduler import DeadlineScheduler
from repro_torch.kernels import distthresh as dt

RTOL, ATOL = 1e-4, 1e-3
CPU = "cpu"
INDEX_FIELDS = ("entry_idx", "entry_traj", "entry_seg", "query_idx")
POLICY = dict(num_bins=64, batching="periodic", batch_params={"s": 16})


def assert_same_rows(got, want, label=""):
    assert len(got) == len(want), (label, len(got), len(want))
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{label}:{f}")
    for f in ("t_enter", "t_exit"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}:{f}")


@pytest.fixture(scope="module")
def worlds():
    """(port db, port queries, reference db, reference queries, d)."""
    rng = np.random.default_rng(21)
    segs = random_segments(rng, 800)
    queries = random_segments(rng, 96)
    rdb = R.TrajectoryDB.from_segments(segs,
                                       policy=R.ExecutionPolicy(**POLICY))
    tdb = TrajectoryDB.from_segments(state.segments_from_numpy(vars(segs)),
                                     policy=ExecutionPolicy(**POLICY),
                                     device=CPU)
    return tdb, state.segments_from_numpy(vars(queries)), rdb, queries, 4.0


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_query_stream_equals_query_and_reference(worlds, backend):
    tdb, tq, rdb, rq, d = worlds
    res, st = tdb.query_stream(tq, d, backend=backend)
    base = tdb.query(tq, d, backend=backend)
    for f in INDEX_FIELDS + ("t_enter", "t_exit"):
        np.testing.assert_array_equal(getattr(res, f), getattr(base, f))
    ref, ref_st = rdb.query_stream(rq, d, backend="jnp")
    assert_same_rows(res, ref)
    assert (st.groups, st.group_sizes, st.completed) == (
        ref_st.groups, ref_st.group_sizes, ref_st.completed)
    assert st.reissued == 0 and st.batches_per_call >= 2


@pytest.mark.parametrize("group_size", [None, 1, 4])
@pytest.mark.parametrize("workers", [1, 2, 3])
def test_scheduler_groups_equal_reference(worlds, workers, group_size):
    tdb, tq, rdb, rq, d = worlds
    plan = tdb.plan(tq, d=d)
    ref_plan = rdb.plan(rq, d=d)
    assert plan.num_batches == ref_plan.num_batches
    mine = DeadlineScheduler(tdb.engine("kernel"), workers=workers,
                             group_size=group_size)
    theirs = RefScheduler(rdb.engine("jnp"), workers=workers,
                          group_size=group_size)
    for n in (1, 2, 5, plan.num_batches):
        assert mine.groups(n) == theirs.groups(n), n
    assert mine.groups(plan.num_batches, plan.batches, plan.runs) == \
        theirs.groups(ref_plan.num_batches, ref_plan.batches, ref_plan.runs)


def test_straggler_group_reissued_rows_exact(worlds):
    tdb, tq, rdb, rq, d = worlds
    base = tdb.query(tq, d, backend="kernel")

    def delay(group, attempt):
        if group == 0 and attempt == 0:
            time.sleep(0.5)                       # straggler

    res, st = tdb.query_stream(
        tq, d, backend="kernel", delay_hook=delay,
        policy=tdb.policy.with_(stream_min_deadline=0.05))
    for f in INDEX_FIELDS + ("t_enter", "t_exit"):
        np.testing.assert_array_equal(getattr(res, f), getattr(base, f))
    assert st.reissued >= 1 and st.completed == len(res.plan.batches)


def test_exact_beta_and_alpha_equal_reference(worlds):
    tdb, tq, rdb, rq, d = worlds
    eng, ref_eng = tdb.engine("torch"), rdb.engine("jnp")
    plan = periodic(eng.index, tq, 16)
    checked = 0
    for b in plan.batches:
        if b.num_candidates == 0:
            continue
        args = (b.q_first, b.q_last, b.cand_first, b.cand_last)
        assert perfmodel.exact_beta(eng, tq, *args) == rperf.exact_beta(
            ref_eng, rq, *args)
        checked += 1
    assert checked > 0
    for pruning in ("none", "spatial"):
        got = perfmodel.estimate_alpha_by_epoch(
            eng, tq, d, 16, num_epochs=8, seed=3, pruning=pruning)
        want = rperf.estimate_alpha_by_epoch(
            ref_eng, rq, d, 16, num_epochs=8, seed=3, pruning=pruning)
        np.testing.assert_array_equal(got, want)
        assert (got > 0).any()


def test_fit_response_model_wires_planner_broker_and_stream(worlds):
    tdb, tq, rdb, rq, d = worlds
    assert tdb.response_model is None
    try:
        model = tdb.fit_response_model(tq, d, s=16, quick=True, num_epochs=6)
        assert tdb.response_model is model and model.alphas.shape == (6,)
        assert model.device.theta > 0 and model.host.transfer_bw > 0
        assert tdb.planner(num_queries=len(tq)).predict_hits == \
            model.predict_batch_hits
        broker = tdb.broker(backend="kernel")
        assert broker.predict_seconds == model.predict_batch_seconds
        ticket = broker.submit(tq, d, deadline=3600.0)
        assert ticket.predicted_seconds is not None
        assert ticket.predicted_seconds >= 0
        assert_same_rows(ticket.result(), rdb.query(rq, d, backend="jnp"))
        res, _ = tdb.query_stream(tq, d, backend="kernel")
        assert_same_rows(res, rdb.query(rq, d, backend="jnp"))
    finally:
        tdb.response_model = None
    assert tdb.broker(backend="kernel").predict_seconds is None


def test_launch_counter_holds_under_concurrent_increments():
    """The launch counters are bumped from the scheduler's and the
    broker's worker threads: no increment may be lost."""
    name, per_thread, threads = "distthresh_compact_rowloop", 2000, 16
    before = dt.LAUNCHES[name]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            dt._count_launch(name) for _ in range(per_thread)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
        total = dt.LAUNCHES[name] - before
        dt.LAUNCHES[name] = before
    assert total == per_thread * threads
