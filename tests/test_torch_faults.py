"""Fault injection, broker retry and the degradation ladder of the port
against the reference, on one world built from the same numpy seed in
both packages (600 random entry segments, 80 queries, d = 4, periodic
s = 16, 64 bins: the world of ``tests/test_faults.py``).

The port runs ``backend="kernel"`` on the CPU (the kernels' plain twins)
and the reference ``backend="pallas"`` (interpret mode) where the ladder
is walked, ``"jnp"`` elsewhere.  One ``FaultPlan`` must fire on the same
calls in both packages; the hook context names the kernel flag
``use_kernel`` in the port and ``use_pallas`` in the reference.  Rows:
indices exact, intervals within ``rtol=1e-4, atol=1e-3``
(``tests/test_torch_api.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as R
from conftest import random_segments
from repro import faults as rfaults
from repro.core.segments import SegmentArray as RefSegmentArray
from repro.serve.retry import RetryPolicy as RefRetryPolicy
from repro_torch import faults, state
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core.errors import CapacityError
from repro_torch.core.segments import SegmentArray
from repro_torch.serve import RetryPolicy
from repro_torch.serve.broker import DEGRADATION_LADDER, degradation_ladder

RTOL, ATOL = 1e-4, 1e-3
CPU = "cpu"
INDEX_FIELDS = ("entry_idx", "entry_traj", "entry_seg", "query_idx")
POLICY = dict(num_bins=64, batching="periodic", batch_params={"s": 16})
#: fast backoff so retry tests do not sleep for real
FAST = dict(base_backoff=0.002, max_backoff=0.01)


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
    """(port db, port queries, reference db, reference queries, d,
    reference jnp result)."""
    rng = np.random.default_rng(7)
    segs = random_segments(rng, 600)
    queries = random_segments(rng, 80)
    rdb = R.TrajectoryDB.from_segments(segs,
                                       policy=R.ExecutionPolicy(**POLICY))
    tdb = TrajectoryDB.from_segments(state.segments_from_numpy(vars(segs)),
                                     policy=ExecutionPolicy(**POLICY),
                                     device=CPU)
    return (tdb, state.segments_from_numpy(vars(queries)), rdb, queries,
            4.0, rdb.query(queries, 4.0, backend="jnp"))


def _events(plan):
    """A plan's fired events with the kernel flag's name unified."""
    out = []
    for e in plan.events:
        ctx = dict(e.ctx)
        if "use_pallas" in ctx:
            ctx["use_kernel"] = ctx.pop("use_pallas")
        out.append((e.site, e.kind, e.index, ctx))
    return out


def _specs():
    return [dict(site="engine.dispatch", kind="delay", times=None,
                 probability=0.5, delay=0.0),
            dict(site="engine.count", kind="corrupt_count", times=2,
                 after=1, factor=1.0, bias=0),
            dict(site="ops.query_block", kind="delay", times=3, after=2,
                 delay=0.0, match={"compaction": "fused"}),
            dict(site="engine.marshal", kind="delay", times=None,
                 probability=0.3, delay=0.0)]


def test_same_plan_fires_same_events(worlds):
    tdb, tq, rdb, rq, d, base = worlds
    plan = faults.FaultPlan(_specs(), seed=5)
    ref_plan = rfaults.FaultPlan(_specs(), seed=5)
    with faults.active(plan):
        got = tdb.query(tq, d, backend="kernel")
    with rfaults.active(ref_plan):
        want = rdb.query(rq, d, backend="pallas")
    assert_same_rows(got, want)
    assert plan.events and _events(plan) == _events(ref_plan)
    assert plan.calls == ref_plan.calls
    assert plan.report()["fired"] == ref_plan.report()["fired"]


def test_transient_retry_backoff_equals_reference(worlds):
    tdb, tq, rdb, rq, d, base = worlds
    spec = dict(site="engine.dispatch", kind="resource_exhausted", times=2)
    broker = tdb.broker(backend="kernel",
                        retry=RetryPolicy(degrade_after=1, seed=3, **FAST))
    ref_broker = rdb.broker(backend="jnp", retry=RefRetryPolicy(
        degrade_after=1, seed=3, **FAST))
    with faults.active(faults.FaultPlan([spec])):
        t = broker.submit(tq, d)
        got = t.result()
    with rfaults.active(rfaults.FaultPlan([spec])):
        rt = ref_broker.submit(rq, d)
        rt.result()
    assert_same_rows(got, base)
    assert t.health.retries == rt.health.retries == 2
    assert t.health.attempts == rt.health.attempts
    assert t.health.backoff_seconds == rt.health.backoff_seconds > 0
    assert not t.health.degradations          # transient: no ladder step
    assert broker.inflight_interactions == 0
    for attempt in (1, 2, 3):
        assert RetryPolicy(seed=9).backoff_seconds(4, 1, attempt) == \
            RefRetryPolicy(seed=9).backoff_seconds(4, 1, attempt)


def test_persistent_kernel_failure_walks_full_ladder(worlds):
    """A CPU database walks the reference's whole ladder, down to the
    plain torch rung (the reference's pallas → jnp step)."""
    tdb, tq, rdb, rq, d, base = worlds
    broker = tdb.broker(backend="kernel", retry=RetryPolicy(
        max_attempts=8, degrade_after=1, **FAST))
    spec = faults.FaultSpec("engine.dispatch", "error", times=None,
                            match={"use_kernel": True})
    with faults.active(faults.FaultPlan([spec])) as plan:
        t = broker.submit(tq, d)
        res = t.result()
    assert_same_rows(res, base, "ladder")
    stages = [(g.stage, g.after) for g in t.health.degradations]
    assert stages == [("compaction", "kernel/fused_rowloop"),
                      ("compaction", "kernel/dense"),
                      ("backend", "torch/dense")]
    assert [e.ctx["compaction"] for e in plan.events] == [
        "fused", "fused_rowloop", "dense"]
    assert res.degraded and t.health.degraded
    assert t.slices()[-1].result is not None
    clean = tdb.query(tq, d, backend="torch")
    for f in INDEX_FIELDS + ("t_enter", "t_exit"):
        np.testing.assert_array_equal(getattr(res, f), getattr(clean, f))


def test_ladder_on_a_card_ends_at_the_dense_kernel():
    cpu = degradation_ladder(torch.device("cpu"))
    cuda = degradation_ladder(torch.device("cuda"))
    assert cpu == DEGRADATION_LADDER and cpu[-1] == ("torch", "dense")
    assert cuda == (("kernel", "fused"), ("kernel", "fused_rowloop"),
                    ("kernel", "dense"))


def test_persistent_kernel_failure_on_card_ladder_fails_ticket(worlds):
    """The ladder a CUDA database gets: after the dense kernel's rung the
    ticket fails with the injected error instead of falling back to the
    plain torch version.  The broker logic is device-independent, so the
    CUDA ladder is driven here on the CPU database."""
    tdb, tq, rdb, rq, d, base = worlds
    broker = tdb.broker(backend="kernel", retry=RetryPolicy(
        max_attempts=5, degrade_after=1, **FAST))
    broker.ladder = degradation_ladder(torch.device("cuda"))
    spec = faults.FaultSpec("engine.dispatch", "error", times=None,
                            match={"use_kernel": True})
    with faults.active(faults.FaultPlan([spec])) as plan:
        t = broker.submit(tq, d)
        with pytest.raises(faults.InjectedKernelError):
            t.result()
    assert t.state == "error"
    assert isinstance(t.exception(), faults.InjectedKernelError)
    assert [(g.stage, g.after) for g in t.health.degradations] == [
        ("compaction", "kernel/fused_rowloop"),
        ("compaction", "kernel/dense")]
    assert [e.ctx["compaction"] for e in plan.events] == [
        "fused", "fused_rowloop", "dense", "dense", "dense"]
    assert all(e.ctx["use_kernel"] for e in plan.events)
    assert t.health.attempts == {0: 5} and t.groups_completed == 0
    assert broker.errored == 1 and broker.inflight_interactions == 0
    # A ticket that enters at the dense kernel has nowhere to step on a
    # card.
    dense = tdb.broker(backend="kernel", retry=RetryPolicy(
        max_attempts=2, degrade_after=1, **FAST),
        policy=tdb.policy.with_(compaction="dense"))
    dense.ladder = degradation_ladder(torch.device("cuda"))
    with faults.active(faults.FaultPlan([spec])):
        t2 = dense.submit(tq, d)
        with pytest.raises(faults.InjectedKernelError):
            t2.result()
    assert not t2.health.degradations


def test_corrupted_counts_cannot_corrupt_rows(worlds):
    tdb, tq, rdb, rq, d, base = worlds
    clean = tdb.query(tq, d, backend="kernel")
    for factor, bias in ((8.0, 3), (0.0, 0), (1.0, -5)):
        spec = faults.FaultSpec("engine.count", "corrupt_count",
                                times=None, factor=factor, bias=bias)
        with faults.active(faults.FaultPlan([spec])):
            res = tdb.query(tq, d, backend="kernel")
        for f in INDEX_FIELDS + ("t_enter", "t_exit"):
            np.testing.assert_array_equal(getattr(res, f),
                                          getattr(clean, f),
                                          err_msg=f"{factor}/{bias}:{f}")
    assert_same_rows(clean, base)


@pytest.fixture(scope="module")
def adversarial():
    """Every entry within d of every query during a shared window (the
    overflow-retry worst case), as numpy columns for both packages."""
    rng = np.random.default_rng(11)

    def cluster(m):
        ts = np.sort(rng.uniform(0.0, 1.0, m)).astype(np.float32)
        p0 = rng.uniform(0, 0.5, (m, 3)).astype(np.float32)
        p1 = (p0 + rng.normal(0, 0.1, (m, 3))).astype(np.float32)
        return dict(xs=p0[:, 0], ys=p0[:, 1], zs=p0[:, 2], xe=p1[:, 0],
                    ye=p1[:, 1], ze=p1[:, 2], ts=ts,
                    te=(ts + 9.0).astype(np.float32),
                    seg_id=np.arange(m, dtype=np.int32),
                    traj_id=np.arange(m, dtype=np.int32) % 5)
    return cluster(96), cluster(12), 50.0


def test_capacity_error_is_structured(adversarial):
    entries, queries, d = adversarial
    fields = dict(capacity=16, max_capacity_retries=0, batching="periodic",
                  batch_params={"s": 4}, num_bins=8)
    tdb = TrajectoryDB.from_segments(SegmentArray(**entries),
                                     policy=ExecutionPolicy(**fields),
                                     device=CPU)
    rdb = R.TrajectoryDB.from_segments(RefSegmentArray(**entries),
                                       policy=R.ExecutionPolicy(**fields))
    with pytest.raises(CapacityError) as ei:
        tdb.query(SegmentArray(**queries), d, backend="kernel")
    with pytest.raises(R.CapacityError) as ref_ei:
        rdb.query(RefSegmentArray(**queries), d, backend="jnp")
    err, ref = ei.value, ref_ei.value
    assert (err.count, err.capacity, err.batch_index, err.retries) == (
        ref.count, ref.capacity, ref.batch_index, ref.retries)
    assert err.count > err.capacity and str(err) == str(ref)
    broker = tdb.broker(backend="kernel", retry=RetryPolicy(**FAST))
    t = broker.submit(SegmentArray(**queries), d)
    with pytest.raises(CapacityError):
        t.result()
    assert t.health.attempts[0] == 1          # permanent: not re-run
    assert broker.inflight_interactions == 0


def test_partial_result_after_error(worlds):
    tdb, tq, rdb, rq, d, base = worlds
    spec = dict(site="engine.dispatch", kind="error", times=None, after=1)
    broker = tdb.broker(backend="kernel")         # no retry: fail fast
    ref_broker = rdb.broker(backend="jnp")
    with faults.active(faults.FaultPlan([spec])):
        t = broker.submit(tq, d, group_size=1)
        with pytest.raises(faults.InjectedKernelError):
            t.result()
    with rfaults.active(rfaults.FaultPlan([spec])):
        rt = ref_broker.submit(rq, d, group_size=1)
        with pytest.raises(rfaults.InjectedKernelError):
            rt.result()
    assert t.state == rt.state == "error"
    assert t.num_groups == rt.num_groups > 1
    assert t.groups_completed == rt.groups_completed == 1
    part = t.partial_result()
    assert part.degraded and 0 < len(part) < len(base)
    assert_same_rows(part, rt.partial_result())
    t2 = broker.submit(tq, d)
    full = t2.result()                        # a done ticket's partial view
    assert t2.partial_result() is full and not full.degraded


def test_fault_dataclasses_match_reference():
    """The port's copy keeps the reference's spec fields and kinds."""
    assert faults.KINDS == rfaults.KINDS
    assert [f.name for f in dataclasses.fields(faults.FaultSpec)] == [
        f.name for f in dataclasses.fields(rfaults.FaultSpec)]
