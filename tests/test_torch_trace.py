"""The port's program spans (``repro_torch.core.trace``) on the CPU.

With no profiler recording a span is a shared null context: no range is
entered and ``ExecStats.spans`` stays empty.  Under
``torch.profiler.profile`` a query names the planner's four phases, the
dispatcher's pieces of host work and the facade's rank into the caller's
order as ``repro_torch.*`` events inside the call, each counted in
``ExecStats.spans``; the preparation runs once per dispatch and again
per overflow re-dispatch; ``ExecStats.plan_seconds`` covers all of
``QueryPlanner.plan``; the dispatch-group labels and the rows are the
same traced or not.  Database: C3 at scale 0.05 (32 query segments,
50,000 entries).  The default (spatial) route builds its tile operands
on the device and uploads nothing, so ``dispatch.upload`` shows only on
the live-tile route."""
import collections
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import TrajectoryDB
from repro_torch.core import engine, planner, trace
from repro_torch.core.executor import current_group_label

SPANS = ("plan.price_setup", "plan.batching", "plan.subranges", "plan.refine",
         "dispatch.prep", "dispatch.upload", "dispatch.launch",
         "dispatch.stage")
#: (batching, batch params): the default policy's plan and fixed batches
PLANS = {"greedysetsplit-min": ("greedysetsplit-min", {}),
         "periodic": ("periodic", {"s": 8})}


@pytest.fixture(scope="module")
def c3():
    db = TrajectoryDB.from_scenario("C3", scale=0.05, device="cpu")
    return db, db.scenario_queries, float(db.scenario_d)


@pytest.fixture(params=sorted(PLANS))
def query(request, c3):
    """One ``db.query`` on the plan named by the parameter, backend
    ``kernel``, the default policy otherwise."""
    db, qs, d = c3
    batching, params = PLANS[request.param]

    def run(**policy):
        pol = db.policy.with_(batching=batching, batch_params=params,
                              **policy)
        return db.query(qs, d, backend="kernel", policy=pol)
    return run


def profiled(fn):
    """``fn()`` inside a ``test.call`` range under the CPU profiler:
    (its result, the ``repro_torch.*`` events as (name, start, end), the
    call's (start, end))."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("test.call"):
            out = fn()
    events, call = [], None
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.name() == "test.call":
            call = iv
        elif e.name().startswith(trace.PREFIX):
            assert not e.is_user_annotation(), e.name()
            events.append((e.name()[len(trace.PREFIX):],) + iv)
    return out, events, call


def _no_range(name):
    raise AssertionError(f"a profiler range was entered: {name}")


# ----------------------------------------------------------------------
# The span facility.
# ----------------------------------------------------------------------
def test_a_span_off_is_one_shared_null_context(monkeypatch):
    monkeypatch.setattr(trace, "_range", _no_range)
    assert trace.span("plan.batching") is trace.span("dispatch.prep")
    with trace.collect() as acc:
        with trace.span("dispatch.prep"):
            pass
    assert acc == {}


def test_a_span_on_is_an_operator_range_counted_in_the_accumulator():
    def work():
        with trace.collect({"dispatch.prep": (1, 1.0)}) as acc:
            for _ in range(2):
                with trace.span("dispatch.prep"):
                    time.sleep(0.002)
        return acc

    acc, events, call = profiled(work)
    calls, seconds = acc["dispatch.prep"]
    assert calls == 3 and seconds >= 1.004
    assert [n for n, _, _ in events] == ["dispatch.prep"] * 2
    assert all(call[0] <= s <= e <= call[1] for _, s, e in events)


def test_accumulators_nest_and_stay_on_their_thread():
    def stage():
        with trace.span("dispatch.stage"):
            pass

    def work():
        with trace.span("plan.refine"):        # no accumulator: dropped
            pass
        with trace.collect() as outer:
            with trace.collect() as inner:
                with trace.span("plan.batching"):
                    pass
            other = threading.Thread(target=stage)
            other.start()
            other.join()
            with trace.span("plan.refine"):
                pass
        return outer, inner

    (outer, inner), _, _ = profiled(work)
    assert set(inner) == {"plan.batching"}
    assert set(outer) == {"plan.refine"} and outer["plan.refine"][0] == 1


# ----------------------------------------------------------------------
# A query, traced and not.
# ----------------------------------------------------------------------
def test_no_profiler_no_spans_and_no_ranges(monkeypatch, query):
    monkeypatch.setattr(trace, "_range", _no_range)
    res = query()
    assert len(res) > 0 and res.stats.spans == {}


def test_a_traced_query_names_every_span_inside_the_call(query):
    res, events, call = profiled(query)
    seen = collections.Counter(n for n, _, _ in events)
    assert set(seen) == set(SPANS) - {"dispatch.upload"} | {"order.rank"}
    assert all(call[0] <= s <= e <= call[1] for _, s, e in events)
    st = res.stats
    assert {k: c for k, (c, _) in st.spans.items()} == dict(seen)
    assert all(s > 0 for _, s in st.spans.values())
    for name in SPANS[:4] + ("order.rank",):
        assert seen[name] == 1
    live = sum(b.num_candidates > 0 for b in st.batches)
    assert seen["dispatch.launch"] == seen["dispatch.stage"] == live


def test_the_preparation_runs_again_for_each_retry(query):
    res, events, _ = profiled(lambda: query(capacity=256))
    st = res.stats
    live = sum(b.num_candidates > 0 for b in st.batches)
    assert st.total_retries > 0
    assert st.spans["dispatch.prep"][0] == live + st.total_retries
    assert st.spans["dispatch.launch"][0] == live + st.total_retries


def test_plan_seconds_covers_every_phase_traced(query):
    res, _, _ = profiled(query)
    st = res.stats
    phases = sum(st.spans[n][1] for n in SPANS[:4])
    assert phases <= st.plan_seconds


def test_plan_seconds_covers_pricing_setup_and_subranges(monkeypatch, query):
    """Untraced: the counter's construction and ``_prune_batches``, each
    made 50 ms slower, show in ``plan_seconds``."""
    counter, prune = planner.SpatialInteractionCounter, \
        planner.QueryPlanner._prune_batches

    def slow_counter(*a, **kw):
        time.sleep(0.05)
        return counter(*a, **kw)

    def slow_prune(self, *a, **kw):
        time.sleep(0.05)
        return prune(self, *a, **kw)

    monkeypatch.setattr(planner, "SpatialInteractionCounter", slow_counter)
    monkeypatch.setattr(planner.QueryPlanner, "_prune_batches", slow_prune)
    t0 = time.perf_counter()
    res = query()
    wall = time.perf_counter() - t0
    assert 0.1 <= res.stats.plan_seconds <= wall
    assert res.stats.spans == {}


def test_group_labels_are_the_same_traced_or_not(monkeypatch, query):
    seen = []
    disp = engine._QueryBlockDispatcher
    dispatch, marshal = disp.dispatch, disp.marshal

    def watch_dispatch(self, *a, **kw):
        seen.append(("dispatch", current_group_label()))
        return dispatch(self, *a, **kw)

    def watch_marshal(self, *a, **kw):
        seen.append(("marshal", current_group_label()))
        return marshal(self, *a, **kw)

    monkeypatch.setattr(disp, "dispatch", watch_dispatch)
    monkeypatch.setattr(disp, "marshal", watch_marshal)
    query()
    off = list(seen)
    seen.clear()
    _, events, _ = profiled(query)
    assert seen == off and off
    assert {lbl.split(":")[1] for kind, lbl in off} == {"dispatch", "finish"}
    assert all(lbl.startswith("pipelined:") for _, lbl in off)
    assert {n.split(".")[0] for n, _, _ in events} <= {"plan", "dispatch",
                                                        "order"}
    assert current_group_label() is None


def test_rows_are_the_same_traced_or_not(query):
    off = query()
    on, _, _ = profiled(query)
    assert on.stats.spans and not off.stats.spans
    for col in ("entry_idx", "query_idx", "t_enter", "t_exit"):
        a = np.asarray(getattr(off, col))
        b = np.asarray(getattr(on, col))
        np.testing.assert_array_equal(a, b, err_msg=col)


@pytest.mark.parametrize("pruning,compaction,spans", [
    ("hierarchical", "fused", SPANS[4:]),
    ("spatial", "fused", ("dispatch.prep", "dispatch.launch",
                          "dispatch.stage")),
    ("none", "fused", ("dispatch.launch", "dispatch.stage")),
    ("spatial", "dense", ("dispatch.launch", "dispatch.stage"))])
def test_each_route_names_its_own_dispatch_work(query, pruning, compaction,
                                                spans):
    """The live-tile route prepares, uploads its lists and launches once a
    dispatch; the spatial route prepares on the device and uploads
    nothing; without tile pruning, or on the dense path, nothing is
    prepared or uploaded."""
    res, events, _ = profiled(lambda: query(pruning=pruning,
                                            compaction=compaction))
    st = res.stats
    live = sum(b.num_candidates > 0 for b in st.batches)
    dispatch = {k: c for k, (c, _) in st.spans.items()
                if k.startswith("dispatch.")}
    assert dispatch == {name: live for name in spans}
