"""The harness's parts: the benchmark's files, the traffic generator, the
yardstick's counts and the trace's arithmetic."""
import json
import re
import types

import numpy as np
import pytest

from perfbench.data import trajgen
from perfbench.harness import cost, spec
from perfbench.harness.trace import DeviceTrace
from perfbench.harness.traffic import RequestStream, query_rows

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_in_the_benchmark_has_its_files():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(cfg["check_limits"]) == {"row_errors", "flip_ratio",
                                           "interval_ratio"}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("k", [1, 10, 100])
def test_requests_are_seeded_and_distinct_within_a_request(k):
    mix = {"trajectories_per_request": k}

    def first(seed, n=60):
        s = RequestStream(mix, 500, np.random.default_rng([seed, 1]))
        return [next(s) for _ in range(n)]

    a, b, c = first(7), first(7), first(8)
    assert all((x == y).all() for x, y in zip(a, b))
    assert any((x != y).any() for x, y in zip(a, c))
    assert all(len(set(r.tolist())) == k for r in a)
    # uniform: every trajectory comes once in each walk through the database
    walk = np.concatenate(a)[:500 - 500 % k]
    assert len(set(walk.tolist())) == len(walk)


def test_every_mix_names_a_client_and_its_backend_can_change():
    for w in BENCH["workloads"]:
        mix = spec.load_cell(w["name"]).traffic
        assert callable(spec.client(mix["client"]))
    calls = []

    class DB:
        def query(self, queries, d, **kw):
            calls.append(kw)

    spec.client("query")(DB(), 1.0, {})("qs")
    spec.client("query")(DB(), 1.0, {"query_kwargs": {"backend": "rtree",
                                                      "s": 64}})("qs")
    assert calls == [{"backend": "kernel"}, {"backend": "rtree", "s": 64}]


def test_a_span_target_the_program_lacks_is_left_out(monkeypatch, capsys):
    from repro_torch.core import planner
    from perfbench.harness import trace as trace_mod
    monkeypatch.setattr(trace_mod, "TARGETS", trace_mod.TARGETS + (
        ("gone", "repro_torch.core.engine", "_QueryBlockDispatcher", "nope"),
        ("gone", "repro_torch.core.engine", "NoSuchClass", "run"),
        ("gone", "repro_torch.no_such_module", "X", "run")))
    before = planner.QueryPlanner.__dict__["plan"]
    spans = trace_mod.Spans()
    with trace_mod.wrapped(spans):
        assert planner.QueryPlanner.__dict__["plan"] is not before
    assert planner.QueryPlanner.__dict__["plan"] is before
    assert capsys.readouterr().err.count("left out") == 3
    obs = types.SimpleNamespace(traced=types.SimpleNamespace(
        requests=[{"stats": None}], spans=spans, device=None))
    assert spec.reader("plan_ms")(obs) is None
    assert spec.reader("redispatch_per_batch")(obs) is None
    assert spec.reader("dispatch_ms_per_batch")(obs) is None


def test_query_rows_keep_the_callers_trajectory_order():
    ds = trajgen.make("galaxy", {}, seed=0, scale=0.002)
    rows = query_rows(ds.traj_slices, np.array([3, 1]))
    assert (ds.cols["traj_id"][rows] == [3] * 400 + [1] * 400).all()


def test_least_work_counts_what_a_brute_force_counts():
    ds = trajgen.make("randwalk-exp", {}, seed=4, scale=0.01)
    qs = ds.take(query_rows(ds.traj_slices, np.array([0, 5, 9])))
    w = cost.Work(ds.cols)
    ets, ete = ds.cols["ts"][:, None], ds.cols["te"][:, None]
    overlap = (ets <= qs["te"][None]) & (ete >= qs["ts"][None])
    assert w.overlap_pairs(qs) == int(overlap.sum())
    assert w.entries_touched(qs) == int(overlap.any(1).sum())
    ops_s = cost.OPS_PER_OVERLAP * overlap.sum() / cost.PEAK_FLOPS["float32"]
    assert w.least_seconds(qs, rows=100) >= ops_s > 0


def trace(ops, spans):
    host = {k: (np.array([s for s, _ in v]), np.array([e for _, e in v]))
            for k, v in spans.items()}
    window = (int(host["request"][0].min()), int(host["request"][1].max()))
    return DeviceTrace(ops, host, window)


def test_device_trace_union_and_idle_gaps():
    tr = trace([("k1", 10, 30), ("k2", 20, 40), ("copy", 60, 70),
                ("late", 200, 250)],
               {"request": [(0, 100)], "plan": [(0, 10)],
                "execute": [(10, 100)], "sync": [(40, 60)]})
    np.testing.assert_array_equal(tr.busy_intervals(), [[10, 40], [60, 70]])
    assert tr.busy_s() == pytest.approx(40e-9)
    assert tr.window_s == pytest.approx(100e-9)
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"plan": 10e-9, "sync": 20e-9,
                                  "execute": 30e-9})
    assert tr.device_ops()[0] == ["late", pytest.approx(50e-9)]
    assert tr.time_by_kernel("k") == pytest.approx(40e-9)


def test_readers_return_nothing_where_nothing_was_read():
    obs = types.SimpleNamespace(setup_s=1.0, window_s=2.0, requests=[],
                                peak_window_bytes=0, traced=None)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s":
            assert spec.reader(m["name"])(obs) is None, m["name"]
    traced = types.SimpleNamespace(requests=[{"stats": {"invocations": 4,
                                                        "retries": 1,
                                                        "dispatch_s": 0.002},
                                              "least_s": 1e-4}],
                                   spans=None, device=None)
    obs.traced = traced
    assert spec.reader("redispatch_per_batch")(obs) == 0.25
    assert spec.reader("dispatch_ms_per_batch")(obs) == pytest.approx(0.5)
    assert spec.reader("distance_kernel_roofline")(obs) is None
    assert spec.reader("device_idle_share")(obs) is None
    traced.device = trace([("distthresh_compact_kernel", 0, 400_000)],
                          {"request": [(0, 1_000_000)]})
    assert spec.reader("distance_kernel_roofline")(obs) == pytest.approx(25.0)
    assert spec.reader("device_idle_share")(obs) == pytest.approx(0.6)
    for name in ("redispatch_per_batch", "dispatch_ms_per_batch",
                 "distance_kernel_roofline", "device_idle_share"):
        assert spec.reader(name + ".fixed")(obs) == spec.reader(name)(obs)


def test_the_per_layer_rate_leaves_out_the_traced_requests():
    rate = spec.reader("searches_per_s.fixed")
    obs = types.SimpleNamespace(
        requests=[{"trajectories": 100, "latency_s": 9.0},
                  {"trajectories": 100, "latency_s": 2.0},
                  {"trajectories": 100, "latency_s": 3.0}],
        traced=types.SimpleNamespace(requests=[{}]))
    assert rate(obs) == pytest.approx(40.0)
    obs.traced.requests = [{}, {}, {}]
    assert rate(obs) is None
    obs.traced = None
    assert rate(obs) == pytest.approx(300 / 14)
