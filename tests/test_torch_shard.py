"""The temporal-pod backend (``repro_torch.core.distributed``,
``backend="shard"``) on the CPU against the reference's
``repro.core.distributed`` and ``backend="jnp"``.

The host partition functions are numpy on both sides and must be equal.
Query rows are compared as the facade tests compare them
(``_torch_rows``: index columns exact, ``t_enter``/``t_exit`` within
``rtol=1e-4, atol=1e-3``); against the reference on C1 at scale 0.05 one
borderline pair may differ (see ``tests/test_torch_rtree.py``).  Within
the port, the shard backend must give exactly the rows of the
single-device backends.  On the CPU ``shard_use_kernel=True`` runs the
kernels' plain twins; pods beyond the one CPU device share it
round-robin.

The subprocess test holds ``shard_pods=8`` to the reference's forced
8-device host mesh.  On jax 0.9.0 the reference's Pallas kernels under
``shard_map`` raise a ``check_vma`` ``ValueError`` (ROADMAP, queue C), so
that test rebinds the reference module's ``_shard_map`` to
``jax.shard_map(..., check_vma=False)`` in its own process; no file of
the reference changes.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.api as R
import repro.core.distributed as RD
from _torch_rows import assert_same_rows
from repro_torch import faults
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core import distributed as TD
from repro_torch.core.errors import PodFailedError
from repro_torch.core.segments import SegmentArray
from repro_torch.serve.retry import RetryPolicy

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
_FAST = dict(base_backoff=0.002, max_backoff=0.01)

#: (scenario, scale, policy fields).
SCENARIOS = {
    "S2": (0.01, dict(batching="periodic", batch_params={"s": 32},
                      num_bins=200)),
    "C1": (0.05, dict(num_bins=100)),
    "C3": (0.05, dict(num_bins=8, index_kboxes=4, max_subranges=16)),
}
PRUNINGS = ("none", "spatial", "hierarchical")


def _pairs(res):
    return list(zip(res.entry_idx.tolist(), res.query_idx.tolist()))


def _identical(a, b, label=""):
    for f in ("entry_idx", "entry_traj", "entry_seg", "query_idx",
              "t_enter", "t_exit"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{label} {f}")


@pytest.fixture(scope="module")
def worlds():
    """Per scenario: (reference jnp result, port database on the CPU,
    the port's single-device torch result)."""
    out = {}
    for name, (scale, fields) in SCENARIOS.items():
        rdb = R.TrajectoryDB.from_scenario(
            name, scale=scale, policy=R.ExecutionPolicy(**fields))
        base = rdb.query(rdb.scenario_queries, rdb.scenario_d, backend="jnp")
        assert len(base) > 0, name
        tdb = TrajectoryDB.from_scenario(
            name, scale=scale, policy=ExecutionPolicy(**fields), device=CPU)
        single = tdb.query(tdb.scenario_queries, tdb.scenario_d,
                           backend="torch")
        out[name] = (base, tdb, single)
    return out


# ----------------------------------------------------------------------
# Host partition functions.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("balance", ["time", "num_ints"])
@pytest.mark.parametrize("pods", [1, 3, 8])
def test_partition_and_routing_equal_reference(worlds, pods, balance, halo):
    _, tdb, _ = worlds["C1"]
    from repro.core.segments import SegmentArray as RefSegments
    seg = tdb.segments
    rseg = RefSegments(**{f: getattr(seg, f) for f in (
        "xs", "ys", "zs", "xe", "ye", "ze", "ts", "te", "seg_id",
        "traj_id")})
    got = TD.temporal_pod_partition(seg, pods, balance=balance, halo=halo)
    assert got == RD.temporal_pod_partition(rseg, pods, balance=balance,
                                            halo=halo)
    if not halo:
        # ownership: every segment in exactly one pod
        assert sum(last - first + 1 for first, last in got) == len(seg)
    t0, t1 = seg.temporal_extent
    rng = np.random.default_rng(pods)
    for _ in range(20):
        a, b = np.sort(rng.uniform(t0 - 5, t1 + 5, 2))
        assert (TD.route_query_to_pods(a, b, seg, got)
                == RD.route_query_to_pods(a, b, rseg, got))
    assert TD.route_query_to_pods(t1, t0 - 1, seg, got) == []


def test_partition_edge_cases():
    empty = SegmentArray.empty()
    assert TD.temporal_pod_partition(empty, 3) == [(0, -1)] * 3
    with pytest.raises(ValueError):
        TD.temporal_pod_partition(empty, 0)
    with pytest.raises(ValueError):
        TD.temporal_pod_partition(empty, 2, balance="bogus")
    for args in ((1000, 10, 4, 2), (10, 1000, 4, 2), (0, 0, 1, 1),
                 (512, 512, 8, 1)):
        assert TD.choose_sharding(*args) == RD.choose_sharding(*args)


def test_pod_devices_round_robin():
    import torch
    cpu = torch.device("cpu")
    assert TD.pod_devices(device=CPU) == [cpu]
    assert TD.pod_devices(8, device=CPU) == [cpu] * 8
    assert TD.pod_devices(3, devices=["cpu", "cpu"]) == [cpu] * 3
    with pytest.raises(ValueError):
        TD.pod_devices(2, devices=[])


# ----------------------------------------------------------------------
# backend="shard" through the facade.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("pods", [1, 3, 8])
def test_s2_shard_equals_reference_and_brute(worlds, pods, use_kernel):
    base, tdb, single = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=pods, shard_use_kernel=use_kernel)
    got = tdb.query(q, d, backend="shard", policy=pol)
    assert tdb.backend("shard", pol).engine.ways == pods
    assert_same_rows(got, base, (pods, use_kernel))
    _identical(got, single, "single-device torch")
    assert_same_rows(got, tdb.query(q, d, backend="brute"), "brute")
    st = got.stats
    assert st.pipelined and st.num_syncs <= 2 * st.num_groups
    assert len(set(_pairs(got))) == len(got)


@pytest.mark.parametrize("pruning", PRUNINGS)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scenario", ["C1", "C3"])
def test_modes_equal_reference(worlds, scenario, use_kernel, pruning):
    """Pruning × kernel/oracle on 3 pods, sparse on and off: the
    reference's rows, the single-device rows, ≤ 2 syncs per group, no
    duplicate pair, and sparse on/off byte-identical."""
    base, tdb, single = worlds[scenario]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=3, shard_use_kernel=use_kernel,
                           pruning=pruning)
    got = tdb.query(q, d, backend="shard", policy=pol)
    assert_same_rows(got, base, (scenario, use_kernel, pruning),
                     entries=tdb.segments.packed(), queries=q.packed(),
                     d=d, max_borderline=1)
    _identical(got, single, "single-device torch")
    st = got.stats
    assert st.num_syncs <= 2 * st.num_groups
    assert len(set(_pairs(got))) == len(got)
    dense = tdb.query(q, d, backend="shard",
                      policy=pol.with_(shard_sparse=False))
    _identical(got, dense, "sparse on/off")


def test_hierarchical_kernel_path_prunes_and_skips(worlds):
    """C3 with the kernels, hierarchical: the pod-partitioned K-box plan
    index is used, live-tile lists prune tiles, and sparse dispatch
    skips pods."""
    _, tdb, _ = worlds["C3"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=4, shard_use_kernel=True,
                           pruning="hierarchical")
    eng = tdb.backend("shard", pol).engine
    assert eng.plan_pruning == "hierarchical" and eng.plan_index is not None
    assert eng.pruning == "hierarchical"
    res, sched = tdb.query_stream(q, d, backend="shard", policy=pol.with_(
        stream_min_deadline=30.0))
    rt = sched.routing
    assert rt is not None and rt.num_pods == 4
    assert rt.pods_skipped > 0 and rt.padded_interactions_avoided > 0
    assert int(rt.pod_hits.sum()) >= len(res)
    tiles = tdb.query(q, d, backend="shard", policy=pol).stats.batches
    assert sum(b.num_tiles for b in tiles) > 0


def test_backend_key_normalizes_irrelevant_knobs(worlds):
    """As in the reference: without the kernels compaction is dense and
    kernel pruning none, so those knobs share one engine."""
    _, tdb, _ = worlds["S2"]
    a = tdb.backend("shard", tdb.policy.with_(compaction="fused"))
    b = tdb.backend("shard", tdb.policy.with_(compaction="fused_rowloop"))
    assert a is b and a.engine.compaction == "dense"
    assert a.engine.pruning == "none" and a.engine.use_kernel is False
    k = tdb.backend("shard", tdb.policy.with_(shard_use_kernel=True))
    assert k is not a and k.engine.compaction == "fused"
    assert k.engine.pruning == "spatial"
    assert tdb.policy.shard_pods is None and a.engine.ways == 1
    plan = tdb.plan(tdb.scenario_queries, tdb.policy.with_(
        shard_capacity=512), backend="shard")
    assert set(plan.capacities) == {512}


def test_overflow_retry_reuses_prepared_blocks(worlds, monkeypatch):
    """A tiny per-pod capacity overflows; the retry re-launches from the
    prepared blocks (``redispatch``) and rows stay exact."""
    _, tdb, single = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    calls = []
    real = TD._PodShardDispatcher.redispatch

    def spy(self, dp, capacity):
        calls.append(capacity)
        return real(self, dp, capacity)

    monkeypatch.setattr(TD._PodShardDispatcher, "redispatch", spy)
    for pipeline in (True, False):
        pol = tdb.policy.with_(shard_pods=3, shard_use_kernel=True,
                               shard_capacity=16, pipeline=pipeline)
        got = tdb.query(q, d, backend="shard", policy=pol)
        _identical(got, single, pipeline)
        assert got.stats.total_retries > 0
    assert calls


def test_caller_order(worlds):
    _, tdb, single = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    perm = np.random.default_rng(13).permutation(len(q))
    got = tdb.query(q.take(perm), d, backend="shard",
                    policy=tdb.policy.with_(shard_pods=3))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    expect_q = inv[single.query_idx]
    rank = np.lexsort((single.entry_idx, expect_q))
    np.testing.assert_array_equal(got.query_idx, expect_q[rank])
    np.testing.assert_array_equal(got.entry_idx, single.entry_idx[rank])


# ----------------------------------------------------------------------
# Serving: broker, faults, query_stream.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pods", [1, 3])
def test_broker_slices_and_routing(worlds, pods):
    _, tdb, _ = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=pods)
    base = tdb.query(q, d, backend="shard", policy=pol)
    broker = tdb.broker(backend="shard", policy=pol)
    delivered = []
    ticket = broker.submit(q, d, group_size=2,
                           on_slice=lambda tk, sl: delivered.append(sl))
    assert ticket.state == "pending"
    broker.step()
    assert ticket.state in ("partial", "done")
    res = ticket.result()
    _identical(res, base, "ticket")
    for f in ("entry_idx", "entry_traj", "entry_seg", "query_idx",
              "t_enter", "t_exit"):
        concat = np.concatenate([getattr(s.result, f) for s in delivered])
        np.testing.assert_array_equal(concat, getattr(base, f),
                                      err_msg="slice:" + f)
    assert all(s.num_syncs <= 2 for s in delivered)
    rt = ticket.routing
    assert rt is not None and rt.num_pods == pods
    assert rt.batches == len(ticket.plan.batches)
    assert len(rt.pods_per_batch) == rt.batches
    dispatched = sum(1 for b in ticket.plan.batches if b.num_candidates > 0)
    assert sum(1 for n in rt.pods_per_batch if n > 0) == dispatched
    assert int(rt.pod_hits.sum()) == len(res)
    assert 1 <= max(rt.pods_per_batch) <= pods
    assert rt.hit_balance >= 1.0


def test_fully_pruned_ticket_records_empty_routing(worlds):
    _, tdb, _ = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    _, t_max = tdb.segments.temporal_extent
    far = SegmentArray(q.xs, q.ys, q.zs, q.xe, q.ye, q.ze,
                       q.ts + (t_max + 100.0), q.te + (t_max + 100.0),
                       q.seg_id, q.traj_id)
    ticket = tdb.broker(backend="shard").submit(far, d, group_size=2)
    assert len(ticket.result()) == 0
    rt = ticket.routing
    assert rt.batches == len(ticket.plan.batches) > 0
    assert rt.pods_per_batch == [0] * rt.batches
    assert rt.mean_pods_per_batch == 0.0 and rt.hit_balance == 0.0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pod_dropout_reroutes_with_same_rows(worlds, use_kernel):
    _, tdb, single = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=3, shard_use_kernel=use_kernel)
    broker = tdb.broker(backend="shard", policy=pol,
                        retry=RetryPolicy(**_FAST))
    spec = faults.FaultSpec("shard.pod", "pod_dropout", times=1,
                            match={"pod": 1})
    with faults.active(faults.FaultPlan([spec])) as plan:
        t = broker.submit(q, d, group_size=2)
        res = t.result()
    assert [e.kind for e in plan.events] == ["pod_dropout"]
    assert res.degraded
    assert [g.stage for g in t.health.degradations] == ["route"]
    assert t.health.degradations[0].after == "single-device"
    _identical(res, single, "reroute")


def test_pod_dropout_without_retry_is_structured(worlds):
    _, tdb, _ = worlds["S2"]
    broker = tdb.broker(backend="shard")
    spec = faults.FaultSpec("shard.pod", "pod_dropout", times=None)
    with faults.active(faults.FaultPlan([spec])):
        t = broker.submit(tdb.scenario_queries, tdb.scenario_d)
        with pytest.raises(PodFailedError):
            t.result()
    assert broker.inflight_interactions == 0


@pytest.mark.parametrize("site,kind,kw", [
    ("shard.count", "corrupt_count", dict(factor=4.0, bias=7)),
    ("shard.count", "corrupt_count", dict(factor=0.0, bias=0)),
    ("shard.dispatch", "delay", dict(delay=0.001)),
    ("shard.marshal", "delay", dict(delay=0.001)),
])
def test_shard_fault_sites_keep_exact_rows(worlds, site, kind, kw):
    """``marshal`` masks on the -1 pads, never on ``count``: a corrupted
    total costs at most a bounded retry, and rows stay exact."""
    _, tdb, _ = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=3)
    clean = tdb.query(q, d, backend="shard", policy=pol)
    spec = faults.FaultSpec(site, kind, times=None, **kw)
    with faults.active(faults.FaultPlan([spec])) as plan:
        res = tdb.query(q, d, backend="shard", policy=pol)
    assert plan.events and {e.site for e in plan.events} == {site}
    _identical(res, clean, site)


def test_query_block_site_not_fired_inside_pod_step(worlds):
    """As in the reference, ``ops.query_block`` fires for host-side
    dispatches only, not inside the pod step."""
    _, tdb, _ = worlds["S2"]
    spec = faults.FaultSpec("ops.query_block", "error", times=None)
    with faults.active(faults.FaultPlan([spec])) as plan:
        tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="shard",
                  policy=tdb.policy.with_(shard_pods=3,
                                          shard_use_kernel=True))
    assert plan.events == []


def test_query_stream_shard_routes_per_pod(worlds):
    _, tdb, single = worlds["S2"]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(shard_pods=3, stream_min_deadline=30.0)
    res, sched = tdb.query_stream(q, d, backend="shard", policy=pol)
    _identical(res, single, "stream")
    assert sched.completed == res.plan.num_batches
    rt = sched.routing
    assert rt is not None and rt.num_pods == 3
    assert rt.batches >= res.plan.num_batches          # incl. re-issue
    assert int(rt.pod_hits.sum()) >= len(res)


# ----------------------------------------------------------------------
# The 2-D sharded step.
# ----------------------------------------------------------------------
def test_distributed_engine_matches_brute():
    from repro_torch.core.engine import brute_force
    from repro_torch.data import trajgen
    db, queries, d = trajgen.make_scenario("S3", scale=0.005)
    bf = brute_force(db, queries, d, device=CPU)
    eng = TD.DistributedEngine(db, cand_ways=4, num_bins=200,
                               capacity_per_shard=8192, device=CPU)
    out = eng.query_batch(queries.packed(), float(queries.ts.min()),
                          float(queries.te.max()), d)
    order = np.lexsort((out["query_idx"], out["entry_idx"]))
    assert out["entry_idx"].shape[0] == len(bf) > 0
    np.testing.assert_array_equal(out["entry_idx"][order], bf.entry_idx)
    np.testing.assert_allclose(out["t_enter"][order], bf.t_enter, atol=1e-4)


@pytest.mark.parametrize("qry_ways", [1, 2])
def test_sharded_count_and_query_fns(worlds, qry_ways):
    from repro_torch.kernels import ops
    _, tdb, _ = worlds["S2"]
    e = tdb.segments.packed()[:1024]
    q = tdb.scenario_queries.packed()[:64]
    d = np.float32(tdb.scenario_d)
    want = int(ops.count_hits(e, q, d, device=CPU))
    assert want > 0
    count = TD.make_sharded_count_fn([CPU], 4, qry_ways)
    assert int(count(e, q, d)) == want
    fn, ways = TD.make_sharded_query_fn([CPU], 4, 512, qry_ways=qry_ways)
    out = fn(e, q, d)
    assert ways == 4 and out["entry_idx"].shape == (4 * qry_ways * 512,)
    assert int(out["count"].sum()) == want
    keep = out["entry_idx"].numpy() >= 0
    got = set(zip(out["entry_idx"].numpy()[keep].tolist(),
                  out["query_idx"].numpy()[keep].tolist()))
    _, _, hit = ops.interaction_tiles(e, q, d, device=CPU)
    assert got == set(zip(*np.nonzero(hit.numpy())))
    with pytest.raises(ValueError):
        count(e[:1023], q, d)


# ----------------------------------------------------------------------
# Against the reference's 8-device host mesh.
# ----------------------------------------------------------------------
_MESH_SCRIPT = textwrap.dedent("""
    import functools, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    assert jax.device_count() == 8
    import repro.api as R
    import repro.core.distributed as RD
    # The reference's Pallas kernels under shard_map need check_vma off
    # on jax 0.9.0; rebinding the module's alias changes no file.
    RD._shard_map = functools.partial(jax.shard_map, check_vma=False)
    import repro_torch.core.distributed as TD
    from repro_torch.api import ExecutionPolicy, TrajectoryDB

    def record(cls):
        log, orig = [], cls.marshal
        def marshal(self, dp, count):
            log.append((int(dp.batch.q_first), int(dp.batch.cand_first),
                        dp.capacity, np.asarray(dp.out["count"]).tolist()))
            return orig(self, dp, count)
        cls.marshal = marshal
        return log

    ref_log, port_log = record(RD._PodShardDispatcher), record(
        TD._PodShardDispatcher)
    CASES = [("S2", 0.01, dict(batching="periodic", batch_params={"s": 32},
                               num_bins=200, shard_sparse=False)),
             ("C3", 0.05, dict(num_bins=8, index_kboxes=4, max_subranges=16,
                               pruning="hierarchical", shard_sparse=False)),
             ("C3", 0.05, dict(num_bins=8, index_kboxes=4, max_subranges=16,
                               pruning="spatial", shard_sparse=True))]
    for name, scale, fields in CASES:
        for kernel in (True, False):
            rdb = R.TrajectoryDB.from_scenario(name, scale=scale,
                policy=R.ExecutionPolicy(shard_use_pallas=kernel,
                                         interpret=True, **fields))
            assert rdb.backend("shard").engine.ways == 8
            want = rdb.query(rdb.scenario_queries, rdb.scenario_d,
                             backend="shard")
            tdb = TrajectoryDB.from_scenario(name, scale=scale, device="cpu",
                policy=ExecutionPolicy(shard_pods=8, shard_use_kernel=kernel,
                                       **fields))
            got = tdb.query(tdb.scenario_queries, tdb.scenario_d,
                            backend="shard")
            label = (name, fields.get("pruning"), kernel)
            assert len(got) == len(want) > 0, label
            for f in ("entry_idx", "entry_traj", "entry_seg", "query_idx"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)
            for f in ("t_enter", "t_exit"):
                np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                           rtol=1e-4, atol=1e-3, err_msg=f)
            # per-pod count vectors of every dispatch (retries included)
            assert ref_log == port_log, (label, ref_log[:2], port_log[:2])
            assert ref_log, label
            ref_log.clear(); port_log.clear()
            a, b = got.stats, want.stats
            assert a.num_syncs == b.num_syncs and a.num_groups == b.num_groups
            for x, y in zip(a.batches, b.batches, strict=True):
                assert ((x.pruned_tiles, x.num_tiles, x.num_hits, x.retries)
                        == (y.pruned_tiles, y.num_tiles, y.num_hits,
                            y.retries)), (label, x, y)
            print("CASE_OK", label, len(got),
                  sum(x.num_tiles for x in a.batches))
    print("SHARD_MESH_OK")
""")


def test_shard_equals_reference_8_device_mesh_subprocess():
    """``shard_pods=8`` (round-robin on the one CPU device) against the
    reference's forced 8-device host mesh: rows, each dispatch's per-pod
    ``count`` vector and the ``ExecStats`` tile counters, with the
    kernels (plain twins) against Pallas in interpret mode and with the
    oracles."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "SHARD_MESH_OK" in proc.stdout
    assert proc.stdout.count("CASE_OK") == 6
