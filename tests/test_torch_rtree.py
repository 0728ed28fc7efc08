"""The R-tree baseline (``repro_torch.core.rtree``, ``backend="rtree"``)
on the CPU against the reference's ``repro.core.rtree`` on the same
seeded inputs.

The tree is numpy on both sides, so its arrays must be equal exactly.
Query results are compared as the facade tests compare them
(``_torch_rows``): index columns exact, ``t_enter``/``t_exit`` within
``rtol=1e-4, atol=1e-3``.  Against the port's own ``brute`` the rows must
be the same pairs; against the reference one borderline pair may differ:
on C1 at scale 0.05 the pair (entry 26177, query 30) closes to 5.0021
(float64) of d = 5 at coordinates near 570, which the port's float32
reports as a hit (as the reference's eager oracle does on that pair
alone) and the reference's jit-fused backends do not.
"""
import numpy as np
import pytest

import repro.api as R
from repro.core.rtree import RTree as RefRTree
from repro.core.segments import SegmentArray as RefSegments
from _torch_rows import assert_same_rows
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core.rtree import RTree, RTreeEngine
from repro_torch.core.segments import SegmentArray
from repro_torch.data import trajgen

CPU = "cpu"

#: (scenario, scale, policy fields) of the engine comparisons.
SCENARIOS = {
    "S2": (0.01, dict(batching="periodic", batch_params={"s": 32},
                      num_bins=200)),
    "C1": (0.05, dict(num_bins=100)),
}


def _random_db(seed: int, n: int = 600) -> SegmentArray:
    """Sorted random segments in 9 trajectories (numpy seed)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 50.0, n)).astype(np.float32)
    te = ts + rng.uniform(0.1, 3.0, n).astype(np.float32)
    p0 = rng.uniform(0, 30.0, (n, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    return SegmentArray(
        xs=p0[:, 0], ys=p0[:, 1], zs=p0[:, 2], xe=p1[:, 0], ye=p1[:, 1],
        ze=p1[:, 2], ts=ts, te=te, seg_id=np.arange(n, dtype=np.int32),
        traj_id=(np.arange(n, dtype=np.int32) % 9))


def _ref_segments(seg: SegmentArray) -> RefSegments:
    return RefSegments(**{f: getattr(seg, f) for f in (
        "xs", "ys", "zs", "xe", "ye", "ze", "ts", "te", "seg_id",
        "traj_id")})


@pytest.mark.parametrize("r", [4, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_arrays_equal_reference(seed, r):
    """Leaves, STR order and every level: exactly the reference's."""
    seg = _random_db(seed)
    got, want = RTree(seg, r=r, fanout=16), RefRTree(_ref_segments(seg),
                                                     r=r, fanout=16)
    for f in ("seg_order", "leaf_first", "leaf_count", "leaf_lo", "leaf_hi",
              "leaf_perm", "leaf_level_children"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert len(got.levels) == len(want.levels) >= 2
    for a, b in zip(got.levels, want.levels):
        for f in ("lo", "hi", "child", "count"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


@pytest.mark.parametrize("d", [0.5, 2.0])
def test_candidate_segments_equal_reference(d):
    seg = _random_db(2)
    got, want = RTree(seg, r=12), RefRTree(_ref_segments(seg), r=12)
    queries = _random_db(3, n=40).packed()
    total = 0
    for qseg in queries:
        a = got.candidate_segments(qseg, d)
        np.testing.assert_array_equal(a, want.candidate_segments(qseg, d))
        total += a.size
    assert total > 0


@pytest.fixture(scope="module")
def worlds():
    """Per scenario: (reference rtree result, port database on the CPU)."""
    out = {}
    for name, (scale, fields) in SCENARIOS.items():
        rdb = R.TrajectoryDB.from_scenario(
            name, scale=scale, policy=R.ExecutionPolicy(**fields))
        base = rdb.query(rdb.scenario_queries, rdb.scenario_d,
                         backend="rtree")
        assert len(base) > 0, name
        tdb = TrajectoryDB.from_scenario(
            name, scale=scale, policy=ExecutionPolicy(**fields), device=CPU)
        out[name] = (base, tdb)
    return out


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_backend_equals_reference_and_brute(worlds, scenario, threads):
    base, tdb = worlds[scenario]
    q, d = tdb.scenario_queries, tdb.scenario_d
    pol = tdb.policy.with_(rtree_threads=threads)
    got = tdb.query(q, d, backend="rtree", policy=pol)
    assert got.stats is None and got.backend == "rtree"
    assert_same_rows(got, base, (scenario, threads),
                     entries=tdb.segments.packed(), queries=q.packed(), d=d,
                     max_borderline=1)
    assert_same_rows(got, tdb.query(q, d, backend="brute"),
                     (scenario, threads, "brute"))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_query_and_parallel_agree(worlds, scenario):
    """``RTreeEngine.query`` and ``query_parallel`` directly, on the
    sorted queries: the same rows, bit for bit."""
    _, tdb = worlds[scenario]
    q = tdb.scenario_queries
    q = q if q.is_sorted() else q.sort_by_tstart()
    eng = RTreeEngine(tdb.segments, r=12, fanout=16)
    a = eng.query(q, tdb.scenario_d)
    b = eng.query_parallel(q, tdb.scenario_d, num_threads=3)
    for f in ("entry_idx", "query_idx", "t_enter", "t_exit"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_policy_knobs_and_caching(worlds):
    """A per-call policy's rtree knobs are honoured and cached, as in the
    reference facade (``tests/test_api.py``)."""
    _, db = worlds["S2"]
    q, d = db.scenario_queries, db.scenario_d
    assert (db.policy.rtree_r, db.policy.rtree_fanout,
            db.policy.rtree_threads) == (12, 16, 1)
    pol = db.policy.with_(rtree_threads=2, rtree_r=4, capacity=512)
    assert db.backend("rtree", pol) is not db.backend("rtree")
    assert db.backend("rtree", pol).threads == 2
    assert db.backend("rtree", pol).engine.tree.r == 4
    assert db.backend("rtree", pol) is db.backend("rtree", pol)    # cached
    assert db.engine("torch", pol).default_capacity == 512
    res = db.query(q, d, backend="rtree", policy=pol)
    base = db.query(q, d, backend="rtree")
    np.testing.assert_array_equal(res.entry_idx, base.entry_idx)
    with pytest.raises(ValueError, match="has no engine"):
        db.engine("rtree")


def test_query_stream_rejects_rtree(worlds):
    _, db = worlds["S2"]
    with pytest.raises(ValueError, match="engine backend"):
        db.query_stream(db.scenario_queries, db.scenario_d, backend="rtree")


def test_rtree_runs_on_host_for_any_device(worlds, monkeypatch):
    """The refine asks for the CPU oracle explicitly, whatever device the
    database names: the baseline never launches a kernel."""
    from repro_torch.core import rtree
    from repro_torch.kernels import ops
    calls = []
    real = ops.interaction_tiles

    def spy(*args, **kw):
        calls.append((kw.get("device"), kw.get("use_kernel")))
        return real(*args, **kw)

    monkeypatch.setattr(rtree.ops, "interaction_tiles", spy)
    _, db = worlds["S2"]
    db.query(db.scenario_queries, db.scenario_d, backend="rtree")
    assert calls and set(calls) == {("cpu", False)}


def test_scenarios_match_reference_generator():
    """The engine comparisons above rest on equal inputs."""
    for name, (scale, _) in SCENARIOS.items():
        a = trajgen.make_scenario(name, scale=scale)
        from repro.data import trajgen as rt
        b = rt.make_scenario(name, scale=scale)
        np.testing.assert_array_equal(a[0].packed(), b[0].packed())
        np.testing.assert_array_equal(a[1].packed(), b[1].packed())
