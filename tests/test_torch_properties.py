"""The exactness properties on the port's CPU path (the kernels' plain
twins and the torch oracle), against brute force, a float64 oracle and
the reference.

The reference's hypothesis properties (``tests/test_pruning.py``,
``tests/test_hierarchical.py``, ``tests/test_properties.py``) run on the
port's index, batching, planner and facade, and two are the port's own:

* pruning never changes the result set: every pruning mode with every
  compaction gives byte-identical rows (the same float32 arithmetic on
  the same pairs, so no tolerance);
* near-tangent pairs (``chip_smoke.near_tangent``, the generator phase
  properties sweeps on the card): pairs whose float64 closest approach
  lies within a few round-off bands of ``d``, at coordinates of 1e3-1e4,
  mixed into random databases.  Pruning must not change their rows, and
  every difference from a float64 oracle must lie inside the pair's own
  round-off band, ``prune_limit`` at the pair's ``solve_scale``.  With
  the slack removed from the tile test, the rows must change on some
  drawn case: the negative control that shows the family reaches the
  band.

The band is sized by ``solve_scale`` (coordinates plus ``|v|·t_start``),
not by the coordinates alone: the float32 solve anchors each segment at
time zero, and ``test_fast_late_pair_kept_by_every_pruning_mode`` keeps
the pair with which the coordinate-sized slack dropped a float32 hit
(ROADMAP, queue C).

Every property draws its examples through ``_hypothesis_compat`` with
``derandomize=True``, so the installed hypothesis draws the same examples
on every run (the shim's draws are seeded by the test's name anyway); a
drawn seed builds the inputs with numpy.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import repro.api as R
from repro.core.index import TemporalBinIndex as RefIndex
from repro.data import trajgen as ref_trajgen
from _hypothesis_compat import given, settings
from _hypothesis_compat import strategies as st
from _torch_rows import assert_same_rows, closest_approach
from conftest import random_segments
from repro.core.segments import SegmentArray as RefSegmentArray
from repro_torch import state
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core import batching
from repro_torch.core.engine import DistanceThresholdEngine, brute_force
from repro_torch.core.index import (MAX_KBOXES, TemporalBinIndex,
                                    dispatch_prune_threshold, mbr_gap2,
                                    prune_limit, solve_scale)
from repro_torch.kernels import distthresh as dt
from repro_torch.kernels import ops, ref

CPU = "cpu"
ALGORITHMS = tuple(batching.ALGORITHMS)
MODES = [(p, c) for p in ops.PRUNINGS for c in ops.COMPACTIONS]
IDX_FIELDS = ("entry_idx", "entry_traj", "entry_seg", "query_idx")
FIELDS = IDX_FIELDS + ("t_enter", "t_exit")
#: Pairs the reference's ``jnp`` may decide otherwise than the port (its
#: jit-fused XLA may contract products into FMAs, and its prune slack is
#: sized by the coordinates alone), each within the round-off band.
MAX_BORDERLINE = 2
#: The reference's eps for interval endpoints (tests/test_properties.py).
EPS = 1e-3


def _chip_smoke():
    """``chip_smoke.py``, loaded by path for its input generators."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's many small ops: beside other
    test workers on the same cores, a pool per worker spends its time
    waiting for cores (one property ran 90× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cols(segs) -> dict:
    return {f: np.asarray(getattr(segs, f)) for f in state.SEGMENT_FIELDS}


def _port(segs):
    """The port's ``SegmentArray`` of a reference one (or of the port's)."""
    return state.segments_from_numpy(_cols(segs))


def _ref(segs) -> RefSegmentArray:
    return RefSegmentArray(**{k: v.copy() for k, v in _cols(segs).items()})


def bimodal_segments(rng, n: int, *, far=(520.0, 180.0, 0.0),
                     far_frac=0.75, by_time=False):
    """``random_segments`` with ``far_frac`` of them moved ~550 away (a
    second cloud; by time when ``by_time``, so kernel tiles are
    cloud-pure), as the reference's ``tests/test_hierarchical.py``
    builds its bimodal worlds."""
    segs = _port(random_segments(rng, n))
    if by_time:
        shift = segs.ts > 50.0 * (1 - far_frac)
    else:
        shift = rng.random(n) < far_frac
    cols = _cols(segs)
    for k, axis in enumerate(("xs", "ys", "zs", "xe", "ye", "ze")):
        cols[axis] = cols[axis] + shift * np.float32(far[k % 3])
    return state.segments_from_numpy(cols)


def clustered_world(rng, n: int, nq: int):
    """``chip_smoke.clustered_segs`` at ~256-row windows (one kernel tile
    at the 64-row tiles the tests use is a quarter window)."""
    e, q = CS.clustered_segs(rng, n, nq, max(2, n // 256), extent=12.4)
    return CS.segments_of(e), CS.segments_of(q)


def tangent_world(rng, d: float):
    """16 near-tangent clusters of 32 rows (one 32-row tile each), 100
    background entries and 10 background queries."""
    e, q = CS.near_tangent(rng, d, 16, 32, background=100, bg_queries=10)
    return CS.segments_of(e), CS.segments_of(q)


def _identical(got, want, label) -> None:
    assert len(got) == len(want), (label, len(got), len(want))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{label} {f}")


def _keys(res) -> set:
    return set(zip(res.entry_idx.tolist(), res.query_idx.tolist()))


def band_ratio(e, q, d: float) -> float:
    """|closest approach − d| over the pair's own round-off band
    (``prune_limit(d, solve_scale(pair)) − d``): at most 1 for a pair
    that float32 may decide otherwise than float64."""
    band = prune_limit(d, solve_scale(np.stack([e, q]))) - d
    return abs(closest_approach(e, q) - d) / band


def _oracle_differences(db, res, queries, d):
    """The (entry, query) pairs on which ``res`` and a float64 oracle
    (``chip_smoke.closest_approach64``, checked pair by pair against
    ``_torch_rows.closest_approach``) disagree, with the packed sorted
    entries and the packed queries they index."""
    entries, qp = db.segments.packed(), queries.packed()
    ca = CS.closest_approach64(entries, qp).numpy()
    oracle = set(zip(*np.nonzero(ca <= d)))
    diff = {(int(e), int(q)) for e, q in oracle ^ _keys(res)}
    for e, q in diff:
        assert ca[e, q] == pytest.approx(closest_approach(entries[e], qp[q]),
                                         rel=1e-9, abs=1e-9)
    return diff, entries, qp


# ----------------------------------------------------------------------
# 1-3. The index: sub-ranges never drop a true hit; the box estimate is
# conservative (tests/test_pruning.py:158, tests/test_hierarchical.py:137
# and :166).
# ----------------------------------------------------------------------
def _may_hit(db, qt0, qt1, qlo, qhi, d):
    """The necessary condition for a hit: temporal overlap and a pair box
    gap within ``d``."""
    elo, ehi = db.mbrs()
    return ((db.ts <= qt1) & (db.te >= qt0)
            & (mbr_gap2(elo, ehi, qlo, qhi) <= float(d) ** 2))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d=st.floats(0.2, 12.0),
       num_bins=st.sampled_from([5, 37, 200]))
def test_subranges_never_drop_a_true_hit(seed, d, num_bins):
    rng = np.random.default_rng(seed)
    db = _port(random_segments(rng, 250))
    queries = _port(random_segments(rng, 12))
    idx = TemporalBinIndex.build(db, num_bins=num_bins)
    qlo, qhi = queries.mbrs()
    limit = idx.prune_threshold(float(d), queries.packed())
    for k in range(0, len(queries), 3):
        qt0, qt1 = float(queries.ts[k]), float(queries.te[k])
        subs = idx.candidate_subranges(qt0, qt1, qlo[k], qhi[k],
                                       limit=limit)
        for (f1, l1), (f2, l2) in zip(subs, subs[1:]):
            assert l1 < f2                       # disjoint + increasing
        covered = np.zeros(len(db), bool)
        for f, l in subs:
            covered[f:l + 1] = True
        missing = np.nonzero(_may_hit(db, qt0, qt1, qlo[k], qhi[k], d)
                             & ~covered)[0]
        assert missing.size == 0, (k, missing[:5], subs)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d=st.floats(0.2, 12.0),
       kboxes=st.integers(2, MAX_KBOXES),
       num_bins=st.sampled_from([5, 37, 128]))
def test_box_subranges_never_drop_a_true_hit(seed, d, kboxes, num_bins):
    rng = np.random.default_rng(seed)
    db = bimodal_segments(rng, 250)
    queries = _port(random_segments(rng, 12))
    idx = TemporalBinIndex.build(db, num_bins=num_bins, kboxes=kboxes)
    qlo, qhi = queries.mbrs()
    limit = idx.prune_threshold(float(d), queries.packed())
    for k in range(0, len(queries), 3):
        qt0, qt1 = float(queries.ts[k]), float(queries.te[k])
        subs = idx.candidate_subranges(qt0, qt1, qlo[k], qhi[k],
                                       limit=limit, level="box")
        for (f1, l1), (f2, l2) in zip(subs, subs[1:]):
            assert l1 < f2
        covered = np.zeros(len(db), bool)
        for f, l in subs:
            covered[idx.perm[f:l + 1]] = True    # permuted → original
        missing = np.nonzero(_may_hit(db, qt0, qt1, qlo[k], qhi[k], d)
                             & ~covered)[0]
        assert missing.size == 0, (k, missing[:5], subs)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d=st.floats(0.5, 10.0),
       kboxes=st.integers(2, MAX_KBOXES))
def test_box_estimate_is_conservative(seed, d, kboxes):
    rng = np.random.default_rng(seed)
    db = bimodal_segments(rng, 300)
    queries = _port(random_segments(rng, 16))
    idx = TemporalBinIndex.build(db, num_bins=100, kboxes=kboxes)
    qlo, qhi = queries.mbrs()
    qt0 = queries.ts.astype(np.float64)
    qt1 = queries.te.astype(np.float64)
    limit = idx.prune_threshold(float(d), queries.packed())
    for cap in (None, 4):
        est = idx.estimate_pruned_candidates_batch(
            qt0, qt1, qlo, qhi, limit=limit, level="box", max_subranges=cap)
        temporal = idx.num_candidates_batch(qt0, qt1)
        kw = {} if cap is None else {"max_subranges": cap}
        for k in range(len(queries)):
            exact = idx.pruned_num_candidates(
                float(qt0[k]), float(qt1[k]), qlo[k], qhi[k], limit=limit,
                level="box", **kw)
            assert exact <= est[k] <= temporal[k], (k, cap)


@pytest.mark.parametrize("name,scale", [("S1", 0.01), ("S10", 0.01),
                                        ("C1", 0.01), ("C3", 0.02)])
def test_prune_threshold_equals_the_three_term_rule(name, scale):
    """The index's one threshold per query set equals bit for bit the
    rule sized per call, ``prune_limit(d, max(database scale, the call's
    query-MBR coordinates, the queries' solve_scale))``, for every MBR a
    call can pass (a batch's union takes one query's largest coordinate);
    a carried reference index, floored by the facade, gives the same."""
    segs, queries, d = ref_trajgen.make_scenario(name, scale=scale)
    db, q = _port(segs), _port(queries)
    index = TemporalBinIndex.build(db, 100, kboxes=8)
    packed = q.packed()
    got = index.prune_threshold(d, packed)
    qlo, qhi = q.mbrs()
    coords = np.maximum(np.abs(qlo), np.abs(qhi)).max(axis=1)
    scales = (solve_scale(db.packed()), solve_scale(packed))
    for c in np.unique(coords):
        assert got == prune_limit(d, max(scales[0], float(c), scales[1]))
    carried = state.index_from_numpy(vars(RefIndex.build(segs, 100,
                                                         kboxes=8)))
    assert carried.prune_threshold(d, packed) <= got
    tdb = TrajectoryDB.from_segments(
        db, device=CPU, index=carried,
        policy=ExecutionPolicy(num_bins=100, index_kboxes=8))
    assert tdb.index.prune_threshold(d, packed) == got


# ----------------------------------------------------------------------
# 4. The pruned query equals brute force, for all six batching algorithms
# (tests/test_pruning.py:188), and the reference's jnp.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("algo", ALGORITHMS)
@settings(max_examples=4, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d=st.floats(0.5, 8.0))
def test_pruned_query_equals_brute_force(algo, seed, d):
    """``backend="torch"`` with spatial pruning against the port's brute
    force (every column exact: the same float32 oracle on the same
    pairs) and against the reference's ``jnp``, each algorithm at the
    facade's default parameters (``ExecutionPolicy.
    resolved_batch_params``)."""
    rng = np.random.default_rng(seed)
    segs, queries = random_segments(rng, 300), random_segments(rng, 30)
    db = TrajectoryDB.from_segments(
        _port(segs), policy=ExecutionPolicy(num_bins=64, batching=algo),
        device=CPU)
    q = _port(queries)
    got = db.query(q, float(d), backend="torch", pruning="spatial")
    _identical(got, db.query(q, float(d), backend="brute"), (algo, "brute"))
    rdb = R.TrajectoryDB.from_segments(
        segs, policy=R.ExecutionPolicy(num_bins=64, batching=algo))
    want = rdb.query(queries, float(d), backend="jnp", pruning="spatial")
    entries, qp = db.segments.packed(), q.packed()
    assert_same_rows(got, want, (algo, seed), entries=entries, queries=qp,
                     d=float(d), max_borderline=MAX_BORDERLINE,
                     pair_scale=True)


# ----------------------------------------------------------------------
# 5-8. tests/test_properties.py on the port.
# ----------------------------------------------------------------------
@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), num_bins=st.sampled_from([3, 17, 256]),
       s=st.integers(1, 60), d=st.floats(0.5, 8.0))
def test_engine_equals_bruteforce_randomized(seed, num_bins, s, d):
    """A ``periodic`` plan through the engine (the kernels' plain twins,
    the tile early-out armed) equals brute force."""
    rng = np.random.default_rng(seed)
    eng = DistanceThresholdEngine(_port(random_segments(rng, 300)),
                                  num_bins=num_bins, device=CPU)
    queries = _port(random_segments(rng, 40))
    plan = batching.periodic(eng.index, queries, s)
    rs, _ = eng.execute(queries, float(d), plan)
    rs = rs.sorted_canonical()
    bf = brute_force(eng.db, queries, float(d), device=CPU)
    assert len(rs) == len(bf)
    for f in ("entry_idx", "query_idx", "t_enter", "t_exit"):
        np.testing.assert_array_equal(getattr(rs, f), getattr(bf, f))


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d1=st.floats(0.5, 4.0),
       extra=st.floats(0.5, 4.0))
def test_result_set_monotone_in_d(seed, d1, extra):
    """d ≤ d' ⇒ results(d) ⊆ results(d'), on the query path (default
    policy: greedysetsplit-min, spatial pruning, the fused kernel)."""
    rng = np.random.default_rng(seed)
    db = TrajectoryDB.from_segments(_port(random_segments(rng, 200)),
                                    policy=ExecutionPolicy(num_bins=64),
                                    device=CPU)
    q = _port(random_segments(rng, 20))
    small = db.query(q, float(d1), backend="kernel")
    big = db.query(q, float(d1 + extra), backend="kernel")
    assert _keys(small) <= _keys(big)
    assert _keys(small) == _keys(brute_force(db.segments, q, float(d1),
                                             device=CPU))


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000))
def test_intervals_within_overlap(seed):
    """Every query-path interval lies inside the pair's common time and
    ``t_enter ≤ t_exit``, within the reference's eps."""
    rng = np.random.default_rng(seed)
    db = TrajectoryDB.from_segments(_port(random_segments(rng, 200)),
                                    policy=ExecutionPolicy(num_bins=64),
                                    device=CPU)
    q = _port(random_segments(rng, 20))
    rs = db.query(q, 5.0, backend="kernel")
    assert len(rs) > 0
    e, k = rs.entry_idx, rs.query_idx
    lo = np.maximum(db.segments.ts[e], q.ts[k])
    hi = np.minimum(db.segments.te[e], q.te[k])
    assert np.all(rs.t_enter <= rs.t_exit + EPS)
    assert np.all(rs.t_enter >= lo - EPS)
    assert np.all(rs.t_exit <= hi + EPS)


#: tests/test_properties.py's parameters for three algorithms, small
#: batches for the other three.
BATCH_KW = {"periodic": {"s": 5}, "setsplit-fixed": {"num_batches": 4},
            "setsplit-max": {"max_size": 8},
            "setsplit-minmax": {"min_size": 2, "max_size": 16},
            "greedysetsplit-min": {"bound": 4},
            "greedysetsplit-max": {"bound": 16}}


@pytest.mark.parametrize("algo", ALGORITHMS)
@settings(max_examples=4, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000))
def test_batching_never_loses_queries(algo, seed):
    """Every query lands in exactly one batch (contiguous, in order), and
    the plan equals the reference's on the same inputs."""
    from repro.core import batching as ref_batching
    from repro.core.engine import DistanceThresholdEngine as RefEngine
    rng = np.random.default_rng(seed)
    segs, queries = random_segments(rng, 150), random_segments(rng, 33)
    eng = DistanceThresholdEngine(_port(segs), num_bins=32, device=CPU)
    plan = batching.ALGORITHMS[algo](eng.index, _port(queries),
                                     **BATCH_KW[algo])
    assert plan.sizes().sum() == len(queries)
    assert plan.total_interactions >= 0
    firsts = [b.q_first for b in plan.batches]
    lasts = [b.q_last for b in plan.batches]
    assert firsts[0] == 0 and lasts[-1] == len(queries) - 1
    assert all(a == b + 1 for a, b in zip(firsts[1:], lasts[:-1]))
    want = ref_batching.ALGORITHMS[algo](RefEngine(segs, num_bins=32).index,
                                         queries, **BATCH_KW[algo])
    assert [(b.q_first, b.q_last, b.cand_first, b.cand_last, b.num_ints)
            for b in plan.batches] == [
        (b.q_first, b.q_last, b.cand_first, b.cand_last, b.num_ints)
        for b in want.batches]


# ----------------------------------------------------------------------
# 9. Pruning never changes the result set.
# ----------------------------------------------------------------------
def _nine_modes(db, q, d, label):
    """Every pruning × compaction mode through ``backend="kernel"``, each
    byte-identical to ``none/fused``; returns that result and the tiles
    the modes pruned."""
    base = db.query(q, d, backend="kernel", pruning="none",
                    compaction="fused")
    pruned = 0
    for pruning, compaction in MODES:
        res = db.query(q, d, backend="kernel", pruning=pruning,
                       compaction=compaction)
        _identical(res, base, (label, pruning, compaction))
        pruned += res.stats.pruned_tiles
    return base, pruned


WORLDS = {
    "random": lambda rng: (_port(random_segments(rng, 400)),
                           _port(random_segments(rng, 40))),
    "bimodal": lambda rng: (bimodal_segments(rng, 600, by_time=True),
                            _port(random_segments(rng, 40))),
    "clustered": lambda rng: clustered_world(rng, 1500, 60),
}


@pytest.mark.parametrize("world", list(WORLDS))
@settings(max_examples=6, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d=st.floats(0.2, 12.0),
       num_bins=st.sampled_from([3, 8, 64]),
       kboxes=st.sampled_from([1, 2, 4]), capacity=st.sampled_from(
           [4096, 64]))
def test_pruning_never_changes_the_result_set(world, seed, d, num_bins,
                                              kboxes, capacity):
    """The nine pruning × compaction modes give byte-identical rows, at
    64-row tiles and coarse bins (so the early-out and the live-tile
    lists have work), also when a small capacity makes batches overflow;
    and they equal brute force in their index columns."""
    rng = np.random.default_rng(seed)
    segs, q = WORLDS[world](rng)
    db = TrajectoryDB.from_segments(segs, device=CPU, policy=ExecutionPolicy(
        num_bins=num_bins, index_kboxes=kboxes, cand_blk=64, qry_blk=64,
        capacity=capacity))
    base, _ = _nine_modes(db, q, float(d), (world, seed))
    bf = db.query(q, float(d), backend="brute")
    for f in IDX_FIELDS:
        np.testing.assert_array_equal(getattr(base, f), getattr(bf, f))


def test_pruning_modes_prune_tiles_on_clustered_worlds():
    """Positive control of property 9: on the clustered and by-time
    bimodal worlds the tile early-out and the live-tile lists skip
    tiles (else the property would hold vacuously)."""
    pruned = {}
    for world in ("bimodal", "clustered"):
        rng = np.random.default_rng(7)
        segs, q = WORLDS[world](rng)
        db = TrajectoryDB.from_segments(segs, device=CPU,
                                        policy=ExecutionPolicy(
                                            num_bins=3, cand_blk=64,
                                            qry_blk=64))
        _, pruned[world] = _nine_modes(db, q, 3.0, world)
    assert all(n > 0 for n in pruned.values()), pruned


# ----------------------------------------------------------------------
# 10. Near-tangent pairs.
# ----------------------------------------------------------------------
def _tangent_db(rng, d, **policy):
    segs, q = tangent_world(rng, d)
    db = TrajectoryDB.from_segments(segs, device=CPU, policy=ExecutionPolicy(
        num_bins=64, cand_blk=32, qry_blk=32, **policy))
    return db, q


@settings(max_examples=16, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), d=st.floats(0.2, 12.0),
       kboxes=st.sampled_from([1, 2, 4]))
def test_near_tangent_pairs(seed, d, kboxes):
    """Property 9 on near-tangent pairs, and every difference from the
    float64 oracle inside the pair's own round-off band (``band_ratio``
    ≤ 1: ``prune_limit`` at the pair's ``solve_scale``, not the
    database's, which the fastest late segment sets)."""
    rng = np.random.default_rng(seed)
    db, q = _tangent_db(rng, float(d), index_kboxes=kboxes)
    base, _ = _nine_modes(db, q, float(d), ("near-tangent", seed))
    diff, entries, qp = _oracle_differences(db, base, q, float(d))
    for e, k in diff:
        assert band_ratio(entries[e], qp[k], float(d)) <= 1.0, (
            seed, (e, k), closest_approach(entries[e], qp[k]), float(d))


#: Seeds and thresholds of the negative control's drawn cases.
NEGATIVE_CASES = [(int(s), float(d)) for s, d in zip(
    np.random.default_rng(2025).integers(0, 10_000, 8),
    np.random.default_rng(2026).uniform(0.2, 12.0, 8))]


def test_near_tangent_negative_control(monkeypatch):
    """With the threshold of each route's tile test at d itself (no
    slack: ``dispatch_prune_threshold``, which the hierarchical route calls,
    and the ``d_prune`` of ``distthresh_tile_prep``, the spatial route's
    seam), the tile test drops float32 hits of near-tangent pairs whose
    box gap exceeds d: property 9 must fail on at least one drawn case,
    for each route."""
    prep = dt.distthresh_tile_prep

    def prep_no_slack(entries, queries_t, d, **kw):
        e_mbr, q_mbr, _ = prep(entries, queries_t, d, **kw)
        return e_mbr, q_mbr, ref._f32(np.float32(d), entries.device)
    monkeypatch.setattr(ops, "dispatch_prune_threshold",
                        lambda d, entries, queries: float(d))
    monkeypatch.setattr(dt, "distthresh_tile_prep", prep_no_slack)
    failed = []
    for seed, d in NEGATIVE_CASES:
        db, q = _tangent_db(np.random.default_rng(seed), d,
                            batching="periodic", batch_params={"s": 1})
        base = _keys(db.query(q, d, backend="kernel", pruning="none"))
        for pruning in ("spatial", "hierarchical"):
            if _keys(db.query(q, d, backend="kernel",
                              pruning=pruning)) != base:
                failed.append((seed, d, pruning))
    assert {p for _, _, p in failed} == {"spatial", "hierarchical"}, (
        "a route's tile test kept every drawn near-tangent hit", failed)


# ----------------------------------------------------------------------
# The fault the properties found: a fast pair late in time.
# ----------------------------------------------------------------------
#: Entry and query moving along x at 58 and 38 units a time unit, crossing
#: at t ≈ 108 with a y offset of 7.7345, against d = 7.7161: the float32
#: solve calls it a hit (its anchors x0 − v·ts are ~6,000, far beyond the
#: coordinates' 16), while the slack sized by the coordinates put the
#: prune threshold at 7.7163 and the box test dropped it.
FAST_LATE = (np.array([15.88990306854248, 0.0, 0.0, 3.194505453109741, 0.0,
                       0.0, 107.91468811035156, 108.13350677490234],
                      np.float32),
             np.array([0.24787813425064087, 7.734529495239258, 0.0,
                       8.473974227905273, 7.734529495239258, 0.0,
                       107.91468811035156, 108.13350677490234], np.float32),
             7.716147910393161)


def test_tile_prep_keeps_the_fast_late_threshold():
    """The spatial route's device-built threshold on the fault's pair:
    the plain twin of ``distthresh_tile_prep`` equals the host helpers bit
    for bit, and it keeps the pair's float32 hit."""
    e, q, d = FAST_LATE
    e_mbr, q_mbr, d_prune = dt.distthresh_tile_prep(
        torch.from_numpy(e[None]), torch.from_numpy(q[None]).T.contiguous(),
        d, cand_blk=256, qry_blk=256, device="cpu")
    want = np.float32(dispatch_prune_threshold(d, e[None], q[None]))
    assert d_prune.numpy().view(np.uint32) == want.view(np.uint32)
    np.testing.assert_array_equal(e_mbr.numpy(),
                                  ops._host_tile_mbrs(e[None], 256))
    np.testing.assert_array_equal(q_mbr.numpy(),
                                  ops._host_tile_mbrs(q[None], 256))
    assert closest_approach(e, q) <= float(d_prune)


def test_fast_late_pair_kept_by_every_pruning_mode():
    e, q, d = FAST_LATE
    coords = max(float(np.abs(e[:6]).max()), float(np.abs(q[:6]).max()))
    ca = closest_approach(e, q)
    _, _, hit = ref.pair_intervals(torch.from_numpy(e[None]),
                                   torch.from_numpy(q[None]), d)
    assert bool(hit[0])                            # a float32 hit ...
    assert ca > prune_limit(d, coords)             # ... the old slack cut
    assert ca <= prune_limit(d, solve_scale(np.stack([e, q])))
    # Slow segments earlier in time: the pair's entry is alone in its bin
    # and the coordinates stay within 16.
    other = CS.random_segs(np.random.default_rng(0), 50, t_span=(0.0, 50.0),
                           box=10.0)
    other[:, 3:6] = other[:, 0:3]
    entries = np.concatenate([other, e[None]])
    entries = entries[np.argsort(entries[:, 6], kind="stable")]
    segs, qs = CS.segments_of(entries), CS.segments_of(q[None])
    for kboxes in (1, 4):
        db = TrajectoryDB.from_segments(segs, device=CPU,
                                        policy=ExecutionPolicy(
                                            num_bins=16, index_kboxes=kboxes))
        base, _ = _nine_modes(db, qs, d, ("fast-late", kboxes))
        assert len(base) == 1 and base.t_enter[0] <= base.t_exit[0]
        _identical(db.query(qs, d, backend="torch"), base, "torch")
        assert _keys(db.query(qs, d, backend="brute")) == _keys(base)
    # The reference keeps the coordinate-sized slack: its spatial pruning
    # drops the hit that its unpruned path reports (a deliberate
    # difference, ROADMAP queue C).
    rdb = R.TrajectoryDB.from_segments(_ref(segs), policy=R.ExecutionPolicy(
        num_bins=16))
    assert len(rdb.query(_ref(qs), d, backend="jnp", pruning="none")) == 1
    assert len(rdb.query(_ref(qs), d, backend="jnp",
                         pruning="spatial")) == 0


def _tangent_pairs(rng, n: int, kind: str):
    """``n`` (entry, query) pairs, each crossing at a random time in its
    common time with separation d (1 + δ), |δ| log-uniform in [1e-8,
    0.1]: ``parallel`` along x with a y offset, or ``general`` (random
    directions, the offset perpendicular to the relative velocity);
    coordinates of magnitude 1 to 1e4, start times up to 400, speeds
    0.1 to 30.  Returns float32 (n, 8) entries and queries and float64 d."""
    d = rng.uniform(0.2, 12.0, n)
    ts = rng.uniform(0.0, 400.0, n) * (rng.random(n) < 0.7)
    dt = 10.0 ** rng.uniform(-1.0, 1.0, n)
    tc = ts + dt * rng.uniform(0.0, 1.0, n)
    centre = 10.0 ** rng.uniform(0.0, 4.0, (n, 1)) * rng.choice([-1, 1],
                                                                 (n, 3))
    speed = lambda: 10.0 ** rng.uniform(-1.0, 1.5, (n, 1))  # noqa: E731
    ve = rng.normal(0.0, 1.0, (n, 3)) * speed()
    if kind == "parallel":
        ve[:, 1:] = 0.0
        vq = ve.copy()
        vq[:, 0] = rng.normal(0.0, 1.0, n) * speed()[:, 0]
        off = np.zeros((n, 3))
        off[:, 1] = 1.0
    else:
        vq = rng.normal(0.0, 1.0, (n, 3)) * speed()
        off = np.cross(ve - vq, rng.normal(0.0, 1.0, (n, 3)))
        off /= np.linalg.norm(off, axis=1, keepdims=True)
    sep = d * (1.0 + rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-8, -1, n))

    def seg(p, v):
        return np.concatenate([p + v * (ts - tc)[:, None],
                               p + v * (ts + dt - tc)[:, None],
                               ts[:, None], (ts + dt)[:, None]],
                              axis=1).astype(np.float32)
    return seg(centre, ve), seg(centre + off * sep[:, None], vq), d


@pytest.mark.parametrize("kind", ["parallel", "general"])
def test_solve_scale_bounds_the_float32_error(kind):
    """Where the float32 solve (``ref.interval_math``) and the float64
    closest approach disagree about ``d``, the error in ``|Δr|² − d²``
    stays inside ``prune_limit``'s ``4e-6 · solve_scale²`` (its slack's
    premise), on 20,000 seeded near-tangent pairs per kind; at the
    coordinate scale alone it does not."""
    rng = np.random.default_rng({"parallel": 11, "general": 12}[kind])
    e, q, d = _tangent_pairs(rng, 20_000, kind)
    d32 = d.astype(np.float32)
    _, _, hit = ref.interval_math(
        tuple(torch.from_numpy(e[:, k]) for k in range(8)),
        tuple(torch.from_numpy(q[:, k]) for k in range(8)),
        torch.from_numpy(d32))
    ca = np.array([closest_approach(a, b) for a, b in zip(e, q)])
    wrong = hit.numpy() != (ca <= d32)
    assert wrong.sum() > 100                     # the family reaches the band
    err = np.abs(ca ** 2 - d32.astype(np.float64) ** 2)[wrong]
    scale = np.array([solve_scale(np.stack([a, b]))
                      for a, b in zip(e[wrong], q[wrong])])
    coords = np.maximum(np.abs(e[wrong, :6]).max(1),
                        np.abs(q[wrong, :6]).max(1))
    assert np.all(err <= 4e-6 * scale ** 2), (err / scale ** 2).max()
    assert np.any(err > 4e-6 * np.maximum(coords, 1.0) ** 2)
