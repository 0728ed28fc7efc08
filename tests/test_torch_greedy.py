"""GREEDYSETSPLIT's plans on the port against the reference's.

The port prices the greedy set-split in array calls
(``repro_torch.core.batching._FreeRuns``); the reference walks the batch
list and prices one merge at a time.  The plans must be equal, field for
field, for both variants, with and without the spatial pricing counter.

The port sizes its prune slack by ``solve_scale`` and the reference by
the coordinates (ROADMAP, deliberate differences), so their counters may
price a union differently.  The comparison with a counter therefore hands
the reference's algorithm the port's index and counter: the same inputs,
so any difference is the algorithm's.  Without a counter the reference
also runs on its own index.

The work bound: the rows the counter prices stay under ``8·n`` (the bound
``_FreeRuns`` states) on all-singleton runs and on long free runs, where
pricing every open start once per round would be quadratic.
"""
import numpy as np
import pytest

import repro.api as R
from repro.core import batching as ref_batching
from repro.core.index import TemporalBinIndex as RefIndex
from repro.core.segments import SegmentArray
from repro_torch import state
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core import batching
from repro_torch.core.index import TemporalBinIndex

FIELDS = ("q_first", "q_last", "qt0", "qt1", "cand_first", "cand_last",
          "num_ints")
VARIANTS = {"min": 8, "max": 16}
#: counter None, then (level, max_subranges).
COUNTERS = [None, ("bin", None), ("bin", 2), ("box", None), ("box", 2)]


def _fields(plan):
    return [tuple(getattr(b, f) for f in FIELDS) for b in plan.batches]


def _path(t):
    """The drifting cloud's centre at time ``t``."""
    return 5.0 + 0.4 * np.asarray(t, np.float64)[..., None] * np.ones(3)


def _segments(p0, p1, ts, te):
    order = np.argsort(ts, kind="stable")
    p0, p1 = p0[order].astype(np.float32), p1[order].astype(np.float32)
    n = len(ts)
    return SegmentArray(xs=p0[:, 0], ys=p0[:, 1], zs=p0[:, 2],
                        xe=p1[:, 0], ye=p1[:, 1], ze=p1[:, 2],
                        ts=ts[order].astype(np.float32),
                        te=te[order].astype(np.float32),
                        seg_id=np.arange(n, dtype=np.int32),
                        traj_id=np.arange(n, dtype=np.int32) % 7)


def _database(rng, n=1500):
    """Segments of a cloud drifting along a diagonal, so that a time bin's
    MBR is local and spatial pricing prunes."""
    ts = rng.uniform(0.0, 50.0, n)
    te = ts + rng.uniform(0.1, 1.5, n)
    p0 = _path(ts) + rng.normal(0, 2.0, (n, 3))
    return _segments(p0, p0 + rng.normal(0, 0.5, (n, 3)), ts, te)


def _queries(rng, trajectories, steps, dup, dt=0.6):
    """``trajectories`` polylines of ``steps`` consecutive ``dt``-long
    segments near the cloud, each segment repeated ``dup(rng)`` times
    with 1e-3 jitter: copies share their extent, so they merge for free."""
    ts, p0 = [], []
    for _ in range(trajectories):
        t = rng.uniform(0.0, 50.0 - dt * steps) + dt * np.arange(steps)
        x = _path(t) + rng.normal(0, 3.0, 3) + np.cumsum(
            rng.normal(0, 0.3, (steps, 3)), axis=0)
        k = np.array([dup(rng) for _ in range(steps)])
        ts.append(np.repeat(t, k))
        p0.append(np.repeat(x, k, axis=0))
    ts, p0 = np.concatenate(ts), np.concatenate(p0)
    p0 = p0 + rng.normal(0, 1e-3, p0.shape)
    return _segments(p0, p0 + 0.3, ts, ts + dt)


WORLDS = {
    # one query a step: the pair call settles every run.
    "singletons": lambda rng: _queries(rng, 1, 80, lambda r: 1),
    # 50 queries a step: each run settles over windows along the chain.
    "free-runs": lambda rng: _queries(rng, 1, 6, lambda r: 50),
    # runs of 1 to 60 in random order: rounds and windows both extend.
    "mixed-0": lambda rng: _queries(
        rng, 2, 60, lambda r: int(r.choice([1] * 8 + [2, 3, 9]))),
    "mixed-1": lambda rng: _queries(
        rng, 1, 40, lambda r: int(r.choice([1] * 3 + [2, 4, 30]))),
}


@pytest.fixture(scope="module")
def worlds():
    """Per world: (reference index, port index, reference queries, port
    queries), on one database of 1,500 segments."""
    segs = _database(np.random.default_rng(30))
    ref_index = RefIndex.build(segs, 100, kboxes=4)
    index = TemporalBinIndex.build(
        state.segments_from_numpy(vars(segs)), 100, kboxes=4)
    out = {}
    for k, (name, make) in enumerate(WORLDS.items()):
        q = make(np.random.default_rng([30, k]))
        out[name] = (ref_index, index, q, state.segments_from_numpy(vars(q)))
    return out


@pytest.mark.parametrize("counter", COUNTERS, ids=str)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_greedy_plan_equals_reference(worlds, world, variant, counter):
    ref_index, index, rq, q = worlds[world]
    fn = getattr(batching, f"greedysetsplit_{variant}")
    ref_fn = getattr(ref_batching, f"greedysetsplit_{variant}")
    bound = VARIANTS[variant]
    if counter is None:
        got = fn(index, q, bound)
        assert _fields(got) == _fields(ref_fn(ref_index, rq, bound))
        assert _fields(got) == _fields(ref_fn(index, q, bound))
        return
    level, cap = counter
    ctr = batching.SpatialInteractionCounter(index, q, 2.0, level=level,
                                             max_subranges=cap)
    got = fn(index, q, bound, counter=ctr)
    assert _fields(got) == _fields(ref_fn(index, q, bound, counter=ctr))
    assert got.algorithm == f"greedysetsplit-{variant}"
    assert got.params == {"bound": bound}


class _Pricing:
    """A pricing counter for the test of any pricing: ``zones`` prices 7
    where the union is 1 to 2 wide along x or its extent 1 to 2 long
    (modulo 10), and 1 elsewhere, so it is not monotone in the union;
    ``sums`` prices the
    sum of the union's ends along x, so a free run's price changes as it
    grows.  Runs then settle as the reference settles them only if each
    run's union and price are carried whole from one call to the next."""

    def __init__(self, q, kind):
        self.qlo, self.qhi = q.mbrs()
        self.kind = kind

    def counts(self, qt0, qt1, lo, hi):
        if self.kind == "sums":
            return np.rint(lo[:, 0] + hi[:, 0]).astype(np.int64)
        w, t = hi[:, 0] - lo[:, 0], qt1 - qt0
        return 1 + 6 * (((w >= 1) & (w < 2)) | ((t % 10 >= 1) & (t % 10 < 2)))


def _priced_world(rng, kind, n=300):
    """``zones``: x uniform in [0, 3], a third of the extents 4 long;
    ``sums``: x mostly 2, else 1 or 3."""
    ts = np.sort(rng.uniform(0.0, 50.0, n))
    p0 = np.zeros((n, 3))
    if kind == "sums":
        p0[:, 0] = rng.choice([1.0, 2.0, 3.0], n, p=[0.1, 0.8, 0.1])
        te = ts + 0.1
    else:
        p0[:, 0] = rng.uniform(0.0, 3.0, n)
        te = ts + rng.choice([0.1, 4.0], n, p=[0.7, 0.3])
    return _segments(p0, p0, ts, te)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", ["sums", "zones"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_equals_reference_on_any_pricing(worlds, variant, kind, seed):
    """Seeded worlds whose price is a function of the whole union: the
    plan is still the reference's."""
    q = state.segments_from_numpy(vars(
        _priced_world(np.random.default_rng([31, seed]), kind)))
    index = worlds["singletons"][1]
    fn = getattr(batching, f"greedysetsplit_{variant}")
    ref_fn = getattr(ref_batching, f"greedysetsplit_{variant}")
    ctr = _Pricing(q, kind)
    got = fn(index, q, VARIANTS[variant], counter=ctr)
    assert _fields(got) == _fields(ref_fn(index, q, VARIANTS[variant],
                                          counter=ctr))


#: (scenario, scale, policy fields): S1 with the port's default policy,
#: C3 with the README's hierarchical configuration.
SCENARIOS = {
    "S1": (0.01, {}),
    "C3": (0.02, dict(num_bins=8, index_kboxes=4, max_subranges=16,
                      pruning="hierarchical")),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_planner_equals_reference(name):
    """``QueryPlanner.plan`` with spatial pricing gives the reference
    planner's batches, capacities, groups, runs and pruned work."""
    scale, fields = SCENARIOS[name]
    rdb = R.TrajectoryDB.from_scenario(name, scale=scale,
                                       policy=R.ExecutionPolicy(**fields))
    tdb = TrajectoryDB.from_scenario(name, scale=scale,
                                     policy=ExecutionPolicy(**fields),
                                     device="cpu")
    got = tdb.plan(tdb.scenario_queries, d=tdb.scenario_d)
    want = rdb.plan(rdb.scenario_queries, d=rdb.scenario_d)
    assert got.batch_plan.algorithm.startswith("greedysetsplit")
    assert _fields(got) == _fields(want)
    assert got.capacities == want.capacities
    assert got.groups == want.groups
    assert got.runs == want.runs
    assert got.pruned_interactions == want.pruned_interactions


def _counted(index, q, d=2.0):
    ctr = batching.SpatialInteractionCounter(index, q, d)
    rows = []
    counts = ctr.counts

    def counting(qt0, qt1, lo, hi):
        rows.append(len(qt0))
        return counts(qt0, qt1, lo, hi)

    ctr.counts = counting
    return ctr, rows


def _zigzag(rng, steps, dup):
    """``steps`` time steps of ``dup`` jittered copies each, on alternate
    sides of the cloud and far from it: one copy prices no candidate, a
    union that straddles the cloud does.  So the free runs are exactly
    the steps."""
    ts = np.repeat(np.linspace(0.0, 49.0, steps), dup)
    side = np.repeat(np.where(np.arange(steps) % 2, 12.0, -12.0), dup)
    p0 = _path(ts) + side[:, None] + rng.normal(0, 1e-3, (ts.size, 3))
    return _segments(p0, p0 + 0.01, ts, ts + 0.1)


#: 40,000 queries in 400 free runs of 100, and 4,000 singleton runs.
SHAPES = {"free-runs": (400, 100), "singletons": (4000, 1)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_greedy_rows_priced_linear(shape):
    """Rows priced stay under 8·n on both shapes."""
    steps, dup = SHAPES[shape]
    rng = np.random.default_rng(7)
    index = TemporalBinIndex.build(
        state.segments_from_numpy(vars(_database(rng, 2000))), 32)
    q = state.segments_from_numpy(vars(_zigzag(rng, steps, dup)))
    n = len(q)
    ctr, rows = _counted(index, q)
    plan = batching.greedysetsplit_min(index, q, 1, counter=ctr)
    assert sum(rows) <= 8 * n, (sum(rows), n)
    assert plan.num_batches == steps and set(plan.sizes().tolist()) == {dup}
