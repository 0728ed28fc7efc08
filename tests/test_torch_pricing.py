"""The planner's pruned-count estimate, priced over each row's window of
coarse cells, against the dense body that evaluates every row over the
whole grid.

``TemporalBinIndex.estimate_pruned_candidates_batch`` evaluates a row only
over the coarse cells its temporal range can overlap.  :func:`dense` below
is the body that evaluated every row over all of them; the estimate must
equal it element for element, dtype included, and the plans built on it
must equal the plans built on the dense body.
"""
import numpy as np
import pytest

from conftest import random_segments
from repro.data import trajgen as ref_trajgen
from repro_torch import state
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core import batching
from repro_torch.core.index import (COARSE_GRID_BINS, PodPartitionedIndex,
                                    TemporalBinIndex, mbr_gap2)
from repro_torch.core.planner import QueryPlanner


def dense(index, qt0, qt1, qlo, qhi, *, limit, level="bin",
          max_subranges=None):
    """The estimate with every row over every coarse cell."""
    qt0 = np.asarray(qt0, np.float64)
    qt1 = np.asarray(qt1, np.float64)
    qlo = np.asarray(qlo, np.float64).reshape(-1, 3)
    qhi = np.asarray(qhi, np.float64).reshape(-1, 3)
    first, last = index.candidate_range_batch(qt0, qt1)
    cf, cl = index._coarse_first, index._coarse_last
    ov = (np.minimum(last[:, None], cl[None, :])
          - np.maximum(first[:, None], cf[None, :]) + 1)
    ov = np.maximum(ov, 0)
    lim2 = limit * limit
    if level == "box":
        gap2 = mbr_gap2(index._coarse_klo[None], index._coarse_khi[None],
                        qlo[:, None, None], qhi[:, None, None])
        keep = (gap2 <= lim2).any(axis=2)
    else:
        gap2 = mbr_gap2(index._coarse_lo[None], index._coarse_hi[None],
                        qlo[:, None], qhi[:, None])
        keep = gap2 <= lim2
    est = (ov * keep).sum(axis=1).astype(np.int64)
    if max_subranges is not None:
        kk = keep & (ov > 0)
        ncell = kk.shape[1]
        frag = kk[:, 0].astype(np.int64) + (kk[:, 1:] & ~kk[:, :-1]).sum(axis=1)
        any_k = kk.any(axis=1)
        idx = np.arange(ncell)
        first_k = np.where(any_k, kk.argmax(axis=1), ncell)
        last_k = np.where(any_k, ncell - 1 - kk[:, ::-1].argmax(axis=1), -1)
        internal = (~kk) & (idx[None, :] > first_k[:, None]) \
            & (idx[None, :] < last_k[:, None])
        dropped = (ov * internal).sum(axis=1).astype(np.int64)
        excess = np.maximum(frag - int(max_subranges), 0)
        denom = np.maximum(frag - 1, 1)
        est = est + (dropped * excess + denom - 1) // denom
    return est


def window_widths(index, qt0, qt1):
    """Per row, the coarse cells whose segment range meets the row's."""
    first, last = index.candidate_range_batch(qt0, qt1)
    return ((index._coarse_first[None] <= last[:, None])
            & (index._coarse_last[None] >= first[:, None])).sum(axis=1)


def _port(segs):
    return state.segments_from_numpy(vars(segs))


def _gapped(rng, n=1200):
    """Segments in two bursts, [0, 20] and [60, 80], with nothing between:
    the coarse cells over the gap are empty, inside the windows of rows
    that span it."""
    ts = np.concatenate([rng.uniform(0.0, 20.0, n // 2),
                         rng.uniform(60.0, 80.0, n - n // 2)])
    te = ts + rng.uniform(0.1, 1.0, n)
    p0 = rng.uniform(0.0, 40.0, (n, 3)) + 0.3 * ts[:, None]
    p1 = p0 + rng.normal(0.0, 0.5, (n, 3))
    order = np.argsort(ts, kind="stable")
    return state.segments_from_numpy(dict(
        xs=p0[order, 0].astype(np.float32), ys=p0[order, 1].astype(np.float32),
        zs=p0[order, 2].astype(np.float32), xe=p1[order, 0].astype(np.float32),
        ye=p1[order, 1].astype(np.float32), ze=p1[order, 2].astype(np.float32),
        ts=ts[order].astype(np.float32), te=te[order].astype(np.float32),
        seg_id=np.arange(n, dtype=np.int32),
        traj_id=np.arange(n, dtype=np.int32) % 11))


def _gapped_queries(rng):
    return random_segments(rng, 200, t_span=(0.0, 80.0), box=50.0,
                           max_len=60.0)


def _scenario(name, scale):
    """(database, queries, d) of a world, as the port's arrays."""
    segs, queries, d = ref_trajgen.make_scenario(name, scale=scale)
    return _port(segs), _port(queries), d


def _seeded_rows(rng, index, n):
    """``n`` extents and boxes over the database's time and space: rows
    with empty ranges (before, after and inverted), single-cell rows, rows
    spanning the whole grid, and the rest random."""
    t_lo, t_hi = index.t0, index.t0 + index.bin_width * index.num_bins
    span = t_hi - t_lo
    qt0 = rng.uniform(t_lo, t_hi, n)
    qt1 = qt0 + rng.exponential(0.05 * span, n)
    kind = rng.integers(0, 6, n)
    qt0 = np.where(kind == 0, t_lo - 2.0 * span, qt0)        # before the db
    qt1 = np.where(kind == 0, t_lo - span, qt1)
    qt0 = np.where(kind == 1, t_hi + span, qt0)              # after it
    qt1 = np.where(kind == 1, t_hi + 2.0 * span, qt1)
    qt1 = np.where(kind == 2, qt0 - 1.0, qt1)                # inverted
    qt1 = np.where(kind == 3, qt0, qt1)                      # an instant
    qt0 = np.where(kind == 4, t_lo - 1.0, qt0)               # the whole grid
    qt1 = np.where(kind == 4, t_hi + 1.0, qt1)
    lo = np.asarray(index.prefix_lo[-1], np.float64)
    hi = np.asarray(index.prefix_hi[-1], np.float64)
    centre = rng.uniform(lo, hi, (n, 3))
    half = rng.exponential(0.1 * float(np.max(hi - lo)), (n, 3))
    return qt0, qt1, centre - half, centre + half


def _pod_index(db, index):
    n = len(db)
    cuts = np.linspace(0, n, 5).astype(np.int64)
    return PodPartitionedIndex.build_partitioned(
        index, db, [(int(a), int(b) - 1) for a, b in zip(cuts[:-1], cuts[1:])])


#: (world, scale): the four worlds of the port's scenarios, and a
#: database with a time gap.
WORLDS = [("S1", 0.01), ("S10", 0.02), ("C1", 0.01), ("C3", 0.02),
          ("gap", None)]


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, scale in WORLDS:
        if scale is None:
            rng = np.random.default_rng(33)
            db = _gapped(rng)
            queries = _port(_gapped_queries(rng))
            d = 2.0
        else:
            db, queries, d = _scenario(name, scale)
        index = TemporalBinIndex.build(db, 1000, kboxes=4)
        out[name] = (db, queries, d, index, _pod_index(db, index))
    return out


@pytest.mark.parametrize("pod", [False, True], ids=["index", "pods"])
@pytest.mark.parametrize("cap", [None, 4, 8])
@pytest.mark.parametrize("level", ["bin", "box"])
@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_estimate_equals_dense_on_seeded_rows(worlds, world, level, cap, pod):
    """Seeded extents of every kind, over each world's index and its pod
    partition: equal to the dense body element for element, dtype too."""
    db, queries, d, index, pods = worlds[world]
    index = pods if pod else index
    rng = np.random.default_rng([33, len(world), cap or 0, pod])
    limit = index.prune_threshold(d, queries.packed())
    for n in (1, 2, 7, 300):
        qt0, qt1, qlo, qhi = _seeded_rows(rng, index, n)
        got = index.estimate_pruned_candidates_batch(
            qt0, qt1, qlo, qhi, limit=limit, level=level, max_subranges=cap)
        want = dense(index, qt0, qt1, qlo, qhi, limit=limit, level=level,
                     max_subranges=cap)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [None, 4, 8])
@pytest.mark.parametrize("level", ["bin", "box"])
@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_estimate_equals_dense_on_the_queries(worlds, world, level, cap):
    """The rows a planner prices first — each query alone, then every
    adjacent pair's union — and one row spanning the whole query set."""
    db, queries, d, index, _ = worlds[world]
    limit = index.prune_threshold(d, queries.packed())
    qlo, qhi = queries.mbrs()
    qt0 = queries.ts.astype(np.float64)
    qt1 = queries.te.astype(np.float64)
    rows = [(qt0, qt1, qlo, qhi),
            (qt0[:-1], np.maximum(qt1[:-1], qt1[1:]),
             np.minimum(qlo[:-1], qlo[1:]), np.maximum(qhi[:-1], qhi[1:])),
            (qt0[:1], qt1.max(keepdims=True), qlo.min(axis=0, keepdims=True),
             qhi.max(axis=0, keepdims=True))]
    for a, b, lo, hi in rows:
        got = index.estimate_pruned_candidates_batch(
            a, b, lo, hi, limit=limit, level=level, max_subranges=cap)
        want = dense(index, a, b, lo, hi, limit=limit, level=level,
                     max_subranges=cap)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", ["all-span", "one-window", "no-rows",
                                   "all-empty"])
def test_estimate_equals_dense_on_shared_windows(worlds, shape):
    """Calls whose rows share one window take the cells by slice: every
    row over the whole grid, every row inside one window, no row at all,
    and only empty ranges."""
    db, queries, d, index, _ = worlds["S1"]
    limit = index.prune_threshold(d, queries.packed())
    rng = np.random.default_rng(34)
    n = {"no-rows": 0}.get(shape, 50)
    t_lo, t_hi = index.t0, index.t0 + index.bin_width * index.num_bins
    if shape == "all-span":
        qt0, qt1 = np.full(n, t_lo - 1.0), np.full(n, t_hi + 1.0)
    elif shape == "one-window":
        mid = 0.5 * (t_lo + t_hi)
        qt0, qt1 = np.full(n, mid), np.full(n, mid + 0.01 * (t_hi - t_lo))
    else:
        qt0, qt1 = np.full(n, t_hi + 5.0), np.full(n, t_hi + 6.0)
    _, _, qlo, qhi = _seeded_rows(rng, index, n)
    for level in ("bin", "box"):
        for cap in (None, 4):
            got = index.estimate_pruned_candidates_batch(
                qt0, qt1, qlo, qhi, limit=limit, level=level,
                max_subranges=cap)
            want = dense(index, qt0, qt1, qlo, qhi, limit=limit, level=level,
                         max_subranges=cap)
            assert got.dtype == want.dtype and got.shape == (n,)
            np.testing.assert_array_equal(got, want)
    widths = window_widths(index, qt0, qt1)
    assert index.price_rows(qt0, qt1, qlo, qhi, limit=limit)[1] \
        == int(widths.sum())
    if shape == "all-span":
        assert (widths == len(index._coarse_first)).all()


@pytest.mark.parametrize("world", ["S1", "C3", "gap"])
def test_windows_are_the_cells_each_row_overlaps(worlds, world):
    """``price_rows`` counts, per call, the cells whose segment range meets
    each row's: no more than the grid, one for a row inside one cell, none
    for an empty range."""
    db, queries, d, index, _ = worlds[world]
    rng = np.random.default_rng(35)
    qt0, qt1, qlo, qhi = _seeded_rows(rng, index, 400)
    limit = index.prune_threshold(d, queries.packed())
    _, cells = index.price_rows(qt0, qt1, qlo, qhi, limit=limit)
    widths = window_widths(index, qt0, qt1)
    assert cells == int(widths.sum())
    assert (widths <= len(index._coarse_first)).all()
    assert (widths == 1).any() and (widths == 0).any()
    if world == "gap":
        # Empty cells lie inside the windows of the rows spanning the gap.
        first, last = index.candidate_range_batch(qt0, qt1)
        inside = ((index._coarse_first[None] <= last[:, None])
                  & (index._coarse_last[None] >= first[:, None]))
        assert (inside & (index._coarse_last < index._coarse_first)).any()


#: (scenario, scale, policy fields) of the plan identity test.
PLANS = {
    "S1": (0.01, {}),
    "S10": (0.05, {}),
    "S1-hierarchical": (0.01, dict(index_kboxes=4, pruning="hierarchical",
                                   max_subranges=4)),
}


def _plan_digest(plan):
    return ([(b.q_first, b.q_last, b.qt0, b.qt1, b.cand_first, b.cand_last,
              b.num_ints) for b in plan.batches],
            plan.capacities, plan.groups, plan.runs, plan.pruned_interactions)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_equals_plan_on_dense_estimate(monkeypatch, name):
    """``QueryPlanner.plan`` gives the same batches, capacities, groups and
    runs as with the dense body patched in, and reads the cells it priced
    per row: at most the grid, here below it."""
    scale, fields = PLANS[name]
    world = name.split("-")[0]
    db = TrajectoryDB.from_scenario(world, scale=scale,
                                    policy=ExecutionPolicy(**fields),
                                    device="cpu")
    got = db.plan(db.scenario_queries, d=db.scenario_d)
    with monkeypatch.context() as m:
        m.setattr(TemporalBinIndex, "estimate_pruned_candidates_batch", dense)
        m.setattr(TemporalBinIndex, "price_rows",
                  lambda self, *a, **kw: (dense(self, *a, **kw), 0))
        want = db.plan(db.scenario_queries, d=db.scenario_d)
    assert _plan_digest(got) == _plan_digest(want)
    assert 0.0 < got.priced_cells_per_row < COARSE_GRID_BINS


def test_priced_cells_per_row_is_the_summed_widths_over_rows(worlds):
    """The counter totals the rows and the summed window widths of every
    ``counts`` call; the plan reads their ratio, 0.0 for a periodic plan,
    which prices nothing, and ``ExecStats`` carries it."""
    db, queries, d, index, _ = worlds["S1"]
    ctr = batching.SpatialInteractionCounter(index, queries, d)
    calls = []
    counts = ctr.counts

    def recording(qt0, qt1, lo, hi):
        calls.append(int(window_widths(index, qt0, qt1).sum()))
        return counts(qt0, qt1, lo, hi)

    ctr.counts = recording
    batching.greedysetsplit_min(index, queries, 64, counter=ctr)
    assert ctr.rows_priced > 0
    assert ctr.cells_priced == sum(calls)
    assert ctr.cells_per_row == ctr.cells_priced / ctr.rows_priced
    assert ctr.cells_per_row <= COARSE_GRID_BINS

    greedy = QueryPlanner(index, algorithm="greedysetsplit-min",
                          params={"bound": 64})
    plan = greedy.plan(queries, d)
    assert 0.0 < plan.priced_cells_per_row <= COARSE_GRID_BINS
    periodic = QueryPlanner(index, algorithm="periodic", params={"s": 64})
    assert periodic.plan(queries, d).priced_cells_per_row == 0.0
    assert greedy.plan(queries).priced_cells_per_row == 0.0   # no d

    tdb = TrajectoryDB.from_segments(db, device="cpu")
    res = tdb.query(queries, d, backend="kernel")
    assert res.stats.priced_cells_per_row == res.plan.priced_cells_per_row
    assert 0.0 < res.stats.priced_cells_per_row <= COARSE_GRID_BINS
    res = tdb.query(queries, d, backend="kernel", batching="periodic", s=64)
    assert res.stats.priced_cells_per_row == 0.0
