"""The NumPy reference against a brute force of its own and against the
port's ``torch`` backend, and the comparison's three numbers."""
import json

import numpy as np
import pytest

from perfbench.data import trajgen
from perfbench.harness.check import answer_of, reference_answer
from perfbench.harness.spec import HERE
from perfbench.reference.compare import INF, compare
from perfbench.reference.distthresh import Reference, bf16, geometry, intervals

LIMITS = json.loads((HERE / "configs" / "galaxy-s1.json").read_text()
                    )["check_limits"]


def random_db(rng, n, *, box=30.0, span=50.0, max_len=3.0, static=0.1):
    ts = rng.uniform(0, span, n).astype(np.float32)
    te = (ts + rng.uniform(0.1, max_len, n)).astype(np.float32)
    p0 = rng.uniform(0, box, (n, 3)).astype(np.float32)
    p1 = (p0 + rng.normal(0, 2.0, (n, 3))).astype(np.float32)
    still = rng.random(n) < static           # some segments do not move
    p1[still] = p0[still]
    cols = {c: v for c, v in zip(trajgen.COLUMNS, (*p0.T, *p1.T, ts, te))}
    cols["seg_id"] = np.zeros(n, np.int32)
    cols["traj_id"] = np.arange(n, dtype=np.int32)
    return cols


def brute(db, qs, d):
    """Every pair, solved: the answer with no join at all."""
    e, q = np.meshgrid(np.arange(len(db["ts"])), np.arange(len(qs["ts"])),
                       indexing="ij")
    e, q = e.ravel(), q.ravel()
    g = geometry(db, qs, e, q, d)
    hit = g.overlap & (g.dmin2 <= d * d)
    return set(zip(e[hit].tolist(), q[hit].tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_finds_every_pair_of_the_brute_force(seed):
    rng = np.random.default_rng(seed)
    db = random_db(rng, 400)
    qs = random_db(rng, 60)
    for d in (0.5, 3.0, 12.0):
        got = Reference(db).query(qs, d)
        assert set(zip(got["e"].tolist(), got["q"].tolist())) == brute(db, qs, d)


def test_intervals_are_where_the_distance_is_d():
    rng = np.random.default_rng(3)
    db, qs = random_db(rng, 300), random_db(rng, 40)
    d = 4.0
    got = Reference(db).query(qs, d)
    g = geometry(db, qs, got["e"], got["q"], d)
    lo, hi = g.lo, g.hi
    assert ((got["t_enter"] >= lo) & (got["t_exit"] <= hi)
            & (got["t_enter"] <= got["t_exit"])).all()
    for t, at_edge in ((got["t_enter"], lo), (got["t_exit"], hi)):
        s = t - lo
        dist2 = g.A * s * s + 2 * g.B * s + (g.C + d * d)
        inner = ~np.isclose(t, at_edge, rtol=0, atol=1e-9)
        np.testing.assert_allclose(dist2[inner], d * d, rtol=1e-9, atol=1e-9)
        assert (dist2[~inner] <= d * d * (1 + 1e-9)).all()


def small_db(name, seed=0):
    from repro_torch.api import TrajectoryDB
    from repro_torch.core.segments import SegmentArray
    params, scale, d = {"galaxy": ({}, 0.02, 1.0),
                        "randwalk-exp": ({}, 0.01, 100.0)}[name]
    ds = trajgen.make(name, params, seed=seed, scale=scale)
    return ds, d, TrajectoryDB.from_segments(SegmentArray(**ds.cols),
                                             device="cpu")


@pytest.mark.parametrize("name", ["galaxy", "randwalk-exp"])
@pytest.mark.parametrize("batching", [None, "periodic"])
def test_port_torch_backend_agrees(name, batching):
    from repro_torch.core.segments import SegmentArray
    ds, d, db = small_db(name, seed=11)
    rng = np.random.default_rng(5)
    traj = rng.choice(len(ds.traj_slices), 6, replace=False)
    rows = np.concatenate([np.arange(*ds.traj_slices[t]) for t in traj])
    qs = ds.take(rows)
    res = db.query(SegmentArray(**qs), d, backend="torch", batching=batching)
    ref = Reference(ds.cols)
    got = compare(answer_of(res), ref.query(qs, d), ds.cols, qs,
                  ds.traj_slices, d)
    assert got["rows"] > 0
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got


def test_control_fails_and_reference_passes():
    ds, d, _ = small_db("galaxy", seed=12)
    rows = np.concatenate([np.arange(*ds.traj_slices[t]) for t in (1, 7, 30)])
    qs = ds.take(rows)
    ref = Reference(ds.cols)
    want = ref.query(qs, d)
    same = compare(reference_answer(ref, ds.cols, qs, d), want, ds.cols, qs,
                   ds.traj_slices, d)
    assert same["rows_differing"] == 0 and same["interval_ratio"] == 0
    ctl = compare(reference_answer(ref, ds.cols, qs, d, bf16), want, ds.cols,
                  qs, ds.traj_slices, d)
    assert ctl["flip_ratio"] > 3 * LIMITS["flip_ratio"]
    assert ctl["interval_ratio"] > 3 * LIMITS["interval_ratio"]


def test_compare_counts_row_errors_and_flags_rows_that_cannot_be():
    ds, d, _ = small_db("galaxy", seed=13)
    rows = np.concatenate([np.arange(*ds.traj_slices[t]) for t in (2, 3)])
    qs = ds.take(rows)
    ref = Reference(ds.cols)
    want = ref.query(qs, d)
    ans = reference_answer(ref, ds.cols, qs, d)
    args = (want, ds.cols, qs, ds.traj_slices, d)
    swapped = {k: v.copy() for k, v in ans.items()}
    swapped["entry_idx"][[0, 1]] = swapped["entry_idx"][[1, 0]]
    assert compare(swapped, *args)["row_errors"] >= 1
    doubled = {k: np.concatenate([v, v[:1]]) for k, v in ans.items()}
    assert compare(doubled, *args)["row_errors"] >= 1
    nowhere = {k: v.copy() for k, v in ans.items()}
    nowhere["entry_seg"][0] = 10 ** 6
    assert compare(nowhere, *args)["row_errors"] == 1
    # a row whose segments share no time at all
    far = {k: v.copy() for k, v in ans.items()}
    far["entry_seg"][-1] = (far["entry_seg"][-1] + 200) % 400
    assert compare(far, *args)["flip_ratio"] == INF
    late = {k: v.copy() for k, v in ans.items()}
    late["t_exit"][5] = late["t_exit"][5] + 0.25
    assert compare(late, *args)["interval_ratio"] > 3 * LIMITS["interval_ratio"]


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 400.7, -3.3])
    got = bf16(x)
    np.testing.assert_array_equal(got[:3], [1.0, 1.0, 1.0 + 2 ** -6])
    assert got[3] == 400.0 and abs(got[4] + 3.3) < 2 ** -6
    g = geometry({c: np.array([v], np.float32) for c, v in
                  zip(trajgen.COLUMNS, (0, 0, 0, 1, 0, 0, 0, 1))},
                 {c: np.array([v], np.float32) for c, v in
                  zip(trajgen.COLUMNS, (0, 1, 0, 1, 1, 0, 0, 1))},
                 np.array([0]), np.array([0]), 1.0)
    t_enter, t_exit = intervals(g)
    assert (t_enter[0], t_exit[0]) == (0.0, 1.0)
