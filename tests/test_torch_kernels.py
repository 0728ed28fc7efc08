"""The port's torch oracle and the plain versions of its kernels, against
the reference on the same inputs (made from a numpy seed).

* ``repro_torch.kernels.ref`` vs ``repro.kernels.ref``: both evaluate one
  IEEE float32 operation at a time in the same order, so the outputs are
  required to be **equal**, bit for bit.
* Each ``*_plain`` vs its Pallas kernel run in interpret mode at
  ``cand_blk = qry_blk ∈ {8, 16}``, as ``tests/test_kernels.py`` runs them;
  the row-loop twins against ``append="rowloop"``.
  Hit sets, counts, ``pruned`` and the row order (the plain versions emit
  the TPU kernels' grid order) are exact.  Intervals are compared with
  ``rtol=1e-5, atol=1e-4``: XLA fuses the interpret-mode solve and may
  contract products into FMAs, which moves endpoints by a few ulp (about
  7e-6 relative on these inputs).
"""
import numpy as np
import pytest
import torch

from conftest import random_segments
from repro.kernels import distthresh as jdt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import distthresh as dt
from repro_torch.kernels import ops
from repro_torch.kernels import ref

RTOL, ATOL = 1e-5, 1e-4
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _degenerate() -> tuple[np.ndarray, np.ndarray]:
    """The degenerate cases of the reference oracle's docstring, as rows
    (x0, y0, z0, x1, y1, z1, ts, te); with d = 2 each entry i meets the
    query of the same index in the stated way."""
    entries = np.array([
        [0, 0, 0, 10, 0, 0, 0, 10],     # head-on, hits on [4, 6]
        [0, 0, 0, 10, 0, 0, 0, 10],     # parallel, always within (constant)
        [0, 0, 0, 10, 0, 0, 0, 10],     # parallel, never within (constant)
        [5, 0, 0, 5, 0, 0, 3, 3],       # zero-length extent (static point)
        [0, 0, 0, 10, 0, 0, 0, 10],     # tangent: closest approach == d
        [0, 0, 0, 1, 0, 0, 0, 1],       # disjoint temporal extents
        [0, 0, 0, 10, 0, 0, 0, 10],     # linear: only the queries moves
        [3, 1, 0, 3, 1, 0, 0, 10],      # zero relative velocity, static
    ], np.float32)
    queries = np.array([
        [10, 0, 0, 0, 0, 0, 0, 10],
        [0, 1, 0, 10, 1, 0, 0, 10],
        [0, 5, 0, 10, 5, 0, 0, 10],
        [0, 0, 0, 10, 0, 0, 0, 10],
        [10, 2, 0, 0, 2, 0, 0, 10],
        [0, 0, 0, 1, 0, 0, 5, 6],
        [0, 0, 0, 10, 3, 0, 0, 10],
        [3, 1, 1, 3, 1, 1, 0, 10],
    ], np.float32)
    return entries, queries


def _random(seed: int, c: int, q: int):
    rng = np.random.default_rng(seed)
    return (random_segments(rng, c).packed(), random_segments(rng, q).packed(),
            np.float32(rng.uniform(0.5, 10.0)))


# ----------------------------------------------------------------------
# The torch oracle against the reference oracle: bit-equal.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_ref_equals_reference_oracle(seed):
    e, q, d = _random(seed, 40 + seed, 24)
    got = ref.interaction_tile(_t(e), _t(q), d)
    want = jref.interaction_tile(e, q, d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_ref_degenerate_cases():
    e, q = _degenerate()
    d = np.float32(2.0)
    t_enter, t_exit, hit = (_np(x) for x in ref.interaction_tile(_t(e),
                                                                  _t(q), d))
    for g, w in zip((t_enter, t_exit, hit), jref.interaction_tile(e, q, d)):
        np.testing.assert_array_equal(g, np.asarray(w))
    diag = np.arange(len(e))
    np.testing.assert_array_equal(
        hit[diag, diag], [True, True, False, True, True, False, True, True])
    np.testing.assert_allclose(t_enter[0, 0], 4.0, atol=1e-5)
    np.testing.assert_allclose(t_exit[0, 0], 6.0, atol=1e-5)
    assert t_enter[4, 4] == t_exit[4, 4]          # tangent: one instant
    assert (t_enter[1, 1], t_exit[1, 1]) == (0.0, 10.0)
    assert t_enter[3, 3] == t_exit[3, 3] == 3.0   # static point at t = 3


@pytest.mark.parametrize("seed", range(2))
def test_interaction_classes_and_count_hits(seed):
    e, q, d = _random(100 + seed, 32, 20)
    for g, w in zip(ref.interaction_classes(_t(e), _t(q), d),
                    jref.interaction_classes(e, q, d)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert int(ref.count_hits(_t(e), _t(q), d)) == int(
        jref.count_hits(e, q, d))
    assert int(ops.count_hits(e, q, d, device=CPU)) == int(
        jops.count_hits(e, q, d, use_pallas=False))


# ----------------------------------------------------------------------
# Plain versions against the Pallas kernels in interpret mode.
# ----------------------------------------------------------------------
def _padded(blk: int, seed: int, c: int, q: int):
    """Random entries/queries padded the reference's way (zero rows at a
    time past the data) to a multiple of ``blk``; d = 8 so there are
    about ten hits."""
    e, qq, _ = _random(seed, c, q)
    d = np.float32(8.0)
    pad_t = max(e[:, 7].max(), qq[:, 7].max()) + 1.0
    return (np.asarray(jops._pad_rows(e, blk, pad_t)),
            np.asarray(jops._pad_rows(qq, blk, pad_t)), d, c, q)


@pytest.mark.parametrize("blk", [8, 16])
def test_dense_plain_equals_pallas(blk):
    e, q, d, _, _ = _padded(blk, blk, 40, 24)
    got = dt.distthresh_dense(_t(e), _t(q.T), d, cand_blk=blk, qry_blk=blk,
                              device=CPU)
    want = jdt.distthresh_pallas(e, q.T, d, cand_blk=blk, qry_blk=blk)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c, q, offset", [(20, 300, None), (20, 300, 29),
                                           (9, 600, 5)])
def test_dense_plain_wide_and_sliced_equals_pallas(c, q, offset):
    """More than 256 query columns (several of the dense kernel's column
    blocks) and ``queries_t`` as a column slice of a wider (8, N) array,
    read through its row stride.  Hit masks equal the reference's padded
    Pallas launch; intervals equal the reference oracle bit for bit (at
    6,000 pairs a near-tangent pair's endpoint moves past ``RTOL`` under
    the interpret mode's FMA contraction, see the module docstring)."""
    rng = np.random.default_rng(c + q + (offset or 0))
    e = random_segments(rng, c, box=10.0).packed()
    wide = random_segments(rng, q + 2 * (offset or 0), box=10.0).packed()
    d = np.float32(3.0)
    qt = torch.from_numpy(np.ascontiguousarray(wide.T))
    if offset is not None:
        qt = qt[:, offset:offset + q]
        assert qt.stride(0) == wide.shape[0] and not qt.is_contiguous()
    got = dt.distthresh_dense(_t(e), qt, d, device=CPU)
    q_np = wide[(offset or 0):(offset or 0) + q]
    pad_t = max(e[:, 7].max(), q_np[:, 7].max()) + 1.0
    want = jdt.distthresh_pallas(np.asarray(jops._pad_rows(e, 8, pad_t)),
                                 np.asarray(jops._pad_rows(q_np, 128,
                                                           pad_t)).T,
                                 d, cand_blk=8, qry_blk=128)
    hit = np.asarray(want[2])[:c, :q]
    assert hit.sum() > 0
    np.testing.assert_array_equal(_np(got[2]), hit)
    oracle = jref.interaction_tile(e, q_np, d)
    np.testing.assert_array_equal(np.asarray(oracle[2]), hit.astype(bool))
    for g, w in zip(got[:2], oracle[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _assert_rows_equal(got, want, n):
    """Exact indices in the same order, intervals within tolerance."""
    for k in (0, 1):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    for k in (2, 3):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
    assert int(got[4]) == int(want[4]) == n


APPENDS = ["chunk", "rowloop"]


@pytest.mark.parametrize("append", APPENDS)
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("capacity", [4096, 5], ids=["ample", "overflow"])
def test_compact_plain_equals_pallas(blk, capacity, append):
    e, q, d, c, nq = _padded(blk, 7 * blk, 64, 48)
    kw = dict(capacity=capacity, cand_blk=blk, qry_blk=blk, valid_c=c,
              valid_q=nq, append=append)
    got = dt.distthresh_compact(_t(e), _t(q.T), d, device=CPU, **kw)
    want = jdt.distthresh_compact_pallas(e, q.T, d, **kw)
    n = int(want[4])
    assert n > capacity if capacity == 5 else 0 < n <= capacity
    if n > capacity:       # overflow: the first `capacity` rows, exact count
        got = tuple(x[:capacity] for x in got[:4]) + got[4:]
    _assert_rows_equal(got, want, n)
    assert int(got[5]) == int(want[5]) == 0


def _clustered(blk: int):
    """Entries ordered along x in tight clusters and queries at two spots,
    so most (entry tile, query tile) boxes are far apart."""
    rng = np.random.default_rng(blk)
    c, q = 6 * blk, 3 * blk
    e = np.zeros((c, 8), np.float32)
    e[:, 0] = np.repeat(np.arange(6) * 100.0, blk) + rng.uniform(0, 3, c)
    e[:, 1:3] = rng.uniform(0, 3, (c, 2))
    e[:, 3:6] = e[:, 0:3] + rng.normal(0, 1, (c, 3))
    e[:, 6] = rng.uniform(0, 10, c)
    e[:, 7] = e[:, 6] + rng.uniform(0.5, 5, c)
    qq = np.zeros((q, 8), np.float32)
    qq[:, 0] = np.repeat([100.0, 300.0, 900.0], blk) + rng.uniform(0, 3, q)
    qq[:, 1:3] = rng.uniform(0, 3, (q, 2))
    qq[:, 3:6] = qq[:, 0:3] + rng.normal(0, 1, (q, 3))
    qq[:, 6] = rng.uniform(0, 10, q)
    qq[:, 7] = qq[:, 6] + rng.uniform(0.5, 5, q)
    return e, qq, np.float32(4.0)


@pytest.mark.parametrize("append", APPENDS)
@pytest.mark.parametrize("blk", [8, 16])
def test_compact_plain_armed_equals_pallas(blk, append):
    e, q, d = _clustered(blk)
    e_mbr, q_mbr, d_prune = ops._host_tile_prune(e, q, d, blk, blk)
    kw = dict(capacity=4096, cand_blk=blk, qry_blk=blk, append=append)
    got = dt.distthresh_compact(_t(e), _t(q.T), d, e_mbr=_t(e_mbr),
                                q_mbr=_t(q_mbr), d_prune=d_prune, device=CPU,
                                **kw)
    want = jdt.distthresh_compact_pallas(e, q.T, d, e_mbr=e_mbr,
                                         q_mbr=q_mbr, d_prune=d_prune, **kw)
    _assert_rows_equal(got, want, int(want[4]))
    assert int(want[4]) > 0
    assert int(got[5]) == int(want[5]) > 0        # tiles were pruned


@pytest.mark.parametrize("armed", [False, True], ids=["unarmed", "armed"])
@pytest.mark.parametrize("capacity", [8192, 301], ids=["ample", "cut"])
def test_rowloop_plain_multiblock_equals_pallas(armed, capacity):
    """The row loop at ``cand_blk`` 64 × ``qry_blk`` 128 with 192 query
    columns: the CUDA kernel runs each 64-row tile as 8 row blocks of 8
    rows (1,024 pairs / 8 warps / 128 columns = 1 row per warp), two query
    tiles, the second ragged.  The plain twin against the reference's
    ``append="rowloop"``, with capacity ample or cut, armed with dead
    tiles or not."""
    e, q, d = _clustered(64)
    cb, qb = 64, 128
    pad_t = max(e[:, 7].max(), q[:, 7].max()) + 1.0
    q_pad = np.asarray(jops._pad_rows(q, qb, pad_t))
    kw = dict(capacity=capacity, cand_blk=cb, qry_blk=qb, valid_c=len(e),
              valid_q=len(q), append="rowloop")
    arm, jarm = {}, {}
    if armed:
        e_mbr, q_mbr, d_prune = ops._host_tile_prune(e, q, d, cb, qb)
        arm = dict(e_mbr=_t(e_mbr), q_mbr=_t(q_mbr), d_prune=d_prune)
        jarm = dict(e_mbr=e_mbr, q_mbr=q_mbr, d_prune=d_prune)
    got = dt.distthresh_compact(_t(e), _t(q_pad.T), d, device=CPU, **kw,
                                **arm)
    want = jdt.distthresh_compact_pallas(e, q_pad.T, d, **kw, **jarm)
    n = int(want[4])
    assert n > capacity if capacity == 301 else 0 < n <= capacity
    if n > capacity:
        got = tuple(x[:capacity] for x in got[:4]) + got[4:]
    _assert_rows_equal(got, want, n)
    assert int(got[5]) == int(want[5])
    assert (int(want[5]) > 0) == armed


@pytest.mark.parametrize("append", APPENDS)
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("capacity", [4096, 9], ids=["ample", "overflow"])
def test_compact_live_plain_equals_pallas(blk, capacity, append):
    e, q, d = _clustered(blk)
    tile_i, tile_j, n_live, num_tiles = ops._host_live_tiles(e, q, d, blk,
                                                             blk)
    assert 0 < int(n_live[0]) < num_tiles
    kw = dict(capacity=capacity, cand_blk=blk, qry_blk=blk, append=append)
    got = dt.distthresh_compact_live(_t(e), _t(q.T), d, _t(tile_i),
                                     _t(tile_j), _t(n_live), device=CPU, **kw)
    want = jdt.distthresh_compact_live_pallas(e, q.T, d, tile_i, tile_j,
                                              n_live, **kw)
    n = int(want[4])
    assert n > 0
    _assert_rows_equal(got, want, n)


@pytest.mark.parametrize("append", APPENDS)
def test_degenerate_cases_through_compact(append):
    e, q = _degenerate()
    d = np.float32(2.0)
    kw = dict(capacity=64, cand_blk=8, qry_blk=8, append=append)
    got = dt.distthresh_compact(_t(e), _t(q.T), d, device=CPU, **kw)
    want = jdt.distthresh_compact_pallas(e, q.T, d, **kw)
    _assert_rows_equal(got, want, int(want[4]))


def test_unpadded_equals_padded():
    """The port needs no pad rows: the unpadded batch with ragged tiles
    gives the rows of the reference's padded, masked launch."""
    blk = 16
    e, q, d, c, nq = _padded(blk, 5, 40, 24)
    got = dt.distthresh_compact(_t(e[:c]), _t(q[:nq].T), d, capacity=512,
                                cand_blk=blk, qry_blk=blk, device=CPU)
    want = jdt.distthresh_compact_pallas(e, q.T, d, capacity=512,
                                         cand_blk=blk, qry_blk=blk,
                                         valid_c=c, valid_q=nq)
    _assert_rows_equal(got[:5], want[:5], int(want[4]))


# ----------------------------------------------------------------------
# ops.query_block against the reference's, every mode.
# ----------------------------------------------------------------------
def _canon(out):
    e, q = _np(out["entry_idx"]), _np(out["query_idx"])
    keep = e >= 0
    order = np.lexsort((q[keep], e[keep]))
    return (e[keep][order], q[keep][order],
            _np(out["t_enter"])[keep][order], _np(out["t_exit"])[keep][order])


@pytest.mark.parametrize("compaction", ["fused", "fused_rowloop", "dense"])
@pytest.mark.parametrize("pruning", ["none", "spatial", "hierarchical"])
def test_query_block_equals_reference(compaction, pruning):
    e, q, d = _clustered(16)
    kw = dict(capacity=1024, cand_blk=16, qry_blk=16, compaction=compaction,
              pruning=pruning)
    got = ops.query_block(e, q, d, device=CPU, **kw)
    want = jops.query_block(e, q, d, use_pallas=True, **kw)
    for key in ("count", "pruned_tiles", "num_tiles"):
        assert int(got[key]) == int(want[key]), key
    g, w = _canon(got), _canon(want)
    assert len(g[0]) == int(want["count"]) > 0
    for k in (0, 1):
        np.testing.assert_array_equal(g[k], w[k])
    for k in (2, 3):
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


def test_query_block_torch_oracle_equals_jnp():
    """``use_kernel=False`` (the torch backend's path) against the
    reference's jnp path; both are the dense two-phase compaction."""
    e, q, d = _random(3, 50, 30)
    got = ops.query_block(e, q, d, capacity=256, device=CPU, use_kernel=False)
    want = jops.query_block(e, q, d, capacity=256, use_pallas=False)
    assert int(got["count"]) == int(want["count"]) > 0
    for k, (g, w) in enumerate(zip(_canon(got), _canon(want))):
        if k < 2:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_rowloop_twins_are_their_own_functions(monkeypatch):
    """On the CPU ``append="rowloop"`` runs the row-loop twins (so the card
    can hold each row-loop kernel against its own plain version), and
    ``compaction="fused_rowloop"`` reaches them through ``query_block``."""
    calls = []
    for name in ("distthresh_compact_rowloop_plain",
                 "distthresh_compact_live_rowloop_plain"):
        fn = getattr(dt, name)
        monkeypatch.setattr(dt, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    e, q, d = _clustered(8)
    for pruning in ("spatial", "hierarchical"):
        ops.query_block(e, q, d, capacity=256, cand_blk=8, qry_blk=8,
                        device=CPU, compaction="fused_rowloop",
                        pruning=pruning)
    assert calls == ["distthresh_compact_rowloop_plain",
                     "distthresh_compact_live_rowloop_plain"]
    assert all(v == 0 for v in dt.LAUNCHES.values())
    with pytest.raises(ValueError, match="append"):
        dt.distthresh_compact(_t(e), _t(q.T), d, capacity=8, append="x",
                              device=CPU)


def test_empty_inputs():
    e = np.zeros((0, 8), np.float32)
    q = _random(0, 4, 4)[1]
    out = ops.query_block(e, q, 1.0, capacity=8, device=CPU)
    assert int(out["count"]) == 0 and (_np(out["entry_idx"]) == -1).all()
    t_enter, _, hit = ops.interaction_tiles(e, q, 1.0, device=CPU)
    assert tuple(hit.shape) == (0, 4) and t_enter.dtype == torch.float32


@pytest.mark.parametrize("bad", ["dtype", "shape", "mbr"])
def test_wrappers_reject_bad_inputs(bad):
    e, q, d = _random(0, 16, 8)
    et, qt = _t(e), _t(q.T)
    if bad == "dtype":
        with pytest.raises(TypeError):
            dt.distthresh_compact(et.double(), qt, d, capacity=8, device=CPU)
    elif bad == "shape":
        with pytest.raises(ValueError):
            dt.distthresh_dense(et[:, :7], qt, d, device=CPU)
    else:
        with pytest.raises(ValueError, match="together"):
            dt.distthresh_compact(et, qt, d, capacity=8, e_mbr=et,
                                  device=CPU)
