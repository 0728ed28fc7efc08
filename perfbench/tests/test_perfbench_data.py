"""The benchmark's copy of the generators gives the port's scenarios."""
import numpy as np
import pytest

from perfbench.data import trajgen
from perfbench.harness.spec import HERE
from repro_torch.data import trajgen as port

COLS = trajgen.COLUMNS + ("seg_id", "traj_id")
#: the seeds the port's generators default to
PORT_SEEDS = {"galaxy": 0, "randwalk-exp": 4}


def load_config(name):
    import json
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config,scenario,scale", [
    ("galaxy-s1", "S1", 0.02),
    ("randwalk-exp-s10", "S10", 0.01),
])
def test_copy_equals_the_ports_scenario(config, scenario, scale):
    cfg = load_config(config)
    ds = trajgen.make(cfg["dataset"], cfg["dataset_params"],
                      seed=PORT_SEEDS[cfg["dataset"]], scale=scale)
    db, qs = trajgen.scenario(ds, cfg["paper_query_trajectories"],
                              scale=scale, seed=0)
    want_db, want_qs, d = port.make_scenario(scenario, scale=scale, seed=0)
    assert d == cfg["d"]
    assert cfg["paper_query_trajectories"] == port.SCENARIOS[scenario].num_query_traj
    for c in COLS:
        np.testing.assert_array_equal(db[c], getattr(want_db, c), err_msg=c)
        np.testing.assert_array_equal(qs[c], getattr(want_qs, c), err_msg=c)


def test_galaxy_trajectories_have_400_segments():
    cfg = load_config("galaxy-s1")
    ds = trajgen.make("galaxy", cfg["dataset_params"], seed=0, scale=0.01)
    assert (ds.trajectory_lengths() == cfg["segments_per_trajectory"]).all()


def test_trajectory_slices_cover_the_segments():
    ds = trajgen.make("randwalk-exp", {}, seed=9, scale=0.003)
    sl = ds.traj_slices
    assert sl[0, 0] == 0 and sl[-1, 1] == len(ds)
    assert (sl[1:, 0] == sl[:-1, 1]).all()
    for k in (0, len(sl) // 2, len(sl) - 1):
        a, b = sl[k]
        assert (ds.cols["traj_id"][a:b] == k).all()
        np.testing.assert_array_equal(ds.cols["seg_id"][a:b], np.arange(b - a))


@pytest.mark.parametrize("config", ["galaxy-s1", "randwalk-exp-s10"])
def test_the_database_follows_the_seed(config):
    cfg = load_config(config)

    def make(seed):
        return trajgen.make(cfg["dataset"], cfg["dataset_params"],
                            seed=[seed, 0], scale=0.01)

    a, b, c = make(2 ** 33 + 1), make(2 ** 33 + 1), make(2 ** 33 + 2)
    np.testing.assert_array_equal(a.cols["xs"], b.cols["xs"])
    assert a.cols["xs"].shape != c.cols["xs"].shape or \
        not np.array_equal(a.cols["xs"], c.cols["xs"])
