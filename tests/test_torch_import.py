"""The port stands alone: ``repro_torch`` loads neither ``jax`` nor the
reference package, and no source of it (nor ``chip_smoke.py``,
``chip_compare.py`` or ``chip_train_sweep.py``) imports either.  Also pins the device rule: a CUDA
request without CUDA raises."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_has_modules():
    names = {_module_name(p) for p in PORT_FILES}
    assert {"repro_torch.api", "repro_torch.kernels.distthresh",
            "repro_torch.kernels.ops", "repro_torch.core.engine",
            "repro_torch.core.executor", "repro_torch.state",
            "repro_torch.faults", "repro_torch.core.perfmodel",
            "repro_torch.core.scheduler", "repro_torch.serve",
            "repro_torch.serve.broker", "repro_torch.serve.cache",
            "repro_torch.serve.retry", "repro_torch.serve.trajectory",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.granite_3_2b", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.models.convert", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.models.xlstm",
            "repro_torch.kernels.flashattn",
            "repro_torch.kernels._launch", "repro_torch.serve.engine",
            "repro_torch.serve.batcher", "repro_torch.core.rtree",
            "repro_torch.core.distributed", "repro_torch.lint",
            "repro_torch.lint.__main__", "repro_torch.lint.astutils",
            "repro_torch.lint.config", "repro_torch.lint.sentinel",
            "repro_torch.lint.rules", "repro_torch.lint.rules.sync",
            "repro_torch.lint.rules.kern", "repro_torch.lint.rules.dead",
            "repro_torch.lint.rules.fault", "repro_torch.data.tokens",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.step", "repro_torch.train.checkpoint",
            "repro_torch.train.compress", "repro_torch.launch",
            "repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.models.shardctx", "repro_torch.roofline",
            "repro_torch.roofline.analysis", "repro_torch.roofline.opcount",
            "repro_torch.roofline.kernels",
            "repro_torch.roofline.dryrun"} <= names


def test_import_loads_neither_jax_nor_repro():
    mods = [_module_name(p) for p in PORT_FILES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_modules_leave_jax_and_repro_out():
    """The training slice alone (the token pipeline and ``train/``, with
    the models they import) loads neither package."""
    mods = ["repro_torch.data.tokens", "repro_torch.train.optimizer",
            "repro_torch.train.step", "repro_torch.train.checkpoint",
            "repro_torch.train.compress", "repro_torch.launch.sharding",
            "repro_torch.models.shardctx"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
                          ROOT / "chip_train_sweep.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert bad == [], f"{path} imports {bad}"


# ----------------------------------------------------------------------
# Entry points run on the card unless the caller asks for the CPU.
# ----------------------------------------------------------------------
def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.api import TrajectoryDB
    from repro_torch.core import distributed, perfmodel
    from repro_torch.core.engine import DistanceThresholdEngine, brute_force
    from repro_torch.core.segments import SegmentArray
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import distthresh as dt
    from repro_torch.kernels import ops
    from repro_torch.kernels.flashattn import flashattn, flashattn_bwd
    from repro_torch.models import convert, transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import checkpoint
    from repro_torch.train import step as train_step

    cfg = ARCHS["granite-3-2b"].reduced()
    qkv = torch.zeros((2, 4, 16)), torch.zeros((1, 4, 16))
    seg = SegmentArray(*(np.zeros(2, np.float32),) * 6,
                       np.zeros(2, np.float32), np.ones(2, np.float32),
                       np.arange(2), np.zeros(2))
    packed = seg.packed()
    e = torch.from_numpy(packed)
    return {
        "resolve_device": lambda: resolve_device(),
        "TrajectoryDB": lambda: TrajectoryDB.from_segments(seg),
        "DistanceThresholdEngine": lambda: DistanceThresholdEngine(seg),
        "brute_force": lambda: brute_force(seg, seg, 1.0),
        "query_block": lambda: ops.query_block(packed, packed, 1.0,
                                               capacity=8),
        "interaction_tiles": lambda: ops.interaction_tiles(packed, packed,
                                                           1.0),
        "distthresh_dense": lambda: dt.distthresh_dense(e, e.T, 1.0),
        "distthresh_compact": lambda: dt.distthresh_compact(
            e, e.T, 1.0, capacity=8),
        "distthresh_compact_live": lambda: dt.distthresh_compact_live(
            e, e.T, 1.0, torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), capacity=8),
        "distthresh_compact_rowloop": lambda: dt.distthresh_compact(
            e, e.T, 1.0, capacity=8, append="rowloop"),
        "distthresh_compact_live_rowloop": lambda: dt.distthresh_compact_live(
            e, e.T, 1.0, torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), capacity=8, append="rowloop"),
        "distthresh_tile_prep": lambda: dt.distthresh_tile_prep(e, e.T, 1.0),
        "query_block_rowloop": lambda: ops.query_block(
            packed, packed, 1.0, capacity=8, compaction="fused_rowloop"),
        "benchmark_device_curves": lambda: perfmodel.benchmark_device_curves(
            c_values=(8, 16), q_values=(8, 16), repeats=1),
        "flashattn": lambda: flashattn(qkv[0], qkv[1], qkv[1], g=2,
                                       device="cuda"),
        "flashattn_bwd": lambda: flashattn_bwd(
            qkv[0], qkv[1], qkv[1], qkv[0], torch.zeros((2, 4)), qkv[0], g=2,
            device="cuda"),
        "init_train_state": lambda: train_step.init_train_state(
            cfg, generator=torch.Generator()),
        "train_state_from_jax": lambda: convert.train_state_from_jax(
            cfg, {}),
        "checkpoint_restore": lambda: checkpoint.restore(
            str(ROOT), {}, step=0),
        "init_params": lambda: transformer.init_params(
            cfg, generator=torch.Generator()),
        "LM": lambda: transformer.LM(cfg),
        "init_cache": lambda: transformer.init_cache(cfg, 1, 8),
        "ServeEngine": lambda: ServeEngine(
            cfg, transformer.LM(cfg, device="cpu")),
        "ShardedEngine": lambda: distributed.ShardedEngine(seg),
        "pod_devices": lambda: distributed.pod_devices(2),
        "DistributedEngine": lambda: distributed.DistributedEngine(seg),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_cuda_request_without_cuda_raises(name, monkeypatch):
    """Default ``device="cuda"`` on a machine without CUDA raises; nothing
    carries on silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_wrapper_refuses_tensor_on_other_device():
    """A wrapper runs its plain version only when asked for the CPU; it
    never picks a device the caller did not name."""
    from repro_torch.kernels import distthresh as dt
    e = torch.zeros((4, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="but device=cpu"):
        dt.distthresh_dense(e, e.T, 1.0, device="cpu")


# ----------------------------------------------------------------------
# Facade parity with the reference's package surface.
# ----------------------------------------------------------------------
def test_lazy_names_equal_reference():
    """``repro_torch`` exports the reference's 17 lazy facade names (plus
    ``resolve_device``), each the ``repro_torch.api`` object."""
    import repro
    import repro_torch
    from repro_torch import api
    assert repro_torch._API_NAMES == repro._API_NAMES
    assert len(repro_torch._API_NAMES) == 17
    for name in repro_torch._API_NAMES:
        assert getattr(repro_torch, name) is getattr(api, name), name
    assert set(dir(repro_torch)) >= set(repro._API_NAMES) | {
        "resolve_device"}
    assert repro_torch.BACKENDS == ("kernel", "torch", "rtree", "brute",
                                    "shard")
    with pytest.raises(AttributeError):
        repro_torch.NoSuchName


def test_core_deprecated_reexports_warn():
    import repro_torch.core as core
    from repro_torch.core import engine
    for name in ("DistanceThresholdEngine", "ResultSet", "ExecStats",
                 "brute_force"):
        with pytest.warns(DeprecationWarning, match=name):
            assert getattr(core, name) is getattr(engine, name)
        assert name in dir(core)
    with pytest.raises(AttributeError):
        core.NoSuchName


def test_import_package_leaves_jax_out():
    code = ("import sys, repro_torch\n"
            "repro_torch.TrajectoryDB\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
