"""The device mesh in the port (``launch/``, ``models/shardctx.py`` and the
mesh halves of ``train/``) against the reference.

* **The rules**, with no ranks: ``param_spec`` (``fsdp`` off and on),
  ``grad_specs``, ``train_state_shardings``, ``input_shardings`` and
  ``cache_shardings`` for all 10 architectures at full size, on the
  (16, 16), (2, 16, 16) with ``pod``, (4, 2) and (2, 4) meshes
  (shape-only stand-ins on both sides: the reference's ``AbstractMesh``,
  the port's ``FakeMesh``), mapped through ``convert.reference_location``
  onto the port's parameter names: equal to the reference's
  ``PartitionSpec``s.
* **gloo meshes in subprocesses**, one process per rank, each with its
  own timeout:

  1. a (2, 2) train step of reduced granite-3-2b and qwen3-moe-30b-a3b
     (float32), at 1 and at 2 microbatches, state placed by ``train_state_shardings``, gradients by
     ``grad_specs``, activations by ``activation_sharding``, against the
     reference's jitted step on a forced 4-device host mesh under
     ``jax.set_mesh`` and its ``activation_sharding``, from the same
     state and batch; loss, grad_norm and master weights held as
     ``test_torch_train.py`` holds one step (its ``FLOOR``, ``CAP`` and
     ``SPREAD_FACTOR``, the control being the reference's step from
     weights moved by one float32 rounding).  Negative control: qwen3
     with ``batch_block_count`` forced to 1 (one MoE block, one capacity
     for the whole batch) misses the reference;
  2. elastic restore: a train state saved from an 8-rank (4, 2) mesh and
     restored onto (2, 4) is bit-equal, its leaves on the new mesh; a
     save whose write fails on rank 0 raises on every rank;
  3. ``make_compressed_allreduce`` over 4 ranks, bf16 and int8, against
     the reference's on a (4, 1) host mesh: the residuals equal (int8:
     within the reference's own jit-versus-eager spread), the mean
     within 1e-6 (the sum of four float32 payloads in another order).
"""
import functools
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import sharding as rshd
from repro.models import transformer as RT
from repro.train import step as rstep
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.models import convert, shardctx
from repro_torch.models import transformer as T
from repro_torch.train import step as step_lib

from test_torch_train import CAP, FLOOR, SPREAD_FACTOR

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
#: Seconds each rank of a gloo run, and each reference run, may take.
TIMEOUT = 300
#: Microbatch counts of the sharded step comparison.
MICROBATCHES = (1, 2)


class FakeMesh:
    """A shape-only mesh: axis names and sizes, no ranks."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _meshes(key):
    shape, axes = MESHES[key]
    return FakeMesh(shape, axes), AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's parameter shapes by path."""
    flat = jax.tree_util.tree_flatten_with_path(
        RT.param_specs(REF_ARCHS[arch]))[0]
    return {tuple(rshd._path_names(p)): leaf for p, leaf in flat}


def _mapped(name, ref_by_path, fn):
    """The reference's spec for the port's parameter ``name`` (``fn`` of
    the reference's path and leaf), mapped onto the port's layout."""
    path, lead, transposed = convert.reference_location(name)
    spec = tuple(fn(path, ref_by_path[path]))
    assert spec[:lead] == (None,) * lead, (name, spec)
    body = spec[lead:]
    return body[::-1] if transposed else body


# ----------------------------------------------------------------------
# The rules.
# ----------------------------------------------------------------------
def test_reference_location_matches_the_reference_tree():
    """Every port parameter of every architecture has a reference path
    whose leaf, stack dims dropped and transposed where the conversion
    transposes, is the port's shape; every reference leaf is reached."""
    for arch, cfg in ARCHS.items():
        ref = _ref_params(arch)
        reached = set()
        for name, p in T.param_specs(cfg).items():
            path, lead, transposed = convert.reference_location(name)
            shape = tuple(ref[path].shape[lead:])
            assert (shape[::-1] if transposed else shape) == tuple(
                p.shape), (arch, name)
            reached.add(path)
        assert reached == set(ref), (arch, set(ref) - reached)


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_rules_equal_reference(arch, mesh_key):
    """``param_spec`` (fsdp off and on), ``grad_specs`` and
    ``train_state_shardings`` on the port's names."""
    fake, amesh = _meshes(mesh_key)
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    ref = _ref_params(arch)
    specs = T.param_specs(cfg)
    for fsdp in (False, True):
        for name, p in specs.items():
            want = _mapped(name, ref, lambda path, leaf: rshd.param_spec(
                [jax.tree_util.DictKey(k) for k in path], leaf.shape, amesh,
                fsdp=fsdp))
            assert shd.param_spec(name, p.shape, fake, fsdp=fsdp) == want, \
                (name, fsdp)
    rgrad = rshd.grad_specs(rcfg, amesh, RT.param_specs(rcfg))
    rgrad = {tuple(rshd._path_names(p)): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 rgrad, is_leaf=lambda x: isinstance(
                     x, jax.sharding.PartitionSpec))[0]}
    got = shd.grad_specs(cfg, fake, specs)
    for name in specs:
        assert got[name] == _mapped(name, rgrad, lambda path, s: s), name
    rstate = rshd.train_state_shardings(rcfg, amesh,
                                        rstep.train_state_specs(rcfg))
    state = shd.train_state_shardings(cfg, fake,
                                      step_lib.train_state_specs(cfg))
    assert state["opt"]["count"] == tuple(rstate["opt"]["count"].spec) == ()
    for part, tree in (("params", rstate["params"]),
                       ("m", rstate["opt"]["m"]), ("v", rstate["opt"]["v"]),
                       ("master", rstate["opt"]["master"])):
        by_path = {tuple(rshd._path_names(p)): s.spec for p, s in
                   jax.tree_util.tree_flatten_with_path(tree)[0]}
        got = state["params"] if part == "params" else state["opt"][part]
        assert set(got) == set(specs)
        for name in specs:
            assert got[name] == _mapped(name, by_path,
                                        lambda path, s: s), (part, name)


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_rules_equal_reference(arch, mesh_key):
    """``input_shardings`` and ``input_structs`` for every shape;
    ``cache_shardings`` of the decode cache for the decode shapes (the
    port's ``init_cache`` on the meta device against the reference's
    ``eval_shape``)."""
    fake, amesh = _meshes(mesh_key)
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    for key, shape in SHAPES.items():
        rshape = REF_SHAPES[key]
        want = {k: tuple(s.spec) for k, s in
                rshd.input_shardings(rcfg, rshape, amesh).items()}
        assert shd.input_shardings(cfg, shape, fake) == want, key
        rstructs = rshd.input_structs(rcfg, rshape)
        structs = shd.input_structs(cfg, shape)
        assert set(structs) == set(rstructs)
        for k, s in structs.items():
            assert s.device.type == "meta"
            assert tuple(s.shape) == tuple(rstructs[k].shape), (key, k)
            assert str(s.dtype).split(".")[-1] == str(rstructs[k].dtype)
        if shape.kind != "decode":
            continue
        rcache = jax.eval_shape(lambda: RT.init_cache(
            rcfg, rshape.global_batch, rshape.seq_len))
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        assert jax.tree.map(lambda x: tuple(x.shape), rcache) == {
            k: tuple(tuple(x.shape) for x in v) if isinstance(v, tuple)
            else tuple(v.shape) for k, v in cache.items()}
        rsh = rshd.cache_shardings(rcfg, rshape, amesh, rcache)
        want = jax.tree.map(lambda s: tuple(s.spec), rsh)
        assert shd.cache_shardings(cfg, shape, fake, cache) == want, key


def test_to_placements_and_batch_block_count():
    mesh = FakeMesh((2, 4, 2), ("pod", "data", "model"))
    assert M.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert M.to_placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert M.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="two dims"):
        M.to_placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in"):
        M.to_placements(("seq",), mesh)
    assert M.axis_sizes(mesh) == {"pod": 2, "data": 4, "model": 2}
    assert M.data_axes(mesh) == ("pod", "data") and M.batch_ways(mesh) == 8
    assert shardctx.batch_block_count(64) == 1
    with shardctx.activation_sharding(mesh):
        assert shardctx.current_mesh() is mesh
        assert shardctx.batch_block_count(64) == 8
        assert shardctx.batch_block_count(12) == 1
        assert shardctx.spec_for((16, 5, 4), ("batch", "heads", "ffn")) == (
            ("pod", "data"), None, "model")
    assert shardctx.current_mesh() is None


def test_recompute_sees_the_context_and_other_threads_do_not():
    """The context is per thread, as the reference's.  On CUDA the
    autograd engine runs the backward, and a remat recompute with it, on
    a device thread of its own: ``shardctx.checkpoint``'s recompute must
    re-enter the forward's context there (a recompute that missed it
    handed DTensors to the flash kernel on the card), while a thread
    started inside a context sees none."""
    mesh = FakeMesh((2, 2), ("data", "model"))
    seen = []

    def body(x):
        seen.append((shardctx.current_mesh(),
                     shardctx.batch_block_count(4)))
        return x * x

    def look():
        seen.append((shardctx.current_mesh(),
                     shardctx.batch_block_count(4)))

    x = torch.ones(3, requires_grad=True)
    with shardctx.activation_sharding(mesh):
        y = shardctx.checkpoint(body, x).sum()
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    # The backward on a thread of its own, outside any context.
    t = threading.Thread(target=y.backward)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [(mesh, 2), (None, 1), (mesh, 2)]
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    assert shardctx.current_mesh() is None


def test_constrain_outside_a_mesh_is_the_identity():
    x = torch.ones(4, 2)
    assert shardctx.constrain(x, ("batch", None)) is x
    assert shardctx.local(lambda a: a + 1, (x,), (("batch", None),),
                          (0,)).sum() == 16


def test_meshes_need_their_ranks():
    """Without CUDA the default mesh refuses; the production mesh
    refuses a process group of another size (here: none)."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default mesh would build")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_mesh_compat((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        M.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh_compat((2,), ("data", "model"), "cpu")


# ----------------------------------------------------------------------
# gloo meshes, one subprocess per rank.
# ----------------------------------------------------------------------
def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + str(ROOT / "tests"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _run(script: str, argv_list: list[list[str]]) -> list[str]:
    """``script`` in one process per argv, all at once; each must end
    with code 0 within ``TIMEOUT``.  Returns their standard outputs."""
    procs = [subprocess.Popen([sys.executable, "-c", script, *argv],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_env()) for argv in argv_list]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out[-2000:] + err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _ranks(script: str, world: int, *args: str) -> list[str]:
    return _run(script, [[*args, str(rank), str(world)]
                         for rank in range(world)])


_REF_STEP = f"MICROBATCHES = {MICROBATCHES}\n" + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, jax, numpy as np, torch
    from repro.configs import ARCHS as RA
    from repro.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro.launch import sharding as shd
    from repro.launch.mesh import make_mesh_compat
    from repro.models import shardctx
    from repro.train import optimizer as opt, step as st
    from repro_torch.configs import ARCHS
    from repro_torch.models import convert
    from test_torch_train import OPT

    arch, out = sys.argv[1], sys.argv[2]
    assert jax.device_count() == 4
    rcfg = dataclasses.replace(RA[arch].reduced(), dtype="float32")
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    state = st.init_train_state(rcfg, jax.random.PRNGKey(0))
    port0 = convert.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, state), device="cpu")
    torch.save({"params": port0["params"].state_dict(),
                "opt": port0["opt"]}, f"{out}/state0.pt")
    batch = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=16,
        global_batch=4)).global_batch_at(0)
    np.savez(f"{out}/batch.npz", **batch)

    rng = np.random.default_rng(1)
    pert = jax.tree.map(
        lambda x: (np.asarray(x) * (1 + 2.0 ** -23 * rng.choice(
            [-1, 1], size=np.shape(x)))).astype(np.float32),
        state["params"])
    control = {"params": pert, "opt": opt.init_state(pert)}

    mesh = make_mesh_compat((2, 2), ("data", "model"))
    specs = st.train_state_specs(rcfg)
    sh = shd.train_state_shardings(rcfg, mesh, specs)
    gs = shd.grad_specs(rcfg, mesh, specs["params"])
    results = {}
    for mb in MICROBATCHES:
        step = jax.jit(st.make_train_step(rcfg, opt.AdamWConfig(**OPT),
                                          microbatches=mb, grad_specs=gs))
        with jax.set_mesh(mesh), shardctx.activation_sharding(mesh):
            for name, s in (("ref", state), ("control", control)):
                new, m = step(jax.tree.map(jax.device_put, s, sh), batch)
                master = convert.train_state_from_jax(
                    cfg, jax.tree.map(np.asarray, new), device="cpu")[
                    "opt"]["master"]
                results[name, mb] = {"loss": float(m["loss"]),
                                     "grad_norm": float(m["grad_norm"]),
                                     "master": master}
    torch.save(results, f"{out}/ref.pt")
    print("REF_OK", {k: (v["loss"], v["grad_norm"])
                     for k, v in results.items()})
""")

_PORT_STEP = f"MICROBATCHES = {MICROBATCHES}\n" + textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch
    import torch.distributed as dist
    arch, out, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        int(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rdv",
                            rank=rank, world_size=world)
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as M, sharding as shd
    from repro_torch.models import shardctx
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt, step as st
    from test_torch_train import OPT

    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    saved = torch.load(f"{out}/state0.pt")
    batch = dict(np.load(f"{out}/batch.npz"))
    mesh = M.make_host_mesh((2, 2), ("data", "model"))
    specs = st.train_state_specs(cfg)
    sh = shd.train_state_shardings(cfg, mesh, specs)
    gs = shd.grad_specs(cfg, mesh, specs["params"])

    def fresh():
        model = T.LM(cfg, device="cpu")
        model.load_state_dict(saved["params"])
        o = {k: {n: t.clone() for n, t in saved["opt"][k].items()}
             for k in ("m", "v", "master")}
        o["count"] = saved["opt"]["count"].clone()
        return shd.place({"params": model, "opt": o}, sh, mesh)

    runs = [("port", mb) for mb in MICROBATCHES] + (
        [("one_block", 1)] if cfg.is_moe else [])
    results = {}
    blocks = shardctx.batch_block_count
    for name, mb in runs:
        state = fresh()
        step = st.make_train_step(cfg, opt.AdamWConfig(**OPT),
                                  microbatches=mb, grad_specs=gs)
        if name == "one_block":
            shardctx.batch_block_count = lambda n: 1
        with shardctx.activation_sharding(mesh):
            state, m = step(state, batch)
        shardctx.batch_block_count = blocks
        for n, p in state["params"].named_parameters():
            assert p.placements == M.to_placements(sh["params"][n], mesh), n
        for n, w in state["opt"]["master"].items():
            assert w.placements == M.to_placements(
                sh["opt"]["master"][n], mesh), n
        results[name, mb] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "master": {n: w.full_tensor() for n, w in
                       state["opt"]["master"].items()}}
    if rank == 0:
        torch.save(results, f"{out}/port.pt")
        print("PORT_OK", {k: (v["loss"], v["grad_norm"])
                          for k, v in results.items()})
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """``arch`` → the reference's and the port's step results, each run
    once per module."""
    runs = {}

    def get(arch: str) -> dict:
        if arch not in runs:
            out = str(tmp_path_factory.mktemp(arch))
            _run(_REF_STEP, [[arch, out]])
            _ranks(_PORT_STEP, 4, arch, out)
            runs[arch] = {**torch.load(f"{out}/ref.pt"),
                          **torch.load(f"{out}/port.pt")}
        return runs[arch]
    return get


def _misses(got: dict, ref: dict, control: dict) -> list:
    """How ``got`` misses the reference's step, as
    ``test_torch_train.py`` holds one step: [] when it does not."""
    out = []
    for k in ("loss", "grad_norm"):
        want = ref[k]
        spread = abs(control[k] - want) / want
        tol = min(max(FLOOR[k], SPREAD_FACTOR * spread), CAP[k])
        if abs(got[k] - want) / want > tol:
            out.append((k, got[k], want, tol))

    def beyond(a):
        return sum(int(((a[n] - ref["master"][n]).abs()
                        > FLOOR["master"]).sum()) for n in a)
    flipped, allowed = beyond(got["master"]), SPREAD_FACTOR * beyond(
        control["master"])
    if flipped > allowed:
        out.append(("master", flipped, allowed))
    return out


@pytest.mark.parametrize("microbatches", MICROBATCHES)
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b"])
def test_sharded_step_matches_reference(arch, microbatches, step_runs):
    """With 2 microbatches each one's gradient is laid out by
    ``grad_specs`` before it is added to the accumulator."""
    runs = step_runs(arch)
    mb = microbatches
    assert _misses(runs["port", mb], runs["ref", mb],
                   runs["control", mb]) == []


def test_one_moe_block_misses_reference(step_runs):
    """The negative control: without the per-shard MoE blocks (one block,
    one capacity for the whole batch) the step is not the reference's."""
    runs = step_runs("qwen3-moe-30b-a3b")
    assert _misses(runs["one_block", 1], runs["ref", 1],
                   runs["control", 1]) != []


_ELASTIC = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    root, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdv",
                            rank=rank, world_size=world)
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as M, sharding as shd
    from repro_torch.train import checkpoint as ckpt, step as st

    cfg = ARCHS["granite-3-2b"].reduced()
    specs = st.train_state_specs(cfg)
    state = st.init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = dict(ckpt._flatten(state))
    want = {k: v.detach().clone() for k, v in want.items()}
    mesh_a = M.make_host_mesh((4, 2))
    placed = shd.place(state, shd.train_state_shardings(cfg, mesh_a, specs),
                       mesh_a)
    ckpt.save(f"{root}/ckpt", 7, placed)
    mesh_b = M.make_host_mesh((2, 4))
    sh_b = shd.train_state_shardings(cfg, mesh_b, specs)
    restored, step, _ = ckpt.restore(f"{root}/ckpt", placed, shardings=sh_b,
                                     mesh=mesh_b, device="cpu")
    assert step == 7
    got = dict(ckpt._flatten(restored))
    assert list(got) == list(want)
    for name, leaf in got.items():
        assert isinstance(leaf, DTensor), name
        assert leaf.device_mesh is mesh_b, name
        full = leaf.full_tensor()
        assert full.dtype == want[name].dtype, name
        assert torch.equal(full, want[name]), name
    for n, p in restored["params"].named_parameters():
        assert p.placements == M.to_placements(sh_b["params"][n], mesh_b), n
    assert restored["opt"]["master"]["layers.0.attn.wq.weight"].placements \\
        == M.to_placements(sh_b["opt"]["master"]["layers.0.attn.wq.weight"],
                           mesh_b)
    # A write that fails on rank 0 (its root is a file) raises everywhere.
    blocked = f"{root}/blocked"
    if rank == 0:
        open(blocked, "w").close()
    try:
        ckpt.save(blocked, 8, restored)
    except (OSError, RuntimeError) as e:
        assert rank == 0 or "rank 0 failed" in str(e), e
        print("SAVE_FAILURE_RAISED", rank)
    dist.destroy_process_group()
    print("ELASTIC_OK", rank, len(got))
""")


def test_elastic_restore_onto_a_reshaped_mesh(tmp_path):
    """Saved from (4, 2), restored onto (2, 4): the same values, every
    leaf on the new mesh in the new rules' layout (the reference's
    ``test_elastic_reshard_subprocess`` on the port).  Then a save whose
    write fails on rank 0 raises on every rank, none left waiting."""
    outs = _ranks(_ELASTIC, 8, str(tmp_path))
    assert all("ELASTIC_OK" in o and "SAVE_FAILURE_RAISED" in o
               for o in outs)
    assert os.listdir(tmp_path / "ckpt") == ["step_00000007"]


_REF_COMPRESS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh_compat
    from repro.train import compress
    out = sys.argv[1]
    inp = dict(np.load(f"{out}/inputs.npz"))
    mesh = make_mesh_compat((4, 1), ("data", "model"))
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("data")))
    res = {}
    for codec in ("bf16", "int8"):
        fn = compress.make_compressed_allreduce(mesh, ("data",), codec)
        mean, err = fn({k: put(inp["g_" + k]) for k in ("a", "b")},
                       {k: put(inp["e_" + k]) for k in ("a", "b")})
        for k in ("a", "b"):
            res[f"{codec}_mean_{k}"] = np.asarray(mean[k])
            res[f"{codec}_err_{k}"] = np.asarray(err[k])
    np.savez(f"{out}/ref.npz", **res)
    print("REF_OK")
""")

_PORT_COMPRESS = textwrap.dedent("""
    import sys, numpy as np, torch
    import torch.distributed as dist
    out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"file://{out}/rdv",
                            rank=rank, world_size=world)
    from torch.distributed.tensor import DTensor, Replicate, Shard, \\
        distribute_tensor
    from repro_torch.launch import mesh as M
    from repro_torch.train import compress
    inp = dict(np.load(f"{out}/inputs.npz"))
    mesh = M.make_host_mesh((4, 1), ("data", "model"))
    put = lambda x: distribute_tensor(torch.from_numpy(x), mesh,
                                      [Shard(0), Replicate()])
    res = {}
    for codec in ("bf16", "int8"):
        fn = compress.make_compressed_allreduce(mesh, ("data",), codec)
        mean, err = fn({k: put(inp["g_" + k]) for k in ("a", "b")},
                       {k: put(inp["e_" + k]) for k in ("a", "b")})
        for k in ("a", "b"):
            assert isinstance(mean[k], DTensor)
            assert mean[k].placements == (Replicate(), Replicate())
            assert err[k].placements == (Shard(0), Replicate())
            res[f"{codec}_mean_{k}"] = mean[k].to_local().numpy()
            res[f"{codec}_err_{k}"] = err[k].full_tensor().numpy()
    if rank == 0:
        np.savez(f"{out}/port.npz", **res)
    dist.destroy_process_group()
    print("PORT_OK")
""")


@pytest.fixture(scope="module")
def compress_runs(tmp_path_factory):
    """The reference's and the port's results on the same seeded
    inputs, both codecs, run once per module."""
    out = str(tmp_path_factory.mktemp("compress"))
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(4, 37)), "b": rng.normal(size=(4, 3, 5)) * 10}
    np.savez(f"{out}/inputs.npz",
             **{f"g_{k}": v.astype(np.float32) for k, v in g.items()},
             **{f"e_{k}": (rng.normal(size=v.shape) * 1e-3).astype(
                 np.float32) for k, v in g.items()})
    _run(_REF_COMPRESS, [[out]])
    _ranks(_PORT_COMPRESS, 4, out)
    return (dict(np.load(f"{out}/ref.npz")), dict(np.load(f"{out}/port.npz")),
            dict(np.load(f"{out}/inputs.npz")))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compressed_allreduce_matches_reference(codec, compress_runs):
    """bf16: the residuals equal.  int8: the reference's jitted
    ``u / scale`` and ``q · scale`` differ from its own eager
    ``compress_leaf`` (which the port's equals, ``test_torch_train.py``)
    by up to one float32 rounding of the leaf's largest |g + e|
    (measured 0.41 and 0.30 of it on these leaves), so the residuals are
    held within that."""
    ref, port, inputs = compress_runs
    for k in ("a", "b"):
        u = np.abs(inputs[f"g_{k}"] + inputs[f"e_{k}"]).max()
        atol = 0.0 if codec == "bf16" else float(u) * 2.0 ** -23
        np.testing.assert_allclose(port[f"{codec}_err_{k}"],
                                   ref[f"{codec}_err_{k}"], rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(port[f"{codec}_mean_{k}"],
                                   ref[f"{codec}_mean_{k}"],
                                   rtol=1e-6, atol=atol)
