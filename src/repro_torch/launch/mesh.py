"""Device meshes (the reference's ``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no
process group and no device.

Axes, as the reference names them:

* ``pod`` — 2 pods (multi-pod only): data parallelism; no parameter is
  sharded over it;
* ``data`` — the batch / FSDP axis within a pod;
* ``model`` — the tensor- and expert-parallel axis.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, which the caller initialises
(``torch.distributed.init_process_group``, with its own address, world
size and rank: nothing on the machine announces a cluster).  The rules
need only each axis's size: :func:`axis_sizes` (from ``models.shardctx``,
which lays activations out on the same axes) reads them from a
``DeviceMesh`` or from a shape-only stand-in, any object with
``axis_names`` and a ``shape`` mapping (the reference's tests use such a
``FakeMesh``).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.models.shardctx import axis_names, axis_sizes, to_placements

#: (shape, axes) of the reference's production meshes.
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str],
                     device_type: str | None = None) -> DeviceMesh:
    """``init_device_mesh`` of ``shape`` named ``axes`` over the default
    process group.  ``device_type`` is resolved as every entry point
    resolves its device: ``"cuda"`` when None, an error when CUDA is
    absent; ``"cpu"`` meshes run on the gloo backend."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)}"
                         f" differ in length")
    dev = resolve_device("cuda" if device_type is None else device_type)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """The reference's 16 × 16 (or 2 × 16 × 16 with ``multi_pod``) mesh;
    raises unless the process group's world size is its size."""
    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} ranks;"
                           f" the process group has {world}")
    return make_mesh_compat(shape, axes, device_type)


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A small CPU (gloo) mesh over the current process group: tests."""
    return make_mesh_compat(shape, axes, "cpu")


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the batch dimension ("pod" included when present)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_ways(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


__all__ = ["PRODUCTION", "axis_names", "axis_sizes", "batch_ways",
           "data_axes", "make_host_mesh", "make_mesh_compat",
           "make_production_mesh", "to_placements"]
