"""Activation sharding (the reference's ``repro/models/shardctx.py``):
the layout of intermediate tensors on a device mesh.

* Model code calls ``constrain(x, roles)``, one role per dim naming its
  logical axis: ``"batch"``, ``"heads"``, ``"ffn"``, ``"experts"``,
  ``"vocab"``, ``"state"``, ``"seq"``, ``"kv_seq"`` or None.
* The launcher maps roles to mesh axes with :func:`activation_sharding`.
* Outside such a context ``constrain`` returns its argument itself, so
  the paths without a mesh do exactly what they did before.
* Inside one it redistributes a DTensor to the roles' placements; a dim
  whose size does not divide its axes stays unsharded, as in the
  reference, so the rules hold for all 10 architectures.

The reference pins layouts for GSPMD, which partitions one global
program; here the tensors are DTensors and a layout is where their
shards live.  The context is per thread, as the reference's: on CUDA
the autograd engine runs the backward on a device thread of its own, so
a rematerialised block runs under :func:`checkpoint`, whose recompute
re-enters the context its forward ran in.  Inside a context, plain
tensors that meet DTensors (positions, masks, constants the model makes)
count as replicated: that is DTensor's ``implicit_replication`` switch,
which is one for the whole process and stays on while any thread is
inside a context.  Code that cannot take a DTensor (the hand-written
kernels hand ``data_ptr()`` to their launches) runs on each rank's
shards through :func:`local` (``local_map``).

The axis helpers (:func:`axis_sizes`, :func:`to_placements`) live here,
below the launcher, which builds its meshes and rules on them.
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Callable, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


class _Active(threading.local):
    """This thread's active (mesh, role → axes), or None."""
    ctx = None


_ACTIVE = _Active()


class _ImplicitReplication:
    """DTensor's process-wide implicit-replication switch, on while any
    thread is inside a context (``implicit_replication`` itself turns it
    off when any one of them leaves)."""
    lock = threading.Lock()
    depth = 0

    @classmethod
    @contextlib.contextmanager
    def held(cls):
        dispatcher = DTensor._op_dispatcher
        with cls.lock:
            cls.depth += 1
            dispatcher._allow_implicit_replication = True
        try:
            yield
        finally:
            with cls.lock:
                cls.depth -= 1
                if cls.depth == 0:
                    dispatcher._allow_implicit_replication = False

DEFAULT_ROLE_AXES = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "state": ("model",),
    "seq": (),
    "kv_seq": (),
}


@contextlib.contextmanager
def activation_sharding(mesh, role_axes: dict | None = None):
    """Lay activations out over ``mesh`` (a ``DeviceMesh``) inside the
    block; ``role_axes`` overrides :data:`DEFAULT_ROLE_AXES`."""
    roles = dict(DEFAULT_ROLE_AXES)
    if role_axes:
        roles.update(role_axes)
    prev = _ACTIVE.ctx
    _ACTIVE.ctx = (mesh, roles)
    try:
        with _ImplicitReplication.held():
            yield
    finally:
        _ACTIVE.ctx = prev


def current_mesh():
    ctx = _ACTIVE.ctx
    return ctx[0] if ctx else None


def _recompute_contexts():
    """``context_fn`` of :func:`checkpoint`, called as its forward runs:
    the recompute re-enters that thread's context."""
    ctx = _ACTIVE.ctx
    again = (contextlib.nullcontext() if ctx is None
             else activation_sharding(*ctx))
    return contextlib.nullcontext(), again


def checkpoint(fn: Callable, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)``, whose
    recompute runs in the context the forward ran in, on whichever thread
    the backward runs."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=_recompute_contexts)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``)
    or of a shape-only stand-in with ``axis_names`` and ``shape``."""
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names
        if names is None:
            raise ValueError("the mesh's dimensions have no names")
        return dict(zip(names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements over ``mesh`` (a ``DeviceMesh``) for a spec
    tuple: ``Shard(dim)`` on each mesh axis that shards tensor dim
    ``dim`` (a dim over several axes is sharded on each, in mesh order,
    as JAX lays a ``P((a, b))`` dim out), ``Replicate()`` on the rest."""
    dims: dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if axis in dims:
                raise ValueError(f"axis {axis!r} shards two dims of {spec}")
            dims[axis] = dim
    names = axis_names(mesh)
    unknown = set(dims) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not in "
                         f"the mesh's {names}")
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


def _role_ways(sizes: dict, role_axes: dict, role) -> tuple[tuple, int]:
    axes = tuple(a for a in role_axes.get(role, ()) if a in sizes)
    return axes, int(np.prod([sizes[a] for a in axes])) if axes else 1


def batch_block_count(n: int) -> int:
    """Number of batch-axis shards dividing ``n`` (1 outside a context):
    the MoE sorts and ranks its tokens within each shard's block."""
    ctx = _ACTIVE.ctx
    if ctx is None:
        return 1
    mesh, role_axes = ctx
    _, ways = _role_ways(axis_sizes(mesh), role_axes, "batch")
    return ways if (ways > 1 and n % ways == 0) else 1


def spec_for(shape: Sequence[int], roles: tuple) -> tuple:
    """The spec tuple the active context gives a tensor of ``shape`` with
    per-dim ``roles`` (the reference's rule: a role's axes shard its dim
    only when their total size divides it)."""
    mesh, role_axes = _ACTIVE.ctx
    if len(roles) != len(shape):
        raise ValueError(f"roles {roles} for a tensor of shape "
                         f"{tuple(shape)}")
    sizes = axis_sizes(mesh)
    spec = []
    for dim, role in zip(shape, roles):
        axes, ways = _role_ways(sizes, role_axes, role) if role else ((), 1)
        if ways > 1 and dim % ways == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return tuple(spec)


def _as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, roles: tuple) -> torch.Tensor:
    """``x`` itself outside a context; inside one, ``x`` as a DTensor
    laid out by ``roles`` (a plain tensor is taken as replicated), and
    its gradient laid out as ``x`` was."""
    ctx = _ACTIVE.ctx
    if ctx is None:
        return x
    mesh = ctx[0]
    placements = to_placements(spec_for(x.shape, roles), mesh)
    # Redistributed even when already so laid out: the backward lays the
    # gradient out as x was, as a sharding constraint binds the
    # cotangent too.
    return _as_dtensor(x, mesh).redistribute(mesh, placements)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on every rank (an all-gather of a
    DTensor sharded there; anything else as it is), for an op that
    indexes along it."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    placements = tuple(Replicate() if p.is_shard(dim) else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def local(fn: Callable, args: Sequence, in_roles: Sequence,
          out_like: Sequence[int]):
    """``fn(*args)`` outside a context.  Inside one, ``fn`` runs on each
    rank's shards (``local_map``; gradients flow through it): each tensor
    argument is first laid out by its roles (None for an argument passed
    as it is), and output ``i`` is taken as laid out as argument
    ``out_like[i]``, so ``fn`` must compute each output's shard from the
    matching shards of its inputs."""
    ctx = _ACTIVE.ctx
    if ctx is None:
        if any(isinstance(a, DTensor) for a in args):
            raise RuntimeError("DTensor arguments outside an "
                               "activation_sharding context")
        return fn(*args)
    mesh = ctx[0]
    laid = [a if roles is None else constrain(a, roles)
            for a, roles in zip(args, in_roles, strict=True)]
    ins = tuple(None if roles is None else tuple(a.placements)
                for a, roles in zip(laid, in_roles))
    mapped = local_map(fn, out_placements=tuple(ins[i] for i in out_like),
                       in_placements=ins, device_mesh=mesh)
    return mapped(*laid)


__all__ = ["DEFAULT_ROLE_AXES", "activation_sharding", "axis_names",
           "axis_sizes", "batch_block_count", "checkpoint", "constrain",
           "current_mesh", "local", "spec_for", "to_placements", "unshard"]
