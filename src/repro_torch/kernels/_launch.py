"""What every kernel wrapper shares at a launch: the launch counters, the
pointers and stream handed to the C interface, and the error check.

``LAUNCHES`` holds one plain integer per CUDA kernel, bumped only where a
wrapper has launched that kernel (never on the plain path), so a run can
show which kernels its path went through.  Reset by assigning 0.
"""
from __future__ import annotations

import threading

import torch

LAUNCHES = {"distthresh_dense": 0, "distthresh_compact": 0,
            "distthresh_compact_live": 0, "distthresh_compact_rowloop": 0,
            "distthresh_compact_live_rowloop": 0, "flashattn": 0}
#: Serializes the increments: the scheduler and the broker dispatch from
#: several threads.
_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error (a refused
    launch never runs, and no later synchronize reports it)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
