"""Device resolution for every entry point of the port.

The port runs on the card.  An entry point takes ``device=`` (default
``"cuda"``) and resolves it here; the CPU is used only when the caller
asks for it (the tests pass ``device="cpu"``).  There is no fallback: a
``"cuda"`` request on a machine without CUDA raises instead of carrying
on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available, ``ValueError`` for a
    device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available;"
                f" pass device='cpu' to run the plain PyTorch versions on the"
                f" CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")


__all__ = ["resolve_device"]
