"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The one identity of `device` that the port stores and compares.

    A device on the card always carries its index: an index-less
    ``cuda`` becomes ``cuda:{torch.cuda.current_device()}``, the device
    every tensor made on ``"cuda"`` reports, and ``cuda:N`` keeps N. So
    a device stored by one entry point equals a tensor's ``.device`` and
    another entry point's device for the same card. ``cpu`` is returned
    as given (CPU tensors report an index-less ``cpu``). Asking for
    ``cuda`` when no CUDA device is present raises: an entry point asked
    to run on the card never carries on on the CPU. Call it in the
    process that uses the device, after any ``torch.cuda.set_device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
