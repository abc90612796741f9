"""Device policy of the port: entry points run on the card unless asked not to.

Takes the place of ``on_tpu()`` in the JAX package (``repro/kernels/ops.py``):
``on_cuda()`` decides the default dispatch, and every entry point that puts
tensors on a device takes an explicit ``device`` argument that
:func:`resolve_device` turns into a ``torch.device``.  ``None`` means the
card; ``"cpu"`` runs the kernels' plain PyTorch versions on the host (what
the tests do).  Asking for CUDA where there is none raises instead of
quietly running on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DeviceLike", "default_device", "on_cuda", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def on_cuda() -> bool:
    """True when PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none."""
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (``None`` -> :func:`default_device`).

    Raises ``RuntimeError`` for a CUDA device when CUDA is absent and
    ``ValueError`` for device types the port does not run on."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not on_cuda():
            raise RuntimeError(
                "repro_torch needs a CUDA device here but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions on the host"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    return dev
