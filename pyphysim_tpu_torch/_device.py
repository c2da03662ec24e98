"""Explicit device handling: a CUDA device that is asked for must exist.

There is no silent CPU fallback anywhere in the port. Every constructor
and entry point defaults to ``device="cuda"``; on a machine without a
usable card it raises at construction time instead of giving a CPU run that
looks like a GPU run. A caller who wants the CPU says ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

__all__ = ["DeviceLike", "require_cuda"]


def require_cuda(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a :class:`torch.device`; raise ``RuntimeError``
    when it names a CUDA device and ``torch.cuda.is_available()`` is
    False (``None`` means the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch.cuda.is_available() "
            "is False; the port has no CPU fallback for a CUDA device")
    return dev
