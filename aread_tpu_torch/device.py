"""Device resolution for the port's entry points.

Entry points default to the card. A caller that wants the CPU (the tests,
the plain reference path) says so with ``device="cpu"``; a request for
the card on a machine without one raises rather than quietly running on
the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises ``RuntimeError`` when a CUDA device
    is asked for and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aread_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
