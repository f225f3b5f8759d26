"""Parameter initializers with PyTorch's default distributions (counterpart
of ``aread_tpu/ops/initializers.py``): ``nn.Linear`` weights and biases
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``nn.Embedding`` N(0, 1). Every draw
comes from the ``torch.Generator`` the caller passes."""

from __future__ import annotations

import math
from typing import Sequence

import torch


def uniform_fan_in(shape: Sequence[int], fan_in: int, generator: torch.Generator,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float32)
    return (u * (2 * bound) - bound).to(dtype)


def linear_kernel_init(shape: Sequence[int], generator: torch.Generator,
                       device=None) -> torch.Tensor:
    """A (..., fan_in, fan_out) kernel; the bound comes from the
    second-to-last axis, so stacked kernels draw per tower as torch
    would."""
    return uniform_fan_in(shape, shape[-2], generator, device)


def linear_bias_init_for(fan_in: int):
    """torch Linear's bias draw for a layer of ``fan_in`` inputs, as an
    initializer of any shape: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def init(shape: Sequence[int], generator: torch.Generator,
             device=None) -> torch.Tensor:
        return uniform_fan_in(shape, fan_in, generator, device)

    return init


def normal_init(std: float):
    """N(0, std^2)."""

    def init(shape: Sequence[int], generator: torch.Generator,
             device=None) -> torch.Tensor:
        return std * torch.randn(tuple(shape), generator=generator,
                                 device=device, dtype=torch.float32)

    return init


def xavier_normal_init(shape: Sequence[int], generator: torch.Generator,
                       device=None) -> torch.Tensor:
    """N(0, 2 / (fan_in + fan_out)) with the fans of the last two axes
    (``nn.init.xavier_normal_`` per stacked matrix)."""
    std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return std * torch.randn(tuple(shape), generator=generator, device=device,
                             dtype=torch.float32)


def zeros_init(shape: Sequence[int], generator: torch.Generator = None,
               device=None) -> torch.Tensor:
    """Zeros (flax's ``nn.initializers.zeros``: a ``nn.Dense`` bias when
    only its ``kernel_init`` is given)."""
    return torch.zeros(tuple(shape), device=device)


def xavier_uniform_init(shape: Sequence[int], generator: torch.Generator,
                        device=None) -> torch.Tensor:
    """flax's ``xavier_uniform``: U(-b, b), b = sqrt(6 / (fan_in +
    fan_out)), the fans of the last two axes each times the product of the
    leading axes (the receptive field)."""
    rf = math.prod(shape[:-2])
    bound = math.sqrt(6.0 / (shape[-2] * rf + shape[-1] * rf))
    u = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float32)
    return u * (2 * bound) - bound


def embedding_init(shape: Sequence[int], generator: torch.Generator,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1), drawn in f32 and stored in ``dtype``."""
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32).to(dtype)
