"""DCN v1 cross layers (counterpart of ``aread_tpu/ops/cross.py``
``CrossNetwork``): x_{l+1} = x0 * (x_l . w_l) + b_l + x_l."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aread_tpu_torch.ops.initializers import linear_kernel_init


class CrossNetwork(nn.Module):
    def __init__(self, d: int, num_layers: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w_{i}", nn.Parameter(
                linear_kernel_init((d, 1), generator, device)))
            self.register_parameter(f"b_{i}", nn.Parameter(
                torch.zeros((d,), device=device)))

    def forward(self, x):
        x0 = x
        for i in range(self.num_layers):
            xw = x @ getattr(self, f"w_{i}")  # [B, 1]
            x = x0 * xw + getattr(self, f"b_{i}") + x
        return x
