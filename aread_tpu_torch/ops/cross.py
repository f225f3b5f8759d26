"""Cross-interaction networks of the DCN family (counterpart of
``aread_tpu/ops/cross.py``):

  * ``CrossNetwork`` (DCN v1): x_{l+1} = x0 * (x_l . w_l) + b_l + x_l;
  * ``CrossNetV2`` (DCN v2, full matrix): x_{l+1} = x0 * (x_l W_l) + b_l
    + x_l;
  * ``CrossNetMix`` (DCN v2, mixture of low-rank experts): per layer and
    expert e, v = tanh(x V_e), v = tanh(v C_e), u = v U_e^T + b; the
    experts' x0 * u weighted by a softmax over the gates x . g_e and added
    to x. The experts are stacked ``[E, d, r]`` parameters, one batched
    product per projection, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aread_tpu_torch.ops.initializers import (linear_kernel_init,
                                              xavier_normal_init)


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


class CrossNetV2(nn.Module):
    def __init__(self, d: int, num_layers: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w_{i}", nn.Parameter(
                linear_kernel_init((d, d), generator, device)))
            self.register_parameter(f"b_{i}", nn.Parameter(
                torch.zeros((d,), device=device)))

    def forward(self, x):
        x0 = x
        for i in range(self.num_layers):
            x = x0 * (x @ getattr(self, f"w_{i}")) + getattr(self, f"b_{i}") + x
        return x


class CrossNetMix(nn.Module):
    def __init__(self, d: int, num_layers: int = 2, low_rank: int = 32,
                 num_experts: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.gate = nn.Parameter(linear_kernel_init((num_experts, d, 1),
                                                    generator, device))
        for i in range(num_layers):
            for name, shape in ((f"u_{i}", (num_experts, d, low_rank)),
                                (f"v_{i}", (num_experts, d, low_rank)),
                                (f"c_{i}", (num_experts, low_rank, low_rank))):
                self.register_parameter(name, nn.Parameter(
                    xavier_normal_init(shape, generator, device)))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.zeros((d,), device=device)))

    def forward(self, x):
        x0 = x
        for i in range(self.num_layers):
            gates = torch.einsum("bd,edo->beo", x, self.gate)[..., 0]  # [B, E]
            gates = torch.softmax(gates, dim=1)
            vx = torch.tanh(torch.einsum("bd,edr->ber", x,
                                         getattr(self, f"v_{i}")))
            vx = torch.tanh(torch.einsum("ber,ers->bes", vx,
                                         getattr(self, f"c_{i}")))
            uvx = (torch.einsum("bes,eds->bed", vx, getattr(self, f"u_{i}"))
                   + getattr(self, f"bias_{i}")[None, None, :])
            expert_out = x0[:, None, :] * uvx  # [B, E, d]
            x = x + torch.einsum("be,bed->bd", gates, expert_out)
        return x
