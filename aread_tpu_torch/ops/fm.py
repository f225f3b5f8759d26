"""Factorization-machine interaction (counterpart of
``aread_tpu/ops/fm.py`` ``FactorizationMachine``): 0.5 * (square of sum -
sum of squares) over the field axis. The other FM-family ops of the JAX
package are not ported yet."""

from __future__ import annotations

import torch
from torch import nn


class FactorizationMachine(nn.Module):
    def __init__(self, reduce_sum: bool = True):
        super().__init__()
        self.reduce_sum = reduce_sum

    def forward(self, x):
        """x: [B, F, E] -> [B, 1] (``reduce_sum``) or [B, E]."""
        square_of_sum = torch.square(x.sum(dim=1))
        sum_of_square = torch.square(x).sum(dim=1)
        ix = square_of_sum - sum_of_square
        if self.reduce_sum:
            ix = ix.sum(dim=1, keepdim=True)
        return 0.5 * ix
