"""Factorization-machine-family interaction ops (counterpart of
``aread_tpu/ops/fm.py``):

  * ``FactorizationMachine``: 0.5 * (square of sum - sum of squares) over
    the field axis;
  * ``InnerProductNetwork``, ``OuterProductNetwork`` (kernel 'mat', 'vec'
    or 'num'), ``AttentionalFactorizationMachine``,
    ``CompressedInteractionNetwork`` (xDeepFM's CIN) and ``AnovaKernel``:
    the reference's layer library; no model uses them.

Every pairwise (i < j) enumeration uses ``np.triu_indices(F, k=1)``, so
the pairs come in the JAX package's order and converted kernels need no
permutation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from aread_tpu_torch.ops.initializers import (linear_kernel_init,
                                              xavier_uniform_init)
from aread_tpu_torch.ops.mlp import Linear, dropout
from aread_tpu_torch.ops.precision import einsum


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


def _pairs(num_fields: int, device):
    row, col = np.triu_indices(num_fields, k=1)
    return (torch.as_tensor(row, device=device),
            torch.as_tensor(col, device=device))


class InnerProductNetwork(nn.Module):
    def forward(self, x):
        """x: [B, F, E] -> [B, F(F-1)/2], the inner product of every pair."""
        row, col = _pairs(x.shape[1], x.device)
        return torch.sum(x[:, row] * x[:, col], dim=2)


class OuterProductNetwork(nn.Module):
    """Kernel 'mat': [E, num_ix, E], contracted through its (1, 0, 2)
    transpose as in the JAX package; 'vec': [num_ix, E]; 'num':
    [num_ix, 1]; flax's xavier_uniform draws.

    The JAX package's 'mat' contraction, ``einsum("bne,enf->bnf", p,
    transpose(kernel, (1, 0, 2)))``, labels the transpose's pair axis as
    the embedding axis: it is defined only where the pair count
    F(F-1)/2 equals E, and there it computes sum_e p[b,n,e] *
    kernel[n,e,f]. The port computes that function and refuses other
    shapes by name, where the JAX one fails in its einsum."""

    SHAPES = {"mat": lambda n, e: (e, n, e), "vec": lambda n, e: (n, e),
              "num": lambda n, e: (n, 1)}

    def __init__(self, num_fields: int, embed_dim: int,
                 kernel_type: str = "mat",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if kernel_type not in self.SHAPES:
            raise ValueError(f"unknown kernel type: {kernel_type}")
        self.kernel_type = kernel_type
        self.num_fields = num_fields
        num_ix = num_fields * (num_fields - 1) // 2
        if kernel_type == "mat" and num_ix != embed_dim:
            raise ValueError(
                f"kernel type 'mat' needs the pair count ({num_ix} for "
                f"{num_fields} fields) to equal the embedding width "
                f"({embed_dim}), as the JAX package's contraction does")
        self.kernel = nn.Parameter(xavier_uniform_init(
            self.SHAPES[kernel_type](num_ix, embed_dim), generator, device))

    def forward(self, x):
        """x: [B, F, E] -> [B, num_ix]."""
        row, col = _pairs(self.num_fields, x.device)
        p, q = x[:, row], x[:, col]  # [B, num_ix, E]
        if self.kernel_type == "mat":
            kp = einsum("bne,enf->bnf", p, self.kernel.permute(1, 0, 2))
            return torch.sum(kp * q, dim=-1)
        return torch.sum(p * q * self.kernel[None], dim=-1)


class AttentionalFactorizationMachine(nn.Module):
    """The pairs' element-wise products weighted by a softmax over the
    pairs of ``projection(relu(attention(.)))``, summed, then ``fc``."""

    def __init__(self, embed_dim: int, attn_size: int,
                 dropouts: Tuple[float, float] = (0.2, 0.2),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.rates = dropouts
        self.attention = Linear(embed_dim, attn_size, **kw)
        self.projection = Linear(attn_size, 1, **kw)
        self.fc = Linear(embed_dim, 1, **kw)

    def forward(self, x, train: bool = False, generator=None):
        """x: [B, F, E] -> [B, 1]."""
        row, col = _pairs(x.shape[1], x.device)
        inner = x[:, row] * x[:, col]  # [B, num_ix, E]
        attn = torch.relu(self.attention(inner))
        scores = torch.softmax(self.projection(attn), dim=1)
        scores = dropout(scores, self.rates[0], train, generator)
        out = torch.sum(scores * inner, dim=1)
        out = dropout(out, self.rates[1], train, generator)
        return self.fc(out)


class CompressedInteractionNetwork(nn.Module):
    """xDeepFM's CIN. Layer i maps the [B, F * H_i, E] outer products of
    x0 and h_i through ``conv_{i}`` [F * H_i, size_i] and ``conv_b_{i}``;
    with ``split_half`` every layer but the last keeps half its maps as
    output and passes the other half on as h_{i+1}."""

    def __init__(self, input_dim: int, cross_layer_sizes: Tuple[int, ...],
                 split_half: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.split_half = split_half
        self.n_layers = len(cross_layer_sizes)
        prev = input_dim
        for i, size in enumerate(cross_layer_sizes):
            self.register_parameter(f"conv_{i}", nn.Parameter(
                linear_kernel_init((input_dim * prev, size), generator,
                                   device)))
            self.register_parameter(f"conv_b_{i}", nn.Parameter(
                torch.zeros((size,), device=device)))
            prev = size // 2 if self._splits(i) else size

    def _splits(self, i: int) -> bool:
        return self.split_half and i != self.n_layers - 1

    def forward(self, x):
        """x: [B, F, E] -> [B, sum of the kept maps]."""
        B, _, E = x.shape
        xs, x0, h = [], x, x
        for i in range(self.n_layers):
            z = einsum("bfe,bge->bfge", x0, h).reshape(B, -1, E)
            out = torch.relu(einsum("bne,nc->bce", z,
                                    getattr(self, f"conv_{i}"))
                             + getattr(self, f"conv_b_{i}")[None, :, None])
            if self._splits(i):
                out, h = torch.chunk(out, 2, dim=1)
            else:
                h = out
            xs.append(out)
        return torch.sum(torch.cat(xs, dim=1), dim=2)


class AnovaKernel(nn.Module):
    """The ANOVA kernel of degree ``order`` over the fields, by the
    dynamic programme a_t[j] = sum_{k <= j} x[k-1] * a_{t-1}[k-1]
    (a shift and a cumulative sum per degree)."""

    def __init__(self, order: int, reduce_sum: bool = True):
        super().__init__()
        self.order = order
        self.reduce_sum = reduce_sum

    def forward(self, x):
        """x: [B, F, E] -> [B, 1] (``reduce_sum``) or [B, E]."""
        B, F, E = x.shape
        a_prev = torch.ones((B, F + 1, E), dtype=x.dtype, device=x.device)
        for t in range(self.order):
            head = torch.zeros((B, t + 1, E), dtype=x.dtype, device=x.device)
            a = torch.cat([head, x[:, t:, :] * a_prev[:, t:-1, :]], dim=1)
            a_prev = torch.cumsum(a, dim=1)
        if self.reduce_sum:
            return torch.sum(a_prev[:, -1, :], dim=-1, keepdim=True)
        return a_prev[:, -1, :]
