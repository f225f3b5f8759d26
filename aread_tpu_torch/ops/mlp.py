"""Dense stacks (counterpart of ``aread_tpu/ops/mlp.py``): Linear,
BatchNorm with torch semantics and row masking, dropout drawn from an
explicit generator, ``MLP`` / ``DNN``, PEPNet's ``GateNN``, and the
stacked-tower variants (one batched matmul for T parallel towers).

Kernels keep the JAX package's ``[in, out]`` layout (``[T, in, out]`` when
stacked), so converted weights are used as they are and ``x @ kernel``
is the same product.

Under a data-parallel mesh (``parallel.mesh.use``) each rank holds its
rows of the global batch, and the two layers that reduce over the batch
reduce over the global one, as the JAX package's GSPMD program does:
BatchNorm sums its masked count, sum and centred sum of squares over
'data' (the running statistics stay the same on every rank), and dropout
draws the global batch's mask from the rank's generator and keeps the
rank's rows — so a mesh run draws what one device draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from aread_tpu_torch.ops.initializers import (linear_bias_init_for,
                                              linear_kernel_init,
                                              uniform_fan_in)
from aread_tpu_torch.ops.precision import einsum, matmul
from aread_tpu_torch.parallel import mesh as mesh_lib


class Linear(nn.Module):
    """``x @ kernel + bias``. The draws default to torch's Linear; a
    ``kernel_init`` / ``bias_init`` (``ops/initializers.py``) replaces
    them as flax's ``nn.Dense`` arguments do."""

    def __init__(self, din: int, features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None,
                 kernel_init=linear_kernel_init, bias_init=None):
        super().__init__()
        bias_init = bias_init or linear_bias_init_for(din)
        self.kernel = nn.Parameter(kernel_init((din, features), generator,
                                               device))
        self.bias = (nn.Parameter(bias_init((features,), generator, device))
                     if use_bias else None)

    def forward(self, x):
        y = matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


def _masked_moments(x, mask):
    """Mean and biased variance over axis 0 counting only mask == 1 rows,
    and the count."""
    if mesh_lib.data_parallel() is not None:
        return _global_masked_moments(x, mask)
    if mask is None:
        mean = x.mean(dim=0)
        var = torch.square(x - mean[None]).mean(dim=0)
        return mean, var, torch.tensor(float(x.shape[0]), device=x.device)
    m = mask.to(x.dtype)
    count = torch.clamp(m.sum(), min=1.0)
    while m.dim() < x.dim():
        m = m[..., None]
    mean = (x * m).sum(dim=0) / count
    var = (torch.square(x - mean[None]) * m).sum(dim=0) / count
    return mean, var, count


def _global_masked_moments(x, mask):
    """``_masked_moments`` over the global batch of the active mesh: the
    count and the sum in one differentiable sum over 'data', then the
    centred sum of squares in another."""
    m = (torch.ones(x.shape[:1], dtype=x.dtype, device=x.device)
         if mask is None else mask.to(x.dtype))
    mb = m
    while mb.dim() < x.dim():
        mb = mb[..., None]
    head = torch.cat([(x * mb).sum(dim=0).reshape(-1), m.sum().reshape(1)])
    head = mesh_lib.data_sum(head)
    count = torch.clamp(head[-1].detach(), min=1.0)
    mean = head[:-1].reshape(x.shape[1:]) / count
    var = mesh_lib.data_sum((torch.square(x - mean[None]) * mb).sum(dim=0)) / count
    return mean, var, count


class BatchNorm(nn.Module):
    """BatchNorm1d with torch semantics and optional row masking, over
    [B, D] or [B, T, D] (statistics per trailing channel(s)):

    * normalizes with the biased batch variance; running statistics take
      the unbiased variance with momentum 0.1, eps 1e-5;
    * a (valid) batch of <= 1 row passes through unchanged and leaves the
      running statistics alone;
    * ``update_gate`` (broadcastable to the statistics) freezes the running
      statistics where it is 0 — the masked towers of a HEMP domain;
    * ``tied_affine``: over [B, T, D] one [D] scale and bias shared by the
      T towers, the statistics still [T, D] (PEPNet's tower-shared layer);
    * ``scale_mod`` / ``bias_mod``: the effective affine is
      ``scale * scale_mod`` and ``bias + bias_mod`` (STAR's partitioned
      normalization).
    """

    def __init__(self, stat_shape: Tuple[int, ...], tied_affine: bool = False,
                 momentum: float = 0.1, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        aff_shape = tuple(stat_shape[-1:]) if tied_affine else stat_shape
        self.scale = nn.Parameter(torch.ones(aff_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(aff_shape, device=device))
        self.register_buffer("mean", torch.zeros(stat_shape, device=device))
        self.register_buffer("var", torch.ones(stat_shape, device=device))

    def forward(self, x, train: bool, mask=None, update_gate=None,
                scale_mod=None, bias_mod=None):
        scale = self.scale if scale_mod is None else self.scale * scale_mod
        bias = self.bias if bias_mod is None else self.bias + bias_mod
        if not train:
            normed = (x - self.mean[None]) * torch.rsqrt(self.var[None] + self.eps)
            return normed * scale + bias
        mean, var, count = _masked_moments(x, mask)
        normed = (x - mean[None]) * torch.rsqrt(var[None] + self.eps)
        out = normed * scale + bias
        big_enough = count > 1.0
        out = torch.where(big_enough, out, x)
        with torch.no_grad():
            mean, var = mean.detach(), var.detach()
            unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
            new_mean = (1 - self.momentum) * self.mean + self.momentum * mean
            new_var = (1 - self.momentum) * self.var + self.momentum * unbiased
            do_update = big_enough
            if update_gate is not None:
                do_update = torch.logical_and(
                    big_enough, torch.broadcast_to(update_gate.to(torch.bool),
                                                   self.mean.shape))
            self.mean.copy_(torch.where(do_update, new_mean, self.mean))
            self.var.copy_(torch.where(do_update, new_var, self.var))
        return out


def dropout(x, rate: float, train: bool,
            generator: Optional[torch.Generator]):
    """Inverted dropout with the keep mask drawn from ``generator`` (under
    a data-parallel mesh: the global batch's mask, of which the rank keeps
    its rows)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mesh = mesh_lib.data_parallel()
    if mesh is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        n = x.shape[0] * mesh.data
        u = torch.rand((n,) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)[mesh.rows(n)]
    keep_mask = u < keep
    return torch.where(keep_mask, x / keep, torch.zeros((), device=x.device))


class MLP(nn.Module):
    """[Linear -> BatchNorm -> ReLU -> Dropout] per hidden dim, then an
    optional Linear(1) named ``out``."""

    def __init__(self, din: int, layer_dims: Tuple[int, ...],
                 dropout: float = 0.2, output_layer: bool = True,
                 use_bn: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.rate = dropout
        self.use_bn = use_bn
        self.n_layers = len(layer_dims)
        for i, dim in enumerate(layer_dims):
            self.add_module(f"linear_{i}", Linear(din, dim,
                                                  generator=generator,
                                                  device=device))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm((dim,), device=device))
            din = dim
        self.out = (Linear(din, 1, generator=generator, device=device)
                    if output_layer else None)

    def forward(self, x, train: bool = False, mask=None, generator=None):
        for i in range(self.n_layers):
            x = getattr(self, f"linear_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train=train, mask=mask)
            x = torch.relu(x)
            x = dropout(x, self.rate, train, generator)
        return x if self.out is None else self.out(x)


class DNN(MLP):
    """DeepCTR-style MLP: the same layers, no output projection, dropout
    off by default."""

    def __init__(self, din: int, hidden_units: Tuple[int, ...],
                 dropout: float = 0.0, use_bn: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(din, hidden_units, dropout, output_layer=False,
                         use_bn=use_bn, generator=generator, device=device)


class GateNN(nn.Module):
    """PEPNet's gate: ``fc1`` -> ReLU -> dropout -> ``fc2`` -> 2 *
    sigmoid."""

    def __init__(self, din: int, hidden_dim: int, output_dim: int,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.rate = dropout
        self.fc1 = Linear(din, hidden_dim, generator=generator, device=device)
        self.fc2 = Linear(hidden_dim, output_dim, generator=generator,
                          device=device)

    def forward(self, x, train: bool = False, generator=None):
        x = dropout(torch.relu(self.fc1(x)), self.rate, train, generator)
        return 2.0 * torch.sigmoid(self.fc2(x))


class StackedLinear(nn.Module):
    """T parallel Linear layers as one batched product: input [B, T, din]
    (or [B, din], broadcast to all T) -> [B, T, dout]; kernel [T, din,
    dout], bias [T, dout]."""

    def __init__(self, n_stack: int, din: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(linear_kernel_init(
            (n_stack, din, features), generator, device))
        self.bias = (nn.Parameter(uniform_fan_in((n_stack, features), din,
                                                 generator, device))
                     if use_bias else None)

    def forward(self, x):
        if x.dim() == 2:
            y = einsum("bd,tdf->btf", x, self.kernel)
        else:
            y = einsum("btd,tdf->btf", x, self.kernel)
        return y if self.bias is None else y + self.bias[None]


class StackedMLP(nn.Module):
    """T parallel [StackedLinear -> BatchNorm -> ReLU -> Dropout] towers
    with per-tower BatchNorm statistics, then an optional per-tower
    Linear(1) named ``out``."""

    def __init__(self, n_stack: int, din: int, layer_dims: Tuple[int, ...],
                 dropout: float = 0.2, output_layer: bool = False,
                 use_bn: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.rate = dropout
        self.use_bn = use_bn
        self.n_layers = len(layer_dims)
        for i, dim in enumerate(layer_dims):
            self.add_module(f"linear_{i}", StackedLinear(
                n_stack, din, dim, generator=generator, device=device))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm((n_stack, dim),
                                                     device=device))
            din = dim
        self.out = (StackedLinear(n_stack, din, 1, generator=generator,
                                  device=device) if output_layer else None)

    def forward(self, x, train: bool = False, mask=None, tower_gate=None,
                generator=None):
        # tower_gate: optional [T] gating BN running-stat updates per tower
        ug = tower_gate[:, None] if tower_gate is not None else None
        for i in range(self.n_layers):
            x = getattr(self, f"linear_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train=train, mask=mask,
                                             update_gate=ug)
            x = torch.relu(x)
            x = dropout(x, self.rate, train, generator)
        return x if self.out is None else self.out(x)
