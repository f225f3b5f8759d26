"""STAR (counterpart of ``aread_tpu/models/star.py``): the star topology.
Each group's FC kernel is the element-wise product of its domain kernel
and the shared kernel, its bias the sum of both; the partitioned
normalization is a per-group BatchNorm whose scale is multiplied by a
shared scale and whose bias is added to a shared bias. Every group's tower
is computed for every sample and the trainer gathers the sample's group
column. STAR has no cross-network side net.

The parameters sit at the model's top level under the JAX package's names
(``domain_dnns_kernel_{i}``, ``shared_dnn_bias_{i}``, ``shared_bn_weight``,
...); the effective kernel ``dk * sk`` is formed in the forward, so both
factors get their gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.initializers import linear_kernel_init, uniform_fan_in
from aread_tpu_torch.ops.mlp import BatchNorm, dropout
from aread_tpu_torch.ops.precision import einsum


class STAR(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^domain_dnns_kernel_\d+$", 1e-5),
        (r"^shared_dnn_kernel_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int, n_tower: int,
                 tower_dims: Tuple[int, ...] = (256, 128, 64, 32),
                 dropout: float = 0.2, use_atten: bool = True,
                 atten_embed_dim: int = 64, att_layer_num: int = 3,
                 att_head_num: int = 2, att_res: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self._backbone(spec, embed_dim, gen, dev)
        self.n_tower, self.rate = n_tower, dropout
        self.n_layers = len(tower_dims)
        T, D = n_tower, spec.embed_output_dim(embed_dim)
        self.atten = (AttentionTower(spec.field_num, embed_dim,
                                     atten_embed_dim, att_layer_num,
                                     att_head_num, att_res, dropout,
                                     generator=gen, device=dev)
                      if use_atten else None)
        self.shared_bn_weight = nn.Parameter(torch.ones((D,), device=dev))
        self.shared_bn_bias = nn.Parameter(torch.zeros((D,), device=dev))
        self.domain_norm = BatchNorm((T, D), device=dev)

        def param(name, value):
            self.register_parameter(name, nn.Parameter(value))

        dims = (D,) + tuple(tower_dims)
        for i in range(self.n_layers):
            d, f = dims[i], dims[i + 1]
            param(f"domain_dnns_kernel_{i}", linear_kernel_init((T, d, f), gen, dev))
            param(f"domain_dnns_bias_{i}", uniform_fan_in((T, f), d, gen, dev))
            param(f"shared_dnn_kernel_{i}", linear_kernel_init((d, f), gen, dev))
            param(f"shared_dnn_bias_{i}", uniform_fan_in((f,), d, gen, dev))
            self.add_module(f"domain_dnns_bn_{i}", BatchNorm((T, f), device=dev))
        d = dims[-1]
        param("domain_dnn_linears_kernel", linear_kernel_init((T, d, 1), gen, dev))
        param("domain_dnn_linears_bias", uniform_fan_in((T, 1), d, gen, dev))
        param("shared_dnn_linear_kernel", linear_kernel_init((d, 1), gen, dev))
        param("shared_dnn_linear_bias", uniform_fan_in((1,), d, gen, dev))

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)
        flat = embed_x.reshape(embed_x.shape[0], -1)
        B, D = flat.shape
        side = self.linear(flat)  # [B, 1]
        if self.atten is not None:
            side = side + self.atten(flat, train=train, generator=generator)

        h = flat[:, None, :].expand(B, self.n_tower, D)
        h = self.domain_norm(h, train=train, mask=mask,
                             scale_mod=self.shared_bn_weight[None, :],
                             bias_mod=self.shared_bn_bias[None, :])
        for i in range(self.n_layers):
            dk = getattr(self, f"domain_dnns_kernel_{i}")
            sk = getattr(self, f"shared_dnn_kernel_{i}")
            db = getattr(self, f"domain_dnns_bias_{i}")
            sb = getattr(self, f"shared_dnn_bias_{i}")
            h = einsum("btd,tdf->btf", h, dk * sk[None]) + (db + sb[None])[None]
            h = getattr(self, f"domain_dnns_bn_{i}")(h, train=train, mask=mask)
            h = dropout(torch.relu(h), self.rate, train, generator)
        eff_k = self.domain_dnn_linears_kernel * self.shared_dnn_linear_kernel[None]
        eff_b = self.domain_dnn_linears_bias + self.shared_dnn_linear_bias[None]
        logit = einsum("btd,tdf->btf", h, eff_k)[..., 0] + eff_b[None, :, 0]
        logit = logit + side
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
