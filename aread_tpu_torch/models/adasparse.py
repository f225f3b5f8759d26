"""AdaSparse (counterpart of ``aread_tpu/models/adasparse.py``): a deep
tower whose layers are pruned per sample by domain-conditioned pruner
nets, pi = beta * sigmoid(alpha * pruner([h, domain_embed])), set to 0
where |pi| <= epsilon; the domain embedding reaches the pruners without
gradient, as the JAX package stops it there.

Each layer's ``dnn_linear_{i}`` draws its kernel from N(0, 1e-4^2) and
starts its bias at zero (a flax ``nn.Dense`` given only a kernel init).
"""

from __future__ import annotations

from typing import Tuple

import torch

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.initializers import normal_init, zeros_init
from aread_tpu_torch.ops.mlp import BatchNorm, Linear, dropout


class AdaSparse(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^dnn_linear_\d+/kernel$", 1e-5),
        (r"^pruner_\d+/kernel$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int,
                 hidden_dims: Tuple[int, ...] = (256, 128, 64),
                 dropout: float = 0.2, alpha: float = 1.0, beta: float = 2.0,
                 epsilon: float = 0.25, use_dcn: bool = True,
                 use_atten: bool = True, n_cross_layers: int = 3,
                 atten_embed_dim: int = 64, att_layer_num: int = 3,
                 att_head_num: int = 2, att_res: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        self.rate = dropout
        self.alpha, self.beta, self.epsilon = alpha, beta, epsilon
        self.n_layers = len(hidden_dims)
        din = flat_dim = spec.embed_output_dim(embed_dim)
        for i, dim in enumerate(hidden_dims):
            self.add_module(f"dnn_linear_{i}", Linear(
                din, dim, kernel_init=normal_init(1e-4), bias_init=zeros_init,
                **kw))
            self.add_module(f"pruner_{i}", Linear(din + embed_dim, dim, **kw))
            self.add_module(f"bn_{i}", BatchNorm((dim,), device=dev))
            din = dim
        self.dnn_linear_out = Linear(din, 1, **kw)
        self.cn = self.cn_linear = self.atten = None
        if use_dcn:
            self.cn = CrossNetwork(flat_dim, n_cross_layers, **kw)
            self.cn_linear = Linear(flat_dim, 1, use_bias=False, **kw)
        if use_atten:
            self.atten = AttentionTower(
                spec.field_num, embed_dim, atten_embed_dim, att_layer_num,
                att_head_num, att_res, dropout, **kw)

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)
        domain_embed = embed_x[:, self.spec.domain_idx, :].detach()
        flat = embed_x.reshape(embed_x.shape[0], -1)
        h = flat
        for i in range(self.n_layers):
            fc = getattr(self, f"dnn_linear_{i}")(h)
            pi_in = torch.cat([h, domain_embed], dim=-1)
            pi = self.beta * torch.sigmoid(
                self.alpha * getattr(self, f"pruner_{i}")(pi_in))
            # a hard zero: no gradient reaches the pruner there
            pi = torch.where(torch.abs(pi) - self.epsilon <= 0, 0.0, pi)
            fc = getattr(self, f"bn_{i}")(fc * pi, train=train, mask=mask)
            h = dropout(torch.relu(fc), self.rate, train, generator)

        logit = self.dnn_linear_out(h) + self.linear(flat)
        if self.cn is not None:
            logit = logit + self.cn_linear(self.cn(flat))
        if self.atten is not None:
            logit = logit + self.atten(flat, train=train, generator=generator)
        logit = logit[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
