"""MMoE (counterpart of ``aread_tpu/models/mmoe.py``): n shared experts,
one softmax gate and one tower per group; optional DCN and self-attention
side logits added to every tower's output.

Experts, gates and towers are stacked batched products; every tower is
computed for every sample and the trainer gathers the sample's group
column. As in the JAX package, the cross network's output goes through a
bias-free Linear(1) before it is added to the tower logits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.mlp import Linear, StackedLinear, StackedMLP
from aread_tpu_torch.ops.precision import einsum


class MMoE(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^experts/.*/kernel$", 1e-5),
        (r"^towers/.*/kernel$", 1e-5),
        # BatchNorm scales are regularized too (see deepfm.py)
        (r"^(experts|towers)/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int, n_tower: int,
                 n_expert: int = 4,
                 expert_dims: Tuple[int, ...] = (256, 128, 64),
                 tower_dims: Tuple[int, ...] = (64, 32), dropout: float = 0.2,
                 use_dcn: bool = True, use_atten: bool = True,
                 n_cross_layers: int = 3, atten_embed_dim: int = 64,
                 att_layer_num: int = 3, att_head_num: int = 2,
                 att_res: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        self.n_tower = n_tower
        flat_dim = spec.embed_output_dim(embed_dim)
        self.experts = StackedMLP(n_expert, flat_dim, expert_dims, dropout, **kw)
        self.gates = StackedLinear(n_tower, flat_dim, n_expert, **kw)
        self.towers = StackedMLP(n_tower, expert_dims[-1], tower_dims, dropout,
                                 output_layer=True, **kw)
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
        flat = embed_x.reshape(embed_x.shape[0], -1)
        run = dict(train=train, mask=mask, generator=generator)

        expert_outs = self.experts(flat, **run)  # [B, n_expert, D]
        gates = torch.softmax(self.gates(flat), dim=-1)  # [B, T, n_expert]
        tower_inputs = einsum("bte,bed->btd", gates, expert_outs)
        tower_logits = self.towers(tower_inputs, **run)[..., 0]  # [B, T]

        side = self.linear(flat)  # [B, 1]
        if self.cn is not None:
            side = side + self.cn_linear(self.cn(flat))
        if self.atten is not None:
            side = side + self.atten(flat, train=train, generator=generator)
        logit = tower_logits + side
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
