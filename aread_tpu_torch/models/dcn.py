"""DCN (counterpart of ``aread_tpu/models/dcn.py``): CrossNetwork beside
an MLP, concatenated, then a linear head."""

from __future__ import annotations

from typing import Tuple

import torch

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.mlp import MLP, Linear


class DCN(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^mlp/.*/kernel$", 1e-5),
        # the MLP's BatchNorm scales are regularized too (see deepfm.py)
        (r"^mlp/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int,
                 n_cross_layers: int = 3,
                 mlp_dims: Tuple[int, ...] = (256, 128, 64),
                 dropout: float = 0.2, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self._backbone(spec, embed_dim, gen, dev)
        flat_dim = spec.embed_output_dim(embed_dim)
        self.cn = CrossNetwork(flat_dim, n_cross_layers, generator=gen,
                               device=dev)
        self.mlp = MLP(flat_dim, mlp_dims, dropout, output_layer=False,
                       generator=gen, device=dev)
        self.mlp_linear = Linear(flat_dim + mlp_dims[-1], 1, use_bias=False,
                                 generator=gen, device=dev)

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)
        flat = embed_x.reshape(embed_x.shape[0], -1)
        cn_out = self.cn(flat)
        mlp_out = self.mlp(flat, train=train, mask=mask, generator=generator)
        stack = torch.cat([cn_out, mlp_out], dim=1)
        logit = (self.linear(flat) + self.mlp_linear(stack))[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
