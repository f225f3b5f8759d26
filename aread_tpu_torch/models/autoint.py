"""AutoInt (counterpart of ``aread_tpu/models/autoint.py``): stacked
multi-head self-attention over the field embeddings with a value
residual, ReLU and flatten, concatenated with a deep MLP, then a bias-free
linear head plus the first-order logit."""

from __future__ import annotations

from typing import Tuple

import torch

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import MultiHeadSelfAttention
from aread_tpu_torch.ops.mlp import MLP, Linear


class AutoInt(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^dnn/.*/kernel$", 1e-5),
        # the MLP's BatchNorm scales are regularized too (see deepfm.py)
        (r"^dnn/bn_\d+/scale$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int,
                 atten_embed_dim: int = 64, att_layer_num: int = 3,
                 att_head_num: int = 2, att_res: bool = True,
                 mlp_dims: Tuple[int, ...] = (256, 128, 64),
                 dropout: float = 0.2, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        self.att_layer_num = att_layer_num
        self.atten_embedding = Linear(embed_dim, atten_embed_dim, **kw)
        for i in range(att_layer_num):
            self.add_module(f"attn_{i}", MultiHeadSelfAttention(
                atten_embed_dim, att_head_num, dropout, **kw))
        self.v_res = Linear(embed_dim, atten_embed_dim, **kw) if att_res else None
        flat_dim = spec.embed_output_dim(embed_dim)
        self.dnn = MLP(flat_dim, mlp_dims, dropout, output_layer=False, **kw)
        self.dnn_linear = Linear(spec.field_num * atten_embed_dim
                                 + mlp_dims[-1], 1, use_bias=False, **kw)

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)  # [B, F, E]
        B = embed_x.shape[0]
        cross = self.atten_embedding(embed_x)
        for i in range(self.att_layer_num):
            cross = getattr(self, f"attn_{i}")(cross, train=train,
                                               generator=generator)
        if self.v_res is not None:
            cross = cross + self.v_res(embed_x)
        cross = torch.relu(cross).reshape(B, -1)
        flat = embed_x.reshape(B, -1)
        dnn_out = self.dnn(flat, train=train, mask=mask, generator=generator)
        final = torch.cat([cross, dnn_out], dim=1)
        logit = (self.dnn_linear(final) + self.linear(flat))[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
