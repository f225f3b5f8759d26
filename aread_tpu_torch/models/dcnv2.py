"""DCNv2 (counterpart of ``aread_tpu/models/dcnv2.py``): a mixture of
low-rank cross experts (``CrossNetMix``) or the full-matrix ``CrossNetV2``,
with the MLP beside it (``parallel``), after it (``stacked``) or absent
(``crossnet_only``), then a bias-free linear head plus the first-order
logit."""

from __future__ import annotations

from typing import Tuple

import torch

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.cross import CrossNetMix, CrossNetV2
from aread_tpu_torch.ops.mlp import MLP, Linear

STRUCTURES = ("crossnet_only", "stacked", "parallel")


class DCNv2(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^dnn/.*/kernel$", 1e-5),
        # the MLP's BatchNorm scales are regularized too (see deepfm.py)
        (r"^dnn/bn_\d+/scale$", 1e-5),
        (r"^dnn_linear/kernel$", 1e-5),
        (r"^crossnet/(u|v|c)_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int,
                 n_cross_layers: int = 3,
                 mlp_dims: Tuple[int, ...] = (256, 128, 64),
                 dropout: float = 0.2, model_structure: str = "parallel",
                 use_low_rank_mixture: bool = True, low_rank: int = 32,
                 num_experts: int = 4, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        if model_structure not in STRUCTURES:
            raise ValueError(f"model_structure {model_structure!r} not in "
                             f"{STRUCTURES}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        self.model_structure = model_structure
        flat_dim = spec.embed_output_dim(embed_dim)
        self.crossnet = (
            CrossNetMix(flat_dim, n_cross_layers, low_rank, num_experts, **kw)
            if use_low_rank_mixture else
            CrossNetV2(flat_dim, n_cross_layers, **kw))
        self.dnn = None
        final_dim = flat_dim
        if model_structure == "stacked":
            self.dnn = MLP(flat_dim, mlp_dims, dropout, output_layer=False, **kw)
            final_dim = mlp_dims[-1]
        elif model_structure == "parallel":
            self.dnn = MLP(flat_dim, mlp_dims, dropout, output_layer=False, **kw)
            final_dim = flat_dim + mlp_dims[-1]
        self.dnn_linear = Linear(final_dim, 1, use_bias=False, **kw)

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)
        flat = embed_x.reshape(embed_x.shape[0], -1)
        run = dict(train=train, mask=mask, generator=generator)
        cross = self.crossnet(flat)
        if self.model_structure == "crossnet_only":
            final = cross
        elif self.model_structure == "stacked":
            final = self.dnn(cross, **run)
        else:
            final = torch.cat([cross, self.dnn(flat, **run)], dim=1)
        logit = (self.dnn_linear(final) + self.linear(flat))[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
