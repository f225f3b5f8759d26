"""MAMDR's base network (counterpart of ``aread_tpu/models/mamdr.py``):
the linear term plus an MLP head over the flattened embedding. The
Reptile meta-training around it is ``train/mamdr.py``."""

from __future__ import annotations

from typing import Tuple

import torch

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.mlp import MLP


class MAMDR(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^mlp/.*/kernel$", 1e-5),
        # the MLP's BatchNorm scales too (see deepfm.py)
        (r"^mlp/bn_\d+/scale$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int,
                 mlp_dims: Tuple[int, ...] = (256, 128), dropout: float = 0.2,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self._backbone(spec, embed_dim, gen, dev)
        self.mlp = MLP(spec.embed_output_dim(embed_dim), mlp_dims, dropout,
                       output_layer=True, generator=gen, device=dev)

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)
        flat = embed_x.reshape(embed_x.shape[0], -1)
        logit = (self.linear(flat)
                 + self.mlp(flat, train=train, mask=mask,
                            generator=generator))[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
