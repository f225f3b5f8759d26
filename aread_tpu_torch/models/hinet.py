"""HiNet (counterpart of ``aread_tpu/models/hinet.py``): per-scenario SEI
(sub-expert integration) blocks, a shared SEI and SAN attention over the
scenario outputs gated by the domain embedding; the sample's own
scenario output is selected by its group id.

The T scenario SEIs of ``n_expert`` experts each run as one stacked
``[T * n_expert]`` MLP named ``experts`` with a stacked softmax gate
``gate``, as in the JAX package; the group select is a ``gather`` on the
scenario axis. The model returns one logit per sample ([B]) and needs
``group``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.mlp import MLP, Linear, StackedLinear, StackedMLP
from aread_tpu_torch.ops.precision import einsum


class SEIStack(nn.Module):
    """``n_stack`` parallel SEI blocks, each ``n_expert`` MLP experts mixed
    by a softmax gate: [B, din] -> [B, n_stack, hidden_dims[-1]]."""

    def __init__(self, n_stack: int, din: int, hidden_dims: Tuple[int, ...],
                 n_expert: int = 4, dropout: float = 0.2, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.n_stack, self.n_expert = n_stack, n_expert
        self.experts = StackedMLP(n_stack * n_expert, din, hidden_dims,
                                  dropout, **kw)
        self.gate = StackedLinear(n_stack, din, n_expert, **kw)

    def forward(self, x, train: bool = False, mask=None, generator=None):
        outs = self.experts(x, train=train, mask=mask, generator=generator)
        outs = outs.reshape(x.shape[0], self.n_stack, self.n_expert, -1)
        gates = torch.softmax(self.gate(x), dim=-1)  # [B, T, E]
        return einsum("bte,bted->btd", gates, outs)


class HiNet(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^specific_seis/.*kernel$", 1e-5),
        (r"^shared_sei/.*kernel$", 1e-5),
        (r"^san_gate/kernel$", 1e-5),
        (r"^tower/.*/kernel$", 1e-5),
        # the SEI experts' and the tower's BatchNorm scales too (see
        # deepfm.py)
        (r"^(specific_seis|shared_sei)/experts/bn_\d+/scale$", 1e-5),
        (r"^tower/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int, n_tower: int,
                 sei_dims: Tuple[int, ...] = (64, 32),
                 tower_dims: Tuple[int, ...] = (256, 128, 64, 32),
                 dropout: float = 0.2, use_dcn: bool = True,
                 use_atten: bool = True, n_cross_layers: int = 3,
                 atten_embed_dim: int = 64, att_layer_num: int = 3,
                 att_head_num: int = 2, att_res: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        self.n_tower = n_tower
        flat_dim = spec.embed_output_dim(embed_dim)
        self.specific_seis = SEIStack(n_tower, flat_dim, sei_dims,
                                      dropout=dropout, **kw)
        self.shared_sei = SEIStack(1, flat_dim, sei_dims, dropout=dropout,
                                   **kw)
        self.san_gate = Linear(embed_dim, n_tower, **kw)
        self.tower = MLP(3 * sei_dims[-1], tower_dims, dropout,
                         output_layer=False, **kw)
        self.tower_linear = Linear(tower_dims[-1], 1, use_bias=False, **kw)
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
        if group is None:
            raise ValueError("HiNet requires the group (scenario) id")
        embed_x, rows = self.embedding(x, tap=tap)
        domain_embed = embed_x[:, self.spec.domain_idx, :]
        flat = embed_x.reshape(embed_x.shape[0], -1)
        run = dict(train=train, mask=mask, generator=generator)

        specific = self.specific_seis(flat, **run)  # [B, T, D]
        shared = self.shared_sei(flat, **run)[:, 0]  # [B, D]
        san_gate = torch.softmax(self.san_gate(domain_embed), dim=-1)
        san_feas = einsum("bt,btd->bd", san_gate, specific)
        idx = group.to(torch.int64)[:, None, None].expand(
            -1, 1, specific.shape[-1])
        con_feas = torch.gather(specific, 1, idx)[:, 0]

        feature = torch.cat([shared, con_feas, san_feas], dim=1)
        logit = self.tower_linear(self.tower(feature, **run))
        logit = logit + self.linear(flat)
        if self.cn is not None:
            logit = logit + self.cn_linear(self.cn(flat))
        if self.atten is not None:
            logit = logit + self.atten(flat, train=train, generator=generator)
        logit = logit[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
