"""PLE (counterpart of ``aread_tpu/models/ple.py``): levels of Customized
Gate Control — task-specific and shared experts, a softmax gate per task
over its own and the shared experts, and on every level but the last a
shared gate over all experts that feeds the next level's shared slot.

A level's inputs are one [B, n_task + 1, D] tensor, the trailing slot the
shared experts' input. The experts, gates and towers are stacked batched
products; the experts have no BatchNorm. Every tower is computed for every
sample and the trainer gathers the sample's group column.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.mlp import Linear, StackedLinear, StackedMLP
from aread_tpu_torch.ops.precision import einsum


class CGC(nn.Module):
    """One level: [B, n_task + 1, din] -> [B, n_task (+ 1), expert_dims[-1]]
    (the shared slot only when ``cur_level < n_level``)."""

    def __init__(self, din: int, cur_level: int, n_level: int, n_task: int,
                 n_expert_specific: int, n_expert_shared: int,
                 expert_dims: Tuple[int, ...], dropout: float = 0.2,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.n_task, self.n_spec, self.n_shared = (
            n_task, n_expert_specific, n_expert_shared)
        self.experts_specific = StackedMLP(
            n_task * n_expert_specific, din, expert_dims, dropout,
            use_bn=False, **kw)
        self.experts_shared = StackedMLP(n_expert_shared, din, expert_dims,
                                         dropout, use_bn=False, **kw)
        self.gates_specific = StackedLinear(
            n_task, din, n_expert_specific + n_expert_shared, **kw)
        self.gate_shared = (Linear(din, n_task * n_expert_specific
                                   + n_expert_shared, **kw)
                            if cur_level < n_level else None)

    def forward(self, x_list, train: bool = False, mask=None,
                generator=None):
        run = dict(train=train, mask=mask, generator=generator)
        B, _, din = x_list.shape
        n_task, n_spec, n_shared = self.n_task, self.n_spec, self.n_shared
        # each task's row repeated in place (t0, t0, t1, t1, ...)
        spec_in = torch.repeat_interleave(x_list[:, :n_task], n_spec, dim=1)
        spec_out = self.experts_specific(spec_in, **run)
        shared_in = x_list[:, -1:, :].expand(B, n_shared, din)
        shared_out = self.experts_shared(shared_in, **run)

        gates = torch.softmax(self.gates_specific(x_list[:, :n_task]), dim=-1)
        spec_by_task = spec_out.reshape(B, n_task, n_spec, -1)
        shared_rep = shared_out[:, None].expand(B, n_task, n_shared,
                                                shared_out.shape[-1])
        per_task_experts = torch.cat([spec_by_task, shared_rep], dim=2)
        task_outs = einsum("bte,bted->btd", gates, per_task_experts)
        if self.gate_shared is None:
            return task_outs
        all_experts = torch.cat([spec_out, shared_out], dim=1)
        shared_gate = torch.softmax(self.gate_shared(x_list[:, -1, :]), dim=-1)
        shared_next = einsum("be,bed->bd", shared_gate, all_experts)
        return torch.cat([task_outs, shared_next[:, None]], dim=1)


def add_cgc_levels(owner: nn.Module, din: int, n_task: int,
                   n_expert_specific: int, n_expert_shared: int,
                   expert_dims: Tuple[Tuple[int, ...], ...], dropout: float,
                   generator, device) -> int:
    """Adds ``cgc_0`` .. ``cgc_{n-1}`` to ``owner``; returns the last
    level's output width."""
    n_level = len(expert_dims)
    for i, dims in enumerate(expert_dims):
        owner.add_module(f"cgc_{i}", CGC(
            din, i + 1, n_level, n_task, n_expert_specific, n_expert_shared,
            dims, dropout, generator=generator, device=device))
        din = dims[-1]
    return din


def run_cgc_levels(owner: nn.Module, n_level: int, flat, n_task: int,
                   **run):
    """The CGC stack on ``flat`` broadcast to the n_task + 1 slots; the
    task slots of the last level [B, n_task, D]."""
    outs = flat[:, None, :].expand(flat.shape[0], n_task + 1, flat.shape[1])
    for i in range(n_level):
        outs = getattr(owner, f"cgc_{i}")(outs, **run)
    return outs[:, :n_task, :]


class PLE(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^cgc_\d+/.*kernel$", 1e-5),
        (r"^towers/.*/kernel$", 1e-5),
        # the towers' BatchNorm scales are regularized too (see deepfm.py);
        # the experts have no BatchNorm
        (r"^towers/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int, n_tower: int,
                 n_expert_specific: int = 2, n_expert_shared: int = 2,
                 expert_dims: Tuple[Tuple[int, ...], ...] = ((256, 128), (64,)),
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
        self.n_level = len(expert_dims)
        flat_dim = spec.embed_output_dim(embed_dim)
        dout = add_cgc_levels(self, flat_dim, n_tower, n_expert_specific,
                              n_expert_shared, expert_dims, dropout, gen, dev)
        self.towers = StackedMLP(n_tower, dout, tower_dims, dropout,
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
        task_in = run_cgc_levels(self, self.n_level, flat, self.n_tower, **run)
        tower_logits = self.towers(task_in, **run)[..., 0]  # [B, T]

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
