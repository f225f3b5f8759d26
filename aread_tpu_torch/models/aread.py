"""AREAD with an MMoE base (counterpart of ``aread_tpu/models/aread.py``).

  * base: MMoE, 4 stacked experts and one softmax gate per level-0 tower;
  * HEI: levels of towers n_tower = (g, 2g, 4g); a level's towers are one
    stacked product; levels >= 1 gate over the previous level's towers
    from [domain_embed || group_embed], masked by the domain's HEMP edges
    and renormalized;
  * leaves: a per-leaf linear over [cross-net out || tower out] plus the
    shared first-order logit.

Modes: 'wo_mask' (warm-up, all edges, mean over all leaves),
'domain_with_mask' (one domain's mask, mean over active leaves) and
'domain_mask_bagging' (the same, the trainer averages per-leaf losses).
Every mode returns leaf_logit, leaf_prob, leaf_active, gate_means, prob
and logit. The ``final_gate`` parameter exists, as the JAX package
initializes through 'domain_mask_final'; that mode, 'batch_with_mask' and
the PLE base are not ported yet and raise.

Submodule and parameter names are the JAX package's flax paths with '.'
for '/', so ``convert.py`` maps weights one to one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.initializers import embedding_init
from aread_tpu_torch.ops.mlp import Linear, StackedLinear, StackedMLP

MODES = ("wo_mask", "domain_with_mask", "domain_mask_bagging")


def full_mask(n_tower: Sequence[int]) -> Tuple[np.ndarray, ...]:
    """All-edges-active HEMP mask: [1,T0], [T0,T1], ..., [T_last,1]."""
    masks = [np.ones((1, n_tower[0]), bool)]
    for l in range(1, len(n_tower)):
        masks.append(np.ones((n_tower[l - 1], n_tower[l]), bool))
    masks.append(np.ones((n_tower[-1], 1), bool))
    return tuple(masks)


class AREAD(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^mmoe_experts/.*kernel$", 1e-5),
        (r"^cgc_\d+/.*kernel$", 1e-5),
        (r"^towers_\d+/.*kernel$", 1e-5),
        (r"^(mmoe_experts|towers_\d+)/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int,
                 n_tower: Tuple[int, ...], n_domain: int,
                 base_model: str = "mmoe",
                 expert_dims: Tuple[int, ...] = (256, 128, 64),
                 tower_dims: Tuple[Tuple[int, ...], ...] = ((64, 32), (32, 16), (16, 8)),
                 dropout: float = 0.2, use_dcn: bool = True,
                 n_cross_layers: int = 3, mmoe_n_expert: int = 4,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if base_model != "mmoe":
            raise NotImplementedError(
                f"base_model={base_model!r} is not ported yet (mmoe only)")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.n_tower = tuple(int(t) for t in n_tower)
        self.n_domain = n_domain
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        flat_dim = spec.embed_output_dim(embed_dim)
        self.cn = CrossNetwork(flat_dim, n_cross_layers, **kw) if use_dcn else None
        self.mmoe_experts = StackedMLP(mmoe_n_expert, flat_dim, expert_dims,
                                       dropout, **kw)
        self.mmoe_gates = StackedLinear(self.n_tower[0], flat_dim,
                                        mmoe_n_expert, **kw)
        self.group_embedding = nn.Parameter(embedding_init(
            (self.n_tower[0], embed_dim), gen, dev))
        din = expert_dims[-1]
        for l, T in enumerate(self.n_tower):
            if l > 0:
                self.add_module(f"tower_gates_{l}", StackedLinear(
                    T, 2 * embed_dim, self.n_tower[l - 1], **kw))
            self.add_module(f"towers_{l}", StackedMLP(T, din, tower_dims[l],
                                                      dropout, **kw))
            din = tower_dims[l][-1]
        leaf_din = din + (flat_dim if use_dcn else 0)
        self.towers_linear = StackedLinear(self.n_tower[-1], leaf_din, 1,
                                           use_bias=False, **kw)
        self.final_gate = Linear(2 * embed_dim, self.n_tower[-1],
                                 use_bias=False, **kw)

    @property
    def n_level(self) -> int:
        return len(self.n_tower)

    def forward(self, x, domain_mask=None, mode: str = "wo_mask",
                train: bool = False, mask=None, generator=None,
                tap: bool = False):
        """``domain_mask``: n_level+1 boolean arrays shaped as
        ``full_mask``, required by the masked modes. ``mask``: [B] row
        validity for BatchNorm. ``generator``: dropout's. ``tap``: make
        the gathered rows a grad leaf, returned as ``out['rows']``."""
        if mode not in MODES:
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        dev = self.device
        f32 = torch.float32
        embed_x, rows = self.embedding(x, tap=tap)
        B = embed_x.shape[0]
        domain_embed = embed_x[:, self.spec.domain_idx, :]
        flat = embed_x.reshape(B, -1)
        linear_out = self.linear(flat)  # [B, 1]
        cn_out = self.cn(flat) if self.cn is not None else None
        run = dict(train=train, mask=mask, generator=generator)

        expert_outs = self.mmoe_experts(flat, **run)  # [B, E, D]
        gates0 = torch.softmax(self.mmoe_gates(flat), dim=-1)  # [B, T0, E]
        tower_inputs = torch.einsum("bte,bed->btd", gates0, expert_outs)

        if mode == "wo_mask":
            group_embed = torch.zeros_like(domain_embed)
            dm = [torch.as_tensor(m, device=dev) for m in full_mask(self.n_tower)]
        else:
            if domain_mask is None:
                raise ValueError("masked modes need a domain_mask")
            dm = [torch.as_tensor(np.asarray(m), device=dev) for m in domain_mask]
            m0 = dm[0][0].to(f32)
            ge = (m0 / torch.clamp(m0.sum(), min=1e-8)) @ self.group_embedding
            group_embed = ge[None, :].expand_as(domain_embed)
        gate_inputs = torch.cat([domain_embed, group_embed], dim=1)

        active = [dm[0][0]]
        for l in range(1, self.n_level):
            active.append(dm[l].any(dim=0))
        leaf_active = dm[self.n_level][:, 0]

        gate_means = []
        outs = None
        for l in range(self.n_level):
            actb = active[l].to(f32)[None, :, None]
            if l == 0:
                level_in = tower_inputs * actb
            else:
                gl = getattr(self, f"tower_gates_{l}")(gate_inputs)
                gate_out = torch.softmax(gl, dim=-1)  # [B, T_l, T_{l-1}]
                masked = gate_out * dm[l].T.to(f32)[None]
                renorm = masked / (masked.sum(dim=-1, keepdim=True) + 1e-8)
                level_in = torch.einsum("btp,bpd->btd", renorm, outs)
                gate_means.append(masked.mean(dim=0).detach().T)
            body = getattr(self, f"towers_{l}")(level_in, tower_gate=active[l],
                                                **run)
            outs = body * actb

        if cn_out is not None:
            leaf_in = torch.cat(
                [cn_out[:, None, :].expand(B, self.n_tower[-1], cn_out.shape[1]),
                 outs], dim=-1)
        else:
            leaf_in = outs
        leaf_logit = self.towers_linear(leaf_in)[..., 0] + linear_out
        leaf_prob = torch.sigmoid(leaf_logit)
        out = {"leaf_logit": leaf_logit, "leaf_prob": leaf_prob,
               "leaf_active": leaf_active, "gate_means": tuple(gate_means)}
        la = leaf_active.to(f32)
        if mode == "wo_mask":
            out["prob"] = leaf_prob.mean(dim=1)
        else:
            out["prob"] = (leaf_prob * la[None]).sum(dim=1) / torch.clamp(
                la.sum(), min=1e-8)
        p = torch.clamp(out["prob"], 1e-7, 1 - 1e-7)
        out["logit"] = torch.log(p) - torch.log1p(-p)
        if tap:
            out["rows"] = rows
        return out
