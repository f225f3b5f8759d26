"""AREAD (counterpart of ``aread_tpu/models/aread.py``).

  * base: MMoE (4 stacked experts and one softmax gate per level-0 tower)
    or PLE (the CGC levels ``cgc_{i}`` with one task per level-0 tower);
  * HEI: levels of towers n_tower = (g, 2g, 4g); a level's towers are one
    stacked product; levels >= 1 gate over the previous level's towers
    from [domain_embed || group_embed], masked by the domain's HEMP edges
    and renormalized;
  * leaves: a per-leaf linear over [cross-net out || tower out] plus the
    shared first-order logit.

Modes: 'wo_mask' (warm-up, all edges, mean over all leaves),
'domain_with_mask' (one domain's mask, mean over active leaves),
'domain_mask_bagging' (the same, the trainer averages per-leaf losses),
'domain_mask_final' (the body detached, a trainable softmax gate over the
active leaves: only ``final_gate`` gets a gradient) and 'batch_with_mask'
(evaluation only: every mask array carries a leading [B] axis, so a
mixed-domain batch runs in one forward). Every mode returns leaf_logit,
leaf_prob, leaf_active, gate_means, prob and logit.

Submodule and parameter names are the JAX package's flax paths with '.'
for '/', so ``convert.py`` maps weights one to one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.models.ple import add_cgc_levels, run_cgc_levels
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.initializers import embedding_init
from aread_tpu_torch.ops.mlp import Linear, StackedLinear, StackedMLP
from aread_tpu_torch.ops.precision import einsum, matmul
from aread_tpu_torch.parallel.mesh import batch_mean

MODES = ("wo_mask", "domain_with_mask", "domain_mask_bagging",
         "domain_mask_final", "batch_with_mask")


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
                 ple_n_expert_specific: int = 2, ple_n_expert_shared: int = 2,
                 ple_expert_dims: Tuple[Tuple[int, ...], ...] = ((256, 128), (64,)),
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if base_model not in ("mmoe", "ple"):
            raise ValueError(f"unknown base_model {base_model!r}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.n_tower = tuple(int(t) for t in n_tower)
        self.n_domain = n_domain
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        flat_dim = spec.embed_output_dim(embed_dim)
        self.cn = CrossNetwork(flat_dim, n_cross_layers, **kw) if use_dcn else None
        self.base_model = base_model
        if base_model == "mmoe":
            self.mmoe_experts = StackedMLP(mmoe_n_expert, flat_dim,
                                           expert_dims, dropout, **kw)
            self.mmoe_gates = StackedLinear(self.n_tower[0], flat_dim,
                                            mmoe_n_expert, **kw)
            din = expert_dims[-1]
        else:
            self.n_level_ple = len(ple_expert_dims)
            din = add_cgc_levels(self, flat_dim, self.n_tower[0],
                                 ple_n_expert_specific, ple_n_expert_shared,
                                 ple_expert_dims, dropout, gen, dev)
        self.group_embedding = nn.Parameter(embedding_init(
            (self.n_tower[0], embed_dim), gen, dev))
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

    def full_mask_on(self, dev) -> List[torch.Tensor]:
        """``full_mask`` as tensors on ``dev``, made once: a copy from the
        host per forward would make the host wait for the device, and a
        captured CUDA graph cannot hold one."""
        key, cached = getattr(self, "_full_mask", (None, None))
        if key != str(dev):
            cached = [torch.as_tensor(m, device=dev)
                      for m in full_mask(self.n_tower)]
            self._full_mask = (str(dev), cached)
        return cached

    def forward(self, x, domain_mask=None, mode: str = "wo_mask",
                train: bool = False, mask=None, generator=None,
                tap: bool = False, group=None):
        """``domain_mask``: n_level+1 boolean arrays (numpy or tensors)
        shaped as ``full_mask``, required by the masked modes; with a
        leading [B] axis each in 'batch_with_mask'. ``mask``: [B] row
        validity for BatchNorm. ``generator``: dropout's. ``tap``: make
        the gathered rows a grad leaf, returned as ``out['rows']``.
        ``group`` is accepted and unused, so that the generic Trainer can
        drive the model in 'wo_mask' mode ('aread_womask')."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        per_ex = mode == "batch_with_mask"
        final = mode == "domain_mask_final"
        if per_ex and train:
            # the per-tower gating of the BatchNorm statistics is undefined
            # per example: ungated updates would fold mask-zeroed rows in
            raise ValueError("batch_with_mask is eval-only (train=True)")
        dev = self.device
        f32 = torch.float32
        embed_x, rows = self.embedding(x, tap=tap)
        B = embed_x.shape[0]
        domain_embed = embed_x[:, self.spec.domain_idx, :]
        flat = embed_x.reshape(B, -1)
        linear_out = self.linear(flat)  # [B, 1]
        cn_out = self.cn(flat) if self.cn is not None else None
        run = dict(train=train, mask=mask, generator=generator)

        if self.base_model == "mmoe":
            expert_outs = self.mmoe_experts(flat, **run)  # [B, E, D]
            gates0 = torch.softmax(self.mmoe_gates(flat), dim=-1)  # [B, T0, E]
            tower_inputs = einsum("bte,bed->btd", gates0, expert_outs)
        else:
            tower_inputs = run_cgc_levels(self, self.n_level_ple, flat,
                                          self.n_tower[0], **run)

        if mode == "wo_mask":
            group_embed = torch.zeros_like(domain_embed)
            dm = self.full_mask_on(dev)
        else:
            if domain_mask is None:
                raise ValueError("masked modes need a domain_mask")
            dm = [m.to(dev) if torch.is_tensor(m)
                  else torch.as_tensor(np.asarray(m), device=dev)
                  for m in domain_mask]
            if per_ex:
                m0 = dm[0][:, 0, :].to(f32)  # [B, T0]
                group_embed = matmul(
                    m0 / torch.clamp(m0.sum(dim=1, keepdim=True), min=1e-8),
                    self.group_embedding)
            else:
                m0 = dm[0][0].to(f32)
                ge = matmul(m0 / torch.clamp(m0.sum(), min=1e-8),
                            self.group_embedding)
                group_embed = ge[None, :].expand_as(domain_embed)
        gate_inputs = torch.cat([domain_embed, group_embed], dim=1)
        # the body is frozen while the final gate trains
        gate_inputs_body = gate_inputs.detach() if final else gate_inputs

        if per_ex:
            active = [dm[0][:, 0, :]]  # [B, T0]
            for l in range(1, self.n_level):
                active.append(dm[l].any(dim=1))  # [B, T_l]
            leaf_active = dm[self.n_level][:, :, 0]  # [B, T_last]
        else:
            active = [dm[0][0]]
            for l in range(1, self.n_level):
                active.append(dm[l].any(dim=0))
            leaf_active = dm[self.n_level][:, 0]

        gate_means = []
        outs = None
        for l in range(self.n_level):
            act = active[l].to(f32)
            actb = act[:, :, None] if per_ex else act[None, :, None]
            if l == 0:
                level_in = tower_inputs * actb
            else:
                gl = getattr(self, f"tower_gates_{l}")(gate_inputs_body)
                gate_out = torch.softmax(gl, dim=-1)  # [B, T_l, T_{l-1}]
                if per_ex:
                    masked = gate_out * dm[l].transpose(1, 2).to(f32)
                else:
                    masked = gate_out * dm[l].T.to(f32)[None]
                renorm = masked / (masked.sum(dim=-1, keepdim=True) + 1e-8)
                level_in = einsum("btp,bpd->btd", renorm, outs)
                # over the global batch on a mesh
                gate_means.append(batch_mean(masked.detach()).T)
            # per example the statistics' gate is undefined and unused
            # (evaluation only)
            body = getattr(self, f"towers_{l}")(
                level_in, tower_gate=None if per_ex else active[l], **run)
            if final:
                body = body.detach()
            outs = body * actb

        if cn_out is not None:
            leaf_in = torch.cat(
                [cn_out[:, None, :].expand(B, self.n_tower[-1], cn_out.shape[1]),
                 outs], dim=-1)
        else:
            leaf_in = outs
        if final:
            leaf_in, linear_out = leaf_in.detach(), linear_out.detach()
        leaf_logit = self.towers_linear(leaf_in)[..., 0] + linear_out
        leaf_prob = torch.sigmoid(leaf_logit)
        out = {"leaf_logit": leaf_logit, "leaf_prob": leaf_prob,
               "leaf_active": leaf_active, "gate_means": tuple(gate_means)}
        la = leaf_active.to(f32)
        if mode == "wo_mask":
            out["prob"] = leaf_prob.mean(dim=1)
        elif per_ex:  # la: [B, T_last]
            out["prob"] = (leaf_prob * la).sum(dim=1) / torch.clamp(
                la.sum(dim=1), min=1e-8)
        elif final:
            fg = torch.softmax(self.final_gate(gate_inputs.detach()), dim=1)
            fg = fg * la[None]
            fg = fg / (fg.sum(dim=1, keepdim=True) + 1e-8)
            # the whole leaf stack is frozen, towers_linear included
            out["prob"] = (leaf_prob.detach() * fg).sum(dim=1)
        else:
            out["prob"] = (leaf_prob * la[None]).sum(dim=1) / torch.clamp(
                la.sum(), min=1e-8)
        p = torch.clamp(out["prob"], 1e-7, 1 - 1e-7)
        out["logit"] = torch.log(p) - torch.log1p(-p)
        if tap:
            out["rows"] = rows
        return out
