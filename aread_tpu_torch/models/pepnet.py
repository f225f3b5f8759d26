"""PEPNet / EPNet / EPNet-single (counterpart of
``aread_tpu/models/pepnet.py``).

  * EPNet: a ``GateNN`` on [detached embedding || domain embedding] scales
    the whole flattened embedding;
  * PPNet: per layer a ``GateNN`` on [detached embedding || EPNet output]
    gates each tower's input (chunked per tower); the dense layer is one
    ``[d, f]`` kernel shared by all towers and its BatchNorm has one
    tower-shared affine (``tied_affine``) with per-tower statistics, as
    the JAX package keeps them;
  * variants: ``pepnet`` (PPNet on), ``epnet`` (PPNet off, ``n_tower``
    stacked towers), ``epnet-single`` (one tower, logit [B]).

The detaches stand where the JAX package stops gradients; they change the
gradients, not the forward.

In a training forward on a card each Gate NU (its MLP, 2 * sigmoid and the
multiply that applies it) runs inside a ``pepnet.gate`` event pair, and
the trainer's step inside a ``pepnet.step`` pair (``step_pair``): nodes
of the step's CUDA graph, read at the trainer's fetches
(``utils/profiling.py``). Evaluation and serving open none.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.initializers import linear_kernel_init, uniform_fan_in
from aread_tpu_torch.ops.mlp import (BatchNorm, GateNN, Linear, StackedLinear,
                                     StackedMLP, dropout)
from aread_tpu_torch.ops.precision import einsum
from aread_tpu_torch.utils.profiling import STORE


class PPNetBlock(nn.Module):
    """[B, din] feature embedding and gate embedding -> [B, T,
    tower_dims[-1]]."""

    def __init__(self, din: int, tower_dims: Tuple[int, ...],
                 gate_hidden_dim: int, n_tower: int, dropout: float = 0.0,
                 generator=None, device=None):
        super().__init__()
        self.n_tower, self.rate = n_tower, dropout
        self.dims = (din,) + tuple(tower_dims)
        for idx in range(len(tower_dims)):
            d, f = self.dims[idx], self.dims[idx + 1]
            self.add_module(f"gate_{idx}", GateNN(
                2 * din, gate_hidden_dim, d * n_tower, generator=generator,
                device=device))
            self.register_parameter(f"kernel_{idx}", nn.Parameter(
                linear_kernel_init((d, f), generator, device)))
            self.register_parameter(f"bias_{idx}", nn.Parameter(
                uniform_fan_in((f,), d, generator, device)))
            self.add_module(f"bn_{idx}", BatchNorm((n_tower, f),
                                                   tied_affine=True,
                                                   device=device))

    def forward(self, feature_emb, gate_emb, train: bool = False, mask=None,
                generator=None):
        B, T = feature_emb.shape[0], self.n_tower
        timed = train and feature_emb.is_cuda
        gate_input = torch.cat([feature_emb.detach(), gate_emb], dim=-1)
        x = feature_emb[:, None, :].expand(B, T, feature_emb.shape[-1])
        for idx in range(len(self.dims) - 1):
            with STORE.pair("pepnet.gate", timed):
                gw = getattr(self, f"gate_{idx}")(gate_input, train=train,
                                                  generator=generator)
                gated = x * gw.reshape(B, T, self.dims[idx])
            h = (einsum("btd,df->btf", gated,
                        getattr(self, f"kernel_{idx}"))
                 + getattr(self, f"bias_{idx}"))
            h = getattr(self, f"bn_{idx}")(h, train=train, mask=mask)
            x = dropout(torch.relu(h), self.rate, train, generator)
        return x


class PEPNet(CTRModel):
    # the trainer's step runs inside an event pair of this name
    step_pair = "pepnet.step"
    REG_RULES = BASE_REG_RULES + (
        (r"^epnet/.*kernel$", 1e-5),
        (r"^ppnet/.*kernel", 1e-5),
        (r"^towers/.*kernel$", 1e-5),
        # the PPNet block's and the towers' BatchNorm scales are
        # regularized too (see deepfm.py)
        (r"^(ppnet|towers)/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int, n_tower: int,
                 tower_dims: Tuple[int, ...] = (256, 128, 64, 32),
                 gate_hidden_dim: int = 64, use_ppnet: bool = True,
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
        self.n_tower, self.use_ppnet = n_tower, use_ppnet
        flat_dim = spec.embed_output_dim(embed_dim)
        self.epnet = GateNN(flat_dim + embed_dim, gate_hidden_dim, flat_dim,
                            dropout, **kw)
        self.cn = self.cn_linear = self.atten = None
        if use_dcn:
            self.cn = CrossNetwork(flat_dim, n_cross_layers, **kw)
            self.cn_linear = Linear(flat_dim, 1, use_bias=False, **kw)
        if use_atten:
            self.atten = AttentionTower(
                spec.field_num, embed_dim, atten_embed_dim, att_layer_num,
                att_head_num, att_res, dropout, **kw)
        self.ppnet = self.towers = None
        if use_ppnet:
            self.ppnet = PPNetBlock(flat_dim, tower_dims, gate_hidden_dim,
                                    n_tower, dropout, **kw)
        else:
            self.towers = StackedMLP(n_tower, flat_dim, tower_dims, dropout,
                                     **kw)
        self.ppnet_linears = StackedLinear(n_tower, tower_dims[-1], 1,
                                           use_bias=False, **kw)

    @property
    def single(self) -> bool:
        """``epnet-single``: one tower and a [B] logit."""
        return not self.use_ppnet and self.n_tower == 1

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)  # [B, F, E]
        domain_embed = embed_x[:, self.spec.domain_idx, :]
        flat = embed_x.reshape(embed_x.shape[0], -1)
        run = dict(train=train, mask=mask, generator=generator)
        gate_input = torch.cat([flat.detach(), domain_embed], dim=-1)
        with STORE.pair("pepnet.gate", train and flat.is_cuda):
            epnet_out = flat * self.epnet(gate_input, train=train,
                                          generator=generator)

        side = self.linear(flat)  # [B, 1]
        if self.cn is not None:
            side = side + self.cn_linear(self.cn(flat))
        if self.atten is not None:
            side = side + self.atten(flat, train=train, generator=generator)

        if self.ppnet is not None:
            touts = self.ppnet(flat, epnet_out, **run)
        else:
            touts = self.towers(epnet_out, **run)
        logit = self.ppnet_linears(touts)[..., 0] + side  # [B, T]
        if self.single:
            logit = logit[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit)}
        if tap:
            out["rows"] = rows
        return out
