"""ADL (counterpart of ``aread_tpu/models/adl.py``): Distribution-Learning-
Module routing. Each sample is assigned to a tower by a gradient-free
soft K-means step against L2-normalized cluster centres, routed by the
argmax; every tower is computed densely and the routed tower's logit is
selected. The output weight of each tower is the STAR-style product
``domain_mlps_linears_kernel * shared_mlps_linear_kernel``, formed in the
forward so that both factors get their gradient.

The centres are the persistent buffer ``cluster_centers`` [n_tower, F*D]
(the JAX package's ``model_state`` collection), drawn N(0, 1) from the
model's generator. After the route is taken from them, a training forward
— and, with ``eval_dlm_update``, an evaluation forward too, as in the
reference — moves them in place:
centres = l2norm(rate * centres + (1 - rate) * l2norm(coeff^T @ x)),
over every row of the batch (pad rows included: the JAX package applies
no mask there). The JAX model's DLM loop starts each of its ``dlm_iters``
iterations from the original centres, so every iteration computes the
same assignment; it is computed once here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models.base import BASE_REG_RULES, CTRModel, FeatureSpec
from aread_tpu_torch.ops.attention import AttentionTower
from aread_tpu_torch.ops.cross import CrossNetwork
from aread_tpu_torch.ops.initializers import (linear_bias_init_for,
                                              linear_kernel_init)
from aread_tpu_torch.ops.mlp import Linear, StackedMLP
from aread_tpu_torch.ops.precision import einsum, matmul
from aread_tpu_torch.parallel.mesh import batch_sum


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """x / sqrt(max(sum(x^2), eps)): the squared norm is clamped."""
    return x / torch.sqrt(torch.clamp(
        torch.sum(torch.square(x), dim=dim, keepdim=True), min=eps))


class ADL(CTRModel):
    REG_RULES = BASE_REG_RULES + (
        (r"^domain_mlps/.*kernel$", 1e-5),
        (r"^shared_mlps/.*kernel$", 1e-5),
        # the MLPs' BatchNorm scales too (see deepfm.py)
        (r"^(domain_mlps|shared_mlps)/bn_\d+/scale$", 1e-5),
        (r"^cn/w_\d+$", 1e-5),
    )

    def __init__(self, spec: FeatureSpec, embed_dim: int, n_tower: int,
                 tower_dims: Tuple[int, ...] = (256, 128, 64, 32),
                 dlm_iters: int = 3, dlm_update_rate: float = 0.9,
                 eval_dlm_update: bool = False, dropout: float = 0.2,
                 use_dcn: bool = True, use_atten: bool = True,
                 n_cross_layers: int = 3, atten_embed_dim: int = 64,
                 att_layer_num: int = 3, att_head_num: int = 2,
                 att_res: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        if dlm_iters < 1:
            raise ValueError(f"dlm_iters={dlm_iters}: the DLM routes after "
                             "at least one iteration")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self._backbone(spec, embed_dim, gen, dev)
        self.n_tower = n_tower
        self.dlm_update_rate = dlm_update_rate
        self.eval_dlm_update = eval_dlm_update
        flat_dim = spec.embed_output_dim(embed_dim)
        self.register_buffer("cluster_centers", torch.randn(
            (n_tower, flat_dim), generator=gen, device=dev))
        self.cn = self.cn_linear = self.atten = None
        if use_dcn:
            self.cn = CrossNetwork(flat_dim, n_cross_layers, **kw)
            self.cn_linear = Linear(flat_dim, 1, use_bias=False, **kw)
        if use_atten:
            self.atten = AttentionTower(
                spec.field_num, embed_dim, atten_embed_dim, att_layer_num,
                att_head_num, att_res, dropout, **kw)
        self.domain_mlps = StackedMLP(n_tower, flat_dim, tower_dims, dropout,
                                      **kw)
        self.shared_mlps = StackedMLP(1, flat_dim, tower_dims, dropout, **kw)
        d = tower_dims[-1]
        bias_init = linear_bias_init_for(d)
        self.domain_mlps_linears_kernel = nn.Parameter(
            linear_kernel_init((n_tower, d, 1), gen, dev))
        self.domain_mlps_linears_bias = nn.Parameter(
            bias_init((n_tower, 1), gen, dev))
        self.shared_mlps_linear_kernel = nn.Parameter(
            linear_kernel_init((d, 1), gen, dev))
        self.shared_mlps_linear_bias = nn.Parameter(bias_init((1,), gen, dev))

    @torch.no_grad()
    def route(self, flat: torch.Tensor, update: bool) -> torch.Tensor:
        """The tower of each row [B], taken from the current centres;
        with ``update`` the centres then take their EMA step in place."""
        flat = flat.detach()
        centers = self.cluster_centers
        coeff = torch.softmax(matmul(flat, centers.T), dim=1)
        route = torch.argmax(coeff, dim=1)
        if update:
            rate = self.dlm_update_rate
            # over the global batch on a mesh
            tmp = l2_normalize(batch_sum(matmul(coeff.T, flat)), dim=1)
            centers.copy_(l2_normalize(rate * centers + (1 - rate) * tmp,
                                       dim=1))
        return route

    def forward(self, x, group=None, train: bool = False, mask=None,
                generator=None, tap: bool = False):
        embed_x, rows = self.embedding(x, tap=tap)
        flat = embed_x.reshape(embed_x.shape[0], -1)
        route = self.route(flat, update=train or self.eval_dlm_update)
        run = dict(train=train, mask=mask, generator=generator)

        side = self.linear(flat)  # [B, 1]
        if self.cn is not None:
            side = side + self.cn_linear(self.cn(flat))
        if self.atten is not None:
            side = side + self.atten(flat, train=train, generator=generator)
        touts = self.domain_mlps(flat, **run)  # [B, T, D']
        if train:
            # the output is unused, as in the JAX package; the forward
            # moves the shared tower's BatchNorm statistics
            self.shared_mlps(flat, **run)
        eff_k = (self.domain_mlps_linears_kernel
                 * self.shared_mlps_linear_kernel[None])
        eff_b = (self.domain_mlps_linears_bias
                 + self.shared_mlps_linear_bias[None])
        tower_logits = (einsum("btd,tdf->btf", touts, eff_k)[..., 0]
                        + eff_b[None, :, 0] + side)  # [B, T]
        logit = torch.gather(tower_logits, 1, route[:, None])[:, 0]
        out = {"logit": logit, "prob": torch.sigmoid(logit), "route": route}
        if tap:
            out["rows"] = rows
        return out
