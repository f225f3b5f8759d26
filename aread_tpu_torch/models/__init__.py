"""Model construction from a Config (counterpart of
``aread_tpu/models/__init__.py`` ``build_model``): every model name of the
JAX package — ``deepfm``, ``dcn``, ``dcnv2``, ``autoint``, ``ple``,
``mmoe``, ``pepnet`` / ``epnet`` / ``epnet-single``, ``star``, ``adl``,
``hinet``, ``adasparse``, ``mamdr`` and ``aread`` / ``aread_womask`` (MMoE
or PLE base)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from aread_tpu_torch.config import Config
from aread_tpu_torch.device import DeviceLike
from aread_tpu_torch.models.adasparse import AdaSparse
from aread_tpu_torch.models.adl import ADL
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.models.autoint import AutoInt
from aread_tpu_torch.models.base import CTRModel, FeatureSpec
from aread_tpu_torch.models.dcn import DCN
from aread_tpu_torch.models.dcnv2 import DCNv2
from aread_tpu_torch.models.deepfm import DeepFM
from aread_tpu_torch.models.hinet import HiNet
from aread_tpu_torch.models.mamdr import MAMDR
from aread_tpu_torch.models.mmoe import MMoE
from aread_tpu_torch.models.pepnet import PEPNet
from aread_tpu_torch.models.ple import PLE
from aread_tpu_torch.models.star import STAR

__all__ = ["ADL", "AREAD", "AdaSparse", "AutoInt", "CTRModel", "DCN",
           "DCNv2", "DeepFM", "FeatureSpec", "HiNet", "MAMDR", "MMoE",
           "PEPNet", "PLE", "STAR", "build_model"]


def build_model(config: Config, spec: FeatureSpec, n_domain: int,
                n_tower: Optional[int] = None, device: DeviceLike = None):
    """The JAX package's wiring. With ``config.sparse_table_grad`` the
    table is padded as for the JAX package's lane-packed storage, and only
    then — either way the row count, and so the converted weights, equal
    the JAX package's. The table is stored in ``config.table_dtype``.
    ``n_tower`` defaults to the dataset's group count capped by
    ``n_domain``; AREAD's HEI towers are (g, 2g, 4g, ...)."""
    name = config.model
    e = config.embed_dim
    if n_tower is None:
        n_tower = min(config.n_tower, n_domain)
    if config.sparse_table_grad:
        spec = spec.with_flat_table(e)
    spec = dataclasses.replace(spec, table_dtype=config.table_dtype)
    common = dict(dropout=config.dropout, seed=config.seed, device=device)
    common_att = dict(atten_embed_dim=config.atten_embed_dim,
                      att_layer_num=config.att_layer_num,
                      att_head_num=config.att_head_num,
                      att_res=config.att_res)
    side = dict(use_dcn=config.use_dcn, use_atten=config.use_atten,
                n_cross_layers=config.n_cross_layers, **common_att)
    if name == "deepfm":
        return DeepFM(spec, e, mlp_dims=(256, 128), **common)
    if name == "dcn":
        return DCN(spec, e, n_cross_layers=3, mlp_dims=config.mlp_dims,
                   **common)
    if name == "dcnv2":
        return DCNv2(spec, e, n_cross_layers=3, mlp_dims=config.mlp_dims,
                     **common)
    if name == "autoint":
        return AutoInt(spec, e, mlp_dims=config.mlp_dims, **common_att,
                       **common)
    if name == "ple":
        return PLE(spec, e, n_tower=n_tower,
                   n_expert_specific=config.ple_n_expert_specific,
                   n_expert_shared=config.ple_n_expert_shared,
                   expert_dims=config.ple_expert_dims,
                   tower_dims=config.ple_tower_dims, **side, **common)
    if name == "mmoe":
        return MMoE(spec, e, n_tower=n_tower, n_expert=config.mmoe_n_expert,
                    expert_dims=config.mmoe_expert_dims,
                    tower_dims=config.mmoe_tower_dims, **side, **common)
    if name in ("pepnet", "epnet", "epnet-single"):
        return PEPNet(spec, e, n_tower=1 if name == "epnet-single" else n_tower,
                      tower_dims=config.tower_dims, gate_hidden_dim=64,
                      use_ppnet=name == "pepnet", **side, **common)
    if name == "star":
        return STAR(spec, e, n_tower=n_tower, tower_dims=config.tower_dims,
                    use_atten=config.use_atten, **common_att, **common)
    if name == "adl":
        return ADL(spec, e, n_tower=n_tower, tower_dims=config.tower_dims,
                   dlm_iters=config.dlm_iters,
                   eval_dlm_update=config.adl_eval_dlm_update, **side,
                   **common)
    if name == "hinet":
        return HiNet(spec, e, n_tower=n_tower, sei_dims=config.sei_dims,
                     tower_dims=config.tower_dims, **side, **common)
    if name == "adasparse":
        return AdaSparse(spec, e, hidden_dims=config.mlp_dims, **side,
                         **common)
    if name == "mamdr":
        return MAMDR(spec, e, mlp_dims=(256, 128), **common)
    if name in ("aread", "aread_womask"):
        towers = tuple(n_tower * 2 ** l
                       for l in range(len(config.aread_tower_dims)))
        return AREAD(spec, e, towers, n_domain, base_model=config.base_model,
                     expert_dims=config.mlp_dims,
                     tower_dims=config.aread_tower_dims,
                     use_dcn=config.use_dcn,
                     n_cross_layers=config.n_cross_layers,
                     mmoe_n_expert=config.mmoe_n_expert,
                     ple_n_expert_specific=config.ple_n_expert_specific,
                     ple_n_expert_shared=config.ple_n_expert_shared,
                     ple_expert_dims=config.ple_expert_dims, **common)
    raise ValueError(f"Unknown model: {name}")
