"""Model construction from a Config (counterpart of
``aread_tpu/models/__init__.py`` ``build_model``; this slice builds AREAD
only)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from aread_tpu_torch.config import Config
from aread_tpu_torch.device import DeviceLike
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.models.base import FeatureSpec


def build_model(config: Config, spec: FeatureSpec, n_domain: int,
                n_tower: Optional[int] = None,
                device: DeviceLike = None) -> AREAD:
    """The JAX package's wiring: the table padded as for its lane-packed
    storage (same row count, so weights convert one to one) and stored in
    ``config.table_dtype``; HEI towers (g, 2g, 4g, ...) with g the
    dataset's group count capped by ``n_domain``."""
    if config.model not in ("aread", "aread_womask"):
        raise NotImplementedError(f"model {config.model!r} is not ported yet")
    spec = dataclasses.replace(spec.with_flat_table(config.embed_dim),
                               table_dtype=config.table_dtype)
    g = min(config.n_tower, n_domain) if n_tower is None else n_tower
    towers = tuple(g * 2 ** l for l in range(len(config.aread_tower_dims)))
    return AREAD(spec, config.embed_dim, towers, n_domain,
                 base_model=config.base_model, expert_dims=config.mlp_dims,
                 tower_dims=config.aread_tower_dims, dropout=config.dropout,
                 use_dcn=config.use_dcn, n_cross_layers=config.n_cross_layers,
                 mmoe_n_expert=config.mmoe_n_expert, seed=config.seed,
                 device=device)
