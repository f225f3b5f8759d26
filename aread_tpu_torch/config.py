"""Run configuration: the fields of the JAX package's ``Config``
(``aread_tpu/config.py``) that the port reads, with the same names and
defaults."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

DOMAIN2GROUP: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "amazon": {
        "dcn_3groups_kl": (0, 1, 0, 2, 2, 1, 1, 1, 1, 2, 1, 1, 1, 0, 2, 1, 1,
                           1, 1, 0, 1, 1, 1, 1, 1),
    },
    "aliccp": {
        "dcn_3groups_kl": (1, 0, 1, 0, 0, 0, 0, 0, 0, 2, 1, 0, 0, 0, 1, 2, 1,
                           0, 0, 0, 2, 0, 0, 2, 2, 2, 1, 1, 1, 1),
    },
}


@dataclasses.dataclass
class Config:
    model: str = "aread"
    dataset_name: str = "aliccp"
    base_model: str = "mmoe"
    seed: int = 2000
    lr: float = 1e-3
    bs: int = 1024
    embed_dim: int = 32
    wd: float = 1e-8
    group_strategy: str = "dcn_3groups_kl"
    is_evaluate_multi_domain: bool = True

    # HEMP
    init_active_percent: float = 0.7

    # model hyper-params
    use_dcn: bool = True
    n_cross_layers: int = 3
    mmoe_n_expert: int = 4
    mlp_dims: Tuple[int, ...] = (256, 128, 64)  # AREAD's MMoE experts
    aread_tower_dims: Tuple[Tuple[int, ...], ...] = ((64, 32), (32, 16), (16, 8))
    dropout: float = 0.2

    # storage of the table and its Adam moments; compute stays f32 and a
    # bf16 table is written with stochastic rounding (ops/rounding.py)
    table_moments_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    table_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    # add l2 * sum(table^2) to the reported loss (never to the gradient:
    # the table's L2 gradient is folded into its Adam update)
    loss_report_table_l2: bool = True
    # global-norm gradient clipping over all data gradients; 0 = off
    grad_clip_norm: float = 0.0

    def domain2group(self) -> Optional[Tuple[int, ...]]:
        groups = DOMAIN2GROUP.get(self.dataset_name)
        if groups is None:
            return None
        return groups[self.group_strategy]

    @property
    def n_tower(self) -> int:
        d2g = self.domain2group()
        return 3 if d2g is None else max(d2g) + 1
