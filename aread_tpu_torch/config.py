"""Run configuration: the fields of the JAX package's ``Config``
(``aread_tpu/config.py``) that the port reads, with the same names and
defaults."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

ITEMID_ALL = 1368287  # the amazon item vocab, its pad row included
SEQ_MAXLEN = 5

DOMAIN_SIZE: Dict[str, Tuple[int, ...]] = {
    "amazon": (69360, 282546, 776105, 3001846, 88496, 449031, 2859592, 1893,
               1437340, 16454, 601698, 1802, 2416380, 197170, 202176, 6931,
               317131, 132650, 602500, 585227, 845268, 1107407, 997451,
               623565, 44843),
    "aliccp": (2695782, 1433175, 925817, 584726, 461755, 358265, 166869,
               113621, 78692, 65313, 54483, 45808, 40975, 37939, 34079,
               31703, 29551, 27084, 25027, 23464, 21764, 19857, 18390,
               16712, 15852, 14914, 13653, 12265, 11179, 9760),
}

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
    epoch: int = 10
    embed_dim: int = 32
    wd: float = 1e-8
    early_stop: int = 2  # patience, in epochs without a better valid AUC
    seq_maxlen: int = SEQ_MAXLEN
    itemid_all: int = ITEMID_ALL
    group_strategy: str = "dcn_3groups_kl"
    domain_filter: Optional[Sequence[int]] = None
    is_evaluate_multi_domain: bool = True
    prepare2train_month: int = 12

    # AREAD / HEMP: warm-up and regroup intervals count batches of 1024
    # rows (the trainer rescales them by 1024 / bs)
    update_lr: float = 1e-2  # the fast-adapt chains' learning rate
    aug_ratio: float = 0.1  # share of counterfactually augmented rows
    warm_up_interval: int = 100
    regroup_interval: int = 2000
    regroup_update_step: int = 5
    regroup_eval_step: int = 5
    candidate_mask_num: int = 10
    random_modify_sigma: float = 0.2
    init_active_percent: float = 0.7
    # final-gate phase after HEMP: a fresh Adam over final_gate alone
    final_lr: float = 1e-3
    final_epoch: int = 10
    aread_final: bool = False

    # model hyper-params
    use_dcn: bool = True
    n_cross_layers: int = 3
    mmoe_n_expert: int = 4
    mlp_dims: Tuple[int, ...] = (256, 128, 64)  # DCN's MLP, AREAD's experts
    tower_dims: Tuple[int, ...] = (256, 128, 64, 32)
    use_atten: bool = True
    atten_embed_dim: int = 64
    att_layer_num: int = 3
    att_head_num: int = 2
    att_res: bool = True
    mmoe_expert_dims: Tuple[int, ...] = (256, 128, 64)
    mmoe_tower_dims: Tuple[int, ...] = (64, 32)
    ple_n_expert_specific: int = 2
    ple_n_expert_shared: int = 2
    ple_expert_dims: Tuple[Tuple[int, ...], ...] = ((256, 128), (64,))
    ple_tower_dims: Tuple[int, ...] = (64, 32)
    sei_dims: Tuple[int, ...] = (64, 32)  # HiNet's SEI experts
    dlm_iters: int = 3  # ADL's DLM routing iterations
    # ADL: the DLM cluster centres move during evaluation too, batch by
    # batch, as in the reference; off keeps evaluation pure
    adl_eval_dlm_update: bool = False
    aread_tower_dims: Tuple[Tuple[int, ...], ...] = ((64, 32), (32, 16), (16, 8))
    dropout: float = 0.2

    # MAMDR's Reptile meta-training: the meta step size and the auxiliary
    # domains trained before each domain
    mamdr_meta_lr: float = 0.1
    mamdr_aux_sample_num: int = 2

    # storage of the table and its Adam moments; compute stays f32 and a
    # bf16 table is written with stochastic rounding (ops/rounding.py)
    table_moments_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    table_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    # add l2 * sum(table^2) to the reported loss (never to the gradient:
    # the table's L2 gradient is folded into its Adam update)
    loss_report_table_l2: bool = True
    # global-norm gradient clipping over all data gradients; 0 = off
    grad_clip_norm: float = 0.0
    # 'adam': dense semantics, every row's moments decay every step (the
    # sparse-Adam sweep). 'lazy_adam': only the rows gathered this step
    # change (indexed updates, never the kernel).
    table_optimizer: str = "adam"
    # engine of the HEMP fast-adapt chains: 'full' = every chain step runs
    # the full-table sweep; 'auto' resolves to it; 'overlay' (a compact
    # working-set copy) is not ported yet and raises
    hemp_fast_adapt: str = "auto"  # 'auto' | 'overlay' | 'full'
    # the table's data gradient: True = sparse (d loss / d gathered rows,
    # deduplicated, ops/sparse_adam.py; the table padded as the JAX
    # package pads it for its lane-packed storage); False = the dense
    # [n_rows, D] gradient and the fused dense Adam (ops/fused_adam.py).
    # The two leave the same f32 table bitwise.
    sparse_table_grad: bool = True
    # keep the train split on the device and gather each batch by index:
    # 'auto' = when it fits Trainer.DEVICE_DATA_BUDGET, '1' / '0' force
    device_data: str = "auto"

    # evaluate from per-domain histograms of the logits kept on the
    # device (train/metrics.py StreamingAUC): only [n_domain, auc_bins]
    # counts reach the host
    streaming_eval: bool = False
    auc_bins: int = 16384

    # paths
    data_path: str = "dataset"
    save_path: str = "save"
    # warm-start weights, BatchNorm statistics and AREAD masks from the
    # saved best checkpoint; the optimizer starts fresh
    is_increment: bool = False
    # write a resumable checkpoint (weights, optimizer state, HEMP masks
    # and schedule, dropout generator, epoch) on every improvement, and
    # resume from it when one exists
    elastic: bool = False

    # options of the JAX package's trainers that are not ported
    # yet: any value but the default raises NotImplementedError
    compute_dtype: str = "float32"
    dynamic_regroup: str = "off"
    log_dir: str = ""
    epoch_timeout_s: float = 0.0
    embed_lookup: str = "gspmd"

    def domain2group(self) -> Optional[Tuple[int, ...]]:
        groups = DOMAIN2GROUP.get(self.dataset_name)
        if groups is None:
            return None
        return groups[self.group_strategy]

    @property
    def n_tower(self) -> int:
        d2g = self.domain2group()
        return 3 if d2g is None else max(d2g) + 1
