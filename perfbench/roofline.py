"""Peaks of the chip and the operations and bytes of the work, counted from
the configuration's shapes alone (never from the measured package).

Peaks: NVIDIA H100 SXM data sheet, dense: 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s HBM. The step counts float32 products at the
float32 peak: the configuration states float32 compute with TF32 off.

Kernel 1, the table's dense-semantics Adam from its sparse gradient: each
element of w, m and v read once and written once (2 + 2 + 2 bytes each
way in bfloat16, 4 + 4 + 4 in float32), plus the deduplicated ids (4 B
each) and their row gradients (4 B an element) of one batch: 12 B x
48,588,288 elements + 17,408 ids x (4 + 128) B = 585,357,312 B at the
Amazon width with bfloat16 storage.

A training step's compulsory bytes are that update plus one read and one
write of every dense parameter and its two float32 moments; its
operations are the products of the forward (2 per multiply-add) and twice
as many for the backward. At these widths the bytes bound it. The
parameters' shapes and the forward's multiply-adds are the model's own
reference's (``perfbench/reference/<model>.py``, found by name).
"""

from __future__ import annotations

import math
from typing import Dict

from perfbench import registry

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

_ITEM = {"bfloat16": 2, "float32": 4}


def specs(cfg: Dict):
    return registry.model(cfg).param_specs(cfg)


def table_shape(cfg: Dict):
    (shape,) = [s for n, s, _ in specs(cfg) if n == "embedding.table"]
    return shape


def n_columns(cfg: Dict) -> int:
    return len(cfg["one_hot_dims"]) + cfg["n_seq_fields"] * cfg["seq_maxlen"]


def sparse_adam_bytes(cfg: Dict) -> int:
    """Kernel 1's compulsory bytes for one update."""
    rows, d = table_shape(cfg)
    per = 2 * (_ITEM[cfg["table_dtype"]] + 2 * _ITEM[cfg["table_moments_dtype"]])
    k = cfg["bs"] * n_columns(cfg)
    return per * rows * d + k * (4 + 4 * d)


def dense_param_count(cfg: Dict) -> int:
    return sum(math.prod(s) for n, s, how in specs(cfg)
               if n != "embedding.table" and not n.endswith((".mean", ".var")))


def step_bytes(cfg: Dict) -> int:
    """A training step's compulsory bytes: the table update and the dense
    leaves' Adam (w, m, v read and written in float32)."""
    return sparse_adam_bytes(cfg) + 24 * dense_param_count(cfg)


def forward_macs_per_row(cfg: Dict) -> int:
    """Multiply-adds of one row's forward through the products."""
    return registry.model(cfg).forward_macs_per_row(cfg)


def step_flops(cfg: Dict) -> float:
    """Forward and backward of one batch: 2 x 3 x the forward's
    multiply-adds."""
    return 6.0 * forward_macs_per_row(cfg) * cfg["bs"]


def step_seconds_bound(cfg: Dict) -> float:
    """The least time one training step could take on the chip."""
    return max(step_flops(cfg) / PEAK_F32_FLOPS,
               step_bytes(cfg) / PEAK_HBM_BYTES)


def chain_seconds_bound(cfg: Dict) -> float:
    """The least time one HEMP candidate chain could take: its adapt steps
    (training steps) and its probes (a batch's forward products each)."""
    probe = 2.0 * forward_macs_per_row(cfg) * cfg["bs"] / PEAK_F32_FLOPS
    return (cfg["regroup_update_step"] * step_seconds_bound(cfg)
            + cfg["regroup_eval_step"] * probe)
