"""Fused feature embedding (counterpart of ``aread_tpu/ops/embedding.py``).

One logical table of ``sum(one_hot_dims)`` rows; per-field offsets are
added to the raw ids; the multi-hot history-sequence fields reuse the
itemid field's rows and are mean- or sum-pooled over ``seq_maxlen``, pad
rows included in the mean (as ``torch.mean(..., dim=2)`` in the
reference), or, with ``method=None``, left unpooled: one output field per
sequence slot.

The table is stored row-major ``[n_rows, D]`` as a buffer, never a
trainable parameter: its gradient is taken through a sparse tap. The
rows are gathered without grad and cast to f32 (a bf16 table's compute is
f32), and when the caller asks for the tap the f32 rows become a leaf
with ``requires_grad``; after ``backward`` its ``.grad`` is
d loss / d rows ``[B, F_cols, D]``. A dense table gradient never exists.
This replaces the flax ``perturb("rows")`` tap of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from aread_tpu_torch.ops.initializers import (embedding_init,
                                              linear_kernel_init,
                                              uniform_fan_in)


def compute_offsets(one_hot_dims: Sequence[int], n_multi_hot_slots: int,
                    itemid_idx: int) -> np.ndarray:
    """Per-column row offsets into the fused table."""
    offsets = np.concatenate([[0], np.cumsum(one_hot_dims)[:-1]]).astype(np.int64)
    if n_multi_hot_slots > 0:
        multi = np.full((n_multi_hot_slots,), offsets[itemid_idx], dtype=np.int64)
        offsets = np.concatenate([offsets, multi])
    return offsets


class FeaturesEmbedding(nn.Module):
    """Input x: int [B, n_one_hot + n_seq_fields * seq_maxlen].
    Output: f32 [B, n_one_hot + n_seq_fields, D] (pooled; ``method=None``:
    [B, n_one_hot + n_seq_fields * seq_maxlen, D]), plus the tap rows when
    asked for."""

    def __init__(self, one_hot_dims: Tuple[int, ...], embed_dim: int,
                 n_seq_fields: int, itemid_idx: int, seq_maxlen: int,
                 method: Optional[str] = "mean", table_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if method not in ("mean", "sum", None):
            raise ValueError(f"Invalid multi-hot method {method!r}")
        self.one_hot_dims = tuple(int(d) for d in one_hot_dims)
        self.embed_dim = embed_dim
        self.n_seq_fields = n_seq_fields
        self.seq_maxlen = seq_maxlen
        self.method = method
        self.n_rows = int(np.sum(self.one_hot_dims))
        offsets = compute_offsets(self.one_hot_dims, n_seq_fields * seq_maxlen,
                                  itemid_idx)
        self.register_buffer("offsets", torch.as_tensor(offsets, device=device),
                             persistent=False)
        self.register_buffer("table", embedding_init(
            (self.n_rows, embed_dim), generator, device, table_dtype))

    def table_ids(self, x: torch.Tensor) -> torch.Tensor:
        """The table row each input column gathers (offsets applied,
        clipped into the table) — also the sparse update's row ids."""
        return torch.clamp(x.to(torch.int64) + self.offsets[None, :], 0,
                           self.n_rows - 1)

    def forward(self, x: torch.Tensor, tap: bool = False):
        """Returns (embed [B, F, D], rows) where ``rows`` is the f32 leaf
        of gathered rows (``requires_grad`` when ``tap``)."""
        with torch.no_grad():
            rows = self.table[self.table_ids(x)]
        rows = rows.to(torch.float32, copy=True)
        if tap:
            rows.requires_grad_(True)
        n_one = len(self.one_hot_dims)
        embed_x = rows
        if self.n_seq_fields > 0 and self.method is not None:
            multi = rows[:, n_one:, :].reshape(
                rows.shape[0], self.n_seq_fields, self.seq_maxlen,
                self.embed_dim)
            pooled = multi.mean(dim=2) if self.method == "mean" else multi.sum(dim=2)
            embed_x = torch.cat([rows[:, :n_one, :], pooled], dim=1)
        return embed_x, rows


class FeaturesLinear(nn.Module):
    """First-order linear head over the flattened embedding."""

    def __init__(self, input_dim: int, output_dim: int = 1,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(linear_kernel_init(
            (input_dim, output_dim), generator, device))
        self.bias = (nn.Parameter(uniform_fan_in(
            (output_dim,), input_dim, generator, device))
                     if use_bias else None)

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias
