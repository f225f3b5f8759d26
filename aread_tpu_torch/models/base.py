"""Feature specification, the base class of the zoo models and the manual
L2 regularization (counterpart of ``aread_tpu/models/base.py``).

Models return a dict with at least ``logit`` and ``prob``. Each model class
declares ``REG_RULES``: (path_regex, l2) pairs matched against
'/'-joined parameter paths (the JAX package's flax paths; the port's
module names are the same with '.' for '/'); ``regularization_loss`` sums
l2 * sum(w^2) over the first matching rule of each parameter, in f32.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from aread_tpu_torch.ops.embedding import FeaturesEmbedding, FeaturesLinear


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """``one_hot_dims[i]`` is the vocab of one-hot column i; the
    multi-hot (history-sequence) columns follow, ``seq_maxlen`` per
    sequence field, and share the itemid rows."""

    one_hot_dims: Tuple[int, ...]
    n_seq_fields: int
    itemid_idx: int
    domain_idx: int
    seq_maxlen: int = 5
    method: str = "mean"
    flat_table: bool = False
    table_dtype: str = "float32"

    @property
    def n_columns(self) -> int:
        return len(self.one_hot_dims) + self.n_seq_fields * self.seq_maxlen

    @property
    def field_num(self) -> int:
        return len(self.one_hot_dims) + self.n_seq_fields

    @property
    def n_rows(self) -> int:
        return int(np.sum(self.one_hot_dims))

    def embed_output_dim(self, embed_dim: int) -> int:
        return self.field_num * embed_dim

    def pad_vocab(self, multiple: int) -> "FeatureSpec":
        """Grow the last field's vocab so the table's row count is a
        multiple of ``multiple`` (appended rows are never referenced)."""
        pad = (-self.n_rows) % multiple
        if pad == 0:
            return self
        dims = list(self.one_hot_dims)
        dims[-1] += pad
        return dataclasses.replace(self, one_hot_dims=tuple(dims))

    def with_flat_table(self, embed_dim: int) -> "FeatureSpec":
        """The JAX package's lane-packed storage padding: rows to a multiple
        of 128 / embed_dim. The port stores the table row-major either way
        (the element order is the same); the padding keeps the row count,
        and so the converted weights, equal to the JAX package's."""
        if 128 % embed_dim != 0:
            return self
        return dataclasses.replace(self.pad_vocab(128 // embed_dim),
                                   flat_table=True)


# Shared default rules: embedding table + linear head.
BASE_REG_RULES: Tuple[Tuple[str, float], ...] = (
    (r"^embedding/table$", 1e-5),
    (r"^linear/kernel$", 1e-5),
)


def regularization_loss(named: Dict[str, torch.Tensor],
                        rules: Sequence[Tuple[str, float]]) -> torch.Tensor:
    """Sum of l2 * sum(w^2) over tensors whose '/'-joined name matches a
    rule (first match wins). ``named`` maps module paths ('.' or '/'
    separated) to tensors."""
    compiled = [(re.compile(pat), l2) for pat, l2 in rules]
    total = None
    for name, leaf in named.items():
        path = name.replace(".", "/")
        for pat, l2 in compiled:
            if pat.search(path):
                term = l2 * torch.sum(torch.square(leaf.to(torch.float32)))
                total = term if total is None else total + term
                break
    if total is None:
        dev = next(iter(named.values())).device if named else None
        return torch.zeros((), device=dev)
    return total


class CTRModel(nn.Module):
    """Base of the zoo models: the feature spec, the ``REG_RULES``
    contract and the embedding + first-order linear backbone every model
    builds on.

    Subclasses implement ``forward(x, group=None, train=False, mask=None,
    generator=None, tap=False)`` -> dict with 'logit' and 'prob' ([B], or
    [B, n_tower] for multi-tower models) and, with ``tap``, 'rows': the
    gathered table rows as a grad leaf (the table itself is a buffer; its
    gradient is taken through this tap). ``generator`` is dropout's.
    Submodule and parameter names are the JAX package's flax paths with
    '.' for '/'."""

    # (path_regex, l2) applied to '/'-joined parameter paths; first match
    # wins
    REG_RULES: Tuple[Tuple[str, float], ...] = ()

    def _backbone(self, spec: FeatureSpec, embed_dim: int, generator, device):
        """Creates ``self.embedding`` and ``self.linear``."""
        self.spec, self.embed_dim, self.device = spec, embed_dim, device
        self.embedding = FeaturesEmbedding(
            spec.one_hot_dims, embed_dim, spec.n_seq_fields, spec.itemid_idx,
            spec.seq_maxlen, spec.method, getattr(torch, spec.table_dtype),
            generator=generator, device=device)
        self.linear = FeaturesLinear(spec.embed_output_dim(embed_dim),
                                     generator=generator, device=device)

    @property
    def model_name(self) -> str:
        return type(self).__name__.lower()

    def dense_named_parameters(self) -> Dict[str, torch.Tensor]:
        """Every trainable tensor by '/'-joined path (the table is a
        buffer and is not among them)."""
        return {n.replace(".", "/"): p for n, p in self.named_parameters()}


def gather_group(preds: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """preds.gather(1, group) for multi-tower outputs: [B, T] -> [B]."""
    return torch.gather(preds, 1, group.to(torch.int64)[:, None])[:, 0]
