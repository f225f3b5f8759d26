"""HEMP mask machinery on the host, in numpy (counterpart of the host half
of ``aread_tpu/utils/masks.py``). Masks are lists of boolean arrays shaped
[1,T0], [T0,T1], ..., [T_last,1]. The random stream is numpy's
``default_rng(seed)``, drawn in the JAX package's order, so the same seed
gives the same masks."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Mask = List[np.ndarray]


def mask_shapes(n_tower: Sequence[int]) -> List[Tuple[int, int]]:
    shapes = [(1, n_tower[0])]
    for l in range(1, len(n_tower)):
        shapes.append((n_tower[l - 1], n_tower[l]))
    shapes.append((n_tower[-1], 1))
    return shapes


def edge_num(n_tower: Sequence[int]) -> int:
    return int(sum(a * b for a, b in mask_shapes(n_tower)))


def create_single_full_mask(n_tower: Sequence[int], fill_value: float,
                            rng: np.random.Generator) -> Mask:
    """All-zero, all-one or Bernoulli(fill_value) masks."""
    shapes = mask_shapes(n_tower)
    if fill_value == 0:
        return [np.zeros(s, bool) for s in shapes]
    if fill_value == 1:
        return [np.ones(s, bool) for s in shapes]
    if 0 < fill_value < 1:
        return [rng.random(s) < fill_value for s in shapes]
    raise ValueError("fill_value in mask must be 0 or 1 or (0, 1)")


def validate_mask(mask: Mask, add_input: bool = True, add_output: bool = True,
                  remove_hidden: bool = True) -> Mask:
    """Graph repair: input edges for live level-0 towers, output edges for
    live leaves, then sever hidden towers with no in- or out-edges until
    none is left (worklist)."""
    mask = [m.copy() for m in mask]
    n_level = len(mask) - 1
    n_tower = [m.shape[1] for m in mask[:-1]]
    if add_input:
        for t in range(n_tower[0]):
            if mask[1][t, :].any():
                mask[0][:, t] = True
    if add_output:
        for t in range(n_tower[-1]):
            if mask[-2][:, t].any():
                mask[-1][t, :] = True
    if remove_hidden:
        to_check = [(l, t) for l in range(1, n_level) for t in range(n_tower[l])]
        while to_check:
            l, t = to_check.pop(0)
            if not mask[l][:, t].any():
                mask[l + 1][t, :] = False
            if not mask[l + 1][t, :].any():
                if l > 1:
                    for prev_t in np.nonzero(mask[l][:, t])[0].tolist():
                        if (l - 1, prev_t) not in to_check:
                            to_check.append((l - 1, prev_t))
                mask[l][:, t] = False
    return mask


def has_output(mask: Mask) -> bool:
    return bool(mask[-1].any())


class HempMaskState:
    """Per-domain HEMP masks. This slice ports mask generation in 'rand'
    mode; gate accumulation, pruning and candidate selection come with
    the mask-evolution loop."""

    def __init__(self, n_tower: Sequence[int], n_domain: int, seed: int = 0):
        self.n_tower = tuple(int(t) for t in n_tower)
        self.n_domain = n_domain
        self.rng = np.random.default_rng(seed)
        self.edge_num = edge_num(n_tower)
        self.domain_mask: List[Optional[Mask]] = [None] * n_domain

    def generate_mask(self, generate_mode: str, d: int,
                      init_active_percent: float = 0.7) -> Mask:
        if generate_mode != "rand":
            raise NotImplementedError(
                f"generate_mode={generate_mode!r} is not ported yet")
        while True:
            mask = create_single_full_mask(self.n_tower, init_active_percent,
                                           self.rng)
            valid = validate_mask(mask)
            if has_output(valid):
                return valid
