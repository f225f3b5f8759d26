"""Dynamic domain -> group regrouping (counterpart of
``aread_tpu/train/regroup.py``).

Host-side numpy counterparts of the reference's
``Run.get_losses_tower_domain`` and ``Run.regroup_all_domain``: the loss
matrix is tiny ([n_tower, n_domain]) and the assignment is branchy host
work. ``Trainer.apply_dynamic_regroup`` calls them between epochs
(``config.dynamic_regroup``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def get_losses_tower_domain(pred: np.ndarray, y: np.ndarray,
                            domains: np.ndarray, n_tower: int,
                            n_domain: int) -> np.ndarray:
    """Per-(tower, domain) mean BCE of multi-tower probabilities ``pred``
    [B, n_tower], in f64. A domain without rows gives NaN, as torch's mean
    over an empty mask does."""
    pred = np.asarray(pred, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    domains = np.asarray(domains).reshape(-1)
    eps = 1e-12  # torch's BCELoss clamps the log at -100; eps keeps it finite
    p = np.clip(pred, eps, 1.0 - eps)
    bce = -(y[:, None] * np.log(p) + (1.0 - y[:, None]) * np.log(1.0 - p))
    out = np.full((n_tower, n_domain), np.nan)
    for d in range(n_domain):
        mask = domains == d
        if mask.any():
            out[:, d] = bce[mask].mean(axis=0)
    return out


def regroup_all_domain(train_loss_domain_group: np.ndarray,
                       regroup_mode: Sequence[str] = ("towerfirst",),
                       selected_domain: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """Every domain's tower group from a loss matrix [n_tower, n_domain]:
      * 'served': each tower first keeps its selected domain
        (``selected_domain[g]``);
      * 'besttower': each domain without a group takes its argmin tower;
      * 'towerfirst': each tower claims its best domain if it is still
        free, then the others take their argmin tower.
    'served' is a prefix step; 'besttower' takes precedence over
    'towerfirst', as in the reference's if/elif chain."""
    loss = np.asarray(train_loss_domain_group, np.float64)
    n_tower, n_domain = loss.shape
    domain2group = np.full(n_domain, -1, np.int64)
    if "served" in regroup_mode:
        if selected_domain is None:
            raise ValueError("'served' mode needs selected_domain")
        for g in range(n_tower):
            domain2group[selected_domain[g]] = g
    if "besttower" in regroup_mode:
        for d in range(n_domain):
            if domain2group[d] < 0:
                domain2group[d] = int(np.argmin(loss[:, d]))
    elif "towerfirst" in regroup_mode:
        for g in range(n_tower):
            best_d4g = int(np.argmin(loss[g, :]))
            if domain2group[best_d4g] < 0:
                domain2group[best_d4g] = g
        for d in range(n_domain):
            if domain2group[d] < 0:
                domain2group[d] = int(np.argmin(loss[:, d]))
    if np.any(domain2group < 0):
        raise ValueError(f"regroup_mode={tuple(regroup_mode)!r} left domains "
                         "without a group")
    return domain2group
