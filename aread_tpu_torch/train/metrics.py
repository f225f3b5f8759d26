"""Evaluation metrics in numpy on the host (counterpart of the numpy half
of ``aread_tpu/train/metrics.py``): tie-aware ROC-AUC, log-loss clipped at
1e-15, and the per-domain aggregation weighted by train frequency."""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_auc(targets: np.ndarray, predicts: np.ndarray) -> float:
    """Tie-aware AUC via average ranks (Mann-Whitney U)."""
    targets = np.asarray(targets).astype(np.int64).ravel()
    predicts = np.asarray(predicts, dtype=np.float64).ravel()
    n_pos = int(targets.sum())
    n_neg = targets.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present; AUC undefined")
    order = np.argsort(predicts, kind="mergesort")
    _, inv, counts = np.unique(predicts[order], return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - counts + cum + 1) / 2.0
    ranks = np.empty(targets.size, dtype=np.float64)
    ranks[order] = avg_rank[inv]
    pos_rank_sum = ranks[targets == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def log_loss(targets: np.ndarray, predicts: np.ndarray, eps: float = 1e-15) -> float:
    targets = np.asarray(targets, dtype=np.float64).ravel()
    p = np.clip(np.asarray(predicts, dtype=np.float64).ravel(), eps, 1 - eps)
    return float(-np.mean(targets * np.log(p) + (1 - targets) * np.log(1 - p)))


def evaluate_multi_domain(targets: np.ndarray, predicts: np.ndarray,
                          domains: np.ndarray,
                          domain_cnt_weight: np.ndarray) -> Dict:
    """Per-domain AUC / log-loss and their train-frequency-weighted means.
    A single-class domain contributes NaN, which propagates into the
    mean."""
    domains = np.asarray(domains).ravel()
    domain_auc, domain_loss = {}, {}
    mean_auc, mean_loss = 0.0, 0.0
    for d in np.unique(domains):
        m = domains == d
        try:
            auc = roc_auc(targets[m], predicts[m])
            loss = log_loss(targets[m], predicts[m])
        except ValueError:
            auc, loss = np.nan, np.nan
        d = int(d)
        domain_auc[d], domain_loss[d] = auc, loss
        w = domain_cnt_weight[d] if d < len(domain_cnt_weight) else 0.0
        mean_auc += w * auc
        mean_loss += w * loss
    return {"domain_auc": domain_auc, "domain_loss": domain_loss,
            "mean_auc": float(mean_auc), "mean_loss": float(mean_loss)}


def full_evaluation(targets, predicts, domains, domain_cnt_weight,
                    multi_domain: bool = True) -> Dict:
    """Total AUC / log-loss, plus the per-domain block."""
    result = {"total_auc": roc_auc(targets, predicts),
              "total_loss": log_loss(targets, predicts)}
    if multi_domain:
        result.update(evaluate_multi_domain(targets, predicts, domains,
                                            domain_cnt_weight))
    return result
