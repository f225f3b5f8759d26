"""Evaluation metrics (counterpart of ``aread_tpu/train/metrics.py``).

In numpy on the host: tie-aware ROC-AUC, log-loss clipped at 1e-15, and
the per-domain aggregation weighted by train frequency. On the device:
``StreamingAUC``, per-domain histograms of the predictions from which the
same result dict is finalized, so that only [n_domain, n_bins] counts
leave the device instead of every prediction."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


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


class StreamingAUC:
    """Per-domain streaming AUC / log-loss accumulator. The state is a
    dict of device tensors: ``pos`` / ``neg`` [n_domain, n_bins] histograms
    of the positive and negative rows, ``loss_sum`` and ``count``
    [n_domain]. AUC from a histogram is the tie-aware Mann-Whitney
    statistic with the ties inside a bin taken as 0.5 * pos_b * neg_b, so
    it converges to the exact AUC as the bins grow.

    ``update`` adds into the histograms with ``index_add_``, whose adds on
    a CUDA device are atomic and land in any order: the weights are 0 or 1,
    so ``pos`` and ``neg`` are exact in f32 whatever the order (up to 2^24
    rows per bin). ``loss_sum`` is a sum of real numbers and ``count``
    rides with it: both are row sums of a [n_domain, B] one-hot product, a
    reduction with a fixed order, so a run repeats bitwise."""

    def __init__(self, n_domain: int, n_bins: int = 16384):
        self.n_domain = int(n_domain)
        self.n_bins = int(n_bins)

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return {"pos": z(self.n_domain, self.n_bins),
                "neg": z(self.n_domain, self.n_bins),
                "loss_sum": z(self.n_domain), "count": z(self.n_domain)}

    def reset_state(self, state: Optional[Dict[str, torch.Tensor]],
                    device=None) -> Dict[str, torch.Tensor]:
        """``state`` (a state of the caller's device, or None) zeroed in
        place when it has this accumulator's shape, else a new
        ``init_state``: a pass that starts from it keeps the tensors that a
        captured pass adds into."""
        if state is None or state["pos"].shape != (self.n_domain,
                                                   self.n_bins):
            return self.init_state(device)
        with torch.no_grad():
            torch._foreach_zero_(list(state.values()))
        return state

    def _increments(self, dev, probs, targets, domains, valid, logits):
        """One batch's additions to the four entries of a state on
        ``dev``."""
        f32 = torch.float32
        targets = torch.as_tensor(targets, device=dev).to(f32)
        domains = torch.as_tensor(domains, device=dev).to(torch.int64)
        if logits is not None:
            logits = torch.as_tensor(logits, device=dev).to(f32)
        if probs is None:
            probs = torch.sigmoid(logits)
        probs = torch.as_tensor(probs, device=dev).to(f32)
        valid = (torch.ones_like(probs) if valid is None
                 else torch.as_tensor(valid, device=dev).to(f32))

        # bins in logit space: AUC is rank-based, so a monotone transform
        # keeps it, and logit-spaced bins keep their resolution where CTR
        # predictions live, near 0
        if logits is not None:
            z = torch.clamp(logits, -32.0, 32.0)
            lo, width = -32.2, 64.4
        else:
            pc = torch.clamp(probs, 1e-7, 1 - 1e-7)
            z = torch.log(pc) - torch.log1p(-pc)  # in (-16.2, 16.2)
            lo, width = -16.2, 32.4
        bins = torch.clamp(((z - lo) * (self.n_bins / width)).to(torch.int32),
                           0, self.n_bins - 1)
        idx = domains * self.n_bins + bins.to(torch.int64)
        size = self.n_domain * self.n_bins
        pos = torch.zeros(size, dtype=f32, device=dev).index_add_(
            0, idx, targets * valid)
        neg = torch.zeros(size, dtype=f32, device=dev).index_add_(
            0, idx, (1.0 - targets) * valid)
        # 1e-7 is the epsilon that is safe in f32: 1 - 1e-15 rounds to 1
        # and log1p(-1) = -inf would make the masked-out term NaN
        p = torch.clamp(probs, 1e-7, 1 - 1e-7)
        bce = -(targets * torch.log(p) + (1 - targets) * torch.log1p(-p)) * valid
        onehot = (domains[None, :] == torch.arange(
            self.n_domain, device=dev)[:, None]).to(f32)  # [n_domain, B]
        return {"pos": pos.view(self.n_domain, self.n_bins),
                "neg": neg.view(self.n_domain, self.n_bins),
                "loss_sum": (onehot * bce[None]).sum(dim=1),
                "count": (onehot * valid[None]).sum(dim=1)}

    @torch.no_grad()
    def update(self, state, probs, targets, domains, valid=None,
               logits=None) -> Dict[str, torch.Tensor]:
        """``probs`` / ``targets`` [B] float, ``domains`` [B] int,
        ``valid`` [B] float mask of the real rows. Pass the model's raw
        ``logits`` where there are any: f32 probabilities saturate to
        exactly 0 or 1 and lose their rank, logits keep it. Returns the
        new state; ``state`` is left as it was."""
        inc = self._increments(state["pos"].device, probs, targets, domains,
                               valid, logits)
        return {k: state[k] + v for k, v in inc.items()}

    @torch.no_grad()
    def update_(self, state, probs, targets, domains, valid=None,
                logits=None) -> None:
        """``update`` in place: the same increments added into ``state``'s
        own tensors (bitwise the functional form), so that a captured
        evaluation pass keeps its histograms in static tensors. On device
        input it makes no tensor from host data and reads nothing back."""
        inc = self._increments(state["pos"].device, probs, targets, domains,
                               valid, logits)
        for k, v in inc.items():
            state[k].add_(v)

    @staticmethod
    def _auc_from_hist(pos: np.ndarray, neg: np.ndarray) -> float:
        P, N = pos.sum(), neg.sum()
        if P == 0 or N == 0:
            return float("nan")
        cum_neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
        ordered = float(np.sum(pos * cum_neg_below) + 0.5 * np.sum(pos * neg))
        return ordered / float(P * N)

    def finalize(self, state, domain_cnt_weight: Optional[np.ndarray] = None,
                 multi_domain: bool = True) -> Dict:
        """One fetch of the state, then ``full_evaluation``'s dict on the
        host."""
        pos, neg, loss_sum, count = (
            state[k].cpu().numpy().astype(np.float64)
            for k in ("pos", "neg", "loss_sum", "count"))
        total_count = count.sum()
        result = {
            "total_auc": self._auc_from_hist(pos.sum(0), neg.sum(0)),
            "total_loss": (float(loss_sum.sum() / total_count)
                           if total_count else float("nan")),
        }
        if multi_domain:
            domain_auc, domain_loss = {}, {}
            mean_auc, mean_loss = 0.0, 0.0
            for d in range(self.n_domain):
                if count[d] == 0:
                    continue  # the domain is absent from the split
                auc = self._auc_from_hist(pos[d], neg[d])
                loss = float(loss_sum[d] / count[d])
                if np.isnan(auc):
                    loss = float("nan")  # a single-class domain NaNs both
                domain_auc[d], domain_loss[d] = auc, loss
                w = (domain_cnt_weight[d] if domain_cnt_weight is not None
                     and d < len(domain_cnt_weight) else 0.0)
                mean_auc += w * auc
                mean_loss += w * loss
            result.update({"domain_auc": domain_auc,
                           "domain_loss": domain_loss,
                           "mean_auc": float(mean_auc),
                           "mean_loss": float(mean_loss)})
        return result
