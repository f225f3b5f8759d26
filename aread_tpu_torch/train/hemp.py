"""AREAD training step and evaluation (counterpart of the parts of
``aread_tpu/train/hemp.py`` that this slice ports): ``AREADTrainer``'s
construction and init, the bagging loss, the train step as
``warmup_step`` (mode 'wo_mask') and ``main_step`` ('domain_mask_bagging'),
and ``evaluate`` over per-domain batches through each domain's mask.

One step: forward with the embedding's sparse tap, one autograd pass for
the dense leaves and the gathered rows, then ``hybrid_update_sparse`` (the
table through the sparse-Adam kernel on the card). The mask-evolution
loop (``train_epoch``, fast-adapt chains and probes), the final-gate
phase and ``fit`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import DomainBatcher
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.models.base import regularization_loss
from aread_tpu_torch.train import metrics as metrics_lib
from aread_tpu_torch.train.trainer import (bce_with_logits, hybrid_init,
                                           hybrid_update_sparse,
                                           make_optimizer, masked_mean,
                                           split_table, strip_table_rule)
from aread_tpu_torch.utils.masks import HempMaskState


class AREADTrainer:
    def __init__(self, model: AREAD, config: Config, n_domain: int):
        self.model = model
        self.config = config
        self.n_domain = n_domain
        self.device = model.device
        self.mask_state = HempMaskState(model.n_tower, n_domain,
                                        seed=config.seed)
        self.optimizer = make_optimizer(config.lr, config.wd)
        # dropout's stream
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        # the table's L2 gradient is folded into its Adam update
        self.reg_rules = strip_table_rule(type(model).REG_RULES)
        self.opt_state: Optional[Dict] = None

    def init(self) -> Dict:
        """Optimizer state for the model's current weights (the model's
        weights are drawn from its seed when it is built)."""
        self.opt_state = hybrid_init(
            self.optimizer, self.model,
            moments_dtype=self.config.table_moments_dtype)
        return self.opt_state

    def place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def bagging_loss(self, batch, dm, mode: str, train: bool = True):
        """(loss, model output). 'wo_mask' trains on the mean-prob
        prediction; the bagging mode on the mean of per-leaf BCEs over the
        active leaves."""
        out = self.model(batch["x"], domain_mask=dm, mode=mode, train=train,
                         mask=batch["valid"], generator=self.generator,
                         tap=True)
        y, valid = batch["y"], batch["valid"]
        if mode == "wo_mask":
            prob = torch.clamp(out["prob"], 1e-7, 1 - 1e-7)
            bce = masked_mean(-(y * torch.log(prob)
                                + (1 - y) * torch.log1p(-prob)), valid)
        else:
            per_leaf = (torch.sum(bce_with_logits(out["leaf_logit"], y[:, None])
                                  * valid[:, None], dim=0)
                        / torch.clamp(torch.sum(valid), min=1.0))  # [T_last]
            la = out["leaf_active"].to(per_leaf.dtype)
            bce = torch.sum(per_leaf * la) / torch.clamp(la.sum(), min=1e-8)
        _, rest = split_table(self.model)
        loss = bce + regularization_loss(rest, self.reg_rules)
        return loss, out

    def step_core(self, mode: str, batch, dm) -> Tuple[torch.Tensor, Tuple]:
        """One training step in place. Returns (reported loss, gate means);
        neither is fetched to the host."""
        cfg = self.config
        if self.opt_state is None:
            raise RuntimeError("call init() before stepping")
        if isinstance(batch["x"], np.ndarray):
            batch = self.place(batch)
        self.model.train()
        loss, out = self.bagging_loss(batch, dm, mode)
        _, rest = split_table(self.model)
        names = list(rest)
        # leaves a mode does not use get zero gradients, as in JAX (the
        # decay term still moves them)
        grads = torch.autograd.grad(loss, [rest[n] for n in names] + [out["rows"]],
                                    materialize_grads=True)
        ids = self.model.embedding.table_ids(batch["x"])
        l2val = hybrid_update_sparse(
            self.optimizer, cfg.lr, cfg.wd, self.model,
            dict(zip(names, grads[:-1])), ids, grads[-1], self.opt_state,
            want_table_l2=cfg.loss_report_table_l2,
            clip_norm=cfg.grad_clip_norm)
        loss = loss.detach()
        if l2val is not None:
            loss = loss + l2val
        return loss, out["gate_means"]

    def warmup_step(self, batch):
        return self.step_core("wo_mask", batch, None)

    def main_step(self, batch, dm: Sequence[np.ndarray]):
        return self.step_core("domain_mask_bagging", batch, dm)

    @torch.no_grad()
    def eval_prob(self, batch, dm) -> torch.Tensor:
        self.model.eval()
        return self.model(batch["x"], domain_mask=dm, mode="domain_with_mask",
                          train=False)["prob"]

    def evaluate(self, batcher: DomainBatcher,
                 domain_cnt_weight: np.ndarray) -> Dict:
        """One pass over ``batcher.domain_batch_seq``, each batch through
        its domain's current mask; total and per-domain AUC / log-loss."""
        ms = self.mask_state
        preds, targets, domains = [], [], []
        for d in batcher.domain_batch_seq:
            batch_np = batcher.next_batch(d)
            prob = self.eval_prob(self.place(batch_np), ms.domain_mask[d])
            n = int(batch_np["valid"].sum())
            preds.append(prob[:n])
            targets.append(batch_np["y"][:n])
            domains.append(np.full((n,), d, np.int64))
        return metrics_lib.full_evaluation(
            np.concatenate(targets), torch.cat(preds).cpu().numpy(),
            np.concatenate(domains), domain_cnt_weight,
            multi_domain=self.config.is_evaluate_multi_domain)
