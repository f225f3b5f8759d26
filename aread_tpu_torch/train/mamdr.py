"""MAMDR's Reptile meta-training (counterpart of
``aread_tpu/train/mamdr.py``).

Each epoch:
  1. shared update: the meta weights go into the model, a fresh optimizer
     trains them over the domain-ordered batch sequence (domains in a
     random order, each domain's batches together), then the Reptile step
     meta += (new - old) * meta_lr;
  2. for each domain d: ``mamdr_aux_sample_num`` auxiliary domains drawn
     without replacement, then d itself; for each of them, the merged
     weights (meta + d's weights) go into the model, a fresh optimizer
     trains on that domain's batches and then on d's, and d's weights take
     the Reptile step against the merged starting point.
Evaluation runs domain by domain with the merged weights.

What Reptile moves are the weights the JAX package keeps in ``params``:
every trainable tensor and the embedding table (a buffer here). The
BatchNorm statistics are not among them: they stay in the model and run
on through every sequence, as the JAX package's ``state`` does. Weights
are swapped into the model with ``copy_`` into the same tensors, so the
sparse-Adam kernel's scratch (keyed on the table tensor) stays valid. Each
sequence starts from ``hybrid_init`` without ``moments_dtype``: the
table's moments in the table's dtype and the step count at 0, as in the
JAX package. Per-domain weights start at zero, so merged = meta at first.
After ``fit`` the model holds the meta weights (what the CLI saves).

On a mesh (``MamdrTrainer(mesh=)``, passed on to ``Trainer``) the steps
are the mesh steps and the table is each rank's rows; Reptile's passes are
elementwise, so each rank runs them on its own rows, and evaluation
all-gathers the predictions over 'data'.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import DomainBatcher, SplitData
from aread_tpu_torch.train import metrics as metrics_lib
from aread_tpu_torch.train.checkpoint import local_state
from aread_tpu_torch.train.trainer import (Trainer, adopt_state_dict,
                                           hybrid_init)
from aread_tpu_torch.utils.runlog import RunLogger

Weights = Dict[str, torch.Tensor]


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the JAX package multiplies a bf16
    array by the weak-typed ``meta_lr`` cast to bf16 (0.1 -> 0.10009765625),
    where torch would compute with the f32 scalar."""
    return float(torch.tensor(value, dtype=dtype))


@torch.no_grad()
def tree_add(a: Weights, b: Weights) -> Weights:
    """a + b per tensor, in each tensor's dtype."""
    names = list(a)
    return dict(zip(names, torch._foreach_add([a[n] for n in names],
                                              [b[n] for n in names])))


@torch.no_grad()
def reptile_update(update: Weights, new: Weights, old: Weights,
                   meta_lr: float) -> Weights:
    """update + (new - old) * meta_lr per tensor, each operation rounded
    to the tensor's dtype (bitwise the JAX package's ``reptile_update``)."""
    names = list(update)
    delta = torch._foreach_sub([new[n] for n in names],
                               [old[n] for n in names])
    torch._foreach_mul_(delta, [_in_dtype(meta_lr, d.dtype) for d in delta])
    torch._foreach_add_(delta, [update[n] for n in names])
    return dict(zip(names, delta))


class MamdrTrainer(Trainer):
    """Reptile meta-trainer over per-domain batch streams."""

    def __init__(self, model, config: Config, n_domain: int, mesh=None):
        super().__init__(model, config, n_domain, mesh=mesh)
        self.meta_weights: Optional[Weights] = None
        self.domain_weights: Optional[List[Weights]] = None

    def live_weights(self) -> Weights:
        """The model's tensors that Reptile moves: every trainable tensor
        and the table, by '/'-joined path."""
        return {**self.model.dense_named_parameters(),
                "embedding/table": self.model.embedding.table}

    @torch.no_grad()
    def load_weights(self, weights: Weights) -> None:
        """``weights`` into the model's own tensors."""
        live = self.live_weights()
        torch._foreach_copy_([live[n] for n in weights],
                             list(weights.values()))

    def train_from(self, weights: Weights, batcher: DomainBatcher,
                   seq: Iterable[int]) -> None:
        """``weights`` into the model, a fresh optimizer, then one step per
        entry of ``seq`` on that domain's next batch."""
        self.load_weights(weights)
        self.opt_state = hybrid_init(self.optimizer, self.model)
        for d in seq:
            self.step(self.place(batcher.next_batch(int(d))))

    def fit(self, data: SplitData, epochs: Optional[int] = None,
            verbose: bool = True, warm_start: Optional[Dict] = None) -> Dict:
        """``warm_start``: a checkpoint dict whose weights and buffers seed
        the model, and so the meta weights. Returns {'history': per-epoch
        valid results, 'test': the test result, 'meta_weights',
        'domain_weights'}; the model is left holding the meta weights.
        ``config.log_dir``: the valid and test results go to a
        ``RunLogger``. As in the JAX package, the epochs run without the
        watchdog and without dynamic regrouping (``epoch_timeout_s`` and
        ``dynamic_regroup`` are taken and not acted on)."""
        with RunLogger(self.config.log_dir or None,
                       config=self.config) as logger:
            return self._fit(data, epochs, verbose, warm_start, logger)

    def _fit(self, data: SplitData, epochs: Optional[int], verbose: bool,
             warm_start: Optional[Dict], logger: RunLogger) -> Dict:
        cfg = self.config
        nd = self.n_domain
        didx = data.spec.domain_idx
        train_b = DomainBatcher(data.train_x, data.train_y, cfg.bs, didx, nd,
                                seed=cfg.seed)
        valid_b = DomainBatcher(data.valid_x, data.valid_y, cfg.bs, didx, nd,
                                shuffle=False, seed=0)
        test_b = DomainBatcher(data.test_x, data.test_y, cfg.bs, didx, nd,
                               shuffle=False, seed=0)
        np_rng = np.random.default_rng(cfg.seed)
        # the JAX trainer initializes from domain 0's first batch; the same
        # draw keeps the streams in step with it
        train_b.next_batch(0)
        if warm_start is not None:
            adopt_state_dict(self.model, local_state(
                warm_start["state_dict"], None, self.mesh)[0])
        with torch.no_grad():
            self.meta_weights = {n: t.clone()
                                 for n, t in self.live_weights().items()}
            self.domain_weights = [
                {n: torch.zeros_like(t) for n, t in self.meta_weights.items()}
                for _ in range(nd)]
        live = self.live_weights()

        seq_all = np.asarray(train_b.domain_batch_seq)
        domain_list, counts = np.unique(seq_all, return_counts=True)
        cnt = dict(zip(domain_list.tolist(), counts.tolist()))
        lr = cfg.mamdr_meta_lr

        history = []
        for epoch_i in range(epochs if epochs is not None else cfg.epoch):
            t0 = time.time()
            order = np_rng.permutation(domain_list)
            self.train_from(self.meta_weights, train_b, np.concatenate(
                [np.repeat(d, cnt[int(d)]) for d in order]))
            self.meta_weights = reptile_update(self.meta_weights, live,
                                               self.meta_weights, lr)
            for d in domain_list.tolist():
                candidates = domain_list[domain_list != d]
                k = min(cfg.mamdr_aux_sample_num, len(candidates))
                aux = np.append(np_rng.choice(candidates, size=k,
                                              replace=False), d)
                merged = tree_add(self.meta_weights, self.domain_weights[d])
                for a in aux.tolist():
                    self.train_from(merged, train_b,
                                    [a] * cnt[a] + [d] * cnt[d])
                    self.domain_weights[d] = reptile_update(
                        self.domain_weights[d], live, merged, lr)
                    merged = tree_add(self.meta_weights,
                                      self.domain_weights[d])

            result = self.evaluate_merged(valid_b, data.domain_cnt_weight)
            result["epoch_time_s"] = time.time() - t0
            history.append(result)
            logger.log({"valid": result}, step=epoch_i + 1)
            if verbose:
                # Trainer.fit's line; the shared and domain passes report
                # no train loss, as in the JAX package
                print(f"epoch {epoch_i + 1}: train_loss=nan "
                      f"valid auc={result['total_auc']:.4f} "
                      f"loss={result['total_loss']:.4f} "
                      f"mean_auc={result.get('mean_auc', np.nan):.4f}")
            if not self.is_continuable(result, epoch_i):
                break

        test_result = self.evaluate_merged(test_b, data.domain_cnt_weight)
        logger.log({"test": test_result})
        return {"history": history, "test": test_result,
                "meta_weights": self.meta_weights,
                "domain_weights": self.domain_weights}

    def evaluate_merged(self, batcher: DomainBatcher,
                        domain_cnt_weight: np.ndarray) -> Dict:
        """Domain by domain (ascending), each with its merged weights;
        the model holds the meta weights again afterwards."""
        preds, targets, domains = [], [], []
        prev_d = -1
        for d in np.sort(np.asarray(batcher.domain_batch_seq)).tolist():
            if d != prev_d:
                self.load_weights(tree_add(self.meta_weights,
                                           self.domain_weights[d]))
                prev_d = d
            batch = batcher.next_batch(d)
            n = int(batch["valid"].sum())
            preds.append(self.gather_rows(
                self.eval_prob(self.place(batch)))[:n])
            targets.append(batch["y"][:n])
            domains.append(np.full((n,), d, np.int64))
        self.load_weights(self.meta_weights)
        return metrics_lib.full_evaluation(
            np.concatenate(targets), torch.cat(preds).cpu().numpy(),
            np.concatenate(domains), domain_cnt_weight,
            multi_domain=self.config.is_evaluate_multi_domain)
