"""AREAD's bagging steps, epochs back to back (``perfbench.driving``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import inputs
from perfbench.driving import TrainDriver, aread_trainer


class Driver(TrainDriver):
    """AREAD's bagging steps: ``AREADTrainer.train_epoch`` at epochs >= 1
    (no warm-up, no regroup inside the epoch at the configuration's
    regroup interval), over a ``DomainBatcher`` of the resident split, the
    domains' masks drawn from the seed."""

    def build(self) -> None:
        self.tr, self.batcher = aread_trainer(self)
        self.masks = [[m.copy() for m in dm]
                      for dm in self.tr.mask_state.domain_mask]

    def first_feeds(self, n: int) -> List[Dict]:
        """``n`` single-domain batches of distinct rows: domains drawn by
        their sizes among those with a whole batch of rows."""
        bs, dom = self.cfg["bs"], self.x[:, self.cfg["domain_idx"]]
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 0xC4EC))
        counts = np.bincount(dom, minlength=len(self.cfg["domain_size"]))
        big = np.nonzero(counts >= n * bs)[0]
        feeds = []
        for d in rng.choice(big, size=n, p=counts[big] / counts[big].sum()):
            rows = rng.permutation(np.nonzero(dom == d)[0])
            used = sum(1 for f in feeds if f["d"] == d)
            feeds.append({"d": int(d), "ids": rows[used * bs:(used + 1) * bs]
                          .astype(np.int32)})
        return feeds

    def epoch_feeds(self, n: int) -> List[Dict]:
        seq = self.batcher.domain_batch_seq
        return [{"d": int(d), "ids": self.batcher.next_batch_indices(d)}
                for d in (seq * (n // len(seq) + 1))[:n]]

    def run_steps(self, feeds: List[Dict]) -> torch.Tensor:
        steps = [(f["d"], f["ids"], [np.array(m) for m in self.masks[f["d"]]],
                  False) for f in feeds]
        losses, _ = self.tr.run_segment("main", steps)
        return torch.cat(losses)

    def rows_fed(self) -> int:
        return self.batcher.fed

    def steps_run(self) -> int:
        return self.batcher.batches

    def epoch(self, i: int) -> float:
        return self.tr.train_epoch(i, self.batcher, self.batcher,
                                   verbose=False)

    def batch_extra(self, feed: Dict) -> Dict:
        return {"masks": [torch.as_tensor(m, device=self.dev)
                          for m in self.masks[feed["d"]]]}
