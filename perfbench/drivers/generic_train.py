"""The generic ``Trainer``'s steps, epochs back to back
(``perfbench.driving``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import inputs
from perfbench.driving import (TrainDriver, feature_spec, load_weights,
                               program_config)


class Driver(TrainDriver):
    """The generic ``Trainer``: ``train_epoch_device`` over a
    ``GlobalBatcher`` of the resident split, the domains' groups from the
    configuration's map."""

    metric = "zoo_examples_per_s"

    def build(self) -> None:
        from aread_tpu_torch.data.loader import GlobalBatcher
        from aread_tpu_torch.models import build_model
        from aread_tpu_torch.train.trainer import Trainer

        cfg = self.cfg
        pcfg = program_config(cfg, self.pseed)
        n_dom = len(cfg["domain_size"])
        model = build_model(pcfg, feature_spec(cfg), n_dom, device=self.dev)
        load_weights(model, inputs.make_weights(cfg, self.seed, self.dev))
        self.d2g = np.asarray(cfg["domain2group"], np.int32)
        tr = Trainer(model, pcfg, n_dom, domain2group=self.d2g)
        tr.init()
        self.batcher = GlobalBatcher(self.x, self.y, cfg["bs"],
                                     cfg["domain_idx"], self.d2g,
                                     shuffle=True, seed=self.pseed)
        tr.stage_device_data(self.batcher)
        self.tr, self.fed, self.steps = tr, 0, 0

    def first_feeds(self, n: int) -> List[Dict]:
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 0xC4EC))
        rows = rng.permutation(len(self.x))[:n * self.cfg["bs"]]
        return [{"ids": r.astype(np.int32)}
                for r in rows.reshape(n, self.cfg["bs"])]

    def epoch_feeds(self, n: int) -> List[Dict]:
        perm = self.batcher.epoch_perm()
        return [{"ids": perm[i % len(perm)]} for i in range(n)]

    def run_steps(self, feeds: List[Dict]) -> torch.Tensor:
        from aread_tpu_torch.train.step_graph import SCAN_CHUNK

        out = []
        for lo in range(0, len(feeds), SCAN_CHUNK):
            chunk = [f["ids"] for f in feeds[lo:lo + SCAN_CHUNK]]
            losses, _ = self.tr.chunks.run("train", chunk, [None] * len(chunk),
                                           self.tr.opt_state)
            out.append(losses)
        return torch.cat(out)

    def rows_fed(self) -> int:
        return self.fed

    def steps_run(self) -> int:
        return self.steps

    def epoch(self, i: int) -> float:
        loss = self.tr.train_epoch_device(self.batcher)
        self.fed += len(self.x)
        self.steps += len(self.batcher)
        return loss

    def batch_extra(self, feed: Dict) -> Dict:
        dom = self.x[np.asarray(feed["ids"]), self.cfg["domain_idx"]]
        return {"group": torch.as_tensor(self.d2g[dom], device=self.dev)}
