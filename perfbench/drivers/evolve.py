"""HEMP's regroups back to back (``perfbench.driving``)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from perfbench import inputs
from perfbench.driving import F32, Driver as Base, aread_trainer, free_cuda
from perfbench.reference.layers import Products
from perfbench.trace import Traced


class Driver(Base):
    """HEMP's mask evolution: whole regroups back to back through
    ``AREADTrainer._mask_evolution``, the call ``fit`` makes at every regroup
    point, at the configuration's depth (``candidate_mask_num`` decaying by
    0.99 a regroup, ``regroup_update_step`` adapt steps and
    ``regroup_eval_step`` probes a chain) on the engine ``hemp_fast_adapt``
    picks. Nothing trains between regroups, so every chain starts from the
    seed-made weights. The set-up's regroup takes the chain's capture and
    its eager first chains; its candidates are what the check compares."""

    kind = "evolve"

    def setup(self) -> None:
        from aread_tpu_torch.utils.masks import HempMaskState

        cfg = self.cfg
        x, y = inputs.make_rows(cfg, self.mix, self.seed, cfg["n_train_rows"],
                                self.dev)
        self.x, self.y = x.cpu().numpy(), y.cpu().numpy()
        del x, y
        drawn, outs = [], {}

        class Recording(HempMaskState):
            """The package's mask state, keeping each candidate it draws
            and each domain's pruned candidates and probe losses at
            selection."""

            depth = 0

            def generate_mask(self, mode, d, *args, **kw):
                # the trainer's call, not the draws it makes inside
                self.depth += 1
                try:
                    m = super().generate_mask(mode, d, *args, **kw)
                finally:
                    self.depth -= 1
                if self.depth == 0:
                    drawn.append((d, [a.copy() for a in m]))
                return m

            def update_all_mask(self):
                if not outs:
                    outs["masks"] = [[[a.copy() for a in c] for c in cands]
                                     for cands in self.candidate_domain_mask]
                    outs["losses"] = [[list(l) for l in dl]
                                      for dl in self.eval_loss]
                super().update_all_mask()

        self.tr, self.batcher = aread_trainer(self, Recording)
        self.batcher.kept = []
        self.batcher.record = True
        self.regroup()
        self.batcher.record = False
        S, P = cfg["regroup_update_step"], cfg["regroup_eval_step"]
        rows = self.batcher.kept
        self.cands = []
        z = {}
        for i, (d, m) in enumerate(drawn):
            k = z[d] = z.get(d, -1) + 1
            self.cands.append({
                "d": d, "mask": m,
                "adapt": rows[i * (S + P):i * (S + P) + S],
                "probe": rows[i * (S + P) + S:(i + 1) * (S + P)],
                "out_mask": outs["masks"][d][k],
                "out_losses": outs["losses"][d][k]})
        self.sync()

    def regroup(self) -> int:
        self.tr._mask_evolution(self.batcher, self.batcher, verbose=False)
        return self.tr.regroup_log[-1]["chains"]

    def window(self, seconds: float) -> Dict[str, float]:
        chains, n = 0, 0
        self.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            chains += self.regroup()
            n += 1
        self.sync()
        dt = time.perf_counter() - t0
        self.attempted, self.failed = n, 0
        return {"evolve_chains_per_s": chains / dt, "units": chains,
                "seconds": dt}

    def traced(self):
        """One domain's candidates of the set-up's regroup, again, through
        ``run_chains`` (the call every regroup makes) under the profiler:
        a whole regroup is some two million kernel records."""
        n = int(self.mix["trace_chains"])
        c = self.cands[:n]
        self.tr.run_chains([x["mask"] for x in c], [x["adapt"] for x in c],
                           [x["probe"] for x in c], self.tr.overlay_enabled())
        with Traced() as t:
            self.tr.run_chains([x["mask"] for x in c],
                               [x["adapt"] for x in c],
                               [x["probe"] for x in c],
                               self.tr.overlay_enabled())
        t.data.units = n
        return t.data

    def batch(self, idx) -> Dict:
        """A padded batch of the split's rows ``idx`` (-1 pads: the first
        row again, label 0, not valid)."""
        idx = np.asarray(idx)
        valid = idx >= 0
        g = np.where(valid, idx, idx[0])
        return {"x": torch.as_tensor(self.x[g], device=self.dev),
                "y": torch.as_tensor(self.y[g] * valid, dtype=F32,
                                     device=self.dev),
                "valid": torch.as_tensor(valid, dtype=F32, device=self.dev)}

    def check(self, variants=(("program", "f32", None),)
              ) -> Dict[str, Dict[str, float]]:
        """Over a sample of the set-up's candidates (its first two, which
        ran eagerly, and replays drawn from the seed): ``probe_loss_gap``,
        the largest |probe loss - the reference's|, and
        ``mask_edges_differ``, the share of the pruned masks' edges that
        differ from the reference's. A variant other than 'program' puts
        the reference in the package's place at its precision, with its
        fault ('half', 'unchanged': ``reference.hemp.chain``)."""
        from perfbench.reference import hemp as H

        cfg = self.cfg
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 0xE7))
        n = len(self.cands)
        pick = sorted({0, 1, *rng.choice(np.arange(2, n), size=min(
            n - 2, int(self.mix["check_chains"]) - 2), replace=False).tolist()})
        self.tr = self.batcher = None
        free_cuda()
        W = inputs.make_weights(cfg, self.seed, self.dev)
        S = cfg["regroup_update_step"]
        gens = {label: torch.Generator(device=self.dev).manual_seed(self.pseed)
                for label, _, _ in variants if label != "program"}
        gref = torch.Generator(device=self.dev).manual_seed(self.pseed)
        done = 0
        res = {label: [0.0, 0, 0] for label, _, _ in variants}
        for i in pick:
            c = self.cands[i]
            for g in [gref] + list(gens.values()):
                H.skip_forwards(g, cfg, cfg["bs"], (i - done) * S, self.dev)
            done = i + 1
            adapt = [self.batch(r) for r in c["adapt"]]
            probe = [self.batch(r) for r in c["probe"]]
            ref_m, ref_l = H.chain(cfg, W, adapt, probe, c["mask"], gref,
                                   Products("f32"))
            for label, precision, fault in variants:
                if label == "program":
                    m, l = c["out_mask"], c["out_losses"]
                else:
                    m, l = H.chain(cfg, W, adapt, probe, c["mask"],
                                   gens[label], Products(precision), fault)
                r = res[label]
                r[0] = max(r[0], max(abs(a - b) for a, b in zip(l, ref_l)))
                r[1] += sum(int((a != b).sum()) for a, b in zip(m, ref_m))
                r[2] += sum(a.size for a in m)
        return {label: {"probe_loss_gap": r[0],
                        "mask_edges_differ": r[1] / max(r[2], 1)}
                for label, r in res.items()}
