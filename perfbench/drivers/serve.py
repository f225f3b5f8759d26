"""Online scoring through one ``Predictor`` (``perfbench.driving``)."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import inputs, registry
from perfbench.driving import (Driver as Base, feature_spec, free_cuda,
                               load_weights, program_config)
from perfbench.reference.layers import Products
from perfbench.trace import Traced


class Driver(Base):
    """Online scoring: an open loop of arrivals at the mix's fixed
    ``rate_per_s`` into ``Predictor.predict`` (one server; the package's
    HTTP server serialises its calls), simulated in one thread: take the
    next request, wait until it is due if it is early, serve it, time it
    from when it was due until its probabilities are on the host. Each
    request is one user's candidates in one domain. Every seed gets the
    same request sizes and the same gaps between arrivals, in its own
    order. Serving stops when the window closes: below the server's
    capacity every arrival is served by then and the tail is the measure;
    above it the queue grows all through the window and the rows scored by
    its close are."""

    kind = "serve"

    def setup(self) -> None:
        from aread_tpu_torch.models import build_model
        from aread_tpu_torch.serve.predictor import Predictor

        cfg, mix = self.cfg, self.mix
        pcfg = program_config(cfg, self.pseed)
        n_dom = len(cfg["domain_size"])
        model = build_model(pcfg, feature_spec(cfg), n_dom, device=self.dev)
        load_weights(model, inputs.make_weights(cfg, self.seed, self.dev))
        self.masks = inputs.make_masks(cfg, self.seed)
        self.pred = Predictor(model, n_dom, domain_mask=self.masks)
        del model
        free_cuda()
        self.make_requests()
        # every (mode, bucket) the traffic reaches: its eager calls and its
        # capture, before the window
        for j in self.bucket_examples():
            for _ in range(3):
                self.pred.predict(self.payloads[j])
        self.sync()

    def make_requests(self) -> None:
        cfg, mix = self.cfg, self.mix
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 0x5E7E))
        n_pay = mix["payloads"]
        q = (np.arange(n_pay) + 0.5) / n_pay
        lo, hi = math.log(mix["rows_min"]), math.log(mix["rows_max"])
        sizes = rng.permutation(np.exp(lo + q * (hi - lo)).astype(int))
        sizes_d = np.asarray(cfg["domain_size"], np.float64)
        doms = rng.choice(len(sizes_d), size=n_pay, p=sizes_d / sizes_d.sum())
        x, _ = inputs.make_rows(cfg, mix, self.seed, int(sizes.sum()),
                                self.dev, key=0x5E77)
        x = x.cpu().numpy()
        user = [j for j in range(x.shape[1])
                if j not in (cfg["itemid_idx"], cfg["domain_idx"])]
        self.payloads, self.domains, off = [], doms, 0
        for n, d in zip(sizes, doms):
            p = x[off:off + n].copy()
            off += n
            p[:, cfg["domain_idx"]] = d
            p[:, user] = p[0, user]
            self.payloads.append(p)
        # the arrivals of the window: its length x the rate, the gaps the
        # quantiles of the exponential law, in the seed's order
        n_req = max(1, int(round(mix["rate_per_s"] * self.seconds)))
        qa = (np.arange(n_req) + 0.5) / n_req
        gaps = rng.permutation(-np.log1p(-qa) / mix["rate_per_s"])
        self.due = np.cumsum(gaps) * (self.seconds / gaps.sum())
        self.which = rng.integers(0, n_pay, size=n_req)
        # the sample that the check compares, the largest request in it,
        # from the first half of the arrivals: served also when the queue
        # grows
        pool = max(1, n_req // 2)
        n_chk = min(mix["check_requests"], pool)
        self.sampled = set(rng.choice(pool, size=n_chk, replace=False)
                           .tolist())
        j_big = int(rng.integers(0, pool))
        self.which[j_big] = int(np.argmax(sizes))
        self.sampled.add(j_big)
        self.outputs: Dict[int, np.ndarray] = {}

    def bucket_examples(self) -> List[int]:
        """A payload of each of the Predictor's padded sizes the traffic
        reaches."""
        from aread_tpu_torch.serve.predictor import BUCKETS

        first = {}
        for j, p in enumerate(self.payloads):
            first.setdefault(min(b for b in BUCKETS if b >= len(p)), j)
        return sorted(first.values())

    def loop(self, seconds: float, keep: bool) -> Dict:
        """Serve the arrivals due in the first ``seconds`` until that much
        time has passed: per request its latency and its service time
        (seconds), the requests that failed and the rows scored by then."""
        lat, svc = [], []
        failed, rows = 0, 0
        gc.collect()
        t0 = time.perf_counter()
        for j, due in enumerate(self.due):
            if due > seconds or time.perf_counter() - t0 >= seconds:
                break
            t_due = t0 + due
            # spin until due: a sleep can wake a timer tick late, and the
            # request's latency would count the oversleep
            while time.perf_counter() < t_due:
                pass
            s = time.perf_counter()
            try:
                p = self.pred.predict(self.payloads[self.which[j]])
            except RuntimeError:
                p = None
                failed += 1
            e = time.perf_counter()
            lat.append(e - t_due if p is not None else math.inf)
            svc.append(e - s)
            if p is not None and e - t0 <= seconds:
                rows += len(p)
            if keep and j in self.sampled and p is not None:
                self.outputs[j] = p
        return {"lat": lat, "svc": svc, "failed": failed, "rows": rows}

    def window(self, seconds: float) -> Dict:
        r = self.loop(seconds, keep=True)
        self.attempted, self.failed = len(r["lat"]), r["failed"]
        return {"serve_p95_ms": float(np.percentile(r["lat"], 95)) * 1e3,
                "serve_rows_per_s": r["rows"] / seconds,
                "units": len(r["lat"]), "seconds": seconds,
                "spans": {"predict_s": r["svc"]}}

    def traced(self):
        """The first ``trace_s`` seconds of the same arrivals, again, under
        the profiler."""
        with Traced() as t:
            r = self.loop(float(self.mix["trace_s"]), keep=False)
        t.data.units = len(r["lat"])
        return t.data

    def check(self, variants=(("program", "f32", None),)
              ) -> Dict[str, Dict[str, float]]:
        """``prob_gap`` over the sampled requests that were served, of each
        variant (label, precision, fault): 'program' the package's
        responses; any other the reference put in the package's place, at
        ``precision`` ('tf32': the control) or with ``fault`` 'answer' (one
        probability of each response altered where it is produced)."""
        got = dict(self.outputs)
        if not got:
            return {label: {"prob_gap": math.inf} for label, _, _ in variants}
        self.pred = None
        free_cuda()
        W = inputs.make_weights(self.cfg, self.seed, self.dev)
        model = registry.model(self.cfg)
        gaps = {label: 0.0 for label, _, _ in variants}
        for j, p_prog in sorted(got.items()):
            x = self.payloads[self.which[j]]
            d = int(x[0, self.cfg["domain_idx"]])
            batch = {"x": torch.as_tensor(x, device=self.dev),
                     "masks": [torch.as_tensor(m, device=self.dev)
                               for m in self.masks[d]]}
            with torch.no_grad():
                ref = model.eval_prob(self.cfg, W, batch,
                                      Products("f32")).cpu().numpy()
                for label, precision, fault in variants:
                    p = p_prog if label == "program" else model.eval_prob(
                        self.cfg, W, batch, Products(precision)).cpu().numpy()
                    if fault == "answer":
                        p = p.copy()
                        p[len(p) // 2] = 1.0 - p[len(p) // 2]
                    gaps[label] = max(gaps[label],
                                      float(np.max(np.abs(p - ref))))
        return {label: {"prob_gap": g} for label, g in gaps.items()}
