"""What the cells' drivers share. A traffic mix names its driver
(``"driver"``: ``perfbench/drivers/<driver>.py``, its class ``Driver``,
found by ``perfbench.registry``); the driver builds the measured package's
objects from the configuration, the mix and the seed, and runs the parts
of a run:

* ``setup()``: the data, the weights and the masks made from the seed, the
  trainer or the Predictor, the first steps that the correctness check
  compares (through the window's own call and feed), and every shape the
  window uses warmed up and captured;
* ``window(seconds)``: the timed work, returning its end-to-end metrics,
  its timed ``units`` and ``seconds`` and any host-clock ``spans``;
* ``traced()`` (traced runs, after the window): a steady stretch of the
  same calls under the profiler (``perfbench.trace``);
* ``check(prods)``: frees the package's state, runs the reference on the
  same inputs and returns the numbers that ``correct`` holds to limits.

Only the drivers import the measured package, and only inside their
functions.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check as chk
from perfbench import inputs, registry
from perfbench.reference import optim as O
from perfbench.reference.layers import TABLE_L2, Net, Products, is_buffer
from perfbench.trace import Traced

F32 = torch.float32
CHECK_STEPS = 4  # steps 1 and 2 eager, the capture, step 4 a graph replay
WARM_STEPS = 32  # steps after the checked ones, before the window
TRACE_WARM, TRACE_STEPS = 32, 64


def program_config(cfg: Dict, seed: int):
    """The package's ``Config`` of the configuration file (its fields
    only), seeded."""
    from aread_tpu_torch.config import Config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: tup(v) for k, v in cfg.items() if k in names}
    kw["seed"] = seed
    return Config(**kw)


def feature_spec(cfg: Dict):
    from aread_tpu_torch.models.base import FeatureSpec

    return FeatureSpec(tuple(cfg["one_hot_dims"]), cfg["n_seq_fields"],
                       cfg["itemid_idx"], cfg["domain_idx"],
                       cfg["seq_maxlen"])


@torch.no_grad()
def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    """The seed-made weights into the package's model by name; names and
    shapes must be the model's own, all of them."""
    sd = model.state_dict()
    if set(sd) != set(weights):
        raise ValueError("the model's tensors and the reference's differ: "
                         f"{sorted(set(sd) ^ set(weights))}")
    for k, v in sd.items():
        if v.shape != weights[k].shape:
            raise ValueError(f"{k}: {tuple(v.shape)} vs "
                             f"{tuple(weights[k].shape)}")
        v.copy_(weights[k])


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Float32 norms of many tensors in one host copy."""
    names = list(tensors)
    out = torch.stack([torch.linalg.vector_norm(tensors[n].to(F32))
                       for n in names]).cpu().tolist()
    return dict(zip(names, out))


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Driver:
    """What every driver shares: the inputs of the run."""

    kind = ""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, seconds: float,
                 device="cuda"):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        # how long the timed window lasts
        self.seconds = float(seconds)
        self.dev = torch.device(device)
        # the package's seed (dropout, shuffles, masks' streams)
        self.pseed = inputs.sub_seed(seed, 0x5EED) % (2**31)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


# --------------------------------------------------------------- training
class TrainDriver(Driver):
    """A training cell: a device-resident split of the configuration's
    ``n_train_rows`` rows, epochs back to back through the trainer's own
    epoch loop."""

    kind = "train"
    metric = "train_examples_per_s"  # the window's rate is reported as

    def setup(self) -> None:
        cfg, mix = self.cfg, self.mix
        x, y = inputs.make_rows(cfg, mix, self.seed, cfg["n_train_rows"],
                                self.dev)
        self.x, self.y = x.cpu().numpy(), y.cpu().numpy()
        del x, y
        self.build()
        # the checked steps: rows that all differ, fed as row ids
        self.check_feeds = self.first_feeds(CHECK_STEPS)
        lo1 = self.run_steps(self.check_feeds[:1])
        self.m1 = self.first_moments()
        lo2 = self.run_steps(self.check_feeds[1:])
        self.losses = torch.cat([lo1, lo2]).cpu().tolist()
        w0 = inputs.make_weights(cfg, self.seed, self.dev)
        now = self.current_weights()
        self.change = norms({k: now[k].to(F32) - w0[k].to(F32)
                             for k in now})
        del w0, now
        # every later chunk replays the captured step
        self.run_steps(self.epoch_feeds(WARM_STEPS))
        self.sync()

    def window(self, seconds: float) -> Dict:
        rows, steps, epochs, failed = 0, 0, 0, 0
        self.sync()
        t0 = time.perf_counter()
        while True:
            r0, s0 = self.rows_fed(), self.steps_run()
            loss = self.epoch(epochs + 1)
            self.sync()
            rows += self.rows_fed() - r0
            steps += self.steps_run() - s0
            epochs += 1
            failed += 0 if math.isfinite(loss) else 1
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        self.attempted, self.failed = epochs, failed
        return {self.metric: rows / dt, "units": steps,
                "seconds": dt}

    def traced(self):
        feeds = self.epoch_feeds(TRACE_WARM + TRACE_STEPS)
        self.run_steps(feeds[:TRACE_WARM])
        with Traced() as t:
            self.run_steps(feeds[TRACE_WARM:])
        t.data.units = TRACE_STEPS
        return t.data

    def first_moments(self) -> Dict[str, float]:
        """The norms of each leaf's first moment over 1 - b1: the first
        step's gradient as the optimizer holds it."""
        st = self.tr.opt_state
        mu = {k.replace("/", "."): v / 0.1
              for k, v in st["inner"]["mu"].items()}
        return norms({**mu, "embedding.table": st["m"].to(F32) / 0.1})

    def current_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.tr.model.state_dict().items()
                if not k.endswith((".mean", ".var"))}

    def release(self) -> None:
        self.tr = self.batcher = None

    # what the reference needs of the checked steps
    def check_batches(self) -> List[Dict]:
        out = []
        for f in self.check_feeds:
            ids = np.asarray(f["ids"])
            b = {"x": torch.as_tensor(self.x[ids], device=self.dev),
                 "y": torch.as_tensor(self.y[ids], dtype=F32,
                                      device=self.dev),
                 "valid": torch.ones(len(ids), device=self.dev)}
            b.update(self.batch_extra(f))
            out.append(b)
        return out

    def check(self, variants=(("program", "f32", None),)
              ) -> Dict[str, Dict[str, float]]:
        """The training numbers (``check.train_numbers``) of each variant
        (label, precision, fault): 'program' the package's readings; any
        other the reference put in the package's place, at ``precision``
        ('tf32': the control) or with ``fault`` 'half' (half of each batch
        left out, the mean taken over the rest)."""
        batches = self.check_batches()
        prog = {"losses": self.losses, "m1": self.m1, "change": self.change}
        self.release()
        free_cuda()
        ref = reference_steps(self.cfg, self.seed, self.pseed, batches,
                              Products("f32"))
        out, self.detail = {}, {}
        for label, precision, fault in variants:
            side = prog if label == "program" else reference_steps(
                self.cfg, self.seed, self.pseed, batches,
                Products(precision), fault=fault)
            out[label] = chk.train_numbers(side, ref)
            self.detail[label] = chk.worst_leaves(side, ref)
        return out


def reference_steps(cfg: Dict, seed: int, pseed: int, batches: List[Dict],
                    prods: Products, fault: Optional[str] = None) -> Dict:
    """The reference's readings of the checked steps from the seed-made
    weights: each step's reported loss, the first moments' norms after
    step 1 (over 1 - b1), the data gradient's norms at step 1 and the
    change of every leaf over the steps."""
    dev = batches[0]["x"].device
    ref = registry.model(cfg)
    W = inputs.make_weights(cfg, seed, dev)
    P = {k: v.clone() for k, v in W.items()}
    dense = [k for k in P if not is_buffer(k)]
    state = O.fresh_state({k: P[k] for k in dense + ["embedding.table"]},
                          getattr(torch, cfg["table_moments_dtype"]))
    gen = torch.Generator(device=dev).manual_seed(pseed)
    losses, out = [], {}
    for t, b in enumerate(batches, 1):
        if fault == "half":
            b = dict(b, valid=b["valid"] * (torch.arange(
                len(b["valid"]), device=dev) % 2 == 0).to(F32))
            b["y"] = b["y"] * b["valid"]
        Pd = {k: P[k].detach().requires_grad_(True) for k in dense}
        net = Net(cfg, {**P, **Pd}, prods, train=True, valid=b["valid"],
                  gen=gen)
        table = P["embedding.table"]
        ids = net.row_ids(b["x"])
        rows = table[ids].to(F32).requires_grad_(True)
        loss, _ = ref.train_loss(cfg, net, b, rows)
        grads = torch.autograd.grad(loss, [Pd[k] for k in dense] + [rows],
                                    allow_unused=True)
        g = {k: (torch.zeros_like(P[k]) if gk is None else gk)
             for k, gk in zip(dense, grads)}
        G = torch.zeros(table.shape, dtype=F32, device=dev)
        G.index_add_(0, ids.reshape(-1), grads[-1].reshape(-1, G.shape[1]))
        losses.append(float(loss.detach() + TABLE_L2 * O.table_sq(table)))
        if t == 1:
            out["gdata"] = norms({**g, "embedding.table": G})
        m, v = state["embedding.table"]
        P["embedding.table"], m2, v2 = O.adam_table(
            table, m, v, G, t, cfg["lr"], cfg["wd"], TABLE_L2)
        state["embedding.table"] = (m2, v2)
        for k in dense:
            O.adam_dense_(P[k], g[k], *state[k], t, cfg["lr"], cfg["wd"])
        if t == 1:
            out["m1"] = norms({k: state[k][0].to(F32) / 0.1
                               for k in dense + ["embedding.table"]})
        del G, grads, g, rows
    out["losses"] = losses
    out["change"] = norms({k: P[k].to(F32) - W[k].to(F32)
                           for k in dense + ["embedding.table"]})
    return out


def aread_trainer(drv: Driver, mask_state=None):
    """An ``AREADTrainer`` of the seed-made weights over the driver's
    resident split, its domains' masks drawn from the seed, and a
    ``DomainBatcher`` of the split that counts the rows it hands out and,
    when ``record`` is set, keeps them. ``mask_state``: a ``HempMaskState``
    class to hold the masks (default the package's)."""
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.utils.masks import HempMaskState

    cfg = drv.cfg
    pcfg = program_config(cfg, drv.pseed)
    n_dom = len(cfg["domain_size"])
    model = build_model(pcfg, feature_spec(cfg), n_dom, device=drv.dev)
    load_weights(model, inputs.make_weights(cfg, drv.seed, drv.dev))
    tr = AREADTrainer(model, pcfg, n_dom)
    tr.init()
    if not tr.stage_device_data(drv.x, drv.y, drv.x, drv.y):
        raise RuntimeError("the split did not go to the device")
    tr.mask_state = (mask_state or HempMaskState)(model.n_tower, n_dom,
                                                  seed=pcfg.seed)
    tr.mask_state.domain_mask = inputs.make_masks(cfg, drv.seed)

    class Counting(DomainBatcher):
        fed, batches, record, kept = 0, 0, False, []

        def next_batch_indices(self, d):
            idx = super().next_batch_indices(d)
            self.fed += int((idx >= 0).sum())
            self.batches += 1
            if self.record:
                self.kept.append(idx)
            return idx

    batcher = Counting(drv.x, drv.y, cfg["bs"], cfg["domain_idx"], n_dom,
                       seed=drv.pseed)
    return tr, batcher
