"""AREAD training (counterpart of ``aread_tpu/train/hemp.py``): warm-up,
bagging steps under per-domain masks, HEMP mask evolution every regroup
interval, early stopping on the weighted mean AUC, the optional
final-gate phase and the per-domain masked evaluation.

One step (``step_core``): forward with the embedding's sparse tap, one
autograd pass for the dense leaves and the gathered rows, then
``hybrid_update_sparse`` (the table through the sparse-Adam kernel on the
card). The model's weights and BatchNorm statistics live in the model and
are updated in place; the main optimizer's state is ``self.opt_state``.

Host and device:
  * mask generation and selection are numpy on the host
    (``utils/masks.py``): masks are tiny;
  * one evolution is a plain loop over its candidates, in place, on the
    one model: restore the snapshot, zero the one fast-Adam state, run
    ``regroup_update_step`` bagging steps at ``update_lr`` with a prune
    after each, then ``regroup_eval_step`` no-grad probes. The snapshot
    stays on the device and is restored with in-place copies, so no tensor
    that the optimizer states or the kernel's scratch refer to is
    replaced, and the main optimizer's state and step count come out of an
    evolution untouched;
  * losses and recorded gate means stay on the device and are fetched once
    per segment, not per step.

Two engines run the chains (``config.hemp_fast_adapt``,
``overlay_enabled``): the full sweep, where each adapt step updates the
whole table through the sparse-Adam kernel, and the overlay
(``ops/overlay_adam.py``), where each adapt step updates a compact f32
copy of the rows the chain's batches touch through the fused dense Adam
kernel and the probes read every other row drifted; an overlay chain
never writes the live table, so its snapshot and restore leave the table
out.

The JAX package fuses a whole regroup into one dispatch and a segment of
steps into scans (``fast_adapt_many``, ``SCAN_CHUNK``, ``run_segment``)
because every dispatch there crosses a slow link to its device; that
reason does not exist here, so those, and the Pallas kernel window's
prechecks (``FITS_SLICE``, ``_fits_from_x``, ``_fits_from_idx``,
``no_overflow``, ``assume_no_overflow``), have no counterpart: the CUDA
kernel has no window.

``AREADTrainer(mesh=)`` runs one rank of a (data, model) grid as
``Trainer(mesh=)`` does (``train/trainer.py``): the warm-up, bagging and
chain steps on the rank's batch rows with the losses, gradients and gate
means completed over 'data' and the table updated per shard, the probe
losses summed over 'data' so that every rank prunes and selects the same
masks from the same numbers, snapshots of the rank's own rows, and
checkpoints gathered to rank 0. The overlay engine is one device's: on a
mesh 'auto' takes the full sweep and 'overlay' raises, as in the JAX
package.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import DomainBatcher, SplitData, pad_batch
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.models.base import FeatureSpec, regularization_loss
from aread_tpu_torch.ops import overlay_adam as oa
from aread_tpu_torch.ops.precision import matmul_precision_ctx
from aread_tpu_torch.ops.sparse_adam import dedup_rows
from aread_tpu_torch.parallel import mesh as mesh_lib
from aread_tpu_torch.parallel.embed_shard import resolve_a2a_capacity
from aread_tpu_torch.parallel.health import epoch_deadline, watchdog
from aread_tpu_torch.train import metrics as metrics_lib
from aread_tpu_torch.train.checkpoint import (load_checkpoint, local_state,
                                              mask_template, restore_tree_,
                                              set_generator_state)
from aread_tpu_torch.train.trainer import (TABLE_L2, Trainer,
                                           adopt_state_dict,
                                           bce_with_logits,
                                           clip_scale_by_global_norm,
                                           clone_state,
                                           device_data_mode_enabled,
                                           embed_lookup_ctx,
                                           hybrid_init, hybrid_update_sparse,
                                           make_optimizer, masked_mean,
                                           mean_losses, raise_if_nonfinite,
                                           restored_best, split_table,
                                           strip_table_rule, sum_over_data,
                                           sum_states_over_data,
                                           table_reg_value)
from aread_tpu_torch.utils import profiling
from aread_tpu_torch.utils.masks import HempMaskState, prune_mask
from aread_tpu_torch.utils.runlog import RunLogger

log = logging.getLogger(__name__)

TABLE_KEY = "embedding.table"  # the table's state_dict key

# hemp_fast_adapt='auto' picks the overlay from this many table elements
# (n_rows * E) on. It is the JAX package's selection rule, measured end to
# end on its TPU, not on this card (PERF.md holds the card's crossover);
# it is kept so that one config picks the same engine, and so the same
# numbers on a bf16 table, in both packages.
OVERLAY_AUTO_MIN_ELEMS = 240_000_000


def overlay_mode_enabled(mode: str, sparse_table_grad: bool,
                         spec: FeatureSpec, embed_dim: int,
                         mesh=None) -> bool:
    """Whether ``hemp_fast_adapt=mode`` runs the overlay engine for a
    table of ``spec``'s rows (padded as the model pads them) x
    ``embed_dim``: 'full' never, 'overlay' always (it needs
    ``sparse_table_grad`` and no mesh, else ``ValueError``), 'auto' from
    ``OVERLAY_AUTO_MIN_ELEMS`` table elements on when the gradient is
    sparse and there is no mesh."""
    if mode == "full":
        return False
    if mode == "overlay":
        if mesh is not None:
            raise ValueError(
                "hemp_fast_adapt='overlay' is single-device only (mesh "
                "evolutions use the sharded full sweep); use 'auto' or "
                "'full' on mesh runs")
        if not sparse_table_grad:
            raise ValueError(
                "hemp_fast_adapt='overlay' requires sparse_table_grad")
        return True
    if mode != "auto":
        raise ValueError(f"hemp_fast_adapt={mode!r}")
    elems = int(np.sum(spec.one_hot_dims)) * embed_dim
    return (mesh is None and sparse_table_grad
            and elems >= OVERLAY_AUTO_MIN_ELEMS)


def copy_masks(masks) -> List:
    """Per-domain masks (None = no mask yet) as fresh boolean arrays."""
    return [None if m is None else [np.array(mm, dtype=bool) for mm in m]
            for m in masks]


def gather_batch(dxc: torch.Tensor, dyc: torch.Tensor,
                 idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A batch from the device-resident split by row ids (``idx`` [bs]
    int32, -1 = padding), with ``pad_batch``'s semantics: pad rows
    replicate the batch's first row (padding is a suffix), y zeros, the
    validity mask."""
    valid = (idx >= 0).to(torch.float32)
    gidx = torch.where(idx < 0, idx[0], idx).to(torch.int64)
    return {"x": dxc[gidx], "y": dyc[gidx].to(torch.float32) * valid,
            "valid": valid}


def prob_bce(prob, y, valid):
    """Masked mean BCE on a probability."""
    prob = torch.clamp(prob, 1e-7, 1 - 1e-7)
    return masked_mean(-(y * torch.log(prob) + (1 - y) * torch.log1p(-prob)),
                       valid)


class AREADTrainer:
    def __init__(self, model: AREAD, config: Config, n_domain: int,
                 mesh=None):
        if config.table_optimizer not in ("adam", "lazy_adam"):
            raise ValueError(f"table_optimizer={config.table_optimizer!r}")
        self.model = model
        self.config = config
        self.n_domain = n_domain
        # a (data, model) rank grid (parallel/mesh.py): the table is cut to
        # this rank's rows here, unless it is already
        self.mesh = mesh
        if mesh is not None:
            from aread_tpu_torch.parallel.train_step import shard_params
            shard_params(model, mesh)
        self._lookup_ctx = embed_lookup_ctx(config, mesh, model)
        self.device = model.device
        self.mask_state = HempMaskState(model.n_tower, n_domain,
                                        seed=config.seed)
        self.optimizer = make_optimizer(config.lr, config.wd)
        self.fast_optimizer = make_optimizer(config.update_lr, config.wd)
        self.final_optimizer = make_optimizer(config.final_lr, config.wd)
        # HEMP schedule state
        self.random_modify_sigma = config.random_modify_sigma
        self.init_active_percent = config.init_active_percent
        self.candidate_mask_num = float(config.candidate_mask_num)
        self.regroup_times = 0
        # one record per evolution: seconds, chains, candidates per domain
        # and the active ratio it left
        self.regroup_log: List[Dict] = []
        # early stopping
        self.trial_counter = 0
        self.best_auc, self.best_mean_auc = 0.0, 0.0
        self.best_checkpoint = None
        self._improved = False
        # dropout's stream
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        # the table's L2 gradient is folded into its Adam update
        self.reg_rules = strip_table_rule(type(model).REG_RULES)
        self.opt_state: Optional[Dict] = None
        # the chains' optimizer state: allocated once, zeroed per chain
        self._fast_state: Optional[Dict] = None
        self._device_data = None  # (dxc, dyc, aug_offset)
        self._epoch_examples = 0  # rows stepped in the running epoch
        # host clock per step: the launches, since no step synchronises
        self.step_timer = profiling.StepTimer()
        # fail on a hemp_fast_adapt misconfiguration now, not at the first
        # regroup, a warm-up into the first epoch
        overlay = self.overlay_enabled()
        log.info("hemp_fast_adapt=%r: fast-adapt chains run the %s engine",
                 config.hemp_fast_adapt, "overlay" if overlay else "full-sweep")

    def overlay_enabled(self) -> bool:
        """Resolve ``config.hemp_fast_adapt`` for this model
        (``overlay_mode_enabled``)."""
        return overlay_mode_enabled(self.config.hemp_fast_adapt,
                                    self.config.sparse_table_grad,
                                    self.model.spec,
                                    self.model.embedding.embed_dim, self.mesh)

    # the mesh plumbing is the generic trainer's
    run_ctx = Trainer.run_ctx
    place = Trainer.place
    gather_rows = Trainer.gather_rows
    save = Trainer.save

    # ---------------------------------------------------------------- state
    def init(self) -> Dict:
        """Optimizer state for the model's current weights (the model's
        weights are drawn from its seed when it is built)."""
        self.opt_state = hybrid_init(
            self.optimizer, self.model,
            moments_dtype=self.config.table_moments_dtype)
        return self.opt_state

    def _snapshot(self, table: bool = True) -> Dict[str, torch.Tensor]:
        """A device-resident copy of the parameters, the table (unless
        ``table`` is False) and the BatchNorm statistics."""
        if table:
            return clone_state(self.model)
        return {k: v.clone() for k, v in self.model.state_dict().items()
                if k != TABLE_KEY}

    @torch.no_grad()
    def _restore(self, snap: Dict[str, torch.Tensor]) -> None:
        """Copy a snapshot back into the live tensors it holds, in place."""
        live = self.model.state_dict()
        torch._foreach_copy_([live[k] for k in snap], list(snap.values()))

    def _fresh_fast_state(self, table: bool = True) -> Dict:
        """The chains' optimizer state with zero moments and t = 0: one
        allocation for the whole run, zeroed in place for every candidate.
        With ``table`` it holds the table's moments (two table-sized
        tensors, the full sweep's); an overlay chain's table moments are
        its compact ones, so without ``table`` only the dense leaves'."""
        st = self._fast_state
        if st is None or (table and "m" not in st):
            if table:
                st = hybrid_init(self.fast_optimizer, self.model,
                                 moments_dtype=self.config.table_moments_dtype)
            else:
                _, rest = split_table(self.model)
                st = {"inner": self.fast_optimizer.init(rest), "t": 0}
            self._fast_state = st
            return st
        inner = st["inner"]
        torch._foreach_zero_(list(inner["mu"].values())
                             + list(inner["nu"].values())
                             + ([st["m"], st["v"]] if table else []))
        inner["count"] = 0
        st["t"] = 0
        return st

    # ----------------------------------------------------------------- step
    def bagging_loss(self, batch, dm, mode: str, train: bool = True):
        """(loss, model output). 'wo_mask' trains on the mean-prob
        prediction and 'domain_mask_final' on the gate-mixed one; the
        bagging mode on the mean of per-leaf BCEs over the active
        leaves."""
        out = self.model(batch["x"], domain_mask=dm, mode=mode, train=train,
                         mask=batch["valid"], generator=self.generator,
                         tap=mode != "domain_mask_final")
        y, valid = batch["y"], batch["valid"]
        if mode in ("wo_mask", "domain_mask_final"):
            bce = prob_bce(out["prob"], y, valid)
        else:
            # [T_last]; on a mesh the rank's share (the global count)
            per_leaf = (torch.sum(bce_with_logits(out["leaf_logit"], y[:, None])
                                  * valid[:, None], dim=0)
                        / torch.clamp(mesh_lib.batch_sum(torch.sum(valid)),
                                      min=1.0))
            la = out["leaf_active"].to(per_leaf.dtype)
            bce = torch.sum(per_leaf * la) / torch.clamp(la.sum(), min=1e-8)
        if self.mesh is not None and self.mesh.data_index != 0:
            return bce, out  # the data ranks' losses are summed: L2 once
        _, rest = split_table(self.model)
        loss = bce + regularization_loss(rest, self.reg_rules)
        return loss, out

    def step_core(self, optimizer, lr: float, opt_state: Dict, mode: str,
                  batch, dm) -> Tuple[torch.Tensor, Tuple]:
        """One training step in place with the given optimizer, learning
        rate and optimizer state. Returns (reported loss, gate means);
        neither is fetched to the host."""
        cfg = self.config
        if isinstance(batch["x"], np.ndarray):
            batch = self.place(batch)
        self.model.train()
        _, rest = split_table(self.model)
        names = list(rest)
        with matmul_precision_ctx(cfg.compute_dtype), self.run_ctx():
            loss, out = self.bagging_loss(batch, dm, mode)
            # leaves a mode does not use get zero gradients, as in JAX
            # (the decay term still moves them)
            grads = torch.autograd.grad(
                loss, [rest[n] for n in names] + [out["rows"]],
                materialize_grads=True)
        g_rest = dict(zip(names, grads[:-1]))
        ids, row_grads = self.model.embedding.table_ids(batch["x"]), grads[-1]
        loss = loss.detach()
        if self.mesh is not None:
            g_rest, loss, ids, row_grads = sum_over_data(
                self.mesh, g_rest, loss, ids, row_grads)
        l2val = hybrid_update_sparse(
            optimizer, lr, cfg.wd, self.model, g_rest, ids, row_grads,
            opt_state, want_table_l2=cfg.loss_report_table_l2,
            clip_norm=cfg.grad_clip_norm,
            lazy=cfg.table_optimizer == "lazy_adam", mesh=self.mesh)
        if l2val is not None:
            loss = loss + l2val
        return loss, out["gate_means"]

    def _main_state(self) -> Dict:
        if self.opt_state is None:
            raise RuntimeError("call init() before stepping")
        return self.opt_state

    def warmup_step(self, batch):
        return self.step_core(self.optimizer, self.config.lr,
                              self._main_state(), "wo_mask", batch, None)

    def main_step(self, batch, dm: Sequence[np.ndarray]):
        return self.step_core(self.optimizer, self.config.lr,
                              self._main_state(), "domain_mask_bagging",
                              batch, dm)

    def final_core(self, opt_state: Dict, batch, dm):
        """One final-gate step: only the ``final_gate`` leaf is in the
        optimizer. The body is frozen in the loss (detached inside the
        model's 'domain_mask_final' mode) and must be frozen in the
        optimizer too: an Adam over the whole tree would walk every frozen
        weight toward zero at about final_lr per step (zero data gradient
        plus the tiny decay term normalizes to a full-lr signed step).
        ``opt_state`` is ``final_optimizer.init`` of that one leaf."""
        cfg = self.config
        if isinstance(batch["x"], np.ndarray):
            batch = self.place(batch)
        self.model.train()
        leaf = {"final_gate/kernel": self.model.final_gate.kernel}
        with matmul_precision_ctx(cfg.compute_dtype), self.run_ctx():
            loss, out = self.bagging_loss(batch, dm, "domain_mask_final")
            (g,) = torch.autograd.grad(loss, list(leaf.values()))
        loss = loss.detach()
        if self.mesh is not None:
            both = self.mesh.all_reduce_(
                torch.cat([g.reshape(-1), loss.reshape(1)]), "data")
            g, loss = both[:-1].view_as(g), both[-1]
        if cfg.loss_report_table_l2:
            loss = loss + table_reg_value(self.model.embedding.table,
                                          self.mesh)
        self.final_optimizer.update_(leaf, {"final_gate/kernel": g}, opt_state)
        return loss, out["gate_means"]

    # ---------------------------------------------------------- device data
    def device_data_enabled(self, train_x: np.ndarray,
                            aug_x: np.ndarray) -> bool:
        """``config.device_data`` for the HEMP path: the train and the
        augmented split together must fit the budget."""
        total = train_x.nbytes + (0 if aug_x is train_x else aug_x.nbytes)
        return device_data_mode_enabled(self.config, total,
                                        Trainer.DEVICE_DATA_BUDGET, self.mesh)

    def stage_device_data(self, train_x, train_y, aug_x, aug_y) -> bool:
        """Place [train; augmented] on the device as one array when
        ``config.device_data`` allows; returns whether the device-resident
        path is active. Augmented row ids shift by the train length (no
        shift when the splits are one array: no augmentation)."""
        self._device_data = None
        if not self.device_data_enabled(train_x, aug_x):
            return False
        if aug_x is train_x:
            xc, yc, aug_off = train_x, train_y, 0
        else:
            xc = np.concatenate([train_x, aug_x])
            yc = np.concatenate([train_y, aug_y])
            aug_off = train_x.shape[0]
        self._device_data = (
            torch.as_tensor(np.ascontiguousarray(xc), device=self.device),
            torch.as_tensor(np.ascontiguousarray(yc), device=self.device),
            aug_off)
        return True

    def _batch(self, batcher: DomainBatcher, idx: np.ndarray,
               offset: int = 0) -> Dict[str, torch.Tensor]:
        """The batch of ``batcher``'s rows ``idx`` (-1 = padding) on the
        device: gathered from the resident split (``offset`` shifts the
        augmented rows' ids) or staged from the host arrays. The two are
        the same batch."""
        if self._device_data is not None:
            dxc, dyc, _ = self._device_data
            if offset:
                idx = np.where(idx >= 0, idx + offset, -1).astype(np.int32)
            return gather_batch(dxc, dyc,
                                torch.as_tensor(idx, device=self.device))
        sel = idx[idx >= 0]
        return self.place(pad_batch(batcher.x[sel], batcher.y[sel],
                                    self.config.bs))

    # ------------------------------------------------------------ evolution
    def _prune(self, mask, gate_means):
        """The chain's progressive prune, on the host: one fetch of the
        step's gate means (90 floats at Amazon width; the host waits for
        the device, which a host-bound step leaves nearly idle anyway) and
        numpy. The tensor twin (``utils.masks.prune_mask_tensor``) gives
        the same mask without the wait but costs some 90 small launches;
        timed alone on the H100 it is the dearer one, and inside a chain
        the two cannot be told apart (chip_smoke.py, phase hemp, times
        both; PERF.md)."""
        return prune_mask(mask, [g.cpu().numpy() for g in gate_means],
                          prun_ratio=0.05)

    def _place_mask(self, mask) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(m, device=self.device) for m in mask)

    def _probe_losses(self, dm, probe_batches) -> torch.Tensor:
        """[regroup_eval_step] no-grad probe losses (BCE on the
        'domain_with_mask' prob) of the weights the model holds; on a mesh
        summed over 'data', so that every rank holds the same numbers."""
        self.model.eval()
        with torch.no_grad(), matmul_precision_ctx(self.config.compute_dtype), \
                self.run_ctx():
            losses = torch.stack([
                prob_bce(self.model(b["x"], domain_mask=dm,
                                    mode="domain_with_mask",
                                    train=False)["prob"], b["y"], b["valid"])
                for b in probe_batches])
        if self.mesh is not None:
            self.mesh.all_reduce_(losses, "data")
        return losses

    def _fast_adapt(self, mask, fa_batches, probe_batches, drift_l2=None):
        """One candidate's chain from the weights the model holds: a fresh
        fast-Adam state, a bagging step at ``update_lr`` per adapt batch
        with a progressive prune of the mask after each, then one no-grad
        probe per probe batch in 'domain_with_mask' mode. Returns (the
        pruned mask, the probe losses [regroup_eval_step] on the device).
        The weights, the BatchNorm statistics and a bf16 table's rounding
        are left as the chain moved them: the caller restores. With
        ``drift_l2`` (the regroup's ``drift_table_l2``) the chain runs the
        overlay engine (``_fast_adapt_overlay``)."""
        if drift_l2 is not None:
            return self._fast_adapt_overlay(mask, fa_batches, probe_batches,
                                            drift_l2)
        cfg = self.config
        state = self._fresh_fast_state()
        # uploaded once per prune, not once per forward
        dm = self._place_mask(mask)
        for batch in fa_batches:
            _, gms = self.step_core(self.fast_optimizer, cfg.update_lr, state,
                                    "domain_mask_bagging", batch, dm)
            mask = self._prune(mask, gms)
            dm = self._place_mask(mask)
        with torch.no_grad():
            table, rest = split_table(self.model)
            # constant across the probes (the weights are fixed now): the
            # table's term is a pass over the whole table, paid once
            reg = (regularization_loss(rest, self.reg_rules)
                   + table_reg_value(table, self.mesh))
        return mask, self._probe_losses(dm, probe_batches) + reg

    def _fast_adapt_overlay(self, mask, fa_batches, probe_batches,
                            drift_l2: torch.Tensor):
        """``_fast_adapt`` on the overlay engine (``ops/overlay_adam.py``):
        the table's side of the chain is a compact f32 copy of the rows
        the adapt batches gather, stepped by the fused dense Adam from the
        deduplicated row gradients, with a prune after every step; the
        dense leaves step through ``fast_optimizer`` as in the full sweep.
        The probes read the working set's chain values and every other row
        drifted by S decay-only steps, and their table L2 term is
        ``drift_l2`` corrected to this working set. The live table is
        never written."""
        cfg = self.config
        model = self.model
        emb = model.embedding
        table = emb.table
        hyper = dict(lr=cfg.update_lr, wd=cfg.wd, l2=TABLE_L2)
        state = self._fresh_fast_state(table=False)
        ws = oa.build_working_set(emb, torch.stack([b["x"]
                                                    for b in fa_batches]))
        w, m, v = oa.overlay_init(table, ws)
        _, rest = split_table(model)
        names = list(rest)
        dm = self._place_mask(mask)
        # w is stepped in place: the lookup reads the chain's values
        with emb.lookup_override(functools.partial(
                oa.overlay_gather, ws=ws, wvals=w, drift_steps=0, **hyper)):
            for batch in fa_batches:
                model.train()
                with matmul_precision_ctx(cfg.compute_dtype):
                    loss, out = self.bagging_loss(batch, dm,
                                                  "domain_mask_bagging")
                    grads = torch.autograd.grad(
                        loss, [rest[n] for n in names] + [out["rows"]],
                        materialize_grads=True)
                g_rest = dict(zip(names, grads[:-1]))
                ids = emb.table_ids(batch["x"]).reshape(-1)
                uids, gsum = dedup_rows(
                    ids.to(torch.int32),
                    grads[-1].reshape(-1, grads[-1].shape[-1]),
                    table.shape[0])
                scale = clip_scale_by_global_norm(
                    list(g_rest.values()) + [gsum], cfg.grad_clip_norm)
                if scale is not None:
                    g_rest = {n: g * scale for n, g in g_rest.items()}
                    gsum = gsum * scale
                state["t"] += 1
                oa.overlay_adam_step(w, m, v, oa.compact_grad(ws, uids, gsum),
                                     state["t"], **hyper)
                self.fast_optimizer.update_(rest, g_rest, state["inner"])
                mask = self._prune(mask, out["gate_means"])
                dm = self._place_mask(mask)
        S = len(fa_batches)
        with emb.lookup_override(functools.partial(
                oa.overlay_gather, ws=ws, wvals=w, drift_steps=S, **hyper)):
            losses = self._probe_losses(dm, probe_batches)
        with torch.no_grad():
            reg = (regularization_loss(rest, self.reg_rules)
                   + TABLE_L2 * (drift_l2 + oa.overlay_l2_correction(
                       table, ws, w, S, **hyper)))
        return mask, losses + reg

    def _mask_evolution(self, train_batcher: DomainBatcher,
                        aug_batcher: DomainBatcher,
                        verbose: bool = True) -> None:
        """HEMP candidate generation, fast adaptation, probes and
        selection. Every candidate's chain starts from the snapshot taken
        here; the weights and statistics are restored at the end, and the
        main optimizer's state is never touched."""
        cfg = self.config
        ms = self.mask_state
        overlay = self.overlay_enabled()
        # an overlay chain never writes the live table
        snap = self._snapshot(table=not overlay)
        self.random_modify_sigma *= 0.99
        self.init_active_percent = max(0.1, self.init_active_percent * 0.95)
        self.candidate_mask_num *= 0.99
        n_cand = max(1, int(self.candidate_mask_num))
        self.regroup_times += 1
        if verbose:
            print(f"regroup {self.regroup_times}: sigma={self.random_modify_sigma:.4f} "
                  f"active%={self.init_active_percent:.3f} candidates={n_cand}")
        t0 = time.time()
        # the overlay's whole-table drift L2: the same for every chain
        drift_l2 = (oa.drift_table_l2(
            self.model.embedding.table, cfg.regroup_update_step,
            cfg.update_lr, cfg.wd, TABLE_L2) if overlay else None)
        aug_off = self._device_data[2] if self._device_data is not None else 0
        cand_index: List[Tuple[int, int]] = []
        out_masks, out_losses = [], []
        # the numpy streams (mask generator, both batchers) are drawn
        # domain-major, a candidate's mask, then its adapt batches, then
        # its probe batches: the JAX package's staging order
        for d in range(self.n_domain):
            # a domain the augmented rows do not cover adapts on its train
            # rows
            use_aug = len(aug_batcher.domain_indices[d]) > 0
            fa_batcher = aug_batcher if use_aug else train_batcher
            for z in range(n_cand):
                mask = ms.generate_mask(
                    "mask_max_gate", d,
                    init_active_percent=self.init_active_percent,
                    random_modify_sigma=self.random_modify_sigma)
                fa = [self._batch(fa_batcher, fa_batcher.next_batch_indices(d),
                                  aug_off if use_aug else 0)
                      for _ in range(cfg.regroup_update_step)]
                probes = [self._batch(train_batcher,
                                      train_batcher.next_batch_indices(d))
                          for _ in range(cfg.regroup_eval_step)]
                if cand_index:
                    self._restore(snap)
                mask, losses = self._fast_adapt(mask, fa, probes, drift_l2)
                out_masks.append(mask)
                out_losses.append(losses)
                cand_index.append((d, z))
        # one fetch for the whole regroup
        all_losses = torch.stack(out_losses).cpu().numpy()
        for i, (d, z) in enumerate(cand_index):
            ms.candidate_domain_mask[d].append(out_masks[i])
            for loss in all_losses[i]:
                ms.add_eval_loss(float(loss), d=d, mask_z=z)
        ms.update_all_mask()
        self._restore(snap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.time() - t0
        self.regroup_log.append({
            "seconds": seconds, "chains": len(cand_index),
            "candidates": n_cand, "overlay": overlay,
            "active_ratio": ms.current_active_ratio()})
        if verbose:
            print(f"mask evolution took {seconds:.1f}s; "
                  f"active ratio {ms.current_active_ratio():.3f}")
        ms.reset_for_mask_update()

    # --------------------------------------------------------------- epochs
    def train_epoch(self, epoch_i: int, train_batcher: DomainBatcher,
                    aug_batcher: DomainBatcher, verbose: bool = True) -> float:
        """One pass over the train batcher's domain sequence; at epoch 0 a
        warm-up first ('wo_mask', round-robin over the domains, gate means
        recorded) and an evolution right after it; an evolution at every
        regroup point; gate means recorded in the warm_up_interval steps
        before each. Returns the mean loss of the bagging steps."""
        cfg = self.config
        ms = self.mask_state
        warm_up_interval = (cfg.warm_up_interval * 1024) // cfg.bs
        regroup_interval = max(1, (cfg.regroup_interval * 1024) // cfg.bs)
        losses: List[torch.Tensor] = []
        recorded: List[Tuple[int, Tuple]] = []
        self._epoch_examples = 0

        def flush_records():
            # the gate means wait on the device until a regroup needs them
            for d, gms in recorded:
                ms.record_gates(d, [g.cpu().numpy() for g in gms])
            recorded.clear()

        def step(kind, d, mask, record):
            idx = train_batcher.next_batch_indices(d)
            n_ex = int((idx >= 0).sum())
            self._epoch_examples += n_ex
            with self.step_timer.step(n_examples=n_ex):
                batch = self._batch(train_batcher, idx)
                loss, gms = (self.warmup_step(batch) if kind == "warmup"
                             else self.main_step(batch, mask))
            losses.append(loss)
            if record:
                recorded.append((d, gms))

        if epoch_i == 0:
            domain_list: List[int] = []
            for _ in range(warm_up_interval):
                if not domain_list:
                    domain_list = list(range(self.n_domain))
                step("warmup", domain_list.pop(), None, True)
            losses.clear()  # warm-up losses are not epoch losses

        with profiling.trace():  # a no-op unless AREAD_TPU_TRACE is set
            for i, d in enumerate(train_batcher.domain_batch_seq):
                if (epoch_i == 0 and i == 0) or (
                        (i + 1) % regroup_interval == 0):
                    flush_records()
                    with profiling.annotate("hemp_mask_evolution"):
                        self._mask_evolution(train_batcher, aug_batcher,
                                             verbose)
                record = ((i + 1) // regroup_interval
                          - (i + 1 + warm_up_interval) // regroup_interval) > 0
                step("main", d, ms.domain_mask[d], record)
        flush_records()
        return mean_losses(losses)

    def train_final_epoch(self, opt_state: Dict, epoch_i: int,
                          train_batcher: DomainBatcher,
                          verbose: bool = True) -> float:
        """One final-gate epoch: the body frozen, BCE on the gate-mixed
        prob; every domain is in the sequence at least once."""
        ms = self.mask_state
        seq = list(train_batcher.domain_batch_seq)
        present = set(seq)
        seq.extend(d for d in range(self.n_domain) if d not in present)
        losses = []
        for d in seq:
            batch_np = train_batcher.next_batch(d)
            with self.step_timer.step(
                    n_examples=int(batch_np["valid"].sum())):
                loss, _ = self.final_core(opt_state, self.place(batch_np),
                                          ms.domain_mask[d])
            losses.append(loss)
        return mean_losses(losses)

    # ----------------------------------------------------------- evaluation
    @torch.no_grad()
    def eval_prob_logit(self, batch, dm, final: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        self.model.eval()
        mode = "domain_mask_final" if final else "domain_with_mask"
        with self.run_ctx():
            out = self.model(batch["x"], domain_mask=dm, mode=mode,
                             train=False)
        return out["prob"], out["logit"]

    def eval_prob(self, batch, dm, final: bool = False) -> torch.Tensor:
        return self.eval_prob_logit(batch, dm, final)[0]

    def evaluate(self, batcher: DomainBatcher,
                 domain_cnt_weight: np.ndarray, final: bool = False) -> Dict:
        """One pass over ``batcher.domain_batch_seq``, each batch through
        its domain's current mask (``final``: and the trained final gate);
        total and per-domain AUC / log-loss. With
        ``config.streaming_eval`` the predictions stay on the device: each
        batch goes into per-domain histograms (``StreamingAUC``) and only
        those are fetched. On a mesh each rank scores its rows, and the
        predictions are all-gathered (the histograms summed) over 'data'."""
        ms = self.mask_state
        if self.config.streaming_eval:
            acc = metrics_lib.StreamingAUC(self.n_domain, self.config.auc_bins)
            auc_state = acc.init_state(self.device)
            for d in batcher.domain_batch_seq:
                batch = self.place(batcher.next_batch(d))
                prob, logit = self.eval_prob_logit(batch, ms.domain_mask[d],
                                                   final=final)
                auc_state = acc.update(auc_state, prob, batch["y"],
                                       batch["domain"], batch["valid"],
                                       logits=logit)
            return acc.finalize(
                sum_states_over_data(self.mesh, auc_state), domain_cnt_weight,
                multi_domain=self.config.is_evaluate_multi_domain)
        preds, targets, domains = [], [], []
        for d in batcher.domain_batch_seq:
            batch_np = batcher.next_batch(d)
            prob = self.gather_rows(self.eval_prob(
                self.place(batch_np), ms.domain_mask[d], final=final))
            n = int(batch_np["valid"].sum())
            preds.append(prob[:n])
            targets.append(batch_np["y"][:n])
            domains.append(np.full((n,), d, np.int64))
        return metrics_lib.full_evaluation(
            np.concatenate(targets), torch.cat(preds).cpu().numpy(),
            np.concatenate(domains), domain_cnt_weight,
            multi_domain=self.config.is_evaluate_multi_domain)

    def _copy_masks(self) -> List:
        return copy_masks(self.mask_state.domain_mask)

    def is_continuable(self, result: Dict, epoch_i: int) -> bool:
        """Early stopping on mean_auc (total_auc when that is missing or
        NaN) with patience ``config.early_stop``; an improvement keeps a
        device copy of the weights and a copy of the masks."""
        key = ("mean_auc" if "mean_auc" in result
               and not np.isnan(result["mean_auc"]) else "total_auc")
        best = self.best_mean_auc if key == "mean_auc" else self.best_auc
        self._improved = result[key] > best
        if self._improved:
            self.trial_counter = 0
            self.best_auc = result["total_auc"]
            if "mean_auc" in result:
                self.best_mean_auc = result["mean_auc"]
            self.best_checkpoint = (self._snapshot(), self._copy_masks(),
                                    epoch_i)
            return True
        if self.trial_counter + 1 < self.config.early_stop:
            self.trial_counter += 1
            return True
        return False

    def _load_best(self) -> None:
        if self.best_checkpoint is not None:
            snap, masks, _ = self.best_checkpoint
            self._restore(snap)
            self.mask_state.domain_mask = copy_masks(masks)

    def hemp_schedule(self) -> Dict:
        """The HEMP schedule as it stands: what the evolutions so far have
        decayed, and their count."""
        return {"random_modify_sigma": self.random_modify_sigma,
                "init_active_percent": self.init_active_percent,
                "candidate_mask_num": self.candidate_mask_num,
                "regroup_times": self.regroup_times}

    def _resume(self, ckpt_dir: str, verbose: bool,
                train_b: DomainBatcher, aug_b: DomainBatcher) -> int:
        """Take up a run from its resumable checkpoint: weights, optimizer
        state and dropout generator in place, masks, HEMP schedule, best
        metrics, and the host-side streams (both batchers, the mask
        generator and its waiting gate records) where the checkpoint
        holds them. Returns the epoch to go on from."""
        ck = load_checkpoint(ckpt_dir, n_domain=self.n_domain,
                             map_location=self.device)
        template = mask_template(self.model.n_tower, self.n_domain)
        masks = ck.get("domain_mask")
        if masks is None or any(m is None for m in masks) or any(
                mm.shape != template[f"d{d}_l{li}"].shape
                for d, m in enumerate(masks) for li, mm in enumerate(m)):
            raise ValueError(
                f"{ckpt_dir}: the checkpoint's domain masks do not fit "
                f"n_tower={self.model.n_tower}, n_domain={self.n_domain}")
        sd, opt = local_state(ck["state_dict"], ck["opt_state"], self.mesh)
        adopt_state_dict(self.model, sd)
        restore_tree_(self.opt_state, opt, "opt_state")
        set_generator_state(self.generator, ck["rng_state"])
        self.mask_state.domain_mask = copy_masks(masks)
        host = ck.get("host_state")
        if host is not None:
            train_b.set_state(host["train_batcher"])
            aug_b.set_state(host["aug_batcher"])
            self.mask_state.set_state(host["mask_state"])
        start_epoch = int(ck["epoch"])
        sched = ck.get("hemp_schedule") or {}
        self.random_modify_sigma = sched.get(
            "random_modify_sigma", self.random_modify_sigma)
        self.init_active_percent = sched.get(
            "init_active_percent", self.init_active_percent)
        self.candidate_mask_num = sched.get(
            "candidate_mask_num", self.candidate_mask_num)
        self.regroup_times = int(sched.get("regroup_times", 0))
        best = restored_best(ck)
        self.best_auc, self.best_mean_auc = (best["best_auc"],
                                             best["best_mean_auc"])
        self.best_checkpoint = (self._snapshot(), copy_masks(masks),
                                start_epoch - 1)
        if verbose:
            print(f"elastic resume from {ckpt_dir} at epoch {start_epoch} "
                  f"(regroups so far: {self.regroup_times})")
        return start_epoch

    def fit(self, data: SplitData, epochs: Optional[int] = None,
            verbose: bool = True, final_gate: Optional[bool] = None,
            warm_start: Optional[Dict] = None,
            ckpt_dir: Optional[str] = None) -> Dict:
        """Train up to ``epochs`` (default ``config.epoch``) epochs with
        mask evolution and early stopping on the valid split, then, with
        ``final_gate`` (default ``config.aread_final``), the final-gate
        phase: a fresh Adam at ``final_lr`` over ``final_gate`` alone, up
        to ``epochs`` (default ``config.final_epoch``) epochs with the
        patience counter reset. The test split is evaluated on the best
        weights and masks, which the model and the mask state are left
        holding. Returns {'history', 'test', 'domain_mask'}.

        ``warm_start``: a checkpoint dict (``load_checkpoint``) whose
        weights and buffers replace the model's and whose domain masks,
        where it has any, replace the mask state's; the optimizer starts
        fresh.

        ``ckpt_dir``: a resumable checkpoint (weights, optimizer state,
        domain masks, the decayed HEMP schedule, dropout generator, epoch,
        best metrics, and the host-side streams: both batchers' positions,
        the mask generator's and the gate records waiting for the next
        regroup) is written there on every improvement, and when one
        exists training resumes from it at the saved epoch: the resumed
        epochs repeat what the uninterrupted run would have done. A
        checkpoint without the host-side streams (one carried over from
        the JAX package, whose checkpoints hold none) resumes with them
        restarted from the seed, as the JAX package resumes.

        ``config.log_dir``: each main epoch's valid result and the test
        result go to a ``RunLogger``. ``config.epoch_timeout_s``: each main
        train epoch runs under the watchdog."""
        try:
            with RunLogger(self.config.log_dir or None,
                           config=self.config) as logger:
                return self._fit_inner(data, epochs, verbose, final_gate,
                                       warm_start, ckpt_dir, logger)
        finally:
            # release the resident split even when an epoch fails
            self._device_data = None

    def _fit_inner(self, data: SplitData, epochs, verbose, final_gate,
                   warm_start, ckpt_dir, logger: RunLogger) -> Dict:
        cfg = self.config
        final_gate = cfg.aread_final if final_gate is None else final_gate
        didx = data.spec.domain_idx
        train_b = DomainBatcher(data.train_x, data.train_y, cfg.bs, didx,
                                self.n_domain, seed=cfg.seed)
        # evaluation normalizes with the running statistics, so the batch
        # size does not change the predictions; bigger batches cut launches
        eval_bs = cfg.bs * 8
        valid_b = DomainBatcher(data.valid_x, data.valid_y, eval_bs, didx,
                                self.n_domain, shuffle=False, seed=cfg.seed)
        test_b = DomainBatcher(data.test_x, data.test_y, eval_bs, didx,
                               self.n_domain, shuffle=False, seed=cfg.seed)
        aug_x = data.aug_train_x if data.aug_train_x is not None else data.train_x
        aug_y = data.aug_train_y if data.aug_train_y is not None else data.train_y
        aug_b = DomainBatcher(aug_x, aug_y, cfg.bs, didx, self.n_domain,
                              seed=cfg.seed + 1)
        self.stage_device_data(data.train_x, data.train_y, aug_x, aug_y)
        # the a2a capacity before the first step: train and augmented
        # batches, and the 8x eval batches
        cfg.a2a_capacity = resolve_a2a_capacity(
            cfg, self.mesh, self.model.spec, self.model.embed_dim,
            [(data.train_x, cfg.bs), (aug_x, cfg.bs),
             (data.valid_x, eval_bs), (data.test_x, eval_bs)],
            verbose=verbose)
        self._lookup_ctx = embed_lookup_ctx(cfg, self.mesh, self.model)
        # the JAX package draws one batch of the largest domain to shape
        # its weights; drawn here too, so that the data streams agree
        train_b.next_batch_indices(
            int(np.argmax([len(i) for i in train_b.domain_indices])))
        self.init()
        if warm_start is not None:
            adopt_state_dict(self.model, local_state(
                warm_start["state_dict"], None, self.mesh)[0])
            if warm_start.get("domain_mask"):
                self.mask_state.domain_mask = copy_masks(
                    warm_start["domain_mask"])
        start_epoch = 0
        if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "meta.json")):
            start_epoch = self._resume(ckpt_dir, verbose, train_b, aug_b)

        history = []
        for epoch_i in range(start_epoch,
                             epochs if epochs is not None else cfg.epoch):
            t0 = time.time()
            with watchdog(epoch_deadline(cfg.epoch_timeout_s,
                                         cfg.epoch_timeout_first_mult),
                          tag=f"aread_epoch{epoch_i}",
                          kill_process=cfg.epoch_timeout_kill):
                train_loss = self.train_epoch(epoch_i, train_b, aug_b,
                                              verbose)
            train_s = time.time() - t0
            raise_if_nonfinite(train_loss, epoch_i, cfg)
            train_b.shuffle_seq()
            result = self.evaluate(valid_b, data.domain_cnt_weight)
            result["train_loss"] = train_loss
            result["epoch_time_s"] = time.time() - t0
            # evolutions included; the epoch's seconds end in the fetch of
            # its losses (a StepTimer around an unsynchronised step would
            # time the launches)
            result["examples_per_s"] = self._epoch_examples / train_s
            history.append(result)
            logger.log({"valid": result}, step=epoch_i + 1)
            if verbose:
                print(f"epoch {epoch_i + 1}: train_loss={train_loss:.4f} "
                      f"valid auc={result['total_auc']:.4f} "
                      f"loss={result['total_loss']:.4f} "
                      f"mean_auc={result.get('mean_auc', np.nan):.4f}")
            cont = self.is_continuable(result, epoch_i)
            if ckpt_dir and self._improved:
                if any(m is None for m in self.mask_state.domain_mask):
                    raise RuntimeError("a domain has no mask to checkpoint")
                self.save(
                    ckpt_dir, epoch=epoch_i + 1, best_result=result,
                    generator=self.generator,
                    domain_mask=self.mask_state.domain_mask,
                    hemp_schedule=self.hemp_schedule(),
                    host_state={"train_batcher": train_b.get_state(),
                                "aug_batcher": aug_b.get_state(),
                                "mask_state": self.mask_state.get_state()})
            if not cont:
                break
        self._load_best()

        if final_gate:
            final_state = self.final_optimizer.init(
                {"final_gate/kernel": self.model.final_gate.kernel})
            # the main loop leaves the patience counter exhausted
            self.trial_counter = 0
            for epoch_i in range(epochs if epochs is not None
                                 else cfg.final_epoch):
                t0 = time.time()
                floss = self.train_final_epoch(final_state, epoch_i, train_b,
                                               verbose)
                raise_if_nonfinite(floss, epoch_i, cfg)
                train_b.shuffle_seq()
                result = self.evaluate(valid_b, data.domain_cnt_weight,
                                       final=True)
                result["train_loss"] = floss
                result["epoch_time_s"] = time.time() - t0
                result["phase"] = "final_gate"
                history.append(result)
                if verbose:
                    print(f"final-gate epoch {epoch_i + 1}: train_loss={floss:.4f} "
                          f"valid auc={result['total_auc']:.4f} "
                          f"loss={result['total_loss']:.4f} "
                          f"mean_auc={result.get('mean_auc', np.nan):.4f}")
                if not self.is_continuable(result, epoch_i):
                    break
            self._load_best()

        test_result = self.evaluate(test_b, data.domain_cnt_weight,
                                    final=final_gate)
        logger.log({"test": test_result,
                    "domain_mask_active": [
                        None if m is None else [float(np.mean(mm)) for mm in m]
                        for m in self.mask_state.domain_mask]})
        return {"history": history, "test": test_result,
                "domain_mask": self.mask_state.domain_mask}
