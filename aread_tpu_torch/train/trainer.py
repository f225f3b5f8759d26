"""Loss pieces, the hybrid optimizer and the generic ``Trainer`` of the
zoo models (counterpart of ``aread_tpu/train/trainer.py``).

The reference trains with torch.optim.Adam(lr, betas=(0.9, 0.99),
eps=1e-8, weight_decay=1e-8) and a manual L2 term in the loss. Here the
fused embedding table (~99% of the parameters at Amazon width) takes a
dense-semantics Adam with the weight decay and the table's L2 gradient
folded into the update — from its sparse row gradient
(``hybrid_update_sparse``, ``ops/sparse_adam.py``) or from its dense
gradient (``hybrid_update``, ``ops/fused_adam.py``); every other leaf
takes ``DenseAdam``, the JAX package's optax chain
add_decayed_weights(wd) -> scale_by_adam(0.9, 0.99, 1e-8) -> scale(-lr)
in its expression order.

``Trainer`` is train / evaluate / early stop on the weighted mean AUC for
single-output and multi-tower models: a multi-tower model computes every
tower and the loss gathers the sample's group column. Its options:
``compute_dtype`` (``ops/precision.py``), ``dynamic_regroup`` (the
domain -> group map recomputed between epochs from the valid split's
per-(tower, domain) losses, ``train/regroup.py``), ``log_dir``
(``utils/runlog.py``) and the epoch watchdog (``epoch_timeout_s``,
``parallel/health.py``).

``Trainer(mesh=)`` (``parallel/mesh.py``) runs one rank of a (data, model)
grid, and together the ranks compute what one device computes: the rank
steps on its rows of each global batch, the table is its rows
(``train_step.shard_params``), the loss is the global masked mean (each
rank's masked sum over the all-reduced valid count; the dense leaves'
gradients are summed over 'data'; the L2 terms are added on the first data
rank only), the table's row gradients are all-gathered over 'data' in rank
order and the update runs once per shard — the sparse-Adam kernel with its
own rounding stream (``parallel/sharded_adam.py``), or the fused dense
Adam on the shard's rows of the dense gradient. Evaluation scores the
rank's rows and all-gathers the predictions (or sums the streaming
histograms) over 'data'. The lookup is ``embed_lookup`` ('gspmd': the
shard-select lookup; 'a2a': the dedup + all-to-all exchange, its capacity
resolved before the first step). A checkpoint of a mesh run is written
by rank 0 in the single-device format, with the table gathered.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import GlobalBatcher, SplitData
from aread_tpu_torch.models.base import gather_group, regularization_loss
from aread_tpu_torch.ops.fused_adam import fused_adam_dispatch
from aread_tpu_torch.ops.precision import matmul_precision_ctx
from aread_tpu_torch.ops.sparse_adam import dedup_rows, sparse_adam_dispatch
from aread_tpu_torch.parallel import mesh as mesh_lib
from aread_tpu_torch.parallel.embed_shard import (flat_a2a_lookup,
                                                  resolve_a2a_capacity)
from aread_tpu_torch.parallel.health import barrier, epoch_deadline, watchdog
from aread_tpu_torch.parallel.sharded_adam import sharded_sparse_adam_deduped
from aread_tpu_torch.train import metrics as metrics_lib
from aread_tpu_torch.train.checkpoint import (full_state, load_checkpoint,
                                              local_state, restore_tree_,
                                              save_checkpoint,
                                              set_generator_state)
from aread_tpu_torch.train.regroup import (get_losses_tower_domain,
                                           regroup_all_domain)
from aread_tpu_torch.utils import profiling
from aread_tpu_torch.utils.runlog import RunLogger

MULTI_TOWER_MODELS = ("ple", "mmoe", "pepnet", "epnet", "star", "adl", "hinet")
CONCAT_GROUP_MODELS = ("star", "adl", "hinet")  # forward consumes group

TABLE_RULE = r"^embedding/table$"
TABLE_L2 = 1e-5  # the reference's l2_reg_embedding


def bce_with_logits(logit, y):
    """Numerically stable binary cross-entropy from logits."""
    return (torch.clamp(logit, min=0.0) - logit * y
            + torch.log1p(torch.exp(-torch.abs(logit))))


def masked_mean(values, valid):
    """Mean of ``values`` over the rows where ``valid`` is 1. Under a
    data-parallel mesh (``mesh.use``) the count is the global batch's, so
    the result is this rank's share: the shares sum to the global mean
    over 'data'."""
    count = mesh_lib.batch_sum(torch.sum(valid))
    return torch.sum(values * valid) / torch.clamp(count, min=1.0)


def mean_losses(losses: List) -> float:
    """Mean over a list of 0-dim (or [S]) loss tensors. The epoch loops
    keep the losses on the device, unfetched — a fetch per step would make
    the host wait for the device every step — and bring them over here,
    once."""
    if not losses:
        return float("nan")
    return float(torch.cat([l.detach().reshape(-1) for l in losses])
                 .mean(dtype=torch.float32))


def table_reg_value(table: torch.Tensor, mesh=None) -> torch.Tensor:
    """l2 * sum(table^2) without gradient, summed in f32: keeps the
    reported loss equal to the reference's while the term's gradient is
    folded into the table's Adam. On a mesh ``table`` is the rank's rows
    and their sums are added over 'model'."""
    with torch.no_grad():
        sq = torch.sum(torch.square(table.to(torch.float32)))
        if mesh is not None:
            sq = mesh.all_reduce_(sq.reshape(1), "model")[0]
        return TABLE_L2 * sq


def raise_if_nonfinite(train_loss: float, epoch_i: int, config=None) -> None:
    """Guard on the fetched per-epoch train loss. Without it a run
    poisoned by NaN goes on into evaluate(), ``is_continuable`` sees NaN
    metrics (NaN > best is False) and the run stops early as if it had
    converged. With a bounded a2a capacity the likely cause is named
    first: an overflowing batch NaN-poisons its lookup."""
    if np.isfinite(float(train_loss)):
        return
    hints = ["lr too high", "non-finite rows in the input"]
    if getattr(config, "embed_lookup", "gspmd") == "a2a" and \
            int(getattr(config, "a2a_capacity", 0) or 0) > 0:
        hints.insert(0, (
            f"a2a_capacity={config.a2a_capacity} overflowed on a batch "
            "after calibration (the exchange NaN-poisons instead of "
            "silently dropping rows) — raise it or pass -1 for always-"
            "exact"))
    raise FloatingPointError(
        f"non-finite train loss {train_loss} at epoch {epoch_i + 1}; "
        "possible causes: " + "; ".join(hints))


def embed_lookup_ctx(config, mesh, model):
    """Zero-argument context-manager factory that routes the embedding's
    row gathers per ``config.embed_lookup``: 'gspmd' (the default) leaves
    the embedding's own lookup (the shard-select ``sharded_lookup`` on a
    mesh); 'a2a' routes it through the dedup + all-to-all exchange
    (``flat_a2a_lookup`` in the lane-packed row space under flat storage,
    where the capacity is measured). An unknown value and 'a2a' without a
    mesh raise."""
    if config.embed_lookup == "a2a":
        if mesh is None:
            raise ValueError("embed_lookup='a2a' needs a device mesh")
        cap = int(config.a2a_capacity or 0)
        embedding = model.embedding
        rpf = (128 // embedding.embed_dim
               if getattr(model.spec, "flat_table", False) else 1)
        # <= 0 -> always-exact; fit() resolves 0 (auto) to a measured bound
        gather = functools.partial(flat_a2a_lookup, mesh=mesh,
                                   capacity=cap if cap > 0 else None,
                                   rows_per_flat=rpf)
        return lambda: embedding.lookup_override(gather)
    if config.embed_lookup != "gspmd":
        raise ValueError(f"embed_lookup={config.embed_lookup!r}")
    return contextlib.nullcontext


def strip_table_rule(rules):
    """Reg rules without the table term: its gradient is folded into the
    table's Adam and its value reported separately (``want_table_l2``)."""
    return tuple((p, l2) for p, l2 in rules if p != TABLE_RULE)


def split_table(model) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(table buffer, every trainable tensor by '/'-joined path)."""
    return model.embedding.table, model.dense_named_parameters()


@dataclasses.dataclass
class DenseAdam:
    """torch-semantics Adam for the dense leaves, in optax's order:
    g += wd*p; mu = (1-b1)*g + b1*mu; nu = (1-b2)*g^2 + b2*nu;
    p += -lr * (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps). Multi-tensor
    (``torch._foreach_*``) ops, a handful of launches per step; they may
    contract a*b+c into an FMA, so results agree with the JAX package to
    f32 round-off, not bitwise."""

    lr: float
    wd: float = 1e-8
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: Dict) -> None:
        names = list(params)
        p = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        g = torch._foreach_add([grads[n] for n in names], p, alpha=self.wd)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        state["count"] += 1
        t = torch.tensor(float(state["count"]), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(p, upd, alpha=-self.lr)


def make_optimizer(lr: float, wd: float = 1e-8) -> DenseAdam:
    return DenseAdam(lr=lr, wd=wd)


def hybrid_init(optimizer: DenseAdam, model, moments_dtype=None) -> Dict:
    """Optimizer state: the dense leaves' Adam state ('inner'), the
    table's moments m, v (stored in ``moments_dtype``, default the
    table's) and the step t."""
    table, rest = split_table(model)
    mdt = table.dtype if moments_dtype is None else getattr(torch, moments_dtype)
    return {"inner": optimizer.init(rest),
            "m": torch.zeros(table.shape, dtype=mdt, device=table.device),
            "v": torch.zeros(table.shape, dtype=mdt, device=table.device),
            "t": 0}


def clip_scale_by_global_norm(tensors: Sequence[torch.Tensor],
                              clip_norm: float, shard: Optional[torch.Tensor] = None,
                              mesh=None) -> Optional[torch.Tensor]:
    """torch.nn.utils.clip_grad_norm_'s factor min(1, clip/||g||) over all
    ``tensors`` and, last, ``shard``: on a mesh the rank's rows of the
    table gradient, whose squares are summed over 'model'. None when
    clipping is off."""
    if not clip_norm or clip_norm <= 0.0:
        return None
    sq = sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors)
    if shard is not None:
        ssq = torch.sum(torch.square(shard.to(torch.float32)))
        if mesh is not None:
            ssq = mesh.all_reduce_(ssq.reshape(1), "model")[0]
        sq = sq + ssq
    return torch.clamp(clip_norm / (torch.sqrt(sq) + 1e-6), max=1.0)


def dense_table_grad(table_ids: torch.Tensor, row_grads: torch.Tensor,
                     n_rows: int, dtype: torch.dtype,
                     rows: Optional[slice] = None) -> torch.Tensor:
    """The dense [n_rows, D] table gradient from the tap's row gradients
    [..., D] at ``table_ids`` [...]: what autodiff through the gather
    holds. Duplicate ids are summed by ``dedup_rows`` (sorted segmented
    sum, no float atomics) and the sums copied into zeros, so it is the
    same on every run and device. For a bf16 table the gradient is bf16,
    as the gather's cotangent is in the JAX package: the row gradients
    are cast to bf16 before the sum; the sum itself runs in f32 and is
    rounded once. ``rows``: only those rows of the gradient (a mesh rank's
    table rows), bitwise the same rows of the whole one."""
    flat = row_grads.reshape(-1, row_grads.shape[-1])
    if dtype == torch.bfloat16:
        flat = flat.to(torch.bfloat16).to(torch.float32)
    uids, gsum = dedup_rows(table_ids.reshape(-1).to(torch.int32), flat,
                            n_rows)
    lo, hi = (0, n_rows) if rows is None else (rows.start, rows.stop)
    u = uids.to(torch.int64) - lo
    # the sentinel entries (id n_rows, zero gradient) and the rows of other
    # shards land in a spare last row
    u = torch.where((u >= 0) & (u < hi - lo), u, hi - lo)
    g = torch.zeros((hi - lo + 1, flat.shape[-1]), dtype=torch.float32,
                    device=flat.device)
    g.index_copy_(0, u, gsum)
    return g[:hi - lo].to(dtype)


def hybrid_update(optimizer: DenseAdam, lr: float, wd: float, model,
                  g_rest: Dict[str, torch.Tensor], g_table: torch.Tensor,
                  opt_state: Dict, table_l2: float = TABLE_L2,
                  clip_norm: float = 0.0, mesh=None) -> None:
    """One optimizer step from dense gradients, in place: the table
    through the fused dense Adam (``ops/fused_adam.py``: the kernel on the
    card, the plain version on the CPU), the other leaves through
    ``optimizer``. ``clip_norm`` clips by the global norm of all data
    gradients, the table's included; the decay and L2 terms folded into
    the updates are not clipped. On a mesh the table and ``g_table`` are
    the rank's rows, and a row-sharded bf16 table rounds with its shard's
    own stream (``sr_seed = t * model + model_index``)."""
    table, rest = split_table(model)
    scale = clip_scale_by_global_norm(list(g_rest.values()), clip_norm,
                                      shard=g_table, mesh=mesh)
    if scale is not None:
        g_rest = {n: g * scale for n, g in g_rest.items()}
        g_table = g_table.to(torch.float32) * scale
    opt_state["t"] += 1
    t = opt_state["t"]
    sharded = mesh is not None and mesh.model > 1
    fused_adam_dispatch(table, opt_state["m"], opt_state["v"],
                        g_table.contiguous(), t, lr=lr,
                        weight_decay=wd, l2=table_l2,
                        sr_seed=t * mesh.model + mesh.model_index
                        if sharded else None)
    optimizer.update_(rest, g_rest, opt_state["inner"])


def hybrid_update_sparse(optimizer: DenseAdam, lr: float, wd: float, model,
                         g_rest: Dict[str, torch.Tensor],
                         table_ids: torch.Tensor, row_grads: torch.Tensor,
                         opt_state: Dict, table_l2: float = TABLE_L2,
                         want_table_l2: bool = False,
                         clip_norm: float = 0.0,
                         lazy: bool = False,
                         mesh=None) -> Optional[torch.Tensor]:
    """One optimizer step, in place: the table from its sparse (ids,
    rows) gradient (``lazy``: the touched rows only,
    ``table_optimizer='lazy_adam'``), the dense leaves through
    ``optimizer``. Returns
    table_l2 * sum(table_pre^2) with ``want_table_l2`` (the kernel sums it
    inside its sweep), else None. ``clip_norm`` clips by the global norm
    of the dense gradients and the deduplicated row sums — the norm of
    the dense table gradient the reference would hold. On a mesh the
    ids and row gradients are the whole batch's (all-gathered over
    'data'), the table is the rank's rows, and with model > 1 the update
    runs on the shard (``sharded_adam.py``) and sum(table_pre^2) is added
    over 'model'."""
    table, rest = split_table(model)
    n_rows = model.embedding.n_rows
    opt_state["t"] += 1
    uids, gsum = dedup_rows(table_ids.reshape(-1).to(torch.int32),
                            row_grads.reshape(-1, row_grads.shape[-1]), n_rows)
    scale = clip_scale_by_global_norm(list(g_rest.values()) + [gsum], clip_norm)
    if scale is not None:
        g_rest = {n: g * scale for n, g in g_rest.items()}
        gsum = gsum * scale
    kw = dict(lr=lr, weight_decay=wd, l2=table_l2, want_l2=want_table_l2,
              lazy=lazy)
    if mesh is not None and mesh.model > 1:
        raw_l2 = sharded_sparse_adam_deduped(
            table, opt_state["m"], opt_state["v"], uids, gsum,
            opt_state["t"], mesh, **kw)
        if want_table_l2:
            # the kernel's sum is a view of scratch: copied before the sum
            raw_l2 = mesh.all_reduce_(raw_l2.reshape(1).clone(), "model")[0]
    else:
        raw_l2 = sparse_adam_dispatch(
            table, opt_state["m"], opt_state["v"], uids, gsum,
            opt_state["t"], **kw)
    optimizer.update_(rest, g_rest, opt_state["inner"])
    return table_l2 * raw_l2 if want_table_l2 else None


def device_data_mode_enabled(config, total_bytes: int, budget: int,
                             mesh=None) -> bool:
    """``config.device_data`` gate: '0' off, '1' forced, 'auto' = the
    split fits the budget. A mesh run stages each rank's rows from the
    host: off, and '1' there is an error, not a silent ignore."""
    cfg = config.device_data
    if cfg == "0":
        return False
    if mesh is not None:
        if cfg == "1":
            raise ValueError(
                "device_data=1 is not supported on mesh runs (the epoch "
                "paths gather from a single-device split); use "
                "device_data=auto/0 with a mesh")
        return False
    if cfg == "1":
        return True
    if cfg != "auto":
        raise ValueError(f"device_data={cfg!r}")
    return total_bytes <= budget


def sum_over_data(mesh, g_rest: Dict[str, torch.Tensor], loss: torch.Tensor,
                  ids: torch.Tensor, row_grads: torch.Tensor):
    """A mesh step's gradients completed over 'data': the dense leaves'
    gradients and the loss summed (one collective), the table's ids and
    row gradients all-gathered in rank order — the single-device batch's
    order, so its dedup sums are the single-device ones."""
    names = list(g_rest)
    flat = torch.cat([g_rest[n].reshape(-1) for n in names]
                     + [loss.reshape(1)])
    mesh.all_reduce_(flat, "data")
    out, i = {}, 0
    for n in names:
        k = g_rest[n].numel()
        out[n] = flat[i:i + k].view_as(g_rest[n])
        i += k
    return (out, flat[-1], mesh.all_gather(ids, "data"),
            mesh.all_gather(row_grads, "data"))


def sum_states_over_data(mesh, state: Dict[str, torch.Tensor]):
    """A streaming-AUC state summed over 'data' (each rank added its
    rows)."""
    if mesh is None:
        return state
    return {k: mesh.all_reduce_(v.clone(), "data") for k, v in state.items()}


def clone_state(model) -> Dict[str, torch.Tensor]:
    """A copy of the model's weights and buffers on its device."""
    return {k: v.clone() for k, v in model.state_dict().items()}


def adopt_state_dict(model, state_dict: Dict[str, torch.Tensor]) -> None:
    """A checkpoint's weights and buffers into the live tensors, in place,
    each cast to the live tensor's dtype; the shapes must match (a
    mismatch means the checkpoint is of another model or spec)."""
    restore_tree_(model.state_dict(), state_dict, "state_dict")


def restored_best(ck: Dict) -> Dict[str, float]:
    """The early-stop bests of a resumed run from a checkpoint's
    ``best_result`` (a metric that was NaN is stored as null)."""
    best = ck.get("best_result") or {}
    return {"best_auc": best.get("total_auc") or 0.0,
            "best_loss": best.get("total_loss") or np.inf,
            "best_mean_auc": best.get("mean_auc") or 0.0,
            "best_mean_loss": best.get("mean_loss") or np.inf}


class Trainer:
    """Generic trainer for single-output and multi-tower models. The
    model's weights and BatchNorm statistics live in the model and are
    updated in place; the optimizer state is ``self.opt_state``."""

    # device memory the resident train split may take under
    # device_data='auto' (the full Amazon split is ~1.2 GB of int32)
    DEVICE_DATA_BUDGET = 4 * 2**30

    def __init__(self, model, config: Config, n_domain: int,
                 domain2group: Optional[np.ndarray] = None, mesh=None):
        self.model = model
        self.config = config
        self.n_domain = n_domain
        # a (data, model) rank grid (parallel/mesh.py): the model's table is
        # cut to this rank's rows here, unless it is already
        self.mesh = mesh
        if mesh is not None:
            from aread_tpu_torch.parallel.train_step import shard_params
            shard_params(model, mesh)
        self._lookup_ctx = embed_lookup_ctx(config, mesh, model)
        self.device = model.device
        self.model_name = getattr(model, "model_name",
                                  type(model).__name__.lower())
        self.is_multi_tower = self.model_name in MULTI_TOWER_MODELS
        self.domain2group = (None if domain2group is None
                             else np.asarray(domain2group))
        self.optimizer = make_optimizer(config.lr, config.wd)
        # dropout's stream
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        # the table's L2 gradient is folded into its Adam update
        self.reg_rules = strip_table_rule(type(model).REG_RULES)
        self.opt_state: Optional[Dict] = None
        self._device_data = None  # (host_x, host_y, dx, dy)
        # host clock per step: the launches, since no step synchronises
        self.step_timer = profiling.StepTimer()
        # early-stop state
        self.trial_counter = 0
        self.best_auc, self.best_mean_auc = 0.0, 0.0
        self.best_loss, self.best_mean_loss = np.inf, np.inf
        self.best_checkpoint = None
        self._improved = False

    @contextlib.contextmanager
    def run_ctx(self):
        """The block every forward pass runs in: the mesh active (the
        batch reductions of BatchNorm, dropout, ...) and the lookup
        ``config.embed_lookup`` asks for."""
        with mesh_lib.use(self.mesh), self._lookup_ctx():
            yield

    # ---------------------------------------------------------------- init
    def init(self) -> Dict:
        """Optimizer state for the model's current weights (the weights
        are drawn from the model's seed when it is built)."""
        self.opt_state = hybrid_init(
            self.optimizer, self.model,
            moments_dtype=self.config.table_moments_dtype)
        return self.opt_state

    def place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch on the device; on a mesh this rank's rows of it."""
        if self.mesh is not None:
            rows = self.mesh.rows(len(batch["x"]))
            batch = {k: v[rows] for k, v in batch.items()}
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Per-row outputs of this rank's rows, completed to the global
        batch in row order (all-gathered over 'data' on a mesh)."""
        return t if self.mesh is None else self.mesh.all_gather(t, "data")

    # ---------------------------------------------------------------- step
    def step(self, batch) -> torch.Tensor:
        """One training step in place; returns the reported loss (data
        loss + L2 terms, the table's included with
        ``config.loss_report_table_l2``), not fetched to the host. The
        table's gradient is taken through the embedding's tap and goes
        into the update sparse (``config.sparse_table_grad``) or as the
        dense [n_rows, D] gradient. On a mesh ``batch`` is a global host
        batch (``place`` takes this rank's rows) or this rank's placed
        rows; the loss returned is the global one, the same on every
        rank."""
        cfg = self.config
        mesh = self.mesh
        if self.opt_state is None:
            raise RuntimeError("call init() before stepping")
        if isinstance(batch["x"], np.ndarray):
            batch = self.place(batch)
        model = self.model
        model.train()
        x, y, valid = batch["x"], batch["y"], batch["valid"]
        group = batch.get("group")
        table, rest = split_table(model)
        names = list(rest)
        # the gradient's products too: the JAX package traces
        # value_and_grad inside the context
        with matmul_precision_ctx(cfg.compute_dtype), self.run_ctx():
            out = model(x, group=group, train=True, mask=valid,
                        generator=self.generator, tap=True)
            logit = out["logit"]
            if self.is_multi_tower and logit.dim() == 2:
                logit = gather_group(logit, group if group is not None
                                     else batch["domain"])
            loss = masked_mean(bce_with_logits(logit, y), valid)
            if mesh is None or mesh.data_index == 0:
                # once over the data ranks, whose losses are summed
                loss = loss + regularization_loss(rest, self.reg_rules)
            # leaves the loss does not reach get zero gradients (the decay
            # term still moves them)
            grads = torch.autograd.grad(
                loss, [rest[n] for n in names] + [out["rows"]],
                materialize_grads=True)
        g_rest = dict(zip(names, grads[:-1]))
        ids, row_grads = model.embedding.table_ids(x), grads[-1]
        loss = loss.detach()
        if mesh is not None:
            g_rest, loss, ids, row_grads = sum_over_data(
                mesh, g_rest, loss, ids, row_grads)
        if cfg.sparse_table_grad:
            l2val = hybrid_update_sparse(
                self.optimizer, cfg.lr, cfg.wd, model, g_rest, ids, row_grads,
                self.opt_state, want_table_l2=cfg.loss_report_table_l2,
                clip_norm=cfg.grad_clip_norm,
                lazy=cfg.table_optimizer == "lazy_adam", mesh=mesh)
            return loss if l2val is None else loss + l2val
        if cfg.loss_report_table_l2:
            # the pre-update table
            loss = loss + table_reg_value(table, mesh)
        n_rows = model.embedding.n_rows
        g_table = dense_table_grad(
            ids, row_grads, n_rows, table.dtype,
            rows=None if mesh is None else mesh.table_rows(n_rows))
        hybrid_update(self.optimizer, cfg.lr, cfg.wd, model, g_rest, g_table,
                      self.opt_state, clip_norm=cfg.grad_clip_norm, mesh=mesh)
        return loss

    # ------------------------------------------------------------ training
    def train_epoch(self, batcher: Iterable) -> float:
        """One pass over the batcher's host batches; the mean loss."""
        losses = []
        for b in batcher:
            with self.step_timer.step(n_examples=int(b["valid"].sum())):
                losses.append(self.step(self.place(b)))
        return mean_losses(losses)

    def device_data_enabled(self, train_x: np.ndarray) -> bool:
        return device_data_mode_enabled(self.config, train_x.nbytes,
                                        self.DEVICE_DATA_BUDGET, self.mesh)

    def train_epoch_device(self, batcher: GlobalBatcher) -> float:
        """``train_epoch`` over a device-resident copy of the split: each
        step gathers its batch by index, and only the [n_batches, bs]
        permutation is transferred per epoch. Same shuffle stream and
        padded-batch semantics as the host path (pad slots carry -1 and
        replicate the batch's first row), so the two give the same
        result."""
        # keyed on the host arrays themselves (`is`): a second fit() on
        # new data must not gather from the previous split's copy
        if (self._device_data is None
                or self._device_data[0] is not batcher.x
                or self._device_data[1] is not batcher.y):
            self._device_data = (
                batcher.x, batcher.y,
                torch.as_tensor(np.ascontiguousarray(batcher.x),
                                device=self.device),
                torch.as_tensor(np.ascontiguousarray(batcher.y),
                                device=self.device))
        _, _, dx, dy = self._device_data
        perm_np = batcher.epoch_perm()
        perm = torch.as_tensor(perm_np, device=self.device)
        d2g = (None if batcher.domain2group is None else torch.as_tensor(
            np.asarray(batcher.domain2group), dtype=torch.int32,
            device=self.device))
        n_valid = (perm_np >= 0).sum(axis=1).tolist()
        losses = []
        with profiling.trace():  # a no-op unless AREAD_TPU_TRACE is set
            for idx, n_ex in zip(perm, n_valid):
                with self.step_timer.step(n_examples=n_ex):
                    valid = (idx >= 0).to(torch.float32)
                    gidx = torch.where(idx < 0, idx[0], idx).to(torch.int64)
                    x = dx[gidx]
                    batch = {"x": x,
                             "y": dy[gidx].to(torch.float32) * valid,
                             "valid": valid,
                             "domain": x[:, batcher.domain_idx].to(
                                 torch.int32)}
                    if d2g is not None:
                        batch["group"] = d2g[batch["domain"].to(torch.int64)]
                    losses.append(self.step(batch))
        return mean_losses(losses)

    # ---------------------------------------------------------- evaluation
    @torch.no_grad()
    def eval_prob_logit(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prob, logit) [B] of a placed batch; a multi-tower model's
        outputs gathered at the sample's group column."""
        self.model.eval()
        group = batch.get("group")
        with self.run_ctx():
            out = self.model(batch["x"], group=group, train=False)
        prob, logit = out["prob"], out["logit"]
        if self.is_multi_tower and prob.dim() == 2:
            prob, logit = gather_group(prob, group), gather_group(logit, group)
        return prob, logit

    def eval_prob(self, batch) -> torch.Tensor:
        return self.eval_prob_logit(batch)[0]

    def evaluate(self, x: np.ndarray, y: np.ndarray,
                 domain_cnt_weight: np.ndarray) -> Dict:
        """Total and per-domain AUC / log-loss over a split. Evaluation
        normalizes with the running statistics, so the batch size does not
        change the predictions; batches of 8 * bs cut the launches. ADL with
        ``eval_dlm_update`` moves its cluster centres batch by batch, in
        this order, on both paths. With
        ``config.streaming_eval`` the predictions stay on the device: each
        batch's logits go into per-domain histograms (``StreamingAUC``)
        and only those are fetched. On a mesh each rank scores its rows;
        the predictions are all-gathered (the histograms summed) over
        'data' before the metrics, which every rank then computes alike."""
        batcher = GlobalBatcher(x, y, self.config.bs * 8,
                                self.model.spec.domain_idx, self.domain2group,
                                shuffle=False)
        if self.config.streaming_eval:
            acc = metrics_lib.StreamingAUC(self.n_domain, self.config.auc_bins)
            auc_state = acc.init_state(self.device)
            for batch in batcher:
                tb = self.place(batch)
                prob, logit = self.eval_prob_logit(tb)
                auc_state = acc.update(auc_state, prob, tb["y"], tb["domain"],
                                       tb["valid"], logits=logit)
            return acc.finalize(
                sum_states_over_data(self.mesh, auc_state), domain_cnt_weight,
                multi_domain=self.config.is_evaluate_multi_domain)
        preds, targets, domains = [], [], []
        for batch in batcher:
            n = int(batch["valid"].sum())
            preds.append(self.gather_rows(self.eval_prob(self.place(batch)))[:n])
            targets.append(batch["y"][:n])
            domains.append(batch["domain"][:n])
        return metrics_lib.full_evaluation(
            np.concatenate(targets), torch.cat(preds).cpu().numpy(),
            np.concatenate(domains), domain_cnt_weight,
            multi_domain=self.config.is_evaluate_multi_domain)

    # ------------------------------------------------- dynamic regrouping
    @torch.no_grad()
    def tower_domain_losses(self, x: np.ndarray,
                            y: np.ndarray) -> np.ndarray:
        """Per-(tower, domain) mean BCE [n_tower, n_domain] of every tower
        head on a split (NaN for a domain without rows): the loss matrix
        ``regroup_all_domain`` takes."""
        self.model.eval()
        batcher = GlobalBatcher(x, y, self.config.bs * 8,
                                self.model.spec.domain_idx, self.domain2group,
                                shuffle=False)
        preds, targets, domains = [], [], []
        for batch in batcher:
            tb = self.place(batch)
            with self.run_ctx():
                prob = self.model(tb["x"], group=tb.get("group"),
                                  train=False)["prob"]
            n = int(batch["valid"].sum())
            if prob.dim() == 1:  # a single head: one degenerate tower
                prob = prob[:, None]
            preds.append(self.gather_rows(prob)[:n])
            targets.append(batch["y"][:n])
            domains.append(batch["domain"][:n])
        pred = torch.cat(preds).cpu().numpy()
        return get_losses_tower_domain(pred, np.concatenate(targets),
                                       np.concatenate(domains),
                                       pred.shape[1], self.n_domain)

    def apply_dynamic_regroup(self, valid_x: np.ndarray, valid_y: np.ndarray,
                              verbose: bool = True) -> bool:
        """Recompute domain -> group from the valid split's loss matrix
        (``config.dynamic_regroup``: comma-separated modes of
        ``regroup_all_domain``) and take it for what follows. With
        'served', each tower first keeps the domain among its own that it
        serves best (its global best when it serves none). A domain that
        the split lacks (a NaN column) keeps its group. Returns whether the
        map changed. Raises ``ValueError`` for a model without towers or a
        map."""
        modes = tuple(m.strip() for m in
                      self.config.dynamic_regroup.split(",") if m.strip())
        if not modes or modes == ("off",):
            return False
        if not self.is_multi_tower or self.domain2group is None:
            raise ValueError(
                f"dynamic_regroup={self.config.dynamic_regroup!r} needs a "
                f"multi-tower model with a domain2group map "
                f"(model={self.model_name})")
        matrix = self.tower_domain_losses(valid_x, valid_y)
        cur = np.asarray(self.domain2group)
        selected = None
        if "served" in modes:
            selected = []
            for g in range(matrix.shape[0]):
                mine = np.flatnonzero(cur == g)
                row = matrix[g]
                if mine.size and np.isfinite(row[mine]).any():
                    selected.append(int(mine[np.nanargmin(row[mine])]))
                else:
                    selected.append(int(np.nanargmin(row)))
        safe = np.where(np.isnan(matrix), np.inf, matrix)
        new_d2g = regroup_all_domain(safe, modes, selected_domain=selected)
        new_d2g = np.where(np.isnan(matrix).all(axis=0), cur, new_d2g)
        changed = not np.array_equal(new_d2g, cur)
        if changed:
            if verbose:
                print(f"dynamic_regroup({','.join(modes)}): "
                      f"{int(np.sum(new_d2g != cur))} domain(s) reassigned")
            self.domain2group = new_d2g.astype(np.int64)
        return changed

    def resolve_a2a_capacity(self, data: SplitData, verbose: bool) -> None:
        """``config.a2a_capacity`` resolved (measured when 0) from the
        train batches and the 8x eval batches, before the first step: one
        capacity serves every lookup. A no-op unless
        ``embed_lookup='a2a'``."""
        cfg = self.config
        cfg.a2a_capacity = resolve_a2a_capacity(
            cfg, self.mesh, self.model.spec, self.model.embed_dim,
            [(data.train_x, cfg.bs), (data.valid_x, cfg.bs * 8),
             (data.test_x, cfg.bs * 8)], verbose=verbose)
        self._lookup_ctx = embed_lookup_ctx(cfg, self.mesh, self.model)

    def save(self, path: str, **kw) -> None:
        """``save_checkpoint`` of the model and the optimizer state. On a
        mesh every rank takes part in gathering the table and its moments,
        rank 0 writes the single-device format, and all meet at a barrier
        after the write."""
        sd, opt = full_state(self.model.state_dict(), self.opt_state or {},
                             self.mesh)
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(path, sd, opt, **kw)
        if self.mesh is not None:
            barrier("checkpoint", self.config.epoch_timeout_s or None)

    def is_continuable(self, result: Dict, epoch_i: int) -> bool:
        """Early stopping on mean_auc (total_auc when that is missing or
        NaN) with patience ``config.early_stop``; an improvement keeps a
        copy of the weights on the device."""
        key = ("mean_auc" if "mean_auc" in result
               and not np.isnan(result["mean_auc"]) else "total_auc")
        best = self.best_mean_auc if key == "mean_auc" else self.best_auc
        self._improved = result[key] > best
        if self._improved:
            self.trial_counter = 0
            self.best_auc = result["total_auc"]
            self.best_loss = result["total_loss"]
            if "mean_auc" in result:
                self.best_mean_auc = result["mean_auc"]
                self.best_mean_loss = result.get("mean_loss", np.inf)
            self.best_checkpoint = (clone_state(self.model), epoch_i)
            return True
        if self.trial_counter + 1 < self.config.early_stop:
            self.trial_counter += 1
            return True
        return False

    def fit(self, data: SplitData, epochs: Optional[int] = None,
            verbose: bool = True, warm_start: Optional[Dict] = None,
            ckpt_dir: Optional[str] = None) -> Dict:
        """Train up to ``epochs`` (default ``config.epoch``) epochs with
        early stopping on the valid split, then evaluate the best weights
        on the test split; the model is left holding them. Returns
        {'history': per-epoch valid results, 'test': the test result}.

        ``warm_start``: a checkpoint dict (``load_checkpoint``) whose
        weights and buffers replace the model's; the optimizer starts
        fresh.

        ``ckpt_dir``: a resumable checkpoint (weights, optimizer state,
        dropout generator, epoch, best metrics) is written there on every
        improvement, and when one exists training resumes from it at the
        saved epoch. The shuffle restarts at the epoch boundary
        (``GlobalBatcher.set_epoch``), so a resumed run repeats the
        uninterrupted one; the generator's state resumes only on the
        device type it was saved on."""
        cfg = self.config
        batcher = GlobalBatcher(data.train_x, data.train_y, cfg.bs,
                                data.spec.domain_idx, self.domain2group,
                                seed=cfg.seed)
        self.resolve_a2a_capacity(data, verbose)
        self.init()
        if warm_start is not None:
            adopt_state_dict(self.model, local_state(
                warm_start["state_dict"], None, self.mesh)[0])
        start_epoch = 0
        if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "meta.json")):
            ck = load_checkpoint(ckpt_dir, map_location=self.device)
            sd, opt = local_state(ck["state_dict"], ck["opt_state"],
                                  self.mesh)
            adopt_state_dict(self.model, sd)
            restore_tree_(self.opt_state, opt, "opt_state")
            set_generator_state(self.generator, ck["rng_state"])
            start_epoch = int(ck["epoch"])
            batcher.set_epoch(start_epoch)
            for name, value in restored_best(ck).items():
                setattr(self, name, value)
            self.best_checkpoint = (clone_state(self.model), start_epoch - 1)
            if verbose:
                print(f"elastic resume from {ckpt_dir} at epoch {start_epoch}")
        device_data = self.device_data_enabled(data.train_x)
        n_train = data.train_x.shape[0]
        history = []
        with RunLogger(cfg.log_dir or None, config=cfg) as logger:
            try:
                n_epochs = epochs if epochs is not None else cfg.epoch
                for epoch_i in range(start_epoch, n_epochs):
                    t0 = time.time()
                    with watchdog(epoch_deadline(cfg.epoch_timeout_s,
                                                 cfg.epoch_timeout_first_mult),
                                  tag=f"train_epoch{epoch_i}",
                                  kill_process=cfg.epoch_timeout_kill):
                        train_loss = (
                            self.train_epoch_device(batcher) if device_data
                            else self.train_epoch(batcher))
                    train_s = time.time() - t0
                    raise_if_nonfinite(train_loss, epoch_i, cfg)
                    result = self.evaluate(data.valid_x, data.valid_y,
                                           data.domain_cnt_weight)
                    result["train_loss"] = train_loss
                    result["epoch_time_s"] = time.time() - t0
                    # the epoch's rows over its seconds, which end in the
                    # fetch of its losses (a StepTimer around an
                    # unsynchronised step would time the launches)
                    result["examples_per_s"] = n_train / train_s
                    history.append(result)
                    logger.log({"valid": result}, step=epoch_i + 1)
                    if verbose:
                        msg = (f"epoch {epoch_i + 1}: "
                               f"train_loss={train_loss:.4f} "
                               f"valid auc={result['total_auc']:.4f} "
                               f"loss={result['total_loss']:.4f}")
                        if "mean_auc" in result:
                            msg += f" mean_auc={result['mean_auc']:.4f}"
                        print(msg)
                    cont = self.is_continuable(result, epoch_i)
                    if cont and cfg.dynamic_regroup != "off":
                        # the batcher reads its map per batch, the device
                        # epoch once per epoch; the valid and test passes
                        # read the trainer's
                        if self.apply_dynamic_regroup(
                                data.valid_x, data.valid_y, verbose=verbose):
                            batcher.domain2group = self.domain2group
                    if ckpt_dir and self._improved:
                        self.save(ckpt_dir, epoch=epoch_i + 1,
                                  best_result=result,
                                  generator=self.generator)
                    if not cont:
                        break
            finally:
                # release the resident split even when an epoch fails
                self._device_data = None
            if self.best_checkpoint is not None:
                self.model.load_state_dict(self.best_checkpoint[0])
            # ADL with eval_dlm_update moves its centres in every
            # evaluation (fit carries the valid pass's into the next
            # epoch); the run's result is the state before the test pass,
            # as in the JAX package
            kept = (clone_state(self.model)
                    if getattr(self.model, "eval_dlm_update", False) else None)
            test_result = self.evaluate(data.test_x, data.test_y,
                                        data.domain_cnt_weight)
            if kept is not None:
                self.model.load_state_dict(kept)
            logger.log({"test": test_result})
        return {"history": history, "test": test_result}
