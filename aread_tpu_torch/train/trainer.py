"""Loss pieces and the hybrid optimizer (counterpart of the core of
``aread_tpu/train/trainer.py``).

The reference trains with torch.optim.Adam(lr, betas=(0.9, 0.99),
eps=1e-8, weight_decay=1e-8) and a manual L2 term in the loss. Here the
fused embedding table (~99% of the parameters at Amazon width) takes a
dense-semantics Adam from its sparse row gradient, with the weight decay
and the table's L2 gradient folded into the update
(``ops/sparse_adam.py``); every other leaf takes ``DenseAdam``, the JAX
package's optax chain add_decayed_weights(wd) -> scale_by_adam(0.9,
0.99, 1e-8) -> scale(-lr) in its expression order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from aread_tpu_torch.ops.sparse_adam import dedup_rows, sparse_adam_dispatch

TABLE_RULE = r"^embedding/table$"
TABLE_L2 = 1e-5  # the reference's l2_reg_embedding


def bce_with_logits(logit, y):
    """Numerically stable binary cross-entropy from logits."""
    return (torch.clamp(logit, min=0.0) - logit * y
            + torch.log1p(torch.exp(-torch.abs(logit))))


def masked_mean(values, valid):
    return torch.sum(values * valid) / torch.clamp(torch.sum(valid), min=1.0)


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
                              clip_norm: float) -> Optional[torch.Tensor]:
    """torch.nn.utils.clip_grad_norm_'s factor min(1, clip/||g||) over all
    ``tensors``; None when clipping is off."""
    if not clip_norm or clip_norm <= 0.0:
        return None
    sq = sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors)
    return torch.clamp(clip_norm / (torch.sqrt(sq) + 1e-6), max=1.0)


def hybrid_update_sparse(optimizer: DenseAdam, lr: float, wd: float, model,
                         g_rest: Dict[str, torch.Tensor],
                         table_ids: torch.Tensor, row_grads: torch.Tensor,
                         opt_state: Dict, table_l2: float = TABLE_L2,
                         want_table_l2: bool = False,
                         clip_norm: float = 0.0) -> Optional[torch.Tensor]:
    """One optimizer step, in place: the table from its sparse (ids,
    rows) gradient, the dense leaves through ``optimizer``. Returns
    table_l2 * sum(table_pre^2) with ``want_table_l2`` (the kernel sums it
    inside its sweep), else None. ``clip_norm`` clips by the global norm
    of the dense gradients and the deduplicated row sums — the norm of
    the dense table gradient the reference would hold."""
    table, rest = split_table(model)
    n_rows = table.shape[0]
    opt_state["t"] += 1
    uids, gsum = dedup_rows(table_ids.reshape(-1).to(torch.int32),
                            row_grads.reshape(-1, row_grads.shape[-1]), n_rows)
    scale = clip_scale_by_global_norm(list(g_rest.values()) + [gsum], clip_norm)
    if scale is not None:
        g_rest = {n: g * scale for n, g in g_rest.items()}
        gsum = gsum * scale
    raw_l2 = sparse_adam_dispatch(
        table, opt_state["m"], opt_state["v"], uids, gsum, opt_state["t"],
        lr=lr, weight_decay=wd, l2=table_l2, want_l2=want_table_l2)
    optimizer.update_(rest, g_rest, opt_state["inner"])
    return table_l2 * raw_l2 if want_table_l2 else None
