"""Sparse-gradient table Adam on a row-sharded table (counterpart of
``aread_tpu/parallel/sharded_adam.py``).

Each model rank holds its ``[n_rows / model, D]`` rows of (w, m, v). The
update needs no communication beyond the gradient itself:

  1. one global dedup of the (ids, row-gradient) pairs of the whole batch
     — the caller all-gathers them over 'data' in rank order, which is the
     single-device batch order, so the sums are the single-device ones;
  2. each rank takes its contiguous run of the sorted unique ids (two
     ``searchsorted``s), rebases them to local rows and pads with the
     sentinel;
  3. and runs the same dispatch as one device (``sparse_adam_dispatch``:
     the CUDA kernel on the card) on its shard, with ``sr_seed = t * model
     + model_index``: the kernel indexes a shard's elements locally, so
     one seed would reuse one stochastic-rounding stream on every shard.

With ``model == 1`` it is the unsharded update.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from aread_tpu_torch.ops.sparse_adam import dedup_rows, sparse_adam_dispatch
from aread_tpu_torch.parallel.mesh import Mesh


def shard_run(uids: torch.Tensor, gsum: torch.Tensor, lo: int,
              rows_per: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted unique ids in ``[lo, lo + rows_per)`` rebased to local
    rows, first, then the sentinel ``rows_per`` with zero gradients: the
    same length K as ``uids``."""
    K = uids.shape[0]
    bounds = torch.searchsorted(
        uids, torch.tensor([lo, lo + rows_per], dtype=uids.dtype,
                           device=uids.device), side="left")
    a, run = bounds[0], bounds[1] - bounds[0]
    pos = torch.arange(K, device=uids.device)
    src = torch.clamp(pos + a, max=K - 1)
    keep = pos < run
    local = torch.where(keep, uids[src] - lo,
                        torch.full((), rows_per, dtype=uids.dtype,
                                   device=uids.device))
    gloc = torch.where(keep[:, None], gsum[src],
                       torch.zeros((), dtype=gsum.dtype, device=gsum.device))
    return local.contiguous(), gloc.contiguous()


def sharded_sparse_adam_deduped(w, m, v, uids, gsum, t: int, mesh: Mesh,
                                lr: float, b1: float = 0.9, b2: float = 0.99,
                                eps: float = 1e-8, weight_decay: float = 1e-8,
                                l2: float = 0.0, lazy: bool = False,
                                want_l2: bool = False):
    """Steps 2 and 3 on this rank's shard (w, m, v) in place, from the
    global ``dedup_rows`` output. Returns this shard's pre-update sum(w**2)
    with ``want_l2`` (the caller sums it over 'model'), else None."""
    rows_per = w.shape[0]
    local, gloc = shard_run(uids, gsum, mesh.model_index * rows_per,
                            rows_per)
    return sparse_adam_dispatch(
        w, m, v, local, gloc, t, lr=lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, l2=l2, want_l2=want_l2, lazy=lazy,
        sr_seed=int(t) * mesh.model + mesh.model_index)


def sharded_sparse_table_adam(w, m, v, flat_ids, flat_grads, t: int,
                              mesh: Mesh, lr: float, b1: float = 0.9,
                              b2: float = 0.99, eps: float = 1e-8,
                              weight_decay: float = 1e-8, l2: float = 0.0,
                              table_shape: Optional[Tuple[int, int]] = None,
                              lazy: bool = False) -> None:
    """Dense-semantics Adam on a row-sharded table, in place. ``w, m, v``:
    this rank's ``[n_rows / model, D]`` rows; ``flat_ids`` [K] and
    ``flat_grads`` [K, D]: the whole batch's ids and row gradients, the
    same on every rank. ``table_shape``: the logical (n_rows, D), default
    ``(model * rows, D)``."""
    n_rows, d = (table_shape if table_shape is not None
                 else (w.shape[0] * mesh.model, w.shape[1]))
    uids, gsum = dedup_rows(flat_ids.reshape(-1).to(torch.int32),
                            flat_grads.reshape(-1, d), n_rows)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              lazy=lazy)
    if mesh.model == 1:
        sparse_adam_dispatch(w, m, v, uids, gsum, t, **kw)
        return
    if w.shape[0] * mesh.model != n_rows:
        raise ValueError(f"shard {tuple(w.shape)} x model={mesh.model} is "
                         f"not the table's {n_rows} rows")
    sharded_sparse_adam_deduped(w, m, v, uids, gsum, t, mesh, **kw)
