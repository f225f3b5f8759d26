"""Overlay fast-adapt (counterpart of ``aread_tpu/ops/overlay_adam.py``):
HEMP candidate chains whose table work does not grow with the table.

A chain is the reference's fresh ``torch.optim.Adam`` over every
parameter for ``regroup_update_step`` steps at ``update_lr``, from a
snapshot it never commits. Over the table that splits exactly in two:

* the working set, every row that one of the chain's S adapt batches
  gathers (the batches are drawn before the chain starts). Its rows live
  in a compact f32 copy ``[C, E]`` that takes a dense-semantics Adam step
  every chain step (``overlay_adam_step``): the data gradient where the
  batch touched the row, the decay term alone where it did not;
* every other row, which gets no data gradient in the chain: its path is
  S fresh-Adam steps from g = 0, a function of (w0, S) only
  (``drift_rows``). A probe reads such a row drifted
  (``overlay_gather(drift_steps=S)``); an adapt step never reads one,
  since its batch is part of the working set.

The probe loss's table L2 term stays exact: sum(drift(w)^2) over the
whole table is the same for every candidate (``drift_table_l2``, once
per regroup), and each candidate corrects it on its working set
(``overlay_l2_correction``).

On the card the compact step and every drift step are launches of the
fused dense Adam kernel (``ops/fused_adam.py``, ``ops/cuda/fused_adam.cu``),
which computes the JAX package's ``reference_adam_update``; on the CPU
they take its plain version. The chain computes in f32. On an f32 table
it is the full sweep's chain to f32 round-off; on a bf16 table the full
sweep rounds w stochastically into storage every step while the overlay
carries f32 through the chain, and the live table is never written.

The chain runs as one CUDA graph on the card (``train/hemp.py``), so
every shape here is static: the working set keeps the JAX package's
``C = S * bs * F`` slots, sorted, duplicates kept, and every step of the
chain (the compact steps and the probes' drift) reads its lr, bias
corrections and seed from the chain's [S, 4] scalar block on the device
(``ops/sparse_adam.py::chunk_scalars``: step t of a fresh Adam is row
t - 1). Duplicate slots take the same gradient and evolve alike; a lookup
reads the first of them, and the L2 correction counts each row once, as
in the JAX package.

The port stores the table as logical ``[n_rows, E]`` rows, so a
working-set slot is one logical row (the JAX package's ``rpf`` is 1 here)
and the lane-packed branch of its ``compact_grad`` has no counterpart.
"""

from __future__ import annotations

import torch

from aread_tpu_torch.ops.fused_adam import fused_adam_dispatch


def build_working_set(embedding, xs: torch.Tensor) -> torch.Tensor:
    """Sorted [C] int32 table rows that the stacked adapt batches ``xs``
    [S, bs, F] gather, one slot per gathered id (C = S * bs * F,
    duplicates kept: a static shape), through the embedding's own id
    mapping (``table_ids``: offsets and clipping as the forward applies
    them)."""
    ids = embedding.table_ids(xs.reshape(-1, xs.shape[-1])).reshape(-1)
    return torch.sort(ids.to(torch.int32)).values


def overlay_init(table: torch.Tensor, ws: torch.Tensor):
    """Compact (w, m, v) of the working set: the rows as f32 copies and
    zero moments."""
    w = table[ws].to(torch.float32)
    return w, torch.zeros_like(w), torch.zeros_like(w)


def compact_grad(ws: torch.Tensor, uids: torch.Tensor,
                 gsum: torch.Tensor) -> torch.Tensor:
    """The deduplicated sparse gradient (``ops.sparse_adam.dedup_rows``:
    sorted unique table rows ``uids`` [K] with sentinel padding, summed
    rows ``gsum`` [K, E]) in the working set's compact [C, E] f32 layout,
    by gathers; working-set rows the batch did not touch get exact zeros,
    duplicate slots the same row."""
    k = torch.searchsorted(uids, ws.to(uids.dtype))
    k = torch.clamp(k, max=uids.shape[0] - 1)
    hit = (uids[k] == ws)[:, None]
    return torch.where(hit, gsum[k].to(torch.float32), 0.0).contiguous()


def overlay_adam_step(w: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      cgrad: torch.Tensor, t: int, lr: float, wd: float,
                      l2: float, scalars=None) -> None:
    """One dense-semantics Adam step of the compact working set, in place:
    the full table path's update expression (the fused dense Adam).
    ``scalars``: the step's [4] int32 block on the device (None: made from
    ``t`` and ``lr``)."""
    fused_adam_dispatch(w, m, v, cgrad, t, lr=lr, weight_decay=wd, l2=l2,
                        scalars=scalars)


def drift_rows(w0: torch.Tensor, n_steps: int, lr: float, wd: float,
               l2: float, blocks=None) -> torch.Tensor:
    """``n_steps`` fresh-Adam steps of ``w0`` with zero data gradient
    (g = (wd + 2 * l2) * w each step): what the full sweep does to a row
    no adapt batch touches. ``blocks``: the steps' [>= n_steps, 4] scalar
    blocks on the device, row t - 1 for step t (None: each made from its
    step). Returns a new f32 tensor; the scratch moments are freed with
    the call."""
    w = w0.to(torch.float32, copy=True).contiguous()
    m, v, g = torch.zeros_like(w), torch.zeros_like(w), torch.zeros_like(w)
    for i in range(1, n_steps + 1):
        fused_adam_dispatch(w, m, v, g, i, lr=lr, weight_decay=wd, l2=l2,
                            scalars=None if blocks is None else blocks[i - 1])
    return w


def overlay_gather(table: torch.Tensor, row_ids: torch.Tensor, *,
                   ws: torch.Tensor, wvals: torch.Tensor, drift_steps: int,
                   lr: float, wd: float, l2: float,
                   blocks=None) -> torch.Tensor:
    """The embedding's lookup override in an overlay chain
    (``FeaturesEmbedding.lookup_override``): working-set rows read their
    compact chain values (the first of duplicate slots), every other row
    the table's value advanced by ``drift_steps`` decay-only steps (0 in
    adapt steps, whose rows are all in the working set; ``blocks`` as
    ``drift_rows``). f32 rows of ``row_ids``' shape + [E]."""
    rid = row_ids.to(ws.dtype)
    pos = torch.searchsorted(ws, rid)
    pos = torch.clamp(pos, max=ws.shape[0] - 1)
    hit = ws[pos] == rid
    base = table[row_ids].to(torch.float32)
    if drift_steps > 0:
        base = drift_rows(base, drift_steps, lr, wd, l2, blocks)
    return torch.where(hit[..., None], wvals[pos], base)


def drift_table_l2(table: torch.Tensor, n_steps: int, lr: float, wd: float,
                   l2: float, blocks=None) -> torch.Tensor:
    """sum(drift(w)^2) over the whole table, f32 0-dim: the same for every
    candidate of a regroup, so it is computed once per regroup. Its
    scratch (an f32 copy of the table, two f32 moments and a zero
    gradient) is freed when it returns."""
    return torch.sum(torch.square(drift_rows(table, n_steps, lr, wd, l2,
                                             blocks)))


def overlay_l2_correction(table: torch.Tensor, ws: torch.Tensor,
                          wvals: torch.Tensor, drift_steps: int, lr: float,
                          wd: float, l2: float, blocks=None) -> torch.Tensor:
    """What turns ``drift_table_l2`` into this candidate's post-chain table
    L2: the compact chain values' squares in place of the working set's
    drifted squares, each row once (its first slot)."""
    first = torch.ones_like(ws, dtype=torch.bool)
    first[1:] = ws[1:] != ws[:-1]
    first = first.to(torch.float32)
    drifted = drift_rows(table[ws], drift_steps, lr, wd, l2, blocks)
    return (torch.sum(torch.sum(torch.square(wvals), dim=1) * first)
            - torch.sum(torch.sum(torch.square(drifted), dim=1) * first))
