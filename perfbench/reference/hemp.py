"""One HEMP candidate chain in plain PyTorch (AREAD's fast adaptation,
AAAI'25): from the weights at the regroup's start, a fresh Adam at
``update_lr`` takes ``regroup_update_step`` bagging steps in the
candidate's mask, each followed by a progressive prune of the mask by the
step's mean gate values (the 5% quantile of the positive ones, the mask
repaired and kept only if an output survives); then ``regroup_eval_step``
probes, each the masked-mean BCE of the pruned mask's probability in
evaluation mode plus the L2 terms of the adapted weights.

The prune and the repair follow the reference implementation's numpy
rules, written out here on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import aread as A
from perfbench.reference import optim as O
from perfbench.reference.layers import (TABLE_L2, Net, Products, is_buffer,
                                        reg_loss)

F32 = torch.float32


def repair(mask: List[np.ndarray]) -> List[np.ndarray]:
    """Input edges for live level-0 towers, output edges for live leaves,
    then every hidden tower without an in- or an out-edge cut, until none
    is left."""
    m = [x.copy() for x in mask]
    n_level = len(m) - 1
    m[0] = m[0] | m[1].any(axis=1)[None, :]
    m[-1] = m[-1] | m[-2].any(axis=0)[:, None]
    changed = True
    while changed:
        changed = False
        for l in range(1, n_level):
            for t in range(m[l].shape[1]):
                dead = not m[l][:, t].any() or not m[l + 1][t, :].any()
                if dead and (m[l][:, t].any() or m[l + 1][t, :].any()):
                    m[l][:, t] = False
                    m[l + 1][t, :] = False
                    changed = True
    return m


def prune(mask: List[np.ndarray], gate_means: Sequence[np.ndarray],
          ratio: float = 0.05) -> List[np.ndarray]:
    thr = 1.0
    for g in gate_means:
        pos = g[g > 1e-8]
        if pos.size:
            thr = min(thr, float(np.quantile(pos.ravel(), ratio)))
    if thr == 1.0:
        return [x.copy() for x in mask]
    new = [x.copy() for x in mask]
    for li, g in enumerate(gate_means):
        new[li + 1] = new[li + 1] & (g >= thr)
    new = repair(new)
    return new if new[-1].any() else [x.copy() for x in mask]


def dropout_shapes(cfg: Dict, rows: int) -> List[tuple]:
    """The shapes AREAD's training forward draws dropout masks of, in
    order: the experts' layers, then each tower level's layers."""
    n_exp = cfg["mmoe_n_expert"]
    shapes = [(rows, n_exp, d) for d in cfg["mlp_dims"]]
    for t, dims in zip(A.n_towers(cfg), cfg["aread_tower_dims"]):
        shapes += [(rows, t, d) for d in dims]
    return shapes


def skip_forwards(gen: torch.Generator, cfg: Dict, rows: int, n: int,
                  device) -> None:
    """Advance the dropout generator past ``n`` training forwards."""
    if cfg["dropout"] <= 0:
        return
    for _ in range(n):
        for s in dropout_shapes(cfg, rows):
            torch.rand(s, generator=gen, device=device)


def chain(cfg: Dict, W: Dict[str, torch.Tensor], adapt: List[Dict],
          probes: List[Dict], mask: List[np.ndarray], gen: torch.Generator,
          prods: Products, fault=None):
    """(the pruned mask, the probe losses [P]) of one candidate. ``fault``
    plants one in the adapt steps: 'half' leaves half of each batch out
    (the mean over the rest), 'unchanged' returns the state unchanged."""
    dev = W["linear.kernel"].device
    P = {k: v.clone() for k, v in W.items()}
    dense = [k for k in P if not is_buffer(k)]
    state = O.fresh_state({k: P[k] for k in dense + ["embedding.table"]},
                          getattr(torch, cfg["table_moments_dtype"]))
    lr = cfg["update_lr"]
    m = [x.copy() for x in mask]
    for t, b in enumerate(adapt, 1):
        if fault == "half":
            keep = (torch.arange(len(b["valid"]), device=dev) % 2 == 0).to(F32)
            b = dict(b, valid=b["valid"] * keep, y=b["y"] * keep)
        Pd = {k: P[k].detach().requires_grad_(True) for k in dense}
        net = Net(cfg, {**P, **Pd}, prods, train=True, valid=b["valid"],
                  gen=gen, update_stats=fault != "unchanged")
        table = P["embedding.table"]
        ids = net.row_ids(b["x"])
        rows = table[ids].to(F32).requires_grad_(True)
        tm = [torch.as_tensor(x, device=dev) for x in m]
        loss, out = A.train_loss(cfg, net, dict(b, masks=tm), rows)
        grads = torch.autograd.grad(loss, [Pd[k] for k in dense] + [rows],
                                    allow_unused=True)
        m = prune(m, [g.cpu().numpy() for g in out["gate_means"]])
        if fault == "unchanged":
            continue
        G = torch.zeros(table.shape, dtype=F32, device=dev)
        G.index_add_(0, ids.reshape(-1), grads[-1].reshape(-1, G.shape[1]))
        mt, vt = state["embedding.table"]
        P["embedding.table"], m2, v2 = O.adam_table(
            table, mt, vt, G, t, lr, cfg["wd"], TABLE_L2)
        state["embedding.table"] = (m2, v2)
        for k, g in zip(dense, grads):
            O.adam_dense_(P[k], torch.zeros_like(P[k]) if g is None else g,
                          *state[k], t, lr, cfg["wd"])
        del G, grads, rows
    tm = [torch.as_tensor(x, device=dev) for x in m]
    losses = []
    with torch.no_grad():
        reg = reg_loss(A.REG_RULES, P) + TABLE_L2 * torch.sum(
            torch.square(P["embedding.table"].to(F32)))
        for b in probes:
            net = Net(cfg, P, prods, train=False)
            p = torch.clamp(A.forward(net, b["x"], tm)["prob"],
                            1e-7, 1 - 1e-7)
            y, valid = b["y"], b["valid"]
            bce = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
            losses.append(float((bce * valid).sum()
                                / torch.clamp(valid.sum(), min=1.0) + reg))
    return m, losses
