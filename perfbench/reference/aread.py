"""AREAD (AAAI'25) on its MMoE base in plain PyTorch: HEMP's masked tower
levels over shared experts, a leaf per last-level tower, the probability
averaged over a domain's active leaves. The reference of configurations
whose ``model`` is ``aread`` (``perfbench.registry``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.reference.layers import (F32, Net, Products, bce_logits,
                                        field_num, head_specs, mlp_macs,
                                        mlp_specs, reg_loss)

REG_RULES = (r"^linear/kernel$", r"^mmoe_experts/.*kernel$",
             r"^towers_\d+/.*kernel$",
             r"^(mmoe_experts|towers_\d+)/bn_\d+/scale$", r"^cn/w_\d+$")


def n_towers(cfg: Dict) -> List[int]:
    """The levels (g, 2g, 4g, ...) of the group count g."""
    g = max(cfg["domain2group"]) + 1
    return [g * 2 ** l for l in range(len(cfg["aread_tower_dims"]))]


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, how it is drawn) of every weight and statistic; the
    BatchNorm running statistics are buffers, like the table."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    n_exp = cfg["mmoe_n_expert"]
    towers = n_towers(cfg)
    dims = cfg["aread_tower_dims"]
    s = ([("group_embedding", (towers[0], e), "embed")] + head_specs(cfg)
         + mlp_specs("mmoe_experts", n_exp, flat, cfg["mlp_dims"])
         + [("mmoe_gates.kernel", (towers[0], flat, n_exp), "kernel"),
            ("mmoe_gates.bias", (towers[0], n_exp), ("bias", flat))])
    din = cfg["mlp_dims"][-1]
    for l, t in enumerate(towers):
        if l > 0:
            s += [(f"tower_gates_{l}.kernel", (t, 2 * e, towers[l - 1]),
                   "kernel"),
                  (f"tower_gates_{l}.bias", (t, towers[l - 1]),
                   ("bias", 2 * e))]
        s += mlp_specs(f"towers_{l}", t, din, dims[l])
        din = dims[l][-1]
    return s + [("towers_linear.kernel", (towers[-1], din + flat, 1),
                 "kernel"),
                ("final_gate.kernel", (2 * e, towers[-1]), "kernel")]


def forward(net: Net, x, masks: Sequence[torch.Tensor], rows=None):
    """AREAD in one domain's mask (``masks``: the levels [1, T0], [T0, T1],
    ..., [T_last, 1], boolean): per-leaf logits [B, T_last], the leaf
    activity [T_last], the gate means per level >= 1 [T_{l-1}, T_l], and
    the mask-averaged probability [B]; plus the gathered rows."""
    cfg, P = net.cfg, net.P
    towers = n_towers(cfg)
    emb, rows = net.embed(x, rows)
    B = emb.shape[0]
    dom = emb[:, cfg["domain_idx"], :]
    flat = emb.reshape(B, -1)
    lin = net.dense("linear", flat)
    cn = net.cross(flat) if cfg["use_dcn"] else None
    experts = net.mlp("mmoe_experts", flat, len(cfg["mlp_dims"]))
    gates = torch.softmax(net.stacked("mmoe_gates", flat), dim=-1)
    h = net.p.ein("bte,bed->btd", gates, experts)
    m0 = masks[0][0].to(F32)
    grp = net.p.ein("t,te->e", m0 / torch.clamp(m0.sum(), min=1e-8),
                    P["group_embedding"])
    gate_in = torch.cat([dom, grp[None, :].expand_as(dom)], dim=1)
    active = [masks[0][0]] + [masks[l].any(dim=0)
                              for l in range(1, len(towers))]
    gate_means = []
    outs = None
    for l in range(len(towers)):
        a = active[l].to(F32)[None, :, None]
        if l == 0:
            level = h * a
        else:
            g = torch.softmax(net.stacked(f"tower_gates_{l}", gate_in), dim=-1)
            g = g * masks[l].T.to(F32)[None]
            g_n = g / (g.sum(dim=-1, keepdim=True) + 1e-8)
            level = net.p.ein("btp,bpd->btd", g_n, outs)
            gate_means.append(g.detach().mean(dim=0).T)
        outs = net.mlp(f"towers_{l}", level, len(cfg["aread_tower_dims"][l]),
                       gate=active[l]) * a
    if cn is not None:
        outs = torch.cat([cn[:, None, :].expand(B, towers[-1], cn.shape[1]),
                          outs], dim=-1)
    leaf_logit = net.stacked("towers_linear", outs, bias=False)[..., 0] + lin
    leaf_active = masks[-1][:, 0]
    la = leaf_active.to(F32)
    prob = ((torch.sigmoid(leaf_logit) * la[None]).sum(dim=1)
            / torch.clamp(la.sum(), min=1e-8))
    return {"leaf_logit": leaf_logit, "leaf_active": leaf_active,
            "gate_means": gate_means, "prob": prob, "rows": rows}


def train_loss(cfg: Dict, net: Net, batch: Dict, rows=None):
    """(data loss + dense L2, the forward's outputs) of one bagging step in
    the batch's domain mask (``batch["masks"]``): the mean over active
    leaves of each leaf's masked-mean BCE."""
    y, valid = batch["y"], batch["valid"]
    n = torch.clamp(valid.sum(), min=1.0)
    out = forward(net, batch["x"], batch["masks"], rows)
    per_leaf = (bce_logits(out["leaf_logit"], y[:, None])
                * valid[:, None]).sum(dim=0) / n
    la = out["leaf_active"].to(F32)
    data = (per_leaf * la).sum() / torch.clamp(la.sum(), min=1e-8)
    return data + reg_loss(REG_RULES, net.P), out


def eval_prob(cfg: Dict, P, batch: Dict, prods: Products):
    """Served probabilities [B] in evaluation mode (running statistics, no
    dropout) through the batch's domain mask."""
    net = Net(cfg, P, prods, train=False)
    return forward(net, batch["x"], batch["masks"])["prob"]


def forward_macs_per_row(cfg: Dict) -> int:
    """Multiply-adds of one row's forward through the products."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    n_exp = cfg["mmoe_n_expert"]
    macs = flat + cfg["n_cross_layers"] * flat  # linear head, cross net
    towers = n_towers(cfg)
    macs += mlp_macs(n_exp, flat, cfg["mlp_dims"])
    macs += towers[0] * flat * n_exp + towers[0] * n_exp * cfg["mlp_dims"][-1]
    din = cfg["mlp_dims"][-1]
    for l, t in enumerate(towers):
        if l > 0:
            macs += t * 2 * e * towers[l - 1] + t * towers[l - 1] * din
        macs += mlp_macs(t, din, cfg["aread_tower_dims"][l])
        din = cfg["aread_tower_dims"][l][-1]
    return macs + towers[-1] * (din + flat)
