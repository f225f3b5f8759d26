"""MMoE (KDD'18) with the DCN and self-attention side logits of the
reference zoo, in plain PyTorch: shared experts, a gate and a tower per
domain group, each row scored by its group's tower. The reference of
configurations whose ``model`` is ``mmoe`` (``perfbench.registry``)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.reference.layers import (Net, Products, bce_logits, field_num,
                                        head_specs, mlp_macs, mlp_specs,
                                        reg_loss)

REG_RULES = (r"^linear/kernel$", r"^experts/.*/kernel$",
             r"^towers/.*/kernel$", r"^(experts|towers)/bn_\d+/scale$",
             r"^cn/w_\d+$")


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, how it is drawn) of every weight and statistic; the
    BatchNorm running statistics are buffers, like the table."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    n_exp = cfg["mmoe_n_expert"]
    g = max(cfg["domain2group"]) + 1
    a = cfg["atten_embed_dim"]
    head = head_specs(cfg)
    s = (head[:3] + mlp_specs("experts", n_exp, flat, cfg["mmoe_expert_dims"])
         + [("gates.kernel", (g, flat, n_exp), "kernel"),
            ("gates.bias", (g, n_exp), ("bias", flat))]
         + mlp_specs("towers", g, cfg["mmoe_expert_dims"][-1],
                     cfg["mmoe_tower_dims"], out=True)
         + head[3:] + [("cn_linear.kernel", (flat, 1), "kernel"),
                       ("atten.atten_embedding.kernel", (e, a), "kernel"),
                       ("atten.atten_embedding.bias", (a,), ("bias", e))])
    for i in range(cfg["att_layer_num"]):
        s += [(f"atten.attn_{i}.in_proj_kernel", (a, 3 * a), "kernel"),
              (f"atten.attn_{i}.in_proj_bias", (3 * a,), ("bias", a)),
              (f"atten.attn_{i}.out_proj.kernel", (a, a), "kernel"),
              (f"atten.attn_{i}.out_proj.bias", (a,), ("bias", a))]
    return s + [("atten.v_res.kernel", (e, a), "kernel"),
                ("atten.v_res.bias", (a,), ("bias", e)),
                ("atten.atten_linear.kernel", (field_num(cfg) * a, 1),
                 "kernel")]


def attention_side(net: Net, flat):
    """The AutoInt-style side logit: fields projected, stacked multi-head
    self-attention with dropout on the weights, a value residual, ReLU,
    a bias-free Linear(1)."""
    cfg, P = net.cfg, net.P
    F, E, A = field_num(cfg), cfg["embed_dim"], cfg["atten_embed_dim"]
    heads = cfg["att_head_num"]
    x = flat.reshape(-1, F, E)
    c = net.dense("atten.atten_embedding", x)
    B, hd = c.shape[0], A // heads
    for i in range(cfg["att_layer_num"]):
        pre = f"atten.attn_{i}"
        qkv = net.p.ein("bld,de->ble", c, P[pre + ".in_proj_kernel"]) \
            + P[pre + ".in_proj_bias"]
        q, k, v = (t.reshape(B, F, heads, hd).permute(0, 2, 1, 3)
                   for t in torch.split(qkv, A, dim=-1))
        w = torch.softmax(net.p.ein("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd),
                          dim=-1)
        o = net.p.ein("bhqk,bhkd->bhqd", net.dropout(w), v)
        c = net.dense(pre + ".out_proj", o.permute(0, 2, 1, 3).reshape(B, F, A))
    if cfg["att_res"]:
        c = c + net.dense("atten.v_res", x)
    return net.dense("atten.atten_linear", torch.relu(c).reshape(B, F * A),
                     bias=False)


def forward(net: Net, x, group, rows=None):
    """The logit [B] of each row's group tower plus the linear, cross and
    attention side logits; plus the gathered rows."""
    cfg = net.cfg
    emb, rows = net.embed(x, rows)
    flat = emb.reshape(emb.shape[0], -1)
    experts = net.mlp("experts", flat, len(cfg["mmoe_expert_dims"]))
    gates = torch.softmax(net.stacked("gates", flat), dim=-1)
    h = net.p.ein("bte,bed->btd", gates, experts)
    towers = net.mlp("towers", h, len(cfg["mmoe_tower_dims"]), out=True)[..., 0]
    side = net.dense("linear", flat)
    if cfg["use_dcn"]:
        side = side + net.dense("cn_linear", net.cross(flat), bias=False)
    if cfg["use_atten"]:
        side = side + attention_side(net, flat)
    logit = (towers + side).gather(1, group.to(torch.int64)[:, None])[:, 0]
    return {"logit": logit, "rows": rows}


def train_loss(cfg: Dict, net: Net, batch: Dict, rows=None):
    """(data loss + dense L2, the forward's outputs) of one step: the
    masked-mean BCE of each row's group tower (``batch["group"]``)."""
    y, valid = batch["y"], batch["valid"]
    n = torch.clamp(valid.sum(), min=1.0)
    out = forward(net, batch["x"], batch["group"], rows)
    data = (bce_logits(out["logit"], y) * valid).sum() / n
    return data + reg_loss(REG_RULES, net.P), out


def eval_prob(cfg: Dict, P, batch: Dict, prods: Products):
    """Probabilities [B] in evaluation mode of each row's group tower."""
    net = Net(cfg, P, prods, train=False)
    return torch.sigmoid(forward(net, batch["x"], batch["group"])["logit"])


def forward_macs_per_row(cfg: Dict) -> int:
    """Multiply-adds of one row's forward through the products."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    n_exp = cfg["mmoe_n_expert"]
    macs = flat + cfg["n_cross_layers"] * flat  # linear head, cross net
    g = max(cfg["domain2group"]) + 1
    dims = cfg["mmoe_expert_dims"]
    macs += mlp_macs(n_exp, flat, dims) + g * flat * n_exp
    macs += g * n_exp * dims[-1]
    macs += mlp_macs(g, dims[-1], cfg["mmoe_tower_dims"])
    macs += g * cfg["mmoe_tower_dims"][-1] + flat
    f, a = field_num(cfg), cfg["atten_embed_dim"]
    macs += f * e * a * 2  # the projection and the value residual
    macs += cfg["att_layer_num"] * (f * a * 3 * a + 2 * f * f * a + f * a * a)
    return macs + f * a
