"""PEPNet (Chang et al., KDD 2023, arXiv:2302.01115) with the DCN and
self-attention side logits of the reference zoo, in plain PyTorch: the
reference of configurations whose ``model`` is ``pepnet``
(``perfbench.registry``).

The block is the Gate NU: a two-layer MLP (ReLU, then dropout at the rate
the unit is given) whose output is 2 * sigmoid, so that a gate of 1 leaves
its input as it is and the gate can scale it up to 2x.

* EPNet: one Gate NU on [stop-gradient(embedding) || domain embedding]
  scales the whole flattened embedding E (F x D wide).
* PPNet: before each of the towers' layers (``tower_dims``) a Gate NU on
  [stop-gradient(E) || EPNet's output] gives T x d_in numbers, cut into T
  chunks, one per tower; each chunk scales that tower's input to the
  layer. The towers start from E itself, each gated by its own chunk.
* A tower layer is one [d_in, d_out] kernel and bias shared by the T
  towers, then a BatchNorm whose statistics are kept per tower under one
  affine shared by the towers, ReLU and dropout; a bias-free Linear(1)
  per tower gives the tower's logit.

Departures from the paper, all of them the AREAD repository's baseline
(``model/pepnet.py`` at its ``config.py`` defaults):

* the towers are the domain groups of ``domain2group`` (T of them), not
  tasks: each row is scored by its group's tower and trained on its one
  label, as MMoE's towers are;
* the side logits come from the AREAD repository, not the paper: a
  linear head on E, a DCN cross network with a bias-free Linear(1), and
  the AutoInt-style self-attention of ``mmoe.attention_side``, added to
  every tower's logit;
* the wiring of the gates' inputs is the repository's: PPNet's gates read
  [stop-gradient(E) || EPNet's output], the towers start from E, and
  E stands for the paper's personal prior (no separate user, item and
  author embeddings); where the paper's figure wires these otherwise,
  this file follows the repository;
* PPNet's Gate NUs have no dropout (only EPNet's has the model's rate),
  and the tower layer's kernel is shared by the towers (the paper gives
  each task its own DNN).

Dropout draws come from the configuration's generator in the port's
order: EPNet's hidden layer, the attention weights layer by layer, then
each tower layer's output.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.reference.layers import (Net, Products, bce_logits, field_num,
                                        head_specs, mlp_macs, reg_loss)
from perfbench.reference.mmoe import attention_side

REG_RULES = (r"^linear/kernel$", r"^epnet/.*kernel$", r"^ppnet/.*kernel",
             r"^ppnet/bn_\d+/scale$", r"^cn/w_\d+$")
# the Gate NUs' hidden width (the repository's gate_hidden_dim)
GATE_HIDDEN = 64


def n_tower(cfg: Dict) -> int:
    return max(cfg["domain2group"]) + 1


def gate_specs(name: str, din: int, dout: int):
    h = GATE_HIDDEN
    return [(f"{name}.fc1.kernel", (din, h), "kernel"),
            (f"{name}.fc1.bias", (h,), ("bias", din)),
            (f"{name}.fc2.kernel", (h, dout), "kernel"),
            (f"{name}.fc2.bias", (dout,), ("bias", h))]


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, how it is drawn) of every weight and statistic, under
    the port's own names; the BatchNorm running statistics are buffers,
    like the table."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    a = cfg["atten_embed_dim"]
    t = n_tower(cfg)
    head = head_specs(cfg)
    s = head[:3] + gate_specs("epnet", flat + e, flat) + head[3:]
    s += [("cn_linear.kernel", (flat, 1), "kernel"),
          ("atten.atten_embedding.kernel", (e, a), "kernel"),
          ("atten.atten_embedding.bias", (a,), ("bias", e))]
    for i in range(cfg["att_layer_num"]):
        s += [(f"atten.attn_{i}.in_proj_kernel", (a, 3 * a), "kernel"),
              (f"atten.attn_{i}.in_proj_bias", (3 * a,), ("bias", a)),
              (f"atten.attn_{i}.out_proj.kernel", (a, a), "kernel"),
              (f"atten.attn_{i}.out_proj.bias", (a,), ("bias", a))]
    s += [("atten.v_res.kernel", (e, a), "kernel"),
          ("atten.v_res.bias", (a,), ("bias", e)),
          ("atten.atten_linear.kernel", (field_num(cfg) * a, 1), "kernel")]
    dims = [flat] + list(cfg["tower_dims"])
    for i, (d, f) in enumerate(zip(dims, dims[1:])):
        s += [(f"ppnet.kernel_{i}", (d, f), "kernel"),
              (f"ppnet.bias_{i}", (f,), ("bias", d))]
        s += gate_specs(f"ppnet.gate_{i}", 2 * flat, d * t)
        s += [(f"ppnet.bn_{i}.scale", (f,), "bn_scale"),
              (f"ppnet.bn_{i}.bias", (f,), "bn_bias"),
              (f"ppnet.bn_{i}.mean", (t, f), "bn_mean"),
              (f"ppnet.bn_{i}.var", (t, f), "bn_var")]
    return s + [("ppnet_linears.kernel", (t, dims[-1], 1), "kernel")]


def gate_nu(net: Net, name: str, x, dropout: bool):
    """2 * sigmoid(fc2(dropout(relu(fc1(x))))), the dropout at the model's
    rate where ``dropout``, else none."""
    h = torch.relu(net.dense(name + ".fc1", x))
    if dropout:
        h = net.dropout(h)
    return 2.0 * torch.sigmoid(net.dense(name + ".fc2", h))


def forward(net: Net, x, group, rows=None):
    """The logit [B] of each row's group tower plus the linear, cross and
    attention side logits; plus the gathered rows. The products are
    float32 with TF32 off (the control rounds its operands to TF32 itself,
    ``layers.Products``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, P = net.cfg, net.P
    emb, rows = net.embed(x, rows)
    B = emb.shape[0]
    flat = emb.reshape(B, -1)
    dom = emb[:, cfg["domain_idx"], :]
    ep = flat * gate_nu(net, "epnet", torch.cat([flat.detach(), dom], -1),
                        dropout=True)
    side = net.dense("linear", flat)
    if cfg["use_dcn"]:
        side = side + net.dense("cn_linear", net.cross(flat), bias=False)
    if cfg["use_atten"]:
        side = side + attention_side(net, flat)
    t = n_tower(cfg)
    gate_in = torch.cat([flat.detach(), ep], -1)
    h = flat[:, None, :].expand(B, t, flat.shape[-1])
    for i in range(len(cfg["tower_dims"])):
        w = gate_nu(net, f"ppnet.gate_{i}", gate_in, dropout=False)
        h = h * w.reshape(B, t, h.shape[-1])
        h = net.p.ein("btd,df->btf", h, P[f"ppnet.kernel_{i}"]) \
            + P[f"ppnet.bias_{i}"]
        h = net.dropout(torch.relu(net.bn(f"ppnet.bn_{i}", h)))
    towers = net.stacked("ppnet_linears", h, bias=False)[..., 0]
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


def gate_macs_per_row(cfg: Dict) -> int:
    """Multiply-adds of one row through the five Gate NUs."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    t = n_tower(cfg)
    macs = mlp_macs(1, flat + e, (GATE_HIDDEN, flat))
    for d in [flat] + list(cfg["tower_dims"][:-1]):
        macs += mlp_macs(1, 2 * flat, (GATE_HIDDEN, t * d))
    return macs


def forward_macs_per_row(cfg: Dict) -> int:
    """Multiply-adds of one row's forward through the products."""
    e = cfg["embed_dim"]
    flat = field_num(cfg) * e
    t = n_tower(cfg)
    dims = cfg["tower_dims"]
    macs = flat + cfg["n_cross_layers"] * flat + flat  # linear, cross, cn
    macs += gate_macs_per_row(cfg)
    macs += mlp_macs(t, flat, dims) + t * dims[-1]  # shared layers, heads
    f, a = field_num(cfg), cfg["atten_embed_dim"]
    macs += f * e * a * 2  # the projection and the value residual
    macs += cfg["att_layer_num"] * (f * a * 3 * a + 2 * f * f * a + f * a * a)
    return macs + f * a
