"""The port's PEPNet against the benchmark's plain reference
(``perfbench/reference/pepnet.py``), on the CPU at a small width: a vocab
of 395 ids (a 400-row table), 5 domains in T = 3 groups, embed 8, the
published tower and gate widths, bs 64. One set of seed-made weights
(``perfbench.inputs.make_weights``) is loaded into both sides by name.

Compared: the evaluation logits; the training logits at dropout 0 and
0.2, both sides drawing dropout from generators seeded alike; the loss and
every leaf's gradient, the gathered rows' too; the BatchNorm running
statistics after one training forward; one Adam step through the port's
``Trainer`` on the sparse table path (bf16 table and moments) against the
reference's Adam. Then the same comparisons with the reference's products
rounded to TF32 must fail.

Tolerances. Both sides compute in float32 with the same products, but the
port's ``matmul`` / ``einsum`` and the reference's ``torch.einsum`` may
take other CPU GEMM paths, which sum the same terms in another order:
each product's result can move by a few ulps of the sum of the magnitudes
of its terms, and the layers carry that forward. So the forward and the
gradients are held at a relative 1e-5 of each tensor's largest entry (the
sums here are of at most 576 terms, whose round-off reaches ~2e-7
relative; 1e-5 leaves 50x for the layers that follow), and the logits at
an absolute 1e-5 (they are of order 1). TF32 keeps 10 of float32's 23
mantissa bits: its products move by ~1e-3 relative, 100x the tolerance.
The Adam step moves each dense entry by lr * m / sqrt(v), about lr for a
first step, so a gradient that is only round-off (a bias that feeds a
BatchNorm: its true gradient is 0) can flip its sign: those biases are
compared by their size alone (|step| <= 1.01 lr), every other dense
entry within 2 ulps of the leaf's largest weight plus lr x 1e-5: the step
itself is the sign of the gradient to within its relative error, and
w - step rounds once on each side (1 ulp of the weight is what the two
sides were seen to differ by). Because a first Adam step is the
gradient's sign, TF32 products move it little: the control fails the
step's reported loss, which carries the forward's products. The table is stored in
bfloat16 by stochastic rounding keyed by the element and the step, on
both sides the same: an f32 value that differs in its last bits can round
to the other neighbour, so the table may differ by one bf16 ulp in at
most 0.5% of its entries, and not at all elsewhere.

Torch runs on one thread (a module fixture): the suite's workers share the
host's cores."""

import json

import numpy as np
import pytest
import torch

from aread_tpu_torch.models.base import gather_group, regularization_loss
from aread_tpu_torch.models.pepnet import PEPNet
from aread_tpu_torch.train.trainer import (Trainer, bce_with_logits,
                                           masked_mean, split_table,
                                           strip_table_rule)
from perfbench import inputs
from perfbench.driving import feature_spec, load_weights, program_config
from perfbench.reference import optim as O
from perfbench.reference import pepnet as ref
from perfbench.reference.layers import (TABLE_L2, Net, Products, is_buffer,
                                        round_tf32)
from perfbench.run import ROOT

SEED, PSEED, BS = 3_000_000_019, 12_345, 64
TINY = {"one_hot_dims": [300, 7, 5, 10, 11, 50, 12],
        "domain_size": [400, 300, 200, 100, 50],
        "domain2group": [0, 1, 0, 2, 1], "embed_dim": 8, "bs": BS}
REL, LOGIT_ATOL = 1e-5, 1e-5
STEP_ULPS, STEP_REL = 2, 1e-5
PRE_BN_BIAS = r"^ppnet\.bias_\d+$"
TABLE_FLIPS = 0.005


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(dropout: float) -> dict:
    cfg = json.loads((ROOT / "perfbench/configs/pepnet-amazon25.json")
                     .read_text())
    cfg.update(TINY, dropout=dropout)
    return cfg


@pytest.fixture(scope="module")
def data():
    cfg = config(0.2)
    mix = json.loads((ROOT / "perfbench/traffic/train.json").read_text())
    x, y = inputs.make_rows(cfg, mix, SEED, BS, "cpu")
    d2g = torch.tensor(cfg["domain2group"])
    valid = torch.ones(BS)
    valid[-5:] = 0.0  # padding rows: out of the mean and the statistics
    return {"x": x, "y": y, "valid": valid,
            "domain": x[:, cfg["domain_idx"]].to(torch.int32),
            "group": d2g[x[:, cfg["domain_idx"]].to(torch.int64)]}


def port_model(cfg):
    model = build(cfg)
    load_weights(model, inputs.make_weights(cfg, SEED, "cpu"))
    return model


def build(cfg):
    from aread_tpu_torch.models import build_model

    return build_model(program_config(cfg, PSEED), feature_spec(cfg),
                       len(cfg["domain_size"]), device="cpu")


def ref_params(cfg, grad: bool = False):
    P = {k: v.clone() for k, v in inputs.make_weights(cfg, SEED,
                                                      "cpu").items()}
    if grad:
        for k, v in P.items():
            if not is_buffer(k):
                v.requires_grad_(True)
    return P


def close(a, b, rel=REL) -> bool:
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= rel * scale


# ----------------------------------------------------------- forwards
def ref_logit(cfg, P, batch, prods, train, gen=None, update=False):
    net = Net(cfg, P, prods, train=train, valid=batch["valid"], gen=gen,
              update_stats=update)
    return ref.forward(net, batch["x"], batch["group"])["logit"]


def port_logit(model, batch, train, gen=None):
    out = model(batch["x"], group=batch["group"], train=train,
                mask=batch["valid"], generator=gen)
    return gather_group(out["logit"], batch["group"])


def gen():
    return torch.Generator().manual_seed(PSEED)


@torch.no_grad()
def test_eval_logits(data):
    cfg = config(0.2)
    want = ref_logit(cfg, ref_params(cfg), data, Products("f32"), False)
    got = port_logit(port_model(cfg), data, False)
    assert float((got - want).abs().max()) <= LOGIT_ATOL
    tf32 = ref_logit(cfg, ref_params(cfg), data, Products("tf32"), False)
    assert float((tf32 - want).abs().max()) > LOGIT_ATOL


@pytest.mark.parametrize("rate", [0.0, 0.2])
@torch.no_grad()
def test_train_logits_on_one_dropout_stream(data, rate):
    cfg = config(rate)
    want = ref_logit(cfg, ref_params(cfg), data, Products("f32"), True,
                     gen())
    got = port_logit(port_model(cfg), data, True, gen())
    assert float((got - want).abs().max()) <= LOGIT_ATOL
    # the reference with the port's draws: another stream would differ
    other = ref_logit(cfg, ref_params(cfg), data, Products("f32"), True,
                      torch.Generator().manual_seed(PSEED + 1))
    assert (rate == 0.0) == bool(
        float((other - want).abs().max()) <= LOGIT_ATOL)


@torch.no_grad()
def test_running_statistics_after_one_forward(data):
    cfg = config(0.2)
    model = port_model(cfg)
    port_logit(model, data, True, gen())
    P = ref_params(cfg)
    ref_logit(cfg, P, data, Products("f32"), True, gen(), update=True)
    sd = model.state_dict()
    names = [k for k in P if k.endswith((".mean", ".var"))]
    assert len(names) == 8
    W = inputs.make_weights(cfg, SEED, "cpu")
    for k in names:
        assert not torch.equal(sd[k], W[k]), k  # the forward moved them
        assert close(sd[k], P[k]), k


# ------------------------------------------------- loss and gradients
def port_grads(cfg, batch):
    model = port_model(cfg)
    _, rest = split_table(model)
    out = model(batch["x"], group=batch["group"], train=True,
                mask=batch["valid"], generator=gen(), tap=True)
    loss = masked_mean(bce_with_logits(
        gather_group(out["logit"], batch["group"]), batch["y"]),
        batch["valid"]) + regularization_loss(
            rest, strip_table_rule(PEPNet.REG_RULES))
    grads = torch.autograd.grad(loss, list(rest.values()) + [out["rows"]])
    g = {n.replace("/", "."): t for n, t in zip(rest, grads)}
    g["rows"] = grads[-1]
    return float(loss.detach()), g


def ref_grads(cfg, batch, prods):
    P = ref_params(cfg, grad=True)
    net = Net(cfg, P, prods, train=True, valid=batch["valid"], gen=gen())
    rows = net.gather(batch["x"]).requires_grad_(True)
    loss, _ = ref.train_loss(cfg, net, batch, rows)
    dense = [k for k in P if not is_buffer(k)]
    grads = torch.autograd.grad(loss, [P[k] for k in dense] + [rows])
    g = dict(zip(dense, grads))
    g["rows"] = grads[-1]
    return float(loss.detach()), g


def grad_misses(got, want):
    return [k for k in want if not close(got[k], want[k])]


def test_loss_and_every_gradient(data):
    cfg = config(0.2)
    loss, got = port_grads(cfg, data)
    ref_loss, want = ref_grads(cfg, data, Products("f32"))
    assert set(got) == set(want)
    assert len(want) == 63 + 1  # every dense leaf and the rows
    assert abs(loss - ref_loss) <= REL * abs(ref_loss)
    assert grad_misses(got, want) == []
    tf_loss, tf = ref_grads(cfg, data, Products("tf32"))
    assert (abs(tf_loss - ref_loss) > REL * abs(ref_loss)
            or grad_misses(tf, want))


def test_tf32_rounding_moves_products():
    x = torch.tensor([1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    assert torch.equal(round_tf32(x), torch.tensor([1.0, 3.0]))


# ------------------------------------------------------- one Adam step
def ref_step(cfg, batch, prods):
    """One step of the reference's Adam on the seed-made weights: the
    dense leaves and the table (its L2 and decay on every row)."""
    P = ref_params(cfg)
    dense = [k for k in P if not is_buffer(k)]
    Pd = {k: P[k].detach().requires_grad_(True) for k in dense}
    net = Net(cfg, {**P, **Pd}, prods, train=True, valid=batch["valid"],
              gen=gen())
    table = P["embedding.table"]
    ids = net.row_ids(batch["x"])
    rows = table[ids].to(torch.float32).requires_grad_(True)
    loss, _ = ref.train_loss(cfg, net, batch, rows)
    grads = torch.autograd.grad(loss, [Pd[k] for k in dense] + [rows])
    G = torch.zeros(table.shape)
    G.index_add_(0, ids.reshape(-1), grads[-1].reshape(-1, G.shape[1]))
    state = O.fresh_state({k: P[k] for k in dense + ["embedding.table"]},
                          torch.bfloat16)
    m, v = state["embedding.table"]
    P["embedding.table"], _, _ = O.adam_table(table, m, v, G, 1, cfg["lr"],
                                              cfg["wd"], TABLE_L2)
    for k, g in zip(dense, grads):
        O.adam_dense_(P[k], g, *state[k], 1, cfg["lr"], cfg["wd"])
    return float(loss.detach() + TABLE_L2 * O.table_sq(table)), P


def step_misses(cfg, got, want, w0):
    import re

    bad = []
    for k, w in want.items():
        if k.endswith((".mean", ".var")) or k == "embedding.table":
            continue
        if re.match(PRE_BN_BIAS, k):
            if float((got[k] - w0[k]).abs().max()) > 1.01 * cfg["lr"]:
                bad.append(k)
        elif float((got[k] - w).abs().max()) > (
                STEP_ULPS * 2.0 ** -23 * float(w.abs().max())
                + STEP_REL * cfg["lr"]):
            bad.append(k)
    t_got, t_want = got["embedding.table"], want["embedding.table"]
    flips = (t_got != t_want)
    ulp = (t_want.to(torch.float32).abs() * 2.0 ** -7).clamp(min=1e-30)
    if (float(flips.float().mean()) > TABLE_FLIPS or float(
            ((t_got.float() - t_want.float()).abs() / ulp).max()) > 1.0):
        bad.append("embedding.table")
    return bad


def test_one_adam_step_on_the_sparse_table_path(data):
    cfg = config(0.2)
    assert cfg["sparse_table_grad"] and cfg["table_dtype"] == "bfloat16"
    model = port_model(cfg)
    tr = Trainer(model, program_config(cfg, PSEED), len(cfg["domain_size"]),
                 domain2group=np.asarray(cfg["domain2group"]))
    tr.init()
    tr.generator.manual_seed(PSEED)
    loss = float(tr.step(dict(data)))
    got = {k: v.clone() for k, v in model.state_dict().items()}
    ref_loss, want = ref_step(cfg, data, Products("f32"))
    w0 = inputs.make_weights(cfg, SEED, "cpu")
    assert abs(loss - ref_loss) <= REL * abs(ref_loss)
    assert step_misses(cfg, got, want, w0) == []
    tf_loss, tf = ref_step(cfg, data, Products("tf32"))
    assert (abs(tf_loss - ref_loss) > REL * abs(ref_loss)
            or step_misses(cfg, tf, want, w0))
