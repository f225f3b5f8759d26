"""The port's zoo models (aread_tpu_torch/models/: DeepFM, DCN, DCNv2 in
two structures, AutoInt, MMoE, PLE, PEPNet / EPNet / EPNet-single, STAR)
against the JAX package's, from the same weights (carried by aread_tpu_torch/
convert.py) on the same seed-made batch: the eval forward; the train
forward with dropout 0 on a padded batch (masked BatchNorm), the gradient
of the Trainer's loss for every dense parameter and for the gathered rows
(against the JAX perturbation tap), and the updated BatchNorm running
statistics; the regularization_loss values. Tolerance atol 1e-5: f32
products summed in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.base import gather_group as j_gather_group
from aread_tpu.models.base import regularization_loss as j_reg_loss
from aread_tpu.models.autoint import AutoInt as JAutoInt
from aread_tpu.models.dcn import DCN as JDCN
from aread_tpu.models.dcnv2 import DCNv2 as JDCNv2
from aread_tpu.models.deepfm import DeepFM as JDeepFM
from aread_tpu.models.mmoe import MMoE as JMMoE
from aread_tpu.models.pepnet import PEPNet as JPEPNet
from aread_tpu.models.ple import PLE as JPLE
from aread_tpu.models.star import STAR as JSTAR
from aread_tpu.train.trainer import (bce_with_logits as j_bce,
                                     masked_mean as j_masked_mean,
                                     perturbation_zeros, split_variables,
                                     strip_table_rule)
from aread_tpu_torch.convert import convert_variables, flatten
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models.autoint import AutoInt
from aread_tpu_torch.models.base import gather_group, regularization_loss
from aread_tpu_torch.models.dcn import DCN
from aread_tpu_torch.models.dcnv2 import DCNv2
from aread_tpu_torch.models.deepfm import DeepFM
from aread_tpu_torch.models.mmoe import MMoE
from aread_tpu_torch.models.pepnet import PEPNet
from aread_tpu_torch.models.ple import PLE
from aread_tpu_torch.models.star import STAR
from aread_tpu_torch.train import trainer as T

E, N_DOMAIN, BS = 8, 4, 64
D2G = np.array([0, 1, 2, 1])
SIDE_ATT = dict(atten_embed_dim=8, att_layer_num=1, att_head_num=2)
MODELS = {
    "deepfm": (JDeepFM, DeepFM, dict(mlp_dims=(16, 8))),
    "dcn": (JDCN, DCN, dict(n_cross_layers=2, mlp_dims=(16, 8))),
    "mmoe": (JMMoE, MMoE, dict(
        n_tower=3, n_expert=2, expert_dims=(16, 8), tower_dims=(8, 4),
        n_cross_layers=2, atten_embed_dim=8, att_layer_num=2,
        att_head_num=2)),
    "dcnv2": (JDCNv2, DCNv2, dict(n_cross_layers=2, mlp_dims=(16, 8),
                                  low_rank=4, num_experts=2)),
    "dcnv2-stacked-v2": (JDCNv2, DCNv2, dict(
        n_cross_layers=2, mlp_dims=(16, 8), use_low_rank_mixture=False,
        model_structure="stacked")),
    "autoint": (JAutoInt, AutoInt, dict(
        atten_embed_dim=8, att_layer_num=2, att_head_num=2,
        mlp_dims=(16, 8))),
    "ple": (JPLE, PLE, dict(
        n_tower=3, n_expert_specific=2, n_expert_shared=2,
        expert_dims=((16,), (8,)), tower_dims=(8, 4), n_cross_layers=2,
        **SIDE_ATT)),
    "pepnet": (JPEPNet, PEPNet, dict(
        n_tower=3, tower_dims=(16, 8), gate_hidden_dim=8, use_ppnet=True,
        n_cross_layers=2, **SIDE_ATT)),
    "epnet": (JPEPNet, PEPNet, dict(
        n_tower=3, tower_dims=(16, 8), gate_hidden_dim=8, use_ppnet=False,
        n_cross_layers=2, **SIDE_ATT)),
    "epnet-single": (JPEPNet, PEPNet, dict(
        n_tower=1, tower_dims=(16, 8), gate_hidden_dim=8, use_ppnet=False,
        n_cross_layers=2, **SIDE_ATT)),
    "star": (JSTAR, STAR, dict(n_tower=3, tower_dims=(16, 8), **SIDE_ATT)),
}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def seeded_variables(module, *args, seed: int = 0, **kw):
    """The variables ``module.init(*args, **kw)`` would make, drawn from a
    numpy seed over their shapes (``jax.eval_shape``: nothing compiles):
    the table N(0, 1), BatchNorm scales and running variances around 1,
    every other leaf U(-b, b) with b = 1/sqrt(fan_in) (0.3 for vectors)."""
    shapes = jax.eval_shape(lambda r: module.init(
        {"params": r, "dropout": r}, *args, **kw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        name = path[-1].key
        if name == "table":
            a = rng.standard_normal(sd.shape)
        elif name in ("scale", "var"):
            a = 0.5 + np.abs(rng.standard_normal(sd.shape))
        else:
            b = 1 / np.sqrt(sd.shape[-2]) if len(sd.shape) >= 2 else 0.3
            a = rng.uniform(-b, b, sd.shape)
        return jnp.asarray(a, sd.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=list(MODELS))
def setup(request):
    name = request.param
    jcls, tcls, kw = MODELS[name]
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    # the dense path's table: unpadded [n_rows, E]
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    jm = jcls(spec=jspec, embed_dim=E, dropout=0.0, **kw)
    x = data.train_x[:BS]
    group = D2G[x[:, data.spec.domain_idx]].astype(np.int32)
    # non-trivial running statistics and BatchNorm scales
    params, state = split_variables(seeded_variables(
        jm, jnp.asarray(x), train=False))
    tm = tcls(data.spec, E, dropout=0.0, device="cpu", **kw)
    sd = convert_variables(_np_tree(params), _np_tree(state["batch_stats"]), E)
    assert set(sd) == set(tm.state_dict())
    assert sd["embedding.table"].shape == (data.spec.n_rows, E)
    tm.load_state_dict(sd)
    return dict(name=name, jm=jm, tm=tm, params=params, state=state, x=x,
                y=data.train_y[:BS].astype(np.float32), group=group,
                multi=name in T.MULTI_TOWER_MODELS)


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=1e-5, err_msg=name)


def test_forward_eval_matches_jax(setup):
    s = setup
    jout = jax.jit(lambda v, x, g: s["jm"].apply(v, x, group=g, train=False))(
        {"params": s["params"], **s["state"]}, jnp.asarray(s["x"]),
        jnp.asarray(s["group"]))
    with torch.no_grad():
        tout = s["tm"](torch.tensor(s["x"]), group=torch.tensor(s["group"]),
                       train=False)
    want_shape = (BS, 3) if s["multi"] else (BS,)
    assert tuple(tout["logit"].shape) == want_shape
    for k in ("logit", "prob"):
        _close(tout[k].numpy(), jout[k], k)
    if s["multi"]:
        _close(gather_group(tout["prob"], torch.tensor(s["group"])).numpy(),
               j_gather_group(jout["prob"], jnp.asarray(s["group"])),
               "gathered prob")


def test_train_forward_and_gradients_match_jax(setup):
    s = setup
    x, y, group = s["x"], s["y"], s["group"]
    valid = np.ones((BS,), np.float32)
    valid[-5:] = 0.0  # padded rows stay out of the BatchNorm statistics
    rules = strip_table_rule(type(s["jm"]).REG_RULES)

    def jloss(params, pert):
        out, new_state = s["jm"].apply(
            {"params": params, **s["state"], "perturbations": pert},
            jnp.asarray(x), group=jnp.asarray(group), train=True,
            mask=jnp.asarray(valid), mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        logit = out["logit"]
        if s["multi"]:
            logit = j_gather_group(logit, jnp.asarray(group))
        loss = j_masked_mean(j_bce(logit, y), valid) + j_reg_loss(params, rules)
        return loss, (out, new_state)

    pert0 = perturbation_zeros(s["jm"].spec, jnp.asarray(x), E)
    (jl, (jout, jstate)), (jgp, jg) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(s["params"], pert0)

    tm = s["tm"]
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    tout = tm(torch.tensor(x), group=torch.tensor(group), train=True,
              mask=torch.tensor(valid), tap=True)
    logit = tout["logit"]
    if s["multi"]:
        logit = gather_group(logit, torch.tensor(group))
    dense = tm.dense_named_parameters()
    assert "embedding/table" not in dense
    loss = (T.masked_mean(T.bce_with_logits(logit, torch.tensor(y)),
                          torch.tensor(valid))
            + regularization_loss(dense, T.strip_table_rule(type(tm).REG_RULES)))
    grads = torch.autograd.grad(loss, [tout["rows"]] + list(dense.values()),
                                materialize_grads=True)
    _close(tout["logit"].detach().numpy(), jout["logit"], "logit")
    _close(float(loss.detach()), float(jl), "loss")
    _close(grads[0].numpy(), jg["embedding"]["rows"], "d loss / d rows")
    want = flatten(_np_tree(jgp))
    assert set(want) - {"embedding/table"} == set(dense)
    for name, g in zip(dense, grads[1:]):
        _close(g.numpy(), want[name], f"d loss / d {name}")
    stats = tm.state_dict()
    jstats = flatten(_np_tree(jstate["batch_stats"]))
    assert jstats
    for path, w in jstats.items():
        _close(stats[path.replace("/", ".")].numpy(), w, path)
        assert not torch.equal(stats[path.replace("/", ".")],
                               saved[path.replace("/", ".")]), path
    tm.load_state_dict(saved)


def test_regularization_loss_matches_jax(setup):
    """The full rule set, the table's and the BatchNorm scales' terms
    included; rtol 1e-6 (f32 sums in another order)."""
    s = setup
    assert type(s["tm"]).REG_RULES == tuple(type(s["jm"]).REG_RULES)
    named = dict(s["tm"].dense_named_parameters())
    named["embedding/table"] = s["tm"].embedding.table
    got = regularization_loss(named, type(s["tm"]).REG_RULES)
    want = j_reg_loss(s["params"], type(s["jm"]).REG_RULES)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the BatchNorm-scale rule bites: without it the value drops (STAR
    # has no such rule)
    no_bn = tuple(r for r in type(s["tm"]).REG_RULES if "bn_" not in r[0])
    if no_bn != type(s["tm"]).REG_RULES:
        assert float(regularization_loss(named, no_bn)) < float(got)
    np.testing.assert_allclose(
        float(T.table_reg_value(s["tm"].embedding.table)),
        1e-5 * float(np.sum(np.square(
            np.asarray(s["params"]["embedding"]["table"], np.float64)))),
        rtol=1e-6)
