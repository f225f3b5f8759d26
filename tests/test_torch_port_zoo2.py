"""The zoo's second half in the port (aread_tpu_torch/models/: HiNet,
AdaSparse, ADL) against the JAX package's, from the same weights (carried
by aread_tpu_torch/convert.py, ADL's ``model_state`` centres included) on
the same seed-made batch: the eval forward; the train forward with
dropout 0 on a padded batch, the gradient of the Trainer's loss for every
dense parameter and for the gathered rows, the updated BatchNorm
statistics and ADL's moved centres; the regularization_loss values. Then
ADL's centres through the trainers: after 3 Trainer steps, and after one
evaluation (exact and streaming) with and without eval_dlm_update, against
the JAX Trainer's threaded state. Tolerance atol 1e-5 throughout (f32
products summed in another order); without eval_dlm_update an evaluation
leaves the centres bitwise unchanged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.models.adasparse import AdaSparse as JAdaSparse
from aread_tpu.models.adl import ADL as JADL
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.base import regularization_loss as j_reg_loss
from aread_tpu.models.hinet import HiNet as JHiNet
from aread_tpu.train.trainer import (bce_with_logits as j_bce,
                                     masked_mean as j_masked_mean,
                                     perturbation_zeros, split_variables,
                                     strip_table_rule)
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_variables, flatten
from aread_tpu_torch.data.loader import GlobalBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.models.adasparse import AdaSparse
from aread_tpu_torch.models.adl import ADL
from aread_tpu_torch.models.hinet import HiNet
from aread_tpu_torch.models.base import regularization_loss
from aread_tpu_torch.train import trainer as T
from tests.test_torch_port_zoo import seeded_variables

E, N_DOMAIN, BS = 8, 4, 64
D2G = np.array([0, 1, 2, 1])
SIDE = dict(n_cross_layers=2, atten_embed_dim=8, att_layer_num=1,
            att_head_num=2)
MODELS = {
    "hinet": (JHiNet, HiNet, dict(n_tower=3, sei_dims=(8, 4),
                                  tower_dims=(16, 8), **SIDE)),
    "adasparse": (JAdaSparse, AdaSparse, dict(hidden_dims=(16, 8), **SIDE)),
    "adl": (JADL, ADL, dict(n_tower=3, tower_dims=(16, 8), **SIDE)),
}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _convert(params, state):
    """The port's state_dict from flax params and state (every
    collection)."""
    state = dict(_np_tree(state))
    return convert_variables(_np_tree(params), state.pop("batch_stats", {}),
                             E, **state)


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=1e-5, err_msg=name)


@pytest.fixture(scope="module", params=list(MODELS))
def setup(request):
    name = request.param
    jcls, tcls, kw = MODELS[name]
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    jm = jcls(spec=jspec, embed_dim=E, dropout=0.0, **kw)
    x = data.train_x[:BS]
    group = D2G[x[:, data.spec.domain_idx]].astype(np.int32)
    params, state = split_variables(seeded_variables(
        jm, jnp.asarray(x), group=jnp.asarray(group), train=False))
    tm = tcls(data.spec, E, dropout=0.0, device="cpu", **kw)
    sd = _convert(params, state)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return dict(name=name, jm=jm, tm=tm, params=params, state=state, x=x,
                y=data.train_y[:BS].astype(np.float32), group=group)


def test_forward_eval_matches_jax(setup):
    s = setup
    jout = jax.jit(lambda v, x, g: s["jm"].apply(v, x, group=g, train=False))(
        {"params": s["params"], **s["state"]}, jnp.asarray(s["x"]),
        jnp.asarray(s["group"]))
    before = {k: v.clone() for k, v in s["tm"].state_dict().items()}
    with torch.no_grad():
        tout = s["tm"](torch.tensor(s["x"]), group=torch.tensor(s["group"]),
                       train=False)
    # one logit per sample: the trainers gather no tower column
    assert tuple(tout["logit"].shape) == (BS,)
    for k in ("logit", "prob"):
        _close(tout[k].numpy(), jout[k], k)
    if s["name"] == "adl":
        np.testing.assert_array_equal(tout["route"].numpy(), jout["route"])
        assert len(np.unique(jout["route"])) > 1
    for k, v in s["tm"].state_dict().items():  # evaluation is pure
        assert torch.equal(v, before[k]), k


def test_train_forward_and_gradients_match_jax(setup):
    s = setup
    x, y, group = s["x"], s["y"], s["group"]
    valid = np.ones((BS,), np.float32)
    valid[-5:] = 0.0  # padded rows stay out of the BatchNorm statistics
    rules = strip_table_rule(type(s["jm"]).REG_RULES)
    collections = list(s["state"])

    def jloss(params, pert):
        out, new_state = s["jm"].apply(
            {"params": params, **s["state"], "perturbations": pert},
            jnp.asarray(x), group=jnp.asarray(group), train=True,
            mask=jnp.asarray(valid), mutable=collections,
            rngs={"dropout": jax.random.PRNGKey(0)})
        loss = (j_masked_mean(j_bce(out["logit"], y), valid)
                + j_reg_loss(params, rules))
        return loss, (out, new_state)

    pert0 = perturbation_zeros(s["jm"].spec, jnp.asarray(x), E)
    (jl, (jout, jstate)), (jgp, jg) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(s["params"], pert0)

    tm = s["tm"]
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    tout = tm(torch.tensor(x), group=torch.tensor(group), train=True,
              mask=torch.tensor(valid), tap=True)
    dense = tm.dense_named_parameters()
    loss = (T.masked_mean(T.bce_with_logits(tout["logit"], torch.tensor(y)),
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
    # BatchNorm statistics and ADL's centres: moved, and as in JAX
    stats = tm.state_dict()
    jstats = {p: v for c in collections
              for p, v in flatten(_np_tree(jstate[c])).items()}
    assert jstats
    for path, w in jstats.items():
        got = stats[path.replace("/", ".")]
        _close(got.numpy(), w, path)
        assert not torch.equal(got, saved[path.replace("/", ".")]), path
    if s["name"] == "adl":
        norms = torch.linalg.vector_norm(tm.cluster_centers, dim=1)
        _close(norms.numpy(), np.ones(3), "unit-norm centres")
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
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)


def test_initial_distributions_match_the_flax_initializers():
    """The port's own draws (no conversion) follow the JAX package's
    initializers: AdaSparse's dnn_linear_{i} a N(0, 1e-4) kernel and a zero
    bias (a flax nn.Dense given only a kernel init), its pruners torch's
    U(+-1/sqrt(fan_in)); ADL's centres N(0, 1) and its tower output
    factors U(+-1/sqrt(d)); HiNet's tower_linear and ADL's cn_linear
    without a bias; dlm_iters < 1 is refused."""
    spec = make_synthetic_data(n_rows=64, n_domain=N_DOMAIN, vocab=60).spec
    ada = AdaSparse(spec, E, hidden_dims=(256, 128), device="cpu")
    k = ada.dnn_linear_0.kernel.detach()
    assert torch.all(ada.dnn_linear_0.bias.detach() == 0)
    np.testing.assert_allclose(float(k.std()), 1e-4, rtol=0.02)
    bound = 1 / np.sqrt(ada.pruner_0.kernel.shape[0])
    assert float(ada.pruner_0.kernel.detach().abs().max()) <= bound
    assert float(ada.pruner_0.bias.detach().abs().max()) > 0.5 * bound
    adl = ADL(spec, E, n_tower=3, tower_dims=(64, 32), device="cpu")
    c = adl.cluster_centers
    assert tuple(c.shape) == (3, spec.field_num * E)
    assert "cluster_centers" in adl.state_dict()
    np.testing.assert_allclose(float(c.std()), 1.0, rtol=0.1)
    b = adl.domain_mlps_linears_bias.detach()
    assert tuple(b.shape) == (3, 1) and float(b.abs().max()) <= 1 / np.sqrt(32)
    assert adl.cn_linear.bias is None
    assert HiNet(spec, E, 3, device="cpu").tower_linear.bias is None
    with pytest.raises(ValueError, match="dlm_iters"):
        ADL(spec, E, n_tower=3, dlm_iters=0, device="cpu")
    with pytest.raises(ValueError, match="group"):
        HiNet(spec, E, 3, device="cpu")(torch.zeros((2, spec.n_columns),
                                                    dtype=torch.int32))


# ------------------------------------------------ ADL through the trainers
ADL_CFG = dict(model="adl", embed_dim=E, bs=BS, dropout=0.0,
               dataset_name="none", tower_dims=(16, 8), n_cross_layers=2,
               atten_embed_dim=8, att_layer_num=1, sparse_table_grad=False,
               table_dtype="float32", table_moments_dtype="float32")


@pytest.fixture(scope="module")
def adl_world():
    """Both trainers from the same weights after 3 Trainer steps on the
    same batches."""
    data = make_synthetic_data(n_rows=1024, n_domain=N_DOMAIN, vocab=60,
                               seed=2)
    jcfg, cfg = JConfig(**ADL_CFG), Config(**ADL_CFG)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    from aread_tpu.models import build_model as j_build_model

    jm = j_build_model(jcfg, jspec, N_DOMAIN)
    jt = JT.Trainer(jm, jcfg, N_DOMAIN, D2G)
    batcher = GlobalBatcher(data.train_x, data.train_y, BS,
                            data.spec.domain_idx, D2G, seed=3)
    batches = [b for _, b in zip(range(3), batcher)]
    params, state = split_variables(seeded_variables(
        jm, jnp.asarray(batches[0]["x"]), group=jnp.asarray(
            batches[0]["group"]), train=False))
    opt_state = JT.hybrid_init(jt.optimizer, params,
                               moments_dtype=jcfg.table_moments_dtype)
    tr = T.Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                   N_DOMAIN, D2G)
    tr.model.load_state_dict(_convert(params, state))
    tr.init()
    c0 = tr.model.cluster_centers.clone()
    jstep = jax.jit(jt._build_step_core(), static_argnums=(5,))
    for i, batch in enumerate(batches):
        params, state, opt_state, _ = jstep(
            params, state, opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(i), False)
        tr.step({k: np.array(v) for k, v in batch.items()})
    return dict(data=data, jcfg=jcfg, jm=jm, params=params, state=state,
                tr=tr, c0=c0)


def test_adl_centres_after_three_steps_match_jax(adl_world):
    w = adl_world
    got = w["tr"].model.cluster_centers
    _close(got.numpy(), np.asarray(w["state"]["model_state"]["cluster_centers"]),
           "centres after 3 steps")
    assert not torch.allclose(got, w["c0"])
    _close(torch.linalg.vector_norm(got, dim=1).numpy(), np.ones(3), "norms")


@pytest.mark.parametrize("eval_update,streaming", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["pure-exact", "update-exact", "pure-streaming", "update-streaming"])
def test_adl_evaluation_moves_centres_only_with_the_flag(adl_world,
                                                         eval_update,
                                                         streaming):
    """One evaluation of the valid split (8 * bs batches, in order): with
    eval_dlm_update the centres move batch by batch as the JAX Trainer
    threads them (its ``eval_mutated_state``); without it they stay
    bitwise where they were. The metrics agree at atol 1e-5."""
    w = adl_world
    data = w["data"]
    kw = dict(adl_eval_dlm_update=eval_update, streaming_eval=streaming,
              auc_bins=1024)
    jcfg = dataclasses.replace(w["jcfg"], **kw)
    jt = JT.Trainer(w["jm"].clone(eval_dlm_update=eval_update), jcfg,
                    N_DOMAIN, D2G)
    jres = jt.evaluate(w["params"], w["state"], data.valid_x, data.valid_y,
                       data.domain_cnt_weight)
    tr, model = w["tr"], w["tr"].model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    tr.config = dataclasses.replace(tr.config, **kw)
    model.eval_dlm_update = eval_update
    try:
        tres = tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
        got = model.cluster_centers.clone()
    finally:
        model.eval_dlm_update = False
        tr.config = dataclasses.replace(tr.config, adl_eval_dlm_update=False,
                                        streaming_eval=False)
        model.load_state_dict(saved)
    for k in ("total_auc", "total_loss"):
        _close(tres[k], jres[k], k)
    if eval_update:
        want = jt.eval_mutated_state["model_state"]["cluster_centers"]
        _close(got.numpy(), np.asarray(want), "centres after evaluation")
        assert not torch.allclose(got, saved["cluster_centers"])
    else:
        assert jt.eval_mutated_state is None
        assert torch.equal(got, saved["cluster_centers"])


def test_adl_fit_carries_eval_centres_and_returns_the_pre_test_state():
    """With eval_dlm_update, fit's next epoch starts from the centres the
    valid pass left, and the model it returns holds the best epoch's state
    as it was before the test pass (what the JAX fit returns)."""
    data = make_synthetic_data(n_rows=700, n_domain=N_DOMAIN, vocab=60,
                               seed=4)
    cfg = Config(**{**ADL_CFG, "adl_eval_dlm_update": True, "early_stop": 5})
    tr = T.Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                   N_DOMAIN, D2G)
    seen = []
    evaluate = tr.evaluate

    def spy(*a, **kw):
        seen.append(tr.model.cluster_centers.clone())
        out = evaluate(*a, **kw)
        seen.append(tr.model.cluster_centers.clone())
        return out

    tr.evaluate = spy
    # the epoch's steps run through the chunk loop, which calls step_core
    step = tr.step_core
    starts = []

    def step_spy(batch, scalars=None):
        starts.append(tr.model.cluster_centers.clone())
        return step(batch, scalars=scalars)

    tr.step_core = step_spy
    tr.fit(data, epochs=2, verbose=False)
    n_steps = len(starts) // 2
    # epoch 2's first step sees the centres of epoch 1's valid pass
    assert torch.equal(starts[n_steps], seen[1])
    assert not torch.equal(seen[0], seen[1])
    # the model holds the best checkpoint's state, not the test pass's
    best = tr.best_checkpoint[0]["cluster_centers"]
    assert torch.equal(tr.model.cluster_centers, best)
    assert not torch.equal(seen[-1], best)
