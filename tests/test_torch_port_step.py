"""The port's train step (AREADTrainer.main_step -> hybrid_update_sparse ->
sparse_adam_dispatch) against the same composition in JAX (bench.py's
step: perturbation-tap gradients, hybrid_update_sparse with the table
L2 reported, one jax.jit), three bagging steps from the same weights and
optimizer state, dropout 0, f32 table and moments, with and without the
global-norm clip (which takes the deduplicated row sums into the norm), and
on the PLE base (``cgc_{i}`` levels) without the clip. Parameters, all Adam
moments and losses at atol 1e-5. Also the evaluation metrics and the
data streams."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.data.loader import DomainBatcher as JDomainBatcher
from aread_tpu.data.loader import make_synthetic_data as j_make_data
from aread_tpu.models.aread import AREAD as JAREAD
from aread_tpu.models.aread import full_mask
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.base import regularization_loss as j_reg_loss
from aread_tpu.train import metrics as j_metrics
from aread_tpu.train.trainer import (bce_with_logits as j_bce,
                                     embedding_flat_ids, hybrid_init,
                                     hybrid_update_sparse, make_optimizer,
                                     masked_mean as j_masked_mean,
                                     merge_table, perturbation_zeros,
                                     split_table, split_variables,
                                     strip_table_rule)
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_opt_state, convert_variables
from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.train import metrics
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.trainer import DenseAdam
from tests.test_torch_port_zoo import seeded_variables

E, N_TOWER, N_DOMAIN, BS = 8, (2, 4), 4, 64
# A linear bias that feeds a BatchNorm has a true gradient of exactly 0
# (the normalization removes any per-channel shift); the computed one is
# round-off, which Adam normalizes into a step of up to lr either way.
# Both sides get the true 0 so that the comparison measures the port.
PRE_BN_BIAS = re.compile(r"^(mmoe_experts|towers_\d+)/linear_\d+/bias$")


class DenseAdamTrueZero(DenseAdam):
    def update_(self, params, grads, state, scalars=None):
        grads = {n: torch.zeros_like(g) if PRE_BN_BIAS.match(n) else g
                 for n, g in grads.items()}
        super().update_(params, grads, state, scalars)


def _true_zero_jax(g_rest):
    return jax.tree_util.tree_map_with_path(
        lambda path, g: jnp.zeros_like(g) if PRE_BN_BIAS.match(
            "/".join(k.key for k in path)) else g, g_rest)
MODEL_KW = dict(embed_dim=E, n_tower=N_TOWER, n_domain=N_DOMAIN,
                expert_dims=(16, 8), tower_dims=((8,), (8, 4)), dropout=0.0)


def _jax_step_fn(jm, spec, lr, dm, clip_norm):
    """bench.py's one_step_body, with the table L2 value reported."""
    optimizer = make_optimizer(lr)
    reg_rules = strip_table_rule(type(jm).REG_RULES)
    n_rows = int(np.sum(spec.one_hot_dims))

    @jax.jit
    def step(params, state, opt_state, x, y, valid):
        table, rest = split_table(params)

        def loss_fn(rest_p, pert):
            out, new_state = jm.apply(
                {"params": merge_table(rest_p, table), "perturbations": pert,
                 **state}, x, domain_mask=dm, mode="domain_mask_bagging",
                train=True, mask=valid, mutable=list(state.keys()),
                rngs={"dropout": jax.random.PRNGKey(0)})
            per_leaf = jax.vmap(lambda lg: j_masked_mean(j_bce(lg, y), valid),
                                in_axes=1)(out["leaf_logit"])
            la = out["leaf_active"].astype(per_leaf.dtype)
            bce = jnp.sum(per_leaf * la) / jnp.maximum(la.sum(), 1e-8)
            return bce + j_reg_loss(rest_p, reg_rules), new_state

        pert0 = perturbation_zeros(spec, x, E)
        (loss, new_state), (g_rest, g_pert) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(rest, pert0)
        g_rest = _true_zero_jax(g_rest)
        new_params, new_opt, l2val = hybrid_update_sparse(
            optimizer, lr, 1e-8, params, g_rest, embedding_flat_ids(spec, x),
            g_pert["embedding"]["rows"], opt_state,
            table_shape=(n_rows, E), want_table_l2=True,
            clip_norm=clip_norm)
        return new_params, dict(new_state), new_opt, loss + l2val

    return optimizer, step


@pytest.mark.parametrize("clip_norm", [0.0, 0.05], ids=["no_clip", "clip"])
def test_three_bagging_steps_match_jax(clip_norm):
    _three_bagging_steps(clip_norm, MODEL_KW)


def test_three_bagging_steps_ple_base_match_jax():
    _three_bagging_steps(0.0, dict(
        MODEL_KW, base_model="ple", ple_n_expert_specific=2,
        ple_n_expert_shared=2, ple_expert_dims=((16,), (8,))))


def _three_bagging_steps(clip_norm, model_kw):
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    spec = data.spec.with_flat_table(E)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).with_flat_table(E)
    jm = JAREAD(spec=jspec, **model_kw)
    # the full mask: under a masked one, a tower with a single active
    # input edge renormalizes its gate to 1 and the gate's gradient is
    # round-off, which Adam normalizes (the masked modes' forward and
    # gradients are held to JAX in test_torch_port_model.py)
    dm = [np.asarray(m) for m in full_mask(N_TOWER)]
    jdm = fm = tuple(jnp.asarray(m) for m in dm)
    x0 = jnp.asarray(data.train_x[:BS])
    params, state = split_variables(seeded_variables(
        jm, x0, domain_mask=fm, mode="domain_mask_final", train=False))
    lr = 1e-3
    optimizer, jstep = _jax_step_fn(jm, jspec, lr, jdm, clip_norm)
    opt_state = hybrid_init(optimizer, params, moments_dtype="float32")

    cfg = Config(embed_dim=E, dropout=0.0, table_dtype="float32",
                 table_moments_dtype="float32", lr=lr,
                 grad_clip_norm=clip_norm)
    tm = AREAD(spec, device="cpu", **model_kw)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tm.load_state_dict(convert_variables(np_tree(params),
                                         np_tree(state["batch_stats"]), E))
    tr = AREADTrainer(tm, cfg, N_DOMAIN)
    tr.optimizer = DenseAdamTrueZero(lr=lr, wd=cfg.wd)
    tr.init()
    tr.opt_state = convert_opt_state(np_tree(opt_state), E)

    for i in range(3):
        sl = slice(BS * i, BS * (i + 1))
        x = data.train_x[sl]
        y = data.train_y[sl].astype(np.float32)
        valid = np.ones((BS,), np.float32)
        params, state, opt_state, jloss = jstep(
            params, state, opt_state, jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(valid))
        tloss, _ = tr.main_step({"x": x, "y": y, "valid": valid}, dm)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                                   atol=1e-5, err_msg=f"loss, step {i}")

    sd = tm.state_dict()
    want = convert_variables(np_tree(params), np_tree(state["batch_stats"]), E)
    assert set(want) == set(sd)
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    got = convert_opt_state(np_tree(opt_state), E)
    assert tr.opt_state["t"] == got["t"] == 3
    assert tr.opt_state["inner"]["count"] == got["inner"]["count"] == 3
    for k in ("m", "v"):
        np.testing.assert_allclose(tr.opt_state[k].numpy(), got[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    for k in ("mu", "nu"):
        for name, v in got["inner"][k].items():
            np.testing.assert_allclose(tr.opt_state["inner"][k][name].numpy(),
                                       v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{k} {name}")


def test_evaluate_metrics_match_jax():
    """AREADTrainer.evaluate's total_auc and mean_auc equal the JAX
    package's numpy metrics on the same predictions."""
    data = make_synthetic_data(n_rows=1024, n_domain=N_DOMAIN, vocab=60, seed=2)
    spec = data.spec.with_flat_table(E)
    tr = AREADTrainer(AREAD(spec, device="cpu", **MODEL_KW), Config(),
                      N_DOMAIN)
    ms = tr.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d)
    res = tr.evaluate(DomainBatcher(data.valid_x, data.valid_y, 32,
                                    spec.domain_idx, N_DOMAIN, seed=4),
                      data.domain_cnt_weight)
    batcher = DomainBatcher(data.valid_x, data.valid_y, 32, spec.domain_idx,
                            N_DOMAIN, seed=4)
    preds, targets, domains = [], [], []
    for d in batcher.domain_batch_seq:
        b = batcher.next_batch(d)
        n = int(b["valid"].sum())
        preds.append(tr.eval_prob(tr.place(b), ms.domain_mask[d]).numpy()[:n])
        targets.append(b["y"][:n])
        domains.append(np.full((n,), d))
    want = j_metrics.full_evaluation(
        np.concatenate(targets), np.concatenate(preds),
        np.concatenate(domains), data.domain_cnt_weight)
    for k in ("total_auc", "mean_auc", "total_loss", "mean_loss"):
        assert res[k] == want[k], k
    assert res["domain_auc"] == want["domain_auc"]


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 500)
    p = np.round(rng.random(500), 2)  # ties
    dom = rng.integers(0, 3, 500)
    w = np.array([0.5, 0.3, 0.2])
    assert metrics.roc_auc(y, p) == j_metrics.roc_auc(y, p)
    assert metrics.log_loss(y, p) == j_metrics.log_loss(y, p)
    assert metrics.full_evaluation(y, p, dom, w) == \
        j_metrics.full_evaluation(y, p, dom, w)


def test_data_streams_match_jax():
    a = make_synthetic_data(n_rows=300, n_domain=3, vocab=40, seed=5)
    b = j_make_data(n_rows=300, n_domain=3, vocab=40, seed=5)
    for f in ("train_x", "train_y", "valid_x", "test_x", "domain_cnt_weight"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.spec.one_hot_dims == b.spec.one_hot_dims
    ta = DomainBatcher(a.train_x, a.train_y, 16, 2, 3, seed=9)
    tb = JDomainBatcher(b.train_x, b.train_y, 16, 2, 3, seed=9)
    assert ta.domain_batch_seq == tb.domain_batch_seq
    for d in ta.domain_batch_seq * 2:
        ba, bb = ta.next_batch(d), tb.next_batch(d)
        for k in bb:
            np.testing.assert_array_equal(ba[k], bb[k])
