"""The port's AREAD forward (aread_tpu_torch/models/aread.py) against the
JAX package's, from the same weights (converted by aread_tpu_torch/
convert.py) on the same seed-made batch: with the MMoE base the three
single-mask training modes, with the PLE base (``cgc_{i}`` levels) all
five modes (per-example masks in 'batch_with_mask'), eval and train
(dropout 0, BatchNorm running statistics compared too), the sparse row
gradient d loss / d rows against the JAX perturbation tap and every dense
gradient. Tolerance atol 1e-5: f32 products summed in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.models.aread import AREAD as JAREAD
from aread_tpu.models.aread import full_mask
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.train.trainer import (bce_with_logits as j_bce,
                                     masked_mean as j_masked_mean,
                                     perturbation_zeros, split_variables)
from aread_tpu.utils.masks import HempMaskState as JHempMaskState
from aread_tpu_torch.convert import convert_variables, flatten
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.train.trainer import bce_with_logits, masked_mean
from aread_tpu_torch.utils.masks import HempMaskState
from tests.test_torch_port_zoo import seeded_variables

E, N_TOWER, N_DOMAIN, BS = 8, (2, 4), 4, 64
MODEL_KW = dict(embed_dim=E, n_tower=N_TOWER, n_domain=N_DOMAIN,
                expert_dims=(16, 8), tower_dims=((8,), (8, 4)), dropout=0.0)
MODES = ["wo_mask", "domain_with_mask", "domain_mask_bagging"]
PLE_KW = dict(MODEL_KW, base_model="ple", ple_n_expert_specific=2,
              ple_n_expert_shared=2, ple_expert_dims=((16,), (8,)))
PLE_MODES = MODES + ["domain_mask_final", "batch_with_mask"]


@pytest.fixture(scope="module")
def setup():
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    spec = data.spec.with_flat_table(E)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).with_flat_table(E)
    jm = JAREAD(spec=jspec, **MODEL_KW)
    x = data.train_x[:BS]
    fm = tuple(jnp.asarray(m) for m in full_mask(N_TOWER))
    variables = jax.jit(lambda r, xx: jm.init(
        {"params": r, "dropout": r}, xx, domain_mask=fm,
        mode="domain_mask_final", train=False))(jax.random.PRNGKey(0),
                                                jnp.asarray(x))
    params, state = split_variables(variables)
    # non-trivial running statistics for the eval-mode comparison
    rng = np.random.default_rng(1)
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)) + 0.5,
                              jnp.float32), state)
    tm = AREAD(spec, device="cpu", **MODEL_KW)
    tm.load_state_dict(convert_variables(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state["batch_stats"]), E))
    dm = HempMaskState(N_TOWER, N_DOMAIN, seed=3).generate_mask("rand", 0)
    return dict(data=data, jm=jm, tm=tm, params=params, state=state, x=x,
                y=data.train_y[:BS].astype(np.float32), dm=dm)


def test_generate_mask_stream_matches_jax():
    a, b = HempMaskState(N_TOWER, N_DOMAIN, 7), JHempMaskState(N_TOWER, N_DOMAIN, 7)
    for d in range(6):
        for ma, mb in zip(a.generate_mask("rand", d % N_DOMAIN, 0.5),
                          b.generate_mask("rand", d % N_DOMAIN, 0.5)):
            np.testing.assert_array_equal(ma, mb)


@pytest.fixture(scope="module")
def setup_ple():
    """AREAD on a PLE base of two CGC levels, weights drawn from a seed;
    per-example masks (each row its domain's) for 'batch_with_mask'."""
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    spec = data.spec.with_flat_table(E)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).with_flat_table(E)
    jm = JAREAD(spec=jspec, **PLE_KW)
    x = data.train_x[:BS]
    fm = tuple(jnp.asarray(m) for m in full_mask(N_TOWER))
    params, state = split_variables(seeded_variables(
        jm, jnp.asarray(x), domain_mask=fm, mode="domain_mask_final",
        train=False, seed=2))
    tm = AREAD(spec, device="cpu", **PLE_KW)
    sd = convert_variables(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state["batch_stats"]), E)
    assert set(sd) == set(tm.state_dict())
    assert any(k.startswith("cgc_1.gates_specific") for k in sd)
    assert not any(k.startswith("mmoe_") for k in sd)
    tm.load_state_dict(sd)
    ms = HempMaskState(N_TOWER, N_DOMAIN, seed=3)
    masks = [ms.generate_mask("rand", d, 0.6) for d in range(N_DOMAIN)]
    dom = x[:, data.spec.domain_idx]
    per_ex = [np.stack([masks[d][l] for d in dom])
              for l in range(len(masks[0]))]
    return dict(data=data, jm=jm, tm=tm, params=params, state=state, x=x,
                y=data.train_y[:BS].astype(np.float32), dm=masks[0],
                per_ex=per_ex)


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_forward_eval_matches_jax(setup, mode):
    _check_eval(setup, mode)


@pytest.mark.parametrize("mode", PLE_MODES)
def test_ple_base_forward_eval_matches_jax(setup_ple, mode):
    _check_eval(setup_ple, mode)


def _check_eval(s, mode):
    dm = s["per_ex"] if mode == "batch_with_mask" else s["dm"]
    jout = jax.jit(lambda v, x, dm: s["jm"].apply(
        v, x, domain_mask=dm, mode=mode, train=False))(
            {"params": s["params"], **s["state"]}, jnp.asarray(s["x"]),
            tuple(jnp.asarray(m) for m in dm))
    with torch.no_grad():
        tout = s["tm"](torch.as_tensor(s["x"]), domain_mask=dm,
                       mode=mode, train=False)
    for k in ("leaf_logit", "leaf_prob", "prob", "logit"):
        _close(tout[k].numpy(), jout[k], k)
    np.testing.assert_array_equal(tout["leaf_active"].numpy(),
                                  np.asarray(jout["leaf_active"]))
    assert len(tout["gate_means"]) == len(jout["gate_means"]) == len(N_TOWER) - 1
    for a, b in zip(tout["gate_means"], jout["gate_means"]):
        _close(a.numpy(), b, "gate_means")


@pytest.mark.parametrize("mode", MODES)
def test_forward_train_and_row_grads_match_jax(setup, mode):
    """train=True with dropout 0: outputs, updated BatchNorm running stats,
    d (bagging loss) / d rows against JAX's perturbation gradient, and the
    gradient of every dense parameter."""
    _check_train(setup, mode)


@pytest.mark.parametrize("mode", PLE_MODES[:-1])
def test_ple_base_forward_train_and_grads_match_jax(setup_ple, mode):
    """The same on the PLE base, in every mode that trains; the loss adds
    the BCE of the mode's ``logit`` (in 'domain_mask_final' only the final
    gate reaches it)."""
    _check_train(setup_ple, mode, with_prob=True)


def _check_train(s, mode, with_prob=False):
    x, y = s["x"], s["y"]
    valid = np.ones((BS,), np.float32)
    valid[-5:] = 0.0  # padded rows stay out of the BatchNorm statistics

    def jloss(params, pert):
        out, new_state = s["jm"].apply(
            {"params": params, **s["state"], "perturbations": pert},
            jnp.asarray(x), domain_mask=s["dm"], mode=mode, train=True,
            mask=jnp.asarray(valid), mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        per_leaf = jax.vmap(lambda lg: j_masked_mean(j_bce(lg, y), valid),
                            in_axes=1)(out["leaf_logit"])
        loss = jnp.sum(per_leaf)
        if with_prob:
            loss = loss + j_masked_mean(j_bce(out["logit"], y), valid)
        return loss, (out, new_state)

    pert0 = perturbation_zeros(s["jm"].spec, jnp.asarray(x), E)
    (_, (jout, jstate)), (jgp, jg) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(s["params"], pert0)

    tm = s["tm"]
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    tout = tm(torch.as_tensor(x), domain_mask=s["dm"], mode=mode, train=True,
              mask=torch.as_tensor(valid), tap=True)
    yt, vt = torch.as_tensor(y), torch.as_tensor(valid)
    loss = sum(masked_mean(bce_with_logits(tout["leaf_logit"][:, i], yt), vt)
               for i in range(N_TOWER[-1]))
    if with_prob:
        loss = loss + masked_mean(bce_with_logits(tout["logit"], yt), vt)
    dense = tm.dense_named_parameters()
    grads = torch.autograd.grad(loss, [tout["rows"]] + list(dense.values()),
                                materialize_grads=True)
    for k in ("leaf_logit", "prob"):
        _close(tout[k].detach().numpy(), jout[k], k)
    _close(grads[0].numpy(), jg["embedding"]["rows"], "d loss / d rows")
    want = flatten(jax.tree_util.tree_map(np.asarray, jgp))
    for name, g in zip(dense, grads[1:]):
        _close(g.numpy(), want[name], f"d loss / d {name}")
    stats = tm.state_dict()
    for path, want in flatten(jax.tree_util.tree_map(
            np.asarray, jstate["batch_stats"])).items():
        _close(stats[path.replace("/", ".")].numpy(), want, path)
    tm.load_state_dict(saved)


def test_table_is_never_a_trainable_parameter(setup):
    tm = setup["tm"]
    names = dict(tm.named_parameters())
    assert "embedding.table" not in names
    assert "embedding.table" in tm.state_dict()
    assert not tm.embedding.table.requires_grad
