"""The port's StreamingAUC (aread_tpu_torch/train/metrics.py) against
aread_tpu.train.metrics.StreamingAUC on the same seed-made (logits or
probabilities, targets, domains, valid) over several batches, and both
trainers' ``streaming_eval`` against their exact evaluation.

Tolerances: the histograms ``pos`` / ``neg`` and ``count`` are sums of 0/1
weights and must be equal; a row whose logit sits on a bin edge could land
one bin apart under the two frameworks' float products, so the test counts
the rows whose bin index differs and requires none (a count above 0 would
be a gap to record, not a tolerance to widen). ``loss_sum`` rtol 1e-6 (the
two sigmoids and logs differ in the last place); ``finalize`` dicts atol
1e-6. The trainers' streaming evaluation against their exact one: the
bounds of tests/test_streaming_auc.py (AREAD: total AUC 3e-3, loss 1e-5;
generic Trainer: total AUC 8e-3 and the loss within 20 %, where saturated
predictions meet the two paths' different epsilons)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.train.metrics import StreamingAUC as JStreamingAUC
from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.metrics import StreamingAUC, full_evaluation
from aread_tpu_torch.train.trainer import Trainer

N_DOMAIN, N_BINS = 5, 4096


def _eval_rows(n, seed, saturate=False):
    rng = np.random.default_rng(seed)
    domains = rng.integers(0, N_DOMAIN, n)
    targets = rng.integers(0, 2, n).astype(np.float32)
    logits = (1.5 * targets - 0.75 + 2.0 * rng.standard_normal(n)).astype(
        np.float32)
    if saturate:  # beyond the clip at +-32 and deep in f32 saturation
        logits[::7] *= 40.0
    valid = (rng.random(n) > 0.1).astype(np.float32)
    return logits, targets, domains, valid


def _jax_bins(z, lo, width):
    z = jnp.asarray(z, jnp.float32)
    return np.asarray(jnp.clip(((z - lo) * (N_BINS / width)).astype(jnp.int32),
                               0, N_BINS - 1))


def _torch_bins(z, lo, width):
    z = torch.tensor(z, dtype=torch.float32)
    return torch.clamp(((z - lo) * (N_BINS / width)).to(torch.int32),
                       0, N_BINS - 1).numpy()


def _states_close(state, jstate):
    for k in ("pos", "neg", "count"):
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]),
                                      err_msg=k)
    np.testing.assert_allclose(state["loss_sum"].numpy(),
                               np.asarray(jstate["loss_sum"]), rtol=1e-6,
                               atol=0, err_msg="loss_sum")


def _dicts_close(got, want, atol=1e-6):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for d in v:
                np.testing.assert_allclose(got[k][d], v[d], rtol=0, atol=atol,
                                           equal_nan=True, err_msg=f"{k}[{d}]")
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("use_logits", [True, False],
                         ids=["logits", "probs"])
@pytest.mark.parametrize("saturate", [False, True],
                         ids=["plain", "saturated"])
def test_update_and_finalize_equal_jax(use_logits, saturate):
    logits, targets, domains, valid = _eval_rows(6000, seed=0,
                                                 saturate=saturate)
    probs = np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))
    if use_logits:
        z, lo, width = np.clip(logits, -32.0, 32.0), -32.2, 64.4
    else:
        pc = np.clip(probs, np.float32(1e-7), np.float32(1 - 1e-7))
        z, lo, width = np.log(pc) - np.log1p(-pc), -16.2, 32.4
    edge_rows = int((_jax_bins(z, lo, width) != _torch_bins(z, lo, width)).sum())
    print(f"rows binned apart by the two frameworks: {edge_rows} of 6000")
    assert edge_rows == 0

    jacc, acc = JStreamingAUC(N_DOMAIN, N_BINS), StreamingAUC(N_DOMAIN, N_BINS)
    jstate, state = jacc.init_state(), acc.init_state("cpu")
    for lo_ in range(0, 6000, 1024):  # a ragged last batch
        s = slice(lo_, lo_ + 1024)
        kw = {"logits": logits[s]} if use_logits else {}
        jstate = jacc.update(jstate, probs[s], targets[s], domains[s],
                             valid[s], **kw)
        before = {k: v.clone() for k, v in state.items()}
        new = acc.update(state, torch.tensor(probs[s]), torch.tensor(targets[s]),
                         torch.tensor(domains[s]), torch.tensor(valid[s]),
                         **{k: torch.tensor(v) for k, v in kw.items()})
        for k in before:  # update is pure: the old state is as it was
            assert torch.equal(state[k], before[k])
        state = new
    _states_close(state, jstate)
    assert float(state["count"].sum()) == float(valid.sum())
    w = np.full(N_DOMAIN, 1.0 / N_DOMAIN)
    for multi in (True, False):
        _dicts_close(acc.finalize(state, w, multi_domain=multi),
                     jacc.finalize(jstate, w, multi_domain=multi))
    # no weights: the means are 0, as in the JAX package
    _dicts_close(acc.finalize(state), jacc.finalize(jstate))


def test_probs_from_logits_when_probs_is_none():
    logits, targets, domains, valid = _eval_rows(500, seed=1)
    jacc, acc = JStreamingAUC(N_DOMAIN, N_BINS), StreamingAUC(N_DOMAIN, N_BINS)
    jstate = jacc.update(jacc.init_state(), None, targets, domains, valid,
                         logits=logits)
    state = acc.update(acc.init_state(), None, targets, domains, valid,
                       logits=logits)  # numpy in, as the JAX side takes it
    _states_close(state, jstate)


def test_streaming_close_to_exact():
    """Against the exact host metrics on the same predictions: the
    discretization bound of the JAX package's test."""
    logits, targets, domains, _ = _eval_rows(20000, seed=2)
    probs = torch.sigmoid(torch.tensor(logits)).numpy()
    w = np.full(N_DOMAIN, 1.0 / N_DOMAIN)
    exact = full_evaluation(targets, probs, domains, w)
    acc = StreamingAUC(N_DOMAIN, 16384)
    state = acc.init_state()
    for lo in range(0, 20000, 4096):
        s = slice(lo, lo + 4096)
        state = acc.update(state, probs[s], targets[s], domains[s])
    stream = acc.finalize(state, w)
    assert abs(stream["total_auc"] - exact["total_auc"]) < 2e-3
    assert abs(stream["total_loss"] - exact["total_loss"]) < 1e-6
    assert abs(stream["mean_auc"] - exact["mean_auc"]) < 2e-3
    for d in range(N_DOMAIN):
        assert abs(stream["domain_auc"][d] - exact["domain_auc"][d]) < 5e-3


def test_single_class_domain_nans():
    targets = np.array([1.0, 1.0, 1.0, 0.0, 1.0])
    predicts = np.array([0.9, 0.8, 0.7, 0.2, 0.6])
    domains = np.array([0, 0, 0, 1, 1])
    acc, jacc = StreamingAUC(2, 1024), JStreamingAUC(2, 1024)
    out = acc.finalize(acc.update(acc.init_state(), predicts, targets,
                                  domains), np.array([0.5, 0.5]))
    assert np.isnan(out["domain_auc"][0]) and np.isnan(out["domain_loss"][0])
    assert np.isnan(out["mean_auc"])
    assert not np.isnan(out["domain_auc"][1])
    _dicts_close(out, jacc.finalize(jacc.update(
        jacc.init_state(), predicts, targets, domains), np.array([0.5, 0.5])))
    # a domain absent from the split is left out of the dicts
    acc3 = StreamingAUC(3, 1024)
    out3 = acc3.finalize(acc3.update(acc3.init_state(), predicts, targets,
                                     domains), np.ones(3) / 3)
    assert set(out3["domain_auc"]) == {0, 1}
    # nothing seen at all: NaN, not a division error
    empty = acc3.finalize(acc3.init_state())
    assert np.isnan(empty["total_auc"]) and np.isnan(empty["total_loss"])


def test_respects_valid_mask():
    targets = np.array([1.0, 0.0, 1.0, 0.0])
    predicts = np.array([0.9, 0.1, 0.2, 0.8])
    domains = np.zeros(4, np.int64)
    valid = np.array([1.0, 1.0, 0.0, 0.0])  # padded rows dropped
    acc = StreamingAUC(1, 1024)
    state = acc.update(acc.init_state(), predicts, targets, domains, valid)
    out = acc.finalize(state, np.array([1.0]))
    assert out["total_auc"] == 1.0  # the two valid, perfectly ranked rows
    assert float(state["count"].sum()) == 2.0


def test_histogram_auc_formula():
    auc = StreamingAUC._auc_from_hist
    assert auc(np.array([0.0, 0.0, 2.0]), np.array([3.0, 0.0, 0.0])) == 1.0
    assert auc(np.array([2.0, 0.0]), np.array([0.0, 3.0])) == 0.0
    assert auc(np.array([2.0]), np.array([3.0])) == 0.5  # all ties
    assert np.isnan(auc(np.array([0.0]), np.array([3.0])))


def _toy_cfg(model, **kw):
    return Config(**{**dict(
        model=model, bs=128, embed_dim=8, epoch=1, dataset_name="none",
        table_dtype="float32", table_moments_dtype="float32",
        mlp_dims=(16, 8), aread_tower_dims=((8,), (8,), (8,)),
        mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8, 4), atten_embed_dim=8,
        att_layer_num=1, warm_up_interval=1, regroup_interval=4,
        regroup_update_step=1, regroup_eval_step=1, candidate_mask_num=1,
        device_data="0"), **kw})


@pytest.mark.parametrize("model", ["deepfm", "mmoe"])
def test_trainer_streaming_eval_matches_exact(model):
    data = make_synthetic_data(n_rows=1024, n_domain=3, vocab=60, seed=4)
    cfg = _toy_cfg(model)
    d2g = np.array([0, 1, 2]) if model == "mmoe" else None
    tr = Trainer(build_model(cfg, data.spec, 3, device="cpu"), cfg, 3, d2g)
    tr.fit(data, epochs=1, verbose=False)
    exact = tr.evaluate(data.test_x, data.test_y, data.domain_cnt_weight)
    tr.config = dataclasses.replace(cfg, streaming_eval=True)
    stream = tr.evaluate(data.test_x, data.test_y, data.domain_cnt_weight)
    assert set(stream) == set(exact)
    assert abs(stream["total_auc"] - exact["total_auc"]) < 8e-3
    assert np.isfinite(stream["total_loss"])
    assert abs(stream["total_loss"] - exact["total_loss"]) < \
        0.2 * max(1.0, exact["total_loss"])
    # a whole fit under streaming_eval early-stops on the same keys
    tr2 = Trainer(build_model(cfg, data.spec, 3, device="cpu"), tr.config, 3,
                  d2g)
    res = tr2.fit(data, epochs=1, verbose=False)
    assert {"total_auc", "mean_auc", "train_loss"} <= set(res["history"][0])
    assert 0.0 <= res["test"]["total_auc"] <= 1.0


@pytest.mark.parametrize("final", [False, True], ids=["masked", "final_gate"])
def test_hemp_streaming_eval_matches_exact(final):
    data = make_synthetic_data(n_rows=512, n_domain=3, vocab=60, seed=5)
    cfg = _toy_cfg("aread")
    tr = AREADTrainer(build_model(cfg, data.spec, 3, n_tower=2, device="cpu"),
                      cfg, 3)
    tr.fit(data, epochs=1, verbose=False, final_gate=final)

    def valid_batcher():
        return DomainBatcher(data.valid_x, data.valid_y, cfg.bs * 8,
                             data.spec.domain_idx, 3, shuffle=False)

    exact = tr.evaluate(valid_batcher(), data.domain_cnt_weight, final=final)
    tr.config = dataclasses.replace(cfg, streaming_eval=True)
    stream = tr.evaluate(valid_batcher(), data.domain_cnt_weight, final=final)
    assert set(stream) == set(exact)
    assert abs(stream["total_auc"] - exact["total_auc"]) < 3e-3
    assert abs(stream["total_loss"] - exact["total_loss"]) < 1e-5
