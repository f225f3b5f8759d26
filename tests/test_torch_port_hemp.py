"""The port's HEMP loop (aread_tpu_torch/train/hemp.py) against
aread_tpu.train.hemp.AREADTrainer, at a toy size: n_tower (2, 3, 4), 3
domains, bs 32, a vocab of 300, 2 candidates, 2 adapt and 2 probe steps.
Inputs are made from a seed with numpy; the weights are the JAX package's,
carried over by convert.py; f32 table and moments; dropout 0 (the two
frameworks' dropout streams cannot agree).

Tolerances, each stated where it is used: model forwards and the final
gate's gradient atol 1e-5; lazy Adam's touched rows atol 1e-6, the rest
bitwise; an evolution's probe losses atol 1e-4 and its chosen masks equal;
an epoch with two regroups: loss and weights atol 1e-4; the final phase:
final_gate atol 1e-5, every other parameter bitwise unchanged; a 2-epoch
fit: AUCs atol 1e-3, the early-stop bookkeeping equal. Masks depend on
gate means through ``gv >= threshold`` and on probe losses through
``argmin``: the seeds used here are ones at which neither is a near tie
(the probe-loss gaps between candidates are checked to be wide).

A linear bias that feeds a BatchNorm has a true gradient of exactly 0; the
computed one is round-off, which a fresh Adam normalizes into a step of lr
either way. Both sides get the true 0 (the JAX side through a wrapper
around its hybrid_update_sparse that changes nothing else). The JAX
trainer runs single jitted steps (its SCAN_CHUNK is set out of reach on
the instance): the scans compute the same steps and take minutes to
compile here. Every test here runs torch on one thread: the suite's
workers share the host's cores, and small tensors on many threads each
spin for the rest."""

import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aread_tpu.train.hemp as JH
from aread_tpu.config import Config as JConfig
from aread_tpu.data.loader import DomainBatcher as JDomainBatcher
from aread_tpu.data.loader import SplitData as JSplitData
from aread_tpu.models.aread import AREAD as JAREAD
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.ops.sparse_adam import _lazy_sparse_adam
from aread_tpu.train.trainer import hybrid_init as j_hybrid_init
from aread_tpu.utils import masks as JM
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import (convert_final_opt_state,
                                     convert_mask_state, convert_variables,
                                     copy_hemp_schedule)
from aread_tpu_torch.data.loader import (DomainBatcher, make_synthetic_data,
                                         pad_batch)
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.ops.sparse_adam import (dedup_rows, lazy_sparse_adam_,
                                             sparse_adam_dispatch)
from aread_tpu_torch.train.hemp import AREADTrainer, gather_batch
from aread_tpu_torch.train.trainer import DenseAdam
from aread_tpu_torch.utils.masks import prune_mask

E, N_TOWER, N_DOMAIN, BS = 8, (2, 3, 4), 3, 32
MODEL_KW = dict(embed_dim=E, n_tower=N_TOWER, n_domain=N_DOMAIN,
                expert_dims=(16, 8), tower_dims=((8,), (8,), (4,)),
                dropout=0.0, mmoe_n_expert=2)
# intervals count 1024-row batches: 1 is 32 steps at bs 32
CFG_KW = dict(model="aread", bs=BS, embed_dim=E, lr=1e-3, dropout=0.0,
              table_dtype="float32", table_moments_dtype="float32",
              warm_up_interval=1, regroup_interval=1, regroup_update_step=2,
              regroup_eval_step=2, candidate_mask_num=3, epoch=2,
              final_epoch=1, early_stop=2, device_data="0", seed=11)
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


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def _jnp_tree(t):
    return jax.tree_util.tree_map(jnp.array, t)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """One JAX trainer for the module (its jitted functions compile
    once), the initial weights as numpy, and the data."""
    mp = pytest.MonkeyPatch()
    sparse = JH.hybrid_update_sparse
    mp.setattr(JH, "hybrid_update_sparse",
               lambda opt, lr, wd, params, g_rest, *a, **kw: sparse(
                   opt, lr, wd, params, _true_zero_jax(g_rest), *a, **kw))
    data = make_synthetic_data(n_rows=1400, n_domain=N_DOMAIN, vocab=300,
                               seed=3)
    # the valid rows stand in for an augmented split: few rows per domain,
    # so the fast-adapt batches are ragged
    data = dataclasses.replace(data, aug_train_x=data.valid_x,
                               aug_train_y=data.valid_y)
    spec = data.spec.with_flat_table(E)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).with_flat_table(E)
    jdata = JSplitData(**{**{f.name: getattr(data, f.name)
                             for f in dataclasses.fields(data)},
                          "spec": jspec})
    jt = JH.AREADTrainer(JAREAD(spec=jspec, **MODEL_KW), JConfig(**CFG_KW),
                         N_DOMAIN)
    jt.SCAN_CHUNK = 10**9
    params, state, _ = jt.init(
        jax.random.PRNGKey(0), pad_batch(data.train_x[:BS], data.train_y[:BS], BS))
    yield types.SimpleNamespace(data=data, jdata=jdata, spec=spec, jt=jt,
                                params=_np_tree(params), state=_np_tree(state))
    mp.undo()


def _fresh(world, **cfg_kw):
    """The shared JAX trainer with its HEMP and early-stop state as new,
    fresh copies of the initial weights on both sides, and a new port
    trainer holding them."""
    jt = world.jt
    cfg = Config(**{**CFG_KW, **cfg_kw})
    jt.mask_state = JM.HempMaskState(N_TOWER, N_DOMAIN, seed=cfg.seed)
    jt.random_modify_sigma = jt.config.random_modify_sigma
    jt.init_active_percent = jt.config.init_active_percent
    jt.candidate_mask_num = float(jt.config.candidate_mask_num)
    jt.regroup_times = 0
    jt.trial_counter, jt.best_auc, jt.best_mean_auc = 0, 0.0, 0.0
    jt.best_checkpoint, jt._device_data = None, None
    params, state = _jnp_tree(world.params), _jnp_tree(world.state)
    opt_state = j_hybrid_init(jt.optimizer, params, moments_dtype="float32")
    tm = AREAD(world.spec, device="cpu", **MODEL_KW)
    tm.load_state_dict(convert_variables(world.params,
                                         world.state["batch_stats"], E))
    tr = AREADTrainer(tm, cfg, N_DOMAIN)
    tr.optimizer = DenseAdamTrueZero(lr=cfg.lr, wd=cfg.wd)
    tr.fast_optimizer = DenseAdamTrueZero(lr=cfg.update_lr, wd=cfg.wd)
    tr.init()
    return jt, params, state, opt_state, tr


def _batchers(world, cls):
    d = world.data
    didx = d.spec.domain_idx
    return (cls(d.train_x, d.train_y, BS, didx, N_DOMAIN, seed=1),
            cls(d.aug_train_x, d.aug_train_y, BS, didx, N_DOMAIN, seed=2))


def _share_hemp_state(jt, tr, seed):
    """Masks for every domain and two gate records each, on both sides."""
    rng = np.random.default_rng(seed)
    ms = jt.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d, 0.7)
        for _ in range(2):
            ms.record_gates(d, [
                (rng.random(s) + 1e-3).astype(np.float32)
                for s in JM.mask_shapes(N_TOWER)[1:-1]])
    tr.mask_state = convert_mask_state(ms)
    copy_hemp_schedule(jt, tr)


def _assert_masks_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _assert_weights_close(tm, params, state, atol):
    want = convert_variables(_np_tree(params),
                             _np_tree(state["batch_stats"]), E)
    sd = tm.state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------- the model
def _models(world):
    tm = AREAD(world.spec, device="cpu", **MODEL_KW)
    tm.load_state_dict(convert_variables(world.params,
                                         world.state["batch_stats"], E))
    variables = {"params": _jnp_tree(world.params), **_jnp_tree(world.state)}
    return world.jt.model, variables, tm


def _rand_masks(seed):
    ms = JM.HempMaskState(N_TOWER, N_DOMAIN, seed=seed)
    return [ms.generate_mask("rand", d, 0.6) for d in range(N_DOMAIN)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_domain_mask_final_forward_matches_jax(world, train):
    """Forward at atol 1e-5 (prob, leaf logits, gate means, and with
    train=True the BatchNorm statistics, which the mode still updates)."""
    jm, variables, tm = _models(world)
    x = world.data.train_x[:BS]
    dm = _rand_masks(0)[1]
    valid = np.ones((BS,), np.float32)
    jout, new_state = jm.apply(
        variables, jnp.asarray(x), domain_mask=tuple(jnp.asarray(m) for m in dm),
        mode="domain_mask_final", train=train, mask=jnp.asarray(valid),
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    tm.train(train)
    out = tm(torch.tensor(x), domain_mask=dm, mode="domain_mask_final",
             train=train, mask=torch.tensor(valid))
    for k in ("prob", "logit", "leaf_logit", "leaf_prob"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(out["leaf_active"].numpy(),
                                  np.asarray(jout["leaf_active"]))
    for a, b in zip(out["gate_means"], jout["gate_means"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    _assert_weights_close(tm, world.params, new_state, 1e-5)


def test_domain_mask_final_gradient_reaches_final_gate_only(world):
    """Every gradient except final_gate's is exactly zero; final_gate's
    matches JAX at atol 1e-5."""
    jm, variables, tm = _models(world)
    x = world.data.train_x[:BS]
    y = world.data.train_y[:BS].astype(np.float32)
    dm = _rand_masks(1)[0]
    jdm = tuple(jnp.asarray(m) for m in dm)

    def jloss(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(x),
                       domain_mask=jdm, mode="domain_mask_final", train=False)
        p = jnp.clip(out["prob"], 1e-7, 1 - 1e-7)
        return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log1p(-p))

    jg = jax.jit(jax.grad(jloss))(variables["params"])
    out = tm(torch.tensor(x), domain_mask=dm, mode="domain_mask_final",
             train=False, tap=True)
    p = torch.clamp(out["prob"], 1e-7, 1 - 1e-7)
    yt = torch.tensor(y)
    loss = -torch.mean(yt * torch.log(p) + (1 - yt) * torch.log1p(-p))
    named = tm.dense_named_parameters()
    grads = torch.autograd.grad(loss, list(named.values()) + [out["rows"]],
                                allow_unused=True)
    assert grads[-1] is None  # nothing reaches the table's rows
    for name, g in zip(named, grads[:-1]):
        if name == "final_gate/kernel":
            assert float(g.abs().max()) > 0
            np.testing.assert_allclose(
                g.numpy(), np.asarray(jg["final_gate"]["kernel"]), rtol=0,
                atol=1e-5)
        else:
            assert g is None or float(g.abs().max()) == 0.0, name
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        if "final_gate" not in jax.tree_util.keystr(path):
            assert float(jnp.abs(g).max()) == 0.0


def test_batch_with_mask_matches_jax_and_per_domain_rows(world):
    """Per-example masks: the forward at atol 1e-5 to JAX, and each row
    equal to its domain's 'domain_with_mask' forward (atol 1e-6: the same
    arithmetic on another batch shape)."""
    jm, variables, tm = _models(world)
    x = world.data.train_x[:48]
    dom = x[:, world.spec.domain_idx]
    masks = _rand_masks(2)
    stacked = [np.stack([masks[d][li] for d in range(N_DOMAIN)])[dom]
               for li in range(len(masks[0]))]
    jout = jm.apply(variables, jnp.asarray(x),
                    domain_mask=tuple(jnp.asarray(m) for m in stacked),
                    mode="batch_with_mask")
    tm.eval()
    with torch.no_grad():
        out = tm(torch.tensor(x), domain_mask=stacked, mode="batch_with_mask")
        assert tuple(out["leaf_active"].shape) == (48, N_TOWER[-1])
        for k in ("prob", "logit", "leaf_logit"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
        for d in range(N_DOMAIN):
            idx = np.nonzero(dom == d)[0]
            assert len(idx) > 0
            od = tm(torch.tensor(x[idx]), domain_mask=masks[d],
                    mode="domain_with_mask")
            np.testing.assert_allclose(out["prob"].numpy()[idx],
                                       od["prob"].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="eval-only"):
        tm(torch.tensor(x), domain_mask=stacked, mode="batch_with_mask",
           train=True)
    with pytest.raises(ValueError, match="unknown mode"):
        tm(torch.tensor(x), mode="nope")


# ---------------------------------------------------------------- lazy Adam
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_lazy_adam_matches_jax(moments):
    """Against ``_lazy_sparse_adam`` on the [n_rows, D] view: untouched
    rows bitwise unchanged (weights and moments), touched rows at atol
    1e-6 (f32 moments; bf16 moments within one bf16 ulp of their size)."""
    rng = np.random.default_rng(0)
    n_rows, d = 96, 8
    w = rng.standard_normal((n_rows, d)).astype(np.float32)
    m = (0.1 * rng.standard_normal((n_rows, d))).astype(np.float32)
    v = (0.01 * rng.random((n_rows, d))).astype(np.float32)
    ids = rng.integers(0, n_rows // 2, size=40).astype(np.int32)
    grads = rng.standard_normal((40, d)).astype(np.float32)
    mdt = getattr(torch, moments)
    tw, tm_, tv = (torch.tensor(w), torch.tensor(m).to(mdt),
                   torch.tensor(v).to(mdt))
    m0, v0 = tm_.clone(), tv.clone()
    uids, gsum = dedup_rows(torch.tensor(ids), torch.tensor(grads), n_rows)
    assert int((uids == n_rows).sum()) > 0  # sentinel entries are present
    kw = dict(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5)
    jw, jm_, jv = _lazy_sparse_adam(
        jnp.asarray(w), jnp.asarray(m0.float().numpy()).astype(moments),
        jnp.asarray(v0.float().numpy()).astype(moments),
        jnp.asarray(uids.numpy()), jnp.asarray(gsum.numpy()), jnp.int32(3),
        table_shape=(n_rows, d), **kw)
    l2 = sparse_adam_dispatch(tw, tm_, tv, uids, gsum, 3, want_l2=True,
                              lazy=True, **kw)
    np.testing.assert_allclose(float(l2), float(np.sum(w * w)), rtol=1e-6)
    touched = np.zeros(n_rows, bool)
    touched[ids] = True
    assert touched.sum() < n_rows
    np.testing.assert_array_equal(tw.numpy()[~touched], w[~touched])
    assert torch.equal(tm_[~touched], m0[~touched])
    assert torch.equal(tv[~touched], v0[~touched])
    assert not np.array_equal(tw.numpy()[touched], w[touched])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    atol = 1e-6 if moments == "float32" else 2.0 ** -8
    for got, want in ((tm_, jm_), (tv, jv)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            rtol=atol if moments == "bfloat16" else 0, atol=atol)
    # the function itself returns nothing and takes the same arguments
    assert lazy_sparse_adam_(tw, tm_, tv, uids, gsum, 4, **kw) is None


def test_lazy_adam_step_touches_gathered_rows_only(world):
    """``table_optimizer='lazy_adam'`` through the trainer's step: rows
    outside the batch keep their bits, rows inside move."""
    _, _, _, _, tr = _fresh(world, table_optimizer="lazy_adam")
    table = tr.model.embedding.table
    before = table.clone()
    batch = pad_batch(world.data.train_x[:BS], world.data.train_y[:BS], BS)
    ids = tr.model.embedding.table_ids(torch.tensor(batch["x"]))
    loss, _ = tr.main_step(batch, _rand_masks(4)[0])
    assert np.isfinite(float(loss)) and tr.opt_state["t"] == 1
    touched = torch.zeros(table.shape[0], dtype=torch.bool)
    touched[ids.reshape(-1).long()] = True
    assert torch.equal(table[~touched], before[~touched])
    assert not torch.equal(table[touched], before[touched])
    assert float(tr.opt_state["m"][~touched].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="table_optimizer"):
        AREADTrainer(tr.model, Config(**{**CFG_KW, "table_optimizer": "sgd"}),
                     N_DOMAIN)


# ----------------------------------------------------------------- the loop
def _spy(ms):
    """Keep what an evolution hands to update_all_mask (it is reset right
    after)."""
    orig = ms.update_all_mask

    def update_all_mask():
        ms.seen_losses = [[list(z) for z in d] for d in ms.eval_loss]
        ms.seen_candidates = [[[np.array(l) for l in m] for m in d]
                              for d in ms.candidate_domain_mask]
        orig()

    ms.update_all_mask = update_all_mask


def test_mask_evolution_matches_jax(world):
    """One evolution from a shared state: every candidate's pruned mask
    and the chosen masks equal, all probe losses at atol 1e-4 (two adapt
    steps at lr 1e-2 from f32 round-off), the schedule equal; in the port
    the weights, the BatchNorm statistics and the main optimizer's state
    are bitwise what they were."""
    jt, params, state, _, tr = _fresh(world)
    _share_hemp_state(jt, tr, seed=5)
    _spy(jt.mask_state)
    _spy(tr.mask_state)
    jtrain, jaug = _batchers(world, JDomainBatcher)
    ptrain, paug = _batchers(world, DomainBatcher)
    # one main step first, so that the main optimizer's state is not zeros
    batch = pad_batch(world.data.train_x[:BS], world.data.train_y[:BS], BS)
    tr.main_step(batch, tr.mask_state.domain_mask[0])
    tr.model.load_state_dict(convert_variables(
        world.params, world.state["batch_stats"], E))
    sd0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt0 = {"m": tr.opt_state["m"].clone(), "v": tr.opt_state["v"].clone(),
            "mu": {k: v.clone() for k, v in tr.opt_state["inner"]["mu"].items()},
            "nu": {k: v.clone() for k, v in tr.opt_state["inner"]["nu"].items()}}

    jt._mask_evolution(params, state, jtrain, jaug, jax.random.PRNGKey(3),
                       verbose=False)
    tr._mask_evolution(ptrain, paug, verbose=False)

    jms, pms = jt.mask_state, tr.mask_state
    n_cand = 2  # int(3 * 0.99)
    for d in range(N_DOMAIN):
        assert len(pms.seen_candidates[d]) == n_cand
        for a, b in zip(jms.seen_candidates[d], pms.seen_candidates[d]):
            _assert_masks_equal(a, b)
        _assert_masks_equal(jms.domain_mask[d], pms.domain_mask[d])
        jl, pl = np.array(jms.seen_losses[d]), np.array(pms.seen_losses[d])
        assert jl.shape == pl.shape == (n_cand, 2)
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
        # the choice is no near tie
        assert abs(np.diff(jl.mean(axis=1))[0]) > 1e-3
    for name in ("random_modify_sigma", "init_active_percent",
                 "candidate_mask_num", "regroup_times"):
        assert getattr(tr, name) == getattr(jt, name), name
    assert tr.regroup_log[0]["chains"] == N_DOMAIN * n_cand
    assert pms.eval_loss == [[] for _ in range(N_DOMAIN)]  # reset
    assert jms.rng.bit_generator.state == pms.rng.bit_generator.state
    # the data streams moved alike
    for jb, pb in ((jtrain, ptrain), (jaug, paug)):
        assert jb.rng.bit_generator.state == pb.rng.bit_generator.state
    # nothing leaked out of the chains
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, sd0[k]), k
    assert tr.opt_state["t"] == 1 and tr.opt_state["inner"]["count"] == 1
    assert torch.equal(tr.opt_state["m"], opt0["m"])
    assert torch.equal(tr.opt_state["v"], opt0["v"])
    for k in ("mu", "nu"):
        for name, v in tr.opt_state["inner"][k].items():
            assert torch.equal(v, opt0[k][name]), (k, name)
    # the chains ran from fresh moments: their state counts one chain
    assert tr._fast_state["t"] == 2 and tr._fast_state is not tr.opt_state


def test_prune_routes_give_the_same_evolution(world):
    """The chain prunes on the device (the tensor twin); with the host
    ``prune_mask`` put in its place an evolution chooses the same masks
    and the same probe losses, bitwise."""
    def host_prune(mask, gate_means):
        pruned = prune_mask([m.numpy() for m in mask],
                            [g.numpy() for g in gate_means])
        return tuple(torch.tensor(m) for m in pruned)

    seen = {}
    for route in ("host", "tensor"):
        _, _, _, _, tr = _fresh(world)
        if route == "host":
            tr._prune = host_prune
        _share_hemp_state(world.jt, tr, seed=5)
        _spy(tr.mask_state)
        tr._mask_evolution(*_batchers(world, DomainBatcher), verbose=False)
        seen[route] = tr.mask_state
    for d in range(N_DOMAIN):
        assert seen["host"].seen_losses[d] == seen["tensor"].seen_losses[d]
        for a, b in zip(seen["host"].seen_candidates[d],
                        seen["tensor"].seen_candidates[d]):
            _assert_masks_equal(a, b)


def test_train_epoch_with_two_regroups_matches_jax(world):
    """Epoch 0: 32 warm-up steps, an evolution, 31 bagging steps, a second
    evolution, the rest of the sequence. Masks equal, the epoch loss and
    every weight, statistic and Adam moment at atol 1e-4."""
    jt, params, state, opt_state, tr = _fresh(world)
    jtrain, jaug = _batchers(world, JDomainBatcher)
    ptrain, paug = _batchers(world, DomainBatcher)
    assert len(ptrain.domain_batch_seq) >= 32
    params, state, opt_state, _, jloss = jt.train_epoch(
        params, state, opt_state, 0, jtrain, jaug, jax.random.PRNGKey(1),
        verbose=False)
    ploss = tr.train_epoch(0, ptrain, paug, verbose=False)
    assert tr.regroup_times == jt.regroup_times == 2
    for d in range(N_DOMAIN):
        _assert_masks_equal(jt.mask_state.domain_mask[d],
                            tr.mask_state.domain_mask[d])
    np.testing.assert_allclose(ploss, jloss, rtol=0, atol=1e-4)
    _assert_weights_close(tr.model, params, state, 1e-4)
    n_steps = 32 + len(ptrain.domain_batch_seq)
    assert tr.opt_state["t"] == int(opt_state["t"]) == n_steps
    np.testing.assert_allclose(
        tr.opt_state["m"].numpy(),
        np.asarray(opt_state["m"]).reshape(-1, E), rtol=0, atol=1e-4)
    assert jtrain.rng.bit_generator.state == ptrain.rng.bit_generator.state
    # gate records of the last window wait for the next regroup
    assert [len(a) for a in tr.mask_state.gate_acc] == \
        [len(a) for a in jt.mask_state.gate_acc]


def test_final_epoch_moves_final_gate_only(world):
    """One final-gate epoch: every parameter except final_gate is bitwise
    what it was; final_gate and its Adam state match JAX at atol 1e-5."""
    jt, params, state, _, tr = _fresh(world)
    _share_hemp_state(jt, tr, seed=8)
    jtrain, _ = _batchers(world, JDomainBatcher)
    ptrain, _ = _batchers(world, DomainBatcher)
    fns = jt._fns or jt._build_fns()
    fstate = fns["final_opt"].init(params["final_gate"])
    params, state, fstate, _, jloss = jt.train_final_epoch(
        params, state, fstate, 0, jtrain, jax.random.PRNGKey(2), verbose=False)
    before = {n: p.detach().clone()
              for n, p in tr.model.dense_named_parameters().items()}
    table0 = tr.model.embedding.table.clone()
    pstate = tr.final_optimizer.init(
        {"final_gate/kernel": tr.model.final_gate.kernel})
    ploss = tr.train_final_epoch(pstate, 0, ptrain, verbose=False)
    np.testing.assert_allclose(ploss, jloss, rtol=0, atol=1e-5)
    for n, p in tr.model.dense_named_parameters().items():
        if n == "final_gate/kernel":
            assert not torch.equal(p, before[n])
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(params["final_gate"]["kernel"]),
                rtol=0, atol=1e-5)
        else:
            assert torch.equal(p, before[n]), n
    assert torch.equal(tr.model.embedding.table, table0)
    want = convert_final_opt_state(_np_tree(fstate))
    assert want["count"] == pstate["count"] == len(ptrain.domain_batch_seq)
    for k in ("mu", "nu"):
        assert set(want[k]) == {"final_gate/kernel"}
        np.testing.assert_allclose(pstate[k]["final_gate/kernel"].numpy(),
                                   want[k]["final_gate/kernel"].numpy(),
                                   rtol=0, atol=1e-5)
    assert tr.opt_state["t"] == 0  # the main optimizer took no step


def test_fit_with_final_gate_matches_jax(world, monkeypatch):
    """Two epochs of fit and two final-gate epochs from the same weights:
    train losses at atol 1e-4 (1e-3 in the final phase, after ~80 steps),
    every AUC at atol 1e-3 (a swap of two near-tied predictions among 140
    valid rows moves an AUC by ~2e-4), masks and the early-stop
    bookkeeping equal."""
    jt, params, state, _, tr = _fresh(world)
    monkeypatch.setattr(jt, "init", lambda rng, sample: (
        params, state, j_hybrid_init(jt.optimizer, params,
                                     moments_dtype="float32")))
    jres = jt.fit(world.jdata, rng=jax.random.PRNGKey(0), epochs=2,
                  verbose=False, final_gate=True)
    pres = tr.fit(world.data, epochs=2, verbose=False, final_gate=True)
    assert len(pres["history"]) == len(jres["history"])
    assert [h.get("phase") for h in pres["history"]] == \
        [h.get("phase") for h in jres["history"]]
    for ph, jh in zip(pres["history"], jres["history"]):
        atol = 1e-3 if ph.get("phase") == "final_gate" else 1e-4
        np.testing.assert_allclose(ph["train_loss"], jh["train_loss"],
                                   rtol=0, atol=atol)
        for k in ("total_auc", "mean_auc"):
            np.testing.assert_allclose(ph[k], jh[k], rtol=0, atol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(ph["total_loss"], jh["total_loss"],
                                   rtol=0, atol=1e-3)
    for k in ("total_auc", "mean_auc"):
        np.testing.assert_allclose(pres["test"][k], jres["test"][k], rtol=0,
                                   atol=1e-3)
    for d in range(N_DOMAIN):
        _assert_masks_equal(jres["domain_mask"][d], pres["domain_mask"][d])
    assert tr.regroup_times == jt.regroup_times >= 2
    assert tr.trial_counter == jt.trial_counter
    assert tr.best_checkpoint[2] == jt.best_checkpoint[2]
    np.testing.assert_allclose(tr.best_mean_auc, jt.best_mean_auc, rtol=0,
                               atol=1e-3)
    assert tr._device_data is None


def test_device_data_path_equals_host_path(world):
    """Inside the port: fit over the device-resident split (batches
    gathered by row id) is bitwise the fit over host-staged batches."""
    runs = {}
    for mode in ("0", "1"):
        _, _, _, _, tr = _fresh(world, device_data=mode)
        res = tr.fit(world.data, epochs=1, verbose=False, final_gate=True)
        runs[mode] = (tr, res)
    (th, rh), (td, rd) = runs["0"], runs["1"]
    assert td.regroup_times == th.regroup_times == 2
    for k, v in th.model.state_dict().items():
        assert torch.equal(v, td.model.state_dict()[k]), k
    for d in range(N_DOMAIN):
        _assert_masks_equal(rh["domain_mask"][d], rd["domain_mask"][d])
    strip = lambda h: {k: v for k, v in h.items()
                       if k not in ("epoch_time_s", "examples_per_s", "spans")}
    assert [strip(h) for h in rh["history"]] == [strip(h) for h in rd["history"]]
    assert rh["test"] == rd["test"]


def test_gather_batch_equals_pad_batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, size=(40, 6)).astype(np.int32)
    y = rng.integers(0, 2, size=40).astype(np.int8)
    idx = np.full((16,), -1, np.int32)
    idx[:11] = rng.permutation(40)[:11]
    want = pad_batch(x[idx[:11]], y[idx[:11]], 16)
    got = gather_batch(torch.tensor(x), torch.tensor(y), torch.tensor(idx))
    for k in ("x", "y", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got[k].numpy().dtype == want[k].dtype


def test_trainer_state_and_schedule(world):
    """The HEMP schedule decays as the JAX package's: a configured 2
    candidates gives 1 after the first decay; the fast optimizer's state is
    one allocation, zeroed in place."""
    _, _, _, _, tr = _fresh(world, candidate_mask_num=2)
    assert (tr.fast_optimizer.lr, tr.final_optimizer.lr) == (1e-2, 1e-3)
    assert not tr.overlay_enabled()
    st = tr._fresh_fast_state()
    st["m"].add_(1.0)
    st["t"], st["inner"]["count"] = 5, 5
    next(iter(st["inner"]["mu"].values())).add_(1.0)
    again = tr._fresh_fast_state()
    assert again is st and again["m"].data_ptr() == st["m"].data_ptr()
    assert st["t"] == 0 and st["inner"]["count"] == 0
    assert float(st["m"].abs().sum()) == 0.0
    assert all(float(v.abs().sum()) == 0.0 for v in st["inner"]["mu"].values())
    tr.mask_state.init_full_masks()
    tr._mask_evolution(*_batchers(world, DomainBatcher), verbose=False)
    assert tr.regroup_log[0]["candidates"] == 1
    assert tr.candidate_mask_num == 2 * 0.99
    assert tr.init_active_percent == 0.7 * 0.95
    with pytest.raises(RuntimeError, match="init"):
        AREADTrainer(tr.model, tr.config, N_DOMAIN).main_step(
            pad_batch(world.data.train_x[:BS], world.data.train_y[:BS], BS),
            tr.mask_state.domain_mask[0])
