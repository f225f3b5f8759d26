"""The overlay fast-adapt engine of the port (aread_tpu_torch/ops/
overlay_adam.py and AREADTrainer's overlay chains) against the JAX
package's (aread_tpu/ops/overlay_adam.py, ``fast_adapt_many_ov``), at the
shapes of the JAX package's own tests/test_overlay.py with its table
stored row by row (``_setup(flat=False)``: one table row per working-set
slot, the only layout the port has): 3 domains, a vocab of 60, E 8,
n_tower (2, 4), bs 32, 3 adapt steps and 2 probes a chain, 2 candidates.
Inputs are made from a seed with numpy, the JAX weights drawn by
``seeded_variables`` and carried over by convert.py; f32 table and
moments; dropout 0.

Tolerances, each stated where it is used: the working set equal as a set
(the JAX one keeps duplicate slots, the port's holds each row once);
``compact_grad`` exact (a gather of the same deduplicated sums); every
function that runs Adam (the compact step, the drift, the gather with
drift) within one f32 ulp (the fused Adam's plain version against
``reference_adam_update``: Queue 3's one-ulp gap); the whole-table drift
L2 and the correction at rtol 1e-6 (f32 sums in another order); one
overlay evolution: masks exact, probe losses atol 1e-5; the port's
overlay against the port's full sweep on the f32 table: masks exact,
probe losses rtol 2e-4 atol 2e-5 (the JAX test's bound).

A linear bias that feeds a BatchNorm has a true gradient of exactly 0; the
computed one is round-off, which a fresh Adam normalizes into a step of
lr. Both sides get the true 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import aread_tpu.ops.overlay_adam as JOA
import aread_tpu.train.hemp as JH
from aread_tpu.config import Config as JConfig
from aread_tpu.models.aread import AREAD as JAREAD
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.ops.sparse_adam import dedup_rows as j_dedup_rows
from aread_tpu.utils.masks import validate_mask
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_variables
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models.aread import AREAD, full_mask
from aread_tpu_torch.models.base import FeatureSpec
from aread_tpu_torch.ops import fused_adam, overlay_adam as oa, sparse_adam
from aread_tpu_torch.ops.sparse_adam import dedup_rows
from aread_tpu_torch.train import hemp
from aread_tpu_torch.train.hemp import AREADTrainer, overlay_mode_enabled
from aread_tpu_torch.train.trainer import TABLE_L2
from tests.test_torch_port_hemp import (DenseAdamTrueZero, _true_zero_jax)
from tests.test_torch_port_zoo import seeded_variables

E, N_TOWER, N_DOMAIN, BS = 8, (2, 4), 3, 32
N_CAND, S_FA, S_PR = 2, 3, 2
MODEL_KW = dict(embed_dim=E, n_tower=N_TOWER, n_domain=N_DOMAIN,
                expert_dims=(16, 8), tower_dims=((8, 8), (8, 8)),
                mmoe_n_expert=2, dropout=0.0)
CFG_KW = dict(model="aread", bs=BS, embed_dim=E, dropout=0.0,
              table_dtype="float32", table_moments_dtype="float32",
              regroup_update_step=S_FA, regroup_eval_step=S_PR,
              candidate_mask_num=N_CAND, warm_up_interval=1,
              regroup_interval=4, hemp_fast_adapt="overlay")
HYPER = dict(lr=1e-2, wd=1e-8, l2=TABLE_L2)
ULP = 2.0 ** -23  # one f32 ulp, relative


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def world():
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60,
                               seed=5)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    jm = JAREAD(spec=jspec, base_model="mmoe", **MODEL_KW)
    # through 'domain_mask_final', as the JAX trainer's init: every leaf
    fm = tuple(jnp.asarray(m) for m in full_mask(N_TOWER))
    variables = seeded_variables(jm, jnp.asarray(data.train_x[:BS]),
                                 domain_mask=fm, mode="domain_mask_final",
                                 train=False, seed=1)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    jt = JH.AREADTrainer(jm, JConfig(**CFG_KW), N_DOMAIN)
    inner = jt.fast_optimizer
    jt.fast_optimizer = optax.GradientTransformation(
        inner.init, lambda g, s, p=None: inner.update(_true_zero_jax(g), s, p))
    return dataclasses.make_dataclass("World", [
        "data", "jspec", "jt", "fns", "params", "state"])(
        data, jspec, jt, jt._build_fns(), params, state)


def _port_trainer(world, **cfg_kw):
    tm = AREAD(world.data.spec, device="cpu", **MODEL_KW)
    tm.load_state_dict(convert_variables(
        _np_tree(world.params), _np_tree(world.state["batch_stats"]), E))
    cfg = Config(**{**CFG_KW, **cfg_kw})
    tr = AREADTrainer(tm, cfg, N_DOMAIN)
    tr.fast_optimizer = DenseAdamTrueZero(lr=cfg.update_lr, wd=cfg.wd)
    tr.init()
    return tr


def _stacks(data, seed):
    """Candidate stacks [N, S, bs, ...] as numpy: adapt rows drawn from the
    train split, probe rows with every one-hot id rotated within its
    vocab, so that some probe rows lie outside every adapt batch (the
    drift path)."""
    rng = np.random.default_rng(seed)
    dims = np.asarray(data.spec.one_hot_dims)
    F = data.train_x.shape[1]

    def stack(n_steps, shift):
        xs = np.empty((N_CAND, n_steps, BS, F), np.int32)
        ys = np.empty((N_CAND, n_steps, BS), np.float32)
        for c in range(N_CAND):
            for s in range(n_steps):
                idx = rng.integers(0, len(data.train_x), size=BS)
                x = data.train_x[idx].astype(np.int64)
                if shift:
                    for f in range(min(len(dims), F)):
                        x[:, f] = (x[:, f] + 7) % dims[f]
                xs[c, s] = x
                ys[c, s] = data.train_y[idx]
        return {"x": xs, "y": ys,
                "valid": np.ones((N_CAND, n_steps, BS), np.float32)}

    return stack(S_FA, shift=False), stack(S_PR, shift=True)


def _masks0(seed):
    """Per candidate, the full mask with 30% of the deeper edges dropped,
    then validated: [n_levels] stacked [N, ...] bool arrays."""
    fm = [np.asarray(m) for m in full_mask(N_TOWER)]
    rng = np.random.default_rng(seed)
    per_cand = []
    for _ in range(N_CAND):
        m = [mm.copy() for mm in fm]
        for li in range(1, len(m)):
            m[li] = m[li] & ~(rng.random(m[li].shape) < 0.3)
        per_cand.append([np.asarray(x) for x in validate_mask(m)])
    return [np.stack([per_cand[c][li] for c in range(N_CAND)])
            for li in range(len(fm))]


def _assert_ulp(got, want, ulps=1):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=ulps * ULP, atol=0)


# ------------------------------------------------------ the module's parts
FUNCTIONS = ("working_set", "compact_grad", "adam_step", "drift_rows",
             "gather", "drift_table_l2", "l2_correction")


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_overlay_function_matches_jax(world, fn):
    data, jspec = world.data, world.jspec
    table_np = np.asarray(world.params["embedding"]["table"])
    table, jtable = torch.tensor(table_np), jnp.asarray(table_np)
    fa, probe = _stacks(data, seed=3)
    xs = fa["x"][0]                                       # [S, bs, F]
    jws = np.asarray(JOA.build_working_set(jspec, 1, jnp.asarray(xs)))
    emb = AREAD(data.spec, device="cpu", **MODEL_KW).embedding
    ws = oa.build_working_set(emb, torch.tensor(xs))
    if fn == "working_set":
        # the same rows, sorted; the port's once each
        assert np.array_equal(ws.numpy(), np.unique(jws))
        assert (np.diff(ws.numpy()) > 0).all() and len(ws) < len(jws)
        return
    # a JAX slot's row is the port's slot of the same row
    slot = np.searchsorted(ws.numpy(), jws)
    rng = np.random.default_rng(4)
    n_rows = table_np.shape[0]
    if fn == "compact_grad":
        ids = emb.table_ids(torch.tensor(xs[0])).reshape(-1)
        g = rng.standard_normal((len(ids), E)).astype(np.float32)
        juids, jgsum = j_dedup_rows(jnp.asarray(ids.numpy(), jnp.int32),
                                    jnp.asarray(g), n_rows)
        uids, gsum = dedup_rows(ids.to(torch.int32), torch.tensor(g), n_rows)
        jcg = np.asarray(JOA.compact_grad(jnp.asarray(jws), juids, jgsum, 1))
        cg = oa.compact_grad(ws, uids, gsum).numpy()
        np.testing.assert_array_equal(cg[slot], jcg)
        # rows of the working set the batch did not touch: exact zeros
        assert (cg[~np.isin(ws.numpy(), ids.numpy())] == 0).all()
        return
    C = len(ws)
    w0 = rng.standard_normal((C, E)).astype(np.float32)
    if fn == "adam_step":
        m0 = (0.1 * rng.standard_normal((C, E))).astype(np.float32)
        v0 = (0.01 * rng.random((C, E))).astype(np.float32)
        g = rng.standard_normal((C, E)).astype(np.float32)
        w, m, v = (torch.tensor(a) for a in (w0, m0, v0))
        jw, jm, jv = (jnp.asarray(a) for a in (w0, m0, v0))
        for t in range(1, 4):
            oa.overlay_adam_step(w, m, v, torch.tensor(g), t, **HYPER)
            jw, jm, jv = JOA.overlay_adam_step(jw, jm, jv, jnp.asarray(g),
                                               jnp.asarray(t, jnp.int32),
                                               **HYPER)
        for a, b in ((w, jw), (m, jm), (v, jv)):
            _assert_ulp(a.numpy(), b)
    elif fn == "drift_rows":
        got = oa.drift_rows(torch.tensor(w0), S_FA, **HYPER)
        _assert_ulp(got.numpy(), JOA.drift_rows(jnp.asarray(w0), S_FA,
                                                **HYPER))
        # the drift is no no-op: decay * w normalizes to lr-sized steps
        assert np.abs(got.numpy() - w0).max() > 0.5 * HYPER["lr"]
    elif fn == "gather":
        rid = emb.table_ids(torch.tensor(probe["x"][0, 0]))  # [bs, F]
        assert not np.isin(rid.numpy(), ws.numpy()).all()
        wvals = rng.standard_normal((C, E)).astype(np.float32)
        for drift in (0, S_FA):
            got = oa.overlay_gather(table, rid, ws=ws,
                                    wvals=torch.tensor(wvals),
                                    drift_steps=drift, **HYPER)
            want = JOA.overlay_gather(jtable, jnp.asarray(rid.numpy()),
                                      ws=jnp.asarray(jws),
                                      wvals=jnp.asarray(wvals[slot]),
                                      drift_steps=drift, **HYPER)
            _assert_ulp(got.numpy(), want)
    elif fn == "drift_table_l2":
        got = float(oa.drift_table_l2(table, S_FA, **HYPER))
        want = float(JOA.drift_table_l2(jtable, S_FA, **HYPER))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        got = float(oa.overlay_l2_correction(table, ws, torch.tensor(w0),
                                             S_FA, **HYPER))
        want = float(JOA.overlay_l2_correction(
            jtable, jnp.asarray(jws), jnp.asarray(w0[slot]), S_FA, **HYPER))
        # a difference of two sums over the working set: bounded by their
        # size, not by the difference's
        scale = float(np.sum(np.square(w0))) * 2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


# -------------------------------------------------------------- the chains
def _port_candidates(tr, fa, probe, masks0, drift_l2):
    snap = tr._snapshot(table=False)
    out_masks, out_losses = [], []
    for c in range(N_CAND):
        tr._restore(snap)
        batches = [[{k: torch.tensor(st[k][c, s]) for k in st}
                    for s in range(st["x"].shape[1])] for st in (fa, probe)]
        mask, losses = tr._fast_adapt([m[c] for m in masks0], *batches,
                                      drift_l2)
        out_masks.append(mask)
        out_losses.append(losses.numpy())
    tr._restore(snap)
    return out_masks, np.stack(out_losses)


def test_overlay_chains_match_jax(world):
    """Both candidates' chains from the same weights, masks and batches:
    the JAX package's fast_adapt_many_ov against the port's overlay
    _fast_adapt. Pruned masks exact, probe losses atol 1e-5 (three adapt
    steps at lr 1e-2 from f32 round-off)."""
    fa, probe = _stacks(world.data, seed=7)
    masks0 = _masks0(seed=2)
    table = world.params["embedding"]["table"]
    jdrift = world.fns["drift_l2"](table)
    jm, jl = world.fns["fast_adapt_many_ov"](
        world.params, world.state, tuple(jnp.asarray(m) for m in masks0),
        jax.tree_util.tree_map(jnp.asarray, fa),
        jax.tree_util.tree_map(jnp.asarray, probe),
        jax.random.split(jax.random.PRNGKey(11), N_CAND), jdrift)
    tr = _port_trainer(world)
    table0 = tr.model.embedding.table.clone()
    drift_l2 = oa.drift_table_l2(tr.model.embedding.table, S_FA,
                                 tr.config.update_lr, tr.config.wd, TABLE_L2)
    np.testing.assert_allclose(float(drift_l2), float(jdrift), rtol=1e-6)
    masks, losses = _port_candidates(tr, fa, probe, masks0, drift_l2)
    for c in range(N_CAND):
        for li, m in enumerate(masks[c]):
            np.testing.assert_array_equal(m, np.asarray(jm[li][c]))
    np.testing.assert_allclose(losses, np.asarray(jl), rtol=0, atol=1e-5)
    # the candidates differ (the override reads the adapted values)
    assert abs(losses[0].mean() - losses[1].mean()) > 1e-6
    # the live table was never written
    assert torch.equal(tr.model.embedding.table, table0)


def test_overlay_evolution_equals_full_sweep_and_its_launches(world,
                                                              monkeypatch):
    """One _mask_evolution from the same weights and streams under 'full'
    and under 'overlay' (f32 table): every candidate's pruned mask and the
    chosen masks equal, probe losses rtol 2e-4 atol 2e-5. The overlay runs
    no sparse-Adam sweep and the fused dense Adam on the schedule that
    chip_smoke.py holds the card's launch counts to: per chain S compact
    steps, S drift steps per probe batch and S for the L2 correction; S
    per regroup for the whole-table drift. The weights, the statistics
    and the table come out of both evolutions bitwise as they went in."""
    from aread_tpu_torch.data.loader import DomainBatcher

    calls = {"sparse": 0, "fused": 0}
    real_sparse = sparse_adam.sparse_adam_dispatch
    real_fused = fused_adam.fused_adam_dispatch

    def count(name, real):
        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return f

    monkeypatch.setattr("aread_tpu_torch.train.trainer.sparse_adam_dispatch",
                        count("sparse", real_sparse))
    monkeypatch.setattr(oa, "fused_adam_dispatch",
                        count("fused", real_fused))
    data = world.data
    seen = {}
    for mode in ("full", "overlay"):
        tr = _port_trainer(world, hemp_fast_adapt=mode,
                           candidate_mask_num=3, seed=11)
        ms = tr.mask_state
        for d in range(N_DOMAIN):
            ms.domain_mask[d] = ms.generate_mask("rand", d, 0.7)
        cands, losses = [], []
        update = ms.update_all_mask

        def spy(ms=ms, cands=cands, losses=losses, update=update):
            cands.extend(m for d in ms.candidate_domain_mask for m in d)
            losses.extend(z for d in ms.eval_loss for z in d)
            update()

        ms.update_all_mask = spy
        sd0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
        calls.update(sparse=0, fused=0)
        batchers = [DomainBatcher(data.train_x, data.train_y, BS,
                                  data.spec.domain_idx, N_DOMAIN, seed=s)
                    for s in (1, 2)]
        tr._mask_evolution(*batchers, verbose=False)
        for k, v in tr.model.state_dict().items():
            assert torch.equal(v, sd0[k]), k
        chains = tr.regroup_log[0]["chains"]
        assert tr.regroup_log[0]["overlay"] == (mode == "overlay")
        seen[mode] = (cands, np.array(losses), dict(calls), chains,
                      [[m.copy() for m in dm] for dm in ms.domain_mask])
    (fc, fl, fcalls, chains, fdm), (oc, ol, ocalls, _, odm) = (
        seen["full"], seen["overlay"])
    assert chains == N_DOMAIN * 2  # int(3 * 0.99) candidates a domain
    for a, b in zip(fc + fdm, oc + odm):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(ol, fl, rtol=2e-4, atol=2e-5)
    assert fcalls == {"sparse": chains * S_FA, "fused": 0}
    assert ocalls == {"sparse": 0,
                      "fused": chains * S_FA * (2 + S_PR) + S_FA}


# ------------------------------------------------------- engine selection
def _spec(n_rows):
    return FeatureSpec((n_rows, 7, 25), 2, 0, 0, 5)


@pytest.mark.parametrize("mode,sparse,n_rows,want", [
    ("full", True, 8_000_000, False),
    ("overlay", True, 10, True),
    ("overlay", False, 10, ValueError),
    ("auto", True, 7_499_967, False),    # 32 elements short of 240M
    ("auto", True, 7_499_968, True),     # 240,000,000 elements
    ("auto", False, 8_000_000, False),
    ("typo", True, 10, ValueError),
], ids=["full", "overlay", "overlay_dense", "auto_below", "auto_at",
        "auto_dense", "typo"])
def test_overlay_mode_matches_jax_rule(mode, sparse, n_rows, want):
    """Which engine each hemp_fast_adapt mode picks, from the spec alone
    (no table is built: 7,499,968 rows and the 32 of the small fields, x
    E 32, are 240,000,000 elements, one row fewer is 32 short), as the JAX
    package's overlay_enabled picks for the same spec and config."""
    spec = _spec(n_rows)
    jspec = JFeatureSpec(*dataclasses.astuple(spec)[:5])
    jt = JH.AREADTrainer.__new__(JH.AREADTrainer)
    jt.config = JConfig(hemp_fast_adapt=mode, sparse_table_grad=sparse)
    jt.model = JAREAD(spec=jspec, embed_dim=32, n_tower=N_TOWER,
                      n_domain=N_DOMAIN)
    jt.mesh = None
    if want is ValueError:
        with pytest.raises(ValueError):
            overlay_mode_enabled(mode, sparse, spec, 32)
        with pytest.raises(ValueError):
            jt.overlay_enabled()
        return
    assert overlay_mode_enabled(mode, sparse, spec, 32) is want
    assert jt.overlay_enabled() is want
    assert hemp.OVERLAY_AUTO_MIN_ELEMS == JH.AREADTrainer.OVERLAY_AUTO_MIN_ELEMS
