"""The port's generic Trainer (aread_tpu_torch/train/trainer.py) against
the JAX package's, from the same weights and optimizer state (carried by
aread_tpu_torch/convert.py) on the same seed-made data:

* three steps of Trainer.step against the JAX Trainer's step core, with
  the dense table gradient (JAX's table update through
  reference_adam_update and through its Pallas kernel in interpret mode)
  and with the sparse one, with and without the global-norm clip, f32
  table and moments, dropout 0: losses, weights, BatchNorm statistics and
  every Adam moment at atol 1e-5 (f32 products summed in another order;
  the dense gradient's duplicate ids are added in sorted order here, in
  XLA's order there);
* one dense step with a bf16 table, where the gap to JAX is the dense
  gradient's accumulation (see the test);
* GlobalBatcher's epoch streams, bit-equal;
* two epochs of Trainer.fit: train loss, valid and test metrics, the
  early-stop bookkeeping;
* the device-resident epoch against the host-batch epoch inside the port;
* the options ported since they were refused run (streaming_eval,
  warm_start and ckpt_dir: tests/test_torch_port_checkpoint.py,
  tests/test_torch_port_streaming_auc.py; a mesh and embed_lookup='a2a':
  tests/test_torch_port_parallel.py, tests/test_torch_port_mesh.py).

A linear bias that feeds a BatchNorm has a true gradient of exactly 0; the
computed one is round-off, which Adam normalizes into a step of up to lr
either way. Both sides get the true 0 (the JAX side through a wrapper
around its hybrid_update / hybrid_update_sparse that changes nothing
else), so that the comparison measures the port."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.data.loader import GlobalBatcher as JGlobalBatcher
from aread_tpu.data.loader import SplitData as JSplitData
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.dcn import DCN as JDCN
from aread_tpu.models.deepfm import DeepFM as JDeepFM
from aread_tpu.models.mmoe import MMoE as JMMoE
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_opt_state, convert_variables
from aread_tpu_torch.data.loader import GlobalBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.models.dcn import DCN
from aread_tpu_torch.models.deepfm import DeepFM
from aread_tpu_torch.models.mmoe import MMoE
from aread_tpu_torch.train import trainer as T
from aread_tpu_torch.train.trainer import DenseAdam, Trainer

E, N_DOMAIN, BS = 8, 4, 64
D2G = np.array([0, 1, 2, 1])
PRE_BN_BIAS = re.compile(r"^(mlp|experts|towers)/linear_\d+/bias$")
MODELS = {
    "deepfm": (JDeepFM, DeepFM, dict(mlp_dims=(16, 8))),
    "dcn": (JDCN, DCN, dict(n_cross_layers=2, mlp_dims=(16, 8))),
    "mmoe": (JMMoE, MMoE, dict(
        n_tower=3, n_expert=2, expert_dims=(16, 8), tower_dims=(8, 4),
        n_cross_layers=2, atten_embed_dim=8, att_layer_num=2,
        att_head_num=2)),
}


class DenseAdamTrueZero(DenseAdam):
    def update_(self, params, grads, state, scalars=None):
        grads = {n: torch.zeros_like(g) if PRE_BN_BIAS.match(n) else g
                 for n, g in grads.items()}
        super().update_(params, grads, state, scalars)


def _true_zero_jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, g: jnp.zeros_like(g) if PRE_BN_BIAS.match(
            "/".join(k.key for k in path)) else g, tree)


@pytest.fixture
def jax_true_zero(monkeypatch):
    """The JAX Trainer's optimizer entry points, with the pre-BatchNorm
    bias gradients set to their true 0 on the way in."""
    dense, sparse = JT.hybrid_update, JT.hybrid_update_sparse

    def hybrid_update(optimizer, lr, wd, params, grads, opt_state, **kw):
        return dense(optimizer, lr, wd, params, _true_zero_jax(grads),
                     opt_state, **kw)

    def hybrid_update_sparse(optimizer, lr, wd, params, g_rest, *a, **kw):
        return sparse(optimizer, lr, wd, params, _true_zero_jax(g_rest), *a,
                      **kw)

    monkeypatch.setattr(JT, "hybrid_update", hybrid_update)
    monkeypatch.setattr(JT, "hybrid_update_sparse", hybrid_update_sparse)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(model, data, **cfg_kw):
    """(JAX trainer, params, state, opt_state, port trainer) from the same
    initial weights; the table padded only on the sparse path, as
    build_model does on both sides."""
    jcls, tcls, kw = MODELS[model]
    cfg_kw = {**dict(model=model, embed_dim=E, dropout=0.0, lr=1e-3, bs=BS,
                     table_dtype="float32", table_moments_dtype="float32"),
              **cfg_kw}
    jcfg, cfg = JConfig(**cfg_kw), Config(**cfg_kw)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    tspec = data.spec
    if cfg.sparse_table_grad:
        jspec, tspec = jspec.with_flat_table(E), tspec.with_flat_table(E)
    jspec = dataclasses.replace(jspec, table_dtype=cfg.table_dtype)
    tspec = dataclasses.replace(tspec, table_dtype=cfg.table_dtype)
    d2g = D2G if model == "mmoe" else None
    jt = JT.Trainer(jcls(spec=jspec, embed_dim=E, dropout=0.0, **kw), jcfg,
                    N_DOMAIN, d2g)
    sample = JGlobalBatcher(data.train_x, data.train_y, BS,
                            data.spec.domain_idx, d2g).sample_batch()
    params, state, opt_state = jt.init(jax.random.PRNGKey(0), sample)
    tm = tcls(tspec, E, dropout=0.0, device="cpu", **kw)
    tm.load_state_dict(convert_variables(
        _np_tree(params), _np_tree(state["batch_stats"]), E))
    tr = Trainer(tm, cfg, N_DOMAIN, d2g)
    tr.optimizer = DenseAdamTrueZero(lr=cfg.lr, wd=cfg.wd)
    tr.init()
    tr.opt_state = convert_opt_state(_np_tree(opt_state), E)
    return jt, params, state, opt_state, tr


def _assert_state_close(tr, params, state, opt_state, atol=1e-5):
    sd = tr.model.state_dict()
    want = convert_variables(_np_tree(params),
                             _np_tree(state["batch_stats"]), E)
    assert set(want) == set(sd)
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].float().numpy(), v.float().numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    got = convert_opt_state(_np_tree(opt_state), E)
    assert tr.opt_state["t"] == got["t"]
    assert tr.opt_state["inner"]["count"] == got["inner"]["count"]
    for k in ("m", "v"):
        np.testing.assert_allclose(tr.opt_state[k].float().numpy(),
                                   got[k].float().numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    for k in ("mu", "nu"):
        for name, v in got["inner"][k].items():
            np.testing.assert_allclose(tr.opt_state["inner"][k][name].numpy(),
                                       v.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{k} {name}")


CASES = [("deepfm", "dense_reference", 0.0), ("deepfm", "dense_reference", 0.05),
         ("deepfm", "dense_pallas", 0.0), ("deepfm", "dense_pallas", 0.05),
         ("deepfm", "sparse", 0.0), ("deepfm", "sparse", 0.05),
         ("dcn", "dense_reference", 0.0),
         ("mmoe", "dense_reference", 0.05), ("mmoe", "sparse", 0.0)]


@pytest.mark.parametrize("model,table_path,clip_norm", CASES,
                         ids=[f"{m}-{p}-clip{c}" for m, p, c in CASES])
def test_three_trainer_steps_match_jax(model, table_path, clip_norm,
                                       monkeypatch, jax_true_zero):
    if table_path == "dense_pallas":
        # read when the JAX step is traced: set before the step is built
        monkeypatch.setenv("AREAD_TPU_PALLAS_ADAM", "1")
    else:
        monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    jt, params, state, opt_state, tr = _pair(
        model, data, sparse_table_grad=table_path == "sparse",
        grad_clip_norm=clip_norm)
    n_rows = data.spec.n_rows
    assert tr.model.embedding.table.shape[0] == (
        -(-n_rows // 16) * 16 if table_path == "sparse" else n_rows)
    jstep = jax.jit(jt._build_step_core(), static_argnums=(5,))
    batcher = GlobalBatcher(data.train_x, data.train_y, BS,
                            data.spec.domain_idx, jt.domain2group, seed=3)
    for i, batch in zip(range(3), batcher):
        params, state, opt_state, jloss = jstep(
            params, state, opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(i), False)
        tloss = tr.step({k: np.array(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                                   atol=1e-5, err_msg=f"loss, step {i}")
    assert tr.opt_state["t"] == 3
    _assert_state_close(tr, params, state, opt_state)


def test_dense_step_bf16_table_gap_to_jax(jax_true_zero, monkeypatch):
    """With a bf16 table the dense table gradient is bf16 on both sides
    (the cotangent of the gather). JAX's scatter-add rounds to bf16 after
    every duplicate it adds; the port casts the row gradients to bf16,
    sums duplicates in f32 in sorted order and rounds once. The gradient
    therefore differs by the accumulation's bf16 round-off: at most one
    bf16 ulp of the largest entry (2^-7 * gmax). After one Adam step that
    is at most 0.1 of it in m and 0.01 * 2 * gmax times it in v (v takes
    0.01 * g^2); the table, written with the
    same stochastic rounding, within one bf16 ulp and bitwise on >= 99 %
    of its elements; the loss, taken before the update, at atol 1e-5."""
    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    jt, params, state, opt_state, tr = _pair(
        "deepfm", data, sparse_table_grad=False, table_dtype="bfloat16")
    assert tr.model.embedding.table.dtype == torch.bfloat16
    batch = GlobalBatcher(data.train_x, data.train_y, BS,
                          data.spec.domain_idx, seed=3).sample_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def data_loss(p):
        out, _ = jt.model.apply(
            {"params": p, **state}, jb["x"], train=True, mask=jb["valid"],
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JT.masked_mean(JT.bce_with_logits(out["logit"], jb["y"]),
                              jb["valid"])

    jg = jax.grad(data_loss)(params)["embedding"]["table"]
    assert jg.dtype == jnp.bfloat16
    gmax = float(jnp.max(jnp.abs(jg.astype(jnp.float32))))
    saved = {k: v.clone() for k, v in tr.model.state_dict().items()}
    out = tr.model(torch.tensor(batch["x"]), train=True,
                   mask=torch.tensor(batch["valid"]), tap=True)
    row_grads, = torch.autograd.grad(T.masked_mean(T.bce_with_logits(
        out["logit"], torch.tensor(batch["y"])), torch.tensor(batch["valid"])),
        [out["rows"]])
    tg = T.dense_table_grad(
        tr.model.embedding.table_ids(torch.tensor(batch["x"])), row_grads,
        data.spec.n_rows, torch.bfloat16)
    tr.model.load_state_dict(saved)
    assert tg.dtype == torch.bfloat16
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)), rtol=0,
                               atol=2.0**-7 * gmax)

    jstep = jax.jit(jt._build_step_core(), static_argnums=(5,))
    p2, _, o2, jloss = jstep(params, state, opt_state, jb,
                             jax.random.PRNGKey(0), False)
    tloss = tr.step({k: np.array(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-5)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    np.testing.assert_allclose(tr.opt_state["m"].numpy(), f32(o2["m"]),
                               rtol=0, atol=0.1 * 2.0**-7 * gmax)
    np.testing.assert_allclose(tr.opt_state["v"].numpy(), f32(o2["v"]),
                               rtol=0, atol=0.01 * 2.0**-6 * gmax**2)
    a = f32(p2["embedding"]["table"])
    b = tr.model.embedding.table.float().numpy()
    diff = a != b
    assert diff.mean() <= 1e-2, diff.mean()
    assert (np.abs(a - b)[diff] <= (np.abs(a) * 2.0**-7 + 1e-30)[diff]).all()


def test_global_batcher_streams_bit_equal():
    data = make_synthetic_data(n_rows=300, n_domain=3, vocab=40, seed=5)
    d2g = np.array([0, 1, 1])
    a = GlobalBatcher(data.train_x, data.train_y, 32, 2, d2g, seed=9)
    b = JGlobalBatcher(data.train_x, data.train_y, 32, 2, d2g, seed=9)
    assert len(a) == len(b) == 8

    def same_batches(x, y):
        n = 0
        for ba, bb in zip(x, y, strict=True):
            assert set(ba) == set(bb) == {"x", "y", "valid", "domain", "group"}
            for k in bb:
                assert ba[k].dtype == bb[k].dtype, k
                np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)
            n += 1
        return n

    for _ in range(2):  # two epochs: the shuffle is keyed by the epoch
        assert same_batches(a, b) == 8
    same_batches([a.sample_batch()], [b.sample_batch()])
    np.testing.assert_array_equal(a.epoch_perm(), b.epoch_perm())  # epoch 2
    a.set_epoch(1)
    b.set_epoch(1)
    first = a.epoch_indices()
    np.testing.assert_array_equal(first, b.epoch_indices())
    a.set_epoch(1)
    np.testing.assert_array_equal(a.epoch_indices(), first)  # replayed
    assert not np.array_equal(a.epoch_indices(), first)  # epoch 2 differs
    plain = GlobalBatcher(data.valid_x, data.valid_y, 32, 2, shuffle=False)
    batch = next(iter(plain))
    assert "group" not in batch
    np.testing.assert_array_equal(batch["x"][:30], data.valid_x[:30])
    assert batch["valid"].sum() == 30 and batch["x"].shape[0] == 32


def test_fit_matches_jax(jax_true_zero, monkeypatch):
    """Two epochs of fit (7 steps each, a ragged last batch; the dense
    path, f32) from the same initial weights: per-epoch train loss and
    valid loss at atol 1e-4 (14 steps of f32 round-off), AUCs at atol 1e-3
    (a swap of two near-tied predictions among 102 valid rows moves an AUC
    by ~4e-4), the early-stop bookkeeping equal."""
    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    data = make_synthetic_data(n_rows=1024, n_domain=N_DOMAIN, vocab=60,
                               seed=0)
    jt, params, state, _, tr = _pair("deepfm", data, sparse_table_grad=False,
                                     bs=128, seed=7)
    # JAX's fit draws its own weights: give it the pair's instead
    monkeypatch.setattr(jt, "init", lambda rng, sample: (
        params, state, JT.hybrid_init(
            jt.optimizer, params,
            moments_dtype=jt.config.table_moments_dtype)))
    jdata = JSplitData(**{f.name: getattr(data, f.name)
                          for f in dataclasses.fields(data) if f.name != "spec"},
                       spec=jt.model.spec)
    jres = jt.fit(jdata, epochs=2, verbose=False)

    # fit() makes its own optimizer state; keep the true-zero optimizer
    tres = tr.fit(data, epochs=2, verbose=False)
    assert len(tres["history"]) == len(jres["history"]) == 2
    for th, jh in zip(tres["history"], jres["history"]):
        np.testing.assert_allclose(th["train_loss"], jh["train_loss"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(th["total_loss"], jh["total_loss"],
                                   rtol=0, atol=1e-4)
        for k in ("total_auc", "mean_auc"):
            np.testing.assert_allclose(th[k], jh[k], rtol=0, atol=1e-3)
    for k in ("total_auc", "mean_auc"):
        np.testing.assert_allclose(tres["test"][k], jres["test"][k], rtol=0,
                                   atol=1e-3)
    assert tr.trial_counter == jt.trial_counter
    assert tr._improved == jt._improved
    assert tr.best_checkpoint[-1] == jt.best_checkpoint[-1]
    for k in ("best_auc", "best_mean_auc", "best_loss", "best_mean_loss"):
        np.testing.assert_allclose(getattr(tr, k), getattr(jt, k), rtol=0,
                                   atol=1e-3, err_msg=k)
    # the model is left holding the best weights
    best = tr.best_checkpoint[0]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, best[k]), k
    assert tr._device_data is None


def test_is_continuable_bookkeeping():
    data = make_synthetic_data(n_rows=256, n_domain=N_DOMAIN, vocab=40)
    cfg = Config(model="deepfm", embed_dim=E, early_stop=2,
                 sparse_table_grad=False)
    tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                 N_DOMAIN)
    res = lambda auc: {"total_auc": auc, "total_loss": 0.5, "mean_auc": auc,
                       "mean_loss": 0.6}
    assert tr.is_continuable(res(0.6), 0) and tr._improved
    assert tr.best_checkpoint[1] == 0 and tr.best_mean_auc == 0.6
    assert tr.is_continuable(res(0.55), 1) and not tr._improved
    assert tr.trial_counter == 1
    assert not tr.is_continuable(res(0.58), 2)  # patience used up
    assert tr.best_checkpoint[1] == 0
    # a NaN mean_auc falls back to total_auc
    nan = {"total_auc": 0.7, "total_loss": 0.4, "mean_auc": float("nan")}
    assert tr.is_continuable(nan, 3) and tr.best_auc == 0.7


@pytest.mark.parametrize("model", ["deepfm", "mmoe"])
def test_device_resident_epoch_equals_host_epoch(model):
    data = make_synthetic_data(n_rows=700, n_domain=N_DOMAIN, vocab=60, seed=1)
    losses, tables = [], []
    for device_data in ("0", "1"):
        cfg = Config(model=model, embed_dim=E, bs=128, dropout=0.0, seed=3,
                     sparse_table_grad=False, table_dtype="float32",
                     device_data=device_data, dataset_name="none")
        tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                     N_DOMAIN, D2G)
        assert tr.device_data_enabled(data.train_x) == (device_data == "1")
        res = tr.fit(data, epochs=1, verbose=False)
        losses.append(res["history"][0]["train_loss"])
        tables.append(tr.model.embedding.table.clone())
    assert losses[0] == losses[1]
    assert torch.equal(tables[0], tables[1])


def test_unported_options_raise(tmp_path):
    """The options refused until they were ported now run (what each does
    is checked against the JAX package in test_torch_port_options.py and
    test_torch_port_parallel.py): a bf16 step, the regroup's refusal of a
    single-tower model (as the JAX package's), the metric files, an epoch
    under a generous watchdog, and embed_lookup='a2a' — an epoch on a
    1 x 1 mesh, which a process without a process group takes, while
    without a mesh the option raises by name, as in the JAX package; a
    larger mesh in one process raises by name."""
    from aread_tpu_torch.parallel.mesh import make_mesh

    data = make_synthetic_data(n_rows=256, n_domain=N_DOMAIN, vocab=40)
    cfg = Config(model="deepfm", embed_dim=E, sparse_table_grad=False,
                 bs=64)
    model = build_model(cfg, data.spec, N_DOMAIN, device="cpu")
    for name, value in (("compute_dtype", "bfloat16"),
                        ("dynamic_regroup", "towerfirst"),
                        ("log_dir", str(tmp_path / "logs")),
                        ("epoch_timeout_s", 5.0),
                        ("embed_lookup", "a2a")):
        ocfg = dataclasses.replace(cfg, **{name: value})
        if name == "embed_lookup":
            with pytest.raises(ValueError, match="a2a.*mesh"):
                Trainer(model, ocfg, N_DOMAIN)
            tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"),
                         ocfg, N_DOMAIN, mesh=make_mesh(1, 1, device="cpu"))
            res = tr.fit(data, epochs=1, verbose=False)
            assert tr.config.a2a_capacity > 0  # resolved before the steps
            assert np.isfinite(res["history"][0]["train_loss"])
            continue
        tr = Trainer(model, ocfg, N_DOMAIN)
        if name == "compute_dtype":
            tr.init()
            batch = GlobalBatcher(data.train_x, data.train_y, 64,
                                  2).sample_batch()
            assert np.isfinite(float(tr.step(batch)))
        elif name == "dynamic_regroup":
            with pytest.raises(ValueError, match="multi-tower"):
                tr.apply_dynamic_regroup(data.valid_x, data.valid_y)
        else:
            res = tr.fit(data, epochs=1, verbose=False)
            assert len(res["history"]) == 1
    (run,) = list((tmp_path / "logs").iterdir())
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2
    with pytest.raises(ValueError, match="mesh of data=2 x model=1 needs 2"):
        Trainer(model, cfg, N_DOMAIN, mesh=make_mesh(2, 1, device="cpu"))
    tr = Trainer(model, cfg, N_DOMAIN)
    # streaming_eval is ported: the option builds a trainer
    Trainer(model, dataclasses.replace(cfg, streaming_eval=True), N_DOMAIN)
    with pytest.raises(RuntimeError, match="init"):
        tr.step(GlobalBatcher(data.train_x, data.train_y, 32, 2).sample_batch())
    with pytest.raises(ValueError, match="Unknown model"):
        build_model(dataclasses.replace(cfg, model="nomodel"), data.spec,
                    N_DOMAIN, device="cpu")
    with pytest.raises(ValueError, match="device_data"):
        Trainer(model, dataclasses.replace(cfg, device_data="yes"),
                N_DOMAIN).device_data_enabled(data.train_x)


def test_dropout_stream_is_seeded():
    """With dropout on (MMoE: the MLPs and the attention weights), a run is
    a function of config.seed: the same seed repeats it bitwise, another
    seed does not."""
    data = make_synthetic_data(n_rows=400, n_domain=N_DOMAIN, vocab=40, seed=2)
    runs = []
    for seed in (5, 5, 6):
        cfg = Config(model="mmoe", embed_dim=E, bs=64, dropout=0.2, seed=5,
                     sparse_table_grad=False, table_dtype="float32",
                     mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8, 4),
                     atten_embed_dim=8, att_layer_num=1, dataset_name="none")
        tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                     N_DOMAIN, D2G)
        tr.generator.manual_seed(seed)
        res = tr.fit(data, epochs=1, verbose=False)
        assert np.isfinite(res["history"][0]["train_loss"])
        runs.append(tr.model.linear.kernel.detach().clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
