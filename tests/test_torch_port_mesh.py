"""The port's trainers on a mesh — gloo ranks on the CPU, started by
``tests/test_torch_port_parallel.py``'s ``spawn`` on this file — against
the JAX package's single-device trainers from the same weights (carried
by ``aread_tpu_torch/convert.py``) on the same seed-made data. The JAX
package's own tests hold its mesh equal to its single device; this file
holds the port's mesh equal to that single device:

* three DeepFM ``Trainer.step``s (its MLP has BatchNorm) on a (4, 1) mesh
  with the sparse table gradient and on a (2, 2) mesh with the dense one
  and with the sparse one; the third batch has a ragged tail, so that some
  ranks hold no valid row: losses, weights, BatchNorm statistics and
  every Adam moment at atol 1e-5 (f32 sums in another order); then the
  (2, 2) sparse steps at dropout 0.2 against the port's own single-device
  steps (dropout draws from a torch generator, not JAX's), atol 1e-5;
* one epoch of ``Trainer.fit`` on (2, 2) under 'gspmd' and under 'a2a'
  with the capacity measured before the first step: train loss, valid
  loss and the AUCs at atol 1e-5; its checkpoint (rank 0 writes it,
  gathered) resumed by a fresh mesh trainer to the same test metrics,
  bitwise, and served by ``load_predictor`` on one process to the mesh
  trainer's predictions at atol 1e-6;
* one ``MamdrTrainer.fit`` epoch on (2, 2) at dropout 0.2 against the
  port's one process (held against the JAX meta-trainer elsewhere): the
  meta weights and the metrics at atol 1e-4, that comparison's bound;
* ``AREADTrainer._mask_evolution`` on (2, 2) against the JAX unsharded
  evolution: every candidate's pruned mask and the chosen masks equal, the
  probe losses at atol 1e-4 (two adapt steps at lr 1e-2 from f32
  round-off, the bound of the single-device comparison in
  test_torch_port_hemp.py), the same masks on every rank;
* the CLI under ``torch.distributed.run`` (2 ranks, ``--mesh_model 2``)
  against the single-process CLI: test metrics at atol 1e-5; a single
  process asked for a 2 x 2 mesh raises by name.

The linear biases that feed a BatchNorm take their true gradient, 0, on
both sides (as in test_torch_port_trainer.py)."""

import dataclasses
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import DomainBatcher, GlobalBatcher, pad_batch
from aread_tpu_torch.parallel.health import barrier
from aread_tpu_torch.parallel.mesh import make_mesh
from aread_tpu_torch.train.checkpoint import full_state, local_state
from aread_tpu_torch.train.trainer import DenseAdam, Trainer
from tests.test_torch_port_parallel import ROOT, rank_main, spawn

N_DOMAIN = 4


def true_zero_adam(pattern: str, lr: float, wd: float) -> DenseAdam:
    """DenseAdam giving the tensors whose path matches ``pattern`` their
    true gradient, 0."""
    rx = re.compile(pattern)

    class TrueZero(DenseAdam):
        def update_(self, params, grads, state, scalars=None):
            super().update_(params, {
                n: torch.zeros_like(g) if rx.match(n) else g
                for n, g in grads.items()}, state, scalars)

    return TrueZero(lr=lr, wd=wd)


# --------------------------------------------------------------- the ranks
def _deepfm_trainer(inp, run, mesh):
    from aread_tpu_torch.models.deepfm import DeepFM

    cfg = Config(**run["cfg"])
    model = DeepFM(inp["spec"], cfg.embed_dim, dropout=cfg.dropout,
                   device="cpu", **inp["model_kw"])
    model.load_state_dict(inp["state_dict"])
    tr = Trainer(model, cfg, N_DOMAIN, mesh=mesh)
    tr.optimizer = true_zero_adam(inp["pre_bn_bias"], cfg.lr, cfg.wd)
    return tr


def _case_steps(workdir: Path):
    inp = torch.load(workdir / "steps_in.pt", weights_only=False)
    out = {}
    for name, run in inp["runs"].items():
        mesh = make_mesh(*run["mesh"], device="cpu")
        tr = _deepfm_trainer(inp, run, mesh)
        tr.init()
        from aread_tpu_torch.train.checkpoint import restore_tree_
        restore_tree_(tr.opt_state,
                      local_state(inp["state_dict"], inp["opt_state"], mesh)[1])
        losses = [float(tr.step(b)) for b in inp["batches"]]
        out[name] = {"losses": losses,
                     "state": full_state(tr.model.state_dict(), tr.opt_state,
                                         mesh)}
        barrier(name, 60.0)
    return out


def _case_fit(workdir: Path):
    from aread_tpu_torch.serve.predictor import load_predictor  # noqa: F401

    inp = torch.load(workdir / "fit_in.pt", weights_only=False)
    mesh = make_mesh(2, 2, device="cpu")
    out = {}
    for lookup in ("gspmd", "a2a"):
        run = {"cfg": {**inp["cfg"], "embed_lookup": lookup}}
        ckpt = workdir / f"ckpt_{lookup}"
        tr = _deepfm_trainer(inp, run, mesh)
        res = tr.fit(inp["data"], epochs=1, verbose=False, ckpt_dir=str(ckpt))
        barrier(f"fit_{lookup}", 120.0)
        # a fresh trainer takes up the checkpoint: no epoch is left, and
        # the test pass runs on the restored rows
        again = _deepfm_trainer(inp, run, mesh).fit(
            inp["data"], epochs=1, verbose=False, ckpt_dir=str(ckpt))
        probs = []
        data = inp["data"]
        for b in GlobalBatcher(data.test_x, data.test_y, 256,
                               data.spec.domain_idx, shuffle=False):
            n = int(b["valid"].sum())
            probs.append(tr.gather_rows(tr.eval_prob(tr.place(b)))[:n])
        tr.save(str(workdir / f"serve_{lookup}"), epoch=1,
                spec=tr.model.spec, run_config=tr.config, n_domain=N_DOMAIN)
        out[lookup] = {"history": res["history"], "test": res["test"],
                       "resumed_test": again["test"],
                       "resumed_epochs": len(again["history"]),
                       "capacity": tr.config.a2a_capacity,
                       "probs": torch.cat(probs).numpy()}
    return out


def _spy(ms):
    orig = ms.update_all_mask

    def update_all_mask():
        ms.seen_losses = [[list(z) for z in d] for d in ms.eval_loss]
        ms.seen_candidates = [[[np.array(l) for l in m] for m in d]
                              for d in ms.candidate_domain_mask]
        orig()

    ms.update_all_mask = update_all_mask


def _case_evolution(workdir: Path):
    from aread_tpu_torch.models.aread import AREAD
    from aread_tpu_torch.train.hemp import AREADTrainer

    inp = torch.load(workdir / "evolution_in.pt", weights_only=False)
    mesh = make_mesh(2, 2, device="cpu")
    cfg = Config(**inp["cfg"])
    tm = AREAD(inp["spec"], device="cpu", **inp["model_kw"])
    tm.load_state_dict(inp["state_dict"])
    tr = AREADTrainer(tm, cfg, N_DOMAIN_HEMP, mesh=mesh)
    tr.optimizer = true_zero_adam(inp["pre_bn_bias"], cfg.lr, cfg.wd)
    tr.fast_optimizer = true_zero_adam(inp["pre_bn_bias"], cfg.update_lr,
                                       cfg.wd)
    tr.init()
    tr.mask_state = inp["mask_state"]
    for k, v in inp["schedule"].items():
        setattr(tr, k, v)
    _spy(tr.mask_state)
    d = inp["data"]
    didx = d.spec.domain_idx
    tr._mask_evolution(
        DomainBatcher(d.train_x, d.train_y, cfg.bs, didx, N_DOMAIN_HEMP,
                      seed=1),
        DomainBatcher(d.aug_train_x, d.aug_train_y, cfg.bs, didx,
                      N_DOMAIN_HEMP, seed=2), verbose=False)
    ms = tr.mask_state
    return {"candidates": ms.seen_candidates, "losses": ms.seen_losses,
            "masks": ms.domain_mask}


def _case_mamdr(workdir: Path):
    from aread_tpu_torch.models.mamdr import MAMDR
    from aread_tpu_torch.parallel.mesh import gather_rows
    from aread_tpu_torch.train.mamdr import MamdrTrainer

    inp = torch.load(workdir / "mamdr_in.pt", weights_only=False)
    mesh = make_mesh(2, 2, device="cpu")
    cfg = Config(**inp["cfg"])
    tm = MAMDR(inp["spec"], cfg.embed_dim, mlp_dims=(16, 8),
               dropout=cfg.dropout, device="cpu")
    tm.load_state_dict(inp["state_dict"])
    tr = MamdrTrainer(tm, cfg, 3, mesh=mesh)
    tr.optimizer = true_zero_adam(MAMDR_PRE_BN_BIAS, cfg.lr, cfg.wd)
    res = tr.fit(inp["data"], epochs=1, verbose=False)
    meta = dict(res["meta_weights"])
    meta["embedding/table"] = gather_rows(meta["embedding/table"], mesh)
    return {"history": res["history"], "test": res["test"], "meta": meta}


N_DOMAIN_HEMP = 3
MAMDR_PRE_BN_BIAS = r"^mlp/linear_\d+/bias$"
CASES = {"steps": _case_steps, "fit": _case_fit,
         "evolution": _case_evolution, "mamdr": _case_mamdr}

if __name__ == "__main__":
    rank_main(CASES)
    sys.exit(0)


# ----------------------------------------------------- the JAX references
from tests import test_torch_port_hemp as H  # noqa: E402
from tests import test_torch_port_trainer as TT  # noqa: E402
from tests.test_torch_port_hemp import world  # noqa: E402,F401  (fixture)
from tests.test_torch_port_trainer import jax_true_zero  # noqa: E402,F401


def _deepfm_pair(data, **cfg_kw):
    jt, params, state, opt_state, tr = TT._pair("deepfm", data, **cfg_kw)
    return jt, params, state, opt_state, tr


def _inputs(tr, **extra):
    return {"spec": tr.model.spec,
            "model_kw": TT.MODELS["deepfm"][2],
            "state_dict": {k: v.clone()
                           for k, v in tr.model.state_dict().items()},
            "pre_bn_bias": TT.PRE_BN_BIAS.pattern, **extra}


def _data():
    from aread_tpu_torch.data.loader import make_synthetic_data

    data = make_synthetic_data(n_rows=512, n_domain=N_DOMAIN, vocab=60, seed=0)
    # the table's rows divide over 2 model ranks (and, for the a2a lookup
    # of the lane-packed table, its flat rows of 16 too)
    return dataclasses.replace(data, spec=data.spec.pad_vocab(32))


def test_mesh_steps_match_jax_single_device(tmp_path, jax_true_zero,
                                            monkeypatch):
    import copy

    import jax
    import jax.numpy as jnp

    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    data = _data()
    bs, didx = TT.BS, data.spec.domain_idx
    batches = [b for _, b in zip(range(2), GlobalBatcher(
        data.train_x, data.train_y, bs, didx, seed=3))]
    # a ragged tail: 20 valid rows of 64, so that some ranks hold none
    tail = pad_batch(data.train_x[100:120], data.train_y[100:120], bs)
    tail["domain"] = tail["x"][:, didx].astype(np.int32)
    batches.append(tail)
    runs, refs = {}, {}
    for name, mesh, sparse in (("dp4_sparse", (4, 1), True),
                               ("mesh22_dense", (2, 2), False),
                               ("mesh22_sparse", (2, 2), True)):
        jt, params, state, opt_state, tr = _deepfm_pair(
            data, sparse_table_grad=sparse)
        cfg = dataclasses.asdict(tr.config)
        runs[name] = _inputs(tr, opt_state=copy.deepcopy(tr.opt_state),
                             batches=batches,
                             runs={name: {"mesh": mesh, "cfg": cfg}})
        jstep = jax.jit(jt._build_step_core(), static_argnums=(5,))
        losses = []
        for i, b in enumerate(batches):
            params, state, opt_state, jloss = jstep(
                params, state, opt_state,
                {k: jnp.asarray(v) for k, v in b.items()},
                jax.random.PRNGKey(i), False)
            losses.append(float(jloss))
        refs[name] = (losses, params, state, opt_state)
    # dropout 0.2 against the port's own single device, same weights
    base = runs["mesh22_sparse"]
    cfg_do = {**base["runs"]["mesh22_sparse"]["cfg"], "dropout": 0.2}
    runs["mesh22_sparse_dropout"] = {
        **base, "runs": {"mesh22_sparse_dropout": {"mesh": (2, 2),
                                                   "cfg": cfg_do}}}
    one = Trainer(TT.DeepFM(base["spec"], TT.E, dropout=0.2, device="cpu",
                            **base["model_kw"]), Config(**cfg_do), N_DOMAIN)
    one.model.load_state_dict(base["state_dict"])
    one.optimizer = true_zero_adam(TT.PRE_BN_BIAS.pattern, one.config.lr,
                                   one.config.wd)
    one.init()
    from aread_tpu_torch.train.checkpoint import restore_tree_
    restore_tree_(one.opt_state, copy.deepcopy(base["opt_state"]))
    do_losses = [float(one.step(b)) for b in batches]

    for name, inp in runs.items():
        d = tmp_path / name
        d.mkdir()
        torch.save(inp, d / "steps_in.pt")
        res = [r[name] for r in spawn(__file__, "steps", 4, d)]
        for r in res[1:]:
            assert r["losses"] == res[0]["losses"], name  # bitwise alike
        sd, opt = res[0]["state"]
        if name == "mesh22_sparse_dropout":
            np.testing.assert_allclose(res[0]["losses"], do_losses, rtol=0,
                                       atol=1e-5)
            for k, v in one.model.state_dict().items():
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                           atol=1e-5, err_msg=k)
            continue
        losses, params, state, opt_state = refs[name]
        np.testing.assert_allclose(res[0]["losses"], losses, rtol=0,
                                   atol=1e-5, err_msg=name)
        view = types.SimpleNamespace(model=types.SimpleNamespace(
            state_dict=lambda sd=sd: sd), opt_state=opt)
        TT._assert_state_close(view, params, state, opt_state, atol=1e-5)


def test_mesh_fit_matches_jax_and_its_checkpoint_serves(tmp_path,
                                                        jax_true_zero,
                                                        monkeypatch):
    from aread_tpu.data.loader import SplitData as JSplitData
    import aread_tpu.train.trainer as JT
    from aread_tpu_torch.serve.predictor import load_predictor

    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    # build_model's DeepFM, so that load_predictor rebuilds it
    monkeypatch.setitem(TT.MODELS, "deepfm",
                        (TT.JDeepFM, TT.DeepFM, dict(mlp_dims=(256, 128))))
    data = _data()
    jt, params, state, _, tr = _deepfm_pair(data, sparse_table_grad=True,
                                            bs=64, seed=7)
    monkeypatch.setattr(jt, "init", lambda rng, sample: (
        params, state, JT.hybrid_init(
            jt.optimizer, params,
            moments_dtype=jt.config.table_moments_dtype)))
    jdata = JSplitData(**{f.name: getattr(data, f.name)
                          for f in dataclasses.fields(data) if f.name != "spec"},
                       spec=jt.model.spec)
    jres = jt.fit(jdata, epochs=1, verbose=False)
    torch.save(_inputs(tr, cfg=dataclasses.asdict(tr.config), data=data),
               tmp_path / "fit_in.pt")
    ranks = spawn(__file__, "fit", 4, tmp_path)
    for lookup in ("gspmd", "a2a"):
        res = [r[lookup] for r in ranks]
        for r in res[1:]:
            np.testing.assert_equal(r["test"], res[0]["test"])
        got = res[0]
        (h,), (jh,) = got["history"], jres["history"]
        for k in ("train_loss", "total_loss", "total_auc", "mean_auc"):
            np.testing.assert_allclose(h[k], jh[k], rtol=0, atol=1e-5,
                                       err_msg=f"{lookup} {k}")
        for k in ("total_auc", "mean_auc", "total_loss"):
            np.testing.assert_allclose(got["test"][k], jres["test"][k],
                                       rtol=0, atol=1e-5, err_msg=k)
        assert got["resumed_epochs"] == 0
        np.testing.assert_equal(got["resumed_test"], got["test"])
        if lookup == "a2a":
            assert got["capacity"] > 0 and got["capacity"] % 8 == 0
        pred = load_predictor(str(tmp_path / f"serve_{lookup}"), device="cpu")
        assert pred.model.embedding.table.shape[0] == tr.model.spec.n_rows
        np.testing.assert_allclose(pred.predict(data.test_x), got["probs"],
                                   rtol=0, atol=1e-6)


def test_mesh_evolution_matches_jax_masks_exact(world, tmp_path):
    import jax

    jt, params, state, _, tr = H._fresh(world)
    H._share_hemp_state(jt, tr, seed=5)
    H._spy(jt.mask_state)
    assert world.spec.n_rows % 2 == 0
    torch.save({
        "spec": world.spec, "model_kw": H.MODEL_KW, "cfg": H.CFG_KW,
        "state_dict": tr.model.state_dict(), "mask_state": tr.mask_state,
        "schedule": {k: getattr(tr, k) for k in (
            "random_modify_sigma", "init_active_percent",
            "candidate_mask_num", "regroup_times")},
        "data": world.data, "pre_bn_bias": H.PRE_BN_BIAS.pattern},
        tmp_path / "evolution_in.pt")
    ranks = spawn(__file__, "evolution", 4, tmp_path)
    jtrain, jaug = H._batchers(world, H.JDomainBatcher)
    jt._mask_evolution(params, state, jtrain, jaug, jax.random.PRNGKey(3),
                       verbose=False)
    jms = jt.mask_state
    for got in ranks:
        for d in range(N_DOMAIN_HEMP):
            for a, b in zip(jms.seen_candidates[d], got["candidates"][d]):
                H._assert_masks_equal(a, b)
            H._assert_masks_equal(jms.domain_mask[d], got["masks"][d])
            np.testing.assert_allclose(np.array(got["losses"][d]),
                                       np.array(jms.seen_losses[d]), rtol=0,
                                       atol=1e-4)
        assert got["losses"] == ranks[0]["losses"]  # every rank alike


def test_mesh_mamdr_epoch_equals_one_process(tmp_path):
    """One ``MamdrTrainer.fit`` epoch on (2, 2) at dropout 0.2 against the
    port's one-process epoch from the same weights (which
    test_torch_port_mamdr.py holds against the JAX meta-trainer): Reptile
    runs on each rank's rows; the meta weights (the table gathered) and
    the metrics at atol 1e-4, the bound of that test (63 Adam steps of f32
    round-off: in a single-domain batch the domain field's embedding is
    constant, so the rows of the first kernel it feeds have a true
    gradient of 0 under BatchNorm, and Adam normalizes the round-off
    there), the MLP's pre-BatchNorm biases at their true zero gradient on
    both sides."""
    from aread_tpu_torch.data.loader import make_synthetic_data
    from aread_tpu_torch.models.mamdr import MAMDR
    from aread_tpu_torch.train.mamdr import MamdrTrainer

    data = make_synthetic_data(n_rows=600, n_domain=3, vocab=50, seed=6)
    cfg = Config(model="mamdr", embed_dim=8, bs=64, dropout=0.2, seed=11,
                 dataset_name="none", table_dtype="float32",
                 table_moments_dtype="float32", mamdr_aux_sample_num=2)
    spec = dataclasses.replace(data.spec.with_flat_table(8),
                               table_dtype="float32")
    tm = MAMDR(spec, 8, mlp_dims=(16, 8), dropout=0.2, device="cpu")
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    tr = MamdrTrainer(tm, cfg, 3)
    tr.optimizer = true_zero_adam(MAMDR_PRE_BN_BIAS, cfg.lr, cfg.wd)
    one = tr.fit(data, epochs=1, verbose=False)
    torch.save({"spec": spec, "cfg": dataclasses.asdict(cfg),
                "state_dict": state, "data": data}, tmp_path / "mamdr_in.pt")
    ranks = spawn(__file__, "mamdr", 4, tmp_path)
    for got in ranks:
        for k, v in one["meta_weights"].items():
            np.testing.assert_allclose(got["meta"][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-4, err_msg=k)
        for t, w in ((got["history"][0], one["history"][0]),
                     (got["test"], one["test"])):
            for k in ("total_auc", "mean_auc", "total_loss"):
                np.testing.assert_allclose(t[k], w[k], rtol=0, atol=1e-4,
                                           err_msg=k)


# ------------------------------------------------------------------ CLI
def _cli_test_line(stdout: str):
    line = [l for l in stdout.splitlines() if l.startswith("test: ")][-1]
    return eval(line[len("test: "):], {"nan": float("nan")})


def test_cli_under_torch_distributed_run(tmp_path):
    from aread_tpu_torch.__main__ import main
    from aread_tpu_torch.data.pipeline import preprocessed_csv_path
    from tests.test_torch_port_data import make_canonical_frame

    csv = preprocessed_csv_path("aliccp", str(tmp_path / "dataset"))
    os.makedirs(os.path.dirname(csv))
    make_canonical_frame("aliccp", 500, seed=7, n_domain=N_DOMAIN).to_csv(
        csv, index=False)
    env = dict(os.environ, AREAD_TPU_CACHE="0", OMP_NUM_THREADS="1")
    # f32 table and moments: a bf16 shard rounds with its own stream
    common = ["--device", "cpu", "--data_path", str(tmp_path / "dataset"),
              "--dataset_name", "aliccp", "--model", "deepfm", "--bs", "64",
              "--embed_dim", "8", "--epoch", "1", "--table_dtype", "float32",
              "--table_moments_dtype", "float32"]
    runs = {}
    for name, launcher in (
            ("one", [sys.executable, "-m", "aread_tpu_torch"]),
            ("mesh", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2", "-m",
                      "aread_tpu_torch", "--mesh_model", "2"])):
        proc = subprocess.run(
            launcher + common + ["--save_path", str(tmp_path / name)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
        runs[name] = proc.stdout
    assert "mesh: data=1 model=2 backend=gloo" in runs["mesh"]
    one, mesh = _cli_test_line(runs["one"]), _cli_test_line(runs["mesh"])
    assert runs["mesh"].count("test: ") == 1  # rank 0 prints
    for k, v in one.items():
        np.testing.assert_allclose(mesh[k], v, rtol=0, atol=1e-5, err_msg=k)
    meta = json.loads((tmp_path / "mesh/aliccp/deepfm_best/meta.json"
                       ).read_text())
    assert meta["config"]["mesh_model"] == 2
    with pytest.raises(ValueError, match="data=2 x model=2 needs 4 processes"):
        main(common + ["--save_path", str(tmp_path / "x"), "--mesh_data", "2",
                       "--mesh_model", "2"])
