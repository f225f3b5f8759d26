"""Both CLIs of the port in a subprocess on the CPU (``--device cpu``), on a
seed-made canonical aliccp CSV: ``python -m aread_tpu_torch`` trains AREAD
with HEMP, writes the augmented file, the self-contained best checkpoint
(with masks) and the resumable one; second runs warm-start
(``--is_increment``) and resume (``--elastic``); ``python -m
aread_tpu_torch.serve`` scores a CSV to the probabilities that
``load_predictor(...).predict`` gives in this process (atol 1e-6; the same
code on the same rows); every ``--flag`` of the root ``main.py`` but
``--platform`` parses; the flags of the options ported since run (the
mesh's: ``--embed_lookup a2a`` without a mesh and a mesh in one process
raise by name, as they must; ``--a2a_capacity`` without a2a is taken and
not acted on, as in ``main.py``); the zoo's models train, save and serve
through the CLI in process. The CLI under ``torch.distributed.run`` is in
test_torch_port_mesh.py."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from aread_tpu_torch.__main__ import load_config, main
from aread_tpu_torch.data.loader import (dataset_columns, load_split_data,
                                         tensorize)
from aread_tpu_torch.data.pipeline import preprocessed_csv_path
from aread_tpu_torch.serve.predictor import load_predictor
from aread_tpu_torch.train.checkpoint import load_checkpoint
from tests.test_torch_port_data import make_canonical_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOMAIN = 4
HEMP_FLAGS = ["--warm_up_interval", "1", "--regroup_interval", "1",
              "--candidate_mask_num", "2", "--regroup_update_step", "1",
              "--regroup_eval_step", "1"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    csv = preprocessed_csv_path("aliccp", str(root / "dataset"))
    os.makedirs(os.path.dirname(csv))
    make_canonical_frame("aliccp", 500, seed=7, n_domain=N_DOMAIN).to_csv(
        csv, index=False)
    return {"data": str(root / "dataset"), "save": str(root / "save"),
            "csv": csv, "root": root}


def run(module, *args, expect_ok=True):
    env = {k: v for k, v in os.environ.items() if k != "AREAD_TPU_CACHE"}
    env["AREAD_TPU_CACHE"] = "0"
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    if expect_ok:
        assert proc.returncode == 0, (
            f"rc={proc.returncode}\nstdout:\n{proc.stdout[-3000:]}\n"
            f"stderr:\n{proc.stderr[-3000:]}")
    return proc


def train(dirs, model, *extra, **kw):
    return run("aread_tpu_torch", "--device", "cpu", "--data_path",
               dirs["data"], "--save_path", dirs["save"], "--dataset_name",
               "aliccp", "--model", model, "--bs", "64", "--embed_dim", "8",
               "--epoch", "1", *extra, **kw)


def test_result(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("test: {")]
    assert lines, stdout[-2000:]
    return eval(lines[-1][len("test: "):],
                {"nan": float("nan"), "inf": float("inf")})


test_result.__test__ = False


@pytest.fixture(scope="module")
def trained_aread(dirs):
    return train(dirs, "aread", "--elastic", *HEMP_FLAGS).stdout


def test_train_cli_aread_writes_checkpoints_with_masks(dirs, trained_aread):
    out = trained_aread
    assert "generated augmentation:" in out
    assert f"n_domain:{N_DOMAIN}" in out and "model:aread, lr:0.001, bs:64" in out
    assert "regroup 1:" in out and "epoch 1: train_loss=" in out
    best = os.path.join(dirs["save"], "aliccp", "aread_best")
    assert f"checkpoint saved: {best}" in out
    res = test_result(out)
    assert 0.0 <= res["total_auc"] <= 1.0 and res["total_loss"] > 0
    assert "test mean_auc:" in out
    assert os.path.exists(os.path.join(
        dirs["save"], "aliccp",
        os.path.basename(dirs["csv"]).replace(".csv", "_aug0.1.csv")))
    ck = load_checkpoint(best, n_domain=N_DOMAIN)
    assert ck["epoch"] == 1 and ck["n_domain"] == N_DOMAIN
    assert ck["opt_state"] == {} and "rng_state" not in ck
    assert all(m is not None for m in ck["domain_mask"])
    assert ck["config"]["model"] == "aread" and ck["config"]["elastic"] is True
    assert len(ck["spec"]["one_hot_dims"]) == 23
    np.testing.assert_allclose(ck["best_result"]["total_auc"],
                               res["total_auc"])
    # the resumable checkpoint of --elastic: optimizer, generator, schedule
    el = load_checkpoint(os.path.join(dirs["save"], "aliccp", "aread_elastic"),
                         n_domain=N_DOMAIN)
    assert el["epoch"] == 1 and el["opt_state"]["t"] > 0
    assert el["rng_state"]["device"] == "cpu"
    assert el["hemp_schedule"]["regroup_times"] >= 1
    assert "spec" not in el


def test_train_cli_second_run_warm_starts_and_resumes(dirs, trained_aread):
    out = train(dirs, "aread", "--elastic", "--is_increment", "--epoch", "2",
                *HEMP_FLAGS).stdout
    best = os.path.join(dirs["save"], "aliccp", "aread_best")
    assert f"warm-start from {best} (epoch 1)" in out
    assert "elastic resume from" in out and "at epoch 1" in out
    assert "generated augmentation:" not in out  # the file is reused
    assert "epoch 2: train_loss=" in out and "epoch 1: train_loss=" not in out
    assert load_checkpoint(best)["epoch"] == 1  # one epoch was run this time


def test_serve_cli_scores_what_predict_gives(dirs, trained_aread):
    best = os.path.join(dirs["save"], "aliccp", "aread_best")
    frame = make_canonical_frame("aliccp", 150, seed=8, n_domain=N_DOMAIN)
    frame = frame.drop(columns=["click"])  # scoring needs no label
    inp, outp = str(dirs["root"] / "score.csv"), str(dirs["root"] / "preds.csv")
    frame.to_csv(inp, index=False)
    out = run("aread_tpu_torch.serve", "--device", "cpu", "--ckpt", best,
              "--input", inp, "--output", outp).stdout
    assert f"wrote 150 predictions to {outp}" in out
    got = pd.read_csv(outp)
    assert list(got.columns) == ["prob"] and len(got) == 150
    pred = load_predictor(best, device="cpu")
    one_hot, seq_cols, label = dataset_columns("aliccp")
    spec = pred.model.spec
    frame[label] = 0
    x, _ = tensorize(frame, one_hot, seq_cols, label, spec.seq_maxlen,
                     spec.one_hot_dims[spec.itemid_idx] - 1)
    want = pred.predict(x)
    assert len(np.unique(x[:, spec.domain_idx])) == N_DOMAIN  # mixed-domain
    np.testing.assert_allclose(got["prob"].to_numpy(), want, rtol=0,
                               atol=1e-6)
    assert ((want > 0) & (want < 1)).all()
    # without --http the two paths are required
    proc = run("aread_tpu_torch.serve", "--device", "cpu", "--ckpt", best,
               expect_ok=False)
    assert proc.returncode != 0 and "--input/--output required" in proc.stderr


def test_train_cli_generic_model_with_streaming_eval(dirs):
    out = train(dirs, "deepfm", "--streaming_eval", "--auc_bins", "2048",
                "--table_dtype", "float32").stdout
    res = test_result(out)
    assert 0.0 <= res["total_auc"] <= 1.0
    ck = load_checkpoint(os.path.join(dirs["save"], "aliccp", "deepfm_best"))
    assert ck["config"]["streaming_eval"] is True
    assert ck["config"]["auc_bins"] == 2048
    assert "domain_mask" not in ck
    pred = load_predictor(os.path.join(dirs["save"], "aliccp", "deepfm_best"),
                          device="cpu")
    # aliccp has a precomputed grouping; deepfm has one output and no use
    # for it, but the map is the training CLI's
    assert pred.domain2group is not None and not pred.is_aread


@pytest.mark.parametrize("flags", [
    ["--model", "ple"],
    ["--model", "aread", "--base_model", "ple", *HEMP_FLAGS],
], ids=["ple", "aread-ple"])
def test_train_cli_runs_the_zoo(dirs, flags, capsys):
    """A zoo model and AREAD on a PLE base through the training CLI (in
    process): trained, tested, saved, and served by load_predictor."""
    save = str(dirs["root"] / "zoo")
    main(["--device", "cpu", "--data_path", dirs["data"], "--save_path", save,
          "--dataset_name", "aliccp", "--bs", "64", "--embed_dim", "8",
          "--epoch", "1", *flags])
    res = test_result(capsys.readouterr().out)
    assert 0.0 <= res["total_auc"] <= 1.0
    ck = os.path.join(save, "aliccp", f"{flags[1]}_best")
    pred = load_predictor(ck, device="cpu")
    assert type(pred.model).__name__.lower() == flags[1]
    if flags[1] == "aread":
        assert pred.model.base_model == "ple" and pred.is_aread
        assert all(m is not None for m in pred.domain_mask)
    else:
        assert pred.model.n_tower == 3 and pred.domain2group is not None
    x = load_checkpoint(ck)  # meta.json holds the run's config
    assert x["config"]["model"] == flags[1]


@pytest.mark.parametrize("flags", [
    ["--model", "hinet"], ["--model", "adasparse"], ["--model", "adl"],
    ["--model", "adl", "--adl_eval_dlm_update"], ["--model", "mamdr"],
], ids=["hinet", "adasparse", "adl", "adl-eval-dlm-update", "mamdr"])
def test_train_cli_runs_the_zoos_second_half(dirs, flags, capsys):
    """HiNet, AdaSparse, ADL (with and without eval-time centre updates)
    and MAMDR (its Reptile meta-trainer) through the training CLI for one
    epoch: trained, tested, saved, and rebuilt by load_predictor from the
    checkpoint alone. An ADL saved with adl_eval_dlm_update is refused by
    the Predictor, as the JAX package's refuses it."""
    save = str(dirs["root"] / "zoo2")
    main(["--device", "cpu", "--data_path", dirs["data"], "--save_path", save,
          "--dataset_name", "aliccp", "--bs", "64", "--embed_dim", "8",
          "--epoch", "1", *flags])
    out = capsys.readouterr().out
    res = test_result(out)
    assert 0.0 <= res["total_auc"] <= 1.0
    if flags[1] == "mamdr":  # the meta-trainer's epoch line
        assert "epoch 1: train_loss=nan valid auc=" in out
    ck = os.path.join(save, "aliccp", f"{flags[1]}_best")
    meta = load_checkpoint(ck)
    assert meta["config"]["model"] == flags[1]
    assert meta["config"]["adl_eval_dlm_update"] == (len(flags) == 3)
    pred = load_predictor(ck, device="cpu")
    assert type(pred.model).__name__.lower() == flags[1]
    x = load_split_data(dirs["csv"], "aliccp", 5).test_x[:50]
    if len(flags) == 3:
        assert pred.model.eval_dlm_update
        with pytest.raises(ValueError, match="adl_eval_dlm_update"):
            pred.predict(x)
        return
    p = pred.predict(x)
    assert p.shape == (50,) and ((p > 0) & (p < 1)).all()


@pytest.mark.parametrize("flags,name", [
    (["--log_dir", "logs"], "log_dir"),
    (["--dynamic_regroup", "towerfirst", "--model", "mmoe"], "dynamic_regroup"),
    (["--epoch_timeout_s", "5"], "epoch_timeout_s"),
    (["--embed_lookup", "a2a"], "embed_lookup"),
    (["--hemp_fast_adapt", "overlay"], "hemp_fast_adapt"),
    (["--mesh_data", "2"], "mesh"),
    (["--a2a_capacity", "8"], "a2a_capacity"),
    (["--epoch_timeout_kill"], "epoch_timeout_kill"),
])
def test_unported_flag_is_accepted_and_raises_by_name(dirs, flags, name,
                                                      monkeypatch, capsys):
    """The flags, refused until their features were ported, train one
    epoch through the CLI (in process) and reach what they set: the
    metric files, the between-epoch regroup, the epoch watchdog (with the
    first epoch's grace), the overlay chains, and --a2a_capacity, which
    without the a2a lookup is taken and not acted on (as in main.py).
    A mesh in one process and --embed_lookup a2a without a mesh raise by
    name; under torch.distributed.run the mesh trains
    (test_torch_port_mesh.py)."""
    from aread_tpu_torch.parallel import health
    from aread_tpu_torch.train import hemp, trainer
    from aread_tpu_torch.train.trainer import Trainer

    save = str(dirs["root"] / f"flag_{name}")
    args = ["--device", "cpu", "--data_path", dirs["data"], "--save_path",
            save, "--dataset_name", "aliccp",
            "--bs", "64", "--embed_dim", "8", "--epoch", "1", *HEMP_FLAGS]
    if "--model" not in flags:
        args += ["--model", "aread"]
    if name in ("embed_lookup", "mesh"):
        with pytest.raises(ValueError, match={
                "embed_lookup": "embed_lookup='a2a' needs a device mesh",
                "mesh": "mesh of data=2 x model=1 needs 2 processes"}[name]):
            main(args + flags)
        return
    if name == "log_dir":
        flags = ["--log_dir", os.path.join(save, "logs")]
    if name == "epoch_timeout_s":
        # generous: a deadline this test can meet on a loaded machine
        flags = ["--epoch_timeout_s", "600"]
    if name == "dynamic_regroup":
        # the aliccp map has 30 domains, and the regroup needs the data to
        # have as many (a shorter domain set fails in the JAX package too)
        data = str(dirs["root"] / "dataset30")
        csv = preprocessed_csv_path("aliccp", data)
        os.makedirs(os.path.dirname(csv))
        make_canonical_frame("aliccp", 1500, seed=8, n_domain=30).to_csv(
            csv, index=False)
        args[args.index("--data_path") + 1] = data
    seen = {"watchdog": [], "regroup": [], "drift": 0}
    real_watchdog, real_regroup = health.watchdog, Trainer.apply_dynamic_regroup
    real_drift = hemp.oa.drift_table_l2

    def watchdog(timeout_s, tag="", kill_process=False):
        seen["watchdog"].append((timeout_s, tag, kill_process))
        return real_watchdog(timeout_s, tag, kill_process)

    def regroup(self, *a, **kw):
        before = self.domain2group.copy()
        changed = real_regroup(self, *a, **kw)
        seen["regroup"].append((before, self.domain2group.copy(), changed))
        return changed

    def drift(*a, **kw):
        seen["drift"] += 1
        return real_drift(*a, **kw)

    monkeypatch.setattr(health, "_first_epoch_done", False)
    monkeypatch.setattr(hemp, "watchdog", watchdog)
    monkeypatch.setattr(trainer, "watchdog", watchdog)
    monkeypatch.setattr(Trainer, "apply_dynamic_regroup", regroup)
    monkeypatch.setattr(hemp.oa, "drift_table_l2", drift)
    main(args + flags)
    assert 0.0 <= test_result(capsys.readouterr().out)["total_auc"] <= 1.0
    if name == "a2a_capacity":
        meta = load_checkpoint(os.path.join(save, "aliccp", "aread_best"))
        assert meta["config"]["a2a_capacity"] == 8
        assert meta["config"]["embed_lookup"] == "gspmd"
    tag = "train_epoch0" if name == "dynamic_regroup" else "aread_epoch0"
    (timeout, got_tag, kill), = seen["watchdog"]
    assert got_tag == tag
    assert (timeout, kill) == {"epoch_timeout_s": (3000.0, False),
                               "epoch_timeout_kill": (0.0, True)}.get(
                                   name, (0.0, False))
    if name == "log_dir":
        (run,) = os.listdir(flags[1])
        lines = open(os.path.join(flags[1], run,
                                  "metrics.jsonl")).read().splitlines()
        assert [json.loads(l).keys() - {"_step", "_ts"} for l in lines] == [
            {"valid"}, {"test", "domain_mask_active"}]
    elif name == "dynamic_regroup":
        (before, after, changed), = seen["regroup"]
        assert after.shape == before.shape and changed == (
            not np.array_equal(before, after))
    assert seen["drift"] == (1 if name == "hemp_fast_adapt" else 0)


def test_unported_flag_fails_the_process(dirs):
    """--embed_lookup a2a without a mesh fails the process by name (a mesh
    run is launched by torch.distributed.run)."""
    proc = train(dirs, "deepfm", "--embed_lookup", "a2a", expect_ok=False)
    assert proc.returncode != 0
    assert "ValueError" in proc.stderr and "embed_lookup" in proc.stderr
    assert "needs a device mesh" in proc.stderr
    assert "checkpoint saved" not in proc.stdout


def test_missing_csv_raises_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="raw-dump"):
        main(["--device", "cpu", "--data_path", str(tmp_path),
              "--dataset_name", "aliccp", "--model", "deepfm"])


def test_load_config_maps_flags_onto_the_config():
    cfg, device = load_config([
        "--model", "mmoe", "--dataset_name", "amazon", "--domain_filter",
        "[0, 2]", "--aread_final", "--lr", "0.01", "--table_dtype", "float32",
        "--use_dcn", "0", "--device_data", "0", "--grad_clip_norm", "0.5",
        "--save_path", "out", "--elastic", "--aug_ratio", "0.2"])
    assert device == "cuda"
    assert (cfg.model, cfg.dataset_name, cfg.domain_filter) == (
        "mmoe", "amazon", [0, 2])
    assert cfg.aread_final and cfg.elastic and not cfg.is_increment
    assert (cfg.lr, cfg.table_dtype, cfg.use_dcn, cfg.device_data) == (
        0.01, "float32", 0, "0")
    assert (cfg.grad_clip_norm, cfg.save_path, cfg.aug_ratio) == (
        0.5, "out", 0.2)
    assert cfg.seed == 2000 and cfg.itemid_all == 1368287
    # --is_set_seed 0 derives the seed from the arguments, the same twice
    a, _ = load_config(["--is_set_seed", "0", "--lr", "0.5"])
    b, _ = load_config(["--is_set_seed", "0", "--lr", "0.5"])
    c, _ = load_config(["--is_set_seed", "0", "--lr", "0.25"])
    assert a.seed == b.seed != 2000 and 0 <= a.seed < 10000
    assert c.seed != a.seed
    assert load_config(["--device", "cpu"])[1] == "cpu"


def _main_py_flags():
    """(flag, add_argument keywords as literals) of every flag of the root
    main.py."""
    tree = ast.parse(open(os.path.join(REPO, "main.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            yield node.args[0].value, {k.arg: ast.literal_eval(k.value)
                                       for k in node.keywords
                                       if k.arg in ("default", "action")}


def test_every_flag_of_main_py_parses():
    """A main.py command line runs here: each flag, given main.py's
    default (a store_true flag given alone), parses, and the mesh's flags
    with other values too (--a2a_capacity 8, --mesh_model 2)."""
    seen = set()
    for flag, kw in _main_py_flags():
        if flag == "--platform":  # --device takes its place
            continue
        seen.add(flag[2:])
        if kw.get("action") == "store_true":
            argv = [flag]
        else:
            default = kw.get("default")
            argv = [flag, "[0]" if default is None else str(default)]
        cfg, _ = load_config(argv)
        assert isinstance(cfg.model, str)
        if flag[2:] in ("a2a_capacity", "mesh_data", "mesh_model"):
            cfg, _ = load_config([flag, "8"])
            assert getattr(cfg, flag[2:]) == 8
    assert {"a2a_capacity", "mesh_data", "mesh_model", "prng_impl", "model",
            "epoch_timeout_s", "embed_lookup"} <= seen
    assert len(seen) >= 40
    # prng_impl has no meaning here: either value gives the same config
    assert (load_config(["--prng_impl", "threefry"])[0]
            == load_config(["--prng_impl", "rbg"])[0])
