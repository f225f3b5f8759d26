"""The port's checkpoints (aread_tpu_torch/train/checkpoint.py), resume
(``fit(ckpt_dir=)``) and warm start (``fit(warm_start=)``), at toy size on
the CPU.

* a checkpoint round trip: state dict (a bf16 table as bf16), optimizer
  state, masks with None domains, HEMP schedule, generator state: equal;
* meta.json from the port and from aread_tpu.train.checkpoint for the same
  spec and the config fields both have: equal values;
* a save interrupted before meta.json leaves no readable checkpoint;
* a checkpoint of the JAX package through convert_checkpoint: state dict,
  optimizer state, masks and schedule;
* generic Trainer: 1 epoch + resume + 1 epoch == 2 epochs uninterrupted,
  weights, BatchNorm statistics and moments bitwise, with dropout on (the
  generator's state is part of the checkpoint);
* AREADTrainer: the same, 1 epoch + resume + 1 epoch == 2 epochs
  uninterrupted, weights and moments bitwise, masks and schedule exact:
  the checkpoint also holds the host-side streams (both batchers'
  positions, the mask generator's, the gate records waiting for the next
  regroup), which the JAX package's does not; the resumed trainer enters
  epoch 1 holding exactly what the first run saved;
* both trainers against the JAX trainers' resumed run, both resuming from
  one checkpoint (the JAX one, carried over by convert_checkpoint: it
  holds no host-side streams, so the port restarts them from the seed as
  the JAX trainer does), at the tolerances of
  tests/test_torch_port_hemp.py and tests/test_torch_port_trainer.py:
  weights and moments atol 1e-4, AUCs atol 1e-3, masks and schedule equal;
* warm start adopts weights, buffers and masks and starts a fresh
  optimizer."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.train import checkpoint as jckpt
from aread_tpu.train.trainer import hybrid_init as j_hybrid_init
from aread_tpu.utils import masks as JM
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import (HEMP_SCHEDULE_FIELDS,
                                     convert_checkpoint, convert_opt_state,
                                     convert_variables)
from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.train import checkpoint as ckpt
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.trainer import Trainer
from aread_tpu_torch.utils.masks import HempMaskState, mask_shapes
from tests import test_torch_port_hemp as H
from tests import test_torch_port_trainer as TT
from tests.test_torch_port_hemp import world  # noqa: F401  (fixture)
from tests.test_torch_port_trainer import jax_true_zero  # noqa: F401

N_DOMAIN = 3


def _toy_cfg(model, **kw):
    return Config(**{**dict(
        model=model, bs=64, embed_dim=8, dataset_name="none", seed=5,
        mlp_dims=(16, 8), aread_tower_dims=((8,), (8,)),
        mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8, 4), atten_embed_dim=8,
        att_layer_num=1, warm_up_interval=1, regroup_interval=1,
        regroup_update_step=1, regroup_eval_step=1, candidate_mask_num=2,
        early_stop=100, device_data="0"), **kw})


def _toy_data(seed=0, n_rows=600):
    return make_synthetic_data(n_rows=n_rows, n_domain=N_DOMAIN, vocab=60,
                               seed=seed)


def _assert_tree_equal(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _assert_masks_equal(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        assert (ma is None) == (mb is None)
        if ma is not None:
            assert len(ma) == len(mb)
            for x, y in zip(ma, mb):
                assert np.asarray(x).dtype == bool
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------------- round trip
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, table_dtype):
    data = _toy_data()
    cfg = _toy_cfg("aread", table_dtype=table_dtype,
                   table_moments_dtype=table_dtype)
    model = build_model(cfg, data.spec, N_DOMAIN, n_tower=2, device="cpu")
    tr = AREADTrainer(model, cfg, N_DOMAIN)
    tr.init()
    batch = {"x": data.train_x[:64], "y": data.train_y[:64].astype(np.float32),
             "valid": np.ones(64, np.float32)}
    for _ in range(2):  # moments and counts that are not zero
        tr.warmup_step(batch)
    assert model.embedding.table.dtype == getattr(torch, table_dtype)
    ms = HempMaskState(model.n_tower, N_DOMAIN, seed=1)
    masks = [ms.generate_mask("rand", 0, 0.6), None,
             ms.generate_mask("rand", 2, 0.6)]
    sched = {"random_modify_sigma": 0.19, "init_active_percent": 0.6,
             "candidate_mask_num": 9.8, "regroup_times": 3}
    gen = torch.Generator(device="cpu").manual_seed(7)
    torch.rand(5, generator=gen)
    path = str(tmp_path / "ckpt")
    host = {"rng": np.random.default_rng(3).bit_generator.state,
            "orders": [np.arange(5, dtype=np.int32), None], "cursors": [2, 0],
            "records": [[np.ones((2, 3), np.float32)], []],
            "count": np.int64(7)}
    ckpt.save_checkpoint(path, model.state_dict(), tr.opt_state, epoch=4,
                         best_result={"total_auc": 0.7, "mean_auc": float("nan"),
                                      "n": 3, "domain_auc": {0: 0.5},
                                      "note": "x"},
                         domain_mask=masks, hemp_schedule=sched, generator=gen,
                         host_state=host)
    assert sorted(os.listdir(path)) == ["arrays", "meta.json"]
    assert os.listdir(os.path.join(path, "arrays")) == [ckpt.ARRAYS_FILE]
    out = ckpt.load_checkpoint(path, n_domain=N_DOMAIN)
    assert out["epoch"] == 4
    # the coercions: floats and ints to float, a NaN stays NaN, a nested
    # dict is dropped, anything else becomes null
    best = out["best_result"]
    assert best["total_auc"] == 0.7 and best["n"] == 3.0
    assert np.isnan(best["mean_auc"]) and best["note"] is None
    assert "domain_auc" not in best
    assert out["hemp_schedule"] == sched
    _assert_tree_equal(dict(model.state_dict()), dict(out["state_dict"]))
    assert out["state_dict"]["embedding.table"].dtype == getattr(torch, table_dtype)
    _assert_tree_equal(tr.opt_state, out["opt_state"])
    assert out["opt_state"]["t"] == 2 and out["opt_state"]["inner"]["count"] == 2
    _assert_masks_equal(out["domain_mask"], masks)
    assert out["domain_mask"][1] is None
    # the host-side tree comes back with numpy arrays and Python numbers
    got = out["host_state"]
    assert got["rng"] == host["rng"]  # 128-bit integers and all
    assert got["cursors"] == [2, 0] and got["count"] == 7
    assert got["orders"][1] is None and got["records"][1] == []
    np.testing.assert_array_equal(got["orders"][0], host["orders"][0])
    assert got["orders"][0].dtype == np.int32
    np.testing.assert_array_equal(got["records"][0][0], host["records"][0][0])
    # the generator goes on where the saved one stood
    gen2 = torch.Generator(device="cpu").manual_seed(0)
    ckpt.set_generator_state(gen2, out["rng_state"])
    assert torch.equal(torch.rand(4, generator=gen2),
                       torch.rand(4, generator=gen))
    # without n_domain the masks are not rebuilt; without a generator or
    # masks nothing of the kind is saved
    assert "domain_mask" not in ckpt.load_checkpoint(path)
    ckpt.save_checkpoint(path, model.state_dict(), {}, epoch=5)
    out = ckpt.load_checkpoint(path, n_domain=N_DOMAIN)
    assert out["epoch"] == 5 and out["opt_state"] == {}
    assert "rng_state" not in out and "domain_mask" not in out
    assert "host_state" not in out
    assert "best_result" not in out and "spec" not in out


def test_generator_state_of_another_device_type_is_refused():
    gen = torch.Generator(device="cpu").manual_seed(1)
    saved = ckpt.generator_state(gen)
    assert saved["device"] == "cpu"
    with pytest.raises(ValueError, match="saved on 'cuda'.*'cpu'"):
        ckpt.set_generator_state(gen, {**saved, "device": "cuda"})


def test_restore_tree_is_in_place_and_checks_structure():
    live = {"a": torch.zeros(3), "n": {"b": torch.zeros(2, 2,
                                                        dtype=torch.bfloat16),
                                       "count": 0}}
    ptr = live["a"].data_ptr(), live["n"]["b"].data_ptr()
    ckpt.restore_tree_(live, {"a": torch.ones(3),
                              "n": {"b": torch.full((2, 2), 2.0), "count": 7}})
    assert (live["a"].data_ptr(), live["n"]["b"].data_ptr()) == ptr
    assert live["n"]["count"] == 7 and float(live["a"].sum()) == 3.0
    assert live["n"]["b"].dtype == torch.bfloat16  # cast to the live dtype
    assert float(live["n"]["b"].float().sum()) == 8.0
    with pytest.raises(KeyError, match="keys differ"):
        ckpt.restore_tree_(live, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="/a"):
        ckpt.restore_tree_(live, {"a": torch.ones(4), "n": live["n"]})


def test_mask_names_and_template():
    n_tower = (2, 4)
    ms = HempMaskState(n_tower, 3, seed=0)
    masks = [ms.generate_mask("rand", 0, 0.5), None,
             ms.generate_mask("rand", 2, 0.5)]
    flat = ckpt._mask_to_flat(masks)
    jflat = jckpt._mask_to_flat(masks)
    assert sorted(flat) == sorted(jflat) == [
        "d0_l0", "d0_l1", "d0_l2", "d2_l0", "d2_l1", "d2_l2"]
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k])
    _assert_masks_equal(ckpt._mask_from_flat(flat, 3), masks)
    _assert_masks_equal(ckpt._mask_from_flat(flat, 3),
                        jckpt._mask_from_flat(jflat, 3))
    tmpl, jtmpl = ckpt.mask_template(n_tower, 3), jckpt.mask_template(n_tower, 3)
    assert list(tmpl) == list(jtmpl)
    for k in tmpl:
        assert tmpl[k].shape == jtmpl[k].shape and tmpl[k].dtype == bool
    assert [tmpl[f"d1_l{i}"].shape for i in range(3)] == mask_shapes(n_tower)


# ------------------------------------------------------------- meta.json
def test_meta_json_equals_the_jax_packages(tmp_path):
    data = _toy_data()
    kw = dict(model="aread", dataset_name="amazon", bs=64, embed_dim=8,
              domain_filter=[0, 2], aread_tower_dims=((8, 4), (4,)),
              mlp_dims=(16, 8), streaming_eval=True, elastic=True,
              save_path="out", lr=3e-3)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    jspec = JFeatureSpec(**dataclasses.asdict(data.spec))
    best = {"total_auc": 0.71, "total_loss": 0.6, "mean_auc": float("nan"),
            "domain_auc": {0: 0.7}}
    sched = {"random_modify_sigma": 0.19, "init_active_percent": 0.6,
             "candidate_mask_num": 9.8, "regroup_times": 3}
    model = build_model(dataclasses.replace(cfg, dataset_name="none"),
                        data.spec, N_DOMAIN, n_tower=2, device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "p"), model.state_dict(), {}, epoch=3,
                         best_result=best, hemp_schedule=sched,
                         spec=data.spec, run_config=cfg, n_domain=N_DOMAIN)
    jckpt.save_checkpoint(str(tmp_path / "j"), {"w": np.zeros(2)}, {}, {},
                          epoch=3, best_result=best, hemp_schedule=sched,
                          spec=jspec, run_config=jcfg, n_domain=N_DOMAIN)
    meta, jmeta = (json.load(open(tmp_path / d / "meta.json"))
                   for d in ("p", "j"))
    assert set(meta) == set(jmeta) == {"epoch", "n_domain", "best_result",
                                       "hemp_schedule", "spec", "config"}
    for k in ("epoch", "n_domain", "hemp_schedule", "spec"):
        assert meta[k] == jmeta[k], k
    np.testing.assert_equal(meta["best_result"], jmeta["best_result"])
    # every config field of the port is one of the JAX package's, stored
    # with the same value
    assert set(meta["config"]) <= set(jmeta["config"])
    assert set(meta["config"]) == {f.name for f in dataclasses.fields(Config)}
    for k, v in meta["config"].items():
        assert v == jmeta["config"][k], k
    assert meta["config"]["aread_tower_dims"] == [[8, 4], [4]]
    assert meta["config"]["domain_filter"] == [0, 2]


# ------------------------------------------------- an interrupted save
@pytest.mark.parametrize("first", [True, False], ids=["first_save",
                                                      "over_an_older_one"])
def test_interrupted_save_leaves_no_readable_checkpoint(tmp_path, monkeypatch,
                                                        first):
    path = str(tmp_path / "ckpt")
    sd = {"w": torch.arange(4.0)}
    if not first:
        ckpt.save_checkpoint(path, sd, {}, epoch=1)
        assert ckpt.load_checkpoint(path)["epoch"] == 1

    def crash(*a, **kw):
        raise OSError("power cut")

    monkeypatch.setattr(ckpt.json, "dump", crash)
    with pytest.raises(OSError, match="power cut"):
        ckpt.save_checkpoint(path, {"w": torch.zeros(4)}, {}, epoch=2)
    # the arrays are the new ones and no meta.json describes them: the
    # directory is not a checkpoint, and a trainer would start over
    assert not os.path.exists(os.path.join(path, "meta.json"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(path)
    monkeypatch.undo()
    # a crash while the arrays are written leaves the old checkpoint whole
    ckpt.save_checkpoint(path, sd, {}, epoch=3)
    monkeypatch.setattr(ckpt.torch, "save", crash)
    with pytest.raises(OSError, match="power cut"):
        ckpt.save_checkpoint(path, {"w": torch.zeros(4)}, {}, epoch=4)
    monkeypatch.undo()
    out = ckpt.load_checkpoint(path)
    assert out["epoch"] == 3 and torch.equal(out["state_dict"]["w"], sd["w"])
    # and the next save goes through over the leftovers
    ckpt.save_checkpoint(path, sd, {}, epoch=5)
    assert ckpt.load_checkpoint(path)["epoch"] == 5
    assert sorted(os.listdir(path)) == ["arrays", "meta.json"]


# ------------------------------------------- the generic Trainer: resume
def _trainer(model_name, data, **kw):
    cfg = _toy_cfg(model_name, **kw)
    d2g = np.array([0, 1, 2]) if model_name == "mmoe" else None
    return Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                   N_DOMAIN, d2g)


@pytest.mark.parametrize("model_name,kw", [
    ("deepfm", dict(sparse_table_grad=False, table_dtype="float32")),
    ("deepfm", dict(sparse_table_grad=True, table_dtype="bfloat16")),
    ("mmoe", dict(sparse_table_grad=True, table_dtype="float32",
                  device_data="1")),
], ids=["deepfm-dense-f32", "deepfm-sparse-bf16", "mmoe-sparse-device_data"])
def test_trainer_resume_equals_uninterrupted(tmp_path, model_name, kw):
    """Dropout is on (0.2): the resumed epoch repeats the uninterrupted
    one only if the generator's state came back too."""
    data = _toy_data(seed=1)
    whole = _trainer(model_name, data, **kw)
    assert whole.config.dropout == 0.2
    res_whole = whole.fit(data, epochs=2, verbose=False)

    d = str(tmp_path / "elastic")
    first = _trainer(model_name, data, **kw)
    first.fit(data, epochs=1, verbose=False, ckpt_dir=d)
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["epoch"] == 1 and meta["best_result"]["total_auc"] > 0
    assert set(meta) == {"epoch", "best_result"}
    second = _trainer(model_name, data, **kw)
    table_ptr = second.model.embedding.table.data_ptr()
    res = second.fit(data, epochs=2, verbose=False, ckpt_dir=d)
    assert len(res["history"]) == 1  # epoch 0 was not run again
    assert second.model.embedding.table.data_ptr() == table_ptr  # in place
    assert second.opt_state["t"] == whole.opt_state["t"]
    _assert_tree_equal(second.opt_state, whole.opt_state)
    # fit leaves the best weights in the model: the same epoch's on both
    _assert_tree_equal(dict(second.model.state_dict()),
                       dict(whole.model.state_dict()))
    strip = lambda h: {k: v for k, v in h.items()
                       if k not in ("epoch_time_s", "examples_per_s", "spans")}
    np.testing.assert_equal(strip(res["history"][0]),
                            strip(res_whole["history"][1]))
    np.testing.assert_equal(res["test"], res_whole["test"])
    assert second.best_checkpoint[1] == whole.best_checkpoint[1]
    for k in ("best_auc", "best_mean_auc", "best_loss", "best_mean_loss"):
        assert getattr(second, k) == getattr(whole, k), k
    # nothing left to do: a third trainer resumes at epoch 2 and only tests
    third = _trainer(model_name, data, **kw)
    saved_epoch = json.load(open(os.path.join(d, "meta.json")))["epoch"]
    res3 = third.fit(data, epochs=saved_epoch, verbose=False, ckpt_dir=d)
    assert res3["history"] == []


def test_trainer_writes_a_checkpoint_where_none_was(tmp_path):
    data = _toy_data(seed=3, n_rows=300)
    d = str(tmp_path / "never_written" / "elastic")
    res = _trainer("deepfm", data).fit(data, epochs=1, verbose=False,
                                       ckpt_dir=d)
    assert len(res["history"]) == 1
    ck = ckpt.load_checkpoint(d)
    assert ck["epoch"] == 1 and ck["rng_state"]["device"] == "cpu"
    assert float(ck["opt_state"]["m"].float().abs().sum()) > 0
    # a generator saved on another device type does not resume here
    tree_path = os.path.join(d, "arrays", ckpt.ARRAYS_FILE)
    tree = torch.load(tree_path, weights_only=True)
    tree["rng_state"]["device"] = "cuda"
    torch.save(tree, tree_path)
    with pytest.raises(ValueError, match="saved on 'cuda'"):
        _trainer("deepfm", data).fit(data, epochs=2, verbose=False, ckpt_dir=d)
    # but warm-starts all the same
    _trainer("deepfm", data).fit(data, epochs=1, verbose=False,
                                 warm_start=ckpt.load_checkpoint(d))


def test_trainer_warm_start_adopts_weights_and_starts_a_fresh_optimizer(
        monkeypatch):
    data = _toy_data(seed=2)
    src = _trainer("deepfm", data)
    src.fit(data, epochs=1, verbose=False)
    warm = {"state_dict": {k: v.clone()
                           for k, v in src.model.state_dict().items()}}
    tr = _trainer("deepfm", data, seed=9)  # other initial weights
    seen = {}
    epoch = tr.train_epoch

    def train_epoch(batcher):
        seen["weights"] = {k: v.clone()
                           for k, v in tr.model.state_dict().items()}
        seen["t"] = tr.opt_state["t"]
        seen["m"] = float(tr.opt_state["m"].float().abs().sum())
        return epoch(batcher)

    monkeypatch.setattr(tr, "train_epoch", train_epoch)
    tr.fit(data, epochs=1, verbose=False, warm_start=warm)
    _assert_tree_equal(seen["weights"], warm["state_dict"])
    assert seen["t"] == 0 and seen["m"] == 0.0
    with pytest.raises(ValueError, match="state_dict/embedding.table"):
        _trainer("deepfm", _toy_data(seed=2, n_rows=300), embed_dim=4).fit(
            data, epochs=1, verbose=False, warm_start=warm)


# ----------------------------------------------- AREADTrainer: resume
def _aread_trainer(data, **kw):
    # intervals count 1024-row batches: at bs 32 an interval is 32 steps,
    # and 1120 train rows give every epoch a regroup point
    cfg = _toy_cfg("aread", **{"bs": 32, **kw})
    return AREADTrainer(build_model(cfg, data.spec, N_DOMAIN, n_tower=2,
                                    device="cpu"), cfg, N_DOMAIN)


def test_host_streams_take_up_where_they_stood():
    """DomainBatcher and HempMaskState: set_state(get_state()) on a fresh
    object gives the draws the first one goes on to give."""
    data = _toy_data(seed=1, n_rows=300)
    make = lambda: DomainBatcher(data.train_x, data.train_y, 32,
                                 data.spec.domain_idx, N_DOMAIN, seed=3)
    a = make()
    for d in (0, 1, 0, 2, 0, 0):
        a.next_batch_indices(d)
    a.shuffle_seq()
    state = a.get_state()
    b = make()
    b.set_state(state)
    assert b.domain_batch_seq == a.domain_batch_seq
    for d in (0, 2, 1, 0, 0, 0, 0, 0, 1):  # across a reshuffle of domain 0
        np.testing.assert_array_equal(a.next_batch_indices(d),
                                      b.next_batch_indices(d))
    a.shuffle_seq()
    b.shuffle_seq()
    assert b.domain_batch_seq == a.domain_batch_seq
    assert state["orders"][0].dtype == np.int32
    ms = HempMaskState((2, 4), N_DOMAIN, seed=2)
    rng = np.random.default_rng(0)
    for d in (0, 0, 2):
        ms.record_gates(d, [(rng.random((2, 4)) + 1e-3).astype(np.float32)])
    ms.generate_mask("rand", 0, 0.6)
    ms2 = HempMaskState((2, 4), N_DOMAIN, seed=9)
    ms2.record_gates(1, [np.ones((2, 4), np.float32)])  # dropped by set_state
    ms2.set_state(ms.get_state())
    assert [len(acc) for acc in ms2.gate_acc] == [2, 0, 1]
    for d in range(N_DOMAIN):
        m1 = ms.generate_mask("mask_max_gate", d, 0.6, 0.2)
        m2 = ms2.generate_mask("mask_max_gate", d, 0.6, 0.2)
        for x, y in zip(m1, m2):
            np.testing.assert_array_equal(x, y)


def test_aread_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """1 epoch + resume + 1 epoch == 2 epochs uninterrupted, bitwise, with
    dropout on and a regroup in either epoch; and the resumed trainer
    enters epoch 1 holding exactly what the first run saved."""
    data = _toy_data(seed=4, n_rows=1400)
    whole = _aread_trainer(data)
    assert whole.config.dropout == 0.2
    res_whole = whole.fit(data, epochs=2, verbose=False)
    d = str(tmp_path / "elastic")
    first = _aread_trainer(data)
    first.fit(data, epochs=1, verbose=False, ckpt_dir=d)
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["epoch"] == 1
    sched = meta["hemp_schedule"]
    assert sched == first.hemp_schedule()
    assert sched["regroup_times"] >= 2
    assert sched["random_modify_sigma"] < first.config.random_modify_sigma
    assert tuple(sched) == HEMP_SCHEDULE_FIELDS
    assert set(ckpt.load_checkpoint(d)["host_state"]) == {
        "train_batcher", "aug_batcher", "mask_state"}
    gen_after_first = first.generator.get_state()

    second = _aread_trainer(data)
    seen = {}
    epoch = second.train_epoch

    def train_epoch(epoch_i, *a, **k):
        seen["epoch_i"] = epoch_i
        seen["weights"] = second._snapshot()
        seen["opt"] = {"t": second.opt_state["t"],
                       "m": second.opt_state["m"].clone(),
                       "v": second.opt_state["v"].clone(),
                       "count": second.opt_state["inner"]["count"]}
        seen["masks"] = [[m.copy() for m in dm]
                         for dm in second.mask_state.domain_mask]
        seen["sched"] = second.hemp_schedule()
        seen["gen"] = second.generator.get_state()
        seen["best"] = (second.best_auc, second.best_mean_auc,
                        second.best_checkpoint[2])
        return epoch(epoch_i, *a, **k)

    monkeypatch.setattr(second, "train_epoch", train_epoch)
    table_ptr = second.model.embedding.table.data_ptr()
    res = second.fit(data, epochs=2, verbose=False, ckpt_dir=d)
    assert second.model.embedding.table.data_ptr() == table_ptr  # in place
    assert seen["epoch_i"] == 1 and len(res["history"]) == 1
    # the first run ended its fit holding its best (only) epoch's weights
    _assert_tree_equal(seen["weights"], first._snapshot())
    assert seen["opt"]["t"] == first.opt_state["t"] > 0
    assert seen["opt"]["count"] == first.opt_state["inner"]["count"]
    assert torch.equal(seen["opt"]["m"], first.opt_state["m"])
    assert torch.equal(seen["opt"]["v"], first.opt_state["v"])
    _assert_masks_equal(seen["masks"], first.mask_state.domain_mask)
    assert seen["sched"] == sched
    assert torch.equal(seen["gen"], gen_after_first)
    assert seen["best"] == (first.best_auc, first.best_mean_auc, 0)
    # after the second epoch: the uninterrupted run's state, bit for bit
    assert second.regroup_times == whole.regroup_times > sched["regroup_times"]
    assert second.hemp_schedule() == whole.hemp_schedule()
    _assert_tree_equal(second.opt_state, whole.opt_state)
    _assert_tree_equal(second._snapshot(), whole._snapshot())
    _assert_masks_equal(res["domain_mask"], res_whole["domain_mask"])
    strip = lambda h: {k: v for k, v in h.items()
                       if k not in ("epoch_time_s", "examples_per_s", "spans")}
    np.testing.assert_equal(strip(res["history"][0]),
                            strip(res_whole["history"][1]))
    np.testing.assert_equal(res["test"], res_whole["test"])
    assert second.best_checkpoint[2] == whole.best_checkpoint[2]
    assert (second.best_auc, second.best_mean_auc) == (
        whole.best_auc, whole.best_mean_auc)


def test_aread_resume_refuses_masks_of_another_model(tmp_path):
    data = _toy_data(seed=4, n_rows=300)
    d = str(tmp_path / "elastic")
    _aread_trainer(data).fit(data, epochs=1, verbose=False, ckpt_dir=d)
    other = _aread_trainer(data, aread_tower_dims=((8,), (8,), (4,)))
    with pytest.raises(ValueError, match="domain masks do not fit"):
        other.fit(data, epochs=2, verbose=False, ckpt_dir=d)


def test_aread_warm_start_adopts_weights_buffers_and_masks(monkeypatch):
    data = _toy_data(seed=6)
    src = _aread_trainer(data)
    res = src.fit(data, epochs=1, verbose=False)
    warm = {"state_dict": src._snapshot(), "domain_mask": res["domain_mask"]}
    tr = _aread_trainer(data, seed=9, warm_up_interval=0,
                        regroup_interval=1000)
    seen = {}
    epoch = tr.train_epoch

    def train_epoch(epoch_i, *a, **k):
        seen["weights"] = tr._snapshot()
        seen["masks"] = [[m.copy() for m in dm]
                         for dm in tr.mask_state.domain_mask]
        seen["t"] = tr.opt_state["t"]
        seen["m"] = float(tr.opt_state["m"].float().abs().sum())
        return epoch(epoch_i, *a, **k)

    monkeypatch.setattr(tr, "train_epoch", train_epoch)
    tr.fit(data, epochs=1, verbose=False, warm_start=warm)
    _assert_tree_equal(seen["weights"], warm["state_dict"])
    assert any(k.endswith("running_mean") or "bn" in k
               for k in warm["state_dict"])  # buffers are part of it
    _assert_masks_equal(seen["masks"], warm["domain_mask"])
    assert seen["t"] == 0 and seen["m"] == 0.0
    assert tr.regroup_times == 1  # a fresh schedule, not the source's
    # a warm start without masks keeps the mask state's own
    tr2 = _aread_trainer(data, seed=9)
    tr2.fit(data, epochs=1, verbose=False,
            warm_start={"state_dict": warm["state_dict"]})


# ------------------------------------------- against the JAX trainers
def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def _jnp_tree(t):
    return jax.tree_util.tree_map(jnp.array, t)


def test_trainer_resume_matches_the_jax_trainers(tmp_path, monkeypatch,
                                                 jax_true_zero):  # noqa: F811
    """Both sides resume from one checkpoint, the JAX trainer's after its
    first epoch, and run epoch 1 (7 steps): weights and moments atol 1e-4,
    the epoch's losses atol 1e-4, AUCs atol 1e-3. ``convert_checkpoint``
    takes the optimizer state in either form Orbax restores it (with a
    template: the optax NamedTuples; without: nested dicts)."""
    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    E = TT.E
    data = make_synthetic_data(n_rows=1024, n_domain=TT.N_DOMAIN, vocab=60,
                               seed=0)
    jt, params, state, opt_state, tr = TT._pair(
        "deepfm", data, sparse_table_grad=False, bs=128, seed=7)
    # the JAX steps donate their inputs: every fit gets copies of its own
    params, state = _np_tree(params), _np_tree(state)

    def init(rng, sample):
        p = _jnp_tree(params)
        return p, _jnp_tree(state), JT.hybrid_init(
            jt.optimizer, p, moments_dtype=jt.config.table_moments_dtype)

    monkeypatch.setattr(jt, "init", init)
    jdata = TT.JSplitData(**{f.name: getattr(data, f.name)
                             for f in dataclasses.fields(data)
                             if f.name != "spec"}, spec=jt.model.spec)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.fit(jdata, epochs=1, verbose=False, ckpt_dir=jdir)
    template = {"params": params, "state": state,
                "opt_state": _np_tree(opt_state),
                "rng_key": np.zeros((2,), np.uint32)}
    ck = jckpt.load_checkpoint(jdir, template=template)
    pck = convert_checkpoint(ck, E)
    assert pck["epoch"] == 1 and pck["opt_state"]["t"] == 7
    loose = convert_checkpoint(jckpt.load_checkpoint(jdir), E)
    _assert_tree_equal(loose["opt_state"], pck["opt_state"])
    _assert_tree_equal(loose["state_dict"], pck["state_dict"])
    ckpt.save_checkpoint(pdir, pck["state_dict"], pck["opt_state"],
                         epoch=pck["epoch"], best_result=pck["best_result"],
                         generator=tr.generator)
    # the JAX side again, its early-stop state as new, from its directory
    jt.trial_counter, jt.best_auc, jt.best_mean_auc = 0, 0.0, 0.0
    jt.best_loss = jt.best_mean_loss = np.inf
    jt.best_checkpoint = None
    jres = jt.fit(jdata, epochs=2, verbose=False, ckpt_dir=jdir)
    pres = tr.fit(data, epochs=2, verbose=False, ckpt_dir=pdir)
    assert len(jres["history"]) == len(pres["history"]) == 1
    ph, jh = pres["history"][0], jres["history"][0]
    for k in ("train_loss", "total_loss"):
        np.testing.assert_allclose(ph[k], jh[k], rtol=0, atol=1e-4, err_msg=k)
    for k in ("total_auc", "mean_auc"):
        np.testing.assert_allclose(ph[k], jh[k], rtol=0, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(pres["test"][k], jres["test"][k], rtol=0,
                                   atol=1e-3, err_msg=k)
    assert tr.best_checkpoint[1] == jt.best_checkpoint[-1]
    np.testing.assert_allclose(tr.best_mean_auc, jt.best_mean_auc, rtol=0,
                               atol=1e-3)
    # the last save of either side holds the same state
    jck = jckpt.load_checkpoint(jdir, template=template)
    pck2 = ckpt.load_checkpoint(pdir)
    assert jck["epoch"] == pck2["epoch"]
    want = convert_checkpoint(jck, E)
    assert want["opt_state"]["t"] == pck2["opt_state"]["t"]
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(pck2["state_dict"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
    for k in ("m", "v"):
        np.testing.assert_allclose(pck2["opt_state"][k].numpy(),
                                   want["opt_state"][k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_aread_resume_matches_the_jax_trainers(world, tmp_path,  # noqa: F811
                                               monkeypatch):
    """Both sides resume from the JAX trainer's checkpoint of its first
    epoch (masks, schedule and optimizer state carried by
    convert_checkpoint) and run epoch 1 with fresh batch streams and a
    fresh mask generator, as a resume does: train loss atol 1e-4, AUCs
    atol 1e-3, the evolved masks and the schedule equal, weights and the
    table's moments atol 1e-4."""
    E = H.E
    jt, _, _, opt_state, tr = H._fresh(world)

    def init(rng, sample):  # the JAX steps donate: copies for every fit
        p = _jnp_tree(world.params)
        return p, _jnp_tree(world.state), j_hybrid_init(
            jt.optimizer, p, moments_dtype="float32")

    monkeypatch.setattr(jt, "init", init)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.fit(world.jdata, rng=jax.random.PRNGKey(0), epochs=1, verbose=False,
           ckpt_dir=jdir)
    ck = jckpt.load_checkpoint(jdir, n_domain=H.N_DOMAIN, template={
        "params": world.params, "state": world.state,
        "opt_state": _np_tree(opt_state),
        "rng_key": np.zeros((2,), np.uint32),
        "domain_mask": jckpt.mask_template(H.N_TOWER, H.N_DOMAIN)})
    pck = convert_checkpoint(ck, E)
    assert "host_state" not in pck  # the JAX checkpoint holds no streams
    sched = pck["hemp_schedule"]
    assert sched["regroup_times"] == jt.regroup_times >= 2
    for d in range(H.N_DOMAIN):
        H._assert_masks_equal(pck["domain_mask"][d],
                              jt.mask_state.domain_mask[d])
    ckpt.save_checkpoint(pdir, pck["state_dict"], pck["opt_state"],
                         epoch=pck["epoch"], best_result=pck["best_result"],
                         domain_mask=pck["domain_mask"], hemp_schedule=sched,
                         generator=tr.generator)
    # the JAX side again as a new process would hold it
    jt.mask_state = JM.HempMaskState(H.N_TOWER, H.N_DOMAIN,
                                     seed=jt.config.seed)
    jt.random_modify_sigma = jt.config.random_modify_sigma
    jt.init_active_percent = jt.config.init_active_percent
    jt.candidate_mask_num = float(jt.config.candidate_mask_num)
    jt.regroup_times = 0
    jt.trial_counter, jt.best_auc, jt.best_mean_auc = 0, 0.0, 0.0
    jt.best_checkpoint = None
    jres = jt.fit(world.jdata, rng=jax.random.PRNGKey(0), epochs=2,
                  verbose=False, ckpt_dir=jdir)
    pres = tr.fit(world.data, epochs=2, verbose=False, ckpt_dir=pdir)
    assert len(jres["history"]) == len(pres["history"]) == 1
    ph, jh = pres["history"][0], jres["history"][0]
    np.testing.assert_allclose(ph["train_loss"], jh["train_loss"], rtol=0,
                               atol=1e-4)
    for k in ("total_auc", "mean_auc"):
        np.testing.assert_allclose(ph[k], jh[k], rtol=0, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(pres["test"][k], jres["test"][k], rtol=0,
                                   atol=1e-3, err_msg=k)
    for d in range(H.N_DOMAIN):
        H._assert_masks_equal(jres["domain_mask"][d], pres["domain_mask"][d])
    assert tr.regroup_times == jt.regroup_times > sched["regroup_times"]
    for name in HEMP_SCHEDULE_FIELDS:
        assert getattr(tr, name) == getattr(jt, name), name
    assert tr.best_checkpoint[2] == jt.best_checkpoint[2]
    H._assert_weights_close(tr.model, jres["params"], jres["state"], 1e-4)
