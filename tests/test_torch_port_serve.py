"""The port's serving layer (aread_tpu_torch/serve) at toy size on the CPU.

* ``Predictor`` against aread_tpu.serve.predictor.Predictor from the same
  weights (carried by convert.py) for DeepFM, MMoE (group gather, with a
  domain2group map and with the domain fallback) and AREAD (single-domain
  requests, mixed-domain requests, a domain without an evolved mask):
  probabilities at atol 1e-5 (two frameworks' f32 products);
* against the port's own evaluation path (``Trainer.eval_prob``,
  ``AREADTrainer.eval_prob``) at atol 1e-6 (a padded bucket and an
  evaluation batch may sum in another order);
* ``_bucket`` equal to the JAX package's over a sweep; input order kept;
  ``n == 0``;
* a checkpoint of the JAX package through ``convert_checkpoint`` and the
  port's ``save_checkpoint`` / ``load_predictor`` serves the JAX
  Predictor's probabilities (atol 1e-5), from meta.json alone, for
  DeepFM, MMoE, AREAD, PEPNet and AREAD on a PLE base with non-default
  ``ple_*`` values;
* the HTTP round trip, 404 and 400, as tests/test_serving.py;
* ``predict`` called from a second thread runs in inference mode and
  records no autograd graph; the Predictor's module is its own."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.config import Config as JConfig
from aread_tpu.models import build_model as j_build_model
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.serve import predictor as JP
from aread_tpu.train import checkpoint as jckpt
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_checkpoint, convert_variables
from aread_tpu_torch.data.loader import (DomainBatcher, GlobalBatcher,
                                         make_synthetic_data)
from aread_tpu_torch.models import build_model
from aread_tpu_torch.serve import predictor as P
from aread_tpu_torch.ops.precision import matmul_precision_ctx
from aread_tpu_torch.serve.predictor import Predictor, load_predictor
from aread_tpu_torch.serve.server import make_server
from aread_tpu_torch.train import checkpoint as ckpt
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.trainer import Trainer
from aread_tpu_torch.utils.masks import HempMaskState
from tests.test_torch_port_zoo import seeded_variables

E, N_DOMAIN = 8, 4
D2G = np.array([0, 1, 2, 1])
CFG_KW = dict(embed_dim=E, bs=64, dataset_name="none", mlp_dims=(16, 8),
              aread_tower_dims=((8,), (8,), (4,)), mmoe_expert_dims=(16, 8),
              mmoe_tower_dims=(8, 4), atten_embed_dim=8, att_layer_num=1,
              table_dtype="float32", table_moments_dtype="float32")


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_data(n_rows=640, n_domain=N_DOMAIN, vocab=60, seed=3)


def _pair(model_name, data, **kw):
    """(JAX model, params, state, the port's model) with the same weights,
    both built by their package's build_model from one config."""
    kw = {**CFG_KW, "model": model_name, **kw}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jspec = JFeatureSpec(**dataclasses.asdict(data.spec))
    jm = j_build_model(jcfg, jspec, N_DOMAIN)
    init_kw = {}
    if model_name == "aread":
        # through 'domain_mask_final', so that final_gate exists too
        from aread_tpu.models.aread import full_mask as j_full_mask
        init_kw = dict(mode="domain_mask_final", domain_mask=tuple(
            jnp.asarray(m) for m in j_full_mask(jm.n_tower)))
    # weights, statistics and a table that are not their initial values
    variables = seeded_variables(jm, jnp.asarray(data.train_x[:8]),
                                 train=False, **init_kw)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    tm = build_model(cfg, data.spec, N_DOMAIN, device="cpu")
    others = {k: v for k, v in _np_tree(state).items() if k != "batch_stats"}
    tm.load_state_dict(convert_variables(
        _np_tree(params), _np_tree(state.get("batch_stats", {})), E,
        **others))
    return jm, params, state, tm, jcfg, cfg, jspec


def _predict_per_domain(pred, x):
    """One request per domain, each through 'domain_with_mask'."""
    out = np.zeros((len(x),), np.float32)
    domain = x[:, pred.model.spec.domain_idx]
    for d in np.unique(domain):
        out[domain == d] = pred.predict(x[domain == d])
    return out


def _masks(n_tower, missing=()):
    ms = HempMaskState(n_tower, N_DOMAIN, seed=4)
    return [None if d in missing else ms.generate_mask("rand", d, 0.6)
            for d in range(N_DOMAIN)]


@pytest.mark.parametrize("model_name,d2g", [
    ("deepfm", None), ("mmoe", D2G), ("mmoe", None)],
    ids=["deepfm", "mmoe-domain2group", "mmoe-domain-fallback"])
def test_generic_predictor_matches_jax(data, model_name, d2g):
    kw = {}
    if model_name == "mmoe" and d2g is None:
        # the fallback gathers the tower of the domain itself
        kw = {"dataset_name": "none"}
    jm, params, state, tm, _, _, _ = _pair(model_name, data, **kw)
    if model_name == "mmoe" and d2g is None:
        x = data.test_x[data.test_x[:, data.spec.domain_idx] < 3][:40]
    else:
        x = data.test_x[:50]
    jp = JP.Predictor(jm, params, state, N_DOMAIN, domain2group=d2g)
    tp = Predictor(tm, N_DOMAIN, domain2group=d2g)
    for n in (1, 17, len(x)):
        got, want = tp.predict(x[:n]), jp.predict(x[:n])
        assert got.shape == want.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the port's own evaluation path on the same rows
    cfg = Config(**{**CFG_KW, "model": model_name, **kw})
    tr = Trainer(tm, cfg, N_DOMAIN, d2g)
    group = None if d2g is None else torch.tensor(
        d2g[x[:, data.spec.domain_idx]])
    if model_name == "mmoe" and d2g is None:
        group = torch.tensor(x[:, data.spec.domain_idx])
    batch = {"x": torch.tensor(x)}
    if group is not None:
        batch["group"] = group
    np.testing.assert_allclose(tp.predict(x), tr.eval_prob(batch).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("missing", [(), (2,), (0, 1, 2, 3)],
                         ids=["all_masks", "one_domain_without",
                              "no_masks_at_all"])
def test_aread_predictor_matches_jax(data, missing):
    jm, params, state, tm, _, cfg, _ = _pair("aread", data)
    masks = _masks(tm.n_tower, missing)
    dm_arg = None if len(missing) == N_DOMAIN else masks
    jp = JP.Predictor(jm, params, state, N_DOMAIN, domain_mask=dm_arg)
    tp = Predictor(tm, N_DOMAIN, domain_mask=dm_arg)
    didx = data.spec.domain_idx
    x = data.test_x[:60]
    assert len(np.unique(x[:, didx])) == N_DOMAIN
    # mixed-domain: one forward with per-example masks
    got = tp.predict(x)
    np.testing.assert_allclose(got, jp.predict(x), rtol=0, atol=1e-5)
    # ... equals one forward per domain through 'domain_with_mask'
    np.testing.assert_allclose(got, _predict_per_domain(tp, x), rtol=0,
                               atol=1e-6)
    # single-domain requests, the domain without a mask among them
    tr = AREADTrainer(tm, cfg, N_DOMAIN)
    from aread_tpu_torch.models.aread import full_mask
    for d in range(N_DOMAIN):
        xd = x[x[:, didx] == d]
        got_d = tp.predict(xd)
        np.testing.assert_allclose(got_d, jp.predict(xd), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_d, got[x[:, didx] == d], rtol=0,
                                   atol=1e-6)
        # the trainer's evaluation through that domain's mask
        dm = masks[d] if masks[d] is not None else full_mask(tm.n_tower)
        want = tr.eval_prob({"x": torch.tensor(xd)}, dm).numpy()
        np.testing.assert_allclose(got_d, want, rtol=0, atol=1e-6)


def test_bucket_equals_jax_over_a_sweep():
    assert P.BUCKETS == JP.BUCKETS == (128, 512, 2048, 8192)
    for n in list(range(1, 300)) + [511, 512, 513, 2048, 2049, 8192, 8193,
                                    16384, 16385, 50000]:
        assert P._bucket(n) == JP._bucket(n), n
    assert P._bucket(8193) == 16384


def test_input_order_empty_request_and_bad_requests(data):
    _, _, _, tm, _, _, _ = _pair("aread", data)
    tp = Predictor(tm, N_DOMAIN, domain_mask=_masks(tm.n_tower))
    x = data.test_x[:48]
    base = tp.predict(x)
    perm = np.random.default_rng(0).permutation(len(x))
    np.testing.assert_allclose(tp.predict(x[perm]), base[perm], rtol=0,
                               atol=1e-6)
    # sorted by domain (every domain's rows contiguous) gives the same rows
    order = np.argsort(x[:, data.spec.domain_idx], kind="stable")
    np.testing.assert_allclose(tp.predict(x[order]), base[order], rtol=0,
                               atol=1e-6)
    empty = tp.predict(np.zeros((0, x.shape[1]), np.int32))
    assert empty.shape == (0,) and empty.dtype == np.float32
    assert tp.predict(x[:3].tolist()).shape == (3,)  # nested lists
    with pytest.raises(ValueError, match=r"x must be \[N, "):
        tp.predict(x[:, :-1])
    bad = x[:4].copy()
    bad[2, data.spec.domain_idx] = N_DOMAIN
    with pytest.raises(ValueError, match="domain outside"):
        tp.predict(bad)


def test_predictor_owns_its_module(data):
    _, _, _, tm, _, cfg, _ = _pair("deepfm", data)
    tp = Predictor(tm, N_DOMAIN)
    assert tp.model is not tm and not tp.model.training
    assert not any(p.requires_grad for p in tp.model.parameters())
    assert all(p.requires_grad for p in tm.parameters())  # the source's stay
    x = data.test_x[:20]
    before = tp.predict(x)
    # a trainer goes on stepping the model the Predictor was made from
    tr = Trainer(tm, cfg, N_DOMAIN)
    tr.init()
    for batch, _ in zip(GlobalBatcher(data.train_x, data.train_y, 64,
                                      data.spec.domain_idx), range(3)):
        tr.step(batch)
    assert tm.training
    np.testing.assert_array_equal(tp.predict(x), before)
    assert not np.array_equal(Predictor(tm, N_DOMAIN).predict(x), before)


def test_predict_from_a_second_thread_records_no_graph(data):
    _, _, _, tm, _, _, _ = _pair("aread", data)
    tp = Predictor(tm, N_DOMAIN, domain_mask=_masks(tm.n_tower))
    seen = []
    forward = tp.model.forward

    def spy(*a, **kw):
        out = forward(*a, **kw)
        seen.append((threading.current_thread().name,
                     torch.is_inference_mode_enabled(),
                     out["prob"].is_inference(), out["prob"].requires_grad,
                     out["prob"].grad_fn))
        return out

    tp.model.forward = spy
    result = {}
    # the main thread has no inference mode on; neither has the new one
    assert not torch.is_inference_mode_enabled()
    t = threading.Thread(
        target=lambda: result.update(p=tp.predict(data.test_x[:30]),
                                     outside=torch.is_inference_mode_enabled()),
        name="request-thread")
    t.start()
    t.join()
    assert result["outside"] is False
    assert seen and all(s == ("request-thread", True, True, False, None)
                        for s in seen)
    np.testing.assert_array_equal(result["p"], tp.predict(data.test_x[:30]))


@pytest.mark.parametrize("model_name", ["deepfm", "mmoe", "aread"])
def test_jax_checkpoint_serves_through_convert_checkpoint(data, model_name,
                                                          tmp_path):
    """The whole way: the JAX package's save_checkpoint -> its
    load_checkpoint -> convert_checkpoint -> the port's save_checkpoint ->
    load_predictor, which rebuilds spec, config and model from meta.json
    (the JAX package's meta.json, with config fields the port does not
    have) and must serve what aread_tpu.serve.load_predictor serves."""
    kw = {"dataset_name": "amazon"} if model_name == "mmoe" else {}
    _serve_jax_checkpoint(data, tmp_path, model_name, **kw)


@pytest.mark.parametrize("model_name,kw", [
    ("pepnet", {"dataset_name": "amazon", "tower_dims": (16, 8)}),
    ("aread", {"base_model": "ple", "ple_n_expert_specific": 1,
               "ple_n_expert_shared": 3, "ple_expert_dims": ((16,), (8,))}),
    ("adl", {"dataset_name": "amazon", "tower_dims": (16, 8),
             "dlm_iters": 2}),
], ids=["pepnet", "aread-ple", "adl"])
def test_jax_checkpoint_of_the_zoo_serves(data, model_name, kw, tmp_path):
    """The same way for PEPNet (three towers gathered by the Amazon
    domain2group), for AREAD on a PLE base whose ple_* values are not the
    defaults (meta.json carries them and the model is rebuilt with them,
    not with the defaults) and for ADL, whose DLM cluster centres live in
    the JAX package's second collection, ``model_state``: they arrive as
    the port's ``cluster_centers`` buffer, not as the centres the port's
    seed would draw."""
    tp = _serve_jax_checkpoint(data, tmp_path, model_name, **kw)
    if model_name == "adl":
        fresh = build_model(Config(**{**CFG_KW, "model": "adl", **kw}),
                            data.spec, N_DOMAIN, device="cpu")
        assert not torch.allclose(tp.model.cluster_centers,
                                  fresh.cluster_centers)
    elif model_name == "aread":
        assert tp.model.base_model == "ple"
        cgc = tp.model.cgc_0
        assert (cgc.n_spec, cgc.n_shared) == (1, 3)
        assert tuple(tp.model.cgc_1.gates_specific.kernel.shape) == (
            tp.model.n_tower[0], 16, 4)
        assert not hasattr(tp.model, "mmoe_experts")
    else:
        assert tp.model.n_tower == 3 and tp.model.use_ppnet


def _serve_jax_checkpoint(data, tmp_path, model_name, **kw):
    jm, params, state, tm, jcfg, cfg, jspec = _pair(model_name, data, **kw)
    masks = _masks(tm.n_tower, missing=(1,)) if model_name == "aread" else None
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, params, state, opt_state={}, epoch=2,
                          best_result={"total_auc": 0.6}, domain_mask=masks,
                          spec=jspec, run_config=jcfg, n_domain=N_DOMAIN)
    jp = JP.load_predictor(jdir)
    ck = jckpt.load_checkpoint(jdir, n_domain=N_DOMAIN)
    pck = convert_checkpoint(ck, E)
    assert pck["opt_state"] == {} and pck["epoch"] == 2
    assert pck["config"]["prng_impl"] == "rbg"  # a field the port lacks
    ckpt.save_checkpoint(pdir, pck["state_dict"], pck["opt_state"],
                         epoch=pck["epoch"], best_result=pck["best_result"],
                         domain_mask=pck.get("domain_mask"),
                         spec=data.spec, run_config=cfg, n_domain=N_DOMAIN)
    # the port reads the JAX package's meta.json as its own
    meta = json.load(open(f"{jdir}/meta.json"))
    with open(f"{pdir}/meta.json", "w") as f:
        json.dump(meta, f)
    tp = load_predictor(pdir, device="cpu")
    assert type(tp.model).__name__.lower() == model_name
    assert tp.model.embedding.table.shape == tm.embedding.table.shape
    assert dataclasses.asdict(tp.model.spec)["one_hot_dims"] == \
        tuple(meta["spec"]["one_hot_dims"][:-1]) + (
            tp.model.spec.one_hot_dims[-1],)
    if model_name == "mmoe":  # amazon's map has 25 entries; 4 domains use 4
        assert tp.domain2group is not None and len(tp.domain2group) == 25
    if model_name == "aread":
        assert tp.domain_mask[1] is None and tp.domain_mask[0] is not None
    for name in state.get("model_state", {}):
        np.testing.assert_array_equal(
            tp.model.state_dict()[name].numpy(),
            np.asarray(state["model_state"][name]))
    x = data.test_x[:70]
    np.testing.assert_allclose(tp.predict(x), jp.predict(x), rtol=0,
                               atol=1e-5)
    # the weights are the converted ones, bit for bit
    for k, v in tp.model.state_dict().items():
        assert torch.equal(v, pck["state_dict"][k]), k
    return tp


def test_adl_with_eval_dlm_update_is_refused_by_both_predictors(data):
    """An ADL built with adl_eval_dlm_update moves its centres at every
    forward. The JAX Predictor applies it without a mutable collection and
    flax refuses the update; the port's Predictor refuses it by name, and
    an empty request is answered on both sides."""
    kw = dict(dataset_name="amazon", tower_dims=(16, 8),
              adl_eval_dlm_update=True)
    jm, params, state, tm, _, _, _ = _pair("adl", data, **kw)
    d2g = np.asarray(Config(**{**CFG_KW, **kw}).domain2group())
    jp = JP.Predictor(jm, params, state, N_DOMAIN, domain2group=d2g)
    tp = Predictor(tm, N_DOMAIN, domain2group=d2g)
    x = data.test_x[:10]
    assert jp.predict(x[:0]).shape == tp.predict(x[:0]).shape == (0,)
    with pytest.raises(Exception, match="model_state"):
        jp.predict(x)
    centres = tp.model.cluster_centers.clone()
    with pytest.raises(ValueError, match="adl_eval_dlm_update"):
        tp.predict(x)
    assert torch.equal(tp.model.cluster_centers, centres)


def test_load_predictor_modulo_grouping_and_missing_metadata(data, tmp_path):
    cfg = Config(**{**CFG_KW, "model": "mmoe", "dataset_name": "cloudtheme"})
    tm = build_model(cfg, data.spec, N_DOMAIN, device="cpu")
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, tm.state_dict(), {}, epoch=1, spec=data.spec,
                         run_config=cfg, n_domain=N_DOMAIN)
    tp = load_predictor(d, device="cpu")
    # no precomputed grouping for the dataset: the training CLI's modulo map
    np.testing.assert_array_equal(tp.domain2group, np.arange(N_DOMAIN) % 3)
    x = data.test_x[:20]
    want = Predictor(tm, N_DOMAIN, domain2group=np.arange(N_DOMAIN) % 3)
    np.testing.assert_array_equal(tp.predict(x), want.predict(x))
    # n_domain falls back to the dataset's domain count
    meta = json.load(open(f"{d}/meta.json"))
    assert meta["n_domain"] == N_DOMAIN
    bare = str(tmp_path / "bare")
    ckpt.save_checkpoint(bare, tm.state_dict(), {}, epoch=1)
    with pytest.raises(ValueError, match="lacks spec/config"):
        load_predictor(bare, device="cpu")
    # a bf16 checkpoint serves every product as one bf16 pass: what the
    # f32 Predictor gives inside the context, not what it gives outside
    meta["config"]["compute_dtype"] = "bfloat16"
    with open(f"{d}/meta.json", "w") as f:
        json.dump(meta, f)
    bf = load_predictor(d, device="cpu")
    assert bf.compute_dtype == "bfloat16"
    with matmul_precision_ctx("bfloat16"):
        want_bf = want.predict(x)
    np.testing.assert_array_equal(bf.predict(x), want_bf)
    gap = np.abs(bf.predict(x) - want.predict(x)).max()
    assert 0 < gap < 1e-2


def test_coerce_like_equals_jax():
    fields = {f.name: f.default for f in dataclasses.fields(Config)}
    for k, v in (("mlp_dims", [16, 8]), ("aread_tower_dims", [[8, 4], [4]]),
                 ("domain_filter", [0, 2]), ("domain_filter", None),
                 ("lr", 0.1), ("model", "aread"), ("mlp_dims", [])):
        assert P._coerce_like(fields[k], v) == JP._coerce_like(fields[k], v)
    assert P._coerce_like(fields["aread_tower_dims"], [[8, 4], [4]]) == (
        (8, 4), (4,))


def _get(url, data=None):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_server_round_trip(data):
    _, _, _, tm, _, _, _ = _pair("aread", data)
    pred = Predictor(tm, N_DOMAIN, domain_mask=_masks(tm.n_tower))
    srv = make_server(pred, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        base = f"http://{host}:{port}"
        assert _get(f"{base}/healthz") == (200, {"status": "ok"})
        for n in (1, 5, 130):  # a single-domain row, mixed, over a bucket
            x = data.train_x[:n]
            code, out = _get(f"{base}/predict",
                             json.dumps({"x": x.tolist()}).encode())
            assert code == 200 and len(out["prob"]) == n
            np.testing.assert_allclose(out["prob"], pred.predict(x), rtol=0,
                                       atol=1e-6)
        code, out = _get(f"{base}/predict",
                         json.dumps({"x": []}).encode())
        assert code == 400  # an empty list is 1-D: refused, not a crash
        assert _get(f"{base}/nothing")[0] == 404
        assert _get(f"{base}/nothing", b"{}")[0] == 404
        # malformed requests: 400 with a message, and the server lives on
        for body in (b'{"x": 3}', b'not json', b'{"y": [[1]]}',
                     json.dumps({"x": data.test_x[:2, :-1].tolist()}).encode()):
            code, out = _get(f"{base}/predict", body)
            assert code == 400 and "error" in out, body
        assert _get(f"{base}/healthz")[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
