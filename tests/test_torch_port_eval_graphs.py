"""The port's evaluation passes, loss matrix and Predictor requests through
the runner (aread_tpu_torch/train/step_graph.py ``run_eval``, ``serve``;
``Trainer.evaluate`` / ``tower_domain_losses``, ``AREADTrainer.evaluate``,
``Predictor.predict``) on the CPU, at toy sizes: 3 domains, embed 8, eval
batches of 8 * bs = 64 rows, small layers, dropout 0, weights drawn from a
seed over the JAX modules' shapes (``seeded_variables``) and carried by
convert.py.

* (a) Each evaluation body (the eval step, the streaming ``accum``, the
  loss matrix's ``all_tower_probs``; every zoo model, ADL also with
  ``eval_dlm_update``; AREAD in both modes, streaming and exact), and each
  request body (generic, AREAD single-domain and mixed) reads nothing back
  to the host and makes no tensor from host data (``NoHostTraffic``); a
  planted ``.item()`` raises by name.
* (b) The passes through the runner, eager on the CPU, against the jitted
  JAX functions on the same weights: ``Trainer.evaluate`` streaming and
  exact (DeepFM, MMoE with a domain -> group map), ``tower_domain_losses``,
  ``AREADTrainer.evaluate`` with and without ``final``, streaming and
  exact, ADL's centres after an ``eval_dlm_update`` pass against the JAX
  Trainer's ``eval_mutated_state``: metrics and centres at atol 1e-5, the
  loss matrix at atol 1e-5 (f32 forwards of two frameworks); the JAX
  ``Predictor`` at every bucket (128 to 8,192 rows and a multiple of
  8,192 above) and mode at atol 1e-5.
* (c) ``GraphChunks``' pass and request with a stand-in for the CUDA graph
  whose replay calls the captured body (``SCAN_CHUNK`` = 4 here, so a
  pass spans chunks): bitwise the eager loop (predictions, histograms,
  results, ADL's centres, served probabilities), a capture again on a new
  shape, mode or final flag, none after an in-place reload of the
  weights, a pass of one batch captured for its next pass, and a failed
  capture raising by name.
* (d) The configuration alone picks the evaluation's dispatch: eager on
  the CPU and on a mesh, graphs on one CUDA device, ``lazy_adam``
  included, through the trainer's own step runner where its steps are
  graphs too (``lazy_adam``'s are).
* (e) ``StreamingAUC.update_`` (in place) is bitwise ``update`` over
  hypothesis draws.

Every test here runs torch on one thread: the suite's workers share the
host's cores, and small tensors on many threads each spin for the rest."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import aread_tpu.train.hemp as JH
import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.data.loader import DomainBatcher as JDomainBatcher
from aread_tpu.models import build_model as j_build_model
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.serve import predictor as JP
from aread_tpu.train.trainer import split_variables
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_variables
from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.serve.predictor import BUCKETS, Predictor
from aread_tpu_torch.train import metrics as M
from aread_tpu_torch.train import step_graph
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.trainer import Trainer
from aread_tpu_torch.utils.masks import HempMaskState
from tests.test_torch_port_graphs import HostRead, StandInGraph, _stand_in
from tests.test_torch_port_trainer_graphs import (SMALL, ZOO, HostCopy,
                                                  NoHostTraffic)
from tests.test_torch_port_zoo import seeded_variables

E, N_DOMAIN, BS = 8, 3, 8
EVAL_BS = 8 * BS
D2G = np.array([0, 2, 1])
CFG_KW = {**SMALL, "bs": BS, "dropout": 0.0, "auc_bins": 512,
          "aread_tower_dims": ((8,), (8,), (4,)),
          "tower_dims": (16, 8), "n_cross_layers": 2, "att_head_num": 2}
ATOL = 1e-5
STREAMING = (False, True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    # 300 valid rows: 5 generic eval batches of 64 (the last ragged), two
    # per domain for AREAD
    return make_synthetic_data(n_rows=3000, n_domain=N_DOMAIN, vocab=100,
                               seed=3)


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def _pair(name, data, **kw):
    """(JAX model, params, state, JAX config, port config, port model) with
    the same weights, each built by its package's build_model."""
    kw = {**CFG_KW, "model": name, **kw}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jspec = JFeatureSpec(**dataclasses.asdict(data.spec))
    jm = j_build_model(jcfg, jspec, N_DOMAIN)
    x = data.train_x[:8]
    init_kw = dict(group=jnp.asarray(D2G[x[:, data.spec.domain_idx]]))
    if name == "aread":
        # through 'domain_mask_final', so that final_gate exists too
        from aread_tpu.models.aread import full_mask as j_full_mask
        init_kw = dict(mode="domain_mask_final", domain_mask=tuple(
            jnp.asarray(m) for m in j_full_mask(jm.n_tower)))
    params, state = split_variables(seeded_variables(
        jm, jnp.asarray(x), train=False, **init_kw))
    tm = build_model(cfg, data.spec, N_DOMAIN, device="cpu")
    others = {k: v for k, v in _np_tree(state).items() if k != "batch_stats"}
    tm.load_state_dict(convert_variables(
        _np_tree(params), _np_tree(state.get("batch_stats", {})), E,
        **others))
    return jm, params, state, jcfg, cfg, tm


def _trainer(name, data, d2g=D2G, **kw):
    _, _, _, _, cfg, tm = _pair(name, data, **kw)
    return Trainer(tm, cfg, N_DOMAIN, d2g)


def _masks(n_tower, seed=4):
    ms = HempMaskState(n_tower, N_DOMAIN, seed=seed)
    return [ms.generate_mask("rand", d, 0.6) for d in range(N_DOMAIN)]


def _aread(data, **kw):
    tm = _pair("aread", data, **kw)[-1]
    tr = AREADTrainer(tm, Config(**{**CFG_KW, "model": "aread", **kw}),
                      N_DOMAIN)
    tr.mask_state.domain_mask = _masks(tm.n_tower)
    return tr


def _eval_batcher(data, cls=DomainBatcher):
    return cls(data.valid_x, data.valid_y, EVAL_BS, data.spec.domain_idx,
               N_DOMAIN, shuffle=False, seed=0)


def _staged_body(owner, ev, feeds, masks=None):
    """What a capture records: ``GraphChunks``' body of the pass ``ev``,
    its first batches staged as a pass stages them."""
    g = step_graph.GraphChunks(owner)
    masks = [None] * len(feeds) if masks is None else masks
    key = g.eval_key(ev, feeds[0], masks[0])
    buf = g.eval_buffers(key, ev, feeds[0], masks[0])
    buf["n"] = len(feeds)
    g.stage_eval(buf, feeds, masks)
    return g.eval_body(ev, buf), buf


# ----------------------------------------------- (a) nothing host-bound
def _pass_ran(buf, n, kind):
    assert int(buf["i"]) == int(buf["o"]) == n
    if kind != "accum":
        assert torch.isfinite(buf["out"][:n]).all()


@pytest.mark.parametrize("kind", ["eval_step", "accum", "all_tower_probs"])
@pytest.mark.parametrize("name", ZOO)
def test_generic_eval_bodies_read_and_copy_nothing(data, name, kind):
    tr = _trainer(name, data)
    feeds = tr.eval_batches(data.valid_x, data.valid_y)[:2]
    ev = tr.eval_pass(kind)
    body, buf = _staged_body(tr, ev, feeds)
    with NoHostTraffic():
        body()
        body()
    _pass_ran(buf, 2, kind)
    if kind == "accum":
        assert float(tr._auc_state["count"].sum()) == 2 * EVAL_BS


def test_adl_eval_update_body_moves_centres_without_host_traffic(data):
    tr = _trainer("adl", data, adl_eval_dlm_update=True)
    assert tr.model.eval_dlm_update
    before = tr.model.cluster_centers.clone()
    feeds = tr.eval_batches(data.valid_x, data.valid_y)[:2]
    body, _ = _staged_body(tr, tr.eval_pass("eval_step"), feeds)
    with NoHostTraffic():
        body()
    assert not torch.equal(tr.model.cluster_centers, before)


@pytest.mark.parametrize("streaming", STREAMING, ids=["exact", "streaming"])
@pytest.mark.parametrize("final", [False, True], ids=["masked", "final"])
def test_aread_eval_bodies_read_and_copy_nothing(data, final, streaming,
                                                 monkeypatch):
    tr = _aread(data)
    feeds, masks = tr.eval_batches(_eval_batcher(data))
    body, buf = _staged_body(tr, tr.eval_pass(final, streaming),
                             feeds[:2], masks[:2])
    with NoHostTraffic():
        body()
        body()
    _pass_ran(buf, 2, "accum" if streaming else "eval_prob")
    # a host read planted in the forward is caught, by name
    forward = tr.model.forward

    def planted(*a, **kw):
        out = forward(*a, **kw)
        out["prob"].sum().item()
        return out

    monkeypatch.setattr(tr.model, "forward", planted)
    with pytest.raises(HostRead, match="_local_scalar_dense"):
        with NoHostTraffic():
            body()


def _predictors(data):
    """{mode: (Predictor, a request of that mode)} of the three modes."""
    aread = _pair("aread", data)[-1]
    masks = _masks(aread.n_tower)
    x = data.test_x[:50]
    single = x.copy()
    single[:, data.spec.domain_idx] = 1
    return {"generic": (Predictor(_pair("mmoe", data)[-1], N_DOMAIN,
                                  domain2group=D2G), x),
            "single": (Predictor(aread, N_DOMAIN, domain_mask=masks), single),
            "mixed": (Predictor(aread, N_DOMAIN, domain_mask=masks), x)}


def test_request_bodies_read_and_copy_nothing(data, monkeypatch):
    for mode, (pred, x) in _predictors(data).items():
        assert pred.mode_of(x) == mode
        xb = np.zeros((BUCKETS[0], x.shape[1]), np.int32)
        xb[:len(x)] = x
        buf = {"x": torch.tensor(xb)}
        body = step_graph.GraphChunks.serve_body(pred.request(mode), buf)
        with torch.inference_mode(), NoHostTraffic():
            body()
        np.testing.assert_array_equal(buf["out"][:len(x)].numpy(),
                                      pred.predict(x))
    # a tensor made from host data in the body is caught, by name
    forward = pred._forward

    def planted(mode, xb):
        torch.as_tensor(np.ones(2), device=xb.device)
        return forward(mode, xb)

    monkeypatch.setattr(pred, "_forward", planted)
    body = step_graph.GraphChunks.serve_body(pred.request("mixed"), buf)
    with pytest.raises(HostCopy, match="lift_fresh"):
        with torch.inference_mode(), NoHostTraffic():
            body()


# --------------------------------------------------- (b) against JAX
def _close(a, b, name, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol,
                               err_msg=name)


def _results_close(got, want):
    assert set(got) == set(want)
    for k in ("total_auc", "total_loss", "mean_auc", "mean_loss"):
        _close(got[k], want[k], k)
    for k in ("domain_auc", "domain_loss"):
        assert set(got[k]) == set(want[k])
        _close([got[k][d] for d in sorted(got[k])],
               [want[k][d] for d in sorted(want[k])], k)


@pytest.mark.parametrize("streaming", STREAMING, ids=["exact", "streaming"])
@pytest.mark.parametrize("name,d2g", [("deepfm", None), ("mmoe", D2G)])
def test_trainer_evaluate_matches_jax(data, name, d2g, streaming):
    kw = dict(streaming_eval=streaming)
    jm, params, state, jcfg, cfg, tm = _pair(name, data, **kw)
    jt = JT.Trainer(jm, jcfg, N_DOMAIN, d2g)
    want = jt.evaluate(params, state, data.valid_x, data.valid_y,
                       data.domain_cnt_weight)
    tr = Trainer(tm, cfg, N_DOMAIN, d2g)
    got = tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
    assert tr.evals.name == "eager"
    _results_close(got, want)


def test_loss_matrix_matches_jax(data):
    jm, params, state, jcfg, cfg, tm = _pair("mmoe", data)
    want = JT.Trainer(jm, jcfg, N_DOMAIN, D2G).tower_domain_losses(
        params, state, data.valid_x, data.valid_y)
    got = Trainer(tm, cfg, N_DOMAIN, D2G).tower_domain_losses(
        data.valid_x, data.valid_y)
    assert got.shape == want.shape == (3, N_DOMAIN)
    _close(got, want, "loss matrix")


@pytest.mark.parametrize("streaming", STREAMING, ids=["exact", "streaming"])
def test_adl_eval_update_centres_match_jax(data, streaming):
    kw = dict(adl_eval_dlm_update=True, streaming_eval=streaming)
    jm, params, state, jcfg, cfg, tm = _pair("adl", data, **kw)
    jt = JT.Trainer(jm, jcfg, N_DOMAIN, D2G)
    want = jt.evaluate(params, state, data.valid_x, data.valid_y,
                       data.domain_cnt_weight)
    tr = Trainer(tm, cfg, N_DOMAIN, D2G)
    before = tr.model.cluster_centers.clone()
    got = tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
    _close(tr.model.cluster_centers.numpy(),
           jt.eval_mutated_state["model_state"]["cluster_centers"], "centres")
    assert not torch.equal(tr.model.cluster_centers, before)
    for k in ("total_auc", "total_loss"):
        _close(got[k], want[k], k)


@pytest.fixture(scope="module")
def aread_jax(data):
    jm, params, state, jcfg, _, _ = _pair("aread", data)
    jt = JH.AREADTrainer(jm, jcfg, N_DOMAIN)
    return jt, params, state


@pytest.mark.parametrize("streaming", STREAMING, ids=["exact", "streaming"])
@pytest.mark.parametrize("final", [False, True], ids=["masked", "final"])
def test_aread_evaluate_matches_jax(data, aread_jax, final, streaming):
    jt, params, state = aread_jax
    jt.config = dataclasses.replace(jt.config, streaming_eval=streaming)
    tr = _aread(data, streaming_eval=streaming)
    jt.mask_state.domain_mask = [list(m) for m in tr.mask_state.domain_mask]
    want = jt.evaluate(params, state, _eval_batcher(data, JDomainBatcher),
                       data.domain_cnt_weight, final=final)
    got = tr.evaluate(_eval_batcher(data), data.domain_cnt_weight,
                      final=final)
    _results_close(got, want)


@pytest.fixture(scope="module")
def predictor_pairs(data):
    """Per mode (the JAX Predictor, the port's, rows of that mode)."""
    out = {}
    for mode, name, kw in (("generic", "mmoe", dict(domain2group=D2G)),
                           ("single", "aread", {}), ("mixed", "aread", {})):
        jm, params, state, _, _, tm = _pair(name, data)
        if name == "aread":
            kw = dict(domain_mask=_masks(tm.n_tower))
        x = data.test_x
        if mode == "single":
            x = x.copy()
            x[:, data.spec.domain_idx] = 2
        out[mode] = (JP.Predictor(jm, params, state, N_DOMAIN, **kw),
                     Predictor(tm, N_DOMAIN, **kw), x)
    return out


@pytest.mark.parametrize("rows", BUCKETS + (BUCKETS[-1] + 1,))
@pytest.mark.parametrize("mode", ["generic", "single", "mixed"])
def test_predictor_matches_jax_at_every_bucket_and_mode(predictor_pairs,
                                                        mode, rows):
    jp, tp, x = predictor_pairs[mode]
    x = np.resize(x, (rows, x.shape[1]))
    assert tp.mode_of(x) == mode
    got = tp.predict(x)
    assert got.shape == (rows,) and got.dtype == np.float32
    _close(got, jp.predict(x), f"{mode} request of {rows} rows")


# -------------------------------------- (c) the graph runner's bookkeeping
@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA graph's stand-in (no step counter, no launch planted) and
    passes of ``SCAN_CHUNK`` = 4 batches a chunk."""
    _stand_in(monkeypatch, lambda: [], planted_launches=0)
    monkeypatch.setattr(step_graph, "SCAN_CHUNK", 4)
    return monkeypatch


def _graph_runner(owner):
    owner._evals = step_graph.GraphChunks(owner)
    return owner._evals


def _bits(x):
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b or (a != a and b != b)


def _aread_pass(tr, data, final, streaming):
    """(result, the streaming pass's histograms) of one pass."""
    tr.config = dataclasses.replace(tr.config, streaming_eval=streaming)
    res = tr.evaluate(_eval_batcher(data), data.domain_cnt_weight,
                      final=final)
    return res, _bits(tr._auc_state) if streaming else None


def test_graph_eval_pass_matches_the_eager_loop(data, stand_in):
    trs = {"graph": _aread(data), "eager": _aread(data)}
    g = _graph_runner(trs["graph"])
    assert isinstance(trs["eager"].evals, step_graph.EagerChunks)
    n = len(trs["eager"].eval_batches(_eval_batcher(data))[0])
    assert n > step_graph.SCAN_CHUNK  # a pass spans chunks
    made = 0
    for final in (False, True):
        for streaming in STREAMING:
            out = {k: _aread_pass(t, data, final, streaming)
                   for k, t in trs.items()}
            made += 1
            assert len(StandInGraph.made) == made == g.eval_captures
            assert _same(out["graph"][0], out["eager"][0])
            if streaming:
                assert _same(out["graph"][1], out["eager"][1])
            # the same pass again: replays only
            assert _same(_aread_pass(trs["graph"], data, final, streaming)[0],
                         out["graph"][0])
            assert len(StandInGraph.made) == made
    assert g.captures == 0 and all(gr.generators == []
                                   for gr in StandInGraph.made)
    # the exact pass's predictions, bitwise, from the static output
    tr = trs["graph"]
    tr.config = dataclasses.replace(tr.config, streaming_eval=False)
    feeds, masks = tr.eval_batches(_eval_batcher(data))
    got = g.run_eval(tr.eval_pass(), feeds, masks)
    want = trs["eager"].evals.run_eval(trs["eager"].eval_pass(), feeds, masks)
    assert got.shape == (n, EVAL_BS) and torch.equal(got, want)
    # weights reloaded in place (_load_best, _restore): no new capture,
    # and the pass follows them
    snap = tr._snapshot()
    with torch.no_grad():
        tr.model.embedding.table.mul_(0.5)
    moved = tr.evaluate(_eval_batcher(data), data.domain_cnt_weight)
    tr._restore(snap)
    back = tr.evaluate(_eval_batcher(data), data.domain_cnt_weight)
    assert len(StandInGraph.made) == made
    assert moved["total_loss"] != back["total_loss"]
    assert _same(back, _aread_pass(trs["eager"], data, False, False)[0])
    # a new batch shape: captured again
    small = DomainBatcher(data.valid_x, data.valid_y, EVAL_BS // 2,
                          data.spec.domain_idx, N_DOMAIN, shuffle=False)
    tr.evaluate(small, data.domain_cnt_weight)
    assert len(StandInGraph.made) == made + 1

    # a capture that fails raises by name; nothing falls back
    def broken(graph, pool, fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    stand_in.setattr(step_graph, "capture", broken)
    g.graphs.clear()
    with pytest.raises(RuntimeError, match="capturing the AREAD "
                       "domain_with_mask evaluation into a CUDA graph"):
        tr.evaluate(_eval_batcher(data), data.domain_cnt_weight)


@pytest.mark.parametrize("name", ["deepfm", "mmoe", "adl"])
def test_graph_generic_passes_match_the_eager_loop(data, stand_in, name):
    kw = dict(adl_eval_dlm_update=True) if name == "adl" else {}
    trs = {k: _trainer(name, data, **kw) for k in ("graph", "eager")}
    g = _graph_runner(trs["graph"])
    out = {}
    for k, tr in trs.items():
        res = [tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)]
        tr.config = dataclasses.replace(tr.config, streaming_eval=True)
        res.append(tr.evaluate(data.valid_x, data.valid_y,
                               data.domain_cnt_weight))
        res.append(_bits(tr._auc_state))
        res.append(tr.tower_domain_losses(data.valid_x, data.valid_y))
        res.append(_bits(tr.model.state_dict()))
        out[k] = res
    for a, b in zip(out["graph"][:-2], out["eager"][:-2]):
        assert _same(a, b)
    np.testing.assert_array_equal(out["graph"][-2], out["eager"][-2])
    assert _same(out["graph"][-1], out["eager"][-1])
    assert g.eval_captures == 3 and len(StandInGraph.made) == 3
    if name == "adl":
        # ADL's centres moved over three passes, bitwise the eager ones;
        # the flag keys the graph: without it, another capture
        trs["graph"].model.eval_dlm_update = False
        trs["graph"].evaluate(data.valid_x, data.valid_y,
                              data.domain_cnt_weight)
        assert g.eval_captures == 4


def test_short_pass_captures_for_its_next_pass(data, stand_in):
    """A pass of no more batches than the recipe's eager ones (one batch
    here) captures after them, so that the next pass replays: no pass
    length keeps the card on the eager loop."""
    trs = {k: _trainer("mmoe", data) for k in ("graph", "eager")}
    g = _graph_runner(trs["graph"])
    x, y = data.valid_x[:EVAL_BS], data.valid_y[:EVAL_BS]
    assert len(trs["graph"].eval_batches(x, y)) == 1
    runs = []

    def replay(self, real=StandInGraph.replay):
        runs.append(self)
        real(self)

    stand_in.setattr(StandInGraph, "replay", replay)
    for _ in range(2):
        got = trs["graph"].tower_domain_losses(x, y)
        np.testing.assert_array_equal(
            got, trs["eager"].tower_domain_losses(x, y))
    assert g.eval_captures == len(StandInGraph.made) == 1
    assert runs == StandInGraph.made  # the second pass, one replay


def test_graph_requests_match_the_eager_predictor(data, stand_in):
    for mode, (pred, x) in _predictors(data).items():
        eager = Predictor(pred.model, N_DOMAIN,
                          domain_mask=pred.domain_mask,
                          domain2group=pred.domain2group)
        assert isinstance(eager.evals, step_graph.EagerChunks)
        g = _graph_runner(pred)
        for n in (len(x), 7, len(x), 200):
            got = pred.predict(x[:n] if n <= len(x) else np.resize(
                x, (n, x.shape[1])))
            want = eager.predict(x[:n] if n <= len(x) else np.resize(
                x, (n, x.shape[1])))
            np.testing.assert_array_equal(got, want)
        # one capture a (mode, bucket): 128 and 512 rows
        assert g.eval_captures == 2
        assert sorted(g.graphs) == [f"serve {mode} [{b}, {x.shape[1]}]"
                                    for b in (128, 512)]
        StandInGraph.made = []

    def broken(graph, pool, fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    stand_in.setattr(step_graph, "capture", broken)
    with pytest.raises(RuntimeError,
                       match="capturing the mixed request into a CUDA graph"):
        pred.predict(np.resize(x, (600, x.shape[1])))


# ------------------------------------------------------ (d) the dispatch
def test_eval_dispatch_follows_the_configuration(data, monkeypatch):
    tr = _aread(data, table_optimizer="lazy_adam")
    gen = _trainer("deepfm", data)
    pred = Predictor(_pair("deepfm", data)[-1], N_DOMAIN)
    for owner in (tr, gen, pred):
        assert isinstance(owner.evals, step_graph.EagerChunks)
    monkeypatch.setattr(tr, "device", torch.device("cuda"))
    monkeypatch.setattr(gen, "device", torch.device("cuda"))
    monkeypatch.setattr(pred, "device", torch.device("cuda"))
    # lazy_adam steps and evaluates by graphs on a card, through one runner
    assert isinstance(step_graph.make_chunks(tr), step_graph.GraphChunks)
    assert isinstance(step_graph.make_evals(tr), step_graph.GraphChunks)
    tr._chunks = tr._evals = None
    assert tr.evals is tr.chunks
    assert isinstance(step_graph.make_evals(pred), step_graph.GraphChunks)
    # graph steps: the evaluation shares the step runner (one pool)
    gen._chunks = gen._evals = None
    assert gen.evals is gen.chunks
    assert isinstance(gen.evals, step_graph.GraphChunks)
    # a new optimizer state drops both
    gen.init()
    assert gen._evals is None and gen._chunks is None
    for owner in (tr, gen):
        monkeypatch.setattr(owner, "mesh", object())
        assert isinstance(step_graph.make_evals(owner),
                          step_graph.EagerChunks)


# ------------------------------------------- (e) the in-place histograms
@settings(max_examples=40, deadline=None)
@given(n_domain=st.integers(1, 5), n_bins=st.sampled_from([1, 7, 64, 1024]),
       b=st.integers(1, 96), seed=st.integers(0, 2**31 - 1),
       with_logits=st.booleans(), with_valid=st.booleans(),
       steps=st.integers(1, 3))
def test_in_place_update_is_bitwise_the_functional_one(
        n_domain, n_bins, b, seed, with_logits, with_valid, steps):
    rng = np.random.default_rng(seed)
    acc = M.StreamingAUC(n_domain, n_bins)
    fun = acc.init_state()
    inplace = acc.reset_state(None)
    kept = inplace["pos"]
    for _ in range(steps):
        logits = torch.tensor(rng.standard_normal(b).astype(np.float32)
                              * rng.choice([1.0, 8.0, 40.0]))
        probs = torch.sigmoid(logits)
        targets = torch.tensor((rng.random(b) < 0.3).astype(np.float32))
        domains = torch.tensor(rng.integers(0, n_domain, b).astype(np.int32))
        valid = (torch.tensor((rng.random(b) < 0.8).astype(np.float32))
                 if with_valid else None)
        kw = dict(logits=logits) if with_logits else {}
        fun = acc.update(fun, probs, targets, domains, valid, **kw)
        acc.update_(inplace, probs, targets, domains, valid, **kw)
    assert inplace["pos"] is kept
    for k in fun:
        assert fun[k].dtype == inplace[k].dtype == torch.float32
        assert torch.equal(fun[k].view(torch.int32),
                           inplace[k].view(torch.int32)), k
    # zeroed in place for the next pass
    assert acc.reset_state(inplace) is inplace
    assert all(float(v.abs().sum()) == 0.0 for v in inplace.values())
    assert acc.reset_state(M.StreamingAUC(n_domain, n_bins + 1).init_state()
                           )["pos"].shape == (n_domain, n_bins)
