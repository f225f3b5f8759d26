"""``table_optimizer='lazy_adam'`` and MAMDR's Reptile meta-trainer on the
port's graph dispatch (aread_tpu_torch/ops/sparse_adam.py
``lazy_sparse_adam_``, train/trainer.py ``hybrid_reset_``,
train/step_graph.py ``graph_dispatch``, train/mamdr.py), on the CPU at toy
sizes: 3 domains, embed 8, small layers.

* (a) ``lazy_sparse_adam_`` in its static shape reads nothing back to the
  host and, fed the step's scalar block, makes no tensor from host data;
  neither does a captured AREAD or DeepFM step under ``lazy_adam``.
* (b) It is bitwise the boolean-index form it replaces (copied here as it
  was) over hypothesis draws: f32 and bf16 tables, f32 and bf16 moments,
  row ``n_rows - 1`` live or not, duplicate-free sentinel tails of every
  length (all entries sentinels too), with and without the block, and the
  dispatch's ``want_l2`` sum; and it matches the JAX package's
  ``_lazy_sparse_adam`` at ``test_torch_port_hemp.py``'s tolerances
  (touched rows atol 1e-6 with f32 moments, one bf16 ulp of their size
  with bf16 ones; untouched rows bitwise).
* (c) ``hybrid_reset_`` puts a stepped state back to bitwise a fresh
  ``hybrid_init``'s, every tensor the same object.
* (d) ``GraphChunks`` with a stand-in for the CUDA graph whose replay
  calls the captured body (``SCAN_CHUNK`` = 4): under ``lazy_adam`` the
  AREAD warm-up, bagging and final steps, a full-sweep HEMP regroup and a
  DeepFM ``Trainer.fit`` are bitwise their eager loops (weights,
  statistics, Adam state, counters, the dropout generator, masks, probe
  losses, results); ``MamdrTrainer.fit`` over two epochs is bitwise its
  eager twin (meta and every domain's weights, history, test result) with
  one step capture for the whole fit, and its graphed fit matches the
  JAX ``MamdrTrainer`` at ``test_torch_port_mamdr.py``'s tolerance (atol
  1e-4).

Every test here runs torch on one thread: the suite's workers share the
host's cores, and small tensors on many threads each spin for the rest."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import aread_tpu.train.trainer as JT
from aread_tpu.data.loader import SplitData as JSplitData
from aread_tpu.ops.sparse_adam import _lazy_sparse_adam
from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.ops import cuda as cuda_ops
from aread_tpu_torch.ops.rounding import sround
from aread_tpu_torch.ops.sparse_adam import (_row_flat_index, adam_scalars,
                                             lazy_sparse_adam_,
                                             sparse_adam_dispatch,
                                             step_scalars)
from aread_tpu_torch.train import mamdr as M
from aread_tpu_torch.train import step_graph
from aread_tpu_torch.train import trainer as T
from aread_tpu_torch.train.mamdr import MamdrTrainer
from aread_tpu_torch.train.trainer import hybrid_init, hybrid_reset_
from tests import test_torch_port_graphs as G
from tests import test_torch_port_trainer_graphs as TG
from tests.test_torch_port_graphs import NoHostReads, StandInGraph
from tests.test_torch_port_mamdr import CFG as MAMDR_CFG
from tests.test_torch_port_mamdr import _as_port, _close_weights, _pair
from tests.test_torch_port_trainer import jax_true_zero  # noqa: F401
from tests.test_torch_port_trainer_graphs import NoHostTraffic

S = 4  # SCAN_CHUNK in the runner tests
LAZY_KW = dict(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8,
               l2=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def boolean_index_lazy_adam_(w, m, v, uids, gsum, t, lr, b1=0.9, b2=0.99,
                             eps=1e-8, weight_decay=1e-8, l2=0.0,
                             sr_seed=None):
    """``lazy_sparse_adam_`` as it was before its static shape: the live
    entries picked by a boolean index (a host read on a card)."""
    n_rows, d = w.shape
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    b1c = torch.tensor(s["b1c"], dtype=torch.float32, device=w.device)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32, device=w.device)
    live = uids < n_rows
    rows = uids[live].to(torch.int64)
    wf = w[rows].to(torch.float32)
    g = gsum[live] + s["decay"] * wf
    m2 = s["b1"] * m[rows].to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v[rows].to(torch.float32) + s["omb2"] * g * g
    w2 = wf - s["lr"] * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
    w[rows] = sround(w2, w.dtype, _row_flat_index(rows, d),
                     t if sr_seed is None else sr_seed)
    m[rows] = m2.to(m.dtype)
    v[rows] = v2.to(v.dtype)


def _raw(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(_raw(a), _raw(b))


def _table(rng, n_rows, d, wdt, mdt):
    w = torch.tensor(rng.standard_normal((n_rows, d)), dtype=torch.float32)
    m = torch.tensor(0.1 * rng.standard_normal((n_rows, d)),
                     dtype=torch.float32)
    v = torch.tensor(0.01 * rng.random((n_rows, d)), dtype=torch.float32)
    return w.to(wdt), m.to(mdt), v.to(mdt)


def _uids(rng, n_rows, n_live, n_sentinel, last_live):
    """``dedup_rows``-shaped ids: ``n_live`` (at most ``n_rows``) sorted
    unique rows, the last row among them with ``last_live``, then
    ``n_sentinel`` sentinels. Returns (uids, the live count)."""
    n_live = min(n_live, n_rows)
    if last_live and n_live:
        live = np.append(rng.choice(n_rows - 1, size=n_live - 1,
                                    replace=False), n_rows - 1)
    else:
        live = rng.choice(n_rows - 1 + (n_live == n_rows), size=n_live,
                          replace=False)
    live = np.sort(live).astype(np.int32)
    return torch.tensor(np.concatenate(
        [live, np.full(n_sentinel, n_rows, np.int32)])), n_live


# ------------------------------------------------------ (a) no host reads
def test_lazy_update_reads_nothing_back_to_the_host():
    rng = np.random.default_rng(0)
    w, m, v = _table(rng, 40, 8, torch.bfloat16, torch.bfloat16)
    uids, _ = _uids(rng, 40, 9, 5, True)
    gsum = torch.randn((len(uids), 8))
    block = torch.from_numpy(step_scalars(3, LAZY_KW["lr"]))
    with NoHostTraffic():
        lazy_sparse_adam_(w, m, v, uids, gsum, 3, scalars=block, **LAZY_KW)
        l2 = sparse_adam_dispatch(w, m, v, uids, gsum, 4, want_l2=True,
                                  lazy=True, scalars=block, **LAZY_KW)
    with NoHostReads():
        lazy_sparse_adam_(w, m, v, uids, gsum, 5, **LAZY_KW)
    assert np.isfinite(float(l2))
    # the form it replaces reads the live count back
    with pytest.raises(G.HostRead, match="boolean mask"):
        with NoHostReads():
            boolean_index_lazy_adam_(w, m, v, uids, gsum, 6, **LAZY_KW)


def test_captured_lazy_steps_read_nothing_back_to_the_host():
    data = G._data()
    tr = G._trainer(data.spec.with_flat_table(G.E),
                    table_optimizer="lazy_adam", loss_report_table_l2=True)
    table = tr.model.embedding.table.clone()
    with NoHostReads():
        outs = G._three_kinds(tr, data)
    assert all(np.isfinite(float(loss)) for loss, _ in outs)
    assert tr.opt_state["t"] == 2 and not torch.equal(
        table, tr.model.embedding.table)
    tdata = TG._data()
    gen = TG._zoo_trainer(tdata, "deepfm", True, table_optimizer="lazy_adam")
    body, buf = TG._captured_body(gen, TG._feeds(tdata, False)[:2])
    with NoHostTraffic():
        body()
        body()
    assert gen.opt_state["t"] == 2 and torch.isfinite(buf["loss"][:2]).all()


# ------------------------------------- (b) the form it replaces, and JAX
@settings(max_examples=60, deadline=None)
@given(n_rows=st.integers(1, 48), d=st.integers(1, 9),
       wdt=st.sampled_from([torch.float32, torch.bfloat16]),
       mdt=st.sampled_from([torch.float32, torch.bfloat16]),
       n_live=st.integers(0, 24), n_sentinel=st.integers(0, 24),
       last_live=st.booleans(), t=st.integers(1, 2000),
       sr_seed=st.one_of(st.none(), st.integers(0, 2**32 - 1)),
       block=st.booleans(), want_l2=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_static_form_is_bitwise_the_boolean_index_form(
        n_rows, d, wdt, mdt, n_live, n_sentinel, last_live, t, sr_seed,
        block, want_l2, seed):
    rng = np.random.default_rng(seed)
    if min(n_live, n_rows) + n_sentinel == 0:
        n_sentinel = 1
    uids, n_live = _uids(rng, n_rows, n_live, n_sentinel, last_live)
    # every row live takes the last one too
    assert bool((uids[:n_live] == n_rows - 1).any()) == (
        (last_live and n_live > 0) or n_live == n_rows)
    gsum = torch.tensor(rng.standard_normal((len(uids), d)),
                        dtype=torch.float32)
    gsum[n_live:] = 0.0  # dedup_rows' sentinel entries
    want = _table(rng, n_rows, d, wdt, mdt)
    got = [x.clone() for x in want]
    ids = [x.data_ptr() for x in got]
    l2_want = torch.sum(torch.square(want[0].to(torch.float32)))
    boolean_index_lazy_adam_(*want, uids, gsum, t, sr_seed=sr_seed,
                             **LAZY_KW)
    scalars = (torch.from_numpy(step_scalars(t, LAZY_KW["lr"],
                                             sr_seed=sr_seed))
               if block else None)
    # with a block, t, lr and sr_seed beside it are not read
    kw = dict(LAZY_KW, lr=9.0) if block else LAZY_KW
    l2 = sparse_adam_dispatch(*got, uids, gsum, t + 7 if block else t,
                              want_l2=want_l2, lazy=True,
                              sr_seed=None if block else sr_seed,
                              scalars=scalars, **kw)
    for name, a, b in zip("wmv", got, want):
        assert _bitwise(a, b), name
    assert [x.data_ptr() for x in got] == ids
    if want_l2:
        assert _bitwise(l2, l2_want)
    else:
        assert l2 is None


@pytest.mark.parametrize("case", ["sentinels", "last_row_live",
                                  "all_sentinels"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_static_form_matches_jax(moments, case):
    rng = np.random.default_rng(1)
    n_rows, d, K = 96, 8, 40
    w = rng.standard_normal((n_rows, d)).astype(np.float32)
    m = (0.1 * rng.standard_normal((n_rows, d))).astype(np.float32)
    v = (0.01 * rng.random((n_rows, d))).astype(np.float32)
    n_live = {"sentinels": 25, "last_row_live": 25, "all_sentinels": 0}[case]
    uids, _ = _uids(rng, n_rows, n_live, K - n_live,
                    case == "last_row_live")
    gsum = torch.tensor(rng.standard_normal((K, d)), dtype=torch.float32)
    gsum[n_live:] = 0.0
    mdt = getattr(torch, moments)
    tw, tm_, tv = torch.tensor(w), torch.tensor(m).to(mdt), \
        torch.tensor(v).to(mdt)
    m0, v0 = tm_.clone(), tv.clone()
    jw, jm_, jv = _lazy_sparse_adam(
        jnp.asarray(w), jnp.asarray(m0.float().numpy()).astype(moments),
        jnp.asarray(v0.float().numpy()).astype(moments),
        jnp.asarray(uids.numpy()), jnp.asarray(gsum.numpy()), jnp.int32(3),
        table_shape=(n_rows, d), **LAZY_KW)
    lazy_sparse_adam_(tw, tm_, tv, uids, gsum, 3, **LAZY_KW)
    touched = np.zeros(n_rows, bool)
    touched[uids.numpy()[:n_live]] = True
    assert touched[-1] == (case == "last_row_live")
    np.testing.assert_array_equal(tw.numpy()[~touched], w[~touched])
    assert torch.equal(tm_[~touched], m0[~touched])
    assert torch.equal(tv[~touched], v0[~touched])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    atol = 1e-6 if moments == "float32" else 2.0 ** -8
    for got, want in ((tm_, jm_), (tv, jv)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            rtol=atol if moments == "bfloat16" else 0, atol=atol)


# ------------------------------------------------ (c) the in-place reset
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reset_is_bitwise_a_fresh_state_in_the_same_tensors(dtype):
    data = make_synthetic_data(n_rows=600, n_domain=3, vocab=50, seed=6)
    cfg = Config(**{**MAMDR_CFG, "table_dtype": dtype,
                    "table_moments_dtype": "float32"})
    tr = MamdrTrainer(build_model(cfg, data.spec, 3, device="cpu"), cfg, 3)
    b = DomainBatcher(data.train_x, data.train_y, cfg.bs,
                      data.spec.domain_idx, 3, seed=0)
    tr.train_from(tr.live_weights(), b, [0, 1, 2])
    st = tr.opt_state
    assert st["t"] == st["inner"]["count"] == 3
    assert st["m"].dtype == getattr(torch, dtype)  # the table's, as JAX's

    def tensors(s):
        return [s["m"], s["v"]] + [x for k in ("mu", "nu")
                                   for x in s["inner"][k].values()]

    ids = [id(x) for x in tensors(st)]
    assert any(bool(x.abs().sum() > 0) for x in tensors(st))
    assert hybrid_reset_(st) is st
    fresh = hybrid_init(tr.optimizer, tr.model)
    assert st["t"] == st["inner"]["count"] == 0 == fresh["t"]
    assert [id(x) for x in tensors(st)] == ids
    assert list(st["inner"]["mu"]) == list(fresh["inner"]["mu"])
    for x, y in zip(tensors(st), tensors(fresh)):
        assert x.shape == y.shape and _bitwise(x, y)
    # and the next sequence reuses it
    tr.train_from(tr.live_weights(), b, [1])
    assert tr.opt_state is st and st["t"] == 1


# ---------------------------------------------- (d) graphs and eager loops
def _graph_dispatch(monkeypatch, graph_tr, counters):
    """The stand-in graph (``test_torch_port_graphs._stand_in``, no
    planted launch: the lazy update launches no kernel) with ``graph_tr``
    (and no other trainer) dispatching steps and evaluation by graphs;
    ``SCAN_CHUNK`` = 4."""
    G._stand_in(monkeypatch, counters, planted_launches=0)
    monkeypatch.setattr(step_graph, "graph_dispatch",
                        lambda tr: tr is graph_tr)
    monkeypatch.setattr(step_graph, "eval_dispatch",
                        lambda tr: tr is graph_tr)
    for mod in (step_graph, T, M):
        monkeypatch.setattr(mod, "SCAN_CHUNK", S)
    cuda_ops.reset_launch_counts()


def _opt_bits(st):
    return ([st["m"], st["v"]] + list(st["inner"]["mu"].values())
            + list(st["inner"]["nu"].values()))


def _same_trainers(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad = [k for k in sa if not _bitwise(sa[k], sb[k])]
    bad += [i for i, (x, y) in enumerate(zip(_opt_bits(a.opt_state),
                                             _opt_bits(b.opt_state)))
            if not _bitwise(x, y)]
    assert not bad, bad
    assert a.opt_state["t"] == b.opt_state["t"]
    assert a.opt_state["inner"]["count"] == b.opt_state["inner"]["count"]
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _aread_twins():
    data = G._data()
    spec = dataclasses.replace(data.spec.with_flat_table(G.E),
                               table_dtype="bfloat16")
    kw = dict(table_optimizer="lazy_adam", table_dtype="bfloat16",
              table_moments_dtype="bfloat16", regroup_update_step=2,
              regroup_eval_step=2, candidate_mask_num=3)
    trs = {k: G._trainer(spec, **kw) for k in ("graph", "eager")}
    trs["graph"].model.load_state_dict(trs["eager"].model.state_dict())
    return data, trs


def test_aread_lazy_steps_and_chains_by_graph_are_the_eager_loop(
        monkeypatch):
    data, trs = _aread_twins()
    gt = trs["graph"]
    finals = {k: t.final_optimizer.init(
        {"final_gate/kernel": t.model.final_gate.kernel})
        for k, t in trs.items()}

    def counters():
        st, fast = gt.opt_state, gt._fast_state
        return ([(st, "t"), (st["inner"], "count"), (finals["graph"], "count")]
                + ([] if fast is None else
                   [(fast, "t"), (fast["inner"], "count")]))

    _graph_dispatch(monkeypatch, gt, counters)
    assert gt.chunks.name == "graph" and trs["eager"].chunks.name == "eager"
    masks = G._masks(2)
    feeds = G._batches(data, 12)
    lo = 0
    for kind, n in (("warmup", 3), ("warmup", 4), ("main", 4), ("main", 3),
                    ("final", 2), ("final", 4)):
        outs = {}
        for name, tr in trs.items():
            state = finals[name] if kind == "final" else tr.opt_state
            outs[name] = tr.chunks.run(
                kind, feeds[lo:lo + n],
                [None if kind == "warmup" else masks[(lo + j) % G.N_DOMAIN]
                 for j in range(n)], state)
        lo = (lo + n) % 8
        assert all(_bitwise(a, b) for a, b in zip(
            [outs["graph"][0], *outs["graph"][1]],
            [outs["eager"][0], *outs["eager"][1]])), kind
        _same_trainers(gt, trs["eager"])
        assert all(_bitwise(a, b) for a, b in zip(
            finals["graph"]["mu"].values(), finals["eager"]["mu"].values()))
        assert finals["graph"]["count"] == finals["eager"]["count"]
    # warm-up, bagging and final gate: each captured once, at its first
    # chunk that outlasts the two eager steps
    assert set(gt.chunks.graphs) == {"warmup", "main", "final"}
    assert gt.chunks.captures == 3 and gt.opt_state["t"] == 14
    # a full-sweep regroup: every chain a replay after the first two
    seen = {}
    for name, tr in trs.items():
        for d in range(G.N_DOMAIN):
            tr.mask_state.domain_mask[d] = \
                tr.mask_state.generate_mask("rand", d, 0.7)
        seen[name] = _spy(tr.mask_state)
        tr._mask_evolution(*[DomainBatcher(
            data.train_x, data.train_y, G.BS, data.spec.domain_idx,
            G.N_DOMAIN, seed=s) for s in (1, 2)], verbose=False)
    (gl, gm), (el, em) = seen["graph"][0], seen["eager"][0]
    assert len(gm) == 2 * G.N_DOMAIN
    assert all(np.array_equal(a, b) for a, b in zip(gl, el))
    assert all(np.array_equal(x, y) for a, b in zip(gm, em)
               for x, y in zip(a, b))
    _same_trainers(gt, trs["eager"])
    assert gt.chunks.captures == 4 and "full_S2_P2" in gt.chunks.graphs
    assert gt.regroup_log[0]["dispatch"] == "graph"
    assert cuda_ops.launch_counts["sparse_adam"] == 0


def _spy(ms):
    """What an evolution hands to update_all_mask: every probe loss and
    candidate mask."""
    seen = []
    update = ms.update_all_mask

    def update_all_mask():
        seen.append(([np.array(z) for d in ms.eval_loss for z in d],
                     [[m.copy() for m in c] for d in ms.candidate_domain_mask
                      for c in d]))
        update()

    ms.update_all_mask = update_all_mask
    return seen


def _results_equal(a, b):
    def metrics(r):
        return [{k: v for k, v in h.items()
                 if k not in ("epoch_time_s", "examples_per_s", "spans")}
                for h in r["history"]] + [r["test"]]

    def same(x, y):
        if isinstance(x, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y or (x != x and y != y)

    return same(metrics(a), metrics(b))


def test_deepfm_lazy_fit_by_graph_is_the_eager_fit(monkeypatch):
    data = TG._data()
    trs = {k: TG._zoo_trainer(data, "deepfm", True, dropout=0.2, seed=5,
                              table_optimizer="lazy_adam",
                              table_dtype="bfloat16",
                              table_moments_dtype="bfloat16")
           for k in ("graph", "eager")}
    gt = trs["graph"]
    _graph_dispatch(monkeypatch, gt, lambda: [
        (gt.opt_state, "t"), (gt.opt_state["inner"], "count")])
    res = {k: t.fit(data, epochs=2, verbose=False) for k, t in trs.items()}
    assert (res["graph"]["dispatch"], res["eager"]["dispatch"]) == (
        "graph", "eager")
    assert _results_equal(res["graph"], res["eager"])
    _same_trainers(gt, trs["eager"])
    # one capture of the step serves both epochs; none launched a kernel
    assert gt.chunks.captures == 1 and gt.opt_state["t"] == 2 * TG.N_STEPS
    assert cuda_ops.launch_counts["sparse_adam"] == 0


def _mamdr_twins():
    data = make_synthetic_data(n_rows=600, n_domain=3, vocab=50, seed=6)
    cfg = Config(**{**MAMDR_CFG, "table_dtype": "bfloat16",
                    "table_moments_dtype": "bfloat16", "dropout": 0.2})
    trs = {k: MamdrTrainer(build_model(cfg, data.spec, 3, device="cpu"),
                           cfg, 3) for k in ("graph", "eager")}
    trs["graph"].model.load_state_dict(trs["eager"].model.state_dict())
    return data, trs


def test_mamdr_fit_by_graph_is_the_eager_fit_with_one_capture(monkeypatch):
    data, trs = _mamdr_twins()
    gt = trs["graph"]
    _graph_dispatch(monkeypatch, gt, lambda: [
        (gt.opt_state, "t"), (gt.opt_state["inner"], "count")])
    spied = []
    real = step_graph.GraphChunks.run_eval
    monkeypatch.setattr(step_graph.GraphChunks, "run_eval",
                        lambda self, ev, feeds, *a: (spied.append(len(feeds)),
                                                     real(self, ev, feeds,
                                                          *a))[-1])
    res = {k: t.fit(data, epochs=2, verbose=False) for k, t in trs.items()}
    assert (res["graph"]["dispatch"], res["eager"]["dispatch"]) == (
        "graph", "eager")
    assert _results_equal(res["graph"], res["eager"])
    assert len(res["graph"]["history"]) == 2
    for what in ("meta_weights", *range(3)):
        a, b = ((r["meta_weights"] if what == "meta_weights"
                 else r["domain_weights"][what]) for r in res.values())
        assert set(a) == set(b)
        assert all(_bitwise(a[k], b[k]) for k in a), what
    _same_trainers(gt, trs["eager"])
    g = gt.chunks
    # one step graph for every sequence of both epochs, each step of
    # which but the first two a replay
    assert g.captures == 1 and set(g.graphs) >= {"train"}
    assert len(StandInGraph.made) == 1 + g.eval_captures
    # the merged evaluation: one pass a domain, by the same runner
    assert gt.evals is g and len(spied) == 3 * 3
    assert cuda_ops.launch_counts["sparse_adam"] == 0


def test_graphed_mamdr_fit_matches_the_jax_meta_trainer(
        monkeypatch, jax_true_zero):  # noqa: F811
    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    data = make_synthetic_data(n_rows=600, n_domain=3, vocab=50, seed=6)
    jt, params, state, tr = _pair(data)
    monkeypatch.setattr(jt, "init", lambda rng, sample: (
        params, state, JT.hybrid_init(jt.optimizer, params)))
    jdata = JSplitData(**{f.name: getattr(data, f.name)
                          for f in dataclasses.fields(data)
                          if f.name != "spec"}, spec=jt.model.spec)
    jres = jt.fit(jdata, epochs=1, verbose=False)
    _graph_dispatch(monkeypatch, tr, lambda: [
        (tr.opt_state, "t"), (tr.opt_state["inner"], "count")])
    tres = tr.fit(data, epochs=1, verbose=False)
    assert tres["dispatch"] == "graph" and tr.chunks.captures == 1
    _close_weights(tres["meta_weights"], _as_port(jres["meta_weights"]),
                   "meta weights")
    for d in range(3):
        _close_weights(tres["domain_weights"][d],
                       _as_port(jres["domain_weights"][d]),
                       f"domain {d}'s weights")
    for split, t, j in (("valid", tres["history"][0], jres["history"][0]),
                        ("test", tres["test"], jres["test"])):
        for k in ("total_auc", "mean_auc", "total_loss"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4,
                                       err_msg=f"{split} {k}")
