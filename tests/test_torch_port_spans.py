"""The port's store of spans, counters and device event pairs
(``aread_tpu_torch/utils/profiling.py``) on the CPU, where no replay
records an event pair:

* spans nest: each records its parent, and a span given no id takes its
  parent's; each name keeps its newest ``RING`` records, those taken under
  a profiler apart from the rest;
* a span opens a profiler range under a running ``torch.profiler`` (its
  name is among the profiler's events) and not otherwise;
* the counters through ``EagerChunks`` and through ``GraphChunks`` with a
  stand-in for the CUDA graph: eager steps, captures (``captures`` reads
  the runner's own share), replays, each replay one ``step_graph.replay``
  span fed to the ``StepTimer``;
* one request's ``serve.*`` spans share its id, eagerly and as a stand-in
  replay, and its rows and padded rows are counted;
* an AREAD fit's regroup: its phases' seconds from its spans, summing to
  no more than its seconds; each epoch's result carries its spans.

Torch runs on one thread: the suite's workers share the host's cores."""

import numpy as np
import pytest
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.serve.predictor import BUCKETS, Predictor
from aread_tpu_torch.train import step_graph
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.utils import profiling
from aread_tpu_torch.utils.profiling import RING, STORE, Store
from tests.test_torch_port_graphs import (E, N_DOMAIN, StandInGraph,
                                          _batches, _data, _masks,
                                          _stand_in, _trainer)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _delta(before, *names):
    return {k: STORE.counts[k] - before.get(k, 0) for k in names}


# ------------------------------------------------------------ the store
def test_spans_nest_and_share_their_unit_id():
    st = Store()
    with st.span("unit", 7) as outer:
        with st.span("child"):
            with st.span("grandchild"):
                assert st.current_uid() == 7
        with st.span("own", 9):
            pass
    with st.span("top"):
        pass
    assert st.current_uid() == -1
    rec = {n: st.records(n)[-1] for n in ("unit", "child", "grandchild",
                                          "own", "top")}
    assert rec["unit"][2:] == (None, 7)
    assert rec["child"][2:] == ("unit", 7)
    assert rec["grandchild"][2:] == ("child", 7)
    assert rec["own"][2:] == ("unit", 9)
    assert rec["top"][2:] == (None, -1)
    # a child lies inside its parent, on one clock
    assert rec["unit"][0] <= rec["child"][0] <= rec["grandchild"][0]
    assert rec["grandchild"][1] <= rec["child"][1] <= rec["unit"][1]
    assert outer.ns == rec["unit"][1] - rec["unit"][0] > 0
    s = st.summary()["spans"]
    assert s["unit"]["count"] == 1 and s["child"]["total_ms"] >= 0
    assert st.summary()["replays"] == {}


def test_ring_keeps_the_newest_and_traced_records_apart():
    st = Store()
    for i in range(RING + 5):
        with st.span("s", i):
            pass
    recs = st.records("s")
    assert len(recs) == RING
    assert [r[3] for r in recs] == list(range(5, RING + 5))
    mark = st.mark()
    with torch.profiler.profile():
        with st.span("s", -5):
            pass
    # a traced record goes to its own ring: the untraced ones stay
    assert len(st.records("s")) == RING
    assert st.records("s")[-1][3] == RING + 4
    assert [r[3] for r in st.records("s", traced=True)] == [-5]
    assert st.summary(since=mark)["spans"] == {}
    with st.span("s", 0):
        pass
    assert st.summary(since=mark)["spans"]["s"]["count"] == 1
    assert st.records("s", since=RING + 5) == st.records("s")[-1:]


def test_profiler_range_only_under_a_running_profiler(monkeypatch):
    st = Store()
    with torch.profiler.profile() as prof:
        with st.span("port_span_under_profiler"):
            torch.ones(4).add_(1)
        with profiling.annotate("port_annotated"):
            torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"port_span_under_profiler", "port_annotated"} <= names

    def refuse(name):
        raise AssertionError(f"a profiler range ({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "_ProfilerRange", refuse)
    with st.span("quiet"):
        pass
    assert len(st.records("quiet")) == 1


def test_step_timer_reads_its_span():
    timer = profiling.StepTimer(window=2)
    for _ in range(3):
        with timer.step(16, "test.timed_step"):
            pass
    assert timer.total_steps == 3 and timer.total_examples == 48
    assert [d * 1e9 for d in timer.durations] == pytest.approx(
        [b - a for a, b, _, _ in STORE.records("test.timed_step")[-2:]])


# ------------------------------------------------ counters through runners
def test_counters_through_eager_and_graph_chunks(monkeypatch):
    data = _data()
    spec = data.spec.with_flat_table(E)
    feeds, masks = _batches(data, 5), _masks(2)
    names = ("step.eager", "step.captures", "step.replays")
    eager = _trainer(spec)
    before = dict(STORE.counts)
    eager.chunks.run("main", feeds, [masks[j % N_DOMAIN] for j in range(5)],
                     eager.opt_state)
    assert _delta(before, *names) == {"step.eager": 5, "step.captures": 0,
                                      "step.replays": 0}
    assert eager.step_timer.total_steps == 5

    tr = _trainer(spec)
    _stand_in(monkeypatch, lambda: [(tr.opt_state, "t"),
                                    (tr.opt_state["inner"], "count")])
    g = tr._chunks = step_graph.GraphChunks(tr)
    tr.step_timer.dispatch = "graph"
    before = dict(STORE.counts)
    n_replay = len(STORE.records("step_graph.replay"))
    g.run("main", feeds, [masks[j % N_DOMAIN] for j in range(5)],
          tr.opt_state)
    g.run("main", feeds[:2], [masks[0]] * 2, tr.opt_state)
    # 2 eager steps and a capture, then 3 + 2 replays
    assert _delta(before, *names) == {"step.eager": 2, "step.captures": 1,
                                      "step.replays": 5}
    assert g.captures == 1 and g.eval_captures == 0
    assert len(StandInGraph.made) == 1
    assert tr.step_timer.total_steps == 7
    recs = STORE.records("step_graph.replay")
    assert len(recs) - n_replay == 5 or len(recs) == RING
    # each replay's id is the replay count; its parent the chunk's span
    uids = [r[3] for r in recs[-5:]]
    assert uids == list(range(uids[0], uids[0] + 5))
    assert {r[2] for r in recs[-5:]} == {"step_graph.run"}
    # the replays' spans are the timer's durations: one clock pair a step
    assert [d * 1e9 for d in list(tr.step_timer.durations)[-5:]] == \
        pytest.approx([b - a for a, b, _, _ in recs[-5:]])
    # the CPU records no device event pair
    assert "step" not in STORE.pairs


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served():
    data = make_synthetic_data(n_rows=400, n_domain=3, vocab=50, seed=1)
    cfg = Config(model="deepfm", embed_dim=8, mlp_dims=(8,), bs=64)
    model = build_model(cfg, data.spec, 3, device="cpu")
    return data, model


def _request_spans(uid):
    out = {}
    for name in ("serve.predict", "serve.prepare", "serve.copy_in",
                 "serve.replay", "step_graph.eager", "serve.fetch",
                 "serve.convert"):
        recs = [r for r in STORE.records(name) if r[3] == uid]
        if recs:
            out[name] = recs[-1]
    return out


def test_a_request_shares_one_id_and_counts_its_rows(served, monkeypatch):
    data, model = served
    pred = Predictor(model, 3)
    x = data.train_x[:200]
    before = dict(STORE.counts)
    pred.predict(x)
    uid = STORE.counts["serve.requests"] - 1
    spans = _request_spans(uid)
    assert set(spans) == {"serve.predict", "serve.prepare", "serve.copy_in",
                          "step_graph.eager", "serve.fetch", "serve.convert"}
    assert all(spans[n][2] == "serve.predict" for n in
               ("serve.prepare", "serve.copy_in", "step_graph.eager",
                "serve.fetch", "serve.convert"))
    padded = min(b for b in BUCKETS if b >= len(x))
    assert _delta(before, "serve.requests", "serve.rows",
                  "serve.padded_rows", "request.eager") == {
        "serve.requests": 1, "serve.rows": 200, "serve.padded_rows": padded,
        "request.eager": 1}

    # as replays of a stand-in graph: the first request of its shape runs
    # eagerly and captures, the next replays under its own id
    _stand_in(monkeypatch, lambda: [], planted_launches=0)
    pred._evals = g = step_graph.GraphChunks(pred)
    before = dict(STORE.counts)
    want = pred.predict(x)
    np.testing.assert_array_equal(pred.predict(x), want)
    uid = STORE.counts["serve.requests"] - 1
    spans = _request_spans(uid)
    assert {"serve.replay", "serve.copy_in", "serve.fetch"} <= set(spans)
    assert spans["serve.replay"][2] == "serve.predict"
    assert _delta(before, "request.eager", "request.captures",
                  "request.replays", "serve.padded_rows") == {
        "request.eager": 2, "request.captures": 1, "request.replays": 1,
        "serve.padded_rows": 2 * padded}
    assert g.eval_captures == 1 and g.captures == 0


# ---------------------------------------------------------------- HEMP
def test_regroup_phases_come_from_its_spans():
    data = make_synthetic_data(n_rows=256, n_domain=3, vocab=40)
    cfg = Config(model="aread", embed_dim=8, mlp_dims=(8,), bs=64,
                 aread_tower_dims=((4,), (4,)), warm_up_interval=1,
                 regroup_interval=1000, regroup_update_step=1,
                 regroup_eval_step=1, candidate_mask_num=1)
    tr = AREADTrainer(build_model(cfg, data.spec, 3, n_tower=2,
                                  device="cpu"), cfg, 3)
    res = tr.fit(data, epochs=1, verbose=False)
    (log,) = tr.regroup_log
    assert set(log["phases"]) == {"draw", "stage", "chains", "fetch",
                                  "select"}
    assert all(v > 0 for v in log["phases"].values())
    assert sum(log["phases"].values()) <= log["seconds"]
    assert log["chains"] == 3
    evo = [r for r in STORE.records("hemp_mask_evolution") if r[3] == 1][-1]
    assert evo[1] - evo[0] == pytest.approx(log["seconds"] * 1e9, rel=0.05)
    for name, parent in (("hemp.draw", "hemp_mask_evolution"),
                         ("hemp.stage", "hemp_mask_evolution"),
                         ("hemp.chains", "hemp_mask_evolution"),
                         ("step_graph.chains", "hemp.chains"),
                         ("hemp.select", "hemp_mask_evolution")):
        rec = STORE.records(name)[-1]
        assert rec[2:] == (parent, 1), name
        assert evo[0] <= rec[0] <= rec[1] <= evo[1], name
    # the epoch's result carries the epoch's spans and counters
    (h,) = res["history"]
    assert h["spans"]["spans"]["hemp_mask_evolution"]["count"] == 1
    assert h["spans"]["spans"]["fit.train"]["count"] == 1
    assert h["spans"]["counters"]["chain.eager"] == 3
    assert h["spans"]["counters"]["step.eager"] > 0
