"""The trainers' options that the port took over last (against the JAX
package where it has a counterpart that runs here), at toy sizes on the
CPU with seed-made inputs:

* ``train/regroup.py``: ``get_losses_tower_domain`` and
  ``regroup_all_domain`` exactly equal to the JAX package's on hypothesis
  draws;
* ``dynamic_regroup``: two epochs of ``Trainer.fit`` (MMoE, dense table
  gradient, f32, dropout 0, ``log_dir`` on) against the JAX Trainer's: the
  same domain -> group maps after each epoch, the history and the test
  result within 1e-4 (losses) and 1e-3 (AUCs: a swap of two near-tied
  predictions moves one by ~4e-4), the same metric records; and the gap
  that ROADMAP.md Queue 3 records: after a regroup that moved a domain,
  the served checkpoint does not see the map the trainer tests with;
* ``compute_dtype='bfloat16'`` (``ops/precision.py``): each product and
  both its gradients against numpy in f64 on bf16-rounded operands, to
  the bound of an f32 sum of K terms (K * 2^-24 * sum |a||b|); the context
  restores what it set; an MMoE forward and gradient against the JAX
  package's run here, which is f32 (XLA on the CPU ignores the setting):
  different, and within 2^-7 of the logits' scale and 2^-5 of each
  gradient's (2^-9 is bf16's unit round-off; see the test);
* ``utils/runlog.py``, ``utils/profiling.py`` (``StepTimer``, ``trace``,
  ``annotate``) and ``parallel/health.py`` (``watchdog``,
  ``epoch_deadline`` with its process-global grace, kill mode in a
  subprocess), and the watchdog wired into both trainers' ``fit``.

The linear biases that feed a BatchNorm get their true gradient, 0, on
both sides of a cross-framework training comparison (see
test_torch_port_trainer.py)."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import aread_tpu.train.regroup as JR
import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.data.loader import SplitData as JSplitData
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.base import gather_group as j_gather_group
from aread_tpu.models.mmoe import MMoE as JMMoE
from aread_tpu.utils.runlog import RunLogger as JRunLogger
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_variables, flatten
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models.base import gather_group
from aread_tpu_torch.models.mmoe import MMoE
from aread_tpu_torch.ops import precision
from aread_tpu_torch.ops.precision import einsum, matmul, matmul_precision_ctx
from aread_tpu_torch.parallel import health
from aread_tpu_torch.parallel.health import HealthError, watchdog
from aread_tpu_torch.serve.predictor import load_predictor
from aread_tpu_torch.train import regroup
from aread_tpu_torch.train.checkpoint import save_checkpoint
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.trainer import Trainer, bce_with_logits
from aread_tpu_torch.utils import profiling
from aread_tpu_torch.utils.runlog import RunLogger
from tests.test_torch_port_trainer import (DenseAdamTrueZero, _np_tree,
                                           _true_zero_jax)
from tests.test_torch_port_zoo import seeded_variables

E, N_DOMAIN = 8, 4
MMOE_KW = dict(n_tower=3, n_expert=2, expert_dims=(16, 8), tower_dims=(8, 4),
               n_cross_layers=2, atten_embed_dim=8, att_layer_num=2,
               att_head_num=2)
# what load_predictor rebuilds for a dataset without a precomputed map
D2G = np.arange(N_DOMAIN) % 3


@pytest.fixture
def fresh_grace(monkeypatch):
    """The watchdog's first-epoch grace as a fresh process has it."""
    monkeypatch.setattr(health, "_first_epoch_done", False)


# --------------------------------------------------------------- regroup
MODES = [("towerfirst",), ("besttower",), ("served", "besttower"),
         ("served", "towerfirst"), ("served", "besttower", "towerfirst")]


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_regroup_functions_equal_jax(data):
    n_tower = data.draw(st.integers(1, 4))
    n_domain = data.draw(st.integers(n_tower, 9))
    seed = data.draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    # ties on purpose: losses on a coarse grid
    loss = rng.integers(0, 4, (n_tower, n_domain)) / 4.0
    modes = data.draw(st.sampled_from(MODES))
    selected = (list(rng.permutation(n_domain)[:n_tower])
                if "served" in modes else None)
    np.testing.assert_array_equal(
        regroup.regroup_all_domain(loss, modes, selected),
        JR.regroup_all_domain(loss, modes, selected))
    n = int(rng.integers(1, 40))
    pred = rng.random((n, n_tower))
    pred[rng.random((n, n_tower)) < 0.1] = rng.choice([0.0, 1.0])
    y = rng.integers(0, 2, n)
    dom = rng.integers(0, n_domain, n)
    np.testing.assert_array_equal(
        regroup.get_losses_tower_domain(pred, y, dom, n_tower, n_domain),
        JR.get_losses_tower_domain(pred, y, dom, n_tower, n_domain))


def _mmoe_pair(data, **cfg_kw):
    """(JAX Trainer, its params and state, port Trainer) on the same
    weights; the dense table gradient, f32, host batches."""
    cfg_kw = {**dict(model="mmoe", dataset_name="cloudtheme", embed_dim=E,
                     dropout=0.0, lr=1e-2, bs=128, seed=7, device_data="0",
                     sparse_table_grad=False, table_dtype="float32",
                     table_moments_dtype="float32", mmoe_n_expert=2,
                     mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8, 4),
                     n_cross_layers=2, atten_embed_dim=8, att_layer_num=2,
                     att_head_num=2), **cfg_kw}
    jspec = dataclasses.replace(
        JFeatureSpec(*dataclasses.astuple(data.spec)[:5]),
        table_dtype="float32")
    jm = JMMoE(spec=jspec, embed_dim=E, dropout=0.0, **MMOE_KW)
    variables = seeded_variables(jm, jnp.asarray(data.train_x[:8]),
                                 train=False, seed=3)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    jt = JT.Trainer(jm, JConfig(**cfg_kw), N_DOMAIN, D2G.copy())
    tm = MMoE(data.spec, E, dropout=0.0, device="cpu", **MMOE_KW)
    tm.load_state_dict(convert_variables(
        _np_tree(params), _np_tree(state["batch_stats"]), E))
    cfg = Config(**cfg_kw)
    tr = Trainer(tm, cfg, N_DOMAIN, D2G.copy())
    tr.optimizer = DenseAdamTrueZero(lr=cfg.lr, wd=cfg.wd)
    return jt, params, state, tr


def _spy_maps(trainer, cls, maps):
    real = cls.apply_dynamic_regroup

    def spy(*a, **kw):
        changed = real(trainer, *a, **kw)
        maps.append(np.asarray(trainer.domain2group).copy())
        return changed

    trainer.apply_dynamic_regroup = spy


@pytest.fixture(scope="module", params=["towerfirst", "served,besttower"])
def regrouped(request, tmp_path_factory):
    """Two epochs of fit with dynamic_regroup and log_dir on both sides."""
    mp = pytest.MonkeyPatch()
    dense = JT.hybrid_update
    mp.setattr(JT, "hybrid_update", lambda opt, lr, wd, p, g, s, **kw: dense(
        opt, lr, wd, p, _true_zero_jax(g), s, **kw))
    logs = tmp_path_factory.mktemp("logs")
    data = make_synthetic_data(n_rows=1024, n_domain=N_DOMAIN, vocab=60,
                               seed=2)
    jt, params, state, tr = _mmoe_pair(
        data, dynamic_regroup=request.param, early_stop=5,
        log_dir=str(logs / "port"))
    jt.config.log_dir = str(logs / "jax")
    mp.setattr(jt, "init", lambda rng, sample: (
        params, state, JT.hybrid_init(jt.optimizer, params,
                                      moments_dtype="float32")))
    jmaps, tmaps = [], []
    _spy_maps(jt, JT.Trainer, jmaps)
    _spy_maps(tr, Trainer, tmaps)
    jdata = JSplitData(**{f.name: getattr(data, f.name)
                          for f in dataclasses.fields(data) if f.name != "spec"},
                       spec=jt.model.spec)
    jres = jt.fit(jdata, epochs=2, verbose=False)
    tres = tr.fit(data, epochs=2, verbose=False)
    yield dict(data=data, jt=jt, tr=tr, jres=jres, tres=tres, jmaps=jmaps,
               tmaps=tmaps, logs=logs, mode=request.param)
    mp.undo()


def test_dynamic_regroup_fit_matches_jax(regrouped):
    r = regrouped
    assert len(r["tmaps"]) == len(r["jmaps"]) == 2
    for a, b in zip(r["tmaps"], r["jmaps"]):
        np.testing.assert_array_equal(a, b)
    # the regroup moved a domain (else this would test nothing)
    assert any(not np.array_equal(m, D2G) for m in r["tmaps"])
    for th, jh in zip(r["tres"]["history"], r["jres"]["history"]):
        for k in ("train_loss", "total_loss"):
            np.testing.assert_allclose(th[k], jh[k], rtol=0, atol=1e-4)
        for k in ("total_auc", "mean_auc"):
            np.testing.assert_allclose(th[k], jh[k], rtol=0, atol=1e-3)
    for k in ("total_loss", "total_auc", "mean_auc"):
        np.testing.assert_allclose(r["tres"]["test"][k], r["jres"]["test"][k],
                                   rtol=0, atol=1e-3 if "auc" in k else 1e-4)
    # the metric records: one valid line per epoch, then the test line
    recs = {}
    for side in ("port", "jax"):
        (run,) = list((r["logs"] / side).iterdir())
        recs[side] = [json.loads(l) for l in
                      (run / "metrics.jsonl").read_text().splitlines()]
        assert [sorted(set(x) - {"_ts"}) for x in recs[side]] == [
            ["_step", "valid"], ["_step", "valid"], ["_step", "test"]]
        assert json.loads((run / "config.json").read_text())[
            "dynamic_regroup"] == r["mode"]
    for a, b in zip(recs["port"], recs["jax"]):
        assert a["_step"] == b["_step"]
        key = "valid" if "valid" in a else "test"
        np.testing.assert_allclose(a[key]["total_auc"], b[key]["total_auc"],
                                   rtol=0, atol=1e-3)


def test_served_checkpoint_misses_the_regrouped_map(regrouped, tmp_path):
    """ROADMAP.md Queue 3: a checkpoint holds no domain -> group map, and
    load_predictor rebuilds it from the config (here the modulo map of a
    dataset without a precomputed one), as the JAX package does. After
    fit has regrouped, the trainer tests its best weights under the new
    map; the served model answers the moved domains from other towers."""
    r = regrouped
    tr, data = r["tr"], r["data"]
    moved = np.flatnonzero(tr.domain2group != D2G)
    assert moved.size
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, tr.model.state_dict(), {}, epoch=2, spec=data.spec,
                    run_config=tr.config, n_domain=N_DOMAIN)
    pred = load_predictor(ck, device="cpu")
    np.testing.assert_array_equal(pred.domain2group, D2G)
    x = data.test_x
    dom = x[:, data.spec.domain_idx]
    served = pred.predict(x)
    with torch.no_grad():
        tr.model.eval()
        prob = tr.model(torch.tensor(x), train=False)["prob"]
        trained = gather_group(prob, torch.tensor(
            tr.domain2group[dom])).numpy()
    same = ~np.isin(dom, moved)
    np.testing.assert_allclose(served[same], trained[same], rtol=0, atol=1e-6)
    assert np.abs(served[~same] - trained[~same]).max() > 1e-3


# ---------------------------------------------------------- compute_dtype
def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.tensor(a).to(torch.bfloat16).to(torch.float64).numpy()


CASES = [("matmul", None, (3, 5, 7), (7, 4)), ("matmul", None, (7,), (7, 4)),
         ("einsum", "bd,edo->beo", (6, 9), (3, 9, 5)),
         ("einsum", "bfe,bge->bfge", (2, 4, 8), (2, 3, 8)),
         ("einsum", "bne,nc->bce", (3, 12, 8), (12, 6))]


@pytest.mark.parametrize("kind,eq,sa,sb", CASES,
                         ids=[c[1] or f"matmul{len(c[2])}d" for c in CASES])
def test_bf16_products_and_gradients_equal_rounded_f64(kind, eq, sa, sb):
    """Under the context, a product and both its gradients are the f64
    product of the bf16-rounded operands (the cotangent rounded too), up to
    an f32 sum: |err| <= K * 2^-24 * sum |a||b| elementwise, K the summed
    length. Outside it, the plain f32 product, bitwise."""
    rng = np.random.default_rng(len(sa) * 10 + len(sb))
    a_np = rng.standard_normal(sa).astype(np.float32)
    b_np = rng.standard_normal(sb).astype(np.float32)
    if kind == "matmul":  # the letters the helper gives it
        lead = "abcdefghij"[:len(sa) - 1]
        eq = f"{lead}y,yz->{lead}z"
    a = torch.tensor(a_np, requires_grad=True)
    b = torch.tensor(b_np, requires_grad=True)
    fn = (lambda x, y: matmul(x, y)) if kind == "matmul" else (
        lambda x, y: einsum(eq, x, y))
    plain = fn(a, b)
    want_plain = torch.einsum(eq, a, b) if kind == "einsum" else a @ b
    assert torch.equal(plain, want_plain)
    with matmul_precision_ctx("bfloat16"):
        out = fn(a, b)
    g_np = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    ga, gb = torch.autograd.grad(out, (a, b), torch.tensor(g_np))
    lhs, rhs = eq.split("->")
    ea, eb = lhs.split(",")
    a16, b16, g16 = _bf16(a_np), _bf16(b_np), _bf16(g_np)
    checks = [(out, np.einsum(eq, a16, b16),
               np.einsum(eq, np.abs(a16), np.abs(b16))),
              (ga, np.einsum(f"{rhs},{eb}->{ea}", g16, b16),
               np.einsum(f"{rhs},{eb}->{ea}", np.abs(g16), np.abs(b16))),
              (gb, np.einsum(f"{rhs},{ea}->{eb}", g16, a16),
               np.einsum(f"{rhs},{ea}->{eb}", np.abs(g16), np.abs(a16)))]
    K = max(sa + sb)
    for got, want, mag in checks:
        err = np.abs(got.detach().numpy().astype(np.float64) - want)
        assert (err <= K * 2.0 ** -24 * mag + 1e-30).all()
    # and it is not the f32 product
    assert not torch.equal(out, plain)


def test_precision_context_is_scoped():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert not precision.bf16_products()
        with matmul_precision_ctx("bfloat16"):
            assert precision.bf16_products()
            assert not torch.backends.cuda.matmul.allow_tf32
            with matmul_precision_ctx("float32"):  # no change inside
                assert precision.bf16_products()
        assert not precision.bf16_products()
        assert torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(ValueError, match="compute_dtype"):
            with matmul_precision_ctx("float16"):
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_bf16_mmoe_forward_and_gradient_against_jax_f32():
    """An MMoE (experts, towers, the cross network and two attention
    layers) forward in eval mode and the gradient of its loss, the port
    under compute_dtype='bfloat16' against the JAX package here (f32: XLA
    on the CPU ignores default_matmul_precision). The two differ, by more
    than f32 round-off, and by at most 4 units of bf16's round-off
    u = 2^-9 of the logits' scale (each product rounds its two operands
    by up to u; a logit's path passes through about eight products, whose
    errors partly cancel) and 16 u of each gradient's scale (the backward
    adds the products of the cotangents, and the attention's softmax
    amplifies the scores' error: the attention embedding's gradient is
    the largest, about 8 u here)."""
    data = make_synthetic_data(n_rows=256, n_domain=N_DOMAIN, vocab=60,
                               seed=4)
    jt, params, state, tr = _mmoe_pair(data)
    x, y = data.train_x[:64], data.train_y[:64].astype(np.float32)
    group = D2G[x[:, data.spec.domain_idx]]

    def jloss(p):
        with JT.matmul_precision_ctx("bfloat16"):
            out = jt.model.apply({"params": p, **state}, jnp.asarray(x),
                                 group=jnp.asarray(group), train=False)
        logit = j_gather_group(out["logit"], jnp.asarray(group))
        return jnp.mean(JT.bce_with_logits(logit, y)), logit

    (jl, jlogit), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = tr.model.eval()
    dense = tm.dense_named_parameters()
    with matmul_precision_ctx("bfloat16"):
        out = tm(torch.tensor(x), group=torch.tensor(group), train=False)
        logit = gather_group(out["logit"], torch.tensor(group))
        loss = torch.mean(bce_with_logits(logit, torch.tensor(y)))
        grads = torch.autograd.grad(loss, list(dense.values()))
    want = flatten(_np_tree(jg))
    pairs = [("logit", logit.detach().numpy(), np.asarray(jlogit))] + [
        (n, g.numpy(), want[n]) for n, g in zip(dense, grads)]
    worst = 0.0
    for name, got, ref in pairs:
        scale = max(float(np.abs(ref).max()), 1e-3)
        err = float(np.abs(got - ref).max())
        bound = 2.0 ** (-7 if name == "logit" else -5)
        assert err <= bound * scale, (name, err, scale)
        worst = max(worst, err / scale)
    assert worst > 2.0 ** -15  # not the f32 computation


# ------------------------------------------------- logging and profiling
def test_runlogger_writes_what_the_jax_one_writes(tmp_path):
    """The same calls give the same records (the wall clock apart) and
    the same config.json; numpy and torch scalars and arrays become JSON
    numbers and lists, NaN and inf null; RunLogger(None) is a no-op."""
    records = {
        "train_loss": np.float32(0.5), "n": np.int64(3),
        "valid": {"total_auc": 0.7, "domain_auc": {0: 0.6, 1: np.nan}},
        "arr": np.arange(3), "inf": float("inf")}
    for cls, name in ((RunLogger, "port"), (JRunLogger, "jax")):
        with cls(str(tmp_path), config=JConfig(model="deepfm", bs=64),
                 run_name=name) as lg:
            lg.log(records, step=10)
            lg.log({"test": {"total_auc": 0.75}})
    read = {n: [json.loads(l) for l in
                (tmp_path / n / "metrics.jsonl").read_text().splitlines()]
            for n in ("port", "jax")}
    for rec in read.values():
        for r in rec:
            r.pop("_ts")
    assert read["port"] == read["jax"]
    assert read["port"][0]["valid"]["domain_auc"] == {"0": 0.6, "1": None}
    assert read["port"][1]["_step"] == 11
    assert ((tmp_path / "port" / "config.json").read_text()
            == (tmp_path / "jax" / "config.json").read_text())
    with RunLogger(str(tmp_path), run_name="t") as lg:
        lg.log({"t": torch.tensor([1.5, float("nan")]),
                "s": torch.tensor(2)})
    (rec,) = [json.loads(l) for l in
              (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    assert rec["t"] == [1.5, None] and rec["s"] == 2
    lg = RunLogger(None)
    lg.log({"x": 1})
    lg.close()
    assert lg.log_dir is None


def test_step_timer_counts_and_throughput():
    timer = profiling.StepTimer(window=4)
    assert timer.summary()["steps"] == 0
    for _ in range(6):
        with timer.step(n_examples=128):
            time.sleep(0.001)
    s = timer.summary()
    assert s["steps"] == 6 and timer.total_examples == 6 * 128
    assert len(timer.durations) == 4 and s["examples_per_s"] > 0
    assert s["mean_ms"] >= 1.0 and s["total_s"] >= 0.006


def test_trace_and_annotate(tmp_path, monkeypatch):
    """No trace without a directory or AREAD_TPU_TRACE; with one, a Chrome
    trace file that holds the annotated range and the ops inside it; the
    JAX package's variable names the directory for either package."""
    monkeypatch.delenv("AREAD_TPU_TRACE", raising=False)
    with profiling.trace():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    for how in ("argument", "variable"):
        out = tmp_path / how
        if how == "variable":
            monkeypatch.setenv("AREAD_TPU_TRACE", str(out))
        with profiling.trace(str(out) if how == "argument" else None):
            with profiling.annotate("hot_region"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        (f,) = list(out.glob("*.pt.trace.json"))
        names = {e.get("name") for e in json.loads(f.read_text())[
            "traceEvents"]}
        assert {"hot_region", "aten::mm"} <= names


def test_aread_epoch_traces_its_mask_evolution(tmp_path, monkeypatch):
    """AREAD_TPU_TRACE set: one epoch of AREADTrainer.fit writes a trace
    in which the evolution is annotated, as the JAX package annotates
    it."""
    monkeypatch.setenv("AREAD_TPU_TRACE", str(tmp_path))
    data = make_synthetic_data(n_rows=256, n_domain=3, vocab=40)
    cfg = Config(model="aread", embed_dim=8, mlp_dims=(8,), bs=64,
                 aread_tower_dims=((4,), (4,)), warm_up_interval=1,
                 regroup_interval=1000, regroup_update_step=1,
                 regroup_eval_step=1, candidate_mask_num=1)
    from aread_tpu_torch.models import build_model
    tr = AREADTrainer(build_model(cfg, data.spec, 3, n_tower=2,
                                  device="cpu"), cfg, 3)
    tr.fit(data, epochs=1, verbose=False)
    (f,) = list(tmp_path.glob("*.pt.trace.json"))
    names = [e.get("name") for e in json.loads(f.read_text())["traceEvents"]]
    assert names.count("hemp_mask_evolution") == 1
    assert tr.step_timer.total_steps > 0


# ------------------------------------------------------------ the watchdog
def test_watchdog_passes_raises_and_is_off_at_zero():
    with watchdog(5.0, tag="ok"):
        time.sleep(0.01)
    with pytest.raises(HealthError, match="slow"):
        with watchdog(0.05, tag="slow"):
            time.sleep(0.2)
    for off in (0, None):
        with watchdog(off, tag="off"):
            time.sleep(0.01)
    # the barrier is ported: a no-op in one process (across ranks it
    # meets, and its deadline fires: test_torch_port_parallel.py)
    t0 = time.perf_counter()
    assert health.barrier("epoch", timeout_s=1.0) is None
    assert time.perf_counter() - t0 < 0.5


def test_watchdog_fire_after_completion_is_a_no_op(monkeypatch):
    """The timer firing after the block returned (before cancel) neither
    flags nor kills: without the guard, os._exit(42) would end pytest."""
    import threading

    captured = {}

    class FakeTimer:
        daemon = True

        def __init__(self, t, fn):
            captured["fn"] = fn

        def start(self):
            pass

        def cancel(self):
            pass

    monkeypatch.setattr(threading, "Timer", FakeTimer)
    with watchdog(0.001, tag="race", kill_process=True):
        time.sleep(0.01)
    captured["fn"]()


def test_watchdog_kill_mode_exits_42():
    code = ("import time\n"
            "from aread_tpu_torch.parallel.health import watchdog\n"
            "with watchdog(0.05, tag='hang', kill_process=True):\n"
            "    time.sleep(30)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert p.returncode == 42
    assert "watchdog 'hang' exceeded" in p.stdout


def test_epoch_deadline_first_epoch_grace(fresh_grace):
    """Equal to the JAX package's: off keeps the grace; the first wrapped
    epoch of the process gets timeout * first_mult, the later ones the
    timeout; the multiplier floors at 1."""
    from aread_tpu.parallel import health as jhealth

    old = jhealth._first_epoch_done
    jhealth._first_epoch_done = False
    try:
        for args in ((0.0, 5.0), (None, 5.0), (10.0, 5.0), (10.0, 5.0),
                     (10.0, 0.5)):
            assert health.epoch_deadline(*args) == jhealth.epoch_deadline(
                *args)
        assert health._first_epoch_done
    finally:
        jhealth._first_epoch_done = old


@pytest.mark.parametrize("trainer", ["generic", "aread"])
def test_fit_epoch_watchdog(trainer, fresh_grace):
    """A deadline shorter than the epoch raises HealthError once the epoch
    returns (first_mult 1: no grace); a generous one lets fit finish."""
    data = make_synthetic_data(n_rows=512, n_domain=3, vocab=40, seed=1)
    if trainer == "generic":
        cfg = Config(model="deepfm", embed_dim=8, bs=64, epoch=1)
        make = lambda c: Trainer(_deepfm(data, c), c, 3)
    else:
        cfg = Config(model="aread", embed_dim=8, mlp_dims=(8,), bs=64,
                     aread_tower_dims=((4,), (4,)), warm_up_interval=1,
                     regroup_interval=1000, regroup_update_step=1,
                     regroup_eval_step=1, candidate_mask_num=1, epoch=1)
        make = lambda c: AREADTrainer(_aread(data, c), c, 3)
    with pytest.raises(HealthError, match="epoch0"):
        make(dataclasses.replace(cfg, epoch_timeout_s=1e-4,
                                 epoch_timeout_first_mult=1.0)).fit(
            data, verbose=False)
    res = make(dataclasses.replace(cfg, epoch_timeout_s=600.0)).fit(
        data, verbose=False)
    assert len(res["history"]) == 1


def _deepfm(data, cfg):
    from aread_tpu_torch.models import build_model
    return build_model(cfg, data.spec, 3, device="cpu")


def _aread(data, cfg):
    from aread_tpu_torch.models import build_model
    return build_model(cfg, data.spec, 3, n_tower=2, device="cpu")
