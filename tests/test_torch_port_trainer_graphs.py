"""The generic Trainer's chunked step dispatch (aread_tpu_torch/train/
trainer.py through train/step_graph.py) and kernel 2's step scalars on the
device, on the CPU at a toy size: 3 domains, bs 32, a vocab of 100, small
layers, dropout 0 where the JAX package is compared (the two frameworks'
dropout streams cannot agree).

* (a) ``fused_adam_reference`` fed the step's scalar block is bitwise its
  host-scalar form (copied here as it was), in f32, with bf16 moments and
  with a bf16 table rounded on a nonzero ``index_base``; the block's words
  are ``adam_scalars``' bits.
* (b) The step a CUDA graph captures — ``GraphChunks``' body, its inputs
  staged as a chunk stages them — of every zoo model, with the dense and
  the sparse table gradient, reads nothing back to the host and makes no
  tensor from host data (on a card a host-to-device copy, which a capture
  would freeze at the capture step's values): a ``TorchDispatchMode``
  raises on either. A ``to_device`` planted in the body raises by name.
* (c) The port's chunk loop (eager on the CPU) over a chunk of 4 steps and
  a remainder of 2, against the JAX ``Trainer.train_epoch`` with
  ``SCAN_CHUNK`` = 4 set on its instance and against its
  ``train_epoch_device`` with ``DEVICE_EPOCH_CHUNK`` = 4: losses, weights,
  BatchNorm statistics, ADL's centres and every Adam moment at atol 1e-5
  (``test_torch_port_trainer.py``'s: f32 products summed in another
  order). DeepFM with the dense and the sparse table gradient, MMoE with a
  domain -> group map, ADL.
* (d) ``GraphChunks``' bookkeeping for the generic Trainer with a stand-in
  for the CUDA graph whose replay calls the captured step: bitwise the
  eager loop (losses, weights, statistics, Adam state, counters), the host
  counters and launch counts advanced per replay, a capture again for a
  new optimizer state, a new resident split, another learning rate and a
  regrouped domain -> group map of the resident split, none for a regroup
  of host batches, and a failed capture raising by name.
* (e) ``graph_dispatch`` follows the configuration: graphs on one CUDA
  device without a mesh under either table optimizer, the eager loop on
  the CPU and on a mesh; ``MamdrTrainer`` follows the same rule, and its
  fit on the CPU steps through the eager loop.

A linear bias that feeds a BatchNorm has a true gradient of exactly 0;
both sides get the true 0 where the JAX package is compared, as in
``test_torch_port_trainer.py``."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.data.loader import GlobalBatcher as JGlobalBatcher
from aread_tpu.models.adl import ADL as JADL
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.deepfm import DeepFM as JDeepFM
from aread_tpu.models.mmoe import MMoE as JMMoE
from aread_tpu.train.trainer import split_variables
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_opt_state, convert_variables
from aread_tpu_torch.data.loader import GlobalBatcher, make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.models.adl import ADL
from aread_tpu_torch.models.deepfm import DeepFM
from aread_tpu_torch.models.mmoe import MMoE
from aread_tpu_torch.ops import cuda as cuda_ops
from aread_tpu_torch.ops.fused_adam import (fused_adam_dispatch,
                                            fused_adam_reference)
from aread_tpu_torch.ops.rounding import sround
from aread_tpu_torch.ops.sparse_adam import (adam_scalars, step_scalars,
                                             to_device)
from aread_tpu_torch.train import step_graph
from aread_tpu_torch.train import trainer as T
from aread_tpu_torch.train.mamdr import MamdrTrainer
from aread_tpu_torch.train.trainer import DenseAdam, Trainer
from tests.test_torch_port_graphs import HostRead, NoHostReads, StandInGraph
from tests.test_torch_port_zoo import seeded_variables

E, N_DOMAIN, BS, VOCAB = 8, 3, 32, 100
D2G = np.array([0, 2, 1])
N_STEPS = 6  # a chunk of 4 and a remainder of 2
S = 4
PRE_BN_BIAS = re.compile(
    r"^(mlp|experts|towers|domain_mlps|shared_mlps)/linear_\d+/bias$")
# the key part of a self-attention in-projection bias: softmax over the
# keys ignores a shift that all keys share, so its true gradient is 0 too
IN_PROJ_BIAS = re.compile(r"(^|/)attn_\d+/in_proj_bias$")
ATTEN_DIM = 8
SIDE = dict(n_cross_layers=2, atten_embed_dim=ATTEN_DIM, att_layer_num=1,
            att_head_num=2)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite's workers share the host's cores,
    and small tensors on many threads each spin for the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    data = make_synthetic_data(n_rows=600, n_domain=N_DOMAIN, vocab=VOCAB,
                               seed=4)
    # 5 whole batches and a ragged sixth
    n = (N_STEPS - 1) * BS + 20
    return dataclasses.replace(data, train_x=data.train_x[:n],
                               train_y=data.train_y[:n])


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ------------------------------------------- (a) kernel 2's scalar block
def _host_scalar_fused_reference(w, m, v, g, t, lr, b1=0.9, b2=0.99,
                                 eps=1e-8, weight_decay=1e-8, l2=0.0,
                                 sr_seed=None, index_base=0):
    """``fused_adam_reference`` as it was, with host scalars."""
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    b1c = torch.tensor(s["b1c"], dtype=torch.float32)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32)
    wf = w.to(torch.float32)
    g = g.to(torch.float32) + s["decay"] * wf
    m2 = s["b1"] * m.to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v.to(torch.float32) + s["omb2"] * g * g
    new_w = wf - s["lr"] * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
    if w.dtype == torch.bfloat16:
        idx = torch.arange(index_base, index_base + w.numel(),
                           dtype=torch.int64).reshape(w.shape)
        new_w = sround(new_w, w.dtype, idx, t if sr_seed is None else sr_seed)
    return new_w.to(w.dtype), m2.to(m.dtype), v2.to(v.dtype)


FUSED_MODES = {  # name: (table dtype, moment dtype, gradient dtype, base)
    "f32": (torch.float32, torch.float32, torch.float32, 0),
    "bf16_moments": (torch.float32, torch.bfloat16, torch.float32, 0),
    "bf16_sr_index_base": (torch.bfloat16, torch.bfloat16, torch.float32,
                           3 * 2**20 + 5),
    "bf16_sr_bf16_grad": (torch.bfloat16, torch.float32, torch.bfloat16, 77),
}


@pytest.mark.parametrize("mode", list(FUSED_MODES))
def test_fused_adam_block_is_its_host_scalar_form(mode):
    wdt, mdt, gdt, base = FUSED_MODES[mode]
    rng = np.random.default_rng(1)
    shape = (301, 8)
    w = torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(wdt)
    m = torch.tensor(rng.normal(size=shape) * 0.1).to(mdt)
    v = torch.tensor(np.abs(rng.normal(size=shape)) * 0.01).to(mdt)
    g = torch.tensor(rng.normal(size=shape)).to(gdt)
    kw = dict(b2=0.99, weight_decay=1e-8, l2=1e-5, index_base=base)
    lr = 3e-3
    for t, seed in ((1, None), (40, None), (7, 2**32 - 3)):
        block = step_scalars(t, lr, sr_seed=seed)
        s = adam_scalars(t, lr)
        assert block[:3].view(np.float32).tobytes() == np.array(
            [s["lr"], s["b1c"], s["b2c"]], np.float32).tobytes()
        assert block[3] == np.array([t if seed is None else seed],
                                    np.uint32).view(np.int32)[0]
        want = _host_scalar_fused_reference(w, m, v, g, t, lr, sr_seed=seed,
                                            **kw)
        for scalars in (torch.from_numpy(block), None):
            got = fused_adam_reference(w, m, v, g, t, lr, sr_seed=seed,
                                       scalars=scalars, **kw)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (mode, t)
        # the in-place dispatch reads the block the same way
        w2, m2, v2 = w.clone(), m.clone(), v.clone()
        # the block decides: t and lr passed beside it are not read
        fused_adam_dispatch(w2, m2, v2, g, t + 100, lr=9.0, sr_seed=seed,
                            scalars=torch.from_numpy(block), **kw)
        for a, b in zip((w2, m2, v2), want):
            assert torch.equal(a, b), mode
    with pytest.raises(TypeError, match=r"\[4\] int32 block"):
        fused_adam_reference(w, m, v, g, 1, lr,
                             scalars=torch.zeros(4, dtype=torch.int64))


# ---------------------------------------- (b) no host reads, no host data
class HostCopy(RuntimeError):
    pass


class NoHostTraffic(NoHostReads):
    """``NoHostReads`` that also raises on every tensor made from host data
    (``aten.lift_fresh``: ``torch.tensor``, ``torch.as_tensor`` of numpy or
    of a list, ``torch.from_numpy``, ``to_device``): on a card a
    host-to-device copy, pinned or pageable, which a captured CUDA graph
    would replay with the capture step's values."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.lift_fresh,
                                   torch.ops.aten.lift_fresh_copy):
            raise HostCopy(f"{func} makes a tensor from host data (a "
                           "host-to-device copy on a card)")
        return super().__torch_dispatch__(func, types, args, kwargs)


ZOO = ("deepfm", "dcn", "mmoe", "dcnv2", "autoint", "ple", "pepnet",
       "epnet", "epnet-single", "star", "hinet", "adasparse", "adl")
SMALL = dict(embed_dim=E, bs=BS, table_dtype="float32",
             table_moments_dtype="float32", mlp_dims=(16, 8),
             tower_dims=(16, 8), sei_dims=(16, 8),
             ple_expert_dims=((16,), (8,)), ple_tower_dims=(8, 4),
             mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8, 4),
             atten_embed_dim=8, att_layer_num=1, dataset_name="none")


def _zoo_trainer(data, name, sparse, **kw):
    cfg = Config(**{**SMALL, "model": name, "sparse_table_grad": sparse,
                    **kw})
    tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"), cfg,
                 N_DOMAIN, D2G)
    tr.init()
    return tr


def _feeds(data, resident: bool, d2g=D2G):
    """The epoch's feeds as the Trainer makes them: host batches, or row
    ids into the split."""
    batcher = GlobalBatcher(data.train_x, data.train_y, BS,
                            data.spec.domain_idx, d2g, seed=3)
    return list(batcher.epoch_perm()) if resident else list(batcher)


def _make_resident(tr, data):
    tr._device_data = (data.train_x, data.train_y,
                       torch.tensor(data.train_x), torch.tensor(data.train_y))
    tr._device_d2g = (D2G, torch.tensor(D2G, dtype=torch.int32))


def _captured_body(tr, feeds):
    """What a capture records: ``GraphChunks``' body for the generic step,
    its inputs staged into the static buffers as a chunk stages them."""
    g = step_graph.GraphChunks(tr)
    st = tr.opt_state
    step = tr.chunk_step("train", st)
    masks = [None] * len(feeds)
    key = "train" if isinstance(feeds[0], dict) else "train_idx"
    buf = g._buffers(key, step, feeds, masks)
    g._stage(buf, "train", feeds, masks, st)
    return g._body("train", buf, st), buf


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", ZOO)
def test_captured_generic_step_reads_and_copies_nothing(name, sparse):
    data = _data()
    tr = _zoo_trainer(data, name, sparse, dropout=0.2)
    body, buf = _captured_body(tr, _feeds(data, False)[:2])
    with NoHostTraffic():
        body()
        body()
    assert tr.opt_state["t"] == tr.opt_state["inner"]["count"] == 2
    assert torch.isfinite(buf["loss"][:2]).all()
    assert int(buf["i"][0]) == 2


@pytest.mark.parametrize("name,sparse,kw", [
    ("mmoe", False, {}), ("adl", True, {}),
    ("deepfm", False, dict(compute_dtype="bfloat16", grad_clip_norm=0.05,
                           loss_report_table_l2=True)),
    ("deepfm", True, dict(compute_dtype="bfloat16", grad_clip_norm=0.05,
                          loss_report_table_l2=True))],
    ids=["mmoe-dense-rows", "adl-sparse-rows", "deepfm-dense-options",
         "deepfm-sparse-options"])
def test_captured_step_on_resident_rows_and_options(name, sparse, kw):
    """Fed row ids into the resident split (the gather, the domain column,
    the group map on the device), and under bf16 products, the global-norm
    clip and the reported table L2 term."""
    data = _data()
    tr = _zoo_trainer(data, name, sparse, **kw)
    _make_resident(tr, data)
    body, buf = _captured_body(tr, _feeds(data, True)[:3])
    with NoHostTraffic():
        for _ in range(3):
            body()
    assert tr.opt_state["t"] == 3 and torch.isfinite(buf["loss"][:3]).all()


def test_planted_host_traffic_in_the_body_raises_by_name(monkeypatch):
    data = _data()
    tr = _zoo_trainer(data, "deepfm", False)
    body, _ = _captured_body(tr, _feeds(data, False)[:1])
    core = tr.step_core
    for plant, err, name in (
            (lambda: to_device(np.zeros(2, np.int32), tr.device), HostCopy,
             "lift_fresh"),
            (lambda: torch.as_tensor(np.ones(2), device=tr.device), HostCopy,
             "lift_fresh"),
            (lambda: tr.opt_state["m"].sum().item(), HostRead,
             "_local_scalar_dense")):
        def planted(batch, scalars=None, plant=plant):
            plant()
            return core(batch, scalars=scalars)

        monkeypatch.setattr(tr, "step_core", planted)
        with pytest.raises(err, match=name):
            with NoHostTraffic():
                body()


# ---------------------------------------------- (c) against the JAX scans
JMODELS = {
    "deepfm": (JDeepFM, DeepFM, dict(mlp_dims=(16, 8))),
    "mmoe": (JMMoE, MMoE, dict(n_tower=3, n_expert=2, expert_dims=(16, 8),
                               tower_dims=(8, 4), **SIDE)),
    "adl": (JADL, ADL, dict(n_tower=3, tower_dims=(16, 8), n_cross_layers=2,
                            use_atten=False)),
}


def _true_zero(name, g, zeroed):
    """``g`` with its true zeros; ``zeroed(g, sl)`` is g with ``sl``
    zeroed."""
    if PRE_BN_BIAS.match(name):
        return zeroed(g, slice(None))
    if IN_PROJ_BIAS.search(name):
        return zeroed(g, slice(ATTEN_DIM, 2 * ATTEN_DIM))
    return g


def _zeroed_torch(g, sl):
    g = g.clone()
    g[sl] = 0
    return g


class DenseAdamTrueZero(DenseAdam):
    def update_(self, params, grads, state, scalars=None):
        grads = {n: _true_zero(n, g, _zeroed_torch) for n, g in grads.items()}
        super().update_(params, grads, state, scalars)


def _true_zero_jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, g: _true_zero("/".join(k.key for k in path), g,
                                   lambda g, sl: g.at[sl].set(0)), tree)


@pytest.fixture
def jax_true_zero(monkeypatch):
    dense, sparse = JT.hybrid_update, JT.hybrid_update_sparse
    monkeypatch.setattr(JT, "hybrid_update", lambda opt, lr, wd, params,
                        grads, st, **kw: dense(opt, lr, wd, params,
                                               _true_zero_jax(grads), st,
                                               **kw))
    monkeypatch.setattr(JT, "hybrid_update_sparse", lambda opt, lr, wd,
                        params, g_rest, *a, **kw: sparse(
                            opt, lr, wd, params, _true_zero_jax(g_rest), *a,
                            **kw))


def _recorded_losses(monkeypatch, module):
    """Each epoch's per-step losses, recorded where the epoch loop hands
    them to ``mean_losses``."""
    seen = []
    real = module.mean_losses

    def record(losses):
        seen.append(np.concatenate([np.asarray(l).reshape(-1)
                                    for l in losses]))
        return real(losses)

    monkeypatch.setattr(module, "mean_losses", record)
    return seen


CHUNK_CASES = [("deepfm", False), ("deepfm", True), ("mmoe", False),
               ("adl", False)]


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host_batches", "row_ids"])
@pytest.mark.parametrize("name,sparse", CHUNK_CASES,
                         ids=[f"{m}-{'sparse' if s else 'dense'}"
                              for m, s in CHUNK_CASES])
def test_chunks_match_the_jax_trainer_epoch(name, sparse, resident,
                                            monkeypatch, jax_true_zero):
    data = _data()
    jcls, tcls, kw = JMODELS[name]
    d2g = None if name == "deepfm" else D2G
    cfg_kw = dict(model=name, embed_dim=E, dropout=0.0, lr=1e-3, bs=BS,
                  table_dtype="float32", table_moments_dtype="float32",
                  sparse_table_grad=sparse, dataset_name="none",
                  device_data="1" if resident else "0")
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    tspec = data.spec
    if sparse:
        jspec, tspec = jspec.with_flat_table(E), tspec.with_flat_table(E)
    jm = jcls(spec=jspec, embed_dim=E, dropout=0.0, **kw)
    x = data.train_x[:BS]
    extra = ({} if name != "adl" else {"group": jnp.asarray(
        D2G[x[:, data.spec.domain_idx]].astype(np.int32))})
    params, state = split_variables(seeded_variables(
        jm, jnp.asarray(x), train=False, **extra))
    # the port's weights before JAX's epoch donates the arrays
    sd0 = seeded_state(params, state)
    jt = JT.Trainer(jm, JConfig(**cfg_kw), N_DOMAIN, d2g)
    jt.SCAN_CHUNK = S
    jt.DEVICE_EPOCH_CHUNK = S
    opt = JT.hybrid_init(jt.optimizer, params, moments_dtype="float32")

    def batcher(cls):
        return cls(data.train_x, data.train_y, BS, data.spec.domain_idx, d2g,
                   seed=3)

    jseen = _recorded_losses(monkeypatch, JT)
    run = jt.train_epoch_device if resident else jt.train_epoch
    params, state, opt, _, jloss = run(params, state, opt,
                                       batcher(JGlobalBatcher),
                                       jax.random.PRNGKey(0))

    # the port: the chunk loop, SCAN_CHUNK = 4
    monkeypatch.setattr(T, "SCAN_CHUNK", S)
    monkeypatch.setattr(step_graph, "SCAN_CHUNK", S)
    tm = tcls(tspec, E, dropout=0.0, device="cpu", **kw)
    tm.load_state_dict(sd0)
    tr = Trainer(tm, Config(**cfg_kw), N_DOMAIN, d2g)
    tr.optimizer = DenseAdamTrueZero(lr=tr.config.lr, wd=tr.config.wd)
    tr.DEVICE_EPOCH_CHUNK = S
    tr.init()
    assert tr.chunks.name == "eager"
    tseen = _recorded_losses(monkeypatch, T)
    b = batcher(GlobalBatcher)
    assert len(b) == N_STEPS
    tloss = tr.train_epoch_device(b) if resident else tr.train_epoch(b)
    assert tr.step_timer.total_steps == N_STEPS

    np.testing.assert_allclose(tseen[-1], jseen[-1], rtol=0, atol=ATOL)
    assert len(tseen[-1]) == N_STEPS
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=ATOL)
    want = seeded_state(params, state)
    got = tr.model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)
    jo = convert_opt_state(_np_tree(opt), E)
    assert tr.opt_state["t"] == jo["t"] == N_STEPS
    assert tr.opt_state["inner"]["count"] == N_STEPS
    for k in ("m", "v"):
        np.testing.assert_allclose(tr.opt_state[k].numpy(), jo[k].numpy(),
                                   rtol=0, atol=ATOL, err_msg=k)
    for k in ("mu", "nu"):
        for n, v in jo["inner"][k].items():
            np.testing.assert_allclose(tr.opt_state["inner"][k][n].numpy(),
                                       v.numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"{k} {n}")


def seeded_state(params, state):
    """The port's state_dict of flax params and state (every collection:
    ADL's centres too)."""
    state = dict(_np_tree(state))
    return convert_variables(_np_tree(params), state.pop("batch_stats", {}),
                             E, **state)


# -------------------------------------- (d) the graph runner's bookkeeping
class _Stream:
    def __init__(self, *a, **kw):
        pass

    def wait_stream(self, other):
        pass


def _stand_in(monkeypatch, graph_tr, kernel):
    """torch.cuda's graph and stream calls replaced for the CPU; a capture
    records one launch of ``kernel``, as a captured step on a card does;
    ``graph_tr`` (and no other trainer) dispatches graphs."""
    import contextlib

    def capture(graph, pool, fn):
        cuda_ops.captured_counts[kernel] += 1
        graph.fn = fn

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(step_graph, "capture", capture)
    monkeypatch.setattr(step_graph, "graph_dispatch",
                        lambda tr: tr is graph_tr)
    monkeypatch.setattr(StandInGraph, "host_counters", staticmethod(lambda: [
        (graph_tr.opt_state, "t"), (graph_tr.opt_state["inner"], "count")]))
    StandInGraph.made = []


def _bits(tr):
    st = tr.opt_state
    return ([v for v in tr.model.state_dict().values()] + [st["m"], st["v"]]
            + list(st["inner"]["mu"].values())
            + list(st["inner"]["nu"].values()))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_graph_runner_bookkeeping_matches_the_eager_loop(monkeypatch,
                                                         sparse):
    data = _data()
    kernel = "sparse_adam" if sparse else "fused_adam"
    trs = {k: _zoo_trainer(data, "mmoe", sparse, dropout=0.2, seed=5,
                           use_dcn=False, use_atten=False)
           for k in ("graph", "eager")}
    assert all(torch.equal(a, b) for a, b in zip(_bits(trs["graph"]),
                                                  _bits(trs["eager"])))
    _stand_in(monkeypatch, trs["graph"], kernel)
    monkeypatch.setattr(T, "SCAN_CHUNK", S)
    monkeypatch.setattr(step_graph, "SCAN_CHUNK", S)
    assert trs["graph"].chunks.name == "graph"
    assert trs["eager"].chunks.name == "eager"
    cuda_ops.reset_launch_counts()
    d2g = {"map": D2G}
    splits = {"xy": (data.train_x, data.train_y)}
    replays = 0

    def epoch(resident):
        losses = {}
        for name, tr in trs.items():
            b = GlobalBatcher(*splits["xy"], BS, data.spec.domain_idx,
                              d2g["map"], seed=3)
            losses[name] = (tr.train_epoch_device(b) if resident
                            else tr.train_epoch(b))
        assert losses["graph"] == losses["eager"]
        assert all(torch.equal(a, b) for a, b in zip(_bits(trs["graph"]),
                                                      _bits(trs["eager"])))
        g, e = (trs[k].opt_state for k in ("graph", "eager"))
        assert g["t"] == e["t"] and g["inner"]["count"] == e["inner"]["count"]
        assert torch.equal(trs["graph"].generator.get_state(),
                           trs["eager"].generator.get_state())

    def check(made, captured_now):
        nonlocal replays
        # a chunk that captures runs 2 eager steps, then replays; every
        # other step is a replay
        replays += N_STEPS - 2 * captured_now
        assert len(StandInGraph.made) == made
        assert cuda_ops.launch_counts[kernel] == replays
        assert all(m.generators == [trs["graph"].generator]
                   for m in StandInGraph.made)

    epoch(False)        # host batches: a chunk of 4 (captures), then 2
    check(1, 1)
    epoch(True)         # row ids: the resident split's graph
    check(2, 1)
    epoch(True)         # the same split and map: replays only
    check(2, 0)
    epoch(False)
    check(2, 0)
    assert set(trs["graph"].chunks.graphs) == {"train", "train_idx"}
    # a regrouped map: a new device map, captured again for row ids; host
    # batches carry their groups
    d2g["map"] = np.array([1, 0, 2])
    for tr in trs.values():
        tr.domain2group = d2g["map"]
    epoch(True)
    check(3, 1)
    epoch(False)
    check(3, 0)
    # a new resident split
    splits["xy"] = (data.train_x.copy(), data.train_y.copy())
    epoch(True)
    check(4, 1)
    # another learning rate
    for tr in trs.values():
        tr.config.lr = 2e-3
    epoch(False)
    check(5, 1)
    # a new optimizer state: the graphs are dropped with it
    for tr in trs.values():
        tr.init()
    epoch(False)
    check(6, 1)
    assert trs["graph"].opt_state["t"] == N_STEPS
    assert trs["graph"].step_timer.dispatch == "graph"

    # a capture that fails raises by name; nothing falls back
    def broken(graph, pool, fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "capture", broken)
    trs["graph"].init()
    with pytest.raises(RuntimeError,
                       match="capturing the generic Trainer step"):
        trs["graph"].train_epoch(GlobalBatcher(
            *splits["xy"], BS, data.spec.domain_idx, d2g["map"], seed=3))
    # the two eager steps ran; the capture's own step was put back
    assert trs["graph"].opt_state["t"] == 2


# ----------------------------------------------------- (e) the dispatch
def test_dispatch_follows_the_configuration(monkeypatch):
    data = _data()
    tr = _zoo_trainer(data, "deepfm", False)
    assert not step_graph.graph_dispatch(tr)
    assert tr.chunks.name == "eager" and tr.step_timer.dispatch == "eager"
    # one CUDA device without a mesh: graphs under either table optimizer;
    # the CPU and a mesh: the eager loop
    for opt in ("adam", "lazy_adam"):
        tr.config.table_optimizer = opt
        assert not step_graph.graph_dispatch(tr), opt
        monkeypatch.setattr(tr, "device", torch.device("cuda"))
        assert step_graph.graph_dispatch(tr), opt
        tr.mesh = object()
        assert not step_graph.graph_dispatch(tr), opt
        tr.mesh = None
        monkeypatch.setattr(tr, "device", torch.device("cpu"))
    tr.config.table_optimizer = "adam"
    # MAMDR's Reptile sequences run through the same rule: graphs on a
    # card, and on the CPU its fit steps through the eager loop
    cfg = Config(**{**SMALL, "model": "mamdr", "sparse_table_grad": True})
    mt = MamdrTrainer(build_model(cfg, data.spec, N_DOMAIN, device="cpu"),
                      cfg, N_DOMAIN)
    monkeypatch.setattr(mt, "device", torch.device("cuda"))
    assert step_graph.graph_dispatch(mt)
    monkeypatch.setattr(mt, "mesh", object())
    assert not step_graph.graph_dispatch(mt)
    monkeypatch.undo()
    steps = []
    real_run = step_graph.EagerChunks.run
    monkeypatch.setattr(step_graph.EagerChunks, "run",
                        lambda self, kind, feeds, *a, **kw: (
                            steps.append(len(feeds)),
                            real_run(self, kind, feeds, *a, **kw))[-1])
    # two batches of rows a split keep MAMDR's passes short
    res = mt.fit(dataclasses.replace(
        data, **{f"{s}_{a}": getattr(data, f"{s}_{a}")[:2 * BS]
                 for s in ("train", "valid", "test") for a in "xy"}),
        epochs=1, verbose=False)
    assert res["dispatch"] == "eager" and mt.chunks.name == "eager"
    assert steps and mt.step_timer.total_steps == sum(steps)
    monkeypatch.undo()
    # fit records the dispatch it ran
    tr = _zoo_trainer(data, "deepfm", False)
    res = tr.fit(data, epochs=1, verbose=False)
    assert res["dispatch"] == "eager"
    assert tr.step_timer.summary()["dispatch"] == "eager"
    assert tr.step_timer.total_steps == N_STEPS
