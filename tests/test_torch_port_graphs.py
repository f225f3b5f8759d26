"""The port's chunked step dispatch (aread_tpu_torch/train/step_graph.py)
on the CPU, at a toy size: n_tower (2, 3), 3 domains, bs 32, a vocab of
100, f32 table and moments, dropout 0 (the two frameworks' dropout streams
cannot agree).

* No step that a CUDA graph captures reads the device from the host: a
  ``TorchDispatchMode`` raises on the ops that do (``_local_scalar_dense``,
  ``nonzero``, ``masked_select``, ``is_nonzero``, indexing by a boolean
  mask) around a warm-up, a bagging and a final-gate step; a planted
  ``.item()`` raises by name.
* The scalar block of a chunk's steps is ``adam_scalars``' bits, and the
  plain sparse Adam and ``DenseAdam`` fed from it are bitwise their
  host-scalar forms (copied here as they were).
* The chunk loop (eager on the CPU) over a chunk of 4 steps and a remainder
  of 2, from host batches and from row ids into the resident split,
  against the JAX trainer's ``main_scan`` / ``main_scan_idx`` for the chunk
  and its single jitted steps for the remainder, as its ``run_segment``
  calls them: losses and gate means at atol 1e-5 (the step tests'), the
  weights, BatchNorm statistics and every Adam moment at atol 1e-5
  (``test_torch_port_step.py``'s).
* ``GraphChunks``' bookkeeping with a stand-in for the CUDA graph whose
  replay calls the captured step: bitwise the eager loop over warm-up,
  bagging and final-gate chunks, the host counters, the launch counts per
  replay, a capture again for another optimizer state or learning rate,
  and a failed capture raising by name.

A linear bias that feeds a BatchNorm has a true gradient of exactly 0; both
sides get the true 0, as in ``test_torch_port_step.py``."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import aread_tpu.train.hemp as JH
from aread_tpu.config import Config as JConfig
from aread_tpu.models.aread import AREAD as JAREAD
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.train.trainer import hybrid_init as j_hybrid_init
from aread_tpu.utils import masks as JM
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_opt_state, convert_variables
from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.ops import cuda as cuda_ops
from aread_tpu_torch.ops.rounding import flat_index_grid, sround
from aread_tpu_torch.ops.sparse_adam import (adam_scalars, chunk_scalars,
                                             dedup_rows, sparse_adam_reference,
                                             step_scalars)
from aread_tpu_torch.train import hemp as port_hemp
from aread_tpu_torch.train import step_graph
from aread_tpu_torch.train.hemp import AREADTrainer
from aread_tpu_torch.train.trainer import DenseAdam

E, N_TOWER, N_DOMAIN, BS = 8, (2, 3), 3, 32
MODEL_KW = dict(embed_dim=E, n_tower=N_TOWER, n_domain=N_DOMAIN,
                expert_dims=(16, 8), tower_dims=((8,), (4,)), dropout=0.0,
                mmoe_n_expert=2)
CFG_KW = dict(model="aread", bs=BS, embed_dim=E, lr=1e-3, dropout=0.0,
              table_dtype="float32", table_moments_dtype="float32",
              device_data="0", seed=11)
PRE_BN_BIAS = re.compile(r"^(mmoe_experts|towers_\d+)/linear_\d+/bias$")


class DenseAdamTrueZero(DenseAdam):
    def update_(self, params, grads, state, scalars=None):
        grads = {n: torch.zeros_like(g) if PRE_BN_BIAS.match(n) else g
                 for n, g in grads.items()}
        super().update_(params, grads, state, scalars)


def _true_zero_jax(g_rest):
    return jax.tree_util.tree_map_with_path(
        lambda path, g: jnp.zeros_like(g) if PRE_BN_BIAS.match(
            "/".join(k.key for k in path)) else g, g_rest)


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def _data():
    return make_synthetic_data(n_rows=600, n_domain=N_DOMAIN, vocab=100,
                               seed=3)


def _trainer(spec, **cfg_kw):
    cfg = Config(**{**CFG_KW, **cfg_kw})
    tr = AREADTrainer(AREAD(spec, device="cpu", **MODEL_KW), cfg, N_DOMAIN)
    tr.optimizer = DenseAdamTrueZero(lr=cfg.lr, wd=cfg.wd)
    tr.init()
    return tr


def _masks(seed):
    ms = JM.HempMaskState(N_TOWER, N_DOMAIN, seed=seed)
    return [ms.generate_mask("rand", d, 0.7) for d in range(N_DOMAIN)]


def _batches(data, n, lo=0):
    return [pad_batch(data.train_x[lo + BS * i:lo + BS * (i + 1)],
                      data.train_y[lo + BS * i:lo + BS * (i + 1)], BS)
            for i in range(n)]


def _tensors(batch):
    return {k: torch.tensor(np.asarray(batch[k])) for k in ("x", "y", "valid")}


# ------------------------------------------------------ (a) no host reads
class HostRead(RuntimeError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a tensor's values to the host (on a
    card: waits for the device, and cannot be captured)."""

    OPS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
           torch.ops.aten.masked_select, torch.ops.aten.is_nonzero}
    INDEXING = {torch.ops.aten.index, torch.ops.aten.index_put,
                torch.ops.aten.index_put_}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in self.OPS:
            raise HostRead(f"{func} reads the device from the host")
        if packet in self.INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                            torch.uint8)
                for i in (args[1] or ())):
            raise HostRead(f"{func} by a boolean mask reads its count from "
                           "the host")
        return func(*args, **kwargs)


def _three_kinds(tr, data):
    """One step of each kind through the step functions a graph captures,
    fed as the graph feeds them (tensors, the scalar block)."""
    b = [_tensors(x) for x in _batches(data, 3)]
    dm = tuple(torch.tensor(m) for m in _masks(1)[0])
    final = tr.final_optimizer.init(
        {"final_gate/kernel": tr.model.final_gate.kernel})
    st = tr.opt_state
    out = []
    for i, (kind, state, mask) in enumerate((("warmup", st, None),
                                             ("main", st, dm),
                                             ("final", final, dm))):
        opt = tr.final_optimizer if kind == "final" else tr.optimizer
        scalars = torch.from_numpy(chunk_scalars(
            step_graph.step_count(kind, state), 1, step_graph.step_lr(tr, kind),
            opt.b1, opt.b2)[0])
        out.append(step_graph.step_fn(tr, kind, state)(b[i], mask, scalars))
    return out


def test_captured_steps_read_nothing_back_to_the_host(monkeypatch):
    data = _data()
    tr = _trainer(data.spec.with_flat_table(E))
    with NoHostReads():
        outs = _three_kinds(tr, data)
    assert all(np.isfinite(float(loss)) for loss, _ in outs)
    assert tr.opt_state["t"] == 2

    # a host read planted in the bagging step is caught, by name
    loss_fn = tr.bagging_loss

    def planted(*a, **kw):
        loss, out = loss_fn(*a, **kw)
        loss.item()
        return loss, out

    monkeypatch.setattr(tr, "bagging_loss", planted)
    with pytest.raises(HostRead, match="_local_scalar_dense"):
        with NoHostReads():
            _three_kinds(tr, data)
    # and so is a boolean selection
    with pytest.raises(HostRead, match="boolean mask"):
        with NoHostReads():
            t = torch.arange(4)
            t[t > 1]


# ------------------------------------------------------ (b) scalar blocks
def _host_scalar_sparse_reference(w, m, v, uids, gsum, t, lr, b1=0.9,
                                  b2=0.99, eps=1e-8, weight_decay=1e-8,
                                  l2=0.0):
    """The plain sparse Adam as it was with host scalars."""
    n_rows, d = w.shape
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    b1c = torch.tensor(s["b1c"], dtype=torch.float32)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32)

    def adam(w_, m_, v_, g_):
        wf = w_.to(torch.float32)
        g_ = g_ + s["decay"] * wf
        m2 = s["b1"] * m_.to(torch.float32) + s["omb1"] * g_
        v2 = s["b2"] * v_.to(torch.float32) + s["omb2"] * g_ * g_
        w2 = wf - s["lr"] * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
        return w2, m2.to(m.dtype), v2.to(v.dtype)

    gid = torch.clamp(uids.to(torch.int64), max=n_rows - 1)
    nw, nm, nv = adam(w[gid], m[gid], v[gid], gsum)
    r = gid[:, None]
    nw = sround(nw, w.dtype, r * d + torch.arange(d)[None], t)
    w2, m2, v2 = adam(w, m, v, torch.zeros_like(w, dtype=torch.float32))
    w2 = sround(w2, w.dtype, flat_index_grid(n_rows, d), t)
    live = uids < n_rows
    rows = uids[live].to(torch.int64)
    w2[rows], m2[rows], v2[rows] = nw[live], nm[live], nv[live]
    return w2, m2, v2


def _host_scalar_dense_adam(opt, params, grads, state):
    """``DenseAdam.update_`` as it was, the bias corrections host floats."""
    names = list(params)
    p = [params[n] for n in names]
    mu = [state["mu"][n] for n in names]
    nu = [state["nu"][n] for n in names]
    g = torch._foreach_add([grads[n] for n in names], p, alpha=opt.wd)
    torch._foreach_mul_(mu, opt.b1)
    torch._foreach_add_(mu, g, alpha=1 - opt.b1)
    torch._foreach_mul_(nu, opt.b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - opt.b2)
    state["count"] += 1
    t = torch.tensor(float(state["count"]), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(opt.b1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(opt.b2, dtype=torch.float32) ** t)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, opt.eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(p, upd, alpha=-opt.lr)


@pytest.mark.parametrize("b2", [0.99, 0.999])
def test_scalar_blocks_are_the_steps_host_scalars(b2):
    lr, t0, S = 3e-3, 40, 9
    blocks = chunk_scalars(t0, S, lr, b2=b2)
    assert blocks.shape == (S, 4) and blocks.dtype == np.int32
    for i in range(S):
        s = adam_scalars(t0 + i + 1, lr, b2=b2)
        want = np.array([s["lr"], s["b1c"], s["b2c"]], np.float32)
        assert blocks[i, :3].view(np.float32).tobytes() == want.tobytes()
        assert blocks[i, 3] == t0 + i + 1
        assert np.array_equal(blocks[i], step_scalars(t0 + i + 1, lr, b2=b2))
    # a seed above 2^31 keeps its 32 bits
    assert step_scalars(1, lr, sr_seed=2**32 - 1)[3] == -1

    rng = np.random.default_rng(0)
    n_rows, d, K = 300, 8, 96
    w32 = torch.tensor(rng.normal(size=(n_rows, d)), dtype=torch.float32)
    m32 = torch.tensor(rng.normal(size=(n_rows, d)) * 0.1, dtype=torch.float32)
    v32 = torch.tensor(np.abs(rng.normal(size=(n_rows, d))) * 0.01,
                       dtype=torch.float32)
    uids, gsum = dedup_rows(
        torch.tensor(rng.integers(0, n_rows, K), dtype=torch.int32),
        torch.tensor(rng.normal(size=(K, d)), dtype=torch.float32), n_rows)
    kw = dict(b2=b2, weight_decay=1e-8, l2=1e-5)
    for dt in (torch.float32, torch.bfloat16):
        w, m, v = w32.to(dt), m32.to(dt), v32.to(dt)
        for i in (0, S - 1):
            t = t0 + i + 1
            got = sparse_adam_reference(w, m, v, uids, gsum, t, lr,
                                        scalars=torch.from_numpy(blocks[i]),
                                        **kw)
            want = _host_scalar_sparse_reference(w, m, v, uids, gsum, t, lr,
                                                 **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (dt, t)

    # the dense leaves' Adam: the block's b1c and b2c are its own
    opt = DenseAdam(lr=lr, b2=b2)
    params = {"a": torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(7,)), dtype=torch.float32)}
    mine = {n: p.clone() for n, p in params.items()}
    st, st_mine = opt.init(params), opt.init(mine)
    st["count"] = st_mine["count"] = t0
    for i in range(S):
        grads = {n: torch.tensor(rng.normal(size=p.shape), dtype=torch.float32)
                 for n, p in params.items()}
        _host_scalar_dense_adam(opt, params, grads, st)
        opt.update_(mine, grads, st_mine,
                    scalars=torch.from_numpy(blocks[i]))
        for n in params:
            assert torch.equal(mine[n], params[n]), (i, n)
            assert torch.equal(st_mine["nu"][n], st["nu"][n])
    assert st_mine["count"] == st["count"] == t0 + S


# -------------------------------------------- (c) chunks against JAX scans
@pytest.fixture(scope="module")
def jax_world():
    mp = pytest.MonkeyPatch()
    sparse = JH.hybrid_update_sparse
    mp.setattr(JH, "hybrid_update_sparse",
               lambda opt, lr, wd, params, g_rest, *a, **kw: sparse(
                   opt, lr, wd, params, _true_zero_jax(g_rest), *a, **kw))
    data = _data()
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).with_flat_table(E)
    jt = JH.AREADTrainer(JAREAD(spec=jspec, **MODEL_KW), JConfig(**CFG_KW),
                         N_DOMAIN)
    params, state, _ = jt.init(jax.random.PRNGKey(0),
                               pad_batch(data.train_x[:BS],
                                         data.train_y[:BS], BS))
    yield jt, data, _np_tree(params), _np_tree(state)
    mp.undo()


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host_batches", "row_ids"])
def test_chunks_match_the_jax_scanned_segment(jax_world, resident,
                                              monkeypatch):
    jt, data, np_params, np_state = jax_world
    fns = jt._fns or jt._build_fns()
    S, n = 4, 6
    masks = _masks(5)
    doms = [0, 1, 2, 1, 0, 2]
    rng = np.random.default_rng(7)
    idxs = [np.sort(rng.choice(len(data.train_x), BS - 3 * (i % 2),
                               replace=False)) for i in range(n)]
    idxs = [np.concatenate([ix, -np.ones(BS - len(ix), int)]).astype(np.int32)
            for ix in idxs]
    batches = [pad_batch(data.train_x[ix[ix >= 0]], data.train_y[ix[ix >= 0]],
                         BS) for ix in idxs]

    # JAX: the chunk as one scan, the remainder as single jitted steps
    params = jax.tree_util.tree_map(jnp.array, np_params)
    state = jax.tree_util.tree_map(jnp.array, np_state)
    opt = j_hybrid_init(jt.optimizer, params, moments_dtype="float32")
    dms = [tuple(jnp.asarray(np.stack([masks[d][li] for d in doms[lo:hi]]))
                 for li in range(len(masks[0]))) for lo, hi in ((0, S), (S, n))]
    rng_key = jax.random.PRNGKey(3)
    jlosses, jgms = [], []
    if resident:
        dxc, dyc = jnp.asarray(data.train_x), jnp.asarray(data.train_y)
        params, state, opt, rng_key, ls, gms = fns["main_scan_idx"](
            params, state, opt, dxc, dyc, jnp.asarray(np.stack(idxs[:S])),
            dms[0], rng_key, False)
    else:
        stk = {k: jnp.asarray(np.stack([b[k] for b in batches[:S]]))
               for k in batches[0]}
        params, state, opt, rng_key, ls, gms = fns["main_scan"](
            params, state, opt, stk, dms[0], rng_key, False)
    jlosses.extend(np.asarray(ls))
    jgms.extend([tuple(np.asarray(g[i]) for g in gms) for i in range(S)])
    for i in range(S, n):
        rng_key, srng = jax.random.split(rng_key)
        dm = tuple(jnp.asarray(masks[doms[i]][li])
                   for li in range(len(masks[0])))
        if resident:
            params, state, opt, loss, gms = fns["main_step_idx"](
                params, state, opt, dxc, dyc, jnp.asarray(idxs[i]), dm, srng,
                False)
        else:
            params, state, opt, loss, gms = fns["main_step"](
                params, state, opt, {k: jnp.asarray(v)
                                     for k, v in batches[i].items()},
                dm, srng, False)
        jlosses.append(np.asarray(loss))
        jgms.append(tuple(np.asarray(g) for g in gms))

    # the port: one segment through the chunk loop, SCAN_CHUNK = 4
    monkeypatch.setattr(port_hemp, "SCAN_CHUNK", S)
    tr = _trainer(data.spec.with_flat_table(E))
    tr.model.load_state_dict(convert_variables(np_params,
                                               np_state["batch_stats"], E))
    if resident:
        tr.stage_device_data(data.train_x, data.train_y, data.train_x,
                             data.train_y)
        tr.config.device_data = "1"
        tr._device_data = (torch.tensor(data.train_x),
                           torch.tensor(data.train_y), 0)
    assert tr.chunks.name == "eager"
    steps = [(d, idxs[i] if resident else batches[i], masks[d], True)
             for i, d in enumerate(doms)]
    losses, recorded = tr.run_segment("main", steps)
    assert [len(x) for x in losses] == [S, n - S]
    np.testing.assert_allclose(torch.cat(losses).numpy(), np.array(jlosses),
                               rtol=0, atol=1e-5)
    assert [d for d, _ in recorded] == doms
    for (_, got), want in zip(recorded, jgms):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    want = convert_variables(_np_tree(params),
                             _np_tree(state["batch_stats"]), E)
    sd = tr.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    got = convert_opt_state(_np_tree(opt), E)
    assert tr.opt_state["t"] == got["t"] == n
    for k in ("m", "v"):
        np.testing.assert_allclose(tr.opt_state[k].numpy(), got[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    for k in ("mu", "nu"):
        for name, v in got["inner"][k].items():
            np.testing.assert_allclose(tr.opt_state["inner"][k][name].numpy(),
                                       v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{k} {name}")


# ------------------------------------- (d) the graph runner's bookkeeping
class StandInGraph:
    """A CUDA graph's stand-in on the CPU: ``capture`` keeps the step and
    ``replay`` calls it. A replay on a card runs no Python, so the host
    counters the step's Python advances (``host_counters()``: (dict, key)
    pairs) are put back after it."""
    made = []
    host_counters = staticmethod(lambda: [])

    def __init__(self):
        self.fn, self.generators = None, []
        StandInGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        saved = [(d, k, d[k]) for d, k in StandInGraph.host_counters()]
        self.fn()
        for d, k, v in saved:
            d[k] = v


class _Stream:
    def __init__(self, *a, **kw):
        pass

    def wait_stream(self, other):
        pass


def _stand_in(monkeypatch, host_counters, planted_launches=1):
    """torch.cuda's graph and stream calls replaced for the CPU; a capture
    records ``planted_launches`` kernel 1 launches, as a captured step on a
    card does."""
    import contextlib

    def capture(graph, pool, fn):
        cuda_ops.captured_counts["sparse_adam"] += planted_launches
        graph.fn = fn

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(step_graph, "capture", capture)
    monkeypatch.setattr(StandInGraph, "host_counters",
                        staticmethod(host_counters))
    StandInGraph.made = []


def _state_bits(tr):
    st = tr.opt_state
    return ([v for v in tr.model.state_dict().values()] + [st["m"], st["v"]]
            + list(st["inner"]["mu"].values()) + list(st["inner"]["nu"].values()))


def test_graph_runner_bookkeeping_matches_the_eager_loop(monkeypatch):
    data = _data()
    spec = data.spec.with_flat_table(E)
    trs = {"graph": _trainer(spec), "eager": _trainer(spec)}
    trs["graph"].model.load_state_dict(trs["eager"].model.state_dict())
    g = step_graph.GraphChunks(trs["graph"])
    runners = {"graph": g, "eager": trs["eager"].chunks}
    masks = _masks(2)
    feeds = _batches(data, 14)
    finals = {k: t.final_optimizer.init(
        {"final_gate/kernel": t.model.final_gate.kernel})
        for k, t in trs.items()}
    _stand_in(monkeypatch, lambda: [
        (trs["graph"].opt_state, "t"),
        (trs["graph"].opt_state["inner"], "count"),
        (finals["graph"], "count")])
    plan = [("warmup", 1), ("warmup", 5), ("main", 2), ("main", 4),
            ("final", 2)]
    cuda_ops.reset_launch_counts()
    lo = 0
    for kind, n in plan:
        outs = {}
        for name, tr in trs.items():
            state = finals[name] if kind == "final" else tr.opt_state
            outs[name] = runners[name].run(
                kind, feeds[lo:lo + n],
                [None if kind == "warmup" else masks[(lo + j) % N_DOMAIN]
                 for j in range(n)], state)
        lo += n
        assert all(torch.equal(a, b) for a, b in zip(
            [outs["graph"][0], *outs["graph"][1]],
            [outs["eager"][0], *outs["eager"][1]])), kind
        assert all(torch.equal(a, b) for a, b in zip(
            _state_bits(trs["graph"]), _state_bits(trs["eager"]))), kind
        assert trs["graph"].opt_state["t"] == trs["eager"].opt_state["t"]
        assert (trs["graph"].opt_state["inner"]["count"]
                == trs["eager"].opt_state["inner"]["count"])
        assert finals["graph"]["count"] == finals["eager"]["count"]
    # warm-up: 1 eager step, then 2 eager + a capture + 3 replays; bagging:
    # 2 eager, then 2 eager + a capture + 2 replays; final: 2 eager, no
    # capture. Each replay adds the captured step's launches
    assert len(StandInGraph.made) == 2
    assert all(m.generators == [trs["graph"].generator]
               for m in StandInGraph.made)
    assert set(g.graphs) == {"warmup", "main"}
    assert cuda_ops.launch_counts["sparse_adam"] == 3 + 2
    assert trs["graph"].opt_state["t"] == 12 and finals["graph"]["count"] == 2

    # another learning rate, another optimizer state: captured again
    trs["graph"].config.lr = 2e-3
    g.run("main", feeds[:3], [masks[0]] * 3, trs["graph"].opt_state)
    assert len(StandInGraph.made) == 3
    trs["graph"].init()
    g.run("main", feeds[:3], [masks[0]] * 3, trs["graph"].opt_state)
    assert len(StandInGraph.made) == 4
    g.run("main", feeds[:3], [masks[0]] * 3, trs["graph"].opt_state)
    assert len(StandInGraph.made) == 4

    # a capture that fails raises by name; nothing falls back
    def broken(graph, pool, fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "capture", broken)
    t_before = trs["graph"].opt_state["t"]
    with pytest.raises(RuntimeError, match="capturing the AREAD final step"):
        g.run("final", feeds[:4], [masks[0]] * 4, trs["graph"].final_optimizer
              .init({"final_gate/kernel": trs["graph"].model.final_gate.kernel}))
    assert trs["graph"].opt_state["t"] == t_before
    with pytest.raises(ValueError, match="1 to 32"):
        g.run("main", feeds[:0], [], trs["graph"].opt_state)


def test_dispatch_follows_the_configuration(monkeypatch):
    data = _data()
    spec = data.spec.with_flat_table(E)
    tr = _trainer(spec)
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
    # fit records the dispatch it ran
    tr = _trainer(spec, epoch=1, warm_up_interval=1, regroup_interval=1,
                  regroup_update_step=1, regroup_eval_step=1,
                  candidate_mask_num=1, aread_final=False)
    res = tr.fit(data, verbose=False)
    assert res["dispatch"] == "eager"
    assert tr.step_timer.summary()["dispatch"] == "eager"


def test_chip_smoke_holds_graph_against_eager_on_the_card():
    """``chip_smoke.py``'s train phase runs both dispatches in turns and
    requires them bitwise after every chunk, holds the counted launches to
    the profiler's kernel records and runs the captured step under sync
    debug mode 'error'; the kernels phase holds kernel 1 on a staged
    scalar block and kernel 2 with ``index_base``; the mesh phase a bf16
    dense step against one process."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    # the turns, the checks and the sync debug step are helpers that the
    # generic Trainer's twins (phase train_dense) share
    assert "twin_chunks(" in funcs["phase_train"]
    assert "sync_debug_step(" in funcs["phase_train"]
    train = (funcs["phase_train"] + funcs["twin_chunks"]
             + funcs["sync_debug_step"])
    for name in ("EagerChunks", "bits_differ(trainer_bits", "chunk_profile(",
                 "KERNEL_RECORDS", "set_sync_debug_mode('error')",
                 "TRAIN_CHUNKS", "reset_peak_memory_stats", "counted(ctx"):
        assert name in train, name
    # each Adam kernel's counted launches are held to the profiler's
    # records of its kernels
    records = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "KERNEL_RECORDS")
    assert records == {"sparse_adam": "sparse_sweeps",
                       "fused_adam": "fused_updates"}
    for key in records.values():
        assert key in funcs["chunk_profile"]
    assert "'generator'" in funcs["trainer_bits"]
    assert "scalars=row" in funcs["sparse_block_case"]
    assert "sparse_block_case(" in funcs["check_sparse_adam"]
    assert "index_base" in funcs["check_fused_adam"]
    assert "mesh_dense_bf16_step(" in funcs["mesh_part_b"]
    assert "mesh_dense_bf16_step(None)" in funcs["mesh_check_b"]
    assert "tr.chunks.run(" in funcs["reference_aread"]
