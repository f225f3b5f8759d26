"""The port's HEMP candidate chains as one staged regroup
(aread_tpu_torch/train/hemp.py ``run_chains``, ``chain_step``; the runner
in aread_tpu_torch/train/step_graph.py) on the CPU, at the toy world of
test_torch_port_graphs.py: n_tower (2, 3), 3 domains, bs 32, a vocab of
100, dropout 0 (the two frameworks' dropout streams cannot agree), f32
table and moments; 5 candidates of 2 adapt steps and 2 probes. The JAX
model's table is stored row by row (one table row per overlay slot, the
port's only layout).

* (a) The chain body that a CUDA graph captures reads nothing back to the
  host and makes no tensor from host data (``NoHostTraffic``), for both
  engines and both feed forms; a planted ``.item()`` raises by name.
* (b) A regroup through the runner, eager on the CPU, against the JAX
  package's ``fast_adapt_many``, ``fast_adapt_many_idx``,
  ``fast_adapt_many_ov`` and ``fast_adapt_many_idx_ov`` on the same
  weights, masks and batches: pruned masks exact, probe losses at atol
  1e-4 (the evolution test's: two adapt steps at lr 1e-2 from f32
  round-off). The JAX functions are jitted once for the module.
* (c) The overlay's static working set is bitwise JAX's
  ``build_working_set`` (sorted int32, duplicates kept).
* (d) ``GraphChunks.run_chains`` with a stand-in for the CUDA graph whose
  replay calls the captured chain: bitwise the eager chain loop over a
  whole evolution (pruned masks, probe losses, weights), the device
  candidate counter, the host counters after a regroup, launch counts
  per replay, a capture again for a new snapshot, another S or engine,
  and a failed capture raising by name.
* (e) The configuration alone picks the chains' dispatch.

A linear bias that feeds a BatchNorm has a true gradient of exactly 0;
both sides get the true 0, as in test_torch_port_hemp.py. Every test here
runs torch on one thread: the suite's workers share the host's cores, and
small tensors on many threads each spin for the rest."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import aread_tpu.ops.overlay_adam as JOA
import aread_tpu.train.hemp as JH
from aread_tpu.config import Config as JConfig
from aread_tpu.models.aread import AREAD as JAREAD
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import convert_variables
from aread_tpu_torch.data.loader import (DomainBatcher, make_synthetic_data,
                                         pad_batch)
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.ops import cuda as cuda_ops
from aread_tpu_torch.ops import overlay_adam as oa
from aread_tpu_torch.train import step_graph
from aread_tpu_torch.train.hemp import AREADTrainer
from tests.test_torch_port_graphs import (HostRead, StandInGraph,
                                          _stand_in)
from tests.test_torch_port_hemp import DenseAdamTrueZero, _true_zero_jax
from tests.test_torch_port_trainer_graphs import HostCopy, NoHostTraffic

E, N_TOWER, N_DOMAIN, BS = 8, (2, 3), 3, 32
S_FA, S_PR, N = 2, 2, 5
MODEL_KW = dict(embed_dim=E, n_tower=N_TOWER, n_domain=N_DOMAIN,
                expert_dims=(16, 8), tower_dims=((8,), (4,)), dropout=0.0,
                mmoe_n_expert=2)
CFG_KW = dict(model="aread", bs=BS, embed_dim=E, lr=1e-3, dropout=0.0,
              table_dtype="float32", table_moments_dtype="float32",
              device_data="0", seed=11, regroup_update_step=S_FA,
              regroup_eval_step=S_PR, candidate_mask_num=3)
ATOL = 1e-4
ENGINES = ("full", "overlay")
FORMS = ("host_batches", "row_ids")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def world():
    """The data, one JAX trainer whose jitted chain functions the module
    shares, its initial weights as numpy, and the candidates' inputs."""
    mp = pytest.MonkeyPatch()
    sparse = JH.hybrid_update_sparse
    mp.setattr(JH, "hybrid_update_sparse",
               lambda opt, lr, wd, params, g_rest, *a, **kw: sparse(
                   opt, lr, wd, params, _true_zero_jax(g_rest), *a, **kw))
    data = make_synthetic_data(n_rows=600, n_domain=N_DOMAIN, vocab=100,
                               seed=3)
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5])
    jt = JH.AREADTrainer(JAREAD(spec=jspec, **MODEL_KW), JConfig(**CFG_KW),
                         N_DOMAIN)
    params, state, _ = jt.init(jax.random.PRNGKey(0),
                               pad_batch(data.train_x[:BS],
                                         data.train_y[:BS], BS))
    # the overlay chain steps its dense leaves through the fast optimizer
    inner = jt.fast_optimizer
    jt.fast_optimizer = optax.GradientTransformation(
        inner.init, lambda g, s, p=None: inner.update(_true_zero_jax(g), s, p))
    fns = jt._build_fns()
    yield dataclasses.make_dataclass("World", [
        "data", "jspec", "jt", "fns", "params", "state", "inputs"])(
        data, jspec, jt, fns, _np_tree(params), _np_tree(state),
        _inputs(data))
    mp.undo()


def _inputs(data, seed=7):
    """Per candidate its mask (numpy levels, a validated random mask of a
    domain), its adapt and probe row ids ([S, bs] int32, -1 = padding, a
    ragged batch among them) and the same rows as padded host batches."""
    from aread_tpu.utils import masks as JM

    rng = np.random.default_rng(seed)
    ms = JM.HempMaskState(N_TOWER, N_DOMAIN, seed=seed)
    masks = [ms.generate_mask("rand", c % N_DOMAIN, 0.7) for c in range(N)]

    def ids(n_steps):
        out = np.full((N, n_steps, BS), -1, np.int32)
        for c in range(N):
            for s in range(n_steps):
                k = BS - 5 * ((c + s) % 2)
                out[c, s, :k] = rng.choice(len(data.train_x), k,
                                           replace=False)
        return out

    fa, probe = ids(S_FA), ids(S_PR)

    def batches(stack):
        return [[pad_batch(data.train_x[i[i >= 0]], data.train_y[i[i >= 0]],
                           BS) for i in cand] for cand in stack]

    return {"masks": masks, "fa_ids": fa, "probe_ids": probe,
            "fa": batches(fa), "probe": batches(probe)}


def _trainer(world, engine="full", **cfg_kw):
    cfg = Config(**{**CFG_KW, "hemp_fast_adapt": engine, **cfg_kw})
    tm = AREAD(world.data.spec, device="cpu", **MODEL_KW)
    tm.load_state_dict(convert_variables(world.params,
                                         world.state["batch_stats"], E))
    tr = AREADTrainer(tm, cfg, N_DOMAIN)
    tr.fast_optimizer = DenseAdamTrueZero(lr=cfg.update_lr, wd=cfg.wd)
    tr.init()
    return tr


def _feeds(tr, world, form):
    """``run_chains``' per-candidate feeds of ``form``; with row ids the
    split is made resident on the trainer."""
    inp = world.inputs
    if form == "row_ids":
        tr._device_data = (torch.tensor(world.data.train_x),
                           torch.tensor(world.data.train_y), 0)
        return ([list(c) for c in inp["fa_ids"]],
                [list(c) for c in inp["probe_ids"]])
    return inp["fa"], inp["probe"]


# ----------------------------------------------- (a) nothing host-bound
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("engine", ENGINES)
def test_chain_body_reads_and_copies_nothing(world, engine, form,
                                             monkeypatch):
    tr = _trainer(world, engine)
    fa, probe = _feeds(tr, world, form)
    chain, io = tr._stage_chains(engine == "overlay", world.inputs["masks"],
                                 fa, probe)
    with NoHostTraffic():
        chain.fn()
        chain.fn()
    assert int(io["i"]) == 2
    assert torch.isfinite(io["out_losses"][:2]).all()
    assert tr._fast_state["t"] == tr._fast_state["inner"]["count"] == S_FA
    # a host read planted in the chain's prune is caught, by name
    prune = tr._prune

    def planted(mask, gate_means):
        gate_means[0].sum().item()
        return prune(mask, gate_means)

    monkeypatch.setattr(tr, "_prune", planted)
    with pytest.raises(HostRead, match="_local_scalar_dense"):
        with NoHostTraffic():
            chain.fn()
    # and so is a tensor made from host data
    with pytest.raises(HostCopy, match="lift_fresh"):
        with NoHostTraffic():
            torch.tensor([1.0])


# --------------------------------------------------- (b) against JAX
def _jax_regroup(world, engine, form):
    inp, fns = world.inputs, world.fns
    masks0 = tuple(jnp.asarray(np.stack([m[li] for m in inp["masks"]]))
                   for li in range(len(inp["masks"][0])))
    rngs = jax.random.split(jax.random.PRNGKey(5), N)
    params, state = (jax.tree_util.tree_map(jnp.asarray, t)
                     for t in (world.params, world.state))
    if form == "row_ids":
        args = (jnp.asarray(world.data.train_x), jnp.asarray(world.data.train_y),
                jnp.asarray(inp["fa_ids"]), jnp.asarray(inp["probe_ids"]))
    else:
        args = tuple({k: jnp.asarray(np.stack([[b[k] for b in c]
                                               for c in inp[name]]))
                      for k in ("x", "y", "valid")}
                     for name in ("fa", "probe"))
    suffix = "_idx" if form == "row_ids" else ""
    if engine == "overlay":
        drift = fns["drift_l2"](params["embedding"]["table"])
        return fns[f"fast_adapt_many{suffix}_ov"](
            params, state, masks0, *args, rngs, drift)
    return fns[f"fast_adapt_many{suffix}"](params, state, masks0, *args, rngs,
                                           False)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("engine", ENGINES)
def test_regroup_matches_jax_fast_adapt_many(world, engine, form):
    jmasks, jlosses = _jax_regroup(world, engine, form)
    tr = _trainer(world, engine)
    sd0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    fa, probe = _feeds(tr, world, form)
    masks, losses = tr.run_chains(world.inputs["masks"], fa, probe,
                                  engine == "overlay")
    assert losses.shape == (N, S_PR) and losses.dtype == np.float32
    for got, want in zip(masks, jmasks):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=0,
                               atol=ATOL)
    # the chains pruned, the candidates differ, and the weights come back
    # bitwise
    assert any(not np.array_equal(m[c], world.inputs["masks"][c][li])
               for li, m in enumerate(masks) for c in range(N))
    assert np.ptp(losses.mean(axis=1)) > 1e-4
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, sd0[k]), k


# ----------------------------------------------- (c) the working set
def test_static_working_set_is_jax_build_working_set(world):
    xs = np.stack([b["x"] for b in world.inputs["fa"][0]])  # [S, bs, F]
    want = np.asarray(JOA.build_working_set(world.jspec, 1, jnp.asarray(xs)))
    emb = _trainer(world).model.embedding
    got = oa.build_working_set(emb, torch.tensor(xs)).numpy()
    assert got.dtype == want.dtype == np.int32
    assert got.shape == (xs.size,) and np.array_equal(got, want)
    assert len(np.unique(got)) < len(got)  # duplicates are kept


# -------------------------------------- (d) the graph runner's bookkeeping
def _spy(ms):
    seen = []
    update = ms.update_all_mask

    def update_all_mask():
        seen.append(([np.array(z) for d in ms.eval_loss for z in d],
                     [[m.copy() for m in c] for d in ms.candidate_domain_mask
                      for c in d]))
        update()

    ms.update_all_mask = update_all_mask
    return seen


def test_graph_runner_matches_the_eager_chain_loop(world, monkeypatch):
    data = world.data
    trs = {"graph": _trainer(world), "eager": _trainer(world)}
    g = step_graph.GraphChunks(trs["graph"])
    trs["graph"]._chunks = g
    gst = trs["graph"]._fresh_fast_state()
    _stand_in(monkeypatch, lambda: [(gst, "t"), (gst["inner"], "count")],
              planted_launches=S_FA)
    seen = {}
    cuda_ops.reset_launch_counts()
    for name, tr in trs.items():
        for d in range(N_DOMAIN):
            tr.mask_state.domain_mask[d] = \
                tr.mask_state.generate_mask("rand", d, 0.7)
        seen[name] = _spy(tr.mask_state)
        batchers = [DomainBatcher(data.train_x, data.train_y, BS,
                                  data.spec.domain_idx, N_DOMAIN, seed=s)
                    for s in (1, 2)]
        tr._mask_evolution(*batchers, verbose=False)
    n_chains = N_DOMAIN * 2  # int(3 * 0.99) candidates a domain
    (gl, gm), (el, em) = seen["graph"][0], seen["eager"][0]
    assert len(gm) == n_chains
    assert all(np.array_equal(a, b) for a, b in zip(gl, el))
    assert all(np.array_equal(x, y) for a, b in zip(gm, em)
               for x, y in zip(a, b))
    for k, v in trs["graph"].model.state_dict().items():
        assert torch.equal(v, trs["eager"].model.state_dict()[k]), k
    # two eager chains, a capture, the rest one replay each; the host
    # counters end as one chain leaves them; each replay adds the
    # captured chain's launches
    assert len(StandInGraph.made) == 1 and g.captures == 1
    assert StandInGraph.made[0].generators == [trs["graph"].generator]
    assert cuda_ops.launch_counts["sparse_adam"] == (n_chains - 2) * S_FA
    for tr in trs.values():
        st = tr._fast_state
        assert st["t"] == st["inner"]["count"] == S_FA
        assert tr.opt_state["t"] == 0
    log = trs["graph"].regroup_log[0]
    assert (log["dispatch"], trs["eager"].regroup_log[0]["dispatch"]) == \
        ("graph", "eager")
    io = trs["graph"]._chain_io["full_S2_P2"]
    assert int(io["i"]) == n_chains

    tr = trs["graph"]
    inp = world.inputs

    def regroup(engine="full", fa=inp["fa"]):
        return tr.run_chains(inp["masks"], fa, inp["probe"],
                             engine == "overlay")

    # the same key, snapshot and state: replays only
    regroup()
    assert len(StandInGraph.made) == 1
    assert int(io["i"]) == N
    # a new snapshot tensor, another S, another engine: captured again
    tr._chain_snap = None
    regroup()
    assert len(StandInGraph.made) == 2
    regroup(fa=[c[:1] for c in inp["fa"]])
    assert len(StandInGraph.made) == 3
    assert "full_S1_P2" in g.graphs
    ov_masks, ov_losses = regroup("overlay")
    assert len(StandInGraph.made) == 4 and "overlay_S2_P2" in g.graphs
    eager = _trainer(world, "overlay")
    want = eager.run_chains(inp["masks"], inp["fa"], inp["probe"], True)
    assert np.array_equal(ov_losses, want[1])
    assert all(np.array_equal(a, b) for a, b in zip(ov_masks, want[0]))

    # a capture that fails raises by name; nothing falls back
    def broken(graph, pool, fn):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "capture", broken)
    tr._chain_snap = None
    with pytest.raises(RuntimeError,
                       match="capturing the HEMP full-sweep chain"):
        regroup()


# ------------------------------------------------------ (e) the dispatch
def test_chain_dispatch_follows_the_configuration(world, monkeypatch):
    tr = _trainer(world)
    runs = []
    monkeypatch.setattr(step_graph.EagerChunks, "run_chains", staticmethod(
        lambda chain, n, real=step_graph.EagerChunks.run_chains: (
            runs.append((chain.name, n)), real(chain, n))[-1]))
    inp = world.inputs
    tr.run_chains(inp["masks"], inp["fa"], inp["probe"], False)
    assert runs == [("HEMP full-sweep chain", N)]
    assert tr.chunks.name == "eager"
    monkeypatch.setattr(tr, "device", torch.device("cuda"))
    assert isinstance(step_graph.make_chunks(tr), step_graph.GraphChunks)
    # lazy_adam's chains are graphs on a card too; a mesh's are eager
    monkeypatch.setattr(tr.config, "table_optimizer", "lazy_adam")
    assert isinstance(step_graph.make_chunks(tr), step_graph.GraphChunks)
    for opt in ("lazy_adam", "adam"):
        monkeypatch.setattr(tr.config, "table_optimizer", opt)
        monkeypatch.setattr(tr, "mesh", object())
        assert isinstance(step_graph.make_chunks(tr), step_graph.EagerChunks)
        monkeypatch.setattr(tr, "mesh", None)
        monkeypatch.setattr(tr, "device", torch.device("cpu"))
        assert isinstance(step_graph.make_chunks(tr), step_graph.EagerChunks)
        monkeypatch.setattr(tr, "device", torch.device("cuda"))
