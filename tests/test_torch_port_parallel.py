"""The port's parallel/ modules against the JAX package's on the same
seed-made inputs:

* the a2a capacity functions (``a2a_required_capacity``, ``lookup_ids``
  with and without flat storage, ``check_a2a_capacity``,
  ``resolve_a2a_capacity`` in its auto, manual and -1 modes, the same
  errors): exact;
* ``sharded_sparse_table_adam`` at model 2 and 4, f32 and bf16 with
  stochastic rounding, ids at the shard edges included (each shard run on
  its own, as a rank runs it: the update needs no collective): against
  the JAX package's shard_map update at the unsharded comparison's
  tolerances, bitwise against the port's unsharded (f32) and per-shard
  (bf16) plain update;
* ``_perm`` and ``HostShardedDomainBatcher`` for 1 to 4 processes:
  bitwise, and the processes' slices make the one-process batch;
* ``sharded_lookup`` and ``a2a_lookup`` over real gloo process groups on
  the CPU — 8 ranks as a (4, 2) mesh, 4 as (2, 2) — against the JAX
  package's on its 8-device CPU mesh: the forward rows bitwise, the
  table gradient of sum(rows * cotangent) at atol 1e-6 (sums of a few
  f32 products in another order), an undersized capacity NaN-poisoning
  every output;
* ``health.barrier``: it meets, and its deadline fires (``HealthError``)
  when one of 2 ranks sleeps past it;
* ``make_mesh`` in one process: a 1 x 1 mesh without a process group, a
  larger one raising by name; the backend rule.

Ranks are processes this file starts on itself (``spawn``): run as a
script, it is one rank, which imports torch and the port only."""

import dataclasses
import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from aread_tpu_torch.parallel import distributed as PD
from aread_tpu_torch.parallel import embed_shard as PE
from aread_tpu_torch.parallel import health
from aread_tpu_torch.parallel.mesh import (Mesh, gather_rows, make_mesh,
                                           pad_to_multiple, param_shardings,
                                           shard_rows)
from aread_tpu_torch.parallel.sharded_adam import sharded_sparse_table_adam

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------- the ranks
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script, case: str, world: int, workdir: Path,
          timeout: float = 240.0):
    """Run ``python script case workdir`` as ``world`` gloo ranks on the
    CPU; returns each rank's saved result (``rank_main``). A rank that
    fails fails the test with every rank's output."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), case, str(workdir)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    end = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(
            f"--- rank {r} (rc {p.returncode}):\n{o[-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [torch.load(workdir / f"{case}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def rank_main(cases) -> None:
    """One rank: start the process group from the environment, run
    ``cases[argv[1]](workdir)``, save its result, meet at a barrier."""
    import torch.distributed as dist

    case, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    assert PD.initialize("cpu") == "gloo"
    out = cases[case](workdir)
    torch.save(out, workdir / f"{case}_rank{dist.get_rank()}.pt")
    if case != "barrier":
        health.barrier("done", 120.0)
    PD.shutdown()


def _case_lookups(workdir: Path):
    """Both lookups and their table gradients on this rank's rows."""
    inp = torch.load(workdir / "lookups_in.pt")
    mesh = make_mesh(*inp["mesh"], device="cpu")
    shard = shard_rows(inp["table"], mesh)
    rows = mesh.rows(inp["ids"].shape[0])
    ids, cot = inp["ids"][rows], inp["cot"][rows]
    out = {"mesh": (mesh.data_index, mesh.model_index)}
    for name, fn in (
            ("sharded", lambda t: PE.sharded_lookup(t, ids, mesh)),
            ("a2a", lambda t: PE.a2a_lookup(t, ids, mesh, None)),
            ("a2a_cap", lambda t: PE.a2a_lookup(t, ids, mesh, inp["cap"]))):
        t = shard.clone().requires_grad_(True)
        o = fn(t)
        (g,) = torch.autograd.grad((o * cot).sum(), [t])
        out[name] = (o.detach(), g)
    out["overflow"] = PE.a2a_lookup(shard, ids, mesh, 1)
    assert torch.equal(gather_rows(shard, mesh), inp["table"])
    return out


def _case_barrier(workdir: Path):
    import torch.distributed as dist

    rank = dist.get_rank()
    health.barrier("meets", 60.0)  # both arrive: no error
    if rank == 1:
        time.sleep(4.0)
        return {"slept": True}
    t0 = time.perf_counter()
    try:
        health.barrier("late", 1.0)
    except health.HealthError as e:
        return {"error": str(e), "seconds": time.perf_counter() - t0}
    return {"error": None}


CASES = {"lookups": _case_lookups, "barrier": _case_barrier}

if __name__ == "__main__":
    rank_main(CASES)
    sys.exit(0)


# --------------------------------------------------- the JAX references
def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from aread_tpu.parallel import embed_shard as JE
    from aread_tpu.parallel.mesh import make_mesh as jmake_mesh
    return types.SimpleNamespace(jax=jax, jnp=jnp, NS=NamedSharding, P=P,
                                 JE=JE, make_mesh=jmake_mesh)


@pytest.mark.parametrize("data,model", [(4, 2), (2, 2)])
def test_lookups_match_jax_mesh(tmp_path, data, model):
    J = _jax()
    jnp = J.jnp
    rng = np.random.default_rng(data * 10 + model)
    R, E, B, F = 64, 8, 16, 5
    rows_per = R // model
    table = rng.normal(size=(R, E)).astype(np.float32)
    ids = rng.integers(0, R, size=(B, F)).astype(np.int64)
    # the shard edges, and duplicates
    edges = [k * rows_per for k in range(model)] + [rows_per - 1, R - 1]
    ids[0, :len(edges)] = edges
    ids[1] = ids[0]
    cot = rng.normal(size=(B, F, E)).astype(np.float32)
    cap = PE.a2a_required_capacity(ids, R, model, n_data=data)
    torch.save({"mesh": (data, model), "table": torch.tensor(table),
                "ids": torch.tensor(ids), "cot": torch.tensor(cot),
                "cap": cap}, tmp_path / "lookups_in.pt")
    got = spawn(__file__, "lookups", data * model, tmp_path)

    mesh = J.make_mesh(data, model)
    tab = J.jax.device_put(jnp.asarray(table),
                           J.NS(mesh, J.P("model", None)))
    jids = J.jax.device_put(jnp.asarray(ids, jnp.int32),
                            J.NS(mesh, J.P("data", None)))
    want = {}
    for name, cap_ in (("sharded", None), ("a2a", None), ("a2a_cap", cap)):
        f = ((lambda t: J.JE.sharded_lookup(t, jids, mesh)) if name == "sharded"
             else (lambda t, c=cap_: J.JE.a2a_lookup(t, jids, mesh, c)))

        def fwd_bwd(t, ct, f=f):
            out, vjp = J.jax.vjp(f, t)
            return out, vjp(ct)[0]

        out, grad = J.jax.jit(fwd_bwd)(tab, jnp.asarray(cot))
        want[name] = (np.asarray(out), np.asarray(grad))
    overflow = np.asarray(J.jax.jit(
        lambda t: J.JE.a2a_lookup(t, jids, mesh, 1))(tab))
    assert np.isnan(overflow).all()  # the JAX side poisons too

    b = B // data
    for r, res in enumerate(got):
        di, mi = res["mesh"]
        assert (di, mi) == divmod(r, model)
        sl, tl = slice(di * b, (di + 1) * b), slice(mi * rows_per,
                                                   (mi + 1) * rows_per)
        for name, (fwd, grad) in want.items():
            o, g = res[name]
            # forward: bitwise the gather (exactly one shard holds a row)
            np.testing.assert_array_equal(o.numpy(), fwd[sl], err_msg=name)
            np.testing.assert_array_equal(o.numpy(), table[ids[sl]])
            np.testing.assert_allclose(g.numpy(), grad[tl], rtol=0,
                                       atol=1e-6, err_msg=name)
        assert torch.isnan(res["overflow"]).all(), r


def test_barrier_meets_and_its_deadline_fires(tmp_path):
    got = spawn(__file__, "barrier", 2, tmp_path)
    assert got[1] == {"slept": True}
    err = got[0]["error"]
    assert err is not None and "late" in err, got[0]
    # raised near the 1 s deadline, not after the sleeper woke
    assert got[0]["seconds"] < 3.5, got[0]


def test_barrier_is_a_no_op_in_one_process():
    health.barrier("alone", 0.01)


# ----------------------------------------------------------- in-process
def _mesh_of(data, model, rank=0):
    return Mesh(data, model, rank, torch.device("cpu"), None,
                {"data": None, "model": None})


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_sparse_adam_matches_jax(model, dtype):
    """Each model rank's update of its rows from the same global ids and
    row gradients (ids at the shard edges among them):

    * against the JAX package's shard_map update at the tolerances of the
      unsharded comparison (tests/test_torch_port_sparse_adam.py: the
      plain version is within 1e-6 of JAX's XLA update, not bitwise — XLA
      contracts a*b+c differently — so f32 atol 1e-6; a bf16 table within
      one bf16 ulp and bitwise on >= 99.9 % of its elements);
    * bitwise, f32: the concatenated shards are the unsharded update;
    * bitwise, bf16: each shard is the plain update of its rows with the
      rank's own stochastic-rounding seed t * model + index, and keying
      every shard on t instead would change > 1 % of the elements (the
      JAX comparison above would then fail: it decorrelates the shards)."""
    J = _jax()
    jnp = J.jnp
    from aread_tpu.parallel.sharded_adam import (
        sharded_sparse_table_adam as j_sharded)
    from aread_tpu_torch.ops.sparse_adam import (dedup_rows,
                                                 sparse_adam_reference)
    from aread_tpu_torch.parallel.sharded_adam import shard_run

    n_rows, D, t = 256, 8, 3
    rows_per = n_rows // model
    rng = np.random.default_rng(model)
    ids = rng.integers(0, n_rows, size=(300,)).astype(np.int32)
    edges = np.array([k * rows_per for k in range(model)]
                     + [k * rows_per - 1 for k in range(1, model + 1)],
                     np.int32)
    ids = np.concatenate([ids, edges, edges])
    g = rng.normal(size=(len(ids), D)).astype(np.float32)
    w = rng.normal(size=(n_rows, D)).astype(np.float32)
    m = (0.1 * rng.normal(size=(n_rows, D))).astype(np.float32)
    v = (0.01 * rng.random(size=(n_rows, D))).astype(np.float32)
    kw = dict(lr=1e-2, weight_decay=1e-8, l2=1e-5)
    jdt = getattr(jnp, dtype)
    mesh = J.make_mesh(1, model)
    sh = J.NS(mesh, J.P("model", None))
    put = lambda a, dt: J.jax.device_put(jnp.asarray(a, dt), sh)
    want = J.jax.jit(lambda *a: j_sharded(*a, mesh=mesh, **kw))(
        put(w, jdt), put(m, jdt), put(v, jdt), jnp.asarray(ids),
        jnp.asarray(g), jnp.asarray(t, jnp.int32))
    want = [np.asarray(a.astype(jnp.float32)) for a in want]

    tdt = getattr(torch, dtype)
    start = [torch.tensor(a).to(tdt) for a in (w, m, v)]
    uids, gsum = dedup_rows(torch.tensor(ids), torch.tensor(g), n_rows)
    shards, plain, same_seed = [], [], []
    for mi in range(model):
        sl = slice(mi * rows_per, (mi + 1) * rows_per)
        ws, ms, vs = (a[sl].clone() for a in start)
        local, gloc = shard_run(uids, gsum, mi * rows_per, rows_per)
        plain.append(sparse_adam_reference(ws, ms, vs, local, gloc, t,
                                           sr_seed=t * model + mi, **kw))
        same_seed.append(sparse_adam_reference(ws, ms, vs, local, gloc, t,
                                               **kw)[0])
        sharded_sparse_table_adam(ws, ms, vs, torch.tensor(ids),
                                  torch.tensor(g), t, _mesh_of(1, model, mi),
                                  **kw)
        shards.append((ws, ms, vs))
    for k in range(3):
        got = torch.cat([s[k] for s in shards])
        for s, p in zip(shards, plain):
            assert torch.equal(s[k], p[k]), k
        a, b = want[k], got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=str(k))
            whole = sparse_adam_reference(*start, uids, gsum, t, **kw)[k]
            assert torch.equal(got, whole), k
            continue
        diff = a != b
        assert diff.mean() <= 1e-3, (k, diff.mean())
        assert (np.abs(a - b)[diff]
                <= (np.abs(a) * 2.0**-7 + 1e-30)[diff]).all(), k
    if dtype == "bfloat16":
        one_stream = torch.cat(same_seed).float().numpy()
        assert (one_stream != want[0]).mean() > 1e-2


def test_sharded_sparse_adam_model_one_is_the_unsharded_update():
    from aread_tpu_torch.ops.sparse_adam import (dedup_rows,
                                                 sparse_adam_reference)

    rng = np.random.default_rng(0)
    w = torch.randn(40, 8, generator=torch.Generator().manual_seed(0))
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    ids = torch.tensor(rng.integers(0, 40, size=30), dtype=torch.int32)
    g = torch.tensor(rng.normal(size=(30, 8)), dtype=torch.float32)
    want = sparse_adam_reference(w, m, v, *dedup_rows(ids, g, 40), 1, lr=1e-3)
    sharded_sparse_table_adam(w, m, v, ids, g, 1, _mesh_of(1, 1), lr=1e-3)
    for a, b in zip((w, m, v), want):
        assert torch.equal(a, b)


def _synthetic():
    from aread_tpu_torch.data.loader import make_synthetic_data
    return make_synthetic_data(n_rows=2048, n_domain=4, vocab=100, seed=0)


def test_capacity_functions_equal_jax():
    import dataclasses

    from aread_tpu.config import Config as JConfig
    from aread_tpu.models.base import FeatureSpec as JFeatureSpec
    from aread_tpu_torch.config import Config

    J = _jax()
    data = _synthetic()
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    x = data.train_x[:256]
    for flat in (False, True):
        spec = data.spec.pad_vocab(2)
        jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).pad_vocab(2)
        if flat:
            spec, jspec = spec.with_flat_table(8), jspec.with_flat_table(8)
        ids, n = PE.lookup_ids(spec, 8, x)
        jids, jn = J.JE.lookup_ids(jspec, 8, x)
        np.testing.assert_array_equal(ids, jids)
        assert n == jn
        for n_model, n_data in ((2, 4), (4, 2), (8, 1)):
            assert (PE.a2a_required_capacity(ids, n, n_model, n_data)
                    == J.JE.a2a_required_capacity(jids, jn, n_model, n_data))
        pools = [(data.train_x, 256), (data.valid_x, 2048)]
        for cap in (0, 64, -1, 1):
            cfg = Config(bs=256, embed_dim=8, embed_lookup="a2a",
                         a2a_capacity=cap)
            jcfg = JConfig(bs=256, embed_dim=8, embed_lookup="a2a",
                           a2a_capacity=cap)
            results = []
            for fn, c, s in ((PE.resolve_a2a_capacity, cfg, spec),
                             (J.JE.resolve_a2a_capacity, jcfg, jspec)):
                try:
                    results.append(fn(c, mesh, s, 8, pools, seed=3))
                except ValueError as e:
                    results.append(str(e))
            assert results[0] == results[1], (flat, cap, results)
            errors = []
            for fn, c, s in ((PE.check_a2a_capacity, cfg, spec),
                             (J.JE.check_a2a_capacity, jcfg, jspec)):
                try:
                    errors.append(fn(c, mesh, s, 8, x))
                except ValueError as e:
                    errors.append(str(e))
            assert errors[0] == errors[1], (flat, cap, errors)
        assert "below the calibrated requirement" in results[0]  # cap 1
        off = Config(embed_lookup="gspmd", a2a_capacity=7)
        assert PE.resolve_a2a_capacity(off, mesh, spec, 8, pools) == 7


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4])
def test_host_sharded_batcher_bitwise_jax(n_proc):
    from aread_tpu.data.loader import DomainBatcher as JDomainBatcher
    from aread_tpu.parallel import distributed as JD

    for parts in ((7,), (7, 1, 2), (2**64 - 1, 0, 5)):
        for n in (1, 10, 97):
            np.testing.assert_array_equal(PD._perm(n, *parts),
                                          JD._perm(n, *parts))
    data = _synthetic()
    gbs = 12 * n_proc
    mine = [PD.HostShardedDomainBatcher(data.train_x, data.train_y, gbs, 2, 4,
                                        p, n_proc, seed=5)
            for p in range(n_proc)]
    theirs = [JD.HostShardedDomainBatcher(data.train_x, data.train_y, gbs, 2,
                                          4, p, n_proc, seed=5)
              for p in range(n_proc)]
    for epoch in range(2):
        assert mine[0].domain_batch_seq == theirs[0].domain_batch_seq
        for d in mine[0].domain_batch_seq + [0, 1, 1, 3]:
            got = [b.next_batch(d) for b in mine]
            for b, g in zip(theirs, got):
                want = b.next_batch(d)
                for k in want:
                    np.testing.assert_array_equal(g[k], want[k], err_msg=k)
            whole = {k: np.concatenate([g[k] for g in got]) for k in got[0]}
            assert whole["x"].shape[0] == gbs
            # the valid rows are the domain's, padding at the tail
            valid = whole["valid"].astype(bool)
            assert (whole["x"][valid, 2] == d).all()
            assert not valid[np.argmin(valid):].any() or valid.all()
        for b in mine + theirs:
            b.shuffle_seq()
    # device_batch: the slice on the rank's device
    mesh = _mesh_of(1, 1)
    db = PD.HostShardedDomainBatcher(data.train_x, data.train_y, 8, 2, 4, 0, 1)
    assert all(t.device == mesh.device
               for t in db.device_batch(0, mesh).values())
    del JDomainBatcher


def test_make_mesh_in_one_process():
    mesh = make_mesh(1, 1, device="cpu")
    assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
    assert mesh.groups == {"data": None, "model": None}
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(mesh.all_reduce_(x.clone(), "data"), x)
    assert torch.equal(gather_rows(shard_rows(x, mesh), mesh), x)
    assert mesh.rows(8) == slice(0, 8)
    with pytest.raises(ValueError, match="data=2 x model=2 needs 4 "
                                         "processes.*torch.distributed.run"):
        make_mesh(2, 2, device="cpu")
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12
    sd = {"embedding.table": torch.zeros(4, 2), "linear.kernel": torch.zeros(4, 1),
          "bn.mean": torch.zeros(3), "x.table": torch.zeros(3)}
    assert param_shardings(sd) == {"embedding.table": "model",
                                   "linear.kernel": "replicated",
                                   "bn.mean": "replicated",
                                   "x.table": "replicated"}
    # the rank's rows of a batch and of a table
    m = _mesh_of(2, 2, rank=3)
    assert (m.data_index, m.model_index) == (1, 1)
    assert m.rows(8) == slice(4, 8) and m.table_rows(10) == slice(5, 10)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        m.table_rows(9)
    with pytest.raises(ValueError, match="does not split over data=2"):
        m.rows(7)


def test_backend_rule(monkeypatch):
    assert PD.collective_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert PD.collective_backend("cuda") == "gloo"  # 4 ranks on one card
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert PD.collective_backend("cuda") == "nccl"
    # one process and no launcher: nothing is started
    for k in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert PD.initialize("cpu") is None


def test_pad_table_rows():
    t = torch.ones(5, 3)
    p = PE.pad_table_rows(t, 4)
    assert p.shape == (8, 3) and torch.equal(p[:5], t) and not p[5:].any()
    assert PE.pad_table_rows(t, 5) is t
    ids = torch.tensor([[0, 4], [2, 2]])
    assert torch.equal(PE.lookup_reference(t, ids), t[ids])


def test_sharded_dense_update_rounds_each_shard_with_its_own_seed():
    """Kernel 2 on a row shard (the dense-gradient mesh step): each shard
    rounds with its own rows' stream of the one table, keyed on the step
    and the global element index (``index_base``, the shard's first
    element), as the JAX package's GSPMD update on its row-sharded table
    does. So f32 and bf16 shards are bitwise the one-device update's rows;
    they agree with JAX's ``reference_adam_update`` on the whole table,
    sliced, at ``test_torch_port_fused_adam.py``'s tolerances (moments
    bitwise; the weights within one ulp of their type, bitwise on >= 99.9 %
    of the elements); and a shard whose global indices would pass 2^32 is
    refused."""
    import jax.numpy as jnp

    from aread_tpu.ops.pallas.fused_adam import reference_adam_update
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.models.deepfm import DeepFM
    from aread_tpu_torch.ops.fused_adam import (fused_adam_dispatch,
                                                fused_adam_reference)
    from aread_tpu_torch.train.trainer import (DenseAdam, hybrid_init,
                                               hybrid_update)

    spec = FeatureSpec((30, 7, 11), 0, 0, 1, 5)
    g = torch.Generator().manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        spec_d = dataclasses.replace(spec, table_dtype=dtype)
        whole = DeepFM(spec_d, 8, mlp_dims=(4,), device="cpu")
        g_table = torch.randn(whole.embedding.table.shape, generator=g)
        opt = DenseAdam(lr=1e-2)
        st = hybrid_init(opt, whole)
        # moments carried from an earlier step, so that m and v are compared
        # on values that are not all zero
        st["m"].copy_(0.1 * torch.randn(st["m"].shape, generator=g))
        st["v"].copy_(0.01 * torch.rand(st["v"].shape, generator=g))
        rest = {n: torch.zeros_like(p)
                for n, p in whole.dense_named_parameters().items()}
        before = whole.embedding.table.clone()
        m0, v0 = st["m"].clone(), st["v"].clone()
        shards = []
        for mi in range(2):
            model = DeepFM(spec_d, 8, mlp_dims=(4,), device="cpu")
            model.load_state_dict(whole.state_dict())
            mesh = _mesh_of(1, 2, rank=mi)
            model.embedding.shard_(mesh)
            sst = hybrid_init(opt, model)
            sl = mesh.table_rows(spec.n_rows)
            sst["m"].copy_(m0[sl])
            sst["v"].copy_(v0[sl])
            hybrid_update(opt, 1e-2, 1e-8, model, dict(rest), g_table[sl],
                          sst, mesh=mesh)
            want = fused_adam_reference(before[sl], m0[sl], v0[sl],
                                        g_table[sl], 1, lr=1e-2,
                                        weight_decay=1e-8, l2=1e-5,
                                        index_base=sl.start * 8)
            assert torch.equal(model.embedding.table, want[0])
            shards.append((model.embedding.table, sst["m"], sst["v"]))
        hybrid_update(opt, 1e-2, 1e-8, whole, dict(rest), g_table, st)
        one = (whole.embedding.table, st["m"], st["v"])
        for i in range(3):
            assert torch.equal(torch.cat([s[i] for s in shards]), one[i]), \
                (dtype, "wmv"[i])
        # JAX's update of the whole table, sliced to each shard's rows
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jw = reference_adam_update(
            *(jnp.asarray(x.float().numpy()).astype(jdt)
              for x in (before, m0, v0)),
            jnp.asarray(g_table.numpy()),
            jnp.int32(1), lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
            weight_decay=1e-8, l2=1e-5)
        for mi, shard in enumerate(shards):
            sl = _mesh_of(1, 2, rank=mi).table_rows(spec.n_rows)
            for name, a, b in zip("wmv", jw, shard):
                a = np.asarray(a.astype(jnp.float32))[sl]
                b = b.float().numpy()
                if name != "w":
                    np.testing.assert_array_equal(b, a, err_msg=name)
                    continue
                diff = a != b
                assert diff.mean() <= 1e-3, (dtype, diff.mean())
                ulp = (np.abs(a) * 2.0**-7 + 1e-30 if dtype == "bfloat16"
                       else np.spacing(np.abs(a)))
                assert (np.abs(a - b)[diff] <= ulp[diff]).all(), dtype
    w = torch.zeros((4, 8))
    for base in (2**32 - 32, -1):
        with pytest.raises(ValueError, match="2\\^32"):
            fused_adam_dispatch(w, w.clone(), w.clone(), w.clone(), 1,
                                lr=1e-3, index_base=base)
    fused_adam_dispatch(w, w.clone(), w.clone(), w.clone(), 1, lr=1e-3,
                        index_base=2**32 - 33)


def test_make_sharded_train_step_is_the_trainers_dense_step():
    """``make_sharded_train_step`` on a 1 x 1 mesh (one process, no
    process group): its step and placement are the generic Trainer's
    dense-gradient step, so two steps from the same weights leave the same
    weights, bitwise, and the same losses; the table is sharded in place
    (``shard_params``), and an unknown lookup raises."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import GlobalBatcher, make_synthetic_data
    from aread_tpu_torch.models.deepfm import DeepFM
    from aread_tpu_torch.parallel.train_step import (make_sharded_train_step,
                                                     shard_params)
    from aread_tpu_torch.train.trainer import DenseAdam, Trainer

    data = make_synthetic_data(n_rows=256, n_domain=2, vocab=30, seed=1)
    models = [DeepFM(data.spec, 8, mlp_dims=(8,), device="cpu")
              for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    mesh = make_mesh(1, 1, device="cpu")
    step, place = make_sharded_train_step(
        models[0], DenseAdam(lr=1e-3), mesh, type(models[0]).REG_RULES,
        is_multi_tower=False)
    assert models[0].embedding.mesh is mesh
    assert shard_params(models[0], mesh)["embedding.table"] == "model"
    tr = Trainer(models[1], Config(model="deepfm", embed_dim=8,
                                   sparse_table_grad=False,
                                   table_moments_dtype=None), 2)
    tr.init()
    for b in list(GlobalBatcher(data.train_x, data.train_y, 32, 2))[:2]:
        assert float(step(place(b))) == float(tr.step(b))
    for k, v in models[1].state_dict().items():
        assert torch.equal(models[0].state_dict()[k], v), k
    with pytest.raises(ValueError, match="embed_lookup"):
        make_sharded_train_step(models[1], DenseAdam(lr=1e-3), mesh, (),
                                False, embed_lookup="other")
