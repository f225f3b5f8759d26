"""MAMDR in the port (aread_tpu_torch/models/mamdr.py,
aread_tpu_torch/train/mamdr.py) against the JAX package's:

* ``reptile_update`` and ``tree_add`` bitwise against
  aread_tpu.train.mamdr's, in f32 and in bf16 (the JAX package multiplies
  a bf16 array by the weak-typed meta_lr cast to bf16; torch's
  ``bf16 * 0.1`` computes with 0.1 in f32 and differs in the last bit,
  which the test shows too. On the CPU torch's in-place foreach multiply
  happens to round the scalar as well; the card's foreach kernels do not,
  and chip_smoke.py holds the two devices to each other bitwise);
* one ``MamdrTrainer.fit`` epoch against the JAX one from the same
  converted weights and the same seed, at 3 domains, toy widths, the
  sparse table gradient with an f32 table and moments, dropout 0: the
  meta weights, domain 0's weights and the valid and test metrics at atol
  1e-4 (63 Adam steps of f32 round-off). The linear biases that feed a
  BatchNorm get their true gradient, exactly 0, on both sides (see
  tests/test_torch_port_trainer.py);
* the Reptile schedule itself: every sequence starts from a fresh
  optimizer with the table's moments in the table's dtype, weights are
  swapped into the same tensors, and after ``fit`` the model holds the
  meta weights."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import aread_tpu.train.mamdr as JM
import aread_tpu.train.trainer as JT
from aread_tpu.config import Config as JConfig
from aread_tpu.data.loader import SplitData as JSplitData
from aread_tpu.models.base import FeatureSpec as JFeatureSpec
from aread_tpu.models.mamdr import MAMDR as JMAMDR
from aread_tpu_torch.config import Config
from aread_tpu_torch.convert import _to_torch, convert_variables
from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
from aread_tpu_torch.models.mamdr import MAMDR
from aread_tpu_torch.train import mamdr as M
from aread_tpu_torch.train import trainer as T
from aread_tpu_torch.train.mamdr import MamdrTrainer, reptile_update, tree_add
from tests.test_torch_port_trainer import (DenseAdamTrueZero,  # noqa: F401
                                           jax_true_zero)
from tests.test_torch_port_zoo import seeded_variables

E, N_DOMAIN, BS = 8, 3, 64
SHAPES = {"embedding/table": (50, 8), "mlp/linear_0/kernel": (24, 16),
          "mlp/linear_0/bias": (16,), "linear/bias": (1,)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite's workers share the host's cores,
    and small tensors on many threads each spin for the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(dtype, seed=0):
    """Three trees (update, new, old) of numpy arrays in ``dtype``."""
    rng = np.random.default_rng(seed)
    return [{n: rng.standard_normal(s).astype(np.float32).astype(dtype)
             for n, s in SHAPES.items()} for _ in range(3)]


@pytest.mark.parametrize("dtype,meta_lr", [
    (np.float32, 0.1), (np.float32, 0.37), (ml_dtypes.bfloat16, 0.1),
    (ml_dtypes.bfloat16, 0.37)], ids=["f32-0.1", "f32-0.37", "bf16-0.1",
                                      "bf16-0.37"])
def test_reptile_arithmetic_is_bitwise_jax(dtype, meta_lr):
    u, n, o = _trees(dtype)
    want = JM.reptile_update(*[{k: jnp.asarray(v) for k, v in t.items()}
                               for t in (u, n, o)], meta_lr)
    tu, tn, to = [{k: _to_torch(v) for k, v in t.items()} for t in (u, n, o)]
    got = reptile_update(tu, tn, to, meta_lr)
    added = tree_add(tu, tn)
    want_add = JM.tree_add({k: jnp.asarray(v) for k, v in u.items()},
                           {k: jnp.asarray(v) for k, v in n.items()})
    for k in SHAPES:
        assert got[k].dtype == tu[k].dtype == _to_torch(
            np.asarray(want[k])).dtype, k
        assert torch.equal(got[k], _to_torch(np.asarray(want[k]))), k
        assert torch.equal(added[k], _to_torch(np.asarray(want_add[k]))), k
    if dtype is ml_dtypes.bfloat16:
        # what the cast to bf16 keeps: torch's scalar product differs
        naive = {k: tu[k] + (tn[k] - to[k]) * meta_lr for k in SHAPES}
        assert any(not torch.equal(naive[k], got[k]) for k in SHAPES)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_data(n_rows=600, n_domain=N_DOMAIN, vocab=50,
                               seed=6)


CFG = dict(model="mamdr", embed_dim=E, bs=BS, dropout=0.0, seed=11,
           dataset_name="none", table_dtype="float32",
           table_moments_dtype="float32", mamdr_aux_sample_num=2)


def _pair(data):
    """(JAX trainer, its initial params and state, the port's trainer) from
    the same weights; the table padded as the sparse path pads it."""
    jcfg, cfg = JConfig(**CFG), Config(**CFG)
    assert cfg.sparse_table_grad  # the CLI default
    jspec = JFeatureSpec(*dataclasses.astuple(data.spec)[:5]).with_flat_table(E)
    tspec = data.spec.with_flat_table(E)
    jm = JMAMDR(spec=jspec, embed_dim=E, mlp_dims=(16, 8), dropout=0.0)
    variables = seeded_variables(jm, jnp.asarray(data.train_x[:8]),
                                 train=False)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    jt = JM.MamdrTrainer(jm, jcfg, N_DOMAIN)
    tm = MAMDR(tspec, E, mlp_dims=(16, 8), dropout=0.0, device="cpu")
    tm.load_state_dict(convert_variables(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state["batch_stats"]), E))
    tr = MamdrTrainer(tm, cfg, N_DOMAIN)
    tr.optimizer = DenseAdamTrueZero(lr=cfg.lr, wd=cfg.wd)
    return jt, params, state, tr


def _as_port(tree):
    """A JAX params tree as the port's {'a/b': tensor} (the table
    unpacked to [n_rows, D])."""
    sd = convert_variables(jax.tree_util.tree_map(np.asarray, tree), {}, E)
    return {k.replace(".", "/"): v for k, v in sd.items()}


def _close_weights(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=f"{what}: {k}")


def test_one_epoch_matches_the_jax_meta_trainer(data, monkeypatch,
                                                jax_true_zero):  # noqa: F811
    monkeypatch.delenv("AREAD_TPU_PALLAS_ADAM", raising=False)
    jt, params, state, tr = _pair(data)
    # JAX's fit draws its own weights: give it the pair's instead
    monkeypatch.setattr(jt, "init", lambda rng, sample: (
        params, state, JT.hybrid_init(jt.optimizer, params)))
    jdata = JSplitData(**{f.name: getattr(data, f.name)
                          for f in dataclasses.fields(data) if f.name != "spec"},
                       spec=jt.model.spec)
    jres = jt.fit(jdata, epochs=1, verbose=False)

    inits = []

    def spy_init(optimizer, model, *a, **kw):
        inits.append((a, kw))
        return T.hybrid_init(optimizer, model, *a, **kw)

    resets = []

    def spy_reset(state):
        resets.append(state)
        return T.hybrid_reset_(state)

    monkeypatch.setattr(M, "hybrid_init", spy_init)
    monkeypatch.setattr(M, "hybrid_reset_", spy_reset)
    table = tr.model.embedding.table
    tres = tr.fit(data, epochs=1, verbose=False)

    _close_weights(tres["meta_weights"], _as_port(jres["meta_weights"]),
                   "meta weights")
    _close_weights(tres["domain_weights"][0],
                   _as_port(jres["domain_weights"][0]), "domain 0's weights")
    for split, t, j in (("valid", tres["history"][0], jres["history"][0]),
                        ("test", tres["test"], jres["test"])):
        for k in ("total_auc", "mean_auc", "total_loss"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4,
                                       err_msg=f"{split} {k}")
    # 1 shared sequence + (2 aux + the domain itself) per domain, each from
    # a fresh optimizer whose table moments take the table's dtype: one
    # state made at the first sequence, put back to step 0 in place before
    # each later one
    assert len(inits) + len(resets) == 1 + 3 * N_DOMAIN and all(
        i == ((), {}) for i in inits)
    assert len(inits) == 1 and all(r is tr.opt_state for r in resets)
    # the same tensors throughout; the model ends on the meta weights
    assert tr.model.embedding.table is table
    for k, v in tr.live_weights().items():
        assert torch.equal(v, tres["meta_weights"][k]), k
    assert torch.equal(tr.best_checkpoint[0]["embedding.table"],
                       tres["meta_weights"]["embedding/table"])


def test_fresh_optimizer_and_weight_swaps(data):
    """``train_from`` copies the weights into the model's own tensors and
    restarts the optimizer: moments in the table's dtype (not
    table_moments_dtype), step count 0 before the first step."""
    cfg = Config(**{**CFG, "table_dtype": "bfloat16",
                    "table_moments_dtype": "float32"})
    spec = dataclasses.replace(data.spec.with_flat_table(E),
                               table_dtype="bfloat16")
    tm = MAMDR(spec, E, mlp_dims=(16, 8), dropout=0.0, device="cpu")
    tr = MamdrTrainer(tm, cfg, N_DOMAIN)
    live = tr.live_weights()
    ids = {k: v.data_ptr() for k, v in live.items()}
    weights = {k: torch.full_like(v, 0.5) for k, v in live.items()}
    b = DomainBatcher(data.train_x, data.train_y, BS, data.spec.domain_idx,
                      N_DOMAIN, seed=0)
    tr.train_from(weights, b, [])
    assert tr.opt_state["t"] == 0 and tr.opt_state["m"].dtype == torch.bfloat16
    for k, v in tr.live_weights().items():
        assert v.data_ptr() == ids[k] and torch.all(v == 0.5), k
    tr.train_from(weights, b, [0, 1])
    assert tr.opt_state["t"] == 2 and tr.opt_state["inner"]["count"] == 2
    assert not torch.equal(tr.model.embedding.table, weights["embedding/table"])
