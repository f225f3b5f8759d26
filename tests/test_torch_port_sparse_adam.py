"""The port's sparse Adam (aread_tpu_torch/ops/sparse_adam.py, CPU path:
the plain version) against the JAX package's XLA path and its Pallas
kernel in interpret mode, on the same seed-made inputs. Tolerances: f32
atol 1e-6 (the JAX package's own kernel-vs-XLA tolerance); a bf16 table
within one bf16 ulp everywhere and bitwise on >= 99.9 % of elements (an
f32 difference of one ulp before the stochastic rounding can flip it);
sum(w^2) rtol 1e-6 against the exact sum. ``dedup_rows`` bitwise the JAX
package's on the orders the card's kernel must keep (one id K times, all
distinct, a pad run beside Zipf ids, ragged runs; D 8, 32, 64;
``tools/dedup_card.py`` checks the kernel on the same cases), and its
kernel's counters read into the store and by the benchmark's readers."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.ops.pallas.sparse_adam_kernel import (BLOCK_F,
                                                     sparse_adam_kernel_update)
from aread_tpu.ops.sparse_adam import dedup_rows as j_dedup_rows
from aread_tpu.ops.sparse_adam import sparse_adam_dispatch as j_dispatch
from aread_tpu_torch.ops import sparse_adam
from aread_tpu_torch.ops.sparse_adam import (dedup_rows, sparse_adam_dispatch,
                                             sparse_adam_reference)
from aread_tpu_torch.utils import profiling
from perfbench import registry
from tools.dedup_card import dedup_case

KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5)
# straddles two TPU kernel blocks with a ragged tail, as
# tests/test_sparse_adam.py's kernel test
N_ROWS, D, K = (BLOCK_F + 513) * 16, 8, 256


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N_ROWS, D)).astype(np.float32)
    m = (rng.normal(size=(N_ROWS, D)) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=(N_ROWS, D))) * 0.01).astype(np.float32)
    ids = rng.integers(0, N_ROWS, K).astype(np.int32)
    ids[:8] = np.arange(N_ROWS - 8, N_ROWS)  # the ragged last block
    ids[8:40] = ids[40:72]  # duplicates
    g = rng.normal(size=(K, D)).astype(np.float32)
    return w, m, v, ids, g


def test_dedup_rows_bitwise():
    _, _, _, ids, g = _inputs()
    ju, jg = j_dedup_rows(jnp.asarray(ids), jnp.asarray(g), N_ROWS)
    tu, tg = dedup_rows(torch.as_tensor(ids), torch.as_tensor(g), N_ROWS)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert (tu.numpy() == N_ROWS).sum() >= 32  # sentinels in the tail


# the dedup kernel's ordering cases (ops/cuda/dedup_rows.cu): each id's
# rows added in sorted order from 0, whichever path its run takes on the
# card (a warp for a run of at most 32 rows, a block staging a longer one)
DEDUP_CASES = [("one_id", 1000, 32), ("all_distinct", 1000, 32),
               ("pad_zipf", 2176, 8), ("pad_zipf", 2176, 32),
               ("pad_zipf", 2176, 64), ("ragged", 1001, 32)]


@pytest.mark.parametrize("case,k,d", DEDUP_CASES)
def test_dedup_rows_orders_bitwise(case, k, d):
    ids, g, n_rows = dedup_case(case, k, d)
    ju, jg = j_dedup_rows(jnp.asarray(ids), jnp.asarray(g), n_rows)
    tu, tg = dedup_rows(torch.tensor(ids), torch.tensor(g), n_rows)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    _, counts = np.unique(ids, return_counts=True)
    assert (tu.numpy() < n_rows).sum() == len(counts)
    assert not tg.numpy()[len(counts):].any()  # zero rows past the last run
    if case == "pad_zipf":
        assert 0.25 <= (ids == 0).mean() <= 0.35
    if case in ("one_id", "pad_zipf", "ragged"):
        assert counts.max() > 32  # a run the card stages


def test_dedup_counts_reach_the_store_and_its_readers(monkeypatch):
    """The dedup kernel's counters (``_Scratch.dedup``: rows summed through
    its staged path, all rows) reach the store's ``DEDUP_COUNTERS`` as
    increases at ``fetch_tiny_counts``' reads, apart under a profiler, and
    the readers ``dedup_staged_pct.*`` give 100 x staged / all in their
    cells' kind, None in another kind and from a store without them."""
    store = profiling.Store()
    monkeypatch.setattr(sparse_adam, "STORE", store)
    monkeypatch.setattr(profiling, "STORE", store)
    monkeypatch.setattr(sparse_adam, "_SLOTS", {})
    monkeypatch.setattr(sparse_adam, "_TINY_READ", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    kinds = {"dedup_staged_pct.train": "train", "dedup_staged_pct.zoo": "train",
             "dedup_staged_pct.pepnet": "train",
             "dedup_staged_pct.evolve": "evolve"}
    for metric, kind in kinds.items():
        ctx = types.SimpleNamespace(kind=kind)
        assert registry.reader(metric)(ctx) is None  # nothing counted yet
    cpu = torch.device("cpu")  # stands in for a card
    scratch = sparse_adam._slot_map(cpu, 64)
    assert scratch.dedup.dtype == torch.int64
    assert scratch.dedup.tolist() == [0, 0]
    scratch.dedup.copy_(torch.tensor([5, 17]))
    record = sparse_adam.fetch_tiny_counts()
    scratch.dedup.copy_(torch.tensor([40, 100]))  # after the copy: not seen
    assert record() == (0, 0)  # the sweeps' two, apart from these
    staged, rows = sparse_adam.DEDUP_COUNTERS
    assert store.counts[staged] == 5 and store.counts[rows] == 17
    assert sparse_adam.fetch_tiny_counts()() == (0, 0)
    assert store.counts[staged] == 40 and store.counts[rows] == 100
    scratch.dedup.copy_(torch.tensor([41, 110]))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        sparse_adam.fetch_tiny_counts()()
    assert store.counts[staged + ".traced"] == 1
    assert store.counts[rows + ".traced"] == 10 and store.counts[rows] == 100
    for metric, kind in kinds.items():
        read = registry.reader(metric)
        assert read(types.SimpleNamespace(kind=kind)) == 40.0
        other = "evolve" if kind == "train" else "train"
        assert read(types.SimpleNamespace(kind=other)) is None


def _f32(a):
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("against", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("variant", ["f32", "bf16", "f32_l2", "bf16_l2"])
def test_sparse_adam_matches_jax(variant, against):
    w, m, v, ids, g = _inputs()
    bf16 = variant.startswith("bf16")
    want_l2 = variant.endswith("l2")
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    ju, jg = j_dedup_rows(jnp.asarray(ids), jnp.asarray(g), N_ROWS)
    t = 5
    jargs = (jnp.asarray(w).astype(jdt), jnp.asarray(m).astype(jdt),
             jnp.asarray(v).astype(jdt), ju, jg, jnp.int32(t))
    if against == "xla":
        jout = j_dispatch(*jargs, want_l2=want_l2, **KW)
    else:
        jout = sparse_adam_kernel_update(*jargs, interpret=True,
                                         want_l2=want_l2, **KW)
    tw, tm, tv = (torch.tensor(a).to(tdt) for a in (w, m, v))
    tu, tg = dedup_rows(torch.as_tensor(ids), torch.as_tensor(g), N_ROWS)
    l2 = sparse_adam_dispatch(tw, tm, tv, tu, tg, t, want_l2=want_l2, **KW)
    for name, a, b in zip("wmv", jout[:3], (tw, tm, tv)):
        a = np.asarray(a.astype(jnp.float32))
        b = b.float().numpy()
        if not bf16:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=name)
            continue
        diff = a != b
        assert diff.mean() <= 1e-3, (name, diff.mean())
        ulp = np.abs(a) * 2.0**-7 + 1e-30  # one bf16 ulp bounds any flip
        assert (np.abs(a - b)[diff] <= ulp[diff]).all(), name
    if want_l2:
        # the port's sum against the exact one at rtol 1e-6; against the
        # JAX package's at 2e-6, since the Pallas kernel carries its sum
        # in f32 across blocks (1.3e-6 off the exact sum here)
        exact = float(np.sum(np.square(_f32(jargs[0]).astype(np.float64))))
        np.testing.assert_allclose(float(l2), exact, rtol=1e-6)
        np.testing.assert_allclose(float(l2), float(jout[3]), rtol=2e-6)
    else:
        assert l2 is None


def test_dispatch_cpu_is_the_plain_version_in_place():
    """On CPU tensors the dispatch writes the plain version's result into
    w, m, v bitwise."""
    w, m, v, ids, g = _inputs(seed=4)
    tu, tg = dedup_rows(torch.as_tensor(ids), torch.as_tensor(g), N_ROWS)
    args = [torch.tensor(a).to(torch.bfloat16) for a in (w, m, v)]
    ref = sparse_adam_reference(*args, tu, tg, 3, **KW)
    sparse_adam_dispatch(*args, tu, tg, 3, **KW)
    for a, b in zip(args, ref):
        assert torch.equal(a, b)
