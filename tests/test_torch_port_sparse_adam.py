"""The port's sparse Adam (aread_tpu_torch/ops/sparse_adam.py, CPU path:
the plain version) against the JAX package's XLA path and its Pallas
kernel in interpret mode, on the same seed-made inputs. Tolerances: f32
atol 1e-6 (the JAX package's own kernel-vs-XLA tolerance); a bf16 table
within one bf16 ulp everywhere and bitwise on >= 99.9 % of elements (an
f32 difference of one ulp before the stochastic rounding can flip it);
sum(w^2) rtol 1e-6 against the exact sum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.ops.pallas.sparse_adam_kernel import (BLOCK_F,
                                                     sparse_adam_kernel_update)
from aread_tpu.ops.sparse_adam import dedup_rows as j_dedup_rows
from aread_tpu.ops.sparse_adam import sparse_adam_dispatch as j_dispatch
from aread_tpu_torch.ops.sparse_adam import (dedup_rows, sparse_adam_dispatch,
                                             sparse_adam_reference)

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
