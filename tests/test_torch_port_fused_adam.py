"""The port's fused dense Adam (aread_tpu_torch/ops/fused_adam.py, CPU
path: the plain version) against the JAX package's reference_adam_update,
its Pallas kernel in interpret mode and the optax chain, on the same
seed-made inputs; and the dense table update against the sparse one
inside the port.

Tolerances. Against reference_adam_update, f32 weights with f32 or bf16
moments: m and v bitwise (both sides take 1 - b in double and round, and
the bias corrections in f32); w within one f32 ulp, and bitwise on
>= 99.9 % of the elements (XLA's CPU code for the last line's two
divisions and square root is not IEEE-exact on every input: 2 of 33,000
elements are one ulp off). A bf16 weight leaf within one bf16 ulp
everywhere and bitwise on >= 99.9 % of the elements (an f32 difference of
one ulp before the stochastic rounding can flip it). Against the interpret-mode Pallas
kernel atol 1e-6, the JAX package's own tolerance (the kernel forms 1 - b
in f32). Dense against sparse inside the port: bitwise."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aread_tpu.ops.pallas.fused_adam import (fused_adam_update,
                                             reference_adam_update)
from aread_tpu.train.trainer import make_optimizer
from aread_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                            fused_adam_dispatch,
                                            fused_adam_reference)
from aread_tpu_torch.ops.sparse_adam import dedup_rows, sparse_adam_dispatch
from aread_tpu_torch.train.trainer import dense_table_grad

KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5)
SHAPES = [(1000, 33), (128,), (7, 5, 3)]
T = 3


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return w, m, v, g


def _f32(a):
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_matches_jax_to_one_ulp(shape, moments):
    w, m, v, g = _inputs(shape)
    jmdt = jnp.bfloat16 if moments == "bf16" else jnp.float32
    tmdt = torch.bfloat16 if moments == "bf16" else torch.float32
    want = reference_adam_update(
        jnp.asarray(w), jnp.asarray(m).astype(jmdt),
        jnp.asarray(v).astype(jmdt), jnp.asarray(g), jnp.int32(T), **KW)
    got = fused_adam_reference(
        torch.tensor(w), torch.tensor(m).to(tmdt), torch.tensor(v).to(tmdt),
        torch.tensor(g), T, **KW)
    for name, a, b in zip("wmv", want, got):
        assert b.shape == shape
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        a, b = _f32(a), b.float().numpy()
        if name != "w":
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        diff = a != b
        assert diff.mean() <= 1e-3, diff.mean()
        assert (np.abs(a - b)[diff] <= np.spacing(np.abs(a))[diff]).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_bf16_leaf_stochastic_rounding_matches_jax(shape):
    w, m, v, g = _inputs(shape, seed=2)
    want = reference_adam_update(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (w, m, v, g)),
        jnp.int32(T), **KW)
    got = fused_adam_reference(
        *(torch.tensor(a).to(torch.bfloat16) for a in (w, m, v, g)), T, **KW)
    for name, a, b in zip("wmv", want, got):
        assert b.dtype == torch.bfloat16
        a, b = _f32(a), b.float().numpy()
        diff = a != b
        assert diff.mean() <= 1e-3, (name, diff.mean())
        ulp = np.abs(a) * 2.0**-7 + 1e-30  # one bf16 ulp bounds any flip
        assert (np.abs(a - b)[diff] <= ulp[diff]).all(), name
    # the write is stochastic, not round-to-nearest: some elements differ
    # from the nearest bf16 of the f32 result
    f32_w = fused_adam_reference(
        torch.tensor(w).to(torch.bfloat16).float(),
        torch.tensor(m).to(torch.bfloat16), torch.tensor(v).to(torch.bfloat16),
        torch.tensor(g).to(torch.bfloat16), T, **KW)[0]
    if np.prod(shape) >= 128:
        assert (f32_w.to(torch.bfloat16) != got[0]).any()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_matches_pallas_interpret(shape):
    w, m, v, g = _inputs(shape)
    want = fused_adam_update(*(jnp.asarray(a) for a in (w, m, v, g)),
                             jnp.int32(T), interpret=True, **KW)
    got = fused_adam_reference(*(torch.tensor(a) for a in (w, m, v, g)), T,
                               **KW)
    for name, a, b in zip("wmv", want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_four_steps_match_optax_chain():
    """Multi-step agreement with the JAX trainer's optimizer on the same
    gradient stream (weight decay only; l2 = 0 so optax sees the same
    effective gradient), as tests/test_fused_adam.py holds the TPU kernel:
    rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(1)
    shape = (64, 16)
    lr, wd = 1e-2, 1e-8
    w0 = rng.normal(size=shape).astype(np.float32)
    opt = make_optimizer(lr, wd)
    w_opt = jnp.asarray(w0)
    opt_state = opt.init(w_opt)
    w, m, v = torch.tensor(w0), torch.zeros(shape), torch.zeros(shape)
    for t in range(1, 5):
        g = rng.normal(size=shape).astype(np.float32)
        updates, opt_state = opt.update(jnp.asarray(g), opt_state, w_opt)
        w_opt = optax.apply_updates(w_opt, updates)
        fused_adam_dispatch(w, m, v, torch.tensor(g), t, lr=lr,
                            weight_decay=wd)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_opt), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=str)
def test_dispatch_cpu_is_the_plain_version_in_place(wdt):
    w, m, v, g = _inputs((50, 8), seed=4)
    args = [torch.tensor(w).to(wdt), torch.tensor(m).to(torch.bfloat16),
            torch.tensor(v).to(torch.bfloat16)]
    ptrs = [a.data_ptr() for a in args]
    ref = fused_adam_reference(*args, torch.tensor(g), 3, **KW)
    assert fused_adam_dispatch(*args, torch.tensor(g), 3, **KW) is None
    for a, b, ptr in zip(args, ref, ptrs):
        assert torch.equal(a, b) and a.data_ptr() == ptr
    assert not torch.equal(args[0], torch.tensor(w).to(wdt))


def test_cuda_wrapper_refuses_cpu_tensors():
    w = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda(w, w.clone(), w.clone(), w.clone(), 1, lr=1e-3)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16], ids=str)
def test_dense_update_equals_sparse_update_bitwise(moments):
    """From the same f32 table and the same row gradients, the dense path
    (dense_table_grad -> fused Adam) and the sparse path (dedup_rows ->
    sparse Adam) leave bit-identical w, m, v."""
    n_rows, d, k = 300, 8, 256
    rng = np.random.default_rng(5)
    w, m, v, _ = _inputs((n_rows, d), seed=5)
    ids = rng.integers(0, n_rows, k).astype(np.int64)
    ids[:32] = ids[32:64]  # duplicates
    rows = rng.normal(size=(k, d)).astype(np.float32)
    dense = [torch.tensor(w), torch.tensor(m).to(moments),
             torch.tensor(v).to(moments)]
    sparse = [a.clone() for a in dense]
    g = dense_table_grad(torch.tensor(ids), torch.tensor(rows), n_rows,
                         torch.float32)
    assert g.shape == (n_rows, d) and g.is_contiguous()
    want_g = np.zeros((n_rows, d))
    np.add.at(want_g, ids, rows)  # f64; the port sums in f32, sorted
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-6)
    fused_adam_dispatch(*dense, g, T, **KW)
    uids, gsum = dedup_rows(torch.tensor(ids).to(torch.int32),
                            torch.tensor(rows), n_rows)
    sparse_adam_dispatch(*sparse, uids, gsum, T, **KW)
    for name, a, b in zip("wmv", dense, sparse):
        assert torch.equal(a, b), name
