"""The port's probes (aread_tpu_torch/ops/gather_rows.py,
ops/adam_attrib.py and aread_tpu_torch/benchmarks/), CPU path: the plain
versions against the TPU probes' JAX arithmetic on the same seed-made
inputs.

* Gather: ``gather_rows_reference`` against ``gather_rows_kernel`` of
  ``benchmarks/prof_dma_issue.py``, called through a ``pl.pallas_call``
  built exactly as ``bench_gather`` builds it, in interpret mode. Bitwise:
  both add in order in f32 (a pairwise sum differs in the last bits).
* Attribution: ``full`` against the JAX package's XLA sparse Adam and
  against its Pallas kernel in interpret mode (at [65,536, 32]: the
  kernel's window holds PAD_W = 384 distinct flat rows a block, which the
  batch overflows on a one-block [4,096, 32] table, where the package
  falls back to XLA); ``rtn``, ``dot1``, ``noslot`` (the TPU's ``nodots``) and
  ``noadam`` against their arithmetic from ``prof_kernel_attrib.py:68-108``
  written here in jnp (``variant_kernel`` is a closure inside its
  ``main``), with the densify as the dense scatter of gsum (its bf16
  ``hi`` part for ``dot1``) and the stochastic rounding of the JAX
  package's hash. Tolerance, tests/test_torch_port_sparse_adam.py's for a
  bf16 table: within one bf16 ulp everywhere and bitwise on >= 99.9 % of
  elements (an f32 difference of one ulp before the rounding can flip
  it); ``noadam`` bitwise, -0.0 told apart; ``copy`` (no JAX
  counterpart) equal to its inputs.
* The wrappers refuse CPU tensors, wrong dtypes and widths by name before
  any build; both entry points run with ``--device cpu`` and print their
  lines, and raise without a card otherwise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aread_tpu.ops.pallas.sparse_adam_kernel import (pack_meta,
                                                     sparse_adam_kernel_update)
from aread_tpu.ops.rounding import flat_index_grid as j_flat_index_grid
from aread_tpu.ops.rounding import sround as j_sround
from aread_tpu.ops.sparse_adam import dedup_rows as j_dedup_rows
from aread_tpu.ops.sparse_adam import sparse_adam_dispatch as j_dispatch
from aread_tpu_torch.benchmarks import prof_dma_issue, prof_kernel_attrib
from aread_tpu_torch.ops import adam_attrib, gather_rows
from aread_tpu_torch.ops.cuda import build
from aread_tpu_torch.ops.sparse_adam import dedup_rows
from benchmarks.prof_dma_issue import LANES, gather_rows_kernel

N_TABLE = 1000
N_ROWS, D, BS, F = 4096, 32, 64, 17
PALLAS_ROWS = 65536  # four kernel blocks of 16,384 rows
KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5)


def jax_gather(table, ids, rows):
    """bench_gather's pallas_call (prof_dma_issue.py:69-81), interpreted."""
    n = ids.shape[0]
    return pl.pallas_call(
        lambda ids_ref, hbm_ref, out_ref, scratch, sems:
            gather_rows_kernel(ids_ref, hbm_ref, out_ref, scratch, sems,
                               n=n, rows=rows),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, 1), memory_space=pltpu.SMEM),
            scratch_shapes=[pltpu.VMEM((2, rows, LANES), jnp.float32),
                            pltpu.SemaphoreType.DMA((2,))],
        ),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(ids, table)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("n", [37, 64])
def test_gather_reference_is_the_tpu_kernels_sum(n, rows):
    rng = np.random.default_rng(n + rows)
    table = rng.normal(size=(N_TABLE, LANES)).astype(np.float32)
    ids = rng.integers(0, N_TABLE - rows + 1, size=n).astype(np.int32)
    want = np.float32(jax_gather(jnp.asarray(table), jnp.asarray(ids),
                                 rows)[0, 0])
    got = gather_rows.gather_rows_reference(torch.tensor(table),
                                            torch.tensor(ids), rows)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.numpy().tobytes() == want.tobytes()
    # a pairwise sum is another function
    assert np.float32(table[ids, 0].sum()) != want or n < 8


def _attrib_inputs(n_rows=N_ROWS, seed=3):
    """bf16 w (every 97th weight -0.0), m, v; a batch of BS x F ids."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_rows, D)).astype(np.float32)
    w.reshape(-1)[::97] = -0.0
    m = (0.1 * rng.normal(size=(n_rows, D))).astype(np.float32)
    v = (0.01 * np.abs(rng.normal(size=(n_rows, D)))).astype(np.float32)
    ids = rng.integers(0, n_rows, size=BS * F).astype(np.int32)
    g = rng.normal(size=(BS * F, D)).astype(np.float32)
    return w, m, v, ids, g


def _jax_variant(mode, w, m, v, uids, gsum, t):
    """prof_kernel_attrib.py:68-108 on the whole table: the densify as the
    dense scatter of gsum (one-hot products of one nonzero term each), the
    TPU's PRNG replaced by the JAX package's hash."""
    n_rows, d = w.shape
    scal = dict(lr=jnp.float32(KW["lr"]), b1=jnp.float32(KW["b1"]),
                b2=jnp.float32(KW["b2"]), eps=jnp.float32(KW["eps"]),
                decay=jnp.float32(KW["weight_decay"] + 2 * KW["l2"]))
    tf = jnp.float32(t)
    b1c = 1.0 - scal["b1"] ** tf
    b2c = 1.0 - scal["b2"] ** tf
    omb1 = jnp.asarray(1.0 - KW["b1"], jnp.float32)
    omb2 = jnp.asarray(1.0 - KW["b2"], jnp.float32)
    live = uids < n_rows
    rows = jnp.where(live, uids, n_rows)
    if mode == "noslot":
        gfix = jnp.zeros((n_rows, d), jnp.float32)
    else:
        hi = gsum.astype(jnp.bfloat16)
        src = hi.astype(jnp.float32) if mode == "dot1" else gsum
        gfix = jnp.zeros((n_rows, d), jnp.float32).at[rows].set(
            src, mode="drop")
    if mode == "noadam":
        return w + gfix.astype(w.dtype) * 0, m, v
    wf = w.astype(jnp.float32)
    gg = gfix + scal["decay"] * wf
    m2 = scal["b1"] * m.astype(jnp.float32) + omb1 * gg
    v2 = scal["b2"] * v.astype(jnp.float32) + omb2 * gg * gg
    w2 = wf - scal["lr"] * (m2 / b1c) / (jnp.sqrt(v2 / b2c) + scal["eps"])
    if mode == "rtn":
        w2 = w2.astype(jnp.bfloat16)
    else:
        w2 = j_sround(w2, jnp.bfloat16, j_flat_index_grid(n_rows, d),
                      jnp.asarray(t, jnp.int32))
    return w2, m2.astype(m.dtype), v2.astype(v.dtype)


def _assert_bf16_close(a, b, name):
    """tests/test_torch_port_sparse_adam.py's bf16 tolerance."""
    a = np.asarray(a.astype(jnp.float32))
    b = b.float().numpy()
    diff = a != b
    assert diff.mean() <= 1e-3, (name, diff.mean())
    ulp = np.abs(a) * 2.0**-7 + 1e-30  # one bf16 ulp bounds any flip
    assert (np.abs(a - b)[diff] <= ulp[diff]).all(), name


@pytest.mark.parametrize("mode,against", [
    ("full", "xla"), ("full", "pallas_interpret"), ("rtn", "jnp"),
    ("dot1", "jnp"), ("noslot", "jnp"), ("noadam", "jnp")])
def test_attrib_modes_match_the_tpu_variants(mode, against):
    n_rows = PALLAS_ROWS if against == "pallas_interpret" else N_ROWS
    w, m, v, ids, g = _attrib_inputs(n_rows)
    t = 1
    ju, jg = j_dedup_rows(jnp.asarray(ids), jnp.asarray(g), n_rows)
    jw, jm, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (w, m, v))
    if against == "xla":
        want = j_dispatch(jw, jm, jv, ju, jg, jnp.int32(t), **KW)
    elif against == "pallas_interpret":
        assert not bool(pack_meta(ju, jg, n_rows, D)[3])  # no overflow
        want = sparse_adam_kernel_update(jw, jm, jv, ju, jg, jnp.int32(t),
                                         interpret=True, **KW)
    else:
        want = jax.jit(_jax_variant, static_argnums=(0, 6))(
            mode, jw, jm, jv, ju, jg, t)
    tw, tm, tv = (torch.tensor(a).to(torch.bfloat16) for a in (w, m, v))
    tu, tg = dedup_rows(torch.tensor(ids), torch.tensor(g), n_rows)
    got = adam_attrib.adam_attrib_reference(mode, tw, tm, tv, tu, tg, t,
                                            **KW)
    for name, a, b, before in zip("wmv", want[:3], got, (tw, tm, tv)):
        a = a.reshape(n_rows, D)
        if mode == "noadam":  # bitwise, -0.0 told apart
            assert np.asarray(a).view(np.int16).tobytes() == \
                b.view(torch.int16).numpy().tobytes(), name
        else:
            _assert_bf16_close(a, b, name)
            assert not torch.equal(b, before), name
    if mode == "noadam":
        neg_zero = tw.view(torch.int16) == -32768
        flipped = neg_zero & (got[0].view(torch.int16) == 0)
        assert 0 < int(flipped.sum()) < int(neg_zero.sum())


def test_attrib_copy_is_its_inputs():
    w, m, v, ids, g = _attrib_inputs()
    tw, tm, tv = (torch.tensor(a).to(torch.bfloat16) for a in (w, m, v))
    tu, tg = dedup_rows(torch.tensor(ids), torch.tensor(g), N_ROWS)
    got = adam_attrib.adam_attrib_reference("copy", tw, tm, tv, tu, tg, 1,
                                            **KW)
    for a, b in zip(got, (tw, tm, tv)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert a.data_ptr() != b.data_ptr()
    with pytest.raises(ValueError, match="mode 'nodots'"):
        adam_attrib.adam_attrib_reference("nodots", tw, tm, tv, tu, tg, 1,
                                          lr=1e-3)


def test_wrappers_refuse_by_name_before_any_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"{name} was built")

    monkeypatch.setattr(build, "load", no_build)
    table = torch.zeros((64, LANES))
    ids = torch.zeros((8,), dtype=torch.int32)
    for args, err, match in (
            ((table, ids, 1), ValueError, "CUDA"),
            ((table.double(), ids, 1), TypeError, "float32 only"),
            ((table[:, :64], ids, 1), ValueError, "width"),
            ((table, ids.long(), 1), TypeError, "int32"),
            ((table, ids, 33), ValueError, "rows=33")):
        with pytest.raises(err, match=match):
            gather_rows.gather_rows_sum(*args)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    uids = torch.zeros((4,), dtype=torch.int32)
    gsum = torch.zeros((4, 32))
    for mode, tensors, err, match in (
            ("full", (w, w.clone(), w.clone()), ValueError, "CUDA"),
            ("full", (w.float(), w.clone(), w.clone()), TypeError,
             "bfloat16 only"),
            ("full", (w[:, :24].contiguous(),) * 3, ValueError, "width"),
            ("dots", (w, w.clone(), w.clone()), ValueError, "mode 'dots'")):
        with pytest.raises(err, match=match):
            adam_attrib.adam_attrib_(mode, *tensors, uids,
                                     gsum[:, :tensors[0].shape[1]], 1,
                                     lr=1e-3)


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_dma_probe_runs_on_the_cpu(capsys):
    assert prof_dma_issue.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [x["probe"] for x in lines] == ["gather", "gather",
                                           "lazy_projection", "lazy_step"]
    assert all(x["tag"] == "cpu-plain" for x in lines)
    assert [x["rows"] for x in lines[:2]] == [1, 8]
    for x in lines[:2]:
        assert x["route"] == "plain" and x["ns_per_copy"] > 0
        assert x["bound_ms"] is None and x["cold_ms"] is None
    proj = lines[2]
    assert proj["row_granular_ms"] == pytest.approx(
        6 * lines[0]["ns_per_copy"] * 17_408 / 1e6)
    assert proj["block8_granular_ms"] == pytest.approx(
        6 * lines[1]["ns_per_copy"] * 14_600 / 1e6)
    lazy = lines[3]
    assert 0 < lazy["touched_rows"] < 64 * 17 and lazy["lazy_ms"] > 0
    assert lazy["kernel1"].endswith("(plain version)")


def test_attrib_probe_runs_on_the_cpu(capsys):
    assert prof_kernel_attrib.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    modes = [x for x in lines if x["probe"] == "attrib"]
    assert [x["mode"] for x in modes] == list(adam_attrib.MODES)
    assert all(len(x["readings"]) == 2 and x["route"] == "plain"
               and x["tag"] == "cpu-plain" for x in modes)
    gaps = lines[-1]
    assert gaps["probe"] == "attrib_gaps" and gaps["copy_over_bound"] is None
    ms = {x["mode"]: x["ms"] for x in modes}
    assert gaps["adam_math_ms"] == pytest.approx(ms["full"] - ms["noadam"])
    assert lines[-2]["probe"] == "attrib_beside"


def test_probes_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the card-less refusal")
    for main in (prof_dma_issue.main, prof_kernel_attrib.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
