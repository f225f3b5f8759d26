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

import ast
import contextlib
import io
import json
import re
from pathlib import Path

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


CHUNK = gather_rows.CHUNK


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("n", [37, 64, CHUNK + 1, 3 * CHUNK + 5])
def test_chunked_reference_is_the_tpu_kernels_sum_within_its_bound(n, rows):
    """The ring's order (chunks in order, then the partials) against the
    TPU kernel's in-order sum: two orders of the same f32 adds differ by at
    most 2 (n - 1) 2^-24 sum|x_i| (each of the n - 1 adds of either order
    rounds by at most 2^-24 of a partial sum, which is at most sum|x_i|);
    at n <= CHUNK the adds are the same, so the sums are bitwise equal."""
    rng = np.random.default_rng(100 + n + rows)
    table = rng.normal(size=(N_TABLE, LANES)).astype(np.float32)
    ids = rng.integers(0, N_TABLE - rows + 1, size=n).astype(np.int32)
    want = np.float32(jax_gather(jnp.asarray(table), jnp.asarray(ids),
                                 rows)[0, 0])
    got = gather_rows.gather_rows_chunked_reference(
        torch.tensor(table), torch.tensor(ids), rows)
    assert got.dtype == torch.float32 and got.dim() == 0
    bound = 2 * (n - 1) * 2.0**-24 * np.abs(table[ids, 0]).astype(
        np.float64).sum()
    assert abs(float(got) - float(want)) <= bound
    if n <= CHUNK:
        assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [0, 1, 37, CHUNK])
def test_chunked_reference_is_the_in_order_sum_up_to_a_chunk(n):
    rng = np.random.default_rng(7 + n)
    table = torch.tensor(rng.normal(size=(N_TABLE, LANES)),
                         dtype=torch.float32)
    ids = torch.tensor(rng.integers(0, N_TABLE, size=n), dtype=torch.int32)
    a = gather_rows.gather_rows_chunked_reference(table, ids, 1)
    b = gather_rows.gather_rows_reference(table, ids, 1)
    assert a.numpy().tobytes() == b.numpy().tobytes()


def test_chunked_reference_adds_chunk_by_chunk():
    """Past a chunk the order is the ring's, not the in-order one: values
    that cancel inside the first chunk only (1e8, then -1e8 in the next
    chunk) leave the small terms of chunk 1 whole in the ring's order."""
    col = np.full(2 * CHUNK, 1.0, np.float32)
    col[0], col[CHUNK] = 1e8, -1e8
    table = torch.tensor(np.repeat(col[:, None], LANES, axis=1))
    ids = torch.arange(2 * CHUNK, dtype=torch.int32)
    ring = float(gather_rows.gather_rows_chunked_reference(table, ids, 1))
    serial = float(gather_rows.gather_rows_reference(table, ids, 1))
    # chunk 0: 1e8 + 63 ones, each lost below half an ulp (4); chunk 1:
    # -1e8 + 63 -> the partials add to 0, not to 126
    assert ring == 0.0 and serial == 63.0


def parity_wait_passes(completions: int, parity: int) -> bool:
    """mbarrier.try_wait.parity: passes once the phase of that parity has
    completed, i.e. while the current phase (the completions so far) has
    the other parity."""
    return completions & 1 != parity


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rows", [1, 2, 3, 8, 32])  # 32, 32, 21, 8, 2 stages
@pytest.mark.parametrize("length", [0, 1, 5, 31, 32])
def test_ring_protocol_keeps_each_copy_until_it_is_read(length, rows, seed):
    """One ring of gather_rows_ring (a warp's ``length`` <= 32 ids), its
    barriers stepped in a random order: the elected lane issues copy q into
    stage q % stages after waiting on the stage's empty barrier with parity
    (q // stages - 1) & 1, and reader q waits on copy q's own full barrier
    (parity 0, used once). The parity wait passes exactly when the read it
    stands for has happened (no phase is mistaken for another), that read
    is never the elected lane's own (lane 31), a stage is never written
    while its copy is unread, at most ``stages`` copies are in flight, and
    every copy is issued and read once."""
    _, stages, _ = gather_rows.ring_plan(length, rows)
    rng = np.random.default_rng(seed)
    empty_done = [0] * stages  # arrivals (completed phases) of each empty
    holder = [None] * stages  # the copy a stage holds, unread
    issued, read = [], set()
    q = 0  # the producer's next copy
    while len(read) < length:
        readers = [c for c in issued if c not in read]
        if q < length and (not readers or rng.random() < 0.5):
            s = q % stages
            if q >= stages:
                ok = parity_wait_passes(empty_done[s], (q // stages - 1) & 1)
                # the read of copy q - stages is what the wait stands for
                assert ok == ((q - stages) in read) and q - stages != 31
                if not ok:
                    continue
            assert holder[s] is None  # its last copy has been read
            holder[s] = q
            issued.append(q)
            assert len(issued) - len(read) <= stages
            q += 1
        else:
            c = readers[rng.integers(len(readers))]
            assert parity_wait_passes(1, 0)  # the copy's own full barrier
            s = c % stages
            assert holder[s] == c
            holder[s] = None
            read.add(c)
            if c + stages < 32:  # the kernel's reader frees only a reused stage
                empty_done[s] += 1
    assert issued == list(range(length)) and read == set(range(length))


@pytest.mark.parametrize("rows", list(range(1, gather_rows.MAX_ROWS + 1)))
def test_ring_plan_fits_the_card(rows):
    """Each ring's stages are whole [rows, 128] f32 blocks, at most 32 (its
    ids), all rings within RING_BYTES; three CTAs of it fit a SM's 227 KB
    (static barriers, ids and values beside the stages); a CTA per
    chunk."""
    block = rows * LANES * 4
    rings = gather_rows.RINGS
    ctas, stages, smem = gather_rows.ring_plan(16_384, rows)
    assert ctas == 16_384 // CHUNK == 256 and rings * 32 == CHUNK
    assert 1 <= stages <= 32 and smem == rings * stages * block
    assert smem <= gather_rows.RING_BYTES < smem + rings * block or \
        stages == 32
    static = CHUNK * (8 + 8 + 4 + 4) + 16  # full, empty, ids, vals
    assert 3 * (smem + static) <= 232_448
    # bytes in flight a SM at 16,384 ids (about two CTAs a SM): 4x the
    # ~12-16 KB that Little's law asks at rows >= 2, 2x at rows 1
    assert 2 * smem >= 4 * 16_384 or rows == 1
    want = {1: (32, 32_768), 8: (8, 65_536), 32: (2, 65_536)}
    if rows in want:
        assert (stages, smem) == want[rows]


@pytest.mark.parametrize("n,ctas", [(0, 1), (1, 1), (CHUNK, 1),
                                    (CHUNK + 1, 2), (3 * CHUNK + 5, 4)])
def test_ring_plan_takes_whole_chunks(n, ctas):
    assert gather_rows.ring_plan(n, 8)[0] == ctas
    with pytest.raises(ValueError, match="rows=33"):
        gather_rows.ring_plan(n, 33)


def test_ring_constants_are_the_kernels():
    cu = build.sources("gather_rows")[0].read_text()
    assert f"constexpr int CHUNK = {CHUNK};" in cu
    assert gather_rows.RING_BYTES == 64 * 1024
    assert "constexpr int RING_BYTES = 64 * 1024;" in cu
    assert "__launch_bounds__(CHUNK)" in cu
    assert "constexpr int RINGS = CHUNK / 32;" in cu and \
        gather_rows.RINGS == CHUNK // 32
    # the serial form stays: one thread, two stages
    assert "gather_rows_sum<<<1, 1, smem" in cu
    assert "gather_rows_ring<<<n_chunks, CHUNK, smem" in cu
    assert "if (lane == 31) {" in cu  # the elected lane of a ring
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in cu


def _schema(op_cpp: str, name: str):
    text = "".join(re.findall(r'"([^"]*)"', op_cpp[op_cpp.index("lib.def("):]))
    inner = text[text.index(f"{name}(") + len(name) + 1:]
    return [a.split()[-1] for a in inner[:inner.index(") -> ()")].split(",")]


def _c_signature(text: str, name: str) -> str:
    sig = text[text.index(f'extern "C" int {name}('):]
    return " ".join(sig[:sig.index(")") + 1].split())


@pytest.mark.parametrize("op,launcher", [
    ("gather_rows_", "aread_gather_rows"),
    ("gather_rows_ring_", "aread_gather_rows_ring")])
def test_gather_schema_launcher_and_call_agree(op, launcher):
    cu, op_cpp = (p.read_text() for p in build.sources("gather_rows"))
    schema = _schema(op_cpp, op)
    tree = ast.parse(Path(gather_rows.__file__).read_text())
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Attribute) and c.func.attr == op]
    assert len(calls) == 1 and not calls[0].keywords
    assert len(calls[0].args) == len(schema) and schema[-1] == "stream"
    assert _c_signature(op_cpp, launcher) == _c_signature(cu, launcher)
    impl = op_cpp[op_cpp.index(f"void {op}("):]
    assert impl[:impl.index(") {")].count(",") + 1 == len(schema)


@pytest.mark.parametrize("form", ["ring", "serial"])
def test_gather_forms_refuse_by_name_before_any_build(monkeypatch, form):
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
            ((table, ids[None], 1), TypeError, "1-D int32"),
            ((table, ids, 0), ValueError, "rows=0"),
            ((table, ids, 33), ValueError, "rows=33"),
            ((table[:7], ids, 8), ValueError, "need at least 8")):
        with pytest.raises(err, match=match):
            gather_rows.gather_rows_sum(*args, form=form)
    for bad in ("tma", "Ring", ""):
        with pytest.raises(ValueError, match=f"form {bad!r}"):
            gather_rows.gather_rows_sum(table, ids, 1, form=bad)


@pytest.mark.parametrize("kernel", ["gather_rows_sum", "gather_rows_ring"])
def test_gather_kernels_check_each_id_before_its_copy(kernel):
    """The ids' range is the kernels' own check, with no wait on the host:
    checked_id traps on an id outside [0, max_id], and every copy starts
    from a checked id (the serial form checks each id as it starts its
    copy, a step after its load; the ring as it loads its chunk's ids);
    the launchers pass max_id = n_table - rows and refuse a shorter
    table. The wrapper keeps no check of its own (nothing that waits for
    the device)."""
    cu = build.sources("gather_rows")[0].read_text()
    helper = cu[cu.index("__device__ __forceinline__ int32_t checked_id("):]
    helper = helper[:helper.index("\n}\n")]
    assert "static_cast<uint32_t>(id) > static_cast<uint32_t>(max_id)" in \
        helper and "__trap();" in helper
    body = cu[cu.index(f"{kernel}(const float* __restrict__ table"):]
    body = body[:body.index("\n}\n")]
    assert "int32_t max_id" in body
    copies = [c[:c.index(";")] for c in body.split("start_copy(")[1:]]
    assert len(copies) == {"gather_rows_sum": 2, "gather_rows_ring": 1}[kernel]
    if kernel == "gather_rows_sum":
        assert all("checked_id(" in c for c in copies)
    else:
        assert "chunk_ids[" in copies[0] and body.count("chunk_ids[tid] =") \
            == 1 and "chunk_ids[tid] = checked_id(ids[first + tid], " \
            "max_id);" in body
    assert "table, ids, n, rows, n_table - rows, out);" in cu
    assert "table, ids, n, rows, n_table - rows, stages," in cu
    assert cu.count("n_table < rows") == 2
    src = Path(gather_rows.__file__).read_text()
    for waits in ("aminmax", ".item()", "int(lo)", "synchronize"):
        assert waits not in src


def test_ring_scratch_and_ticket_are_the_calls_own():
    """The ring's last-CTA ticket is the word after its partials in a
    buffer each call allocates, zeroed by the launcher on the call's
    stream, so calls on two streams never share one; the module holds no
    tensor between calls."""
    cu, op_cpp = (p.read_text() for p in build.sources("gather_rows"))
    launcher = cu[cu.index('extern "C" int aread_gather_rows_ring('):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "reinterpret_cast<unsigned int*>(scratch + n_chunks)" in launcher
    assert "cudaMemsetAsync(ticket, 0, sizeof(unsigned int), stream)" in \
        launcher
    assert launcher.index("cudaMemsetAsync") < \
        launcher.index("gather_rows_ring<<<")
    assert "*ticket = 0u" not in cu  # nothing relies on a reset by a kernel
    assert "scratch.numel() - 1" in op_cpp
    tree = ast.parse(Path(gather_rows.__file__).read_text())
    module_names = {t.id for n in tree.body if isinstance(n, ast.Assign)
                    for t in n.targets if isinstance(t, ast.Name)}
    assert module_names == {"LANES", "MAX_ROWS", "FORMS", "CHUNK", "RINGS",
                            "RING_BYTES", "PLAIN"}
    call = next(c for c in ast.walk(tree) if isinstance(c, ast.Call)
                and getattr(c.func, "attr", "") == "gather_rows_ring_")
    assert ast.unparse(call.args[3]) == "scratch"
    alloc = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "scratch")
    assert ast.unparse(alloc.value.args[0]) == "(chunks + 1,)"


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


@pytest.fixture(scope="module")
def attrib_cpu_run():
    """``prof_kernel_attrib``'s entry point on the CPU (its plain versions
    at a toy size), run once for the module's two tests of it: each run
    takes about two minutes here. Its exit code and its JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = prof_kernel_attrib.main(["--device", "cpu"])
    return rc, [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith("{")]


def test_attrib_probe_runs_on_the_cpu(attrib_cpu_run):
    rc, lines = attrib_cpu_run
    assert rc == 0
    modes = [x for x in lines if x["probe"] == "attrib"]
    assert [x["mode"] for x in modes] == list(adam_attrib.MODES)
    assert all(len(x["readings"]) == 2 and x["route"] == "plain"
               and x["tag"] == "cpu-plain" for x in modes)
    gaps = lines[-1]
    assert gaps["probe"] == "attrib_gaps" and gaps["copy_over_bound"] is None
    ms = {x["mode"]: x["ms"] for x in modes}
    assert gaps["adam_math_ms"] == pytest.approx(ms["full"] - ms["noadam"])
    assert lines[-2]["probe"] == "attrib_beside"


def test_attrib_probe_reports_every_form_in_turns(attrib_cpu_run):
    rc, lines = attrib_cpu_run
    assert rc == 0
    modes = [x for x in lines if x["probe"] == "attrib"]
    for x in modes:
        assert list(x["forms"]) == list(adam_attrib.FORMS)
        assert x["form"] == prof_kernel_attrib.ATTRIBUTED == "vec8"
        assert x["ms"] == x["forms"][x["form"]]["ms"]
        assert all(len(f["readings"]) == 2 for f in x["forms"].values())
    gaps = lines[-1]
    assert set(gaps["copy_over_library_copy_by_form"]) == \
        set(adam_attrib.FORMS)
    # the gaps attribute kernel 1's sweep, whatever the default form
    ms = {x["mode"]: x["forms"]["vec8"]["ms"] for x in modes}
    assert gaps["form"] == "vec8" and gaps["metadata_reads_ms"] == \
        pytest.approx(ms["noadam"] - ms["copy"])


def test_probes_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the card-less refusal")
    for main in (prof_dma_issue.main, prof_kernel_attrib.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])


# ------------------------------------- the attribution sweeps' launch plans
def tma_vectors(n_elem: int, grid: int):
    """attrib_sweep_tma's index math in numpy: tile t of CTA t % grid,
    consumer thread j and its words j, j + 256 of the tile. Returns
    [steps, 32] vector indices of each warp's step (-1 where not live)."""
    tv, consumers = adam_attrib.TILE // 8, 256
    n_tiles = -(-n_elem // adam_attrib.TILE)
    steps = []
    for t in range(n_tiles):
        nv = min(adam_attrib.TILE, n_elem - t * adam_attrib.TILE) // 8
        for j0 in range(0, tv, consumers):
            for warp in range(consumers // 32):
                j = j0 + 32 * warp + np.arange(32)
                vi = t * tv + j
                steps.append(np.where(j < nv, vi, -1))
    return np.array(steps)


@pytest.mark.parametrize("grid", [1, 3, 1056])
@pytest.mark.parametrize("d", adam_attrib.WIDTHS)
def test_attrib_sweeps_visit_every_vector_once_rows_in_one_step(d, grid):
    """The tma sweep visits every 8-element vector of a [5003, D] table
    once, and a row's vectors (D / 8 <= 32 of them) always lie in one
    warp step's 32 aligned consecutive vectors: the lane of the row's
    first vector may reset the row's slot after the whole row has read
    it."""
    n_rows, vpr = 5003, d // 8
    n_vec = n_rows * vpr
    for steps in (tma_vectors(n_vec * 8, grid),):
        live = steps[steps >= 0]
        assert np.array_equal(np.sort(live), np.arange(n_vec))
        first = steps[:, :1]
        assert (first[first >= 0] % 32 == 0).all()
        rows = np.where(steps >= 0, steps // vpr, -1)
        for r in np.unique(rows[rows >= 0])[:: max(1, n_rows // 97)]:
            assert len(np.unique(np.nonzero(rows == r)[0])) == 1


@pytest.mark.parametrize("d", adam_attrib.WIDTHS)
def test_tma_tiles_are_whole_rows_and_bulk_copy_sizes(d):
    """A tile is TILE elements: whole rows at every width, 16-byte bulk
    copies (the last tile's too, as the element count is a multiple of 8),
    a whole number of 16-byte words for each of the 256 computing
    threads, and the stages fit four CTAs a SM."""
    assert adam_attrib.TILE % d == 0
    for n_rows in (1, 5003, 1_521_664):
        n_elem = n_rows * d
        last = n_elem - (-(-n_elem // adam_attrib.TILE) - 1) * adam_attrib.TILE
        assert 0 < last <= adam_attrib.TILE and (2 * last) % 16 == 0
    assert (adam_attrib.TILE // 8) % 256 == 0
    cu = build.sources("adam_attrib")[0].read_text()
    stages = int(re.search(r"constexpr int TMA_STAGES = (\d+);", cu)[1])
    stages_bytes = stages * 3 * adam_attrib.TILE * 2
    assert 3 <= stages and 4 * (stages_bytes + 64) <= 232_448


def test_attrib_constants_and_forms_are_the_kernels():
    cu, op_cpp = (p.read_text() for p in build.sources("adam_attrib"))
    assert f"constexpr int TILE = {adam_attrib.TILE};" in cu
    assert "enum Form : int { VEC8 = 0, TMA = 1 };" in cu
    assert adam_attrib.FORMS == ("vec8", "tma")
    assert adam_attrib.DEFAULT_FORM in adam_attrib.FORMS
    for kernel in ("attrib_sweep(", "attrib_sweep_tma("):
        assert kernel in cu
    assert "vec16" not in cu
    assert "cp.async.bulk.global.shared::cta.bulk_group" in cu
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in cu
    schema = _schema(op_cpp, "adam_attrib_")
    tree = ast.parse(Path(adam_attrib.__file__).read_text())
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Attribute)
             and c.func.attr == "adam_attrib_"]
    assert len(calls) == 1 and len(calls[0].args) == len(schema)
    assert schema[6:8] == ["mode", "form"] and schema[-1] == "stream"
    assert ast.unparse(calls[0].args[7]) == "FORMS.index(form)"
    assert _c_signature(op_cpp, "aread_adam_attrib") == \
        _c_signature(cu, "aread_adam_attrib")
    impl = op_cpp[op_cpp.index("void adam_attrib_("):]
    assert impl[:impl.index(") {")].count(",") + 1 == len(schema)


@pytest.mark.parametrize("form", ["vec8", "tma"])
def test_attrib_forms_refuse_by_name_before_any_build(monkeypatch, form):
    def no_build(name):
        raise AssertionError(f"{name} was built")

    monkeypatch.setattr(build, "load", no_build)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    uids = torch.zeros((4,), dtype=torch.int32)
    gsum = torch.zeros((4, 32))
    for mode, tensors, err, match in (
            ("full", (w, w.clone(), w.clone()), ValueError, "CUDA"),
            ("copy", (w.float(), w.clone(), w.clone()), TypeError,
             "bfloat16 only"),
            ("noslot", (w[:, :24].contiguous(),) * 3, ValueError, "width"),
            ("dots", (w, w.clone(), w.clone()), ValueError, "mode 'dots'")):
        with pytest.raises(err, match=match):
            adam_attrib.adam_attrib_(mode, *tensors, uids,
                                     gsum[:, :tensors[0].shape[1]], 1,
                                     lr=1e-3, form=form)
    for bad in ("vec16", "TMA", "x2"):
        with pytest.raises(ValueError, match=f"form {bad!r}"):
            adam_attrib.adam_attrib_("full", w, w.clone(), w.clone(), uids,
                                     gsum, 1, lr=1e-3, form=bad)


def test_dma_probe_reports_both_forms_and_both_projections(capsys):
    assert prof_dma_issue.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    for x in lines[:2]:
        assert x["form"] == "ring"
        ctas, stages, smem = gather_rows.ring_plan(x["n"], x["rows"])
        assert (x["ring_ctas"], x["ring_stages"], x["ring_smem_bytes"]) == \
            (ctas, stages, smem) and ctas > 1  # the toy size spans chunks
        for pre in ("", "serial_"):
            assert x[f"{pre}ms"] > 0 and x[f"{pre}plain_ms"] > 0
            assert x[f"{pre}device_ms"] is None  # no device metric on the CPU
        assert x["serial_ns_per_copy"] == pytest.approx(
            x["serial_ms"] * 1e6 / x["n"])
        assert x["library_cold_ms"] is None and x["library_call_ms"] > 0
    proj = lines[2]
    assert proj["serial_row_granular_ms"] == pytest.approx(
        6 * lines[0]["serial_ns_per_copy"] * 17_408 / 1e6)
    assert proj["serial_block8_granular_ms"] == pytest.approx(
        6 * lines[1]["serial_ns_per_copy"] * 14_600 / 1e6)
    assert proj["serial_cold_row_granular_ms"] is None
