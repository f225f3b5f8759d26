"""What Python decides for the port's two Adam kernels, checked without a
card: which kernel (vector or scalar) a wrapper picks from the width, the
element count and the pointers' alignment; the vector sweep's index math
(vector index -> row, column, storage index, by a shift or by a
host-computed multiplier), emulated with numpy; where the sweep may reset
the slot map itself; the persistent scratch and its key; the f32 scalars of
a step; and that each operator's schema, its C launcher and the wrapper's
call agree on their arguments."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from aread_tpu_torch.ops import fused_adam, sparse_adam
from aread_tpu_torch.ops.cuda import build
from aread_tpu_torch.ops.sparse_adam import (L2_PARTIALS, VEC, adam_scalars,
                                             is_aligned16, row_divider,
                                             sweep_plan)

WIDTHS = [8, 16, 32, 40, 64, 96, 128]
BLOCK = 256  # threads of a block in both kernels' launches


# ------------------------------------------------------- the kernel choice
@pytest.mark.parametrize("d,aligned,vpr", [
    (32, True, 4), (32, False, 0), (8, True, 1), (40, True, 5),
    (96, True, 12), (264, True, 33), (20, True, 0), (20, False, 0),
    (1, True, 0), (7, True, 0), (12, True, 0)])
def test_sweep_plan_picks_the_vector_sweep_for_aligned_multiples_of_8(
        d, aligned, vpr):
    plan = sweep_plan(d, aligned)
    assert plan[0] == vpr
    if vpr == 0:
        assert plan == (0, 0, 0)
    else:
        assert plan[1:] == row_divider(vpr) and d == VEC * vpr


@pytest.mark.parametrize("numel,aligned,vector", [
    (48588224, True, True), (48588224, False, False), (100003, True, True),
    (8, True, True), (7, True, False), (0, True, False), (105, False, False)])
def test_fused_adam_picks_the_vector_kernel_for_aligned_leaves(numel, aligned,
                                                               vector):
    assert fused_adam.takes_vector_kernel(numel, aligned) is vector


def test_alignment_is_read_from_the_pointers():
    f = torch.zeros(64, dtype=torch.float32)
    h = torch.zeros(64, dtype=torch.bfloat16)
    assert f.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0
    assert is_aligned16(f, h, f[4:], h[8:], f.view(8, 8)[2:])
    assert not is_aligned16(f[1:])
    assert not is_aligned16(h[1:])
    assert not is_aligned16(f, h, f[2:])  # one odd view is enough
    assert not is_aligned16(f.view(8, 8)[:, 1])


# ------------------------------------------------- the sweep's index math
def rows_of(vi: np.ndarray, vpr: int) -> np.ndarray:
    """The vector sweep's row of each vector index, in the kernel's 32-bit
    arithmetic: a shift, or the high word of a 32 x 32 product, shifted."""
    shift, mul = row_divider(vpr)
    vi = vi.astype(np.uint64)
    assert vi.max() < 2**32
    if mul == 0:
        return (vi >> np.uint64(shift)).astype(np.uint32)
    assert 0 < mul < 2**32
    return (((vi * np.uint64(mul)) >> np.uint64(32))
            >> np.uint64(shift)).astype(np.uint32)


def emulate_vector_sweep(n_rows: int, d: int, grid: int):
    """Every (step base, vector index) the kernel's loop visits: a warp
    walks 32 consecutive vectors from a multiple of 32 and strides by the
    whole grid; lanes past the end sit the step out."""
    vpr = d // VEC
    n_vec = n_rows * vpr
    stride = grid * BLOCK
    warp_starts = np.arange(0, stride, 32, dtype=np.int64)
    bases = (warp_starts[:, None]
             + np.arange(0, n_vec, stride, dtype=np.int64)[None, :]).ravel()
    bases = bases[bases < n_vec]
    vi = bases[:, None] + np.arange(32, dtype=np.int64)[None, :]
    live = vi < n_vec
    return np.broadcast_to(bases[:, None], vi.shape)[live], vi[live]


@pytest.mark.parametrize("grid", [1, 3, 1056])
@pytest.mark.parametrize("d", WIDTHS)
def test_vector_sweep_visits_every_element_once(d, grid):
    n_rows, vpr = 5003, d // VEC
    _, vi = emulate_vector_sweep(n_rows, d, grid)
    assert len(vi) == n_rows * vpr
    r = rows_of(vi, vpr).astype(np.int64)
    cv = vi - r * vpr
    assert np.array_equal(r, vi // vpr) and cv.min() >= 0 and cv.max() < vpr
    # the thread's 8 elements: storage index base + j, column cv * 8 + j
    e = (vi * VEC)[:, None] + np.arange(VEC)[None, :]
    assert np.array_equal(e, (r * d + cv * VEC)[:, None] + np.arange(VEC))
    assert np.array_equal(np.sort(e.ravel()), np.arange(n_rows * d))


@pytest.mark.parametrize("d", WIDTHS + [24, 56, 264, 1000, 4096])
def test_row_divider_is_exact_up_to_the_table_limit(d):
    """Tables hold fewer than 2^32 elements, so vector indices stay below
    2^29: the first and last indices, every kind of row boundary and a
    random sample divide exactly at the largest table of this width."""
    vpr = d // VEC
    n_rows = (2**32 - 1) // d
    n_vec = n_rows * vpr
    assert n_vec < 2**29
    rng = np.random.default_rng(d)
    rows = np.concatenate([rng.integers(0, n_rows, 200_000),
                           np.arange(1000), n_rows - 1 - np.arange(1000)])
    vi = np.concatenate([
        np.arange(min(n_vec, 200_000)), n_vec - 1 - np.arange(200_000),
        rng.integers(0, n_vec, 1_000_000),
        rows * vpr, rows * vpr + vpr - 1,
        np.array([2**29 - 1])])  # the bound itself
    vi = vi[vi >= 0]
    assert np.array_equal(rows_of(vi, vpr), vi // vpr)


def test_row_divider_meets_its_proof_condition():
    for vpr in range(1, 4097):
        shift, mul = row_divider(vpr)
        if vpr & (vpr - 1) == 0:
            assert mul == 0 and 1 << shift == vpr
            continue
        # ceil(2^(32+s) / vpr) fits 32 bits and overshoots by at most
        # 2^(32+s-29): exact for every 29-bit dividend
        assert 0 < mul < 2**32, vpr
        over = mul * vpr - (1 << (32 + shift))
        assert 0 < over <= 1 << (3 + shift), vpr


def test_row_divider_refuses_no_vectors():
    with pytest.raises(ValueError):
        row_divider(0)


@pytest.mark.parametrize("d", WIDTHS + [256, 264])
def test_map_reset_in_the_sweep_only_where_a_row_stays_in_one_warp(d):
    """The launcher resets the slot map inside the sweep iff D / 8 divides
    32; exactly then every row's vectors are lanes of one warp in one step,
    whatever the grid."""
    vpr = d // VEC
    for grid in (1, 5):
        base, vi = emulate_vector_sweep(997, d, grid)
        r = vi // vpr
        order = np.argsort(r, kind="stable")
        r, base = r[order], base[order]
        same_row = r[1:] == r[:-1]
        one_warp = bool(np.all(base[1:][same_row] == base[:-1][same_row]))
        assert one_warp == (32 % vpr == 0)
    src = (build.SRC_DIR / "sparse_adam.cu").read_text()
    assert src.count("32 % vpr == 0") + src.count("32 % a.vpr == 0") == 2


# ------------------------------------------------------ persistent scratch
def test_scratch_lives_beside_the_slot_map_under_one_key(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(sparse_adam, "_SLOTS", {})
    cpu = torch.device("cpu")  # stands in for a card: the key is (0, n_rows)
    a = sparse_adam._slot_map(cpu, 64)
    assert sparse_adam._slot_map(cpu, 64) is a
    assert list(sparse_adam._SLOTS) == [sparse_adam._slot_key(cpu, 64)] == [
        (0, 64)]
    assert a.slot.dtype == torch.int32 and bool((a.slot == -1).all())
    assert a.slot.shape == (64,)
    assert a.partials.dtype == torch.float64
    assert a.partials.shape == (L2_PARTIALS,)
    assert a.l2.dtype == torch.float32 and a.l2.shape == (1,)
    assert a.count.dtype == torch.int32 and a.count.tolist() == [0]
    assert a.none.numel() == 0
    b = sparse_adam._slot_map(cpu, 65)
    assert b is not a and b.count is not a.count
    # dropping the key after a failed launch drops map and scratch together
    sparse_adam._SLOTS.pop(sparse_adam._slot_key(cpu, 64), None)
    assert sparse_adam._slot_map(cpu, 64) is not a
    assert "one stream" in sparse_adam._slot_map.__doc__


# ----------------------------------------------------- the step's scalars
def adam_scalars_by_torch(t, lr, b1, b2, eps, weight_decay, l2):
    """The scalars as they were first computed: torch's f32 power of two
    0-dim tensors."""
    f32 = np.float32
    b1t = torch.tensor(b1, dtype=torch.float32) ** torch.tensor(
        float(t), dtype=torch.float32)
    b2t = torch.tensor(b2, dtype=torch.float32) ** torch.tensor(
        float(t), dtype=torch.float32)
    return {
        "lr": float(f32(lr)), "b1": float(f32(b1)), "b2": float(f32(b2)),
        "eps": float(f32(eps)), "decay": float(f32(weight_decay + 2.0 * l2)),
        "b1c": float(1.0 - b1t), "b2c": float(1.0 - b2t),
        "omb1": float(f32(1.0 - b1)), "omb2": float(f32(1.0 - b2)),
    }


@pytest.mark.parametrize("b2", [0.99, 0.999])
def test_adam_scalars_keep_their_bits_for_20000_steps(b2):
    kw = dict(lr=1e-3, b1=0.9, b2=b2, eps=1e-8, weight_decay=1e-8, l2=1e-5)
    for t in range(1, 20001):
        new, old = adam_scalars(t, **kw), adam_scalars_by_torch(t, **kw)
        assert list(new) == list(old) and len(new) == 9
        for k in new:
            assert isinstance(new[k], float)
            assert np.float32(new[k]).tobytes() == np.float32(old[k]).tobytes(), (t, k)
            assert float(np.float32(new[k])) == new[k]  # an exact f32 value


# ------------------------------------- schema, launcher and call agree
def _schema_args(op_cpp: str, name: str):
    text = "".join(re.findall(r'"([^"]*)"', op_cpp[op_cpp.index("lib.def("):]))
    inner = text[text.index(f"{name}_(") + len(name) + 2:text.index(") -> ()")]
    return [a.split()[-1] for a in inner.split(",")]


def _wrapper_call(module, name: str) -> ast.Call:
    tree = ast.parse(Path(module.__file__).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == f"{name}_"]
    assert len(calls) == 1
    return calls[0]


def _c_signature(text: str, name: str) -> str:
    sig = text[text.index(f'extern "C" int aread_{name}('):]
    return " ".join(sig[:sig.index(")") + 1].split())


@pytest.mark.parametrize("name,module", [("sparse_adam", sparse_adam),
                                         ("fused_adam", fused_adam)])
def test_operator_schema_launcher_and_call_agree(name, module):
    cu, op = (p.read_text() for p in build.sources(name))
    schema = _schema_args(op, name)
    call = _wrapper_call(module, name)
    assert not call.keywords and len(call.args) == len(schema)
    # the scalars are passed by the schema's names, in its order
    passed = [a.slice.value for a in call.args
              if isinstance(a, ast.Subscript) and isinstance(a.value, ast.Name)
              and a.value.id == "s"]
    assert passed == [a for a in schema if a in (
        "lr", "b1", "b2", "eps", "decay", "b1c", "b2c", "omb1", "omb2")]
    # both kernels read the scalars that change per step (lr, b1c, b2c,
    # seed) from the step's block on the device, passed as the tensor
    # `step`; the other six are arguments
    per_step = {"sparse_adam": ["step"], "fused_adam": ["step"]}[name]
    assert len(passed) == 9 - 3 * len(per_step)
    assert [a for a in schema if a == "step"] == per_step
    if per_step:
        assert "scalars" in [getattr(a, "id", None) for a in call.args]
        assert "seed" not in schema and "const uint32_t* step" in cu
    assert schema[-1] == "stream"
    # the binding declares the launcher exactly as the kernel source defines it
    assert _c_signature(op, name) == _c_signature(cu, name)
    # the C++ function of the operator takes one parameter per schema entry
    impl = op[op.index(f"void {name}_("):]
    impl = impl[:impl.index(") {")]
    assert impl.count(",") + 1 == len(schema)


@pytest.mark.parametrize("name", ["sparse_adam", "fused_adam"])
def test_both_kernel_forms_stay_in_the_source(name):
    cu = build.sources(name)[0].read_text()
    vec, scalar = {"sparse_adam": ("adam_sweep_vec8", "adam_sweep_scalar"),
                   "fused_adam": ("fused_adam_vec8", "fused_adam_scalar")}[name]
    for kernel in (vec, scalar):
        assert re.search(r"__launch_bounds__\(BLOCK\)\s+" + kernel + r"\(", cu)
    assert "full_grid(" in cu  # the grid comes from the occupancy query
    header = (build.SRC_DIR / "rounding.cuh").read_text()
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in header
    for form in ("load8_cs", "store8_rn", "store8_w", "__ldcs", "__stcs"):
        assert form in header
