"""Sparse-gradient Adam for the fused embedding table (counterpart of
``aread_tpu/ops/sparse_adam.py``).

The reference's torch.optim.Adam is dense over the table: weight decay and
the embedding L2 term give every row a nonzero gradient and the moments
decay every step. The port keeps those exact dense semantics while the
data gradient stays sparse: the trainer takes d loss / d rows for the
gathered rows only, ``dedup_rows`` sums duplicate ids, and one update
sweeps the table with g = g_data + (wd + 2*l2) * w, where g_data is 0 for
the rows not gathered this step.

* ``sparse_adam_reference`` is the plain PyTorch version, a line-for-line
  port of the JAX package's ``_xla_sparse_adam``: a decay-only dense pass,
  then the touched rows recomputed from their pre-step state with the full
  gradient and written over it. It returns new tensors.
* ``sparse_adam_dispatch`` updates w, m and v in place: with CPU tensors
  through the plain version, with CUDA tensors through the hand-written
  kernel ``ops/cuda/sparse_adam.cu`` (``sparse_adam_cuda``), always — if
  the kernel cannot be built or launched it raises.
* ``lazy_sparse_adam_`` (the dispatch's ``lazy=True``) is the other table
  optimizer, ``table_optimizer='lazy_adam'``: only the gathered rows
  change, so there is no table sweep and no kernel; the JAX package runs
  it with gathers and scatters outside its Pallas kernel too, and indexed
  PyTorch ops on either device are its port.

The TPU kernel's ``PAD_W`` block window, its overflow fallback and the
host checks that avoid it (``rows_fit_kernel``, ``steps_fit_kernel``) have
no counterpart: the CUDA kernel finds touched rows through a slot map and
has no window to overflow.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from aread_tpu_torch.ops.cuda import launch_counts
from aread_tpu_torch.ops.rounding import flat_index_grid, sround


def dedup_rows(flat_ids: torch.Tensor, flat_grads: torch.Tensor,
               n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum duplicate ids' gradients. Returns (uids [K] int32 sorted-unique,
    gsum [K, D] f32); entries beyond the number of unique ids carry the
    sentinel ``n_rows`` and zero gradients. Each id's gradients are added
    in sorted order (a segmented sum, no float atomics), so the result is
    the same on every run and device, and bitwise the JAX package's."""
    K = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    sid = flat_ids[order]
    sg = flat_grads[order]
    new_seg = torch.ones((K,), dtype=torch.bool, device=sid.device)
    new_seg[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(new_seg, 0) - 1
    lengths = torch.zeros((K,), dtype=torch.int64,
                          device=seg.device).index_add_(0, seg, torch.ones_like(seg))
    gsum = torch.segment_reduce(sg, "sum", lengths=lengths, axis=0, unsafe=True)
    uids = torch.full((K,), n_rows, dtype=torch.int32, device=sid.device)
    uids.scatter_(0, seg, sid.to(torch.int32))
    return uids, gsum


def _row_flat_index(row_ids: torch.Tensor, d: int) -> torch.Tensor:
    """[K, d] int64 storage element indices of the given table rows, equal
    to ``flat_index_grid``'s rows (row-major, ``r * d + c``)."""
    r = row_ids.to(torch.int64)[:, None]
    c = torch.arange(d, dtype=torch.int64, device=row_ids.device)[None, :]
    return r * d + c


def adam_scalars(t: int, lr: float, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 1e-8,
                 l2: float = 0.0) -> Dict[str, float]:
    """The f32 scalars of one step, each a Python float holding an exact
    f32 value. ``1 - b`` is taken in double and then rounded, and the bias
    corrections ``1 - b**t`` in f32, as the JAX package computes them;
    the kernel and the plain version get the same values."""
    f32 = np.float32
    # numpy's f32 scalar power, not torch's on two 0-dim tensors: the same
    # bits (tests/test_torch_port_vector_plan.py) in under half the host time
    b1t = f32(b1) ** f32(t)
    b2t = f32(b2) ** f32(t)
    return {
        "lr": float(f32(lr)), "b1": float(f32(b1)), "b2": float(f32(b2)),
        "eps": float(f32(eps)), "decay": float(f32(weight_decay + 2.0 * l2)),
        "b1c": float(f32(1.0) - b1t), "b2c": float(f32(1.0) - b2t),
        "omb1": float(f32(1.0 - b1)), "omb2": float(f32(1.0 - b2)),
    }


def sparse_adam_reference(w, m, v, uids, gsum, t: int, lr: float,
                          b1: float = 0.9, b2: float = 0.99,
                          eps: float = 1e-8, weight_decay: float = 1e-8,
                          l2: float = 0.0, want_l2: bool = False,
                          sr_seed=None):
    """Plain two-phase update (port of ``_xla_sparse_adam``). Returns new
    (w, m, v), plus sum(w_pre**2) as a 0-dim f32 tensor with ``want_l2``.
    A bf16 table is rounded stochastically, keyed by ``sr_seed`` (None:
    the step ``t``) and the element index.
    Every scalar that divides is a 0-dim tensor on the data's device: on
    CUDA, PyTorch turns division by a Python scalar into multiplication by
    its reciprocal, which is not the IEEE quotient."""
    n_rows, d = w.shape
    dev = w.device
    seed = t if sr_seed is None else sr_seed
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    b1c = torch.tensor(s["b1c"], dtype=torch.float32, device=dev)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32, device=dev)

    def adam(w_, m_, v_, g_):
        wf = w_.to(torch.float32)
        g_ = g_ + s["decay"] * wf
        m2 = s["b1"] * m_.to(torch.float32) + s["omb1"] * g_
        v2 = s["b2"] * v_.to(torch.float32) + s["omb2"] * g_ * g_
        w2 = wf - s["lr"] * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
        return w2, m2.to(m.dtype), v2.to(v.dtype)

    # f32 squares summed in f64, as the kernel does
    l2v = (torch.sum(torch.square(w.to(torch.float32)), dtype=torch.float64)
           .to(torch.float32) if want_l2 else None)
    # phase B inputs from the pre-step state; sentinel rows clip to the
    # last row and are dropped at the write
    gid = torch.clamp(uids.to(torch.int64), max=n_rows - 1)
    nw, nm, nv = adam(w[gid], m[gid], v[gid], gsum)
    nw = sround(nw, w.dtype, _row_flat_index(gid, d), seed)
    # phase A: decay-only dense pass
    w2, m2, v2 = adam(w, m, v, torch.zeros_like(w, dtype=torch.float32))
    w2 = sround(w2, w.dtype, flat_index_grid(n_rows, d, dev), seed)
    # phase B: overwrite the touched rows with their full-gradient update
    live = uids < n_rows
    rows = uids[live].to(torch.int64)
    w2[rows] = nw[live]
    m2[rows] = nm[live]
    v2[rows] = nv[live]
    return (w2, m2, v2, l2v) if want_l2 else (w2, m2, v2)


@torch.no_grad()
def lazy_sparse_adam_(w, m, v, uids, gsum, t: int, lr: float,
                      b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                      weight_decay: float = 1e-8, l2: float = 0.0,
                      sr_seed=None) -> None:
    """SparseAdam-semantics update in place (port of
    ``_lazy_sparse_adam``): only the rows in ``uids`` change, weights and
    moments; the rest of the table is bitwise untouched and its moments do
    not decay. The bias correction uses the global step ``t``; the decay
    and L2 term is applied to the touched rows' gradients ('lazy
    regularization'). A bf16 table is rounded stochastically, keyed by
    ``sr_seed`` (None: ``t``) and the storage index, as in the
    dense-semantics update. Work is
    O(touched rows). Selecting the live entries of ``uids`` waits for the
    device once."""
    n_rows, d = w.shape
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    b1c = torch.tensor(s["b1c"], dtype=torch.float32, device=w.device)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32, device=w.device)
    live = uids < n_rows  # sentinel entries carry no row
    rows = uids[live].to(torch.int64)
    wf = w[rows].to(torch.float32)
    g = gsum[live] + s["decay"] * wf
    m2 = s["b1"] * m[rows].to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v[rows].to(torch.float32) + s["omb2"] * g * g
    w2 = wf - s["lr"] * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
    w[rows] = sround(w2, w.dtype, _row_flat_index(rows, d),
                     t if sr_seed is None else sr_seed)
    m[rows] = m2.to(m.dtype)
    v[rows] = v2.to(v.dtype)


# --------------------------------------------------------------- CUDA path
VEC = 8  # elements a thread of the vector kernels owns: 16 bytes of bf16
# Capacity of the sum(w*w) partials: with want_l2 the sweep runs at most
# this many blocks (the launcher's grid, occupancy x SMs, is ~1,000).
L2_PARTIALS = 4096


def is_aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's first element sits on a 16-byte boundary (a
    fresh tensor's does; a view at an odd offset does not)."""
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def row_divider(vpr: int) -> Tuple[int, int]:
    """(shift, mul) with which the vector sweep divides a vector index
    ``n < 2**29`` by ``vpr`` (vectors per row) without a division:
    ``n >> shift`` when ``mul == 0`` (``vpr`` a power of two), else
    ``(n * mul >> 32) >> shift`` with ``mul = ceil(2**(32+shift) / vpr)``
    below 2**32. Exact because ``mul * vpr - 2**(32+shift) < vpr <=
    2**(3+shift)`` (Granlund and Montgomery, 29-bit dividends); tables are
    below 2**32 elements, so vector indices are below 2**29."""
    if vpr < 1:
        raise ValueError(f"vpr={vpr}")
    if vpr & (vpr - 1) == 0:
        return vpr.bit_length() - 1, 0
    shift = max(0, (vpr - 1).bit_length() - 3)
    return shift, -(-(1 << (32 + shift)) // vpr)


def sweep_plan(d: int, aligned: bool) -> Tuple[int, int, int]:
    """Which sweep a ``[n_rows, d]`` table takes: ``(vpr, shift, mul)``.
    ``vpr = d // 8 > 0`` is the vector sweep (a thread per 8 elements of a
    row, ``row_divider``'s numbers), taken when ``d`` is a multiple of 8 and
    w, m, v and gsum are 16-byte aligned; ``(0, 0, 0)`` the scalar sweep.
    Where ``vpr`` divides 32 the vector sweep also restores the slot map
    (an update is two launches); else a third launch does."""
    if d % VEC != 0 or not aligned:
        return 0, 0, 0
    vpr = d // VEC
    return (vpr,) + row_divider(vpr)


class _Scratch(NamedTuple):
    """Persistent device state of the sweep for one (card, table size)."""
    slot: torch.Tensor      # [n_rows] int32, all -1 between launches
    partials: torch.Tensor  # [L2_PARTIALS] f64 per-block sums of w*w
    l2: torch.Tensor        # [1] f32, the sweep's sum(w*w)
    count: torch.Tensor     # [1] int32 blocks done, 0 between launches
    none: torch.Tensor      # [0], passed for the three when no sum is wanted


_SLOTS: Dict[Tuple[int, int], _Scratch] = {}


def _slot_key(device: torch.device, n_rows: int) -> Tuple[int, int]:
    """(card index, table size); a device without an index ("cuda") is the
    current card."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return index, n_rows


def _slot_map(device: torch.device, n_rows: int) -> _Scratch:
    """The sweep's persistent scratch, one per (card, table size): the
    int32 slot map, all -1 between launches (the kernel restores it), and
    the sum(w*w) partials, output and block counter (0 between launches).
    Two tables of one size on one card share it, so their updates must
    run on one stream; a launch on a second stream could read the map
    and the counter while the first still uses them."""
    key = _slot_key(device, n_rows)
    scratch = _SLOTS.get(key)
    if scratch is None:
        scratch = _Scratch(
            slot=torch.full((n_rows,), -1, dtype=torch.int32, device=device),
            partials=torch.empty((L2_PARTIALS,), dtype=torch.float64,
                                 device=device),
            l2=torch.zeros((1,), dtype=torch.float32, device=device),
            count=torch.zeros((1,), dtype=torch.int32, device=device),
            none=torch.empty((0,), dtype=torch.float32, device=device))
        _SLOTS[key] = scratch
    return scratch


def sparse_adam_cuda(w, m, v, uids, gsum, t: int, lr: float, b1: float = 0.9,
                     b2: float = 0.99, eps: float = 1e-8,
                     weight_decay: float = 1e-8, l2: float = 0.0,
                     want_l2: bool = False, sr_seed=None):
    """Launch ``ops/cuda/sparse_adam.cu`` (the operator
    ``torch.ops.aread_tpu_torch.sparse_adam_``) on the current stream: w, m,
    v updated in place, a bf16 table rounded stochastically keyed by
    ``sr_seed`` (None: ``t``; a row shard passes its own, so that the shards
    do not share one stream).
    Returns sum(w_pre**2) as a 0-dim f32 CUDA tensor with ``want_l2``, else
    None; it is a view of scratch that the next update of a table of this
    size overwrites, so use it (or copy it) before that. Raises on
    anything the kernel does not take and on a failed build or launch."""
    n_rows, d = w.shape
    dev = w.device
    if dev.type != "cuda":
        raise ValueError("sparse_adam_cuda needs CUDA tensors")
    for name, x in (("m", m), ("v", v), ("uids", uids), ("gsum", gsum)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, w on {dev}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table dtype {w.dtype}")
    if m.dtype != v.dtype or m.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"moment dtypes {m.dtype}, {v.dtype}")
    if m.shape != w.shape or v.shape != w.shape:
        raise ValueError("w, m, v shapes differ")
    if uids.dtype != torch.int32 or uids.dim() != 1:
        raise TypeError("uids must be 1-D int32")
    if gsum.dtype != torch.float32 or gsum.shape != (uids.shape[0], d):
        raise TypeError("gsum must be [K, D] float32")
    if n_rows * d >= 2**32:
        raise ValueError("table has >= 2^32 elements; the element index "
                         "is uint32")
    if not all(x.is_contiguous() for x in (w, m, v, uids, gsum)):
        raise ValueError("w, m, v, uids and gsum must be contiguous")
    from aread_tpu_torch.ops.cuda import build

    build.load("sparse_adam")
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    vpr, shift, mul = sweep_plan(d, is_aligned16(w, m, v, gsum))
    scratch = _slot_map(dev, n_rows)
    partials, out, count = ((scratch.partials, scratch.l2, scratch.count)
                            if want_l2 else (scratch.none,) * 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        try:
            torch.ops.aread_tpu_torch.sparse_adam_(
                w, m, v, uids, gsum, scratch.slot, partials, out, count,
                s["lr"], s["b1"], s["b2"], s["eps"], s["decay"], s["b1c"],
                s["b2c"], s["omb1"], s["omb2"],
                int(t if sr_seed is None else sr_seed), vpr, shift, mul,
                stream)
        except RuntimeError:
            # a launch that failed after the scatter leaves the map dirty
            _SLOTS.pop(_slot_key(dev, n_rows), None)
            raise
    launch_counts["sparse_adam"] += 1
    return out[0] if want_l2 else None


def sparse_adam_dispatch(w, m, v, uids, gsum, t: int, lr: float,
                         b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                         weight_decay: float = 1e-8, l2: float = 0.0,
                         want_l2: bool = False, lazy: bool = False,
                         sr_seed=None):
    """One Adam step on the [n_rows, D] table, in place. (uids, gsum) are
    ``dedup_rows``' output. Dense semantics (the default): CUDA tensors go
    through the kernel, CPU tensors through the plain version. ``lazy``:
    the touched rows only, by indexed updates on either device, never the
    kernel. Returns the pre-update sum(w**2) (0-dim f32) with ``want_l2``,
    else None. ``sr_seed`` keys a bf16 table's stochastic rounding (None:
    ``t``)."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              sr_seed=sr_seed)
    if lazy:
        # the sum is a full pass of its own here: no sweep carries it
        l2v = (torch.sum(torch.square(w.to(torch.float32)))
               if want_l2 else None)
        lazy_sparse_adam_(w, m, v, uids, gsum, t, **kw)
        return l2v
    kw["want_l2"] = want_l2
    if w.device.type == "cuda":
        return sparse_adam_cuda(w, m, v, uids, gsum, t, **kw)
    out = sparse_adam_reference(w, m, v, uids, gsum, t, **kw)
    w.copy_(out[0])
    m.copy_(out[1])
    v.copy_(out[2])
    return out[3] if want_l2 else None
