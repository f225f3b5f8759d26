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
* The scalars that change from step to step (lr, the bias corrections
  b1c and b2c, the stochastic rounding's seed) reach the kernel and the
  plain version as a small device tensor, the step's scalar block
  (``step_scalars``), so that a captured CUDA graph replays each step
  with its own (``train/step_graph.py`` stages a chunk's blocks in one
  copy); the host computes every value as ``adam_scalars`` does, and the
  callers that pass ``t`` and ``lr`` get the block made for them. The
  step-independent scalars stay launch arguments. Neither the kernel's
  wrapper nor the plain version reads anything back to the host.
* ``sparse_adam_dispatch`` updates w, m and v in place: with CPU tensors
  through the plain version, with CUDA tensors through the hand-written
  kernel ``ops/cuda/sparse_adam.cu`` (``sparse_adam_cuda``), always — if
  the kernel cannot be built or launched it raises.
* ``lazy_sparse_adam_`` (the dispatch's ``lazy=True``) is the other table
  optimizer, ``table_optimizer='lazy_adam'``: only the gathered rows
  change, so there is no table sweep and no kernel; the JAX package runs
  it with gathers and scatters outside its Pallas kernel too, and indexed
  PyTorch ops on either device are its port. It reads the same scalar
  block and keeps static shapes (every entry of ``uids``, the sentinels
  included), so a captured step replays it too.

The TPU kernel's ``PAD_W`` block window, its overflow fallback and the
host checks that avoid it (``rows_fit_kernel``, ``steps_fit_kernel``) have
no counterpart: the CUDA kernel finds touched rows through a slot map and
has no window to overflow.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from aread_tpu_torch.ops.cuda import count_launch, launch_counts  # noqa: F401
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


def adam_constants(b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                   weight_decay: float = 1e-8,
                   l2: float = 0.0) -> Dict[str, float]:
    """The step-independent f32 scalars, each a Python float holding an
    exact f32 value; ``1 - b`` is taken in double and then rounded, as the
    JAX package computes it."""
    f32 = np.float32
    return {"b1": float(f32(b1)), "b2": float(f32(b2)),
            "eps": float(f32(eps)), "decay": float(f32(weight_decay + 2.0 * l2)),
            "omb1": float(f32(1.0 - b1)), "omb2": float(f32(1.0 - b2))}


def adam_scalars(t: int, lr: float, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 1e-8,
                 l2: float = 0.0) -> Dict[str, float]:
    """The f32 scalars of one step, each a Python float holding an exact
    f32 value: ``adam_constants`` and lr and the bias corrections ``1 -
    b**t``, taken in f32 as the JAX package computes them; the kernel and
    the plain version get the same values."""
    f32 = np.float32
    # numpy's f32 scalar power, not torch's on two 0-dim tensors: the same
    # bits (tests/test_torch_port_vector_plan.py) in under half the host time
    b1t = f32(b1) ** f32(t)
    b2t = f32(b2) ** f32(t)
    c = adam_constants(b1, b2, eps, weight_decay, l2)
    return {
        "lr": float(f32(lr)), "b1": c["b1"], "b2": c["b2"], "eps": c["eps"],
        "decay": c["decay"],
        "b1c": float(f32(1.0) - b1t), "b2c": float(f32(1.0) - b2t),
        "omb1": c["omb1"], "omb2": c["omb2"],
    }


def step_scalars(t: int, lr: float, b1: float = 0.9, b2: float = 0.99,
                 sr_seed=None) -> np.ndarray:
    """The [4] int32 scalar block of step ``t``: the f32 bits of lr, b1c
    and b2c, bitwise ``adam_scalars``', then the 32 bits of ``sr_seed``
    (None: ``t``)."""
    s = adam_scalars(t, lr, b1, b2)
    seed = (t if sr_seed is None else int(sr_seed)) & 0xFFFFFFFF
    return np.concatenate([
        np.array([s["lr"], s["b1c"], s["b2c"]], np.float32).view(np.int32),
        np.array([seed], np.uint32).view(np.int32)])


def chunk_scalars(t0: int, n: int, lr: float, b1: float = 0.9,
                  b2: float = 0.99) -> np.ndarray:
    """[n, 4] int32: the scalar blocks of steps ``t0 + 1 .. t0 + n`` (a
    chunk of steps after ``t0``), each seeded by its step."""
    return np.stack([step_scalars(t0 + i + 1, lr, b1, b2) for i in range(n)])


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. On CUDA through pinned memory and an
    asynchronous copy, so that the host does not wait for the device (a
    copy from pageable memory synchronizes the stream); the caching host
    allocator keeps the pinned block until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def step_block(t: int, lr: float, b1: float, b2: float, sr_seed,
               scalars, dev) -> torch.Tensor:
    """``scalars``, the step's [4] int32 block on ``dev``, checked; or,
    when it is None, the block of step ``t`` with ``lr`` and ``sr_seed``
    (None: ``t``) made by ``step_scalars`` and copied there without a host
    wait."""
    if scalars is None:
        return to_device(step_scalars(t, lr, b1, b2, sr_seed), dev)
    if (scalars.dtype != torch.int32 or scalars.shape != (4,)
            or scalars.device != dev or not scalars.is_contiguous()):
        raise TypeError("scalars must be the step's contiguous [4] int32 "
                        f"block on {dev}")
    return scalars


def split_scalars(block: torch.Tensor):
    """(lr, b1c, b2c, seed) of a [4] int32 scalar block: 0-dim views on its
    device, f32 for the three and int32 for the seed."""
    f = block.view(torch.float32)
    return f[0], f[1], f[2], block[3]


def sparse_adam_reference(w, m, v, uids, gsum, t: int, lr: float,
                          b1: float = 0.9, b2: float = 0.99,
                          eps: float = 1e-8, weight_decay: float = 1e-8,
                          l2: float = 0.0, want_l2: bool = False,
                          sr_seed=None, scalars=None):
    """Plain two-phase update (port of ``_xla_sparse_adam``). Returns new
    (w, m, v), plus sum(w_pre**2) as a 0-dim f32 tensor with ``want_l2``.
    lr, the bias corrections and the seed are read from ``scalars``, the
    step's [4] int32 scalar block on the data's device (None: made from
    ``t``, ``lr`` and ``sr_seed`` by ``step_scalars``; ``sr_seed`` None is
    ``t``). A bf16 table is rounded stochastically, keyed by the seed and
    the element index. Nothing is read back to the host.
    Every scalar that divides is a 0-dim tensor on the data's device: on
    CUDA, PyTorch turns division by a Python scalar into multiplication by
    its reciprocal, which is not the IEEE quotient."""
    n_rows, d = w.shape
    dev = w.device
    lr_t, b1c, b2c, seed = split_scalars(
        step_block(t, lr, b1, b2, sr_seed, scalars, dev))
    s = adam_constants(b1, b2, eps, weight_decay, l2)

    def adam(w_, m_, v_, g_):
        wf = w_.to(torch.float32)
        g_ = g_ + s["decay"] * wf
        m2 = s["b1"] * m_.to(torch.float32) + s["omb1"] * g_
        v2 = s["b2"] * v_.to(torch.float32) + s["omb2"] * g_ * g_
        w2 = wf - lr_t * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
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
    # phase B: overwrite the touched rows with their full-gradient update;
    # the sentinel entries write a spare last row, dropped after (a boolean
    # selection of the live entries would read their count back to the host)
    dst = torch.where(uids < n_rows, uids, n_rows).to(torch.int64)

    def put(full, rows):
        return torch.cat([full, full[:1]]).index_copy_(0, dst, rows)[:n_rows]

    w2, m2, v2 = put(w2, nw), put(m2, nm), put(v2, nv)
    return (w2, m2, v2, l2v) if want_l2 else (w2, m2, v2)


@torch.no_grad()
def lazy_sparse_adam_(w, m, v, uids, gsum, t: int, lr: float,
                      b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                      weight_decay: float = 1e-8, l2: float = 0.0,
                      sr_seed=None, scalars=None) -> None:
    """SparseAdam-semantics update in place (port of
    ``_lazy_sparse_adam``, its [n_rows, D] branch): only the rows in
    ``uids`` change, weights and moments; the rest of the table is bitwise
    untouched and its moments do not decay. The bias correction uses the
    global step; the decay and L2 term is applied to the touched rows'
    gradients ('lazy regularization'). A bf16 table is rounded
    stochastically, keyed by the seed and the storage index, as in the
    dense-semantics update. lr, the bias corrections and the seed are read
    from ``scalars``, the step's [4] int32 block on the table's device
    (None: made from ``t``, ``lr`` and ``sr_seed``, None: ``t``). Work is
    O(touched rows).

    Static shapes, nothing read back to the host, so that a CUDA graph
    captures it: all K entries of ``uids`` (``dedup_rows``' output, sorted
    and unique, sentinels ``n_rows`` at the tail) are computed, the rows
    read at ``min(uids, n_rows - 1)``. PyTorch has no ``mode="drop"``, so
    a sentinel entry writes entry 0's row with entry 0's new bits, the
    same bits that entry 0 writes there (duplicate writes of equal bits
    leave one result in any order); when entry 0 is itself a sentinel,
    every entry is, and all write row ``n_rows - 1``'s own old bits
    back."""
    n_rows, d = w.shape
    dev = w.device
    lr_t, b1c, b2c, seed = split_scalars(
        step_block(t, lr, b1, b2, sr_seed, scalars, dev))
    s = adam_constants(b1, b2, eps, weight_decay, l2)
    live = (uids < n_rows)[:, None]  # sentinel entries carry no row
    gid = torch.clamp(uids.to(torch.int64), max=n_rows - 1)
    w0, m0, v0 = (x.index_select(0, gid) for x in (w, m, v))
    wf = w0.to(torch.float32)
    g = gsum + s["decay"] * wf
    m2 = s["b1"] * m0.to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v0.to(torch.float32) + s["omb2"] * g * g
    w2 = wf - lr_t * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
    # a sentinel entry's values are its clamped row's old bits ...
    nw = torch.where(live, sround(w2, w.dtype, _row_flat_index(gid, d),
                                  seed), w0)
    nm = torch.where(live, m2.to(m.dtype), m0)
    nv = torch.where(live, v2.to(v.dtype), v0)
    # ... and it writes entry 0's row with entry 0's values: where entry 0
    # is live, never the old bits of a row that a live entry updates
    dst = torch.where(live[:, 0], gid, gid[:1])
    for x, new in ((w, nw), (m, nm), (v, nv)):
        x.index_copy_(0, dst, torch.where(live, new, new[:1]))


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
                     want_l2: bool = False, sr_seed=None, scalars=None):
    """Launch ``ops/cuda/sparse_adam.cu`` (the operator
    ``torch.ops.aread_tpu_torch.sparse_adam_``) on the current stream: w, m,
    v updated in place, a bf16 table rounded stochastically keyed by
    the seed (``sr_seed``, None: ``t``; a row shard passes its own, so that
    the shards do not share one stream). The kernel reads lr, b1c, b2c and
    the seed from ``scalars``, the step's [4] int32 block on the table's
    device (None: made from ``t``, ``lr`` and ``sr_seed`` and copied there
    without a host wait).
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
    scalars = step_block(t, lr, b1, b2, sr_seed, scalars, dev)
    from aread_tpu_torch.ops.cuda import build

    build.load("sparse_adam")
    s = adam_constants(b1, b2, eps, weight_decay, l2)
    vpr, shift, mul = sweep_plan(d, is_aligned16(w, m, v, gsum))
    scratch = _slot_map(dev, n_rows)
    partials, out, count = ((scratch.partials, scratch.l2, scratch.count)
                            if want_l2 else (scratch.none,) * 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        try:
            torch.ops.aread_tpu_torch.sparse_adam_(
                w, m, v, uids, gsum, scratch.slot, partials, out, count,
                scalars, s["b1"], s["b2"], s["eps"], s["decay"], s["omb1"],
                s["omb2"], vpr, shift, mul, stream)
        except RuntimeError:
            # a launch that failed after the scatter leaves the map dirty
            _SLOTS.pop(_slot_key(dev, n_rows), None)
            raise
    count_launch("sparse_adam")
    return out[0] if want_l2 else None


def sparse_adam_dispatch(w, m, v, uids, gsum, t: int, lr: float,
                         b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                         weight_decay: float = 1e-8, l2: float = 0.0,
                         want_l2: bool = False, lazy: bool = False,
                         sr_seed=None, scalars=None):
    """One Adam step on the [n_rows, D] table, in place. (uids, gsum) are
    ``dedup_rows``' output. Dense semantics (the default): CUDA tensors go
    through the kernel, CPU tensors through the plain version, both reading
    the step's scalar block ``scalars`` (None: made from ``t``, ``lr`` and
    ``sr_seed``). ``lazy``: the touched rows only, by indexed updates on
    either device, never the kernel, from the same block. Returns the
    pre-update sum(w**2) (0-dim f32) with ``want_l2``, else None.
    ``sr_seed`` keys a bf16 table's stochastic rounding (None: ``t``)."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              sr_seed=sr_seed)
    if lazy:
        # the sum is a full pass of its own here: no sweep carries it
        l2v = (torch.sum(torch.square(w.to(torch.float32)))
               if want_l2 else None)
        lazy_sparse_adam_(w, m, v, uids, gsum, t, scalars=scalars, **kw)
        return l2v
    kw.update(want_l2=want_l2, scalars=scalars)
    if w.device.type == "cuda":
        return sparse_adam_cuda(w, m, v, uids, gsum, t, **kw)
    out = sparse_adam_reference(w, m, v, uids, gsum, t, **kw)
    w.copy_(out[0])
    m.copy_(out[1])
    v.copy_(out[2])
    return out[3] if want_l2 else None
