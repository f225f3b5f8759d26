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

The TPU kernel's ``PAD_W`` block window, its overflow fallback and the
host checks that avoid it (``rows_fit_kernel``, ``steps_fit_kernel``) have
no counterpart: the CUDA kernel finds touched rows through a slot map and
has no window to overflow.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def sparse_adam_reference(w, m, v, uids, gsum, t: int, lr: float,
                          b1: float = 0.9, b2: float = 0.99,
                          eps: float = 1e-8, weight_decay: float = 1e-8,
                          l2: float = 0.0, want_l2: bool = False):
    """Plain two-phase update (port of ``_xla_sparse_adam``). Returns new
    (w, m, v), plus sum(w_pre**2) as a 0-dim f32 tensor with ``want_l2``.
    A bf16 table is rounded stochastically, keyed by the step ``t``.
    Every scalar that divides is a 0-dim tensor on the data's device: on
    CUDA, PyTorch turns division by a Python scalar into multiplication by
    its reciprocal, which is not the IEEE quotient."""
    n_rows, d = w.shape
    dev = w.device
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
    nw = sround(nw, w.dtype, _row_flat_index(gid, d), t)
    # phase A: decay-only dense pass
    w2, m2, v2 = adam(w, m, v, torch.zeros_like(w, dtype=torch.float32))
    w2 = sround(w2, w.dtype, flat_index_grid(n_rows, d, dev), t)
    # phase B: overwrite the touched rows with their full-gradient update
    live = uids < n_rows
    rows = uids[live].to(torch.int64)
    w2[rows] = nw[live]
    m2[rows] = nm[live]
    v2[rows] = nv[live]
    return (w2, m2, v2, l2v) if want_l2 else (w2, m2, v2)


# --------------------------------------------------------------- CUDA path
_SLOTS: Dict[Tuple[int, int], torch.Tensor] = {}


def _slot_key(device: torch.device, n_rows: int) -> Tuple[int, int]:
    """(card index, table size); a device without an index ("cuda") is the
    current card."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return index, n_rows


def _slot_map(device: torch.device, n_rows: int) -> torch.Tensor:
    """Persistent int32 slot map, all -1 between launches (the kernel
    restores it), one per (card, table size)."""
    key = _slot_key(device, n_rows)
    slot = _SLOTS.get(key)
    if slot is None:
        slot = torch.full((n_rows,), -1, dtype=torch.int32, device=device)
        _SLOTS[key] = slot
    return slot


def sweep_blocks(device: torch.device, n_elems: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms * 16, -(-n_elems // 256)))


def sparse_adam_cuda(w, m, v, uids, gsum, t: int, lr: float, b1: float = 0.9,
                     b2: float = 0.99, eps: float = 1e-8,
                     weight_decay: float = 1e-8, l2: float = 0.0,
                     want_l2: bool = False):
    """Launch ``ops/cuda/sparse_adam.cu`` (the operator
    ``torch.ops.aread_tpu_torch.sparse_adam_``) on the current stream: w, m,
    v updated in place, a bf16 table rounded stochastically keyed by ``t``.
    Returns sum(w_pre**2) as a 0-dim f32 CUDA tensor with ``want_l2``, else
    None. Raises on anything the kernel does not take and on a failed
    build or launch."""
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
    slot = _slot_map(dev, n_rows)
    n_blocks = sweep_blocks(dev, n_rows * d)
    partials = torch.empty((n_blocks if want_l2 else 0,), dtype=torch.float64,
                           device=dev)
    out = torch.empty((1 if want_l2 else 0,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        try:
            torch.ops.aread_tpu_torch.sparse_adam_(
                w, m, v, uids, gsum, slot, partials, out, s["lr"], s["b1"],
                s["b2"], s["eps"], s["decay"], s["b1c"], s["b2c"], s["omb1"],
                s["omb2"], int(t), n_blocks, stream)
        except RuntimeError:
            # a launch that failed after the scatter leaves the map dirty
            _SLOTS.pop(_slot_key(dev, n_rows), None)
            raise
    launch_counts["sparse_adam"] += 1
    return out[0].to(torch.float32) if want_l2 else None


def sparse_adam_dispatch(w, m, v, uids, gsum, t: int, lr: float,
                         b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                         weight_decay: float = 1e-8, l2: float = 0.0,
                         want_l2: bool = False):
    """One dense-semantics Adam step on the [n_rows, D] table, in place.
    (uids, gsum) are ``dedup_rows``' output. CUDA tensors go through the
    kernel, CPU tensors through the plain version. Returns the pre-update
    sum(w**2) (0-dim f32) with ``want_l2``, else None."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              want_l2=want_l2)
    if w.device.type == "cuda":
        return sparse_adam_cuda(w, m, v, uids, gsum, t, **kw)
    out = sparse_adam_reference(w, m, v, uids, gsum, t, **kw)
    w.copy_(out[0])
    m.copy_(out[1])
    v.copy_(out[2])
    return out[3] if want_l2 else None
