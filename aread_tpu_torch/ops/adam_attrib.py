"""Kernel 1's sweep with parts taken out (counterpart of the TPU probe
``benchmarks/prof_kernel_attrib.py::variant_kernel``): where the
sparse-Adam sweep's time above a bare copy of w, m and v goes.

Modes, each a function of (w, m, v, uids, gsum, t) on a bf16 table with
bf16 moments (``ops/cuda/adam_attrib.cu`` says what each isolates):

* ``full``   — the sparse Adam update itself (``sparse_adam_reference``);
* ``rtn``    — the weight rounded to nearest instead of stochastically;
* ``dot1``   — each touched row's gradient rounded to bf16 first;
* ``noslot`` — a zero data gradient (only the decay enters Adam);
* ``noadam`` — w becomes w + g * 0, m and v unchanged;
* ``copy``   — w, m and v unchanged.

``adam_attrib_reference`` is the plain version; ``adam_attrib_`` launches
the hand-written kernel in place on CUDA tensors and raises on anything
else. Both take the scalars of ``ops.sparse_adam.adam_scalars``. The
kernel has two sweeps (``FORMS``), which leave the same bits: ``vec8`` (16
bytes of each of w, m, v a thread, kernel 1's sweep) and ``tma`` (a
bulk-copy pipeline through shared memory, the default: it moves ``copy``
faster on the card).
"""

from __future__ import annotations

import torch

from aread_tpu_torch.ops.cuda import count_launch, launch_counts  # noqa: F401
from aread_tpu_torch.ops.rounding import flat_index_grid, sround
from aread_tpu_torch.ops.sparse_adam import (_SLOTS, _slot_key, _slot_map,
                                             adam_scalars, is_aligned16,
                                             sparse_adam_reference)

MODES = ("full", "rtn", "dot1", "noslot", "noadam", "copy")
# the sweeps, in adam_attrib.cu's Form order
FORMS = ("vec8", "tma")
DEFAULT_FORM = "tma"
# the tma sweep's tiles: TILE contiguous elements of each of w, m and v,
# whole rows for every width
TILE = 2048
# D = 8 * vpr with vpr a power of two dividing 32: a row's vectors are lanes
# of one warp, which resets the row's slot in the sweep
WIDTHS = (8, 16, 32, 64, 128, 256)


def _data_gradient(mode: str, shape, uids, gsum) -> torch.Tensor:
    """The dense f32 data gradient a mode's Adam sees: gsum's rows at their
    uids (sentinels dropped), bf16-rounded for ``dot1``, zero for
    ``noslot``."""
    gd = torch.zeros(shape, dtype=torch.float32, device=gsum.device)
    if mode == "noslot":
        return gd
    live = uids < shape[0]
    g = gsum[live]
    if mode == "dot1":
        g = g.to(torch.bfloat16).to(torch.float32)
    gd[uids[live].to(torch.int64)] = g
    return gd


def adam_attrib_reference(mode: str, w, m, v, uids, gsum, t: int, lr: float,
                          b1: float = 0.9, b2: float = 0.99,
                          eps: float = 1e-8, weight_decay: float = 1e-8,
                          l2: float = 0.0, sr_seed=None):
    """Plain version of ``mode``: new (w, m, v). ``full`` is
    ``sparse_adam_reference``; the others are the same Adam over the table
    (every row: decay for the untouched ones) with the mode's one change."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              sr_seed=sr_seed)
    if mode == "full":
        return sparse_adam_reference(w, m, v, uids, gsum, t, **kw)
    if mode == "copy":
        return w.clone(), m.clone(), v.clone()
    gd = _data_gradient(mode, w.shape, uids, gsum)
    if mode == "noadam":
        return (w.to(torch.float32) + gd * 0).to(w.dtype), m.clone(), v.clone()
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    # divisors as 0-dim tensors: see sparse_adam_reference
    b1c = torch.tensor(s["b1c"], dtype=torch.float32, device=w.device)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32, device=w.device)
    wf = w.to(torch.float32)
    g = gd + s["decay"] * wf
    m2 = s["b1"] * m.to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v.to(torch.float32) + s["omb2"] * g * g
    w2 = wf - s["lr"] * (m2 / b1c) / (torch.sqrt(v2 / b2c) + s["eps"])
    if mode == "rtn":
        w2 = w2.to(w.dtype)
    else:
        w2 = sround(w2, w.dtype, flat_index_grid(*w.shape, w.device),
                    t if sr_seed is None else sr_seed)
    return w2, m2.to(m.dtype), v2.to(v.dtype)


def adam_attrib_(mode: str, w, m, v, uids, gsum, t: int, lr: float,
                 b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                 weight_decay: float = 1e-8, l2: float = 0.0,
                 sr_seed=None, form: str = DEFAULT_FORM) -> None:
    """Launch ``ops/cuda/adam_attrib.cu``'s ``mode`` in its sweep ``form``
    on the current stream, w, m and v updated in place. Takes CUDA bf16 w,
    m, v ``[n_rows, D]`` with D in ``WIDTHS``, contiguous and 16-byte
    aligned, int32 uids and f32 gsum ``[K, D]`` (``dedup_rows``' output);
    raises on anything else (a mode, a form, a dtype or a width before a
    tensor off the card, all before any build) and on a failed build or
    launch. The slot map is kernel 1's (``sparse_adam._slot_map``): all -1
    between launches of either."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if form not in FORMS:
        raise ValueError(f"form {form!r}: one of {FORMS}")
    if not all(x.dtype == torch.bfloat16 for x in (w, m, v)):
        raise TypeError(f"w, m, v dtypes {w.dtype}, {m.dtype}, {v.dtype}: "
                        "bfloat16 only")
    if w.dim() != 2 or m.shape != w.shape or v.shape != w.shape:
        raise ValueError("w, m, v must be [n_rows, D] of one shape")
    n_rows, d = w.shape
    if d not in WIDTHS:
        raise ValueError(f"width D={d}: one of {WIDTHS}")
    if uids.dtype != torch.int32 or uids.dim() != 1:
        raise TypeError("uids must be 1-D int32")
    if gsum.dtype != torch.float32 or gsum.shape != (uids.shape[0], d):
        raise TypeError("gsum must be [K, D] float32")
    dev = w.device
    if dev.type != "cuda":
        raise ValueError("adam_attrib_ needs CUDA tensors")
    for name, x in (("m", m), ("v", v), ("uids", uids), ("gsum", gsum)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, w on {dev}")
    if n_rows * d >= 2**32:
        raise ValueError("table has >= 2^32 elements; the element index "
                         "is uint32")
    if not all(x.is_contiguous() for x in (w, m, v, uids, gsum)):
        raise ValueError("w, m, v, uids and gsum must be contiguous")
    if not is_aligned16(w, m, v, gsum):
        raise ValueError("w, m, v and gsum must start on 16-byte boundaries")
    from aread_tpu_torch.ops.cuda import build

    build.load("adam_attrib")
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    slot = _slot_map(dev, n_rows).slot
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        try:
            torch.ops.aread_tpu_torch.adam_attrib_(
                w, m, v, uids, gsum, slot, MODES.index(mode),
                FORMS.index(form), s["lr"],
                s["b1"], s["b2"], s["eps"], s["decay"], s["b1c"], s["b2c"],
                s["omb1"], s["omb2"], int(t if sr_seed is None else sr_seed),
                (d // 8).bit_length() - 1, stream)
        except RuntimeError:
            # a launch that failed after the scatter leaves the map dirty
            _SLOTS.pop(_slot_key(dev, n_rows), None)
            raise
    count_launch("adam_attrib")
