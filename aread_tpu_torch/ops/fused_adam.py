"""Fused dense Adam for one large leaf (counterpart of
``aread_tpu/ops/pallas/fused_adam.py``).

The generic ``Trainer`` with ``sparse_table_grad=False`` holds the fused
embedding table's dense ``[n_rows, D]`` gradient, and the reference's
L2 term and torch-Adam weight decay give every row a nonzero gradient, so
the whole table takes one Adam step per training step:

    g  = g + (wd + 2*l2) * w
    m  = b1*m + (1-b1)*g
    v  = b2*v + (1-b2)*g^2
    w  = w - lr * (m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps)

* ``fused_adam_reference`` is the plain PyTorch version, a line-for-line
  port of the JAX package's ``reference_adam_update``; it returns new
  tensors. Tests and the CPU path use it.
* ``fused_adam_cuda`` launches the hand-written kernel
  ``ops/cuda/fused_adam.cu`` (``torch.ops.aread_tpu_torch.fused_adam_``),
  in place: its vector form (a thread per 8 elements, 16-byte accesses)
  when w, m, v and g are 16-byte aligned, its scalar form (a thread per
  element) otherwise. Both leave the same bits.
* ``fused_adam_dispatch`` updates w, m and v in place: CUDA tensors go
  through the kernel, always — a failed build or launch raises — and CPU
  tensors through the plain version.

Both take the f32 scalars of ``ops.sparse_adam.adam_scalars``, so the
dense and the sparse table update agree bitwise on the same gradient. The
scalars that change from step to step (lr, the bias corrections, the
rounding's seed) reach the kernel and the plain version as the step's
scalar block on the device (``ops/sparse_adam.py::step_scalars``, ``scalars=``),
as kernel 1's do, so that a captured CUDA graph replays each step with its
own; a caller that passes only ``t`` and ``lr`` gets the block made for it.
Neither reads anything back to the host. A
bf16 leaf computes in f32 and is written with stochastic rounding keyed
by (global element index, t), in the kernel too (the TPU kernel hands that
case to its plain version). The global index of the leaf's first element
is ``index_base``: 0 for a whole leaf, the shard's first element for a
mesh rank's rows of the table, so that the shards round as the whole
table does, as in the JAX package, where GSPMD runs the update on the
row-sharded table with global indices.
"""

from __future__ import annotations

import torch

from aread_tpu_torch.ops.cuda import count_launch, launch_counts  # noqa: F401
from aread_tpu_torch.ops.rounding import sround
from aread_tpu_torch.ops.sparse_adam import (VEC, adam_constants,
                                             is_aligned16, split_scalars,
                                             step_block)

_STORAGE = (torch.float32, torch.bfloat16)


def fused_adam_reference(w, m, v, g, t: int, lr: float, b1: float = 0.9,
                         b2: float = 0.99, eps: float = 1e-8,
                         weight_decay: float = 1e-8, l2: float = 0.0,
                         sr_seed=None, index_base: int = 0, scalars=None):
    """Plain version (port of ``reference_adam_update``). Returns new
    (w, m, v) in the inputs' dtypes; a bf16 leaf rounds stochastically,
    keyed by the seed and the element's global index ``index_base + e``.
    lr, the bias corrections and the seed are read from ``scalars``, the
    step's [4] int32 block on the data's device (None: made from ``t``,
    ``lr`` and ``sr_seed``; ``sr_seed`` None is ``t``). Nothing is read
    back to the host. Every scalar that divides is a 0-dim tensor on the
    data's device: on CUDA, PyTorch turns division by a Python scalar into
    multiplication by its reciprocal, which is not the IEEE quotient."""
    dev = w.device
    check_index_base(index_base, w.numel())
    lr_t, b1c, b2c, seed = split_scalars(
        step_block(t, lr, b1, b2, sr_seed, scalars, dev))
    s = adam_constants(b1, b2, eps, weight_decay, l2)
    wf = w.to(torch.float32)
    g = g.to(torch.float32) + s["decay"] * wf
    m2 = s["b1"] * m.to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v.to(torch.float32) + s["omb2"] * g * g
    mhat = m2 / b1c
    vhat = v2 / b2c
    new_w = wf - lr_t * mhat / (torch.sqrt(vhat) + s["eps"])
    if w.dtype == torch.bfloat16:
        idx = torch.arange(index_base, index_base + w.numel(),
                           dtype=torch.int64, device=dev).reshape(w.shape)
        new_w = sround(new_w, w.dtype, idx, seed)
    return new_w.to(w.dtype), m2.to(m.dtype), v2.to(v.dtype)


def check_index_base(index_base: int, numel: int) -> None:
    """The stochastic rounding's element index is uint32, as in the JAX
    package: a leaf's global indices ``index_base .. index_base + numel
    - 1`` must stay below 2^32."""
    if index_base < 0 or index_base + numel >= 2**32:
        raise ValueError(f"index_base {index_base} + numel {numel} is not "
                         "below 2^32; the element index is uint32")


def takes_vector_kernel(numel: int, aligned: bool) -> bool:
    """Whether a leaf of ``numel`` elements goes through the vector kernel:
    w, m, v and g 16-byte aligned and at least one whole vector (the last
    ``numel % 8`` elements are done one by one in the same launch)."""
    return aligned and numel >= VEC


def fused_adam_cuda(w, m, v, g, t: int, lr: float, b1: float = 0.9,
                    b2: float = 0.99, eps: float = 1e-8,
                    weight_decay: float = 1e-8, l2: float = 0.0,
                    sr_seed=None, index_base: int = 0,
                    scalars=None) -> None:
    """Launch ``ops/cuda/fused_adam.cu`` on the current stream: w, m, v
    updated in place; a bf16 leaf rounds keyed by the seed and the global
    element index ``index_base + e``. The kernel reads lr, b1c, b2c and
    the seed from ``scalars``, the step's [4] int32 block on the leaf's
    device (None: made from ``t``, ``lr`` and ``sr_seed``, None meaning
    ``t``, and copied there without a host wait). Raises on anything the
    kernel does not take and on a failed build or launch."""
    dev = w.device
    if dev.type != "cuda":
        raise ValueError("fused_adam_cuda needs CUDA tensors")
    for name, x in (("m", m), ("v", v), ("g", g)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, w on {dev}")
        if x.shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, w "
                             f"{tuple(w.shape)}")
    if w.dtype not in _STORAGE or g.dtype not in _STORAGE:
        raise TypeError(f"w {w.dtype}, g {g.dtype}: float32 or bfloat16")
    if m.dtype != v.dtype or m.dtype not in _STORAGE:
        raise TypeError(f"moment dtypes {m.dtype}, {v.dtype}")
    check_index_base(index_base, w.numel())
    if not all(x.is_contiguous() for x in (w, m, v, g)):
        raise ValueError("w, m, v and g must be contiguous")
    from aread_tpu_torch.ops.cuda import build

    scalars = step_block(t, lr, b1, b2, sr_seed, scalars, dev)
    build.load("fused_adam")
    s = adam_constants(b1, b2, eps, weight_decay, l2)
    vec = takes_vector_kernel(w.numel(), is_aligned16(w, m, v, g))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        torch.ops.aread_tpu_torch.fused_adam_(
            w, m, v, g, scalars, s["b1"], s["b2"], s["eps"], s["decay"],
            s["omb1"], s["omb2"], int(index_base), vec, stream)
    count_launch("fused_adam")


def fused_adam_dispatch(w, m, v, g, t: int, lr: float, b1: float = 0.9,
                        b2: float = 0.99, eps: float = 1e-8,
                        weight_decay: float = 1e-8, l2: float = 0.0,
                        sr_seed=None, index_base: int = 0,
                        scalars=None) -> None:
    """One torch-semantics Adam step on a leaf from its dense gradient, in
    place. CUDA tensors go through the kernel, CPU tensors through the
    plain version, both reading the step's scalar block ``scalars`` (None:
    made from ``t``, ``lr`` and ``sr_seed``). The seed (``sr_seed``, None:
    ``t``) and ``index_base`` (the global index of the leaf's first
    element) key a bf16 leaf's rounding."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              sr_seed=sr_seed, index_base=index_base, scalars=scalars)
    if w.device.type == "cuda":
        fused_adam_cuda(w, m, v, g, t, **kw)
        return
    nw, nm, nv = fused_adam_reference(w, m, v, g, t, **kw)
    w.copy_(nw)
    m.copy_(nm)
    v.copy_(nv)
