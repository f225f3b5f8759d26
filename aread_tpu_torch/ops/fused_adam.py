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
dense and the sparse table update agree bitwise on the same gradient. A
bf16 leaf computes in f32 and is written with stochastic rounding keyed
by (flat element index, t), in the kernel too (the TPU kernel hands that
case to its plain version).
"""

from __future__ import annotations

import torch

from aread_tpu_torch.ops.cuda import launch_counts
from aread_tpu_torch.ops.rounding import sround
from aread_tpu_torch.ops.sparse_adam import VEC, adam_scalars, is_aligned16

_STORAGE = (torch.float32, torch.bfloat16)


def fused_adam_reference(w, m, v, g, t: int, lr: float, b1: float = 0.9,
                         b2: float = 0.99, eps: float = 1e-8,
                         weight_decay: float = 1e-8, l2: float = 0.0,
                         sr_seed=None):
    """Plain version (port of ``reference_adam_update``). Returns new
    (w, m, v) in the inputs' dtypes; a bf16 leaf rounds stochastically,
    keyed by ``sr_seed`` (None: ``t``). Every scalar that divides is a 0-dim
    tensor on the data's device: on CUDA, PyTorch turns division by a
    Python scalar into multiplication by its reciprocal, which is not the
    IEEE quotient."""
    dev = w.device
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    b1c = torch.tensor(s["b1c"], dtype=torch.float32, device=dev)
    b2c = torch.tensor(s["b2c"], dtype=torch.float32, device=dev)
    wf = w.to(torch.float32)
    g = g.to(torch.float32) + s["decay"] * wf
    m2 = s["b1"] * m.to(torch.float32) + s["omb1"] * g
    v2 = s["b2"] * v.to(torch.float32) + s["omb2"] * g * g
    mhat = m2 / b1c
    vhat = v2 / b2c
    new_w = wf - s["lr"] * mhat / (torch.sqrt(vhat) + s["eps"])
    if w.dtype == torch.bfloat16:
        idx = torch.arange(w.numel(), dtype=torch.int64,
                           device=dev).reshape(w.shape)
        new_w = sround(new_w, w.dtype, idx, t if sr_seed is None else sr_seed)
    return new_w.to(w.dtype), m2.to(m.dtype), v2.to(v.dtype)


def takes_vector_kernel(numel: int, aligned: bool) -> bool:
    """Whether a leaf of ``numel`` elements goes through the vector kernel:
    w, m, v and g 16-byte aligned and at least one whole vector (the last
    ``numel % 8`` elements are done one by one in the same launch)."""
    return aligned and numel >= VEC


def fused_adam_cuda(w, m, v, g, t: int, lr: float, b1: float = 0.9,
                    b2: float = 0.99, eps: float = 1e-8,
                    weight_decay: float = 1e-8, l2: float = 0.0,
                    sr_seed=None) -> None:
    """Launch ``ops/cuda/fused_adam.cu`` on the current stream: w, m, v
    updated in place; a bf16 leaf rounds keyed by ``sr_seed`` (None:
    ``t``). Raises on anything the kernel does not take and on
    a failed build or launch."""
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
    if w.numel() >= 2**32:
        raise ValueError("the leaf has >= 2^32 elements; the element index "
                         "is uint32")
    if not all(x.is_contiguous() for x in (w, m, v, g)):
        raise ValueError("w, m, v and g must be contiguous")
    from aread_tpu_torch.ops.cuda import build

    build.load("fused_adam")
    s = adam_scalars(t, lr, b1, b2, eps, weight_decay, l2)
    vec = takes_vector_kernel(w.numel(), is_aligned16(w, m, v, g))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        torch.ops.aread_tpu_torch.fused_adam_(
            w, m, v, g, s["lr"], s["b1"], s["b2"], s["eps"], s["decay"],
            s["b1c"], s["b2c"], s["omb1"], s["omb2"],
            int(t if sr_seed is None else sr_seed), vec, stream)
    launch_counts["fused_adam"] += 1


def fused_adam_dispatch(w, m, v, g, t: int, lr: float, b1: float = 0.9,
                        b2: float = 0.99, eps: float = 1e-8,
                        weight_decay: float = 1e-8, l2: float = 0.0,
                        sr_seed=None) -> None:
    """One torch-semantics Adam step on a leaf from its dense gradient, in
    place. CUDA tensors go through the kernel, CPU tensors through the
    plain version. ``sr_seed`` keys a bf16 leaf's rounding (None: ``t``)."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, l2=l2,
              sr_seed=sr_seed)
    if w.device.type == "cuda":
        fused_adam_cuda(w, m, v, g, t, **kw)
        return
    nw, nm, nv = fused_adam_reference(w, m, v, g, t, **kw)
    w.copy_(nw)
    m.copy_(nm)
    v.copy_(nv)
