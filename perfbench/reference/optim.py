"""Adam as the configuration states it, in plain PyTorch:

* the dense leaves: torch.optim.Adam(lr, betas=(0.9, 0.99), eps=1e-8,
  weight_decay) semantics, the decay added to the gradient, moments in
  float32, the bias corrections 1 - b**t in float32;
* the embedding table: the same Adam over the whole table every step (the
  reference's dense semantics: weight decay and the table's L2 gradient
  2 * l2 * w reach every row, so every row's moments decay), the table and
  its moments stored in the configuration's dtypes: a bfloat16 table is
  written by stochastic rounding (``sround_bf16``, keyed by the element
  index row * D + col and the step), bfloat16 moments by rounding to
  nearest.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

F32 = torch.float32
_M1, _M2, _GOLD, _U32 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF


def hash32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3's 32-bit finalizer over idx * golden + seed * M1 (uint32
    arithmetic held in int64)."""
    h = (idx.to(torch.int64) * _GOLD) & _U32
    h = (h + ((int(seed) & _U32) * _M1 & _U32)) & _U32
    h ^= h >> 16
    h = (h * _M1) & _U32
    h ^= h >> 13
    h = (h * _M2) & _U32
    return h ^ (h >> 16)


def sround_bf16(x: torch.Tensor, idx: torch.Tensor, seed: int) -> torch.Tensor:
    """float32 -> bfloat16 rounding up with probability (low 16 bits of x)
    / 2**16: add the hash's low 16 bits to the float's bits and cut."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    b = (b + (hash32(idx, seed) & 0xFFFF)) & 0xFFFF0000
    b = torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)
    return b.view(F32).to(torch.bfloat16)


def f32(x: float) -> float:
    return float(np.float32(x))


def bias_corrections(t: int, b1: float, b2: float):
    return (float(np.float32(1) - np.float32(b1) ** np.float32(t)),
            float(np.float32(1) - np.float32(b2) ** np.float32(t)))


@torch.no_grad()
def adam_dense_(p, g, m, v, t: int, lr: float, wd: float, b1=0.9, b2=0.99,
                eps=1e-8) -> None:
    """One Adam step of a float32 leaf, in place."""
    c1, c2 = bias_corrections(t, b1, b2)
    g = g + wd * p
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


@torch.no_grad()
def adam_table(w, m, v, g, t: int, lr: float, wd: float, l2: float,
               b1=0.9, b2=0.99, eps=1e-8, row_block: int = 1 << 18):
    """One dense-semantics Adam step of the table from its data gradient
    ``g`` [n_rows, D] f32; returns the new (w, m, v) in w's and m's dtypes,
    in blocks of rows so that the float32 temporaries stay small."""
    c1, c2 = bias_corrections(t, b1, b2)
    decay = f32(wd + 2.0 * l2)
    n, d = w.shape
    nw, nm, nv = torch.empty_like(w), torch.empty_like(m), torch.empty_like(v)
    for lo in range(0, n, row_block):
        hi = min(n, lo + row_block)
        wf = w[lo:hi].to(F32)
        gg = g[lo:hi] + decay * wf
        m2 = b1 * m[lo:hi].to(F32) + f32(1 - b1) * gg
        v2 = b2 * v[lo:hi].to(F32) + f32(1 - b2) * gg * gg
        w2 = wf - lr * (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if w.dtype == torch.bfloat16:
            idx = (torch.arange(lo, hi, device=w.device)[:, None] * d
                   + torch.arange(d, device=w.device)[None, :])
            nw[lo:hi] = sround_bf16(w2, idx, t)
        else:
            nw[lo:hi] = w2.to(w.dtype)
        nm[lo:hi] = m2.to(m.dtype)
        nv[lo:hi] = v2.to(v.dtype)
    return nw, nm, nv


def table_sq(w) -> torch.Tensor:
    """sum(w**2) of the stored table in float64, as a float32 0-dim."""
    return torch.sum(torch.square(w.to(F32)), dtype=torch.float64).to(F32)


def fresh_state(P: Dict[str, torch.Tensor], moments_dtype) -> Dict:
    st = {}
    for k, p in P.items():
        dt = moments_dtype if k == "embedding.table" else F32
        st[k] = (torch.zeros(p.shape, dtype=dt, device=p.device),
                 torch.zeros(p.shape, dtype=dt, device=p.device))
    return st
