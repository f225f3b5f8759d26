"""Stochastic rounding to bfloat16 with a counter-based hash (counterpart of
``aread_tpu/ops/rounding.py``).

The bf16-stored embedding table keeps all optimizer arithmetic in f32 and
rounds the write stochastically: per-step Adam deltas (~lr) sit below the
bf16 quantum of N(0, 1) weights, so round-to-nearest would freeze most
updates, while E[sr(x)] = x keeps them. The random bits are the murmur3
32-bit finalizer over (storage element index, seed = Adam step), so the
CUDA kernel, this plain version and the JAX package make the same rounding
decision for the same element: bitwise-equal results across all three.

``torch.uint32`` lacks CPU kernels for ``*`` and ``>>`` in many builds, so
the uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every step
(an int64 product that wraps keeps its low 32 bits exact). Hash values are
returned as int64 tensors holding uint32 values.

Layout: the port stores the table row-major ``[n_rows, D]``. When
``128 % D == 0`` the JAX package's lane-packed flat order
``(r // rpf) * 128 + (r % rpf) * D + c`` equals ``r * D + c``, so the
storage element index of (r, c) is simply ``r * D + c`` here too.
"""

from __future__ import annotations

import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_U32 = 0xFFFFFFFF


def hash_bits(idx: torch.Tensor, seed) -> torch.Tensor:
    """murmur3 fmix32 of (element index, seed). ``idx``: integer tensor of
    uint32 values; ``seed``: int, or a 0-dim integer tensor holding the
    seed's 32 bits (an int32 holds them as its two's complement), which is
    read on its device, not fetched. Returns int64 holding uint32
    values."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64) & _U32
    else:
        seed = int(seed) & _U32
    h = (idx.to(torch.int64) * _GOLD) & _U32
    h = (h + ((seed * _M1) & _U32)) & _U32
    h = h ^ (h >> 16)
    h = (h * _M1) & _U32
    h = h ^ (h >> 13)
    h = (h * _M2) & _U32
    h = h ^ (h >> 16)
    return h


def stochastic_round_bf16(x: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, rounding up with probability (low 16 bits of x) / 2^16,
    driven by the low 16 bits of ``rbits``. View the f32 bits, add the
    random bits, clear the low half; the final cast to bf16 is exact."""
    xb = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    ob = (xb + (rbits & 0xFFFF)) & 0xFFFF0000
    ob = torch.where(ob >= 2**31, ob - 2**32, ob).to(torch.int32)
    return ob.view(torch.float32).to(torch.bfloat16)


def sround(x: torch.Tensor, dtype: torch.dtype, idx: torch.Tensor,
           seed) -> torch.Tensor:
    """Round f32 ``x`` to ``dtype``: a plain cast unless ``dtype`` is bf16,
    then stochastic, keyed by element index ``idx`` and ``seed``."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    return stochastic_round_bf16(x, hash_bits(idx, seed))


def flat_index_grid(n_rows: int, d: int, device=None) -> torch.Tensor:
    """[n_rows, d] int64 storage element indices ``r * d + c``, equal to
    the JAX package's lane-packed flat order where 128 % d == 0 (see the
    module docstring) and to its row-major order otherwise."""
    r = torch.arange(n_rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    return r * d + c
