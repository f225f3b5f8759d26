"""``config.compute_dtype`` (counterpart of the JAX package's
``matmul_precision_ctx``, ``aread_tpu/train/trainer.py``).

Under ``jax.default_matmul_precision('bfloat16')`` XLA runs every f32
product of a traced step as one bf16 pass: both operands rounded to bf16,
the sum taken in f32, an f32 result; the gradient's products too, since
the step traces ``value_and_grad`` inside the context. Nothing of
PyTorch's own asks for that function: ``set_float32_matmul_precision``
gives TF32 on the card, ``autocast`` also rounds each product's output to
bf16, and a ``TorchFunctionMode`` does not see the products autograd runs
in the backward. So every product of the port's models goes through
``matmul`` / ``einsum`` here. Outside the context they are ``a @ b`` and
``torch.einsum``. Inside it, both operands are rounded to bf16 (round to
nearest even) and multiplied in f32 with TF32 off, in an
``autograd.Function`` whose backward rounds its operands the same way. A
product of two bf16 values is exact in f32, so this is the single bf16
pass bit for bit, up to the order of the sum, on either device.

The context is per thread (a server thread serves under its own), and it
holds TF32 off for the matmuls of the process while it is open."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

_LETTERS = "abcdefghij"
_state = threading.local()


def bf16_products() -> bool:
    """Whether this thread is inside ``matmul_precision_ctx('bfloat16')``."""
    return getattr(_state, "bf16", False)


@contextlib.contextmanager
def matmul_precision_ctx(compute_dtype: str) -> Iterator[None]:
    """'bfloat16': the products of ``matmul`` / ``einsum`` in the block
    take bf16-rounded operands and accumulate in f32. 'float32': no
    change. Restores what it changed on exit."""
    if compute_dtype == "float32":
        yield
        return
    if compute_dtype != "bfloat16":
        raise ValueError(f"compute_dtype={compute_dtype!r}")
    prev, prev_tf32 = bf16_products(), torch.backends.cuda.matmul.allow_tf32
    _state.bf16 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        _state.bf16 = prev
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _Bf16Einsum(torch.autograd.Function):
    """Two-operand einsum over bf16-rounded operands, f32 sums; each
    gradient is the einsum of the bf16-rounded cotangent and the other
    bf16-rounded operand, as XLA transposes a bf16-precision dot."""

    @staticmethod
    def forward(ctx, eq: str, a: torch.Tensor, b: torch.Tensor):
        a16, b16 = _bf16(a), _bf16(b)
        ctx.eq = eq
        ctx.save_for_backward(a16, b16)
        return torch.einsum(eq, a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        lhs, out = ctx.eq.split("->")
        sa, sb = lhs.split(",")
        g16 = _bf16(g)
        ga = (torch.einsum(f"{out},{sb}->{sa}", g16, b16)
              if ctx.needs_input_grad[1] else None)
        gb = (torch.einsum(f"{out},{sa}->{sb}", g16, a16)
              if ctx.needs_input_grad[2] else None)
        return None, ga, gb


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``, as one bf16 pass inside
    ``matmul_precision_ctx('bfloat16')``. ``eq`` is explicit
    ('ab,bc->ac'), and every index of an operand is in the output or in
    the other operand (the gradient is then again one einsum)."""
    if not bf16_products():
        return torch.einsum(eq, a, b)
    lhs, out = eq.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    if set(sa) - set(out + sb) or set(sb) - set(out + sa):
        raise ValueError(f"einsum {eq!r}: an index is summed within one "
                         "operand")
    return _Bf16Einsum.apply(f"{sa},{sb}->{out}", a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a 2-D ``b`` (``a`` of any rank >= 1), as one bf16
    pass inside ``matmul_precision_ctx('bfloat16')``."""
    if not bf16_products():
        return a @ b
    if b.dim() != 2 or a.dim() > len(_LETTERS):
        raise ValueError(f"matmul of {tuple(a.shape)} and {tuple(b.shape)}: "
                         "b must be 2-D")
    lead = _LETTERS[:a.dim() - 1]
    return einsum(f"{lead}y,yz->{lead}z", a, b)
