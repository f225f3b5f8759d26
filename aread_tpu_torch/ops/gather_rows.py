"""Scattered row copies, summed (counterpart of the TPU probe
``benchmarks/prof_dma_issue.py::gather_rows_kernel``).

``n`` blocks ``table[ids[i] : ids[i] + rows, :]`` of a ``[n_table, 128]``
f32 table are each copied whole into shared memory, and element [0, 0] of
each is added in f32. What the probe measures is the time per copy: the
price of a touched-rows Adam that fetches each touched row with such a
copy. The kernel ``ops/cuda/gather_rows.cu`` has two forms, each with its
own order of the adds and its own plain version:

* ``"ring"`` (the default; ``torch.ops.aread_tpu_torch.gather_rows_ring_``):
  a CTA per ``CHUNK`` consecutive ids on every SM, each warp of it a ring
  of ``ring_plan``'s stages keeping that many TMA bulk copies of its 32 ids
  in flight. Each chunk is added
  in order into its partial, the partials in chunk order
  (``gather_rows_chunked_reference``). For ``n <= CHUNK`` that is the
  in-order sum, bitwise.
* ``"serial"`` (``torch.ops.aread_tpu_torch.gather_rows_``): the TPU's
  form, one thread, two shared-memory stages, the ids in order, one f32
  add at a time (``gather_rows_reference``).

The plain versions add on the host with ``np.add.accumulate``, which adds
one element at a time in the array's dtype; neither ``Tensor.sum`` nor
``torch.cumsum`` does (the one sums pairwise, the other carries a double on
the CPU and scans in parallel on the card). ``gather_rows_sum`` takes CUDA
tensors only and raises on anything the kernel does not take.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from aread_tpu_torch.ops.cuda import count_launch, launch_counts  # noqa: F401

LANES = 128  # f32 per table row, the TPU's lane width
MAX_ROWS = 32  # two stages of 32 x 512 B fit the default shared memory
FORMS = ("ring", "serial")
# gather_rows.cu's constants: ids a CTA of the ring sums in order (a ring
# of 32 a warp), and the shared memory of its rings' stages
CHUNK = 64
RINGS = CHUNK // 32
RING_BYTES = 64 * 1024


def ring_plan(n: int, rows: int) -> Tuple[int, int, int]:
    """(CTAs, stages a ring, dynamic shared-memory bytes) of the ring form
    for ``n`` ids of ``rows``-row blocks: a CTA per chunk of ``CHUNK`` ids
    (one when ``n`` is 0), and for each of its ``RINGS`` rings as many
    ``[rows, 128]`` f32 stages as its share of ``RING_BYTES`` holds, at
    most 32 (a ring never has more ids in flight)."""
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows={rows}: 1 to {MAX_ROWS}")
    block = rows * LANES * 4
    stages = min(32, RING_BYTES // (RINGS * block))
    return max(1, -(-n // CHUNK)), stages, RINGS * stages * block


def _in_order(x: np.ndarray) -> np.ndarray:
    """f32 sums of ``x`` along its last axis, added one element at a time
    from +0.0 in index order."""
    zero = np.zeros(x.shape[:-1] + (1,), np.float32)
    x = np.concatenate([zero, x.astype(np.float32)], axis=-1)
    return np.add.accumulate(x, axis=-1, dtype=np.float32)[..., -1]


def _column(table: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    return table[ids.to(torch.int64), 0].cpu().numpy().astype(np.float32)


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                          rows: int) -> torch.Tensor:
    """The serial form's plain version: sum_i table[ids[i], 0], added in
    order in f32, as a 0-dim f32 tensor on the table's device. ``rows``
    does not change the sum: the kernel copies whole ``rows``-row blocks
    but reads their first element."""
    acc = _in_order(_column(table, ids))
    return torch.tensor(acc, dtype=torch.float32, device=table.device)


def gather_rows_chunked_reference(table: torch.Tensor, ids: torch.Tensor,
                                  rows: int) -> torch.Tensor:
    """The ring's plain version: each chunk of ``CHUNK`` consecutive ids
    summed in order in f32, then the partials in chunk order in f32."""
    col = _column(table, ids)
    chunks = ring_plan(col.size, rows)[0]
    padded = np.zeros(chunks * CHUNK, np.float32)
    padded[:col.size] = col  # + 0.0 leaves a partial's bits as they are
    acc = _in_order(_in_order(padded.reshape(chunks, CHUNK)))
    return torch.tensor(acc, dtype=torch.float32, device=table.device)


PLAIN = {"ring": gather_rows_chunked_reference,
         "serial": gather_rows_reference}


def gather_rows_sum(table: torch.Tensor, ids: torch.Tensor, rows: int,
                    form: str = "ring") -> torch.Tensor:
    """Launch ``form`` of ``ops/cuda/gather_rows.cu`` on the current
    stream: the f32 sum of ``table[ids[i], 0]`` in the form's order, each
    block ``[rows, 128]`` copied whole into shared memory first. Returns a
    0-dim f32 CUDA tensor. Raises, before any build, on anything the
    kernel does not take: a form, a dtype, a width, a tensor off the card,
    a table shorter than a block. The ids' range is the kernel's check,
    made without a wait on the host: an id outside
    ``[0, n_table - rows]`` traps before any copy reads with it, so the
    launch fails (a CUDA error at the next synchronisation, the context
    lost). The ring's scratch (its partials and its ticket) is the call's
    own, so calls on different streams may overlap."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: one of {FORMS}")
    if table.dtype != torch.float32:
        raise TypeError(f"table dtype {table.dtype}: float32 only")
    if table.dim() != 2 or table.shape[1] != LANES:
        raise ValueError(f"table width {tuple(table.shape)}: [n, {LANES}] "
                         "only")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids {ids.dtype} {tuple(ids.shape)}: 1-D int32 only")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows={rows}: 1 to {MAX_ROWS}")
    if table.shape[0] < rows:
        raise ValueError(f"table of {table.shape[0]} rows: blocks of "
                         f"rows={rows} need at least {rows}")
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError("gather_rows_sum needs CUDA tensors on one device, "
                         f"got table on {table.device}, ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary")
    from aread_tpu_torch.ops.cuda import build

    build.load("gather_rows")
    out = torch.empty((1,), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        if form == "serial":
            torch.ops.aread_tpu_torch.gather_rows_(table, ids, out, rows,
                                                   stream)
        else:
            chunks, stages, _ = ring_plan(ids.numel(), rows)
            # the chunks' partials, then the ticket (zeroed by the launcher)
            scratch = torch.empty((chunks + 1,), dtype=torch.float32,
                                  device=table.device)
            torch.ops.aread_tpu_torch.gather_rows_ring_(
                table, ids, out, scratch, rows, stages, stream)
    count_launch("gather_rows")
    return out[0]
