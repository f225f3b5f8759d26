"""Scattered row copies, summed in order (counterpart of the TPU probe
``benchmarks/prof_dma_issue.py::gather_rows_kernel``).

``n`` blocks ``table[ids[i] : ids[i] + rows, :]`` of a ``[n_table, 128]``
f32 table are copied one after another, and element [0, 0] of each is
added, in the order of ``i``, one f32 add at a time. What the probe
measures is the time per copy: the price of a touched-rows Adam that
fetches each touched row with such a copy.

* ``gather_rows_reference`` is the plain version: the gathered column
  summed in order in f32 on the host (``np.add.accumulate`` adds one
  element at a time in the array's dtype; neither ``Tensor.sum`` nor
  ``torch.cumsum`` does: the one sums pairwise, the other carries a double
  on the CPU and scans in parallel on the card).
* ``gather_rows_sum`` launches the hand-written kernel
  ``ops/cuda/gather_rows.cu`` (``torch.ops.aread_tpu_torch.gather_rows_``):
  one thread, two shared-memory stages, each copy a TMA bulk copy. It
  takes CUDA tensors only and raises on anything the kernel does not take.
"""

from __future__ import annotations

import numpy as np
import torch

from aread_tpu_torch.ops.cuda import launch_counts

LANES = 128  # f32 per table row, the TPU's lane width
MAX_ROWS = 32  # two stages of 32 x 512 B fit the default shared memory


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                          rows: int) -> torch.Tensor:
    """sum_i table[ids[i], 0], added in order in f32, as a 0-dim f32
    tensor on the table's device. ``rows`` does not change the sum: the
    kernel copies whole ``rows``-row blocks but reads their first element."""
    col = table[ids.to(torch.int64), 0].cpu().numpy().astype(np.float32)
    acc = np.add.accumulate(col, dtype=np.float32)[-1] if col.size else \
        np.float32(0)
    return torch.tensor(acc, dtype=torch.float32, device=table.device)


def gather_rows_sum(table: torch.Tensor, ids: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Launch ``ops/cuda/gather_rows.cu`` on the current stream: the f32 sum
    of ``table[ids[i], 0]`` in order, each block ``[rows, 128]`` copied
    whole into shared memory first. Returns a 0-dim f32 CUDA tensor.
    Raises, before any build, on anything the kernel does not take: a
    dtype, a width, a tensor off the card; then checks
    ``0 <= ids < n_table - rows + 1`` on the device (one wait for it)."""
    if table.dtype != torch.float32:
        raise TypeError(f"table dtype {table.dtype}: float32 only")
    if table.dim() != 2 or table.shape[1] != LANES:
        raise ValueError(f"table width {tuple(table.shape)}: [n, {LANES}] "
                         "only")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids {ids.dtype} {tuple(ids.shape)}: 1-D int32 only")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows={rows}: 1 to {MAX_ROWS}")
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError("gather_rows_sum needs CUDA tensors on one device, "
                         f"got table on {table.device}, ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary")
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi > table.shape[0] - rows:
            raise ValueError(f"ids span [{lo}, {hi}]; blocks of {rows} rows "
                             f"need 0 <= id < {table.shape[0] - rows + 1}")
    from aread_tpu_torch.ops.cuda import build

    build.load("gather_rows")
    out = torch.empty((1,), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        torch.ops.aread_tpu_torch.gather_rows_(table, ids, out, rows, stream)
    launch_counts["gather_rows"] += 1
    return out[0]
