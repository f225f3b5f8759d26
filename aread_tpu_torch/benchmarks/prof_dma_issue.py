"""What a scattered row copy costs on the card, and what lazy Adam costs
(counterpart of the TPU probe ``benchmarks/prof_dma_issue.py``).

A touched-rows ("lazy") Adam step reads and writes w, m and v of each
table row a batch touches: about 6 scattered copies a row. This probe
copies ``n`` = 16,384 scattered ``[rows, 128]`` f32 blocks (rows 1 and 8:
512 B and 4 KB) of a ``[380,000, 128]`` table one after another through two
shared-memory stages (``ops/gather_rows.py``, kernel
``ops/cuda/gather_rows.cu``) and reports ns per copy, then the TPU script's
projection of a lazy step (6 x ns x 17,408 rows, 6 x ns_8 x 14,600
blocks), by the back-to-back clock as the TPU script times it (on the card
the blocks of rows 1 then stay in L2) and cold (L2 flushed before each
launch). On the card the projection is not the answer: the probe also
times ``lazy_sparse_adam_`` itself, on bf16 table and moments
``[1,518,384, 32]`` and one Amazon batch's ``dedup_rows``, by both
clocks, beside kernel 1 (``sparse_adam_cuda``, the full sweep) on the same
inputs.

    python -m aread_tpu_torch.benchmarks.prof_dma_issue [--device cpu]

On the CPU the plain versions run at a toy size (lines tagged
``cpu-plain``).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from aread_tpu_torch.benchmarks import (AMAZON_DIMS, EMBED_DIM, SPARSE_KW,
                                        amazon_table_rows, clocks, cold_ms,
                                        device_tag, emit,
                                        peak_hbm_bytes_per_s)
from aread_tpu_torch.ops.gather_rows import (LANES, gather_rows_reference,
                                             gather_rows_sum)

N_FLAT = 380_000  # the TPU script's [n_flat, 128] f32 table (194.6 MB)
N_COPIES = 16_384
ROWS = (1, 8)
# the TPU script's lazy-step projection: 6 copies (w, m, v read and
# written) per touched row, or per touched 8-row block
LAZY_ROWS, LAZY_BLOCKS = 17_408, 14_600
# the plain versions on the CPU: a 1,000-row table, a thousandth of the
# Amazon vocabularies
CPU_SIZES = dict(n_flat=1_000, n=64, bs=64,
                 dims=tuple(max(d // 1000, 7) for d in AMAZON_DIMS),
                 reps=2, lazy_reps=2)


def make_inputs(n_flat: int, n: int, device) -> Dict[object, torch.Tensor]:
    """The TPU script's draws from ``np.random.default_rng(0)``: the table,
    then the ids of rows 1, then of rows 8. Returns {"table": table,
    rows: ids}."""
    rng = np.random.default_rng(0)
    out = {"table": torch.tensor(rng.normal(size=(n_flat, LANES)),
                                 dtype=torch.float32, device=device)}
    for rows in ROWS:
        out[rows] = torch.tensor(rng.integers(0, n_flat - rows, size=n),
                                 dtype=torch.int32, device=device)
    return out


def lazy_inputs(bs: int, device, dims=AMAZON_DIMS):
    """bf16 w, m, v of the fused table of ``dims`` (Amazon's:
    ``[1,518,384, 32]``, padded as the trainer pads it) and one batch's
    deduplicated rows and gradients."""
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.ops.sparse_adam import dedup_rows

    n_rows = FeatureSpec(dims, 2, 0, 2, 5).with_flat_table(EMBED_DIM).n_rows
    gen = torch.Generator(device=device).manual_seed(0)

    def table(scale, fn):
        return (scale * fn((n_rows, EMBED_DIM), generator=gen,
                           device=device)).to(torch.bfloat16)

    w, m, v = table(1.0, torch.randn), table(0.1, torch.randn), \
        table(0.01, torch.rand)
    ids = torch.as_tensor(
        amazon_table_rows(np.random.default_rng(1), dims, bs).reshape(-1),
        dtype=torch.int32, device=device)
    grads = torch.randn((ids.numel(), EMBED_DIM), generator=gen,
                        device=device)
    uids, gsum = dedup_rows(ids, grads, n_rows)
    return w, m, v, uids, gsum


def run(device="cuda", n_flat: int = N_FLAT, n: int = N_COPIES,
        bs: int = 1024, dims=AMAZON_DIMS, reps: int = 5,
        lazy_reps: int = 20) -> Dict[str, object]:
    """Every measurement of the probe; prints its lines and returns them.
    On a card the kernels (``gather_rows_sum``, ``sparse_adam_cuda``) run;
    on the CPU their plain versions."""
    from aread_tpu_torch.device import resolve_device
    from aread_tpu_torch.ops.sparse_adam import (lazy_sparse_adam_,
                                                 sparse_adam_cuda,
                                                 sparse_adam_dispatch)

    dev = resolve_device(device)
    tag = device_tag(dev)
    card = dev.type == "cuda"
    peak = peak_hbm_bytes_per_s(dev)
    data = make_inputs(n_flat, n, dev)
    table = data["table"]
    out: Dict[str, object] = {"tag": tag, "gather": {}}
    for rows in ROWS:
        ids = data[rows]
        kernel = gather_rows_sum if card else gather_rows_reference
        ms, call_ms = clocks(lambda: kernel(table, ids, rows), dev, reps)
        # the blocks of rows 1 (8 MB) stay in the 50 MB L2 from one launch
        # to the next; a lazy step's rows come from device memory
        cold = cold_ms(lambda: kernel(table, ids, rows), dev, reps)
        plain_ms, _ = clocks(lambda: gather_rows_reference(table, ids, rows),
                             dev, reps)
        library_ms, _ = clocks(lambda: table[ids, 0].sum(), dev, reps)
        nbytes = n * rows * LANES * 4 + n * 4 + 4
        out["gather"][rows] = emit(
            "gather", tag, rows=rows, bytes_per_copy=rows * LANES * 4, n=n,
            route="kernel" if card else "plain", ms=ms, call_ms=call_ms,
            ns_per_copy=ms * 1e6 / n, cold_ms=cold,
            cold_ns_per_copy=cold * 1e6 / n if cold else None,
            plain_ms=plain_ms,
            library_ms=library_ms,
            bound_ms=nbytes / peak * 1e3 if peak else None)
    g1, g8 = out["gather"][1], out["gather"][8]
    out["projection"] = emit(
        "lazy_projection", tag,
        row_granular_ms=6 * g1["ns_per_copy"] * LAZY_ROWS / 1e6,
        block8_granular_ms=6 * g8["ns_per_copy"] * LAZY_BLOCKS / 1e6,
        cold_row_granular_ms=(6 * g1["cold_ns_per_copy"] * LAZY_ROWS / 1e6
                              if card else None),
        cold_block8_granular_ms=(6 * g8["cold_ns_per_copy"] * LAZY_BLOCKS
                                 / 1e6 if card else None),
        formula="6 x ns_per_copy x 17,408 rows; 6 x ns_per_copy(8) x "
                "14,600 blocks (benchmarks/prof_dma_issue.py:112-113)")
    del data, table
    w, m, v, uids, gsum = lazy_inputs(bs, dev, dims)
    n_unique = int((uids < w.shape[0]).sum())
    lazy_ms, lazy_call_ms = clocks(
        lambda: lazy_sparse_adam_(w, m, v, uids, gsum, 1, **SPARSE_KW), dev,
        lazy_reps)
    full = sparse_adam_cuda if card else sparse_adam_dispatch
    full_ms, full_call_ms = clocks(
        lambda: full(w, m, v, uids, gsum, 1, **SPARSE_KW), dev, lazy_reps)
    out["lazy"] = emit(
        "lazy_step", tag, table=list(w.shape), dtype="bfloat16",
        touched_rows=n_unique, lazy_ms=lazy_ms, lazy_call_ms=lazy_call_ms,
        kernel1_ms=full_ms, kernel1_call_ms=full_call_ms,
        kernel1=("sparse_adam_cuda" if card
                 else "sparse_adam_dispatch (plain version)"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu: the plain versions at "
                         "a toy size")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        run("cpu", **CPU_SIZES)
    else:
        run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
