"""What a scattered row copy costs on the card, and what lazy Adam costs
(counterpart of the TPU probe ``benchmarks/prof_dma_issue.py``).

A touched-rows ("lazy") Adam step reads and writes w, m and v of each
table row a batch touches: about 6 scattered copies a row. This probe
copies ``n`` = 16,384 scattered ``[rows, 128]`` f32 blocks (rows 1 and 8:
512 B and 4 KB) of a ``[380,000, 128]`` table into shared memory
(``ops/gather_rows.py``, kernel ``ops/cuda/gather_rows.cu``) in both of the
kernel's forms, in turns (ring, serial, serial, ring): the ring, CTAs on
every SM each keeping a ring of bulk copies in flight (the card's answer),
and the serial form, one thread and two stages (the TPU script's
question: what one issuer costs). For each it reports ns per copy by the
back-to-back clock the TPU script times with (on the card the blocks of
rows 1 then stay in L2; a ring launch takes less device time than its
call takes on the host, so this clock reads the host), with the host
ahead (``device_ms``: the device's own time a call), and cold (L2 flushed
before each launch), the byte bound and the cold clock's share of it,
beside ``table[ids, 0].sum()`` by the same clocks (it reads 4 B a copy,
not the block: a lower bar than the kernel's function). Then the TPU
script's projection of a lazy step (6 x ns x 17,408 rows, 6 x ns_8 x
14,600 blocks) from each form. On the card the projection is not the
answer: the probe also times
``lazy_sparse_adam_`` itself, on bf16 table and moments ``[1,518,384, 32]``
and one Amazon batch's ``dedup_rows``, by both clocks, beside kernel 1
(``sparse_adam_cuda``, the full sweep) on the same inputs.

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
                                        amazon_table_rows, clocks,
                                        cold_ms, device_ms, device_tag,
                                        emit,
                                        peak_hbm_bytes_per_s)
from aread_tpu_torch.ops.gather_rows import (FORMS, LANES, PLAIN,
                                             gather_rows_sum, ring_plan)

N_FLAT = 380_000  # the TPU script's [n_flat, 128] f32 table (194.6 MB)
N_COPIES = 16_384
ROWS = (1, 8)
# the TPU script's lazy-step projection: 6 copies (w, m, v read and
# written) per touched row, or per touched 8-row block
LAZY_ROWS, LAZY_BLOCKS = 17_408, 14_600
# the plain versions on the CPU: a 1,000-row table, a thousandth of the
# Amazon vocabularies
CPU_SIZES = dict(n_flat=1_000, n=200, bs=64,
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


def _gather_times(table, ids, rows: int, dev, reps: int) -> Dict[str, float]:
    """Both forms' clocks (ms, call ms, cold ms, device ms) in turns, ring,
    serial, serial, ring, each form's mean; their plain versions' and the
    library call's clocks."""
    card = dev.type == "cuda"
    readings: Dict[str, list] = {form: [] for form in FORMS}
    for form in FORMS + FORMS[::-1]:
        if card:
            def fn(form=form):
                return gather_rows_sum(table, ids, rows, form)
        else:
            def fn(form=form):
                return PLAIN[form](table, ids, rows)
        readings[form].append((*clocks(fn, dev, reps), cold_ms(fn, dev, reps),
                               device_ms(fn, dev, reps)))
    out: Dict[str, float] = {}
    for form in FORMS:
        pre = "" if form == "ring" else f"{form}_"
        ms, call, cold, device = (None if None in col
                                  else float(np.mean(col))
                                  for col in zip(*readings[form]))
        out.update({f"{pre}ms": ms, f"{pre}call_ms": call,
                    f"{pre}cold_ms": cold, f"{pre}device_ms": device,
                    f"{pre}plain_ms": clocks(
                        lambda: PLAIN[form](table, ids, rows), dev, 2)[0]})

    def library():
        return table[ids, 0].sum()

    out["library_ms"], out["library_call_ms"] = clocks(library, dev, reps)
    out["library_cold_ms"] = cold_ms(library, dev, reps)
    out["library_device_ms"] = device_ms(library, dev, reps)
    return out


def run(device="cuda", n_flat: int = N_FLAT, n: int = N_COPIES,
        bs: int = 1024, dims=AMAZON_DIMS, reps: int = 20,
        lazy_reps: int = 20) -> Dict[str, object]:
    """Every measurement of the probe; prints its lines and returns them.
    On a card the kernels (both forms of ``gather_rows_sum``,
    ``sparse_adam_cuda``) run; on the CPU their plain versions."""
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
        t = _gather_times(table, data[rows], rows, dev, reps)
        # each id's whole block read once, and the ids
        nbytes = n * rows * LANES * 4 + n * 4 + 4
        bound = nbytes / peak * 1e3 if peak else None
        ctas, stages, smem = ring_plan(n, rows)
        per_copy = {f"{pre}{k}ns_per_copy": t[f"{pre}{k}ms"] * 1e6 / n
                    for pre in ("", "serial_")
                    for k in ("", "cold_", "device_")
                    if t[f"{pre}{k}ms"] is not None}
        # the L2-hot clock may pass the HBM bound at rows 1; the cold one
        # is the kernel's share of it
        shares = {f"{pre}bound_share_cold": bound / t[f"{pre}cold_ms"]
                  for pre in ("", "serial_")
                  if bound and t[f"{pre}cold_ms"]}
        out["gather"][rows] = emit(
            "gather", tag, rows=rows, bytes_per_copy=rows * LANES * 4, n=n,
            route="kernel" if card else "plain", form="ring",
            ring_ctas=ctas, ring_stages=stages, ring_smem_bytes=smem, **t,
            **per_copy, bound_ms=bound, **shares,
            library="table[ids, 0].sum() (reads 4 B a copy)")
    g1, g8 = out["gather"][1], out["gather"][8]

    def projection(pre: str, clock: str) -> Dict[str, float]:
        ns1, ns8 = (g.get(f"{pre}{clock}ns_per_copy") for g in (g1, g8))
        return {f"{pre}{clock}row_granular_ms":
                6 * ns1 * LAZY_ROWS / 1e6 if ns1 else None,
                f"{pre}{clock}block8_granular_ms":
                6 * ns8 * LAZY_BLOCKS / 1e6 if ns8 else None}

    out["projection"] = emit(
        "lazy_projection", tag,
        **{k: v for pre in ("", "serial_")
           for clock in ("", "cold_", "device_")
           for k, v in projection(pre, clock).items()},
        formula="6 x ns_per_copy x 17,408 rows; 6 x ns_per_copy(8) x "
                "14,600 blocks (benchmarks/prof_dma_issue.py:112-113); "
                "unprefixed: the ring (the card's answer), serial_: one "
                "issuer (the TPU script's question); by the back-to-back, "
                "cold_ and device_ (the host ahead) clocks")
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
