"""Where kernel 1's time above a bare copy goes (counterpart of the TPU
probe ``benchmarks/prof_kernel_attrib.py``).

Runs kernel 1's sweep with parts taken out (``ops/adam_attrib.py``, kernel
``ops/cuda/adam_attrib.cu``; modes ``full``, ``rtn``, ``dot1``,
``noslot``, ``noadam``, ``copy``) at the TPU script's shapes and scalars:
bf16 w, m, v ``[1,521,664, 32]``, a batch of 1,024 x 17 ids uniform over the
rows, t = 1, lr 1e-3, b1 0.9, b2 0.99, eps 1e-8, decay 1e-8 + 2e-5. Each
mode's ms per update is one CUDA event pair around 200 back-to-back
updates over 200; the modes run in turns, forward then backward, and the
two readings are averaged. Then each mode's share of the byte bound (12 B
an element plus the uids and gsum at 3.35 TB/s) and the differences that
attribute the gap: full - rtn (the random bits), full - noslot (the
gradient's gather, the slot scatter included), noadam - copy (the
metadata reads), full - noadam (the Adam math), copy against the bound
(the card's ceiling), and the same bytes moved by three ``Tensor.copy_``
calls beside it.

    python -m aread_tpu_torch.benchmarks.prof_kernel_attrib [--device cpu]

On the CPU the plain versions run at a toy size (lines tagged
``cpu-plain``).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from aread_tpu_torch.benchmarks import clocks, device_tag, emit, \
    peak_hbm_bytes_per_s
from aread_tpu_torch.ops.adam_attrib import (MODES, adam_attrib_,
                                             adam_attrib_reference)

N_ROWS, D, BS, F = 1_521_664, 32, 1024, 17
REPS = 200
# prof_kernel_attrib.py:116-124: decay = weight_decay + 2 * l2
KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5)
T = 1
CPU_SIZES = dict(n_rows=4096, bs=64, reps=2)


def make_inputs(n_rows: int, bs: int, device):
    """The TPU script's draws from ``np.random.default_rng(0)``: w normal
    (rounded to bf16), m = v = 0, ids uniform over the rows, gradients
    normal; then ``dedup_rows``."""
    from aread_tpu_torch.ops.sparse_adam import dedup_rows

    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(n_rows * D // 128, 128)),
                     dtype=torch.float32, device=device
                     ).to(torch.bfloat16).view(n_rows, D)
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    ids = torch.tensor(rng.integers(0, n_rows, size=bs * F),
                       dtype=torch.int32, device=device)
    g = torch.tensor(rng.normal(size=(bs * F, D)), dtype=torch.float32,
                     device=device)
    uids, gsum = dedup_rows(ids, g, n_rows)
    return w, m, v, uids, gsum


def bound_bytes(w, uids, gsum) -> int:
    """w, m, v read and written once in bf16, uids and gsum read once."""
    return 12 * w.numel() + uids.numel() * 4 + gsum.numel() * 4


def run(device="cuda", n_rows: int = N_ROWS, bs: int = BS,
        reps: int = REPS) -> Dict[str, object]:
    """ms per update of every mode, the shares of the bound and the gaps;
    prints the lines and returns them. On a card the kernel runs, on the
    CPU the plain versions (host clock)."""
    from aread_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    tag = device_tag(dev)
    card = dev.type == "cuda"
    peak = peak_hbm_bytes_per_s(dev)
    w0, m0, v0, uids, gsum = make_inputs(n_rows, bs, dev)
    bound_ms = bound_bytes(w0, uids, gsum) / peak * 1e3 if peak else None
    readings: Dict[str, list] = {mode: [] for mode in MODES}
    for mode in MODES + MODES[::-1]:
        w, m, v = w0.clone(), m0.clone(), v0.clone()
        update = adam_attrib_ if card else adam_attrib_reference
        readings[mode].append(clocks(lambda: update(
            mode, w, m, v, uids, gsum, T, **KW), dev, reps))
        del w, m, v
    out: Dict[str, object] = {"tag": tag, "modes": {}}
    for mode in MODES:
        ms = float(np.mean([r[0] for r in readings[mode]]))
        out["modes"][mode] = emit(
            "attrib", tag, mode=mode, route="kernel" if card else "plain",
            table=[n_rows, D], ms=ms,
            call_ms=float(np.mean([r[1] for r in readings[mode]])),
            readings=[r[0] for r in readings[mode]], bound_ms=bound_ms,
            bound_share=bound_ms / ms if bound_ms else None)
    # beside full: its plain version, and kernel 1's library yardstick,
    # torch's fused Adam over the same table in f32 with a dense gradient
    plain_ms, _ = clocks(lambda: adam_attrib_reference(
        "full", w0, m0, v0, uids, gsum, T, **KW), dev, 3)
    library_ms = None
    if card:
        p = torch.nn.Parameter(w0.float())
        p.grad = torch.zeros_like(p)
        live = uids < n_rows
        p.grad[uids[live].long()] = gsum[live]
        opt = torch.optim.Adam([p], lr=KW["lr"], betas=(KW["b1"], KW["b2"]),
                               eps=KW["eps"],
                               weight_decay=KW["weight_decay"] + 2 * KW["l2"],
                               fused=True)
        library_ms, _ = clocks(opt.step, dev, 20)
        del p, opt
    # the card's own copy of the same bytes: three device-to-device copies
    w, m, v = w0.clone(), m0.clone(), v0.clone()
    library_copy_ms, _ = clocks(
        lambda: (w.copy_(w0), m.copy_(m0), v.copy_(v0)), dev, 20)
    del w, m, v
    out["beside"] = emit(
        "attrib_beside", tag, plain_full_ms=plain_ms,
        library_ms=library_ms,
        library="torch.optim.Adam(fused=True), f32 table, dense gradient",
        library_copy_ms=library_copy_ms,
        library_copy="Tensor.copy_ of w, m and v (the same 12 B an element)")
    ms = {k: v["ms"] for k, v in out["modes"].items()}
    out["gaps"] = emit(
        "attrib_gaps", tag,
        random_bits_ms=ms["full"] - ms["rtn"],
        gradient_gather_ms=ms["full"] - ms["noslot"],
        metadata_reads_ms=ms["noadam"] - ms["copy"],
        adam_math_ms=ms["full"] - ms["noadam"],
        copy_over_bound=ms["copy"] / bound_ms if bound_ms else None,
        copy_over_library_copy=ms["copy"] / library_copy_ms,
        full_over_copy=ms["full"] / ms["copy"])
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
