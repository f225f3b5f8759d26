"""The port's probes, counterparts of the root ``benchmarks/`` folder's TPU
probes (which stay as they are):

    python -m aread_tpu_torch.benchmarks.prof_dma_issue      [--device cpu]
    python -m aread_tpu_torch.benchmarks.prof_kernel_attrib  [--device cpu]

Each runs on the card unless ``--device cpu`` is given; on the CPU it runs
the plain versions at a toy size. Every line is one JSON object tagged
with where its numbers come from: the card's ``nvidia-smi`` name and power
limit, or ``cpu-plain`` (host-clock times of the plain versions, no device
metric). This module holds what both share: the tag, the clocks and one
Amazon batch's table rows.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# Amazon layout of bench.py / the config defaults
AMAZON_DIMS = (1368287, 7, 25, 40, 11, 150000, 12)
EMBED_DIM, BS = 32, 1024
SPARSE_KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8,
                 l2=1e-5)
CPU_TAG = "cpu-plain"


def device_tag(device: torch.device) -> str:
    """``cpu-plain`` on the CPU; on a card the name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (a card set below its maximum runs slower under load)."""
    if device.type != "cuda":
        return CPU_TAG
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    if smi is None or smi.returncode != 0 or not smi.stdout.strip():
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return smi.stdout.strip().splitlines()[0]


def peak_hbm_bytes_per_s(device: torch.device) -> Optional[float]:
    """The H100 SXM's published HBM bandwidth (data sheet); None for any
    other device, whose bound this module does not know."""
    if device.type == "cuda" and \
            torch.cuda.get_device_name(device) == "NVIDIA H100 80GB HBM3":
        return 3.35e12
    return None


def clocks(fn: Callable[[], object], device: torch.device, n: int,
           warmup: int = 2) -> Tuple[float, float]:
    """(ms, call_ms) of one call of ``fn``. On a card: ``ms`` is device
    time, one CUDA event pair around ``n`` back-to-back calls over ``n``
    (the host runs ahead, so its own time is left out), and ``call_ms``
    the median of ``n`` calls each between its own events (host time
    included). On the CPU both are the host clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.mean(times), statistics.median(times)
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / n
    times = []
    for _ in range(n):
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return ms, statistics.median(times)


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2


def cold_ms(fn: Callable[[], object], device: torch.device,
            n: int) -> Optional[float]:
    """Median device time of ``n`` calls of ``fn``, each between its own
    CUDA events after ``L2_FLUSH_BYTES`` written elsewhere have pushed
    everything out of the L2 cache: what a caller whose data is in device
    memory only pays. None on the CPU."""
    if device.type != "cuda":
        return None
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    times = []
    for _ in range(n):
        flush.fill_(1.0)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# what the device sleeps before device_ms's events: ~10 ms at the H100's
# 1.98 GHz, longer than the host takes to queue the calls it times
SLEEP_CYCLES = 20_000_000


def device_ms(fn: Callable[[], object], device: torch.device,
              n: int) -> Optional[float]:
    """Device time per call of ``fn``: one CUDA event pair around ``n``
    back-to-back calls, queued while the device sleeps, so the host is
    ahead and no gap where the device waits for it is counted (the
    back-to-back clock counts such gaps when a call's host time exceeds
    its kernels'). ``fn`` must not wait for the device. None on the
    CPU."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def amazon_table_rows(rng: np.random.Generator, dims=AMAZON_DIMS,
                      bs: int = BS) -> np.ndarray:
    """[bs, 17] table rows one Amazon batch gathers, as the embedding
    computes them: per-field offsets into the fused table, the two
    history sequences of 5 on the item id rows."""
    offs = np.concatenate([[0], np.cumsum(dims)[:-1]])
    cols = [rng.integers(0, d, size=(bs, 1)) + o for d, o in zip(dims, offs)]
    seqs = rng.integers(0, dims[0], size=(bs, 10))
    return np.concatenate(cols + [seqs], axis=1)


def emit(probe: str, tag: str, **kw) -> Dict[str, object]:
    """Print one result line and return it."""
    line = {"probe": probe, "tag": tag, **kw}
    print(json.dumps(line), flush=True)
    return line
