"""On-card smoke run of the PyTorch/CUDA port (aread_tpu_torch) on one GPU.

    python3 chip_smoke.py                      # every phase, as CI runs it
    python3 chip_smoke.py --phases device,build,kernels

Phases, each printing one line:
  device   the card's name and power limit (nvidia-smi) and torch's name;
  build    every kernel of the port built from the sources in the checkout
           (nvcc for the .cu, the host compiler for its TORCH_LIBRARY
           binding), one compiler process per source, all at once;
  kernels  each kernel, in its vector and in its scalar form, against its
           plain PyTorch version on the card: bitwise at small shapes that
           take every path of the wrappers' choice (widths 8 to 264,
           element counts that are no multiple of 8, misaligned views) and
           at the main path's shapes (full 1,518,384 x 32 Amazon table);
           then its times there: ms = device time per update (one event
           pair around 20 back-to-back calls / 20), call_ms = median of
           calls timed one by one (host time included), scalar_ms the
           scalar kernel by the first clock in the same run, the plain
           version's and the library call's by both, the bound, and the
           CUDA launches of one update (torch.profiler); both kernels
           reading their step's scalars from a row of a chunk's staged
           blocks (kernel 2 in every check and timing above), kernel 2 on
           a row shard's global element indices (index_base), each
           bitwise its plain version; then kernel 1 on an aged table
           (benchmarks/prof_aged_adam.py: 5,000 updates that leave most
           rows untouched, so most weights and moments sit at the bottom
           of the f32 range): both sweeps' ms there and fresh, an update
           of it and of it mixed with the fresh table bitwise the plain
           version, the share of warp steps that took a small-operand
           form of the division or sqrt, and rounding.cuh's division and
           sqrt bitwise __fdiv_rn / __fsqrt_rn over every f32 below
           2^-100 (line kernels_aged);
  train    the AREAD path at full Amazon width through AREADTrainer's chunk
           dispatch (train/step_graph.py): two trainers from one seed, one
           replaying CUDA graphs and one launching each step, in turns on
           TRAIN_CHUNKS (8 warm-up steps, 104 bagging steps in chunks of
           32, 32, 32 and 8) under per-domain 'rand' masks, bitwise equal
           after every chunk (weights, BatchNorm statistics, all Adam
           state, losses, gate means, the dropout generator); per dispatch
           the step time by CUDA events over a chunk and by the host
           clock, examples/s, launches and kernels per step and the
           device's idle share (torch.profiler over one chunk), peak
           memory; the captured step once under sync debug mode 'error';
           then its lazy part, table_optimizer='lazy_adam' (the touched
           rows' update, no kernel of ours): AREAD trainers on LAZY_CHUNKS,
           a regroup of LAZY_CHAINS chains of 5 + 5, and DeepFM through
           Trainer.fit and on LAZY_DENSE_CHUNKS, each by graph and by its
           eager twin in turns, bitwise, with the same per-dispatch
           numbers, a step and a chain under sync debug mode 'error'; and
           lazy_sparse_adam_ alone, by its call and by a replay, bitwise;
  eval     evaluation by CUDA graph replays (one a batch) and by its eager
           twin, in turns, bitwise (results, predictions or histograms,
           weights): the train phase's AREAD trainer over EVAL_BATCHES
           per-domain batches of 1,024 rows in 'domain_with_mask' and
           'domain_mask_final', exact and streaming, then DeepFM's
           Trainer.evaluate at 8,192-row batches; per dispatch ms a batch
           (CUDA events, host clock), the pass's seconds, launch calls,
           kernels, busy ms and idle share (torch.profiler over 32
           batches); a captured batch under sync debug mode 'error';
  train_dense  the generic Trainer at full Amazon width with the dense
           table gradient: build_model + Trainer.fit for DeepFM (one epoch
           of graph replays, valid and test passes), then a few steps each
           of DCN and MMoE, and of DeepFM with the sparse table gradient;
           then its chunk dispatch (train/step_graph.py): two DeepFM
           trainers from one seed, graph and eager, in turns on
           DENSE_CHUNKS (32, 32, 8) for each table gradient (kernel 2,
           kernel 1) and each feed (host batches, row ids into the
           resident split), bitwise after every chunk, per dispatch the
           step time, launch calls, kernels, busy ms, idle share and peak
           memory, the counted launches against the profiler's kernel
           records, the captured step under sync debug mode 'error'; and
           dense from host batches under compute_dtype='bfloat16';
  zoo      the zoo's first half at full Amazon width: build_model +
           Trainer.fit by graph replays and by its eager twin from one
           seed (40 dense-gradient steps: a full chunk and a remainder;
           valid and test passes), bitwise after the fit, for dcnv2,
           autoint, ple, pepnet, epnet, epnet-single and star; then the
           twins in turns on ZOO_CHUNKS of host batches: step ms by both
           dispatches with launches, kernels, busy time, idle share and
           peak memory; an MMoE dynamic_regroup fit of 2 epochs, graph
           bitwise eager (a moved map captured again);
           one step of each on the card against the CPU at a small width;
           then AREAD on a PLE base (bf16 table and moments): 8 warm-up +
           16 bagging steps, 3 steps card vs CPU, one epoch of
           AREADTrainer.fit at RESUME_DEPTH, the model saved, rebuilt by
           load_predictor and served against the trainer's evaluation;
  zoo2     the zoo's second half at full Amazon width: hinet, adasparse
           and adl fitted, held graph against eager and timed as in zoo; ADL's DLM centres
           unit vectors after fit, left bitwise alone by an evaluation and
           moved by one with eval_dlm_update, by graph bitwise as by the
           eager twin; one step of each card vs CPU
           at a small width, and ADL's centres after such an evaluation;
           MAMDR at the CLI defaults (sparse table gradient, bf16 table and
           moments) through MamdrTrainer.fit for one epoch by graph
           replays and by its eager twin, bitwise (meta and every domain's
           weights, history), one step capture for the fit, each fit's
           sparse_adam launches held to the Reptile schedule's, then its
           steps by both dispatches in turns on MAMDR_CHUNKS, a Reptile
           update, a merge and a weight swap timed, and one small epoch
           card (graph replays) vs CPU;
           the four models saved, rebuilt by load_predictor and served
           against their trainers' evaluation; each FM op this slice
           added to ops/fm.py card vs CPU at the Amazon field count;
  hemp     the HEMP loop at full Amazon width: build_model +
           AREADTrainer.fit — warm-up, bagging steps, a mask evolution at
           every regroup point (fresh fast-Adam chains from a snapshot,
           a prune on the card after each step, probes; one CUDA graph
           replay a chain), the valid pass, the final-gate phase, the test
           pass; depth cut to HEMP_DEPTH. Then the evolution's parts timed
           one by one (adapt step, probe, snapshot restore, the prune by
           both routes); a regroup at the default depth (225 chains of
           5 + 5) by graph and by an eager twin, bitwise, its seconds by
           each; ms, launches, kernels and idle share of a chain by each
           dispatch; a chain under sync debug mode 'error';
  serve    the path from a trained model to an answered request, at full
           Amazon width: the hemp phase's AREAD (evolved masks), the
           train_dense phase's DeepFM and MMoE each saved with
           save_checkpoint and rebuilt by load_predictor from the
           directory alone; served probabilities against the trainers'
           evaluation, the per-domain loop and the same checkpoint on the
           CPU; the HTTP server on a thread (requests of 1 to 8,192 rows,
           a malformed one); each bucket and mode (AREAD single- and
           mixed-domain, DeepFM, MMoE) by CUDA graph (one replay a
           request, 2 copies) and by the eager twin, bitwise, with times
           by both clocks, copies, launches, busy ms and idle share, and a
           captured request under sync debug mode 'error';
           streaming evaluation against the exact one; fit(ckpt_dir=) and
           a resume; both CLIs in subprocesses on a seed-made CSV;
  options  the trainers' options at full Amazon width: one 50-chain
           evolution under each fast-adapt engine (the full sweep, kernel
           1; the overlay, kernel 2 alone, on the schedule's launch
           counts) with ms, launches and device time per chain; both
           engines' chains by graph and by an eager twin, bitwise, on the
           Amazon table and on a 248M-element one, and the crossover
           they imply; the overlay card vs CPU and vs the full sweep (f32,
           2 domains); an overlay AREADTrainer.fit with log_dir; MMoE
           fits under each dynamic_regroup mode, the loss matrix by graph
           bitwise its eager twin (seconds of each) and card vs CPU; compute_dtype='bfloat16' (a product against f64 on
           rounded operands, a step card vs CPU, step times, a served
           checkpoint); the epoch watchdog, a fresh process's first two
           epochs, and a trace;
  mesh     the mesh paths (parallel/, Trainer(mesh=), AREADTrainer(mesh=),
           the CLI under torch.distributed.run) at full Amazon width,
           each against the single-process card run: (a) a world-1 NCCL
           group, an all_reduce and one step on a 1 x 1 mesh; (b) 2 ranks
           (mesh 1 x 2, 759,192 table rows each) of this script on the
           one card under gloo: the train phase's 8 warm-up + 16 bagging
           steps in bf16 and in f32 (losses alike on every rank and at
           atol 1e-5 + 2 ulp against one process; the f32 shards bitwise
           the unsharded kernel's rows after 3 steps), one bf16 shard
           update bitwise the CPU plain version with the shard's seed, the
           a2a lookup at its measured capacity bitwise the plain gather,
           one bf16 dense-gradient DeepFM step (kernel 2 per shard,
           index_base) bitwise one process's;
           (c) 4 ranks (mesh 2 x 2): the reference phase's 4-chain
           evolution (masks equal), 6 dense DeepFM steps (kernel 2 per
           shard), one AREADTrainer.fit epoch at RESUME_DEPTH whose
           gathered checkpoint load_predictor serves to the mesh
           evaluation (1e-6); (d) the training CLI under
           torch.distributed.run --nproc_per_node 2 --mesh_model 2 against
           the single-process CLI (1e-5). Each rank's kernel launches are
           held to the schedule's and added to the kernels' counts. Times
           there are of "gloo, N ranks on one H100", not of NCCL across
           cards;
  data     the data pipeline (layer L1) with a fresh parse cache: the
           native CSV parser built from csv_loader.cc; (a) seed-made raw
           dumps (AliCCP skeleton + common features, 120 values of field
           206; Amazon ratings + metadata over the 25 categories) through
           the training CLI's main, counted: AREAD from AliCCP (kernel 1)
           and AREAD with the overlay engine from Amazon (kernel 1 steps,
           kernel 2 chains), launches held to the schedule, both CSVs read
           by the native parser, stage seconds; the CLI again (DeepFM) as
           a process on the same directory: the skip path (the CSV
           untouched, the cache read); the Cloud-Theme build; (b) a
           canonical Amazon CSV at the real 25 domain sizes (17,664,862
           rows, fields over bench.py's dims, two history columns of 0-5
           ids) written by one numpy-only process per CPU: the native
           parse in a process of its own (seconds, rows/s, threads, peak
           RSS), which then parses the first 1,000,000 rows with pandas
           (bitwise equal) while (a) runs; load_split_data cold and warm,
           24 AREAD bagging steps of the train phase's model on the parsed
           rows (kernel 1);
  probes   the two probes that replace the benchmark folder's TPU kernels,
           through their entry points at full size, counted:
           aread_tpu_torch.benchmarks.prof_dma_issue (16,384 scattered
           [rows, 128] f32 block copies of a [380,000, 128] table into
           shared memory, rows 1 and 8, in both forms in turns: the ring
           (CTAs on every SM, a ring of bulk copies each) and the serial
           form (one thread, two stages); ns per copy by both clocks and
           cold, the byte bound, table[ids, 0].sum() beside them, the
           lazy-step projection from each form, lazy_sparse_adam_ and
           kernel 1 on the bf16 Amazon table by both clocks) and
           aread_tpu_torch.benchmarks.prof_kernel_attrib (kernel 1's sweep
           with parts taken out, six modes at [1,521,664, 32] bf16 in each
           of two sweeps, vec8 and tma, in turns: ms per update
           over 200 back-to-back updates, shares of the byte bound, the
           gaps, copy against three Tensor.copy_); then each gather_rows
           form bitwise against its own plain version (rows 1 and 8;
           16,384, 37, 1, 0, CHUNK and CHUNK + 1 copies), ring calls on
           two streams at once, an id past the table refused by each
           form's kernel (a process each), and every
           adam_attrib mode in every sweep bitwise against its plain
           version, full against kernel 1 too (-0.0 told apart), at the
           full table and at D = 8, 64, 256;
  spans    the store of spans, counters and device event pairs
           (utils/profiling.py): AREAD bagging steps, a regroup's chains,
           generic Trainer chunks and a Predictor's requests at full Amazon
           width, their replays, staging and pair reads under sync debug
           mode 'error'; every kind's pairs read, none dropped; the host's
           ns a span, a replay's span, an event pair and a pair read back;
  reference three steps from the same weights on the card and on the CPU
           (plain versions) at a small width, for the AREAD step and for
           the dense DeepFM step, and one small evolution at full width
           (2 domains' chains, replays of a graph on the card): they
           must agree;
  profile, profile_dense, profile_hemp  (opt-in, after train /
           train_dense / hemp) torch.profiler over a chunk of AREAD bagging
           steps of each dispatch / 4 dense DeepFM steps / 4 fast-adapt
           chains; tables and a trace go to --profile-dir.

Kernel launches are counted where they run: a wrapper counts its launch,
or, inside a CUDA graph's capture, records it for the graph, which adds it
to the counts once per replay (ops/cuda/__init__.py count_launch); the
train phase holds that count against the profiler's kernel records.

The launch counts are set to 0 just before each path (train, train_dense
and its parts, zoo's and zoo2's fits and steps, hemp, serve's resumes,
options' evolutions and fits, in each rank of the mesh phase its runs,
data's two CLI runs and its steps, the probes' entry points) and read just after it; a kernel's ``launches`` is the sum over the
paths, the ranks' included. Then one JSON line with every kernel's numbers, and last
the line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import platform
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# Amazon layout of bench.py / config defaults
AMAZON_DIMS = (1368287, 7, 25, 40, 11, 150000, 12)
EMBED_DIM, BS, N_DOMAIN = 32, 1024, 25
KERNEL_SOURCES = ["sparse_adam", "fused_adam", "gather_rows", "adam_attrib"]
# the phase whose path launches each kernel ("no path launched" is checked
# for the kernels whose phase ran)
LAUNCHED_IN = {"sparse_adam": "train", "fused_adam": "train_dense",
               "gather_rows": "probes", "adam_attrib": "probes"}
# each kernel's main __global__ function by a part of its name, and the
# instantiations ptxas must report (every storage variant or mode); none
# may spill
MAIN_KERNELS = {"sparse_adam": ("vec8", 8), "fused_adam": ("vec8", 8),
                "gather_rows": ("gather_rows_", 2),
                "adam_attrib": ("attrib_sweep", 12)}
# per-kernel times of the final ``kernels`` line (beside library_ms):
# ms / scalar_ms are device times of the vector and the scalar kernel (the
# back-to-back clock; for the gather, whose ring launch is shorter than its
# host time, the device_ms clock, and its back-to-back clock under
# back_to_back_ms), call_ms the vector kernel's per-call median (host
# included)
ROW_TIMES = ("ms", "call_ms", "scalar_ms", "scalar_call_ms", "plain_ms",
             "bound_ms", "cuda_launches_per_update", "wrapper_host_us")
# TPU kernel each port replaces
REPLACES = {"sparse_adam":
            "aread_tpu/ops/pallas/sparse_adam_kernel.py:252",
            "fused_adam": "aread_tpu/ops/pallas/fused_adam.py:63",
            "gather_rows": "benchmarks/prof_dma_issue.py:69",
            "adam_attrib": "benchmarks/prof_kernel_attrib.py:139"}


def peak_hbm_bytes_per_s(name: str) -> float:
    """Published HBM bandwidth of the H100 SXM (data sheet)."""
    if name != "NVIDIA H100 80GB HBM3":
        raise RuntimeError(f"no peak bandwidth known for {name!r}")
    return 3.35e12


def cuda_time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` calls, each timed with its own CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Device time per call: one event pair around ``n`` back-to-back
    calls, over ``n``. The host runs ahead of the device, so its own time
    per call is left out; every launch a call makes is included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def both_clocks(fn, n: int = 20):
    """(ms, call_ms): the back-to-back device time per call and the median
    of calls timed one by one (which holds the caller's host time)."""
    return device_time_ms(fn, n), cuda_time_ms(fn, n)


def host_us_per_call(fn, n: int = 20) -> float:
    """Host time of one call (microseconds): ``n`` calls on the host clock
    with the device left to run behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def launches_and_busy_per_call(fn, n: int = 3):
    """(cudaLaunchKernel calls, device busy ms) per call of ``fn`` from a
    torch.profiler window over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel") / n
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA) / n / 1e3
    if launches == 0:
        raise AssertionError("the profiler saw no cudaLaunchKernel")
    return launches, busy


def cuda_launches_per_call(fn, n: int = 4) -> float:
    """cudaLaunchKernel calls per call of ``fn``, from a torch.profiler
    window over ``n`` calls."""
    return launches_and_busy_per_call(fn, n)[0]


def cuda_copies_per_call(fn, n: int = 4):
    """(cudaMemcpyAsync calls per call of ``fn``, {device-side copy kind:
    count per call}) from a torch.profiler window over ``n`` calls. The
    calls count copies between host and device in either direction and
    device-to-device ones; the kinds tell them apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return (sum(e.count for e in ka if e.key == "cudaMemcpyAsync") / n,
            {e.key: e.count / n for e in ka if e.key.startswith("Memcpy")})


def assert_copies(what: str, copies: float, kinds, want: int) -> None:
    """``want`` cudaMemcpyAsync calls per request: one copy in and one
    out, plus, on the eager path with an f32 table, the device-to-device
    copy of the gathered rows (by graph a node of the replay). Held on the
    host-side call count; the device-side kinds are printed beside it but
    a profiler window can lose one of them."""
    if copies != want:
        raise AssertionError(f"{what} made {copies} copies ({kinds}); "
                             f"{want} were expected")


@contextlib.contextmanager
def scalar_kernels():
    """Inside, both wrappers take their scalar kernel whatever the shapes
    and alignment (the choice is a module function of each wrapper)."""
    from aread_tpu_torch.ops import fused_adam, sparse_adam

    saved = sparse_adam.sweep_plan, fused_adam.takes_vector_kernel
    sparse_adam.sweep_plan = lambda d, aligned: (0, 0, 0)
    fused_adam.takes_vector_kernel = lambda numel, aligned: False
    try:
        yield
    finally:
        sparse_adam.sweep_plan, fused_adam.takes_vector_kernel = saved


def kernel_forms():
    """("vector", ctx), ("scalar", ctx): the wrappers' own choice (checked
    by the caller to be the vector kernel) and the scalar kernels forced."""
    return (("vector", contextlib.nullcontext()), ("scalar", scalar_kernels()))


def time_forms(fn, plain_fn):
    """Both clocks of ``fn`` with the scalar and the vector kernel in turns
    (scalar, vector, vector, scalar), with the wrapper's host time per call,
    and of the plain version. ``ms`` / ``scalar_ms`` are the means of the
    two back-to-back readings."""
    runs = []
    for form in ("scalar", "vector", "vector", "scalar"):
        with (scalar_kernels() if form == "scalar"
              else contextlib.nullcontext()):
            ms, call_ms = both_clocks(fn)
            host_us = host_us_per_call(fn)
        runs.append({"form": form, "ms": ms, "call_ms": call_ms,
                     "host_us": host_us})
    plain_ms, plain_call_ms = both_clocks(plain_fn, n=5)

    def mean(form, key):
        return statistics.mean(r[key] for r in runs if r["form"] == form)

    return {"ms": mean("vector", "ms"), "call_ms": mean("vector", "call_ms"),
            "scalar_ms": mean("scalar", "ms"),
            "scalar_call_ms": mean("scalar", "call_ms"),
            "wrapper_host_us": mean("vector", "host_us"),
            "scalar_wrapper_host_us": mean("scalar", "host_us"),
            "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
            "runs": runs}


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def path_counts(launch_counts) -> dict:
    """A path's launch counts: the two Adam kernels' always (every path's
    check names both), any other kernel's where the path launched it (so
    an unexpected launch fails those checks)."""
    return {k: v for k, v in launch_counts.items()
            if v or k in ("sparse_adam", "fused_adam")}


def counted(ctx, path: str, fn):
    """Run ``fn`` with the kernels' launch counts set to 0 just before and
    read just after; the counts go to ctx['launches_by_path'][path]."""
    from aread_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    ctx.setdefault("launches_by_path", {})[path] = path_counts(launch_counts)
    return out


# ------------------------------------------------------------------ phases
def phase_device(ctx):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    ctx["smi"] = smi.stdout.strip().splitlines()[0]
    print(ctx["smi"], flush=True)
    ctx["name"] = torch.cuda.get_device_name(0)
    ctx["peak_bw"] = peak_hbm_bytes_per_s(ctx["name"])
    say("device", torch_name=ctx["name"], smi=ctx["smi"],
        torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count(), peak_hbm_bytes_per_s=ctx["peak_bw"],
        host_cpu=host_cpu(),
        cpu_capability=torch.backends.cpu.get_cpu_capability())


def host_cpu() -> str:
    """The host CPU (model name, else vendor, family and model) and its
    widest vector set: the CPU references' last bits follow the
    instruction set that MKL and ATen pick for it."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
        if k in info) or platform.processor() or platform.machine()
    flags = info.get("flags", "").split()
    widest = next((f for f in ("avx512f", "avx2", "sse4_2") if f in flags),
                  "flags unknown")
    return f"{name}, {widest}"


def phase_build(ctx):
    from aread_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build_all(KERNEL_SOURCES)
    ctx["build_s"] = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        build.load(name)
    ptxas = {n: ptxas_summary(build.BUILD_LOGS.get(n, ""))
             for n in KERNEL_SOURCES}
    say("build", seconds=round(ctx["build_s"], 3),
        steps_s=build.BUILD_TIMES, libs={n: str(p.name)
                                         for n, p in paths.items()},
        ptxas=ptxas)
    for name, kernels in ptxas.items():
        part, want = MAIN_KERNELS[name]
        main = [k for k in kernels if part in k["kernel"]]
        if build.BUILD_LOGS.get(name) and len(main) != want:
            raise AssertionError(f"{name}: ptxas reported {len(main)} "
                                 f"{part} kernels, {want} instantiations "
                                 "expected")
        spilled = [k for k in main if k.get("spill_bytes")]
        if spilled:
            raise AssertionError(f"kernels spill registers: {spilled}")


def ptxas_summary(log: str):
    """[{kernel, registers, spill_bytes}] from nvcc's ``-Xptxas -v`` output,
    kernel names demangled where c++filt is at hand."""
    import re
    import shutil

    out = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            out.append({"kernel": m.group(1)})
        elif out and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                     r"spill loads", line)):
            # a device function that was not inlined reports under its caller
            out[-1]["spill_bytes"] = (out[-1].get("spill_bytes", 0)
                                      + int(m.group(1)) + int(m.group(2)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = max(out[-1].get("registers", 0),
                                       int(m.group(1)))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"] + [k["kernel"] for k in out],
                               capture_output=True, text=True).stdout.split("\n")
        for k, name in zip(out, names):
            k["kernel"] = (name.replace("(anonymous namespace)::", "")
                           .split("(")[0].removeprefix("void "))
    return out


def amazon_table_ids(rng, spec_dims, n_rows, bs=BS):
    """One batch's gathered table rows (17 per example), as the embedding
    computes them: per-field offsets, the two history sequences on the
    itemid rows."""
    offs = np.concatenate([[0], np.cumsum(spec_dims)[:-1]])
    cols = [rng.integers(0, d, size=(bs, 1)) + o
            for d, o in zip(spec_dims, offs)]
    seqs = rng.integers(0, spec_dims[0], size=(bs, 10))
    return np.clip(np.concatenate(cols + [seqs], axis=1), 0, n_rows - 1)


def phase_kernels(ctx):
    check_sparse_adam(ctx)
    check_aged_table(ctx)
    check_fused_adam(ctx)
    check_dense_adam_scalar_forms()


def host_float_dense_adam(opt, params, grads, state):
    """``DenseAdam.update_`` with its bias corrections as host floats (the
    form before the step's scalar block): the float overloads of
    ``torch._foreach_div``."""
    names = list(params)
    p = [params[n] for n in names]
    mu = [state["mu"][n] for n in names]
    nu = [state["nu"][n] for n in names]
    g = torch._foreach_add([grads[n] for n in names], p, alpha=opt.wd)
    torch._foreach_mul_(mu, opt.b1)
    torch._foreach_add_(mu, g, alpha=1 - opt.b1)
    torch._foreach_mul_(nu, opt.b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - opt.b2)
    state["count"] += 1
    t = torch.tensor(float(state["count"]), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(opt.b1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(opt.b2, dtype=torch.float32) ** t)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, opt.eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(p, upd, alpha=-opt.lr)


def check_dense_adam_scalar_forms():
    """The dense leaves' Adam on the card with its bias corrections as 0-dim
    device tensors (the step's scalar block, what a captured step reads)
    against the host-float overloads, over the AREAD train model's leaves
    for 20 steps: the tensor-scalar ``_foreach_div`` may round otherwise.
    Reported, not required: both dispatches use the tensor form."""
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.ops.sparse_adam import step_scalars, to_device
    from aread_tpu_torch.train.trainer import DenseAdam

    tr = build_trainer(FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5), "cuda",
                       N_DOMAIN, dataset_name="amazon", seed=0)
    params = {n: p.detach().clone()
              for n, p in tr.model.dense_named_parameters().items()}
    mine = {n: p.clone() for n, p in params.items()}
    opt = DenseAdam(lr=1e-3)
    st, st_mine = opt.init(params), opt.init(mine)
    gen = torch.Generator(device="cuda").manual_seed(5)
    steps_equal = []
    for _ in range(20):
        grads = {n: 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")
                 for n, p in params.items()}
        host_float_dense_adam(opt, params, grads, st)
        opt.update_(mine, grads, st_mine, scalars=to_device(step_scalars(
            st_mine["count"] + 1, opt.lr, opt.b1, opt.b2), "cuda"))
        steps_equal.append(all(torch.equal(mine[n], params[n])
                               for n in params))
    worst = max(float((mine[n] - params[n]).abs().max()) for n in params)
    # which overload is the IEEE quotient: against x / bc, bc a 0-dim
    # tensor on the card (a broadcast division, not a scalar's reciprocal)
    xs = [st["nu"][n] for n in params]
    bc = to_device(step_scalars(7, opt.lr, opt.b1, opt.b2), "cuda").view(
        torch.float32)[2]
    quotient = [x / bc for x in xs]
    ieee = {form: all(torch.equal(a, b) for a, b in zip(
        torch._foreach_div(xs, d), quotient))
        for form, d in (("tensor", bc), ("float", float(bc)))}
    say("kernels", check="DenseAdam tensor-scalar vs float _foreach_div",
        leaves=len(params), steps=20, bitwise_every_step=all(steps_equal),
        max_abs_diff=worst, ieee_quotient=ieee)
    del tr


SPARSE_KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8,
                 l2=1e-5)
SPARSE_VARIANTS = {  # name: (table dtype, moment dtype, want_l2)
    "f32": (torch.float32, torch.float32, False),
    "bf16": (torch.bfloat16, torch.bfloat16, False),
    "bf16_l2": (torch.bfloat16, torch.bfloat16, True),
    "f32_l2": (torch.float32, torch.float32, True),
}


def sparse_case(label, w32, m32, v32, uids, gsum, t, want_vpr):
    """Vector (the wrapper's choice, which must be ``want_vpr`` vectors per
    row; 0 = it takes the scalar sweep itself) and scalar sweep against the
    plain version in every storage variant: bitwise, repeatable, sum(w^2)
    within rtol 1e-5 of f64, the slot map and the block counter clean
    afterwards. Returns the worst absolute error."""
    from aread_tpu_torch.ops.sparse_adam import (_slot_map, is_aligned16,
                                                 sparse_adam_cuda,
                                                 sparse_adam_reference,
                                                 sweep_plan)

    n_rows, d = w32.shape
    worst = 0.0
    for vname, (wdt, mdt, want_l2) in SPARSE_VARIANTS.items():
        w, m, v = w32.to(wdt), m32.to(mdt), v32.to(mdt)
        ref = sparse_adam_reference(w, m, v, uids, gsum, t, want_l2=want_l2,
                                    **SPARSE_KW)
        vpr = sweep_plan(d, is_aligned16(w, m, v, gsum))[0]
        if vpr != want_vpr:
            raise AssertionError(f"{label}: the wrapper plans vpr={vpr}, "
                                 f"expected {want_vpr}")
        for form, forced in kernel_forms():
            if form == "vector" and vpr == 0:
                continue
            line = {**label, "variant": vname, "form": form}
            with forced:
                sums = []
                for _ in range(2):  # the second launch must repeat the first
                    got = w.clone(), m.clone(), v.clone()
                    l2k = sparse_adam_cuda(*got, uids, gsum, t,
                                           want_l2=want_l2, **SPARSE_KW)
                    # the sum is a view of scratch the next launch overwrites
                    sums.append(l2k.clone() if want_l2 else None)
                    torch.cuda.synchronize()
                    line["bitwise"] = all(torch.equal(x, y)
                                          for x, y in zip(got, ref[:3]))
                    line["max_abs_err"] = max(
                        float((x.float() - y.float()).abs().max())
                        for x, y in zip(got, ref[:3]))
                    if not line["bitwise"]:
                        raise AssertionError(f"kernel != plain version: {line}")
            scratch = _slot_map(w.device, n_rows)
            if not (bool((scratch.slot == -1).all())
                    and int(scratch.count) == 0):
                raise AssertionError(f"the slot map or the block counter "
                                     f"was left dirty: {line}")
            if want_l2:
                if not torch.equal(sums[0], sums[1]):
                    raise AssertionError(f"sum(w^2) not repeatable: {line}")
                exact = float(torch.sum(torch.square(w.double())))
                line["l2_rel_err"] = abs(float(sums[0]) - exact) / exact
                line["l2_equals_plain"] = bool(torch.equal(sums[0], ref[3]))
                if line["l2_rel_err"] > 1e-5 or abs(
                        float(sums[0]) - float(ref[3])) > 1e-5 * exact:
                    raise AssertionError(f"sum(w^2) off: {line}")
            worst = max(worst, line["max_abs_err"])
            say("kernels", **line)
    return worst


def sparse_shard_case(w32, m32, v32, ids, t):
    """Kernel 1 on model rank 1's rows of a 2-way row-sharded table,
    [n_rows / 2, D], with the shard's local ids (``shard_run``) and its own
    stochastic-rounding seed t * 2 + 1, against the plain version with the
    same seed, in every storage variant: bitwise. A bf16 shard keyed on t
    alone would round otherwise (checked: the seed reaches the kernel).
    Returns the worst absolute error."""
    from aread_tpu_torch.ops.sparse_adam import (dedup_rows,
                                                 sparse_adam_cuda,
                                                 sparse_adam_reference)
    from aread_tpu_torch.parallel.sharded_adam import shard_run

    n_rows, d = w32.shape
    rows = n_rows // 2
    dev = w32.device
    gen = torch.Generator(device=dev).manual_seed(3)
    ids_t = torch.as_tensor(ids.reshape(-1), dtype=torch.int32, device=dev)
    grads = torch.randn((ids_t.numel(), d), generator=gen, device=dev)
    uids, gsum = dedup_rows(ids_t, grads, n_rows)
    local, gloc = shard_run(uids, gsum, rows, rows)
    seed = t * 2 + 1
    worst = 0.0
    for vname, (wdt, mdt, want_l2) in SPARSE_VARIANTS.items():
        w = w32[rows:].to(wdt).clone()
        m, v = m32[rows:].to(mdt).clone(), v32[rows:].to(mdt).clone()
        ref = sparse_adam_reference(w, m, v, local, gloc, t, want_l2=want_l2,
                                    sr_seed=seed, **SPARSE_KW)
        got = w.clone(), m.clone(), v.clone()
        l2k = sparse_adam_cuda(*got, local, gloc, t, want_l2=want_l2,
                               sr_seed=seed, **SPARSE_KW)
        torch.cuda.synchronize()
        line = {"shard": [rows, d], "model_index": 1, "sr_seed": seed,
                "variant": vname,
                "touched_rows": int((local < rows).sum()),
                "bitwise": all(torch.equal(x, y)
                               for x, y in zip(got, ref[:3])),
                "max_abs_err": max(float((x.float() - y.float()).abs().max())
                                   for x, y in zip(got, ref[:3]))}
        if want_l2:
            line["l2_rel_err"] = abs(float(l2k) - float(ref[3])) / float(ref[3])
            if line["l2_rel_err"] > 1e-5:
                raise AssertionError(f"shard sum(w^2): {line}")
        if wdt == torch.bfloat16:
            seed_t = sparse_adam_reference(w, m, v, local, gloc, t,
                                           **SPARSE_KW)[0]
            line["differs_from_seed_t"] = not torch.equal(seed_t, ref[0])
            if not line["differs_from_seed_t"]:
                raise AssertionError(f"the shard's seed changed nothing: "
                                     f"{line}")
        if not line["bitwise"]:
            raise AssertionError(f"shard kernel != plain version: {line}")
        worst = max(worst, line["max_abs_err"])
        say("kernels", **line)
    return worst


def sparse_block_case(w32, m32, v32, ids, t):
    """Kernel 1 reading its step's scalars from row 2 of a chunk's staged
    blocks ([SCAN_CHUNK, 4] on the card, steps t - 2 .. of the chunk),
    against the plain version reading the same row and against both made
    from ``t``: bitwise, in every storage variant."""
    from aread_tpu_torch.ops.sparse_adam import (chunk_scalars, dedup_rows,
                                                 sparse_adam_cuda,
                                                 sparse_adam_reference,
                                                 to_device)
    from aread_tpu_torch.train.step_graph import SCAN_CHUNK

    n_rows, d = w32.shape
    dev = w32.device
    gen = torch.Generator(device=dev).manual_seed(4)
    ids_t = torch.as_tensor(ids.reshape(-1), dtype=torch.int32, device=dev)
    uids, gsum = dedup_rows(ids_t, torch.randn((ids_t.numel(), d),
                                               generator=gen, device=dev),
                            n_rows)
    blocks = to_device(chunk_scalars(t - 3, SCAN_CHUNK, SPARSE_KW["lr"]), dev)
    row = blocks[2]
    worst = 0.0
    for vname, (wdt, mdt, want_l2) in SPARSE_VARIANTS.items():
        w, m, v = w32.to(wdt), m32.to(mdt), v32.to(mdt)
        ref = sparse_adam_reference(w, m, v, uids, gsum, t, want_l2=want_l2,
                                    scalars=row, **SPARSE_KW)
        by_t = sparse_adam_reference(w, m, v, uids, gsum, t, want_l2=want_l2,
                                     **SPARSE_KW)
        got = w.clone(), m.clone(), v.clone()
        sparse_adam_cuda(*got, uids, gsum, t, want_l2=want_l2, scalars=row,
                         **SPARSE_KW)
        torch.cuda.synchronize()
        line = {"scalars": "chunk block row", "variant": vname,
                "bitwise": all(torch.equal(x, y) for x, y in zip(got, ref[:3])),
                "plain_equals_t_form": all(torch.equal(x, y) for x, y in
                                           zip(ref[:3], by_t[:3])),
                "max_abs_err": max(float((x.float() - y.float()).abs().max())
                                   for x, y in zip(got, ref[:3]))}
        if not (line["bitwise"] and line["plain_equals_t_form"]):
            raise AssertionError(f"kernel 1 on a staged block: {line}")
        worst = max(worst, line["max_abs_err"])
        say("kernels", **line)
    return worst


def check_sparse_adam(ctx):
    """The sparse sweep, vector and scalar kernel, against its plain version
    at the full Amazon table (two batches) and at small tables whose D takes
    each path of the plan; then its times at the main path's configuration."""
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.ops.sparse_adam import (dedup_rows,
                                                 sparse_adam_cuda,
                                                 sparse_adam_reference)

    dev = torch.device("cuda")
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5).with_flat_table(EMBED_DIM)
    n_rows, d = spec.n_rows, EMBED_DIM
    rng = np.random.default_rng(1)
    K = BS * spec.n_columns
    batches = {
        "amazon": amazon_table_ids(rng, spec.one_hot_dims, n_rows),
        # every id inside one 16K-row region (the TPU window's worst case)
        "clustered": rng.integers(700_000, 700_000 + 16384, size=K),
    }
    kw = SPARSE_KW
    gen = torch.Generator(device=dev).manual_seed(0)
    t = 7
    worst = 0.0
    # small tables: D = 20 takes the scalar sweep; 8, 32, 64, 256 the vector
    # sweep with the row found by a shift and the map reset in the sweep; 40
    # and 96 by the host-computed multiplier, 264 too (33 vectors a row, more
    # than a warp), with the reset launch. 5,003 rows: the last warp is ragged
    for small_d, want_vpr in ((20, 0), (8, 1), (32, 4), (40, 5), (64, 8),
                              (96, 12), (256, 32), (264, 33)):
        rows = 5003
        sw = torch.randn((rows, small_d), generator=gen, device=dev)
        sm = 0.1 * torch.randn((rows, small_d), generator=gen, device=dev)
        sv = 0.01 * torch.rand((rows, small_d), generator=gen, device=dev)
        ids = torch.randint(0, rows, (700,), generator=gen, device=dev,
                            dtype=torch.int32)
        grads = torch.randn((700, small_d), generator=gen, device=dev)
        uids, gsum = dedup_rows(ids, grads, rows)
        worst = max(worst, sparse_case({"rows": rows, "d": small_d}, sw, sm,
                                       sv, uids, gsum, t, want_vpr))
    # a misaligned gradient (a view one float into its buffer): the wrapper
    # itself must take the scalar sweep
    buf = torch.zeros((gsum.numel() + 1,), device=dev)
    off = buf[1:].view(gsum.shape).copy_(gsum)
    worst = max(worst, sparse_case({"rows": rows, "d": small_d,
                                    "gsum": "misaligned"}, sw, sm, sv, uids,
                                   off, t, 0))
    del sw, sm, sv, buf, off

    w32 = torch.randn((n_rows, d), generator=gen, device=dev)
    m32 = 0.1 * torch.randn((n_rows, d), generator=gen, device=dev)
    v32 = 0.01 * torch.rand((n_rows, d), generator=gen, device=dev)
    for bname, ids in batches.items():
        ids_t = torch.as_tensor(ids.reshape(-1), dtype=torch.int32, device=dev)
        grads = torch.randn((K, d), generator=gen, device=dev)
        uids, gsum = dedup_rows(ids_t, grads, n_rows)
        # the segmented sum adds in sorted order on every device
        cu, cg = dedup_rows(ids_t.cpu(), grads.cpu(), n_rows)
        if not (torch.equal(uids.cpu(), cu) and torch.equal(gsum.cpu(), cg)):
            raise AssertionError(f"dedup_rows differs between card and CPU "
                                 f"({bname} batch)")
        n_unique = int((uids < n_rows).sum())
        if n_unique >= K:
            raise AssertionError("the batch must carry duplicate ids")
        worst = max(worst, sparse_case(
            {"batch": bname, "n_unique": n_unique}, w32, m32, v32, uids, gsum,
            t, d // 8))
        del ids_t, grads

    # a row shard, as a mesh run updates it
    worst = max(worst, sparse_shard_case(w32, m32, v32, batches["amazon"], t))
    # the step's scalars as a captured step reads them: a row of a chunk's
    # staged blocks on the card
    worst = max(worst, sparse_block_case(w32, m32, v32, batches["amazon"], t))

    # times at the main path's configuration: bf16 table and moments,
    # sum(w^2) wanted (config defaults), Amazon batch
    ids_t = torch.as_tensor(batches["amazon"].reshape(-1), dtype=torch.int32,
                            device=dev)
    grads = torch.randn((K, d), generator=gen, device=dev)
    uids, gsum = dedup_rows(ids_t, grads, n_rows)
    timing = {}
    for vname in ("bf16_l2", "f32_l2"):
        wdt, mdt, _ = SPARSE_VARIANTS[vname]
        w, m, v = w32.to(wdt), m32.to(mdt), v32.to(mdt)

        def update():
            return sparse_adam_cuda(w, m, v, uids, gsum, t, want_l2=True, **kw)

        times = time_forms(update, lambda: sparse_adam_reference(
            w, m, v, uids, gsum, t, want_l2=True, **kw))
        esz = w.element_size() + m.element_size() + v.element_size()
        nbytes = 2 * esz * n_rows * d + uids.numel() * 4 + gsum.numel() * 4
        timing[vname] = {**times, "bound_ms": nbytes / ctx["peak_bw"] * 1e3,
                         "bytes": nbytes,
                         "cuda_launches_per_update":
                             cuda_launches_per_call(update)}
        say("kernels_time", kernel="sparse_adam", variant=vname,
            **timing[vname],
            achieved_bytes_per_s=nbytes / (times["ms"] * 1e-3))
        del w, m, v
    # library yardstick: PyTorch's fused dense Adam over an f32 table with
    # a dense gradient (the function the sweep computes, minus sparsity)
    p = torch.nn.Parameter(w32.clone())
    p.grad = torch.zeros_like(p)
    p.grad.index_put_((uids[uids < n_rows].long(),), gsum[uids < n_rows])
    opt = torch.optim.Adam([p], lr=1e-3, betas=(0.9, 0.99), eps=1e-8,
                           weight_decay=1e-8 + 2e-5, fused=True)
    library_ms, library_call_ms = both_clocks(opt.step)
    say("kernels_library", call="torch.optim.Adam(fused=True) f32 dense",
        ms=library_ms, call_ms=library_call_ms)
    del p, opt
    main = timing["bf16_l2"]
    if main["cuda_launches_per_update"] != 2:
        raise AssertionError("the sparse update at the main path's shapes "
                             "must be two CUDA launches (scatter, sweep), "
                             f"not {main['cuda_launches_per_update']}")
    ctx["kernel_rows"] = {"sparse_adam": {
        "name": "sparse_adam", "route": "cuda",
        "source": "aread_tpu_torch/ops/cuda/sparse_adam.cu",
        "replaces": REPLACES["sparse_adam"], "max_abs_err": worst,
        **{k: main[k] for k in ROW_TIMES},
        "bound_by": "bytes", "library_ms": library_ms,
        "library_call_ms": library_call_ms}}


def check_aged_table(ctx):
    """Kernel 1 on an aged table (``benchmarks/prof_aged_adam.py``): the
    1,518,384 x 32 table after AGE_STEPS updates that leave most rows
    untouched, its operand classes, both sweeps' ms there and on the fresh
    table, an update of it (and of it mixed row by row with the fresh one)
    by each sweep bitwise against the plain version with the share of warp
    steps that took a small-operand form (the sweep's counters), and
    rounding.cuh's division and sqrt bitwise against __fdiv_rn /
    __fsqrt_rn over every f32 below 2^-100."""
    from aread_tpu_torch.benchmarks import prof_aged_adam

    out = prof_aged_adam.run("cuda")
    times, ieee = out["times"], out["ieee"]
    checks = {k: c for k, c in out["bitwise"].items() if isinstance(c, dict)}
    line = {"table": out["state"]["table"], "steps": out["state"]["steps"],
            **{k: times[k] for k in ("ms", "scalar_ms", "fresh_ms",
                                     "fresh_scalar_ms", "roofline_pct",
                                     "fresh_roofline_pct")},
            "any_small": out["state"]["any_small"],
            "bitwise": {k: c["bitwise"] for k, c in checks.items()},
            "tiny_pct": {k: c["tiny_pct"] for k, c in checks.items()},
            "ieee_mismatches": {op: ieee[op]["mismatches"]
                                for op in ("div", "sqrt")},
            "ieee_operands": {op: ieee[op]["operands"]
                              for op in ("div", "sqrt")}}
    say("kernels_aged", **line)
    if not all(line["bitwise"].values()) or any(
            line["ieee_mismatches"].values()) or not (
            ieee["div_plain_equal"] and ieee["sqrt_plain_equal"]):
        raise AssertionError(f"kernel 1 on the aged table: {line}")
    ctx["kernel_rows"]["sparse_adam"].update(
        aged_ms=times["ms"], aged_scalar_ms=times["scalar_ms"])


def fused_case(label, w, m, v, g, t, kw, want_vector):
    """Vector (the wrapper's choice, which must be the vector kernel iff
    ``want_vector``) and scalar kernel against the plain version, both fed
    the step's scalar block ``kw['scalars']`` (a row of a chunk's blocks
    staged on the card): bitwise, repeatable, and the leaf really changed;
    the plain version on the block bitwise its form made from ``t``.
    Returns the worst absolute error."""
    from aread_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                fused_adam_reference,
                                                takes_vector_kernel)
    from aread_tpu_torch.ops.sparse_adam import is_aligned16

    ref = fused_adam_reference(w, m, v, g, t, **kw)
    by_t = fused_adam_reference(w, m, v, g, t, **dict(kw, scalars=None))
    if not all(torch.equal(x, y) for x, y in zip(ref, by_t)):
        raise AssertionError(f"{label}: the plain version on the staged "
                             "block differs from its form made from t")
    vec = takes_vector_kernel(w.numel(), is_aligned16(w, m, v, g))
    if vec != want_vector:
        raise AssertionError(f"{label}: the wrapper picks vector={vec}")
    worst = 0.0
    for form, forced in kernel_forms():
        if form == "vector" and not vec:
            continue
        line = {"kernel": "fused_adam", **label, "form": form,
                "scalars": "chunk block row"}
        with forced:
            for _ in range(2):  # the second launch must repeat the first
                w0, m0, v0 = w.clone(), m.clone(), v.clone()
                fused_adam_cuda(w, m, v, g, t, **kw)
                torch.cuda.synchronize()
                got = w.clone(), m.clone(), v.clone()
                w.copy_(w0), m.copy_(m0), v.copy_(v0)
                line["bitwise"] = all(torch.equal(x, y)
                                      for x, y in zip(got, ref))
                line["max_abs_err"] = max(
                    float((x.float() - y.float()).abs().max())
                    for x, y in zip(got, ref))
                if not line["bitwise"]:
                    raise AssertionError(f"kernel != plain version: {line}")
                if torch.equal(got[0], w0):
                    raise AssertionError(f"the kernel changed nothing: {line}")
                del got, w0, m0, v0
        worst = max(worst, line["max_abs_err"])
        say("kernels", **line)
    return worst


def check_fused_adam(ctx):
    """The dense fused Adam, vector and scalar kernel, against its plain
    version — bitwise — at small shapes (element counts that are and are
    not multiples of 8), on misaligned views (which the wrapper itself must
    hand to the scalar kernel) and at the dense path's unpadded Amazon
    table, in every storage variant; against the sparse sweep fed the same
    gradient; and its times at the full table. Every launch reads lr, the
    bias corrections and the seed from row 2 of a chunk's scalar blocks
    staged on the card (step t), as a captured step's launch does."""
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                fused_adam_reference)
    from aread_tpu_torch.ops.sparse_adam import (chunk_scalars, dedup_rows,
                                                 sparse_adam_cuda, to_device)
    from aread_tpu_torch.train.step_graph import SCAN_CHUNK

    dev = torch.device("cuda")
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)  # the dense path pads nothing
    n_rows, d = spec.n_rows, EMBED_DIM
    t = 7
    blocks = to_device(chunk_scalars(t - 3, SCAN_CHUNK, 1e-3), dev)
    kw = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5,
              scalars=blocks[2])
    bf16, f32 = torch.bfloat16, torch.float32
    variants = {  # name: (w, moments, g) storage
        "f32": (f32, f32, f32),
        "f32_bf16m": (f32, bf16, f32),
        "bf16_sr": (bf16, bf16, bf16),
        "bf16_f32m": (bf16, f32, f32),
    }
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for shape in [(1000, 33), (128,), (7, 5, 3), (5,), (100003,),
                  (n_rows, d)]:
        w32 = torch.randn(shape, generator=gen, device=dev)
        m32 = 0.1 * torch.randn(shape, generator=gen, device=dev)
        v32 = 0.01 * torch.rand(shape, generator=gen, device=dev)
        g32 = torch.randn(shape, generator=gen, device=dev)
        for vname, (wdt, mdt, gdt) in variants.items():
            w, m, v, g = (x.to(dt, copy=True) for x, dt in (
                (w32, wdt), (m32, mdt), (v32, mdt), (g32, gdt)))
            worst = max(worst, fused_case(
                {"shape": list(shape), "variant": vname}, w, m, v, g, t, kw,
                want_vector=w.numel() >= 8))
            del w, m, v, g
        if shape == (100003,):
            # views one element into flat buffers: not 16-byte aligned
            for vname, (wdt, mdt, gdt) in variants.items():
                w, m, v, g = (
                    torch.zeros((x.numel() + 1,), dtype=dt, device=dev)[1:]
                    .copy_(x) for x, dt in ((w32, wdt), (m32, mdt),
                                            (v32, mdt), (g32, gdt)))
                worst = max(worst, fused_case(
                    {"shape": list(shape), "variant": vname,
                     "views": "misaligned"}, w, m, v, g, t, kw,
                    want_vector=False))
                del w, m, v, g
    # the full-size f32 state stays for what follows

    # a row shard's global element indices (index_base: the second half of
    # a 2-way split, as a mesh's model rank 1 updates it): bitwise the
    # plain version, and a bf16 leaf rounds otherwise than from index 0
    half = n_rows // 2
    for vname in ("bf16_sr", "bf16_f32m", "f32"):
        wdt, mdt, gdt = variants[vname]
        w, m, v, g = (x[half:].to(dt, copy=True) for x, dt in (
            (w32, wdt), (m32, mdt), (v32, mdt), (g32, gdt)))
        base = half * d
        worst = max(worst, fused_case(
            {"shape": list(w.shape), "variant": vname, "index_base": base},
            w, m, v, g, t, dict(kw, index_base=base), want_vector=True))
        if wdt == bf16:
            at0 = fused_adam_reference(w, m, v, g, t, **kw)[0]
            atb = fused_adam_reference(w, m, v, g, t,
                                       **dict(kw, index_base=base))[0]
            if torch.equal(at0, atb):
                raise AssertionError("index_base changed no rounding")
        del w, m, v, g

    # the sparse sweep on (uids, gsum) and this kernel on the same gradient
    # scattered into a dense g leave the same f32 table and moments
    rng = np.random.default_rng(1)
    ids = amazon_table_ids(rng, spec.one_hot_dims, n_rows)
    ids_t = torch.as_tensor(ids.reshape(-1), dtype=torch.int32, device=dev)
    grads = torch.randn((ids_t.numel(), d), generator=gen, device=dev)
    uids, gsum = dedup_rows(ids_t, grads, n_rows)
    live = uids < n_rows
    dense_g = torch.zeros((n_rows, d), device=dev).index_copy_(
        0, uids[live].long(), gsum[live])
    for mdt in (f32, bf16):
        for form, forced in kernel_forms():
            a = w32.clone(), m32.to(mdt, copy=True), v32.to(mdt, copy=True)
            b = w32.clone(), m32.to(mdt, copy=True), v32.to(mdt, copy=True)
            with forced:
                sparse_adam_cuda(*a, uids, gsum, t, **kw)
                fused_adam_cuda(*b, dense_g, t, **kw)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            say("kernels", kernel="sparse_adam == fused_adam", form=form,
                moments=str(mdt), n_unique=int(live.sum()), bitwise=same)
            if not same:
                raise AssertionError("the sparse and the dense table update "
                                     f"differ (moments {mdt}, {form})")
            del a, b

    # times at the full table: all-f32 and the dense path's configuration
    # (f32 table, bf16 moments)
    timing = {}
    for vname in ("f32", "f32_bf16m"):
        wdt, mdt, gdt = variants[vname]
        w, m, v = (x.to(dt, copy=True)
                   for x, dt in ((w32, wdt), (m32, mdt), (v32, mdt)))

        def update():
            fused_adam_cuda(w, m, v, dense_g, t, **kw)

        times = time_forms(update, lambda: fused_adam_reference(
            w, m, v, dense_g, t, **kw))
        # w, m, v read and written once, g read once
        nbytes = (2 * (w.element_size() + 2 * m.element_size())
                  + dense_g.element_size()) * w.numel()
        timing[vname] = {**times, "bound_ms": nbytes / ctx["peak_bw"] * 1e3,
                         "bytes": nbytes,
                         "cuda_launches_per_update":
                             cuda_launches_per_call(update)}
        say("kernels_time", kernel="fused_adam", variant=vname,
            **timing[vname],
            achieved_bytes_per_s=nbytes / (times["ms"] * 1e-3))
        del w, m, v
    # library yardstick: PyTorch's fused Adam on the same f32 leaf and
    # gradient (the same function for the all-f32 case)
    p = torch.nn.Parameter(w32.clone())
    p.grad = dense_g.clone()
    opt = torch.optim.Adam([p], lr=1e-3, betas=(0.9, 0.99), eps=1e-8,
                           weight_decay=1e-8 + 2e-5, fused=True)
    library_ms, library_call_ms = both_clocks(opt.step)
    say("kernels_library", kernel="fused_adam",
        call="torch.optim.Adam(fused=True) f32 dense", ms=library_ms,
        call_ms=library_call_ms)
    del p, opt
    main = timing["f32_bf16m"]
    if main["cuda_launches_per_update"] != 1:
        raise AssertionError("the dense update must be one CUDA launch, not "
                             f"{main['cuda_launches_per_update']}")
    ctx["kernel_rows"]["fused_adam"] = {
        "name": "fused_adam", "route": "cuda",
        "source": "aread_tpu_torch/ops/cuda/fused_adam.cu",
        "replaces": REPLACES["fused_adam"], "max_abs_err": worst,
        **{k: main[k] for k in ROW_TIMES},
        "bound_by": "bytes", "library_ms": library_ms,
        "library_call_ms": library_call_ms}


def amazon_rows(rng, spec, n: int):
    """Synthetic rows over the full Amazon vocab, 25 domains, labels tied
    to the item id as in make_synthetic_data (so AUC is learnable)."""
    cols = [rng.integers(0, d, size=n) for d in spec.one_hot_dims]
    seq = rng.integers(0, spec.one_hot_dims[spec.itemid_idx],
                       size=(n, spec.n_seq_fields * spec.seq_maxlen))
    x = np.concatenate([np.stack(cols, axis=1), seq], axis=1).astype(np.int32)
    logits = ((x[:, spec.itemid_idx] % 7) / 3.0 - 1.0
              + 0.3 * rng.standard_normal(n))
    return x, (logits > 0).astype(np.int8)


def build_trainer(spec, device, n_domain, n_tower=None, **cfg_kw):
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer

    cfg = Config(**cfg_kw)
    tr = AREADTrainer(build_model(cfg, spec, n_domain, n_tower=n_tower,
                                  device=device), cfg, n_domain)
    tr.init()
    return tr


# the train phase's chunks: (kind, steps). 8 warm-up steps are one short
# chunk; the bagging steps two full chunks (the first of them captures),
# a third that is profiled, and a remainder
TRAIN_CHUNKS = (("warmup", 8), ("main", 32), ("main", 32), ("main", 32),
                ("main", 8))
TIMED_CHUNK, PROFILED_CHUNK = 2, 3


def trainer_bits(tr):
    """Everything a step changes, for a bitwise comparison: the weights
    and BatchNorm statistics, the table's and the dense leaves' Adam state
    with their counters, the dropout generator's state."""
    st = tr.opt_state
    return {"state_dict": tr.model.state_dict(), "m": st["m"], "v": st["v"],
            "mu": st["inner"]["mu"], "nu": st["inner"]["nu"],
            "counts": (st["t"], st["inner"]["count"]),
            "generator": tr.generator.get_state()}


def bits_differ(a, b, path="") -> list:
    """The paths at which two ``trainer_bits`` (or tensors, tuples, dicts)
    are not bitwise equal."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [path + "/keys"]
        return [p for k in a for p in bits_differ(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path + "/len"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in bits_differ(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor):
        def raw(t):
            return t.detach().contiguous().reshape(-1).view(torch.uint8)

        same = (a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device and torch.equal(raw(a), raw(b)))
        return [] if same else [path]
    return [] if a == b else [path]


def chunk_profile(run, n: int, trace_dir=None):
    """One chunk of ``n`` steps under torch.profiler, per step: host-side
    launch calls (kernels, graphs, copies), kernels the card ran, device
    busy ms, the profiled wall ms and the idle share, and the kernel
    records of the sparse sweep (kernel 1's main kernel) and of the dense
    update (kernel 2's). With
    ``trace_dir`` the tables and a Chrome trace go there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ka = prof.key_averages()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(trace_dir, "key_averages.txt"), "w") as f:
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40))
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.self_device_time_total for e in dev) / n / 1e3

    def calls(name):
        return sum(e.count for e in ka if e.key == name) / n

    # which ops make the host-side copies: each cudaMemcpyAsync's chain of
    # enclosing ops, innermost first, three deep
    by_op = {}
    for e in prof.events():
        if e.name == "cudaMemcpyAsync":
            chain, p = [], e.cpu_parent
            while p is not None and len(chain) < 3:
                chain.append(p.name)
                p = p.cpu_parent
            key = " < ".join(chain) or "?"
            by_op[key] = by_op.get(key, 0) + 1 / n

    return out, {
        "cudaLaunchKernel": calls("cudaLaunchKernel"),
        "cudaGraphLaunch": calls("cudaGraphLaunch"),
        "cudaMemcpyAsync": calls("cudaMemcpyAsync"),
        "kernels_run": sum(e.count for e in kernels) / n,
        "device_busy_ms": busy_ms, "wall_ms_profiled": wall_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "copies_by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:6]),
        "sparse_sweeps": sum(e.count for e in kernels
                             if "adam_sweep" in e.key),
        "fused_updates": sum(e.count for e in kernels
                             if "fused_adam" in e.key)}


# profiler kernel records of each Adam kernel, by the chunk_profile key
KERNEL_RECORDS = {"sparse_adam": "sparse_sweeps", "fused_adam": "fused_updates"}


def twin_chunks(ctx, path, trs, chunks, run, timed: int, profiled: int):
    """Two trainers from one seed, ``trs['graph']`` replaying CUDA graphs
    and ``trs['eager']`` launching every step, run in turns on ``chunks``
    (each (label, feeds, ...); ``run(trainer, chunk)`` returns its
    (losses, outputs)), counted as ``path``; after every chunk the two
    must be bitwise equal (``trainer_bits`` and the chunk's outputs).
    Chunk ``timed`` is timed by CUDA events and by the host clock, chunk
    ``profiled`` runs under ``chunk_profile``, whose kernel records of
    each Adam kernel must equal its counted launches. Returns (per
    dispatch its per-step numbers, per dispatch its chunks' records, per
    dispatch its chunks' outputs, the chunks checked)."""
    from aread_tpu_torch.ops.cuda import launch_counts

    runs = {name: [] for name in trs}
    outs = {name: [] for name in trs}
    checked, miss = [], []

    def loop():
        for ci, chunk in enumerate(chunks):
            n = len(chunk[1])
            order = ("graph", "eager") if ci % 2 == 0 else ("eager", "graph")
            for name in order:
                t = trs[name]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = dict(launch_counts)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                a.record()
                if ci == profiled:
                    out, prof = chunk_profile(lambda: run(t, chunk), n)
                else:
                    out, prof = run(t, chunk), None
                b.record()
                launch_ms = (time.perf_counter() - h0) * 1e3
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - h0) * 1e3
                rec = {"chunk": ci, "kind": chunk[0], "steps": n,
                       "event_ms": a.elapsed_time(b), "wall_ms": wall_ms,
                       "launch_ms": launch_ms,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                       **{k: launch_counts[k] - before[k]
                          for k in KERNEL_RECORDS}}
                if prof is not None:
                    rec["profile"] = prof
                    miss.extend(f"{name}: the profiler saw {prof[key]} {k} "
                                f"kernels, the counts {rec[k]} (kernels run "
                                f"{prof['kernels_run'] * n:.0f})"
                                for k, key in KERNEL_RECORDS.items()
                                if prof[key] != rec[k])
                runs[name].append(rec)
                outs[name].append(out)
            bad = bits_differ(trainer_bits(trs["graph"]),
                              trainer_bits(trs["eager"]))
            bad += bits_differ(outs["graph"][-1], outs["eager"][-1], "/out")
            # the bitwise verdict first, so that a miscount says both
            if miss:
                raise AssertionError(f"{path} chunk {ci}: {'; '.join(miss)}"
                                     f"; graph {'!=' if bad else '=='} "
                                     f"eager {bad[:8]}")
            if bad:
                raise AssertionError(f"{path} chunk {ci} ({chunk[0]}): "
                                     f"graph != eager at {bad[:8]}")
            checked.append(ci)

    counted(ctx, path, loop)
    per_step = {}
    for name, rs in runs.items():
        tm, prof = rs[timed], rs[profiled]["profile"]
        n = tm["steps"]
        per_step[name] = {
            "step_ms_events": tm["event_ms"] / n,
            "step_ms_host_clock": tm["wall_ms"] / n,
            "launch_ms_per_step": tm["launch_ms"] / n,
            "examples_per_s": BS * n / (tm["wall_ms"] * 1e-3),
            "peak_mem_gb": max(r["peak_mem_gb"] for r in rs),
            **{k: v for k, v in prof.items()
               if k not in KERNEL_RECORDS.values()},
            # the profiler stretches the wall clock: the busy time over the
            # unprofiled chunk's step time
            "device_idle_share_unprofiled": 1 - prof["device_busy_ms"] / (
                tm["wall_ms"] / n)}
    return per_step, runs, outs, checked


def aread_chunks(tr, batcher, plan):
    """``plan``'s chunks ((kind, steps)) of ``batcher``'s per-domain
    batches in its domain sequence, each with its steps' domain masks from
    ``tr``'s mask state (none for warm-up): (kind, feeds, masks)."""
    ms = tr.mask_state
    seq = list(batcher.domain_batch_seq)
    chunks, k = [], 0
    for kind, n in plan:
        ds = seq[k:k + n]
        k += n
        chunks.append((kind, [batcher.next_batch(d) for d in ds],
                       [None if kind == "warmup" else ms.domain_mask[d]
                        for d in ds]))
    return chunks


def run_aread_chunk(t, chunk):
    """``twin_chunks``' ``run`` for an AREAD chunk (kind, feeds, masks)."""
    kind, feeds, masks = chunk
    return t.chunks.run(kind, feeds, masks, t.opt_state)


def train_chunks(feeds, sizes):
    """``feeds`` cut into chunks of the generic step ('train', feeds) of
    ``sizes`` steps each, and ``twin_chunks``' ``run`` for them."""
    chunks, k = [], 0
    for n in sizes:
        chunks.append(("train", feeds[k:k + n]))
        k += n

    def run(t, chunk):
        return t.chunks.run("train", chunk[1], [None] * len(chunk[1]),
                            t.opt_state)

    return chunks, run


def sync_debug_step(tr, kind: str, key: str, feeds, masks) -> None:
    """The step ``tr``'s graph ``key`` captured, its body run once eagerly
    on the first of ``feeds`` under torch.cuda.set_sync_debug_mode('error'):
    a step that waited for the device (a host read, a pageable copy)
    raises."""
    g = tr.chunks
    g._stage(g.buf[key], kind, feeds[:1], masks[:1], tr.opt_state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g._body(kind, g.buf[key], tr.opt_state)()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_train(ctx):
    """The main path at full Amazon width (bench.py's configuration and the
    config defaults), through AREADTrainer's chunk dispatch: two trainers
    from one seed, one replaying CUDA graphs (the dispatch the trainer
    takes on a card) and one launching every step eagerly, run in turns on
    the same chunks (TRAIN_CHUNKS); after every chunk the two must be
    bitwise equal. Per dispatch: step time by CUDA events over a chunk and
    by the host clock, examples/s, launches and kernels per step and the
    device's idle share (torch.profiler over one chunk, whose sparse-sweep
    kernel records must equal the counted kernel 1 launches), peak
    memory. Last, the captured step run once eagerly under
    torch.cuda.set_sync_debug_mode('error')."""
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.train.step_graph import EagerChunks

    # the config defaults are bench.py's Amazon configuration
    t0 = time.perf_counter()
    trs = {k: build_trainer(FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5), "cuda",
                            N_DOMAIN, dataset_name="amazon", seed=0)
           for k in ("graph", "eager")}
    tr = trs["graph"]
    trs["eager"]._chunks = EagerChunks(trs["eager"])
    if tr.chunks.name != "graph":
        raise AssertionError(f"a card trainer dispatches {tr.chunks.name}")
    spec, cfg = tr.model.spec, tr.config
    if (spec.n_rows, tr.model.n_tower, cfg.bs) != (1518384, (3, 6, 12), BS):
        raise AssertionError("not the Amazon configuration of bench.py")
    if bits_differ(trainer_bits(tr), trainer_bits(trs["eager"])):
        raise AssertionError("two trainers from one seed differ")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x, y = amazon_rows(rng, spec, N_DOMAIN * 5 * BS)
    ex, ey = amazon_rows(rng, spec, EVAL_BATCHES * BS)
    batcher = DomainBatcher(x, y, BS, spec.domain_idx, N_DOMAIN, seed=0)
    ctx["eval"] = (tr, (ex, ey),
                   np.bincount(x[:, spec.domain_idx], minlength=N_DOMAIN) / len(x))
    for t in trs.values():
        ms = t.mask_state
        for d in range(N_DOMAIN):
            ms.domain_mask[d] = ms.generate_mask("rand", d,
                                                 cfg.init_active_percent)
    table0 = tr.model.embedding.table.clone()
    chunks = aread_chunks(tr, batcher, TRAIN_CHUNKS)
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    per_step, runs, outs, checked = twin_chunks(
        ctx, "train", trs, chunks, run_aread_chunk, TIMED_CHUNK,
        PROFILED_CHUNK)
    loop_s = time.perf_counter() - t_loop
    launches = ctx["launches_by_path"]["train"]
    n_steps = sum(n for _, n in TRAIN_CHUNKS)
    if launches["sparse_adam"] != 2 * n_steps:
        raise AssertionError(f"sparse_adam launched "
                             f"{launches['sparse_adam']} times in "
                             f"{n_steps} steps of each dispatch")
    ctx["profile_args"] = (trs, chunks[PROFILED_CHUNK])

    losses = torch.cat([o[0] for o in outs["graph"]]).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    table = tr.model.embedding.table
    if torch.equal(table, table0):
        raise AssertionError("the table did not change")
    st = tr.opt_state
    if not (st["m"].float().abs().sum() > 0 and st["v"].float().abs().sum() > 0):
        raise AssertionError("the table's Adam moments did not change")
    if st["t"] != n_steps or tr.step_timer.summary()["dispatch"] != "graph":
        raise AssertionError(f"t={st['t']}, {tr.step_timer.summary()}")
    g = tr.chunks
    kind, feeds, masks = chunks[1]
    sync_debug_step(tr, kind, kind, feeds, masks)
    say("train", table_rows=spec.n_rows, embed_dim=cfg.embed_dim, bs=cfg.bs,
        n_tower=[3, 6, 12], chunks=[[k, n] for k, n in TRAIN_CHUNKS],
        bitwise_after_chunks=checked, init_s=init_s, loop_s=loop_s,
        per_step=per_step,
        graph_launches_per_replay={k: v.launches
                                   for k, v in g.graphs.items()},
        chunks_by_dispatch=runs, loss_first=float(losses[0]),
        loss_last=float(losses[-1]), launches=launches,
        sync_debug_error_step="passed")
    train_lazy(ctx)


# the train phase's lazy part: AREAD chunks (kind, steps), the first
# bagging chunk captures, the second is timed, the third profiled; a
# regroup of LAZY_CHAINS candidate chains at the default depth (5 + 5);
# DeepFM's chunks after its fit (steps each, the same roles)
LAZY_CHUNKS = (("warmup", 4), ("main", 16), ("main", 16), ("main", 8))
LAZY_TIMED, LAZY_PROFILED = 2, 3
LAZY_CHAINS = 6
LAZY_DENSE_CHUNKS = (8, 16, 8)
# lazy_sparse_adam_'s call in its former boolean-index form, which waited
# for the device (NVIDIA H100 80GB HBM3, 700 W; PERF.md): ms a call, host
# included, printed beside the static form's
LAZY_CALL_MS_BOOLEAN_INDEX = (0.8, 1.5)


def no_launches(ctx, *paths) -> None:
    """The lazy update launches no kernel of ours: every count 0."""
    for path in paths:
        got = ctx["launches_by_path"][path]
        if any(got.values()):
            raise AssertionError(f"{path} launched {got} under lazy_adam")


def lazy_call(dma) -> dict:
    """lazy_sparse_adam_ alone on the probe's bf16 Amazon table and batch,
    reading a staged scalar block: by the eager call and by one replay of
    its captured CUDA graph, the two bitwise from one state; per call the
    ms (CUDA events around one call, median of 10, and back to back), the
    host clock, launch calls, kernels and device busy ms (torch.profiler
    over 5 calls)."""
    from aread_tpu_torch.ops.sparse_adam import (lazy_sparse_adam_,
                                                 step_scalars, to_device)

    w, m, v, uids, gsum = dma.lazy_inputs(BS, "cuda")
    block = to_device(step_scalars(1, SPARSE_KW["lr"]), "cuda")

    def call():
        lazy_sparse_adam_(w, m, v, uids, gsum, 1, scalars=block, **SPARSE_KW)

    start = [x.clone() for x in (w, m, v)]

    def restore():
        for x, x0 in zip((w, m, v), start):
            x.copy_(x0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        call()
    torch.cuda.current_stream().wait_stream(side)
    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    graph.replay()
    by_graph = [x.clone() for x in (w, m, v)]
    restore()
    call()
    bad = bits_differ(by_graph, [w, m, v])
    if bad:
        raise AssertionError(f"lazy_sparse_adam_: replay != call at {bad}")
    out = {"table": [list(w.shape), str(w.dtype)],
           "touched_rows": int((uids < w.shape[0]).sum()),
           "replay_bitwise_call": True}
    for name, fn in (("eager", call), ("graph", graph.replay)):
        ev, host = event_ms(fn)
        _, prof = chunk_profile(lambda: [fn() for _ in range(5)], 5)
        out[name] = {"call_ms_events": ev, "call_ms_host_clock": host,
                     "ms_back_to_back": device_time_ms(fn),
                     **{k: prof[k] for k in (
                         "cudaLaunchKernel", "cudaGraphLaunch",
                         "cudaMemcpyAsync", "kernels_run",
                         "device_busy_ms")}}
    return out


def train_lazy(ctx):
    """table_optimizer='lazy_adam' at full Amazon width, each path by CUDA
    graph replays and by its eager twin from one seed, required bitwise:
    (a) AREAD's warm-up and bagging steps in turns on LAZY_CHUNKS
    (``twin_chunks``: per dispatch ms a step, launches, kernels, busy ms,
    idle share) and a captured bagging step under sync debug mode
    'error'; (b) a regroup of LAZY_CHAINS full-sweep candidate chains at
    the default depth (5 + 5) in turns (``chain_twins``), ms a chain of
    each dispatch (``chain_replays``) and a chain under sync debug mode
    'error'; (c) DeepFM at the CLI defaults through Trainer.fit
    (``fit_twins``), then its steps in turns on LAZY_DENSE_CHUNKS; (d)
    lazy_sparse_adam_ alone (``lazy_call``). No kernel of ours runs on
    these paths: every count stays 0."""
    from aread_tpu_torch.benchmarks import prof_dma_issue as dma
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher, GlobalBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    spec = amazon_spec()

    def make():
        t = build_trainer(spec, "cuda", N_DOMAIN, dataset_name="amazon",
                          seed=0, table_optimizer="lazy_adam")
        for d in range(N_DOMAIN):
            t.mask_state.domain_mask[d] = t.mask_state.generate_mask(
                "rand", d, t.config.init_active_percent)
        return t

    # (a) the AREAD steps
    trs = chain_twin_trainers(make)
    tr = trs["graph"]
    cfg = tr.config
    if (cfg.table_optimizer, cfg.table_dtype, cfg.table_moments_dtype,
            tr.model.embedding.table.shape[0]) != (
            "lazy_adam", "bfloat16", "bfloat16", 1518384):
        raise AssertionError("not the Amazon configuration under lazy_adam")
    rng = np.random.default_rng(5)
    x, y = amazon_rows(rng, spec, N_DOMAIN * 5 * BS)
    chunks = aread_chunks(tr, DomainBatcher(x, y, BS, spec.domain_idx,
                                            N_DOMAIN, seed=0), LAZY_CHUNKS)

    per_step, runs, outs, checked = twin_chunks(
        ctx, "train/lazy", trs, chunks, run_aread_chunk, LAZY_TIMED,
        LAZY_PROFILED)
    no_launches(ctx, "train/lazy")
    losses = torch.cat([o[0] for o in outs["graph"]]).cpu().numpy()
    n_steps = sum(n for _, n in LAZY_CHUNKS)
    if not np.isfinite(losses).all() or tr.opt_state["t"] != n_steps:
        raise AssertionError(f"lazy: losses {losses}, t={tr.opt_state['t']}")
    say("train", part="lazy_step", table_optimizer="lazy_adam",
        chunks=[[k, n] for k, n in LAZY_CHUNKS],
        bitwise_after_chunks=checked, per_step=per_step,
        chunk_event_ms={k: [r["event_ms"] for r in rs]
                        for k, rs in runs.items()},
        graph_launches_per_replay={k: v.launches
                                   for k, v in tr.chunks.graphs.items()},
        captures=tr.chunks.captures,
        launches=ctx["launches_by_path"]["train/lazy"],
        loss_first=float(losses[0]), loss_last=float(losses[-1]))

    # (b) a regroup's chains at the default depth
    if (cfg.regroup_update_step, cfg.regroup_eval_step) != (5, 5):
        raise AssertionError("not the default chain depth")
    inputs = chain_inputs(tr, DomainBatcher(x, y, BS, spec.domain_idx,
                                            N_DOMAIN, seed=1), LAZY_CHAINS)
    zero = {"sparse_adam": 0, "fused_adam": 0}
    chain_runs = chain_twins(ctx, "train/lazy_chain", trs, inputs, False,
                             (("graph", "eager"), ("eager", "graph")), zero)
    per_chain = {name: chain_replays(t, inputs, False, ctx,
                                     f"train/lazy_chain_replays_{name}")
                 for name, t in trs.items()}
    # last, since they move the graph trainer past its twin: a chain
    # (which restores the weights) and a step under sync debug 'error'
    sync_debug_chain(tr, inputs, False)
    kind, feeds, masks = chunks[1]
    sync_debug_step(tr, kind, kind, feeds, masks)
    say("train", part="lazy_chain", candidates=LAZY_CHAINS,
        adapt_steps=5, probes=5, engine="full", feed="host batches",
        regroups=chain_runs, bitwise_graph_eager=True,
        per_chain=per_chain, captures=tr.chunks.captures,
        graph_launches_per_replay={k: v.launches
                                   for k, v in tr.chunks.graphs.items()},
        sync_debug_error_chain="passed", sync_debug_error_step="passed")
    del trs, tr, chunks, outs
    torch.cuda.empty_cache()

    # (c) DeepFM through Trainer.fit, then its steps
    dcfg = Config(model="deepfm", dataset_name="amazon", seed=0,
                  table_optimizer="lazy_adam")
    if (dcfg.sparse_table_grad, dcfg.table_dtype,
            dcfg.table_moments_dtype) != (True, "bfloat16", "bfloat16"):
        raise AssertionError("not the CLI defaults")
    data = amazon_split(np.random.default_rng(7), 24 * BS, 4096)
    trs, res, fit_s = fit_twins(
        ctx, "train/lazy_fit",
        lambda: Trainer(build_model(dcfg, spec, N_DOMAIN, device="cuda"),
                        dcfg, N_DOMAIN),
        lambda t: t.fit(data, epochs=1, verbose=False))
    no_launches(ctx, "train/lazy_fit", "train/lazy_fit_eager")
    check_metrics("lazy deepfm", (("valid", res["graph"]["history"][0]),
                                  ("test", res["graph"]["test"])))
    g = trs["graph"]
    if g.chunks.captures != 1:
        raise AssertionError(f"lazy deepfm fit: {g.chunks.captures} captures")
    dx, dy = amazon_rows(np.random.default_rng(8), spec,
                         sum(LAZY_DENSE_CHUNKS) * BS)
    dchunks, drun = train_chunks(
        list(GlobalBatcher(dx, dy, BS, spec.domain_idx, None, seed=1)),
        LAZY_DENSE_CHUNKS)
    dper_step, druns, _, dchecked = twin_chunks(
        ctx, "train/lazy_deepfm_steps", trs, dchunks, drun, 1, 2)
    no_launches(ctx, "train/lazy_deepfm_steps")
    sync_debug_step(g, "train", "train", dchunks[1][1], [None])
    say("train", part="lazy_fit", model="deepfm",
        table=[list(g.model.embedding.table.shape),
               str(g.model.embedding.table.dtype)],
        fit_steps=24, fit_s=fit_s, bitwise_graph_eager=True,
        valid_total_auc=res["graph"]["history"][0]["total_auc"],
        test_total_auc=res["graph"]["test"]["total_auc"],
        chunks=list(LAZY_DENSE_CHUNKS), bitwise_after_chunks=dchecked,
        per_step=dper_step,
        chunk_event_ms={k: [r["event_ms"] for r in rs]
                        for k, rs in druns.items()},
        captures=g.chunks.captures, sync_debug_error_step="passed")
    del trs, g, res
    torch.cuda.empty_cache()

    # (d) the update alone
    say("train", part="lazy_call", **lazy_call(dma),
        boolean_index_form_call_ms=list(LAZY_CALL_MS_BOOLEAN_INDEX))


# the eval phase's split: at least this many per-domain batches of BS rows
# for AREAD, and as many batches of 8 * BS rows for DeepFM
EVAL_BATCHES = 100
# batches of a pass run under the profiler
EVAL_PROFILED = 32


@contextlib.contextmanager
def eager_evals(*owners):
    """Inside, ``owners`` (trainers or Predictors) evaluate and serve by
    their eager twin: the dispatch rule, ``step_graph.eval_dispatch``,
    answers False for them and their runners are made anew; afterwards
    their graph runners, graphs and all, are back."""
    from aread_tpu_torch.train import step_graph

    rule = step_graph.eval_dispatch
    saved = [(o, o._evals) for o in owners]
    step_graph.eval_dispatch = lambda t: (all(t is not o for o in owners)
                                          and rule(t))
    try:
        for o in owners:
            o._evals = None
            if o.evals.name != "eager":
                raise AssertionError("the eager twin dispatched "
                                     f"{o.evals.name}")
        yield
    finally:
        step_graph.eval_dispatch = rule
        for o, runner in saved:
            o._evals = runner


def spied_pass(tr, call):
    """One evaluation ``call()`` of ``tr``: (its result, the pass's output
    or, for a streaming pass, its histograms, copied; the batches, the
    seconds by the host clock, the ms by CUDA events)."""
    runner = tr.evals
    got = []
    real = runner.run_eval

    def run_eval(ev, feeds, masks=None):
        out = real(ev, feeds, masks)
        got.append((len(feeds), None if out is None else out.clone()))
        return out

    runner.run_eval = run_eval
    try:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        res = call()
        b.record()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del runner.run_eval
    n, out = got[-1]
    if out is None:
        out = {k: v.clone() for k, v in tr._auc_state.items()}
    return res, out, n, secs, a.elapsed_time(b)


def eval_twins(path: str, tr, cases, profile):
    """Each case ``(label, call)`` (an evaluate of ``tr``) by CUDA graph
    replays and by the eager twin (``eager_evals``) in turns; the two must
    leave bitwise the same result, predictions or histograms, and
    weights. Per dispatch: the evaluate's seconds and ms a batch by CUDA
    events and by the host clock (the metrics on the host included);
    ``profile(label)`` (``run_eval`` over EVAL_PROFILED staged batches,
    the device path alone) by both clocks, then under torch.profiler for
    launch calls, kernels and busy ms a batch, and the idle share of its
    unprofiled time. Returns the per-case records."""
    out = {}
    for ci, (label, call) in enumerate(cases):
        order = ("graph", "eager") if ci % 2 == 0 else ("eager", "graph")
        rec, seen = {}, {}
        for name in order:
            with (contextlib.nullcontext() if name == "graph"
                  else eager_evals(tr)):
                if tr.evals.name != name:
                    raise AssertionError(f"{path} {label}: dispatched "
                                         f"{tr.evals.name}, not {name}")
                res, got, n, secs, ev_ms = spied_pass(tr, call)
                run_ev, run_host = event_ms(lambda: profile(label), n=3,
                                            warmup=1)
                _, prof = chunk_profile(lambda: profile(label),
                                        EVAL_PROFILED)
            seen[name] = (res, got, {k: v.clone() for k, v in
                                     tr.model.state_dict().items()})
            run_ms = run_host / EVAL_PROFILED
            rec[name] = {"batches": n, "pass_s": secs,
                         "batch_ms_events": ev_ms / n,
                         "batch_ms_host_clock": secs * 1e3 / n,
                         "run_eval_batch_ms_events": run_ev / EVAL_PROFILED,
                         "run_eval_batch_ms_host_clock": run_ms,
                         **{k: prof[k] for k in (
                             "cudaLaunchKernel", "cudaGraphLaunch",
                             "cudaMemcpyAsync", "kernels_run",
                             "device_busy_ms")},
                         "device_idle_share_unprofiled":
                             1 - prof["device_busy_ms"] / run_ms}
        bad = bits_differ(seen["graph"][1:], seen["eager"][1:])
        if bad or not fit_results_equal({"history": [], "test": seen[
                "graph"][0]}, {"history": [], "test": seen["eager"][0]}):
            raise AssertionError(f"{path} {label}: graph != eager at "
                                 f"{bad[:8]}")
        rec["bitwise"] = True
        out[label] = rec
    return out


def sync_debug_eval(tr, ev, feeds, masks=None) -> None:
    """The first of ``feeds`` through the body that ``tr``'s graph of the
    pass ``ev`` captured, run eagerly under
    torch.cuda.set_sync_debug_mode('error'): a body that waited for the
    device (a host read, a pageable copy) raises."""
    g = tr.evals
    masks = [None] * len(feeds) if masks is None else masks
    buf = g.buf[g.eval_key(ev, feeds[0], masks[0])]
    g.stage_eval(buf, feeds[:1], masks[:1])
    buf["o"].zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            g.eval_body(ev, buf)()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_eval(ctx):
    """Evaluation at full Amazon width by CUDA graph replays (one a batch,
    train/step_graph.py run_eval) and by its eager twin, in turns
    (``eval_twins``): the train phase's AREAD trainer over EVAL_BATCHES
    per-domain batches of BS rows in both modes ('domain_with_mask' and,
    ``final``, 'domain_mask_final'), exact and streaming; then DeepFM's
    Trainer.evaluate over EVAL_BATCHES batches of 8 * BS rows; a captured
    batch under sync debug mode 'error'."""
    import dataclasses

    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    tr, (ex, ey), weight = ctx["eval"]
    spec, cfg = tr.model.spec, tr.config
    if tr.evals is not tr.chunks or tr.evals.name != "graph":
        raise AssertionError("the card's AREAD trainer does not evaluate "
                             "through its graph runner")

    def batcher():
        return DomainBatcher(ex, ey, BS, spec.domain_idx, N_DOMAIN,
                             shuffle=False)

    def aread_case(final, streaming):
        def call():
            tr.config = dataclasses.replace(cfg, streaming_eval=streaming)
            try:
                return tr.evaluate(batcher(), weight, final=final)
            finally:
                tr.config = cfg
        return (f"{'final' if final else 'domain_with_mask'}_"
                f"{'streaming' if streaming else 'exact'}", call)

    feeds, masks = tr.eval_batches(batcher())
    if len(feeds) < EVAL_BATCHES:
        raise AssertionError(f"{len(feeds)} eval batches")

    def aread_profile(label):
        final, streaming = label.startswith("final"), label.endswith(
            "streaming")
        tr.evals.run_eval(tr.eval_pass(final, streaming),
                          feeds[:EVAL_PROFILED], masks[:EVAL_PROFILED])

    t0 = time.perf_counter()
    aread = eval_twins("eval/aread", tr, [
        aread_case(f, s) for f in (False, True) for s in (False, True)],
        aread_profile)
    aread_s = time.perf_counter() - t0
    res = tr.evaluate(batcher(), weight)
    check_metrics("eval", [("aread", res)])
    sync_debug_eval(tr, tr.eval_pass(), feeds, masks)
    say("eval", model="aread", total_auc=res["total_auc"],
        mean_auc=res["mean_auc"], total_loss=res["total_loss"],
        n_batches=len(feeds), rows_per_batch=BS, cases=aread,
        eval_captures=tr.evals.eval_captures, twins_s=aread_s,
        sync_debug_error_batch="passed")

    # DeepFM through the generic Trainer: 8 * BS rows a batch
    dcfg = Config(model="deepfm", dataset_name="amazon", seed=0,
                  sparse_table_grad=False, table_dtype="float32")
    dtr = Trainer(build_model(dcfg, spec, N_DOMAIN, device="cuda"), dcfg,
                  N_DOMAIN)
    dx, dy = amazon_rows(np.random.default_rng(2), spec,
                         EVAL_BATCHES * 8 * BS)
    dfeeds = dtr.eval_batches(dx, dy)

    def deepfm_case(streaming):
        def call():
            dtr.config = dataclasses.replace(dcfg, streaming_eval=streaming)
            try:
                return dtr.evaluate(dx, dy, weight)
            finally:
                dtr.config = dcfg
        return "streaming" if streaming else "exact", call

    deepfm = eval_twins(
        "eval/deepfm", dtr, [deepfm_case(False), deepfm_case(True)],
        lambda label: dtr.evals.run_eval(
            dtr.eval_pass("accum" if label == "streaming" else "eval_step"),
            dfeeds[:EVAL_PROFILED]))
    dres = dtr.evaluate(dx, dy, weight)
    check_metrics("eval", [("deepfm", dres)])
    say("eval", model="deepfm", total_auc=dres["total_auc"],
        total_loss=dres["total_loss"], n_batches=len(dfeeds),
        rows_per_batch=8 * BS, cases=deepfm,
        eval_captures=dtr.evals.eval_captures)


def timed_steps(tr, batches):
    """Median CUDA-event time of ``tr.step`` over ``batches`` (ms), and the
    losses."""
    losses, events = [], []
    for batch in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(tr.step(batch))
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    return statistics.median(a.elapsed_time(b) for a, b in events), losses


# the train_dense phase's graph-and-eager chunks of DeepFM steps: the
# first full chunk captures, the second is timed, the third, a remainder,
# is profiled (the profiler costs seconds a chunk of eager steps)
DENSE_CHUNKS = (32, 32, 8)
DENSE_TIMED, DENSE_PROFILED = 1, 2


def dense_twins(ctx, make, spec, d2g, sparse: bool, resident: bool,
                compute_dtype: str = "float32"):
    """The generic Trainer's chunk dispatch at full Amazon width: two
    DeepFM trainers from one seed (f32 table, bf16 moments), one replaying
    CUDA graphs and one launching every step, in turns on DENSE_CHUNKS of
    one epoch's batches (``twin_chunks``), fed host batches or row ids
    into the resident split; the table's update is kernel 1 (``sparse``)
    or kernel 2; ``compute_dtype='bfloat16'``: the products' bf16 pass,
    set around the step and so held by the capture. Their launches are
    held to two per step, and the captured step runs once under sync
    debug mode 'error'."""
    from aread_tpu_torch.data.loader import GlobalBatcher
    from aread_tpu_torch.train.step_graph import EagerChunks

    trs = {k: make("deepfm", sparse, compute_dtype=compute_dtype)
           for k in ("graph", "eager")}
    for t in trs.values():
        t.init()
    trs["eager"]._chunks = EagerChunks(trs["eager"])
    g = trs["graph"]
    if g.chunks.name != "graph":
        raise AssertionError(f"a card Trainer dispatches {g.chunks.name}")
    if bits_differ(trainer_bits(g), trainer_bits(trs["eager"])):
        raise AssertionError("two trainers from one seed differ")
    n_steps = sum(DENSE_CHUNKS)
    x, y = amazon_rows(np.random.default_rng(8), spec, n_steps * BS)
    batcher = GlobalBatcher(x, y, BS, spec.domain_idx, d2g, seed=1)
    if resident:
        for t in trs.values():
            t.stage_device_data(batcher)
        feeds = list(batcher.epoch_perm())
    else:
        feeds = list(batcher)
    chunks, run = train_chunks(feeds, DENSE_CHUNKS)
    grad, feed = ("sparse" if sparse else "dense",
                  "resident" if resident else "host")
    path = f"train_dense/deepfm_{grad}_{feed}" + (
        "" if compute_dtype == "float32" else f"_{compute_dtype}")
    per_step, runs, outs, checked = twin_chunks(
        ctx, path, trs, chunks, run, DENSE_TIMED, DENSE_PROFILED)
    kernel = "sparse_adam" if sparse else "fused_adam"
    launches = ctx["launches_by_path"][path]
    want = {"sparse_adam": 0, "fused_adam": 0, kernel: 2 * n_steps}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, want {want}")
    losses = torch.cat([o[0] for o in outs["graph"]]).cpu().numpy()
    if not np.isfinite(losses).all() or g.opt_state["t"] != n_steps:
        raise AssertionError(f"{path}: losses {losses}, t={g.opt_state['t']}")
    sync_debug_step(g, "train", "train_idx" if resident else "train",
                    chunks[1][1], [None])
    table = g.model.embedding.table
    say("train_dense", part="graph_vs_eager", model="deepfm",
        table_grad=grad, feed=feed, compute_dtype=compute_dtype,
        table=[list(table.shape), str(table.dtype)],
        moments=str(g.opt_state["m"].dtype), chunks=list(DENSE_CHUNKS),
        bitwise_after_chunks=checked, per_step=per_step,
        chunk_event_ms={k: [r["event_ms"] for r in rs]
                        for k, rs in runs.items()},
        graph_launches_per_replay={k: v.launches
                                   for k, v in g.chunks.graphs.items()},
        captures=g.chunks.captures, launches=launches,
        loss_first=float(losses[0]), loss_last=float(losses[-1]),
        sync_debug_error_step="passed")


def phase_train_dense(ctx):
    """The generic Trainer at full Amazon width. DeepFM with the dense
    table gradient, an f32 table and bf16 moments — the configuration in
    which the JAX package reaches its fused-Adam Pallas kernel — through
    build_model and Trainer.fit: one epoch of 24 steps, the valid pass, the
    test pass with the best weights. Then timed steps of the same trainer,
    a few dense steps each of DCN and MMoE (3 towers, DCN and attention
    side nets, Amazon domain2group), and DeepFM steps with the sparse
    table gradient (the sparse-Adam kernel through the same Trainer). Last,
    the chunk dispatch graph against eager (``dense_twins``) for each
    table gradient, from host batches and from the resident split."""
    from aread_tpu_torch.config import DOMAIN2GROUP, Config
    from aread_tpu_torch.data.loader import GlobalBatcher, SplitData
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.train.trainer import Trainer, dense_table_grad

    torch.cuda.reset_peak_memory_stats()
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    rng = np.random.default_rng(0)
    n_steps, n_eval = 24, 4096
    x, y = amazon_rows(rng, spec, n_steps * BS + 2 * n_eval)
    n_train = n_steps * BS
    data = SplitData(
        train_x=x[:n_train], train_y=y[:n_train],
        valid_x=x[n_train:n_train + n_eval], valid_y=y[n_train:n_train + n_eval],
        test_x=x[n_train + n_eval:], test_y=y[n_train + n_eval:], spec=spec,
        domain_cnt_weight=np.bincount(x[:n_train, spec.domain_idx],
                                      minlength=N_DOMAIN) / n_train,
        n_domain=N_DOMAIN)
    d2g = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])

    def make(model, sparse=False, **kw):
        cfg = Config(model=model, dataset_name="amazon", seed=0,
                     sparse_table_grad=sparse, table_dtype="float32", **kw)
        if (cfg.bs, cfg.embed_dim, cfg.table_moments_dtype, cfg.dropout) != (
                BS, EMBED_DIM, "bfloat16", 0.2):
            raise AssertionError("not the Amazon defaults")
        return Trainer(build_model(cfg, spec, N_DOMAIN, device="cuda"), cfg,
                       N_DOMAIN, d2g)

    def step_batches(tr, n):
        batcher = GlobalBatcher(data.train_x, data.train_y, BS,
                                spec.domain_idx, d2g, seed=1)
        return [tr.place(b) for b, _ in zip(batcher, range(n))]

    # --- DeepFM, dense table gradient, through fit
    t0 = time.perf_counter()
    tr = make("deepfm")
    table = tr.model.embedding.table
    if tuple(table.shape) != (1518382, EMBED_DIM) or table.dtype != torch.float32:
        raise AssertionError(f"table {tuple(table.shape)} {table.dtype}")
    table0 = table.clone()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = counted(ctx, "train_dense/deepfm_fit",
                  lambda: tr.fit(data, epochs=1, verbose=False))
    fit_s = time.perf_counter() - t0
    launches = ctx["launches_by_path"]["train_dense/deepfm_fit"]
    if launches != {"sparse_adam": 0, "fused_adam": n_steps}:
        raise AssertionError(f"fit of {n_steps} dense steps launched {launches}")
    if res["dispatch"] != "graph":
        raise AssertionError(f"a card fit dispatched {res['dispatch']}")
    hist = res["history"][0]
    for name, r in (("valid", hist), ("test", res["test"])):
        for k in ("total_auc", "mean_auc", "total_loss"):
            if not np.isfinite(r[k]) or (k.endswith("auc")
                                         and not 0 <= r[k] <= 1):
                raise AssertionError(f"{name} {k}={r[k]}")
    if not np.isfinite(hist["train_loss"]):
        raise AssertionError(f"train loss {hist['train_loss']}")
    st = tr.opt_state
    if torch.equal(table, table0) or not (
            st["m"].float().abs().sum() > 0 and st["v"].float().abs().sum() > 0):
        raise AssertionError("the table or its Adam moments did not change")
    if st["t"] != n_steps or st["m"].dtype != torch.bfloat16:
        raise AssertionError(f"t={st['t']}, moments {st['m'].dtype}")
    del table0
    batches = step_batches(tr, 16)
    step_ms, _ = counted(ctx, "train_dense/deepfm_steps",
                         lambda: timed_steps(tr, batches))
    # the dense gradient's build alone, on one batch's ids
    ids = tr.model.embedding.table_ids(batches[0]["x"])
    row_grads = torch.randn(ids.shape + (EMBED_DIM,), device="cuda")
    dense_grad_ms = cuda_time_ms(lambda: dense_table_grad(
        ids, row_grads, table.shape[0], torch.float32))
    say("train_dense", model="deepfm", table_rows=table.shape[0],
        embed_dim=EMBED_DIM, bs=BS, table_dtype="float32",
        moments_dtype="bfloat16", fit_steps=n_steps, init_s=init_s,
        fit_s=fit_s, train_loss=hist["train_loss"],
        fit_examples_per_s_host_clock=hist["examples_per_s"],
        valid_total_auc=hist["total_auc"], valid_mean_auc=hist["mean_auc"],
        test_total_auc=res["test"]["total_auc"],
        test_mean_auc=res["test"]["mean_auc"], fit_launches=launches,
        fit_dispatch=res["dispatch"],
        step_ms_median=step_ms, examples_per_s=BS / (step_ms * 1e-3),
        dense_grad_build_ms=dense_grad_ms,
        step_launches=ctx["launches_by_path"]["train_dense/deepfm_steps"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    ctx["dense_profile_args"] = (tr, batches)
    ctx["dense"] = {"deepfm": tr, "data": data, "d2g": d2g, "make": make}

    # --- DCN and MMoE, dense; DeepFM, sparse table gradient
    for model, sparse, n in (("dcn", False, 6), ("mmoe", False, 6),
                             ("deepfm", True, 6)):
        tr2 = make(model, sparse)
        tr2.init()
        path = f"train_dense/{model}_{'sparse' if sparse else 'dense'}"
        ms_, losses = counted(ctx, path,
                              lambda: timed_steps(tr2, step_batches(tr2, n)))
        want = ({"sparse_adam": n, "fused_adam": 0} if sparse
                else {"sparse_adam": 0, "fused_adam": n})
        if ctx["launches_by_path"][path] != want:
            raise AssertionError(f"{path}: launches "
                                 f"{ctx['launches_by_path'][path]}")
        line = dict(model=model, sparse_table_grad=sparse, steps=n,
                    table_rows=tr2.model.embedding.table.shape[0],
                    step_ms_median=ms_, loss_first=float(losses[0]),
                    loss_last=float(losses[-1]),
                    launches=ctx["launches_by_path"][path])
        if model == "mmoe":
            out = tr2.model(batches[0]["x"], train=False)
            if tuple(out["logit"].shape) != (BS, 3):
                raise AssertionError(f"mmoe logit {tuple(out['logit'].shape)}")
            line["n_tower"] = 3
            ctx["dense"]["mmoe"] = tr2
        say("train_dense", **line)
        del tr2

    # --- graph against eager, dense and sparse table gradient, host
    # batches and the resident split
    for sparse in (False, True):
        for resident in (False, True):
            dense_twins(ctx, make, spec, d2g, sparse, resident)
            torch.cuda.empty_cache()
    # the bf16 products under capture
    dense_twins(ctx, make, spec, d2g, False, False, "bfloat16")


def true_zero_adam(pre_bn_bias: str, lr: float, wd: float,
                   atten_dim: int = 0, constant_rows=None):
    """DenseAdam that gives the linear biases feeding a BatchNorm their
    true gradient, exactly 0: the computed one is round-off, which Adam
    would normalize into a step of up to lr on either device. With
    ``atten_dim``, so does the key slice [atten_dim, 2 * atten_dim) of
    every self-attention in-projection bias; with ``constant_rows`` =
    (name, slice), so do those rows of that kernel (a kernel feeding a
    BatchNorm, its rows fed by an input that is constant over the batch:
    the domain field's embedding in a single-domain batch)."""
    import re

    from aread_tpu_torch.train.trainer import DenseAdam

    pat = re.compile(pre_bn_bias)
    in_proj = re.compile(r"(^|/)attn_\d+/in_proj_bias$")

    def true_zero(n, g):
        if pat.match(n):
            return torch.zeros_like(g)
        if atten_dim and in_proj.search(n):
            g = g.clone()
            g[atten_dim:2 * atten_dim] = 0
        if constant_rows is not None and n == constant_rows[0]:
            g = g.clone()
            g[constant_rows[1]] = 0
        return g

    class DenseAdamTrueZero(DenseAdam):
        def update_(self, params, grads, state, scalars=None):
            super().update_(params, {n: true_zero(n, g)
                                     for n, g in grads.items()}, state,
                            scalars)

    return DenseAdamTrueZero(lr=lr, wd=wd)


def state_diffs(cpu_tr, gpu_tr, losses):
    diffs = {"loss": float(np.max(np.abs(np.subtract(losses["cpu"],
                                                     losses["cuda"]))))}
    gsd = gpu_tr.model.state_dict()
    for k, v in cpu_tr.model.state_dict().items():
        diffs[k] = float((v.float() - gsd[k].float().cpu()).abs().max())
    for k in ("m", "v"):
        diffs[k] = float((cpu_tr.opt_state[k]
                          - gpu_tr.opt_state[k].cpu()).abs().max())
    worst = max(diffs, key=diffs.get)
    return worst, diffs[worst]


def reference_dense(ctx):
    """Three dense DeepFM steps of the generic Trainer from the same
    weights on the card (fused-Adam kernel) and on the CPU (plain
    version): small width, f32 table and moments, dropout 0, with the
    global-norm clip on; atol 1e-5."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    data = make_synthetic_data(n_rows=2048, n_domain=4, vocab=300, seed=3)
    trainers = {}
    for dev in ("cpu", "cuda"):
        cfg = Config(model="deepfm", embed_dim=8, dropout=0.0,
                     sparse_table_grad=False, table_dtype="float32",
                     table_moments_dtype="float32", grad_clip_norm=0.5)
        tr = Trainer(build_model(cfg, data.spec, 4, device=dev), cfg, 4)
        tr.optimizer = true_zero_adam(r"^mlp/linear_\d+/bias$", cfg.lr, cfg.wd)
        tr.init()
        trainers[dev] = tr
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    losses = {dev: [] for dev in trainers}

    def steps():
        for step in range(3):
            sl = slice(256 * step, 256 * (step + 1))
            batch = pad_batch(data.train_x[sl], data.train_y[sl], 256)
            for dev, tr in trainers.items():
                losses[dev].append(float(tr.step(batch)))

    counted(ctx, "reference_dense", steps)
    if ctx["launches_by_path"].pop("reference_dense")["fused_adam"] != 3:
        raise AssertionError("the card's dense steps did not launch "
                             "fused_adam once each")
    worst, diff = state_diffs(trainers["cpu"], trainers["cuda"], losses)
    if diff > 1e-5:
        raise AssertionError(f"dense DeepFM: card and CPU disagree after 3 "
                             f"steps: {worst} {diff}")
    say("reference", path="deepfm dense Trainer.step", steps=3,
        max_abs_diff=diff, worst=worst, tolerance=1e-5)


def phase_reference(ctx):
    reference_aread(ctx)
    reference_dense(ctx)
    reference_evolution(ctx)


def spy_evolutions(tr):
    """Make ``tr`` keep, per evolution, the masks and the main optimizer's
    t before and after it and what it handed to update_all_mask (the
    candidates' pruned masks and probe losses, which the evolution resets
    when it ends). Returns the list the records go to."""
    records = []
    ms = tr.mask_state
    evolve, update = tr._mask_evolution, ms.update_all_mask

    def update_all_mask():
        records[-1]["losses"] = [[list(z) for z in d] for d in ms.eval_loss]
        records[-1]["candidates"] = [[[np.array(l) for l in m] for m in d]
                                     for d in ms.candidate_domain_mask]
        update()

    def mask_evolution(*a, **kw):
        records.append({"before": tr._copy_masks(), "t": tr.opt_state["t"]})
        evolve(*a, **kw)
        records[-1].update(after=tr._copy_masks(), t_after=tr.opt_state["t"])

    ms.update_all_mask = update_all_mask
    tr._mask_evolution = mask_evolution
    return records


def masks_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def reference_evolution(ctx):
    """One mask evolution at full Amazon width (2 domains, 2 candidates
    each, 2 adapt steps and 2 probes a chain) from the same weights on the
    card (kernel) and on the CPU (plain version): f32 table and moments,
    dropout 0, the pre-BatchNorm biases at their true zero gradient. Every
    candidate's pruned mask and the chosen masks must be equal, the probe
    losses agree at atol 1e-5 plus two f32 ulps of their size: a probe
    loss holds the table's L2 term, in the hundreds at this width, where
    one ulp is 6.1e-5."""
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models.base import FeatureSpec

    n_domain = 2
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    rng = np.random.default_rng(5)
    x, y = amazon_rows(rng, spec, 8 * BS)
    x[:, spec.domain_idx] = rng.integers(0, n_domain, size=len(x))
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = build_trainer(
            spec, dev, n_domain, n_tower=3, dataset_name="amazon", seed=0,
            dropout=0.0,
            table_dtype="float32", table_moments_dtype="float32",
            regroup_update_step=2, regroup_eval_step=2, candidate_mask_num=3)
        pat = r"^(mmoe_experts|towers_\d+)/linear_\d+/bias$"
        tr.optimizer = true_zero_adam(pat, tr.config.lr, tr.config.wd)
        tr.fast_optimizer = true_zero_adam(pat, tr.config.update_lr,
                                           tr.config.wd)
        if dev == "cuda":
            tr.model.load_state_dict(runs["cpu"][0].model.state_dict())
        if (tr.model.spec.n_rows, tr.model.n_tower) != (1518384, (3, 6, 12)):
            raise AssertionError("not the Amazon width")
        runs[dev] = (tr, spy_evolutions(tr))
    for dev, (tr, _) in runs.items():
        batchers = [DomainBatcher(x, y, BS, spec.domain_idx, n_domain, seed=s)
                    for s in (1, 2)]
        t0 = time.perf_counter()
        if dev == "cuda":
            counted(ctx, "reference_evolution",
                    lambda: tr._mask_evolution(*batchers, verbose=False))
        else:
            tr._mask_evolution(*batchers, verbose=False)
        runs[dev] += (time.perf_counter() - t0,)
    launches = ctx["launches_by_path"].pop("reference_evolution")
    if launches["sparse_adam"] != n_domain * 2 * 2:
        raise AssertionError(f"the card's evolution launched {launches}")
    dispatch = runs["cuda"][0].regroup_log[-1]["dispatch"]
    if dispatch != "graph":
        raise AssertionError(f"the card's chains ran {dispatch}")
    cpu, gpu = runs["cpu"][1][0], runs["cuda"][1][0]
    diff = 0.0
    for d in range(n_domain):
        for a, b in zip(cpu["candidates"][d], gpu["candidates"][d]):
            if not masks_equal(a, b):
                raise AssertionError(f"domain {d}: a candidate's pruned mask "
                                     "differs between card and CPU")
        if not masks_equal(cpu["after"][d], gpu["after"][d]):
            raise AssertionError(f"domain {d}: card and CPU chose another mask")
        a, b = np.array(cpu["losses"][d]), np.array(gpu["losses"][d])
        diff = max(diff, float(np.max(np.abs(a - b))))
        if not np.allclose(a, b, rtol=2 * 2.0 ** -23, atol=1e-5):
            raise AssertionError(f"probe losses differ: {a} {b}")
    say("reference", path="aread _mask_evolution, full width", chains=4,
        adapt_steps=2, probes=2, masks_equal=True,
        probe_loss_max_abs_diff=diff, tolerance="atol 1e-5 + 2 f32 ulp",
        card_chain_dispatch=dispatch, probe_losses_card=gpu["losses"],
        seconds={"cpu": runs["cpu"][2], "cuda": runs["cuda"][2]})


# the reference phase's AREAD steps: one warm-up step and a bagging chunk
# long enough that the card's graph is captured and replayed
REFERENCE_STEPS = 4


def reference_aread(ctx, **model_kw):
    """The same REFERENCE_STEPS steps, from the same weights, on the card
    (CUDA graphs, kernel 1) and on the CPU (the eager loop, plain versions),
    at a small width with an f32 table,
    no dropout and the full mask; losses, weights and Adam state must
    agree at atol 1e-5. The linear biases that feed a BatchNorm get their
    true gradient, exactly 0, on both sides: the computed one is round-off,
    which Adam would normalize into a step of up to lr either way.
    ``model_kw``: config fields beside the small widths (the PLE base)."""
    from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch
    from aread_tpu_torch.models.aread import full_mask

    data = make_synthetic_data(n_rows=2048, n_domain=4, vocab=300, seed=3)
    trainers = {}
    for dev in ("cpu", "cuda"):
        tr = build_trainer(
            data.spec, dev, 4, embed_dim=8, mlp_dims=(16, 8),
            aread_tower_dims=((8,), (8, 4)), dropout=0.0,
            table_dtype="float32", table_moments_dtype="float32", **model_kw)
        tr.optimizer = true_zero_adam(
            r"^(mmoe_experts|towers_\d+)/linear_\d+/bias$", tr.config.lr,
            tr.config.wd)
        trainers[dev] = tr
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    dm = [np.asarray(m) for m in full_mask(trainers["cpu"].model.n_tower)]
    losses = {dev: [] for dev in trainers}
    batches = [pad_batch(data.train_x[256 * i:256 * (i + 1)],
                         data.train_y[256 * i:256 * (i + 1)], 256)
               for i in range(REFERENCE_STEPS)]
    # through each trainer's chunk dispatch: a warm-up chunk of one step,
    # then a bagging chunk (on the card: the captured graph's eager steps,
    # its capture and a replay; on the CPU the eager loop)
    for kind, sl in (("warmup", slice(0, 1)),
                     ("main", slice(1, REFERENCE_STEPS))):
        for dev, tr in trainers.items():
            feeds = batches[sl]
            ls, _ = tr.chunks.run(kind, feeds, [None if kind == "warmup"
                                                else dm] * len(feeds),
                                  tr.opt_state)
            losses[dev].extend(float(x) for x in ls.cpu())
    if trainers["cuda"].chunks.graphs["main"].launches != {
            **dict.fromkeys(trainers["cuda"].chunks.graphs["main"].launches,
                            0), "sparse_adam": 1}:
        raise AssertionError("the captured bagging step does not launch "
                             "kernel 1 once")
    worst, diff = state_diffs(trainers["cpu"], trainers["cuda"], losses)
    if diff > 1e-5:
        raise AssertionError(f"card and CPU disagree after {REFERENCE_STEPS} "
                             f"steps: {worst} {diff}")
    say("reference", path="aread AREADTrainer steps, graph on the card",
        base_model=trainers["cpu"].config.base_model, steps=REFERENCE_STEPS,
        dispatch={d: t.chunks.name for d, t in trainers.items()},
        max_abs_diff=diff, worst=worst, tolerance=1e-5)


# ------------------------------------------------------------------- zoo
ZOO_MODELS = ("dcnv2", "autoint", "ple", "pepnet", "epnet", "epnet-single",
              "star")
# one fit epoch: a full chunk of SCAN_CHUNK steps and a remainder
ZOO_STEPS = 40
# the chunks of host batches run after a fit, graph against eager: the
# first captures, the second is timed, the third profiled
ZOO_CHUNKS = (4, 16, 4)
# biases whose shift reaches a BatchNorm through linear maps alone, per
# model: their true gradient is 0 (STAR's partitioned normalization feeds
# the first linear layer, which feeds a BatchNorm)
ZOO_PRE_BN_BIAS = {
    "dcnv2": r"^dnn/linear_\d+/bias$",
    "autoint": r"^dnn/linear_\d+/bias$",
    "ple": r"^towers/linear_\d+/bias$",
    "pepnet": r"^ppnet/bias_\d+$",
    "epnet": r"^towers/linear_\d+/bias$",
    "epnet-single": r"^towers/linear_\d+/bias$",
    "star": (r"^((domain_dnns|shared_dnn)_bias_\d+|domain_norm/bias"
             r"|shared_bn_bias)$"),
    "hinet": r"^((specific_seis|shared_sei)/experts|tower)/linear_\d+/bias$",
    # each layer's product fc * pi with a per-sample pi reaches its
    # BatchNorm: no bias has a true zero gradient
    "adasparse": r"(?!)",
    "adl": r"^(domain_mlps|shared_mlps)/linear_\d+/bias$",
}


# multi-tower models that take the group and select the sample's tower in
# their forward: one logit per sample
TOWER_SELECTED_IN_FORWARD = ("adl", "hinet")


def check_metrics(what: str, results) -> None:
    """Finite losses and AUCs, the AUCs in [0, 1]."""
    for name, r in results:
        for k in ("total_auc", "mean_auc", "total_loss"):
            if k in r and (not np.isfinite(r[k]) or (
                    k.endswith("auc") and not 0 <= r[k] <= 1)):
                raise AssertionError(f"{what} {name} {k}={r[k]}")


def phase_zoo(ctx):
    """The first half of the zoo at full Amazon width through the generic
    Trainer, then AREAD on a PLE base through both of its paths."""
    zoo_fit(ctx)
    zoo_regroup_twins(ctx)
    zoo_reference(ctx)
    zoo_aread_ple(ctx)


def fit_results_equal(a, b) -> bool:
    """Two fit results equal in every metric (NaN equal to NaN), their
    clocks and the store's account of each epoch (``spans``) aside."""
    def metrics(r):
        return [{k: v for k, v in h.items()
                 if k not in ("epoch_time_s", "examples_per_s", "spans")}
                for h in r["history"]] + [r["test"]]

    def same(x, y):
        if isinstance(x, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y or (x != x and y != y)

    return same(metrics(a), metrics(b))


def fit_twins(ctx, path: str, make, fit):
    """Two trainers from one seed (``make()``) through Trainer.fit
    (``fit(trainer)``), one by CUDA graph replays (the card's dispatch:
    steps and evaluation passes) and one eager (the dispatch rules,
    ``step_graph.graph_dispatch`` and ``eval_dispatch``, answer False for
    it during the fits), each counted as ``path`` and ``path``_eager;
    after the fits the two must be bitwise equal (``trainer_bits``) and
    their results equal. Returns ({'graph', 'eager'}: trainer, result,
    fit seconds)."""
    from aread_tpu_torch.train import step_graph

    trs = {"graph": make(), "eager": make()}
    res, secs = {}, {}
    card_rule, eval_rule = step_graph.graph_dispatch, step_graph.eval_dispatch
    step_graph.graph_dispatch = lambda t: (t is not trs["eager"]
                                           and card_rule(t))
    step_graph.eval_dispatch = lambda t: (t is not trs["eager"]
                                          and eval_rule(t))
    try:
        for k, t in trs.items():
            t0 = time.perf_counter()
            res[k] = counted(ctx, path + ("" if k == "graph" else "_eager"),
                             lambda: fit(t))
            secs[k] = time.perf_counter() - t0
            if res[k]["dispatch"] != k or t.evals.name != k:
                raise AssertionError(f"{path}: the {k} trainer dispatched "
                                     f"{res[k]['dispatch']}, evaluated "
                                     f"{t.evals.name}")
    finally:
        step_graph.graph_dispatch = card_rule
        step_graph.eval_dispatch = eval_rule
    bad = bits_differ(trainer_bits(trs["graph"]), trainer_bits(trs["eager"]))
    if bad or not fit_results_equal(res["graph"], res["eager"]):
        raise AssertionError(f"{path}: the graph fit != the eager fit at "
                             f"{bad[:8]}")
    return trs, res, secs


def zoo_fit(ctx, models=ZOO_MODELS, phase: str = "zoo", keep: bool = False):
    """Each of ``models`` through build_model + Trainer.fit, by graph
    replays and eagerly from one seed (``fit_twins``): one epoch of
    ZOO_STEPS dense-gradient steps (f32 table, bf16 moments, dropout 0.2,
    Amazon domain2group) on the resident split, a full chunk and a
    remainder, the valid and test passes; the two bitwise equal after the
    fit. Then the two in turns on ZOO_CHUNKS of host batches
    (``twin_chunks``): the step's ms by each dispatch, its launches,
    kernels and device busy time per step, the idle share and peak memory.
    With ``keep``, returns ({name: graph trainer}, the split); else each
    trainer is dropped before the next is built."""
    from aread_tpu_torch.config import DOMAIN2GROUP, Config
    from aread_tpu_torch.data.loader import GlobalBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import MULTI_TOWER_MODELS, Trainer

    data = amazon_split(np.random.default_rng(5), ZOO_STEPS * BS, 2048)
    d2g = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])
    kept = {}
    for name in models:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = Config(model=name, dataset_name="amazon", seed=0,
                     sparse_table_grad=False, table_dtype="float32")
        if (cfg.bs, cfg.embed_dim, cfg.table_moments_dtype, cfg.dropout) != (
                BS, EMBED_DIM, "bfloat16", 0.2):
            raise AssertionError("not the Amazon defaults")

        def make():
            return Trainer(build_model(cfg, data.spec, N_DOMAIN,
                                       device="cuda"), cfg, N_DOMAIN, d2g)

        trs, res, fit_s = fit_twins(
            ctx, f"{phase}/{name}_fit", make,
            lambda t: t.fit(data, epochs=1, verbose=False))
        tr = trs["graph"]
        model = tr.model
        launches = {k: ctx["launches_by_path"][f"{phase}/{name}_fit{sfx}"]
                    for k, sfx in (("graph", ""), ("eager", "_eager"))}
        for k, got in launches.items():
            if got != {"fused_adam": ZOO_STEPS, "sparse_adam": 0}:
                raise AssertionError(f"{name}: the {k} fit of {ZOO_STEPS} "
                                     f"dense steps launched {got}")
        hist = res["graph"]["history"][0]
        check_metrics(name, (("valid", hist), ("test", res["graph"]["test"])))
        if not np.isfinite(hist["train_loss"]) or tr.opt_state["t"] != ZOO_STEPS:
            raise AssertionError(f"{name}: train loss {hist['train_loss']}, "
                                 f"t={tr.opt_state['t']}")
        batches = [b for b, _ in zip(GlobalBatcher(
            data.train_x, data.train_y, BS, data.spec.domain_idx, d2g,
            seed=1), range(sum(ZOO_CHUNKS)))]
        with torch.no_grad():
            b0 = tr.place(batches[0])
            logit = model(b0["x"], group=b0["group"], train=False)["logit"]
        multi = (name in MULTI_TOWER_MODELS
                 and name not in TOWER_SELECTED_IN_FORWARD)
        want = (BS, 3) if multi else (BS,)
        if tuple(logit.shape) != want or not torch.isfinite(logit).all():
            raise AssertionError(f"{name}: logit {tuple(logit.shape)}, "
                                 f"want {want}")
        chunks, lo = [], 0
        for n in ZOO_CHUNKS:
            chunks.append(("train", batches[lo:lo + n]))
            lo += n
        per_step, _, _, checked = twin_chunks(
            ctx, f"{phase}/{name}_steps", trs, chunks,
            lambda t, c: t.chunks.run("train", c[1], [None] * len(c[1]),
                                      t.opt_state), 1, 2)
        step_launches = ctx["launches_by_path"][f"{phase}/{name}_steps"]
        if step_launches != {"fused_adam": 2 * sum(ZOO_CHUNKS),
                             "sparse_adam": 0}:
            raise AssertionError(f"{name}: steps launched {step_launches}")
        table = model.embedding.table
        say(phase, model=name, logit_shape=list(want),
            params=sum(p.numel() for p in model.parameters()) + table.numel(),
            dense_params=sum(p.numel() for p in model.parameters()),
            table=[list(table.shape), str(table.dtype)],
            fit_s=fit_s, fit_launches=launches["graph"],
            fit_graph_bitwise_eager=True, captures=tr.chunks.captures,
            train_loss=hist["train_loss"], valid_total_auc=hist["total_auc"],
            valid_mean_auc=hist["mean_auc"],
            test_total_auc=res["graph"]["test"]["total_auc"],
            test_mean_auc=res["graph"]["test"]["mean_auc"],
            step_ms={k: v["step_ms_events"] for k, v in per_step.items()},
            examples_per_s={k: v["examples_per_s"]
                            for k, v in per_step.items()},
            chunks=list(ZOO_CHUNKS), bitwise_after_chunks=checked,
            step_launches=step_launches, per_step=per_step)
        if keep:
            kept[name] = tr
        del tr, trs, model, table, batches
    return kept, data


def zoo_regroup_twins(ctx):
    """MMoE (Amazon domain2group, dense table gradient) through
    Trainer.fit under dynamic_regroup='towerfirst', two epochs of
    ZOO_STEPS on the resident split, by graph replays and eagerly
    (``fit_twins``): bitwise equal after the fit; whether the map moved
    (a moved map is a new device map, which the graph trainer captures
    again for its second epoch)."""
    from aread_tpu_torch.config import DOMAIN2GROUP, Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    data = amazon_split(np.random.default_rng(12), ZOO_STEPS * BS, 2048)
    d2g = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])
    cfg = Config(model="mmoe", dataset_name="amazon", seed=0,
                 sparse_table_grad=False, table_dtype="float32",
                 dynamic_regroup="towerfirst", early_stop=10)
    moved, made = [], []  # per regroup of the graph trainer: map moved

    def make():
        tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                     cfg, N_DOMAIN, d2g.copy())
        if not made:  # the graph trainer, made first
            regroup = tr.apply_dynamic_regroup

            def spy(*a, **kw):
                moved.append(regroup(*a, **kw))
                return moved[-1]

            tr.apply_dynamic_regroup = spy
        made.append(tr)
        return tr

    trs, res, fit_s = fit_twins(
        ctx, "zoo/mmoe_regroup_fit", make,
        lambda t: t.fit(data, epochs=2, verbose=False))
    tr = trs["graph"]
    launches = ctx["launches_by_path"]["zoo/mmoe_regroup_fit"]
    if launches != {"fused_adam": 2 * ZOO_STEPS, "sparse_adam": 0}:
        raise AssertionError(f"regroup fit launches {launches}")
    # one graph for the first epoch's row ids; a map moved after it is a
    # new device map, captured again
    if tr.chunks.captures != 1 + bool(moved[0]):
        raise AssertionError(f"{tr.chunks.captures} captures, the map "
                             f"moved after each epoch: {moved}")
    say("zoo", part="dynamic_regroup", model="mmoe", mode="towerfirst",
        epochs=2, steps_per_epoch=ZOO_STEPS, map_moved=moved,
        domains_moved=int(np.sum(tr.domain2group != d2g)),
        captures=tr.chunks.captures, fit_graph_bitwise_eager=True,
        fit_s=fit_s, launches=launches,
        valid_auc=[h["total_auc"] for h in res["graph"]["history"]])


ZOO_REFERENCE_D2G = np.array([0, 1, 2, 1])


def zoo_reference_batch():
    """The data and the one batch of ``zoo_reference``."""
    from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch

    data = make_synthetic_data(n_rows=1024, n_domain=4, vocab=300, seed=3)
    batch = pad_batch(data.train_x[:256], data.train_y[:256], 256)
    batch["group"] = ZOO_REFERENCE_D2G[
        batch["x"][:, data.spec.domain_idx]].astype(np.int32)
    return data, batch


def zoo_reference_trainer(name: str, data, dev: str):
    """A Trainer of ``zoo_reference``'s small width for model ``name`` on
    ``dev``, its weights drawn from the config's seed, its state made."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    cfg = Config(model=name, embed_dim=8, dropout=0.0,
                 sparse_table_grad=False, table_dtype="float32",
                 table_moments_dtype="float32", mlp_dims=(16, 8),
                 tower_dims=(16, 8), sei_dims=(16, 8),
                 ple_expert_dims=((16,), (8,)), ple_tower_dims=(8, 4),
                 atten_embed_dim=8, att_layer_num=1)
    tr = Trainer(build_model(cfg, data.spec, 4, device=dev), cfg, 4,
                 ZOO_REFERENCE_D2G)
    tr.optimizer = true_zero_adam(ZOO_PRE_BN_BIAS[name], cfg.lr, cfg.wd,
                                  cfg.atten_embed_dim)
    tr.init()
    return tr


def state_digest(tr) -> str:
    """sha256 (its first 16 hex digits) of a trainer's model state and
    table moments as f32 bytes on the host: which side of a card-vs-CPU
    check moved between two runs."""
    import hashlib

    h = hashlib.sha256()
    for k, v in list(tr.model.state_dict().items()) + [
            (k, tr.opt_state[k]) for k in ("m", "v")]:
        h.update(k.encode())
        h.update(v.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def zoo_reference(ctx, models=ZOO_MODELS):
    """One dense step of each of ``models`` from the same weights on the
    card (fused-Adam kernel) and on the CPU (plain versions): small width
    (embed 8, a 300-id vocab, bs 256, layers of 16 and 8 units, one
    attention layer of 8), f32 table and moments, dropout 0; atol 1e-5,
    every model's worst entry reported before a failure is raised. The
    linear biases that feed a BatchNorm and the key part of every
    attention in-projection bias get their true gradient, exactly 0
    (softmax over the keys ignores a shift shared by all keys), on both
    sides: the computed one is round-off, which Adam would normalize into
    a step of up to lr. The small layers matter for the same reason: a
    first Adam step moves an entry by lr * g / (|g| + eps), so an entry
    whose gradient is within a few eps of 0 turns the f32 round-off of
    its sum into a difference of up to ~1e-5; the default widths hold
    ~1M dense entries, enough to meet one."""
    data, batch = zoo_reference_batch()
    diffs, pairs, digests = {}, {}, {}
    for name in models:
        trainers = {dev: zoo_reference_trainer(name, data, dev)
                    for dev in ("cpu", "cuda")}
        trainers["cuda"].model.load_state_dict(
            trainers["cpu"].model.state_dict())
        losses = {"cpu": [float(trainers["cpu"].step(batch))],
                  "cuda": [float(counted(ctx, "zoo_reference",
                                         lambda: trainers["cuda"].step(batch)))]}
        if ctx["launches_by_path"].pop("zoo_reference")["fused_adam"] != 1:
            raise AssertionError(f"{name}: the card's step did not launch "
                                 "fused_adam")
        diffs[name] = state_diffs(trainers["cpu"], trainers["cuda"], losses)
        digests[name] = {d: state_digest(t) for d, t in trainers.items()}
        pairs[name] = trainers
    say("reference", path="zoo Trainer.step (dense)", steps=1,
        max_abs_diff={n: d for n, (_, d) in diffs.items()},
        worst={n: w for n, (w, _) in diffs.items()}, digests=digests,
        tolerance=1e-5)
    bad = {n: wd for n, wd in diffs.items() if wd[1] > 1e-5}
    if bad:
        raise AssertionError(f"card and CPU disagree after one step: {bad}")
    return pairs, data


def zoo_aread_ple(ctx):
    """AREAD with base_model='ple' (the config's ple_* defaults: 2 specific
    and 2 shared experts per task, levels (256, 128) and (64,)), bf16 table
    and moments, at Amazon width: 8 warm-up + 16 bagging steps under 'rand'
    masks; 3 steps on the card against the CPU at a small width; one epoch
    of AREADTrainer.fit at RESUME_DEPTH; the trained model saved, rebuilt
    by load_predictor and its mixed-domain answers held against the
    trainer's evaluation."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.utils.masks import has_output, validate_mask

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = build_trainer(amazon_spec(), "cuda", N_DOMAIN, dataset_name="amazon",
                       seed=0, base_model="ple")
    spec, cfg, model = tr.model.spec, tr.config, tr.model
    if (spec.n_rows, model.n_tower, cfg.table_dtype, cfg.table_moments_dtype,
            cfg.ple_expert_dims, hasattr(model, "cgc_1")) != (
            1518384, (3, 6, 12), "bfloat16", "bfloat16", ((256, 128), (64,)),
            True):
        raise AssertionError("not AREAD-PLE at the Amazon width")
    x, y = amazon_rows(np.random.default_rng(8), spec, N_DOMAIN * 2 * BS)
    batcher = DomainBatcher(x, y, BS, spec.domain_idx, N_DOMAIN, seed=0)
    ms = tr.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d,
                                             cfg.init_active_percent)
    seq = list(batcher.domain_batch_seq)
    plan = [("warmup", seq[i]) for i in range(8)] + \
        [("main", seq[8 + i]) for i in range(16)]
    batches = [(kind, d, tr.place(batcher.next_batch(d))) for kind, d in plan]
    losses, times = [], []

    def loop():
        for kind, d, batch in batches:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss, _ = (tr.warmup_step(batch) if kind == "warmup"
                       else tr.main_step(batch, ms.domain_mask[d]))
            b.record()
            losses.append(loss)
            times.append((kind, a, b))

    counted(ctx, "zoo/aread_ple_steps", loop)
    launches = ctx["launches_by_path"]["zoo/aread_ple_steps"]
    if launches != {"sparse_adam": len(batches), "fused_adam": 0}:
        raise AssertionError(f"aread-ple: {len(batches)} steps launched "
                             f"{launches}")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"aread-ple: non-finite loss {losses}")
    step_ms = {k: statistics.median(a.elapsed_time(b) for kk, a, b in times
                                    if kk == k) for k in ("warmup", "main")}
    _, d_last, b_last = batches[-1]
    per_step, busy_ms = launches_and_busy_per_call(
        lambda: tr.main_step(b_last, ms.domain_mask[d_last]))
    say("zoo", model="aread", base_model="ple", n_tower=list(model.n_tower),
        table=[list(model.embedding.table.shape),
               str(model.embedding.table.dtype)],
        params=sum(p.numel() for p in model.parameters())
        + model.embedding.table.numel(),
        dense_params=sum(p.numel() for p in model.parameters()),
        steps={"warmup": 8, "main": 16}, launches=launches,
        step_ms_median=step_ms,
        examples_per_s_main=BS / (step_ms["main"] * 1e-3),
        cuda_launches_per_main_step=per_step,
        device_busy_ms_per_main_step=busy_ms,
        loss_first=float(losses[0]), loss_last=float(losses[-1]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del tr, model, batches

    # A step moves an entry by lr * m / (sqrt(v) + eps): where |g| is within
    # a few eps of 0 it turns f32 round-off into up to ~1e-4. The CGC
    # experts sit at the bottom of the HEI chain with no BatchNorm, so
    # their gradients are the smallest; at these experts and seed the
    # smallest nonzero entry over the three steps is 8.5e-8 on the CPU
    # (the MMoE base's reference above: 7.3e-8), clear of eps (experts of
    # 16 then 8 units, seed 0: 7.6e-10, and the card differed by 3.2e-5).
    reference_aread(ctx, base_model="ple", ple_expert_dims=((4,), (4,)),
                    seed=4)

    depth = dict(RESUME_DEPTH)
    n_train = depth.pop("train_batches") * BS
    data = amazon_split(np.random.default_rng(9), n_train,
                        depth.pop("eval_rows"), aug=True)
    cfg = Config(model="aread", dataset_name="amazon", seed=0,
                 base_model="ple", **depth)
    tr = AREADTrainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                      cfg, N_DOMAIN)
    t0 = time.perf_counter()
    res = counted(ctx, "zoo/aread_ple_fit",
                  lambda: tr.fit(data, epochs=1, verbose=False))
    fit_s = time.perf_counter() - t0
    want = sparse_adam_launches_of_fit(cfg, data, 1)
    launches = ctx["launches_by_path"]["zoo/aread_ple_fit"]
    if launches != {"sparse_adam": want, "fused_adam": 0}:
        raise AssertionError(f"aread-ple fit launched {launches}, the "
                             f"schedule implies {want} sparse_adam")
    for d, m in enumerate(res["domain_mask"]):
        if m is None or not has_output(m) or not masks_equal(m, validate_mask(m)):
            raise AssertionError(f"aread-ple: domain {d}: invalid mask")
    hist = res["history"][0]
    check_metrics("aread-ple", (("valid", hist), ("test", res["test"])))
    if not np.isfinite(hist["train_loss"]):
        raise AssertionError(f"aread-ple: train loss {hist['train_loss']}")
    say("zoo", model="aread", base_model="ple", part="fit",
        depth=RESUME_DEPTH, epochs=1, fit_s=fit_s,
        regroup_times=tr.regroup_times, launches=launches,
        sparse_adam_launches_schedule=want, train_loss=hist["train_loss"],
        valid_total_auc=hist["total_auc"], valid_mean_auc=hist["mean_auc"],
        test_total_auc=res["test"]["total_auc"],
        test_mean_auc=res["test"]["mean_auc"])
    x, _ = amazon_rows(np.random.default_rng(4), amazon_spec(), SERVE_ROWS)
    with tempfile.TemporaryDirectory(prefix="aread_zoo_") as tmp:
        serve_checkpoints(ctx, {"aread": tr}, tmp, x, phase="zoo")


# ------------------------------------------------------------------ zoo2
ZOO2_MODELS = ("hinet", "adasparse", "adl")
# MAMDR's depth: about one 1024-row batch per domain, one epoch
MAMDR_TRAIN_ROWS = 12800


def phase_zoo2(ctx):
    """The zoo's second half at full Amazon width: HiNet, AdaSparse and ADL
    through build_model + Trainer.fit, ADL's centres through evaluation,
    each model's step card vs CPU; MAMDR through its Reptile meta-trainer
    at the CLI defaults; the four served from their checkpoints; the FM
    ops card vs CPU."""
    trainers, data = zoo_fit(ctx, ZOO2_MODELS, phase="zoo2", keep=True)
    zoo2_adl_centres(trainers["adl"], data)
    pairs, small = zoo_reference(ctx, ZOO2_MODELS)
    zoo2_adl_eval_reference(pairs["adl"], small)
    del pairs
    trainers["mamdr"] = zoo2_mamdr(ctx)
    zoo2_mamdr_reference(ctx)
    x, _ = amazon_rows(np.random.default_rng(4), amazon_spec(), SERVE_ROWS)
    with tempfile.TemporaryDirectory(prefix="aread_zoo2_") as tmp:
        serve_checkpoints(ctx, trainers, tmp, x, phase="zoo2")
    del trainers
    zoo2_fm_ops()


def zoo2_adl_centres(tr, data):
    """After fit the DLM centres are unit vectors; an evaluation leaves
    them bitwise where they were, and one with eval_dlm_update moves
    them (and keeps them unit vectors), by graph replays (a pass that
    captures first, then the replayed one) bitwise as by the eager twin
    (``eager_evals``) from the same centres, each timed."""
    model = tr.model
    centres = model.cluster_centers
    norm_err = float((torch.linalg.vector_norm(centres, dim=1) - 1).abs().max())
    before = centres.clone()
    tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
    pure = torch.equal(centres, before)
    model.eval_dlm_update = True
    runs = {}
    try:
        tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
        captured = tr.evals.eval_captures
        for name in ("graph", "eager"):
            with torch.no_grad():
                centres.copy_(before)  # in place: the graph stays valid
            with (contextlib.nullcontext() if name == "graph"
                  else eager_evals(tr)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = tr.evaluate(data.valid_x, data.valid_y,
                                  data.domain_cnt_weight)
                torch.cuda.synchronize()
                runs[name] = (res, centres.clone(),
                              time.perf_counter() - t0, tr.evals.name)
    finally:
        model.eval_dlm_update = False
    twins = bits_differ(runs["graph"][1], runs["eager"][1]) == [] and \
        fit_results_equal({"history": [], "test": runs["graph"][0]},
                          {"history": [], "test": runs["eager"][0]})
    replayed = tr.evals.eval_captures == captured
    moved = float((centres - before).abs().max())
    norm_err_after = float(
        (torch.linalg.vector_norm(centres, dim=1) - 1).abs().max())
    say("zoo2", model="adl", part="centres", shape=list(centres.shape),
        norm_err_after_fit=norm_err, eval_bitwise_unchanged=pure,
        moved_by_eval_dlm_update=moved, norm_err_after_update=norm_err_after,
        valid_total_auc_with_update=res["total_auc"],
        update_graph_bitwise_eager=twins, update_graph_replayed=replayed,
        dispatch=[r[3] for r in runs.values()],
        update_eval_s={k: r[2] for k, r in runs.items()})
    if max(norm_err, norm_err_after) > 1e-5 or not pure or moved == 0.0:
        raise AssertionError("adl: centres not unit vectors, moved by a pure "
                             "evaluation or not moved by eval_dlm_update")
    if not (twins and replayed) or [r[3] for r in runs.values()] != [
            "graph", "eager"]:
        raise AssertionError("adl: the centres after an eval_dlm_update "
                             "evaluation by graph != by the eager twin")


def zoo2_adl_eval_reference(trainers, data):
    """zoo_reference's ADL pair (one step taken on each device) evaluates
    the valid split with eval_dlm_update: the centres must agree card vs
    CPU at atol 1e-5."""
    for tr in trainers.values():
        tr.model.eval_dlm_update = True
        tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
        tr.model.eval_dlm_update = False
    diff = float((trainers["cpu"].model.cluster_centers
                  - trainers["cuda"].model.cluster_centers.cpu()).abs().max())
    say("reference", path="adl evaluation with eval_dlm_update (centres)",
        max_abs_diff=diff, tolerance=1e-5)
    if diff > 1e-5:
        raise AssertionError(f"adl: centres after evaluation, card vs CPU "
                             f"{diff}")


def mamdr_sparse_adam_launches(cfg, data) -> int:
    """sparse_adam launches of one MamdrTrainer.fit epoch, from the
    DomainBatcher's per-domain batch counts and the trainer's draws (the
    permutation, then each domain's auxiliary domains): the shared pass
    over every batch, then for each domain d and each of its sequences
    (the auxiliary domains, then d itself) cnt[a] + cnt[d] steps."""
    from aread_tpu_torch.data.loader import DomainBatcher

    seq = DomainBatcher(data.train_x, data.train_y, cfg.bs,
                        data.spec.domain_idx, N_DOMAIN,
                        seed=cfg.seed).domain_batch_seq
    domains, counts = np.unique(np.asarray(seq), return_counts=True)
    cnt = dict(zip(domains.tolist(), counts.tolist()))
    rng = np.random.default_rng(cfg.seed)
    rng.permutation(domains)
    total = int(counts.sum())
    for d in domains.tolist():
        cands = domains[domains != d]
        aux = rng.choice(cands, size=min(cfg.mamdr_aux_sample_num,
                                         len(cands)), replace=False)
        total += sum(cnt[a] + cnt[d] for a in aux.tolist() + [d])
    return total


# MAMDR's steps by both dispatches after the fits: chunks of host batches
# (the first is replayed by the fit's graph, the second timed, the third
# profiled)
MAMDR_CHUNKS = (8, 16, 8)


def zoo2_mamdr(ctx):
    """MAMDR at the CLI defaults (sparse table gradient, bf16 table and
    moments, 2 auxiliary domains) through build_model + MamdrTrainer.fit:
    one epoch on MAMDR_TRAIN_ROWS rows, valid and test passes of 2,048,
    by CUDA graph replays and by its eager twin from one seed
    (``fit_twins``); the two bitwise (the model, the optimizer state, the
    generator, the meta weights, every domain's weights, the history and
    the test result), one step graph captured for the whole fit, and
    each fit's sparse_adam launches the schedule's. Then one Reptile
    update, one merge and one weight swap timed alone (the table
    included), and the twins' steps in turns on MAMDR_CHUNKS
    (``twin_chunks``: ms a step, launches, kernels, busy ms, idle
    share). Returns the graph trainer, holding the meta weights."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.mamdr import (MamdrTrainer, reptile_update,
                                             tree_add)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = amazon_split(np.random.default_rng(6), MAMDR_TRAIN_ROWS, 2048)
    cfg = Config(model="mamdr", dataset_name="amazon", seed=0)
    if (cfg.sparse_table_grad, cfg.table_dtype, cfg.table_moments_dtype,
            cfg.mamdr_aux_sample_num, cfg.bs) != (True, "bfloat16",
                                                  "bfloat16", 2, BS):
        raise AssertionError("not the CLI defaults")
    want = mamdr_sparse_adam_launches(cfg, data)
    trs, res, epoch_s = fit_twins(
        ctx, "zoo2/mamdr_fit",
        lambda: MamdrTrainer(build_model(cfg, data.spec, N_DOMAIN,
                                         device="cuda"), cfg, N_DOMAIN),
        lambda t: t.fit(data, epochs=1, verbose=False))
    for path in ("zoo2/mamdr_fit", "zoo2/mamdr_fit_eager"):
        launches = ctx["launches_by_path"][path]
        if launches != {"sparse_adam": want, "fused_adam": 0}:
            raise AssertionError(f"{path} launched {launches}, the "
                                 f"schedule implies {want} sparse_adam")
    bad = bits_differ(
        [res["graph"]["meta_weights"], res["graph"]["domain_weights"]],
        [res["eager"]["meta_weights"], res["eager"]["domain_weights"]])
    if bad:
        raise AssertionError(f"mamdr: the graph fit's Reptile weights != "
                             f"the eager fit's at {bad[:8]}")
    tr = trs["graph"]
    table = tr.model.embedding.table
    if tuple(table.shape) != (1518384, EMBED_DIM):
        raise AssertionError(f"table {tuple(table.shape)}")
    if tr.chunks.captures != 1:
        raise AssertionError(f"mamdr fit: {tr.chunks.captures} step "
                             f"captures, one for the whole fit wanted")
    hist = res["graph"]["history"][0]
    check_metrics("mamdr", (("valid", hist), ("test", res["graph"]["test"])))
    meta = res["graph"]["meta_weights"]
    live = tr.live_weights()
    if tr.model.embedding.table is not table or not all(
            torch.equal(v, meta[k]) for k, v in live.items()):
        raise AssertionError("mamdr: the model does not hold the meta weights")
    peak = torch.cuda.max_memory_allocated() / 2**30
    reptile_ms = event_ms(lambda: reptile_update(meta, live, meta,
                                                 cfg.mamdr_meta_lr))
    merge_ms = event_ms(lambda: tree_add(meta,
                                         res["graph"]["domain_weights"][0]))
    swap_ms = event_ms(lambda: tr.load_weights(meta))
    # the twins' steps alone (the graph trainer's model is put back
    # afterwards: it serves the meta weights)
    saved = {k: v.clone() for k, v in tr.model.state_dict().items()}
    batcher = DomainBatcher(data.train_x, data.train_y, BS,
                            data.spec.domain_idx, N_DOMAIN, seed=1)
    # the split holds a batch a domain: the chunks go round the domains
    seq = list(batcher.domain_batch_seq)
    chunks, run = train_chunks(
        [batcher.next_batch(seq[j % len(seq)])
         for j in range(sum(MAMDR_CHUNKS))], MAMDR_CHUNKS)
    per_step, runs, _, checked = twin_chunks(
        ctx, "zoo2/mamdr_steps", trs, chunks, run, 1, 2)
    steps = ctx["launches_by_path"]["zoo2/mamdr_steps"]
    if steps != {"sparse_adam": 2 * sum(MAMDR_CHUNKS), "fused_adam": 0}:
        raise AssertionError(f"mamdr steps launched {steps}")
    if tr.chunks.captures != 1:
        raise AssertionError("mamdr: its steps captured the step again")
    tr.model.load_state_dict(saved)
    say("zoo2", model="mamdr", part="fit", rows=MAMDR_TRAIN_ROWS,
        table=[list(table.shape), str(table.dtype)],
        params=sum(t.numel() for t in live.values()),
        epoch_s=epoch_s, steps=want,
        launches=ctx["launches_by_path"]["zoo2/mamdr_fit"],
        sparse_adam_launches_schedule=want,
        bitwise_graph_eager=["model", "optimizer state", "generator",
                             "meta weights", "domain weights", "history",
                             "test"],
        step_captures=tr.chunks.captures,
        eval_captures=tr.chunks.eval_captures,
        graph_launches_per_replay={k: v.launches
                                   for k, v in tr.chunks.graphs.items()},
        chunks=list(MAMDR_CHUNKS), bitwise_after_chunks=checked,
        per_step=per_step,
        chunk_event_ms={k: [r["event_ms"] for r in rs]
                        for k, rs in runs.items()},
        valid_total_auc=hist["total_auc"],
        valid_mean_auc=hist["mean_auc"],
        test_total_auc=res["graph"]["test"]["total_auc"],
        reptile_update_ms=reptile_ms, merge_ms=merge_ms, swap_ms=swap_ms,
        peak_mem_gb=peak)
    del res, meta, live, saved, trs
    return tr


def zoo2_mamdr_reference(ctx):
    """One MamdrTrainer.fit epoch from the same weights on the card
    (sparse-Adam kernel, the steps graph replays) and on the CPU (plain
    version, the eager loop): a small width
    (embed 8, MLP of 16 and 8 units, 4 domains, bs 256), f32 table and
    moments, dropout 0; the meta weights and domain 0's weights at atol
    1e-5. Every batch holds one domain, so the rows of the MLP's first
    kernel that the domain field's embedding feeds have a true gradient of
    0 (their input is constant over the batch and a BatchNorm follows), as
    the MLP's pre-BatchNorm biases do: both get it on both sides. Their
    computed gradient is round-off, which each of the epoch's 13 fresh
    optimizers would turn into a first step of up to lr (one run: 1.1e-5
    apart in domain 0's weights without this)."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import make_synthetic_data
    from aread_tpu_torch.models.mamdr import MAMDR
    from aread_tpu_torch.train.mamdr import (MamdrTrainer, reptile_update,
                                             tree_add)

    # the Reptile arithmetic alone, bitwise: a bf16 table (its meta_lr
    # rounded to bf16 as the JAX package does) and f32 leaves
    g = torch.Generator().manual_seed(1)
    trees = [{"table": torch.randn((4096, 32), generator=g).to(torch.bfloat16),
              "kernel": torch.randn((64, 16), generator=g)} for _ in range(3)]
    on_card = [{k: v.to("cuda") for k, v in t.items()} for t in trees]
    for name, fn in (("reptile_update", lambda t: reptile_update(*t, 0.1)),
                     ("tree_add", lambda t: tree_add(t[0], t[1]))):
        want, got = fn(trees), fn(on_card)
        if not all(torch.equal(want[k], got[k].cpu()) for k in want):
            raise AssertionError(f"{name}: card and CPU differ")

    data = make_synthetic_data(n_rows=1024, n_domain=4, vocab=300, seed=3)
    cfg = Config(model="mamdr", embed_dim=8, bs=256, dropout=0.0, seed=0,
                 dataset_name="none", table_dtype="float32",
                 table_moments_dtype="float32")
    trainers, res = {}, {}
    for dev in ("cpu", "cuda"):
        tr = MamdrTrainer(MAMDR(data.spec.with_flat_table(8), 8,
                                mlp_dims=(16, 8), dropout=0.0, device=dev),
                          cfg, 4)
        didx = data.spec.domain_idx
        tr.optimizer = true_zero_adam(
            r"^mlp/linear_\d+/bias$", cfg.lr, cfg.wd,
            constant_rows=("mlp/linear_0/kernel",
                           slice(didx * 8, (didx + 1) * 8)))
        trainers[dev] = tr
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    res["cpu"] = trainers["cpu"].fit(data, epochs=1, verbose=False)
    res["cuda"] = counted(ctx, "zoo2_mamdr_reference", lambda: trainers[
        "cuda"].fit(data, epochs=1, verbose=False))
    launches = ctx["launches_by_path"].pop("zoo2_mamdr_reference")
    if res["cuda"]["dispatch"] != "graph":
        raise AssertionError(f"the card's MAMDR fit dispatched "
                             f"{res['cuda']['dispatch']}")
    diffs = {}
    for what, pick in (("meta", lambda r: r["meta_weights"]),
                       ("domain0", lambda r: r["domain_weights"][0])):
        a, b = pick(res["cpu"]), pick(res["cuda"])
        for k in a:
            diffs[f"{what}:{k}"] = float((a[k] - b[k].cpu()).abs().max())
    worst = max(diffs, key=diffs.get)
    say("reference", path="mamdr MamdrTrainer.fit (one epoch)",
        dispatch=res["cuda"]["dispatch"], launches=launches, max_abs_diff=diffs[worst], worst=worst,
        tolerance=1e-5, reptile_and_merge_bitwise=True)
    if launches["sparse_adam"] != mamdr_sparse_adam_launches(cfg, data):
        raise AssertionError(f"mamdr reference launched {launches}")
    if diffs[worst] > 1e-5:
        raise AssertionError(f"mamdr: card and CPU disagree after one epoch: "
                             f"{worst} {diffs[worst]}")


def zoo2_fm_ops():
    """Each op that slice 7 brought to ops/fm.py (FactorizationMachine is
    on DeepFM's path, held by reference_dense) on the card against the CPU
    at the Amazon
    field count (9 fields of 32) and bs 1024, the same weights and inputs;
    atol 1e-5. OuterProductNetwork('mat') is defined, as in the JAX
    package, only where the pair count equals the width: it runs at 9
    fields of 36."""
    import copy

    from aread_tpu_torch.ops import fm

    n_fields = amazon_spec().field_num
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g)
    n_pairs = n_fields * (n_fields - 1) // 2
    ops = {"ipnn": fm.InnerProductNetwork(),
           **{f"opnn_{k}": fm.OuterProductNetwork(n_fields, EMBED_DIM, k, **kw)
              for k in ("vec", "num")},
           "opnn_mat": fm.OuterProductNetwork(n_fields, n_pairs, "mat", **kw),
           "afm": fm.AttentionalFactorizationMachine(EMBED_DIM, 16,
                                                     (0.2, 0.2), **kw),
           "cin": fm.CompressedInteractionNetwork(n_fields, (16, 16, 8), **kw),
           "anova": fm.AnovaKernel(3)}
    xs = {e: 0.5 * torch.randn((BS, n_fields, e), generator=g)
          for e in (EMBED_DIM, n_pairs)}
    diffs, shapes = {}, {}
    with torch.no_grad():
        for name, op in ops.items():
            x = xs[n_pairs if name == "opnn_mat" else EMBED_DIM]
            want = op(x)
            got = copy.deepcopy(op).to("cuda")(x.to("cuda")).cpu()
            shapes[name] = list(got.shape)
            diffs[name] = float((got - want).abs().max())
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: {tuple(got.shape)}")
    say("zoo2", part="fm_ops", fields=n_fields, embed_dim=EMBED_DIM,
        opnn_mat_embed_dim=n_pairs, rows=BS,
        shapes=shapes, max_abs_diff=diffs, tolerance=1e-5)
    bad = {n: d for n, d in diffs.items() if d > 1e-5}
    if bad:
        raise AssertionError(f"fm ops: card and CPU disagree: {bad}")


# Depth of the hemp phase; the width is the train phase's. Intervals count
# 1024-row batches. 3 candidates configured: int(3 * 0.99) = 2 run.
HEMP_DEPTH = {"train_batches": 48, "eval_rows": 8192, "epoch": 1,
              "warm_up_interval": 8, "regroup_interval": 24,
              "regroup_update_step": 3, "regroup_eval_step": 2,
              "candidate_mask_num": 3, "final_epoch": 1}


def event_ms(fn, n: int = 10, warmup: int = 2):
    """(median CUDA-event ms, median host-clock ms with a sync) of ``fn``,
    each call timed alone."""
    for _ in range(warmup):
        fn()
    ev, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(a.elapsed_time(b))
    return statistics.median(ev), statistics.median(host)


def chain_inputs(tr, batcher, n: int, seed: int = 9):
    """A regroup's inputs for ``run_chains``: ``n`` candidates, candidate c
    of domain c % n_domain, each a random mask of its own stream (so that
    the trainers' mask streams stay as they were) and its adapt and probe
    feeds from ``batcher`` as ``tr`` feeds a chain (row ids with the split
    resident, else host batches). Twins share one draw."""
    from aread_tpu_torch.utils.masks import HempMaskState

    cfg = tr.config
    ms = HempMaskState(tr.model.n_tower, tr.n_domain, seed=seed)
    masks, fa, probe = [], [], []
    for c in range(n):
        d = c % tr.n_domain
        masks.append(ms.generate_mask("rand", d, 0.7))
        fa.append([tr._feed(batcher, batcher.next_batch_indices(d))
                   for _ in range(cfg.regroup_update_step)])
        probe.append([tr._feed(batcher, batcher.next_batch_indices(d))
                      for _ in range(cfg.regroup_eval_step)])
    return masks, fa, probe


def chain_replays(tr, inputs, overlay: bool, ctx, path: str,
                  profiled: int = 2):
    """``tr``'s dispatch over the staged ``inputs`` without the staging:
    ms per chain by CUDA events and by the host clock (median of 3 runs
    of every candidate, after one), then the first ``profiled`` chains
    under chunk_profile (per chain: launch calls, kernels run, device busy
    ms; the idle share against the unprofiled host clock), their launches
    counted as ``path`` and held to the profiler's kernel records. The
    weights are restored after."""
    chain, io = tr._stage_chains(overlay, *inputs)
    n = len(inputs[0])

    def run(k):
        io["i"].zero_()
        tr.chunks.run_chains(chain, k)

    ev, host = event_ms(lambda: run(n), n=3, warmup=1)
    _, prof = counted(ctx, path, lambda: chunk_profile(
        lambda: run(profiled), profiled))
    launches = ctx["launches_by_path"].pop(path)
    miss = [f"{k}: profiler {prof[key]}, counted {launches[k]}"
            for k, key in KERNEL_RECORDS.items() if prof[key] != launches[k]]
    if miss:
        raise AssertionError(f"{path}: {'; '.join(miss)}")
    tr._restore(tr._chain_snap)
    return {"chain_ms_events": ev / n, "chain_ms_host_clock": host / n,
            "chains_timed": n, "chains_profiled": profiled,
            "launches_per_chain": {k: v / profiled
                                   for k, v in launches.items()},
            **{k: v for k, v in prof.items()
               if k not in KERNEL_RECORDS.values()},
            # the profiler stretches the wall clock: the busy time over the
            # unprofiled chain's time
            "device_idle_share_unprofiled": 1 - prof["device_busy_ms"] / (
                host / n)}


def sync_debug_chain(tr, inputs, overlay: bool) -> None:
    """The chain that ``tr``'s graph captured, its body run once eagerly on
    the first staged candidate under torch.cuda.set_sync_debug_mode
    ('error'): a chain that waited for the device (a host read, a
    pageable copy) raises. The weights are restored after."""
    chain, _ = tr._stage_chains(overlay, *inputs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain.fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tr._restore(tr._chain_snap)


def chain_twins(ctx, path, trs, inputs, overlay: bool, orders, want):
    """``trs['graph']`` (CUDA graph replays) and ``trs['eager']`` (its eager
    twin from the same seed) each run the regroup ``inputs`` through
    ``run_chains``, once per entry of ``orders`` (the dispatches in the
    order they run); after each entry that ran both, every candidate's
    pruned mask and probe loss, the weights and the dropout generator
    must be bitwise equal. Each run's kernel launches must equal ``want``.
    Returns per dispatch its runs: seconds (host clock, synchronised) and
    ms per chain by CUDA events and by the host clock, staging and the one
    fetch included."""
    runs = {name: [] for name in trs}
    for ri, order in enumerate(orders):
        got = {}
        for name in order:
            t = trs[name]
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            a.record()
            key = f"{path}/{name}"
            got[name] = counted(ctx, key, lambda: t.run_chains(
                *inputs, overlay))
            b.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - h0
            launches = ctx["launches_by_path"].pop(key)
            if launches != want:
                raise AssertionError(f"{key} run {ri} launched {launches}, "
                                     f"the schedule implies {want}")
            n = len(inputs[0])
            runs[name].append({"seconds": wall, "chains": n,
                               "ms_per_chain_events": a.elapsed_time(b) / n,
                               "ms_per_chain_host_clock": wall * 1e3 / n,
                               "captures": getattr(t.chunks, "captures", 0)})
        if len(got) < 2:
            continue
        (gm, gl), (em, el) = got["graph"], got["eager"]
        bad = [f"level {li}" for li, (x, y) in enumerate(zip(gm, em))
               if not np.array_equal(x, y)]
        if gl.tobytes() != el.tobytes():
            bad.append(f"losses {gl.tolist()} {el.tolist()}")
        bad += bits_differ(
            {"state_dict": trs["graph"].model.state_dict(),
             "generator": trs["graph"].generator.get_state()},
            {"state_dict": trs["eager"].model.state_dict(),
             "generator": trs["eager"].generator.get_state()})
        if bad:
            raise AssertionError(f"{path} run {ri}: graph != eager at "
                                 f"{bad[:8]}")
        if not np.isfinite(gl).all():
            raise AssertionError(f"{path}: non-finite probe losses")
    return runs


def chain_twin_trainers(make):
    """Two trainers from one seed (``make()``), the second with the eager
    dispatch; they must start bitwise equal."""
    from aread_tpu_torch.train.step_graph import EagerChunks

    trs = {"graph": make(), "eager": make()}
    trs["eager"]._chunks = EagerChunks(trs["eager"])
    if trs["graph"].chunks.name != "graph":
        raise AssertionError("a card trainer's chains are not graphs")
    if bits_differ(trainer_bits(trs["graph"]), trainer_bits(trs["eager"])):
        raise AssertionError("two trainers from one seed differ")
    return trs


def hemp_chain_twins(ctx, data):
    """One regroup at the default depth (the config defaults: 25 domains x
    int(10 * 0.99) = 9 candidates = 225 chains of 5 adapt steps and 5
    probes, the full sweep, the split resident on the card, dropout 0.2)
    through ``_mask_evolution`` by graph and by an eager twin from one
    seed: every candidate's pruned mask and probe loss bitwise, the
    weights and generator too, kernel 1's launches the schedule's; then a
    second regroup by graph alone. Then ms per chain of each dispatch
    over 4 staged candidates, per chain launches and the device's idle
    share, and one chain under sync debug mode 'error'."""
    from aread_tpu_torch.data.loader import DomainBatcher

    spec = data.spec

    def make():
        t = build_trainer(spec, "cuda", N_DOMAIN, dataset_name="amazon",
                          seed=0)
        t.stage_device_data(data.train_x, data.train_y, data.aug_train_x,
                            data.aug_train_y)
        for d in range(N_DOMAIN):
            t.mask_state.domain_mask[d] = t.mask_state.generate_mask(
                "rand", d, t.config.init_active_percent)
        return t

    trs = chain_twin_trainers(make)
    cfg = trs["graph"].config
    if (cfg.regroup_update_step, cfg.regroup_eval_step,
            cfg.candidate_mask_num, trs["graph"].overlay_enabled()) != (
            5, 5, 10, False):
        raise AssertionError("not the default depth of the full sweep")
    recs = {name: spy_evolutions(t) for name, t in trs.items()}
    batchers = {name: [DomainBatcher(data.train_x if s == 1 else
                                     data.aug_train_x,
                                     data.train_y if s == 1 else
                                     data.aug_train_y, BS, spec.domain_idx,
                                     N_DOMAIN, seed=s) for s in (1, 2)]
                for name in trs}
    runs = {name: [] for name in trs}
    for order in (("graph", "eager"), ("graph",)):
        for name in order:
            t = trs[name]
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            counted(ctx, f"hemp/default_depth_{name}",
                    lambda: t._mask_evolution(*batchers[name], verbose=False))
            log = t.regroup_log[-1]
            launches = ctx["launches_by_path"].pop(
                f"hemp/default_depth_{name}")
            want = {"sparse_adam": log["chains"] * 5, "fused_adam": 0}
            if log["chains"] != N_DOMAIN * 9 or launches != want:
                raise AssertionError(f"default depth {name}: {log['chains']} "
                                     f"chains launched {launches}, the "
                                     f"schedule implies {want}")
            runs[name].append({"seconds": time.perf_counter() - h0,
                               "seconds_in_regroup_log": log["seconds"],
                               "chains": log["chains"],
                               "dispatch": log["dispatch"]})
        if len(order) == 2:
            g, e = recs["graph"][-1], recs["eager"][-1]
            bad = [d for d in range(N_DOMAIN)
                   if g["losses"][d] != e["losses"][d]
                   or not all(masks_equal(a, b) for a, b in zip(
                       g["candidates"][d], e["candidates"][d]))
                   or not masks_equal(g["after"][d], e["after"][d])]
            bad += bits_differ(
                {"sd": trs["graph"].model.state_dict(),
                 "gen": trs["graph"].generator.get_state()},
                {"sd": trs["eager"].model.state_dict(),
                 "gen": trs["eager"].generator.get_state()})
            if bad:
                raise AssertionError(f"default-depth regroup: graph != eager "
                                     f"at {bad[:8]}")
    if [r["dispatch"] for r in runs["graph"]] != ["graph", "graph"]:
        raise AssertionError(f"the graph trainer ran {runs['graph']}")
    inputs = chain_inputs(trs["graph"], batchers["graph"][0], 4)
    per_chain = {name: chain_replays(t, inputs, False, ctx,
                                     f"hemp/replays_{name}")
                 for name, t in trs.items()}
    tr = trs["graph"]
    chain, io = tr._stage_chains(False, *inputs)
    ctx["hemp_profile_args"] = lambda: (io["i"].zero_(),
                                        tr.chunks.run_chains(chain, 1))
    sync_debug_chain(tr, inputs, False)
    return {"depth": {"domains": N_DOMAIN, "candidates_per_domain": 9,
                      "adapt_steps": 5, "probes": 5, "engine": "full",
                      "feed": "row ids into the resident split"},
            "regroups": runs, "bitwise_graph_eager": True,
            "per_chain_4_staged": per_chain,
            "graph_launches_per_replay": {
                k: v.launches for k, v in tr.chunks.graphs.items()},
            "sync_debug_error_chain": "passed"}


def phase_hemp(ctx):
    """The HEMP loop at full Amazon width through build_model and
    AREADTrainer.fit, then its parts timed alone."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher, SplitData
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.utils.masks import (has_output, prune_mask,
                                             prune_mask_tensor, validate_mask)

    torch.cuda.reset_peak_memory_stats()
    depth = dict(HEMP_DEPTH)
    n_train = depth.pop("train_batches") * BS
    n_eval = depth.pop("eval_rows")
    cfg = Config(model="aread", dataset_name="amazon", seed=0,
                 aread_final=True, **depth)
    if (cfg.bs, cfg.embed_dim, cfg.table_dtype, cfg.table_moments_dtype,
            cfg.dropout, cfg.mmoe_n_expert, cfg.n_cross_layers) != (
            BS, EMBED_DIM, "bfloat16", "bfloat16", 0.2, 4, 3):
        raise AssertionError("not the Amazon defaults")
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    rng = np.random.default_rng(0)
    x, y = amazon_rows(rng, spec, 2 * n_train + 2 * n_eval)
    cuts = np.cumsum([n_train, n_train, n_eval])
    (tx, ax, vx, ex), (ty, ay, vy, ey) = np.split(x, cuts), np.split(y, cuts)
    counts = np.bincount(tx[:, spec.domain_idx], minlength=N_DOMAIN)
    if counts.min() == 0:
        raise AssertionError("a domain has no train rows")
    data = SplitData(train_x=tx, train_y=ty, valid_x=vx, valid_y=vy,
                     test_x=ex, test_y=ey, spec=spec,
                     domain_cnt_weight=counts / n_train, n_domain=N_DOMAIN,
                     aug_train_x=ax, aug_train_y=ay)
    t0 = time.perf_counter()
    model = build_model(cfg, spec, N_DOMAIN, device="cuda")
    tr = AREADTrainer(model, cfg, N_DOMAIN)
    if (model.spec.n_rows, model.n_tower) != (1518384, (3, 6, 12)):
        raise AssertionError("not the Amazon width")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    evolutions = spy_evolutions(tr)
    final = {}
    final_epoch = tr.train_final_epoch

    def train_final_epoch(*a, **kw):
        named = tr.model.dense_named_parameters()
        before = {n: p.detach().clone() for n, p in named.items()}
        table0 = tr.model.embedding.table.clone()
        final.setdefault("t", tr.opt_state["t"])
        out = final_epoch(*a, **kw)
        moved = [n for n, p in named.items() if not torch.equal(p, before[n])]
        if not torch.equal(tr.model.embedding.table, table0):
            moved.append("embedding/table")
        final.setdefault("moved", []).append(moved)
        return out

    tr.train_final_epoch = train_final_epoch
    t0 = time.perf_counter()
    res = counted(ctx, "hemp", lambda: tr.fit(data, verbose=False))
    fit_s = time.perf_counter() - t0
    launches = ctx["launches_by_path"]["hemp"]

    # --- what the schedule implies
    n_seq = int(np.sum(np.ceil(counts / BS)))
    warm = cfg.warm_up_interval * 1024 // BS
    interval = cfg.regroup_interval * 1024 // BS
    n_regroup = 1 + sum((i + 1) % interval == 0 for i in range(n_seq))
    cands = [max(1, int(cfg.candidate_mask_num * 0.99 ** (r + 1)))
             for r in range(n_regroup)]
    want = warm + n_seq + sum(N_DOMAIN * c * cfg.regroup_update_step
                              for c in cands)
    if tr.regroup_times != n_regroup or [
            r["candidates"] for r in tr.regroup_log] != cands:
        raise AssertionError(f"regroups {tr.regroup_log}, expected {cands}")
    if launches != {"sparse_adam": want, "fused_adam": 0}:
        raise AssertionError(f"hemp launched {launches}, the schedule "
                             f"implies {want} sparse_adam")
    # the main optimizer stepped in the warm-up and bagging steps only,
    # and no evolution moved its count
    if final["t"] != warm + n_seq or tr.opt_state["t"] != warm + n_seq:
        raise AssertionError(f"main optimizer t={tr.opt_state['t']}, "
                             f"{warm + n_seq} warm-up and bagging steps")
    for r in evolutions:
        if r["t_after"] != r["t"]:
            raise AssertionError("an evolution moved the main optimizer's t")
    changed = [sum(not masks_equal(b, a) for b, a in zip(r["before"], r["after"])
                   if b is not None) for r in evolutions]
    if len(evolutions) < 2 or not any(changed[1:]):
        raise AssertionError(f"no mask evolved: {changed}")
    for d, m in enumerate(res["domain_mask"]):
        if m is None or not has_output(m) or not masks_equal(m, validate_mask(m)):
            raise AssertionError(f"domain {d}: invalid mask")
    # the final phase moved final_gate and nothing else
    if not final.get("moved") or any(m != ["final_gate/kernel"]
                                     for m in final["moved"]):
        raise AssertionError(f"the final phase moved {final.get('moved')}")
    hist = res["history"]
    if [h.get("phase") for h in hist] != [None, "final_gate"]:
        raise AssertionError(f"history phases {[h.get('phase') for h in hist]}")
    for name, r in (("valid", hist[0]), ("valid_final", hist[1]),
                    ("test", res["test"])):
        for k in ("total_auc", "mean_auc"):
            if not np.isfinite(r[k]) or not 0 <= r[k] <= 1:
                raise AssertionError(f"{name} {k}={r[k]}")
    if not all(np.isfinite(h["train_loss"]) for h in hist):
        raise AssertionError("non-finite train loss")

    # --- the evolution's parts, one by one, at the same shapes
    ms = tr.mask_state
    tb = DomainBatcher(tx, ty, BS, spec.domain_idx, N_DOMAIN, seed=3)
    d = int(np.argmax(counts))
    fa = [tr.place(tb.next_batch(d)) for _ in range(cfg.regroup_update_step)]
    probes = [tr.place(tb.next_batch(d)) for _ in range(cfg.regroup_eval_step)]
    mask = ms.domain_mask[d]
    snap = tr._snapshot()
    state = tr._fresh_fast_state()
    gms = []

    def adapt_step():
        gms[:] = tr.step_core(tr.fast_optimizer, cfg.update_lr, state,
                              "domain_mask_bagging", fa[0], mask)[1]

    step_ms = event_ms(adapt_step)
    probe_ms = event_ms(lambda: tr.eval_prob(probes[0], mask))
    restore_ms = event_ms(lambda: tr._restore(snap))
    mask_t = tuple(torch.as_tensor(m, device="cuda") for m in mask)
    prune_host = event_ms(lambda: prune_mask(
        mask, [g.cpu().numpy() for g in gms]))
    prune_dev = event_ms(lambda: prune_mask_tensor(mask_t, gms))
    got = [m.cpu().numpy() for m in prune_mask_tensor(mask_t, gms)]
    if not masks_equal(got, prune_mask(mask, [g.cpu().numpy() for g in gms])):
        raise AssertionError("the two prune routes disagree on the card")
    tr._restore(snap)
    del snap, state

    # --- the chains by graph and by an eager twin at the default depth
    twins = hemp_chain_twins(ctx, data)
    ctx["hemp"] = {"trainer": tr, "data": data, "final": True}
    log = tr.regroup_log
    say("hemp", depth=HEMP_DEPTH, table_rows=model.spec.n_rows,
        embed_dim=cfg.embed_dim, bs=cfg.bs, n_tower=list(model.n_tower),
        n_domain=N_DOMAIN, table_dtype=cfg.table_dtype,
        moments_dtype=cfg.table_moments_dtype, dropout=cfg.dropout,
        device_data=True, init_s=init_s, fit_s=fit_s,
        warmup_steps=warm, main_steps=n_seq,
        final_steps=len(final["moved"]) * n_seq,
        regroup_times=tr.regroup_times, candidates=cands,
        chains_per_regroup=[r["chains"] for r in log],
        seconds_per_regroup=[r["seconds"] for r in log],
        ms_per_chain=[r["seconds"] / r["chains"] * 1e3 for r in log],
        active_ratio_after_regroup=[r["active_ratio"] for r in log],
        domains_changed_per_regroup=changed,
        adapt_step_ms={"events": step_ms[0], "host_clock": step_ms[1]},
        probe_ms={"events": probe_ms[0], "host_clock": probe_ms[1]},
        snapshot_restore_ms={"events": restore_ms[0],
                             "host_clock": restore_ms[1]},
        prune_ms={"host_route": {"events": prune_host[0],
                                 "host_clock": prune_host[1]},
                  "device_route": {"events": prune_dev[0],
                                   "host_clock": prune_dev[1]}},
        prune_route_in_use="device",
        regroup_dispatch=[r["dispatch"] for r in log],
        regroup_launches=[r["launches"] for r in log],
        default_depth_chains=twins,
        sparse_adam_launches=launches["sparse_adam"],
        sparse_adam_launches_schedule=want,
        main_optimizer_t=tr.opt_state["t"],
        final_phase_moved=final["moved"],
        train_loss=hist[0]["train_loss"],
        final_train_loss=hist[1]["train_loss"],
        examples_per_s_epoch_host_clock=hist[0]["examples_per_s"],
        valid_total_auc=hist[0]["total_auc"],
        valid_mean_auc=hist[0]["mean_auc"],
        valid_final_total_auc=hist[1]["total_auc"],
        valid_final_mean_auc=hist[1]["mean_auc"],
        test_total_auc=res["test"]["total_auc"],
        test_mean_auc=res["test"]["mean_auc"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


# ------------------------------------------------------------------- serve
SERVE_ROWS = 8192
SERVE_BUCKETS = (128, 512, 2048, 8192)
# Depth of the AREAD resume check; the width is the hemp phase's. One
# candidate runs (int(2 * 0.99)); regroup points at steps 0 and 15 of the
# 25-batch domain sequence.
RESUME_DEPTH = {"train_batches": 16, "eval_rows": 2048, "epoch": 2,
                "warm_up_interval": 4, "regroup_interval": 16,
                "regroup_update_step": 2, "regroup_eval_step": 1,
                "candidate_mask_num": 2, "early_stop": 100}


def amazon_spec():
    from aread_tpu_torch.models.base import FeatureSpec

    return FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)


def amazon_split(rng, n_train: int, n_eval: int, aug: bool = False):
    """A SplitData of synthetic Amazon-width rows: train, (augmented,)
    valid and test."""
    from aread_tpu_torch.data.loader import SplitData

    spec = amazon_spec()
    parts = [n_train] * (2 if aug else 1) + [n_eval, n_eval]
    x, y = amazon_rows(rng, spec, sum(parts))
    xs, ys = np.split(x, np.cumsum(parts)[:-1]), np.split(y, np.cumsum(parts)[:-1])
    counts = np.bincount(xs[0][:, spec.domain_idx], minlength=N_DOMAIN)
    if counts.min() == 0:
        raise AssertionError("a domain has no train rows")
    return SplitData(
        train_x=xs[0], train_y=ys[0], valid_x=xs[-2], valid_y=ys[-2],
        test_x=xs[-1], test_y=ys[-1], spec=spec,
        domain_cnt_weight=counts / n_train, n_domain=N_DOMAIN,
        aug_train_x=xs[1] if aug else None, aug_train_y=ys[1] if aug else None)


def serve_trainers(ctx):
    """{name: trainer} of the models the phase serves: the hemp phase's
    AREAD and the train_dense phase's DeepFM and MMoE where those phases
    ran in this process, else the same configurations built here (AREAD
    then under 'rand' masks)."""
    from aread_tpu_torch.config import DOMAIN2GROUP, Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.train.trainer import Trainer

    out = {}
    if "hemp" in ctx:
        out["aread"] = ctx["hemp"]["trainer"]
    else:
        cfg = Config(model="aread", dataset_name="amazon", seed=0)
        tr = AREADTrainer(build_model(cfg, amazon_spec(), N_DOMAIN,
                                      device="cuda"), cfg, N_DOMAIN)
        for d in range(N_DOMAIN):
            tr.mask_state.domain_mask[d] = tr.mask_state.generate_mask(
                "rand", d, cfg.init_active_percent)
        out["aread"] = tr
    d2g = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])
    for name in ("deepfm", "mmoe"):
        if name in ctx.get("dense", {}):
            out[name] = ctx["dense"][name]
        else:
            cfg = Config(model=name, dataset_name="amazon", seed=0,
                         sparse_table_grad=False, table_dtype="float32")
            out[name] = Trainer(build_model(cfg, amazon_spec(), N_DOMAIN,
                                            device="cuda"), cfg, N_DOMAIN, d2g)
    return out


def predict_per_domain(pred, x: np.ndarray) -> np.ndarray:
    """A mixed-domain request served as one request per domain, each
    through 'domain_with_mask' (what a single-domain request takes): the
    reference that the one-forward route is held against."""
    out = np.zeros((len(x),), np.float32)
    domain = x[:, pred.model.spec.domain_idx]
    for d in np.unique(domain):
        idx = np.nonzero(domain == d)[0]
        out[idx] = pred.predict(x[idx])
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def serve_checkpoints(ctx, trainers, tmp: str, x: np.ndarray,
                      phase: str = "serve"):
    """Each model saved, rebuilt from its directory alone on the card and
    on the CPU, and its served probabilities held against the trainer's
    evaluation path. Returns {name: Predictor on the card}."""
    from aread_tpu_torch.models.aread import full_mask
    from aread_tpu_torch.serve.predictor import load_predictor
    from aread_tpu_torch.train.checkpoint import save_checkpoint

    spec = amazon_spec()
    didx = spec.domain_idx
    preds = {}
    for name, tr in trainers.items():
        model = tr.model
        masks = tr.mask_state.domain_mask if name == "aread" else None
        path = os.path.join(tmp, f"{name}_best")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, model.state_dict(), {}, epoch=1,
                        domain_mask=masks, spec=spec, run_config=tr.config,
                        n_domain=N_DOMAIN)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = load_predictor(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if pred.device.type != "cuda":
            raise AssertionError("load_predictor did not build its own "
                                 "model on the card")
        table = pred.model.embedding.table
        if table.shape != model.embedding.table.shape or not torch.equal(
                table, model.embedding.table):
            raise AssertionError(f"{name}: the rebuilt table differs")
        got = pred.predict(x)
        if got.shape != (len(x),) or not np.isfinite(got).all() or not (
                (got >= 0) & (got <= 1)).all():
            raise AssertionError(f"{name}: served probabilities {got[:8]}")
        line = {"model": name, "rows": len(x), "ckpt_bytes": dir_bytes(path),
                "save_s": save_s, "load_predictor_s": load_s,
                "table": [list(table.shape), str(table.dtype)]}
        # (a) against the trainer's evaluation path
        if name == "aread":
            want = np.zeros(len(x), np.float32)
            for d in range(N_DOMAIN):
                idx = np.nonzero(x[:, didx] == d)[0]
                dm = masks[d] if masks[d] is not None else full_mask(
                    model.n_tower)
                want[idx] = tr.eval_prob(
                    {"x": torch.as_tensor(x[idx], device="cuda")},
                    dm).cpu().numpy()
            per_domain = predict_per_domain(pred, x)
            line["mixed_vs_per_domain"] = max_abs(got, per_domain)
            line["per_domain_vs_trainer_eval"] = max_abs(per_domain, want)
            line["domains_without_mask"] = sum(m is None for m in masks)
            line["base_model"] = tr.config.base_model
            if max(line["mixed_vs_per_domain"],
                   line["per_domain_vs_trainer_eval"]) > 1e-6:
                raise AssertionError(f"aread routes disagree: {line}")
            # (b) input order
            perm = np.random.default_rng(1).permutation(len(x))
            line["order_max_abs"] = max_abs(pred.predict(x[perm]), got[perm])
            if line["order_max_abs"] > 1e-6:
                raise AssertionError(f"input order not kept: {line}")
        else:
            xb = torch.as_tensor(x, device="cuda")
            batch = {"x": xb}
            if tr.domain2group is not None:
                batch["group"] = torch.as_tensor(
                    tr.domain2group, device="cuda")[xb[:, didx].long()]
            want = tr.eval_prob(batch).cpu().numpy()
            if name == "mmoe" and (pred.domain2group is None or not
                                   np.array_equal(pred.domain2group,
                                                  tr.domain2group)):
                raise AssertionError("mmoe: domain2group not rebuilt")
        line["vs_trainer_eval"] = max_abs(got, want)
        if line["vs_trainer_eval"] > 1e-6:
            raise AssertionError(f"{name}: served != evaluated: {line}")
        # (c) the same checkpoint on the CPU
        t0 = time.perf_counter()
        cpu = load_predictor(path, device='cpu')
        cpu_got = cpu.predict(x)
        line["cpu_load_and_predict_s"] = time.perf_counter() - t0
        line["card_vs_cpu"] = max_abs(got, cpu_got)
        if cpu.device.type != "cpu" or line["card_vs_cpu"] > 1e-5:
            raise AssertionError(f"{name}: card != CPU: {line}")
        del cpu
        if pred.predict(x[:0]).shape != (0,):
            raise AssertionError("an empty request")
        say(phase, part="checkpoint+predictor", tolerance_eval=1e-6,
            tolerance_cpu=1e-5, **line)
        preds[name] = pred
    return preds


def http_call(url: str, body=None):
    """(status, decoded JSON, seconds) of one request."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.load(r)
    except urllib.error.HTTPError as e:
        status, out = e.code, json.load(e)
    return status, out, time.perf_counter() - t0


def single_domain(x: np.ndarray, d: int) -> np.ndarray:
    out = x.copy()
    out[:, amazon_spec().domain_idx] = d
    return out


def serve_http(pred, x: np.ndarray):
    """The server on a thread: health, requests of 1 to 8,192 rows single-
    and mixed-domain (status 200 and the numbers of pred.predict, never
    only that an answer came: the server turns every exception into a
    400), a malformed request, a clean shutdown. Returns the round-trip
    medians (ms) by (rows, kind)."""
    from aread_tpu_torch.serve.server import make_server

    srv = make_server(pred, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    times = {}
    try:
        base = "http://%s:%d" % srv.server_address
        status, out, _ = http_call(f"{base}/healthz")
        if status != 200 or out != {"status": "ok"}:
            raise AssertionError(f"/healthz: {status} {out}")
        for n in (1, 100) + SERVE_BUCKETS:
            for kind, rows in (("single", single_domain(x[:n], 3)),
                               ("mixed", x[:n])):
                if n == 1 and kind == "mixed":
                    continue  # one row has one domain
                body = json.dumps({"x": rows.tolist()}).encode()
                want = pred.predict(rows)
                secs = []
                for _ in range(5):
                    status, out, s = http_call(f"{base}/predict", body)
                    if status != 200:
                        raise AssertionError(f"/predict {n} {kind}: "
                                             f"{status} {out}")
                    got = np.asarray(out["prob"], np.float32)
                    if got.shape != (n,) or max_abs(got, want) > 1e-6:
                        raise AssertionError(
                            f"/predict {n} {kind}: served numbers differ "
                            f"from predict by {max_abs(got, want)}")
                    secs.append(s)
                times[f"{n}_{kind}"] = statistics.median(secs) * 1e3
        for body in (b'{"x": 3}', b"not json"):
            status, out, _ = http_call(f"{base}/predict", body)
            if status != 400 or "error" not in out:
                raise AssertionError(f"malformed request: {status} {out}")
        if http_call(f"{base}/nothing")[0] != 404:
            raise AssertionError("an unknown path did not give 404")
        if http_call(f"{base}/healthz")[0] != 200:
            raise AssertionError("the server did not outlive a bad request")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    return times


def serve_request_numbers(pred, req: np.ndarray, copies_want: int) -> dict:
    """One request's numbers on ``pred``'s current dispatch: the served
    probabilities, median of 20 calls by CUDA events and by the host clock
    (each call ends in its device-to-host copy), cudaMemcpyAsync calls (held
    to ``copies_want``) and their kinds, launch calls, graph launches,
    kernels and busy ms (torch.profiler over 4 calls), the idle share of
    the unprofiled call (busy ms over the host clock's); on the
    eager path also the launch calls by ``cuda_launches_per_call``, the
    measure of earlier runs."""
    out = pred.predict(req)
    ev, host = event_ms(lambda: pred.predict(req), n=20)
    copies, kinds = cuda_copies_per_call(lambda: pred.predict(req))
    assert_copies(f"a {pred.evals.name} {pred.mode_of(req)} request of "
                  f"{len(req)} rows", copies, kinds, copies_want)
    _, prof = chunk_profile(lambda: [pred.predict(req) for _ in range(4)], 4)
    if pred.evals.name == "eager":
        prof["launches"] = cuda_launches_per_call(lambda: pred.predict(req))
    prof["device_idle_share_unprofiled"] = 1 - prof["device_busy_ms"] / host
    return {"out": out, "events_ms": ev, "host_clock_ms": host,
            "copies": copies, "copy_kinds": kinds,
            **{k: prof[k] for k in ("cudaLaunchKernel", "cudaGraphLaunch",
                                    "kernels_run", "device_busy_ms",
                                    "device_idle_share_unprofiled",
                                    "launches")
               if k in prof}}


def serve_request_twins(pred, req: np.ndarray, copies: dict,
                        turn: int) -> dict:
    """``serve_request_numbers`` by CUDA graph (the card's dispatch) and by
    the eager twin (``eager_evals``), in turns by ``turn``; the two served
    probabilities bitwise equal. ``copies``: per dispatch the copies a
    request makes."""
    rec = {}
    for name in (("graph", "eager") if turn % 2 == 0 else ("eager", "graph")):
        with (contextlib.nullcontext() if name == "graph"
              else eager_evals(pred)):
            if pred.evals.name != name:
                raise AssertionError(f"a request dispatched "
                                     f"{pred.evals.name}, not {name}")
            rec[name] = serve_request_numbers(pred, req, copies[name])
    a, b = (rec[k].pop("out") for k in ("graph", "eager"))
    if a.dtype != b.dtype or not np.array_equal(a.view(np.uint32),
                                                b.view(np.uint32)):
        raise AssertionError(f"a {pred.mode_of(req)} request of {len(req)} "
                             f"rows: graph != eager by {max_abs(a, b)}")
    rec["bitwise"] = True
    return rec


def sync_debug_request(pred, req: np.ndarray) -> None:
    """The body that ``pred``'s graph of ``req``'s (mode, bucket) captured
    run once eagerly on its static input under
    torch.cuda.set_sync_debug_mode('error')."""
    from aread_tpu_torch.serve.predictor import _bucket

    g, mode = pred.evals, pred.mode_of(req)
    buf = g.buf[f"serve {mode} {[_bucket(len(req)), req.shape[1]]}"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            g.serve_body(pred.request(mode), buf)()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def serve_times(preds, x: np.ndarray, http_ms):
    """Request time per bucket and mode (AREAD single- and mixed-domain,
    DeepFM and MMoE at every bucket too) by CUDA graph and by the eager
    twin in turns (``serve_request_twins``: bitwise equal, times by both
    clocks, launches, kernels, busy ms, idle share; by graph one copy in and one
    out for every model, eagerly DeepFM and MMoE with an f32 table also
    copy their gathered rows on the device), the HTTP round trip beside
    them; a captured request under sync debug mode 'error'; the host's
    JSON work of a request apart from the device's."""
    pred = preds["aread"]
    rows, turn = [], 0
    for n in SERVE_BUCKETS:
        for kind, req in (("single", single_domain(x[:n], 3)),
                          ("mixed", x[:n])):
            rows.append({"rows": n, "kind": kind,
                         "http_round_trip_ms": http_ms[f"{n}_{kind}"],
                         **serve_request_twins(
                             pred, req, {"graph": 2, "eager": 2}, turn)})
            turn += 1
    ev, host = event_ms(lambda: predict_per_domain(pred, x), n=5)
    per_domain = {"rows": len(x), "events_ms": ev, "host_clock_ms": host}
    others = {}
    for name in ("deepfm", "mmoe"):
        others[name] = [{"rows": n, **serve_request_twins(
            preds[name], x[:n], {"graph": 2, "eager": 3}, turn + i)}
            for i, n in enumerate(SERVE_BUCKETS)]
    sync_debug_request(pred, x[:SERVE_BUCKETS[0]])
    # the host's share of an 8,192-row HTTP request, timed alone
    body = json.dumps({"x": x.tolist()})
    prob = pred.predict(x)
    t0 = time.perf_counter()
    np.asarray(json.loads(body)["x"], dtype=np.int64)
    decode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    json.dumps({"prob": [float(p) for p in prob]})
    encode_ms = (time.perf_counter() - t0) * 1e3
    say("serve", part="times", model="aread", requests=rows,
        http_round_trip_ms=http_ms,
        per_domain_loop=per_domain, other_models=others,
        captures={k: p.evals.eval_captures for k, p in preds.items()},
        sync_debug_error_request="passed",
        json_8192_rows_ms={"decode_request": decode_ms,
                           "encode_answer": encode_ms,
                           "request_bytes": len(body)})


def serve_streaming_eval(ctx, trainers):
    """evaluate() with streaming_eval against the exact path on the same
    split, both trainers, within the bounds of the JAX package's tests."""
    import dataclasses

    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.train.hemp import AREADTrainer

    spec = amazon_spec()
    rng = np.random.default_rng(5)
    x, y = amazon_rows(rng, spec, SERVE_ROWS)
    weight = np.bincount(x[:, spec.domain_idx], minlength=N_DOMAIN) / len(x)

    def run(tr, streaming):
        cfg = tr.config
        tr.config = dataclasses.replace(cfg, streaming_eval=streaming)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if isinstance(tr, AREADTrainer):
                res = tr.evaluate(
                    DomainBatcher(x, y, cfg.bs * 8, spec.domain_idx, N_DOMAIN,
                                  shuffle=False), weight,
                    final=ctx.get("hemp", {}).get("final", False))
            else:
                res = tr.evaluate(x, y, weight)
        finally:
            tr.config = cfg
        return res, time.perf_counter() - t0

    for name, auc_tol in (("aread", 3e-3), ("deepfm", 8e-3)):
        tr = trainers[name]
        exact, exact_s = run(tr, False)
        stream, stream_s = run(tr, True)
        if name == "deepfm":
            # DeepFM saturates on these rows, and a saturated, wrong row
            # costs -log(1e-15) on the exact path and -log(1e-7) on the
            # streaming one: hold the streaming loss to the same
            # predictions' BCE at the streaming path's f32 epsilon
            xb = torch.as_tensor(x, device="cuda")
            prob = tr.eval_prob({"x": xb, "group": torch.as_tensor(
                tr.domain2group, device="cuda")[xb[:, spec.domain_idx].long()]})
            p = torch.clamp(prob, 1e-7, 1 - 1e-7)
            yt = torch.as_tensor(y, device="cuda").to(torch.float32)
            bce = -(yt * torch.log(p) + (1 - yt) * torch.log1p(-p))
            exact = dict(exact, total_loss=float(bce.double().mean()))
        gaps = {k: abs(stream[k] - exact[k])
                for k in ("total_auc", "mean_auc", "total_loss")}
        say("serve", part="streaming_eval", model=name, rows=len(x),
            auc_bins=tr.config.auc_bins,
            exact={k: exact[k] for k in gaps},
            streaming={k: stream[k] for k in gaps}, gap=gaps,
            bounds={"total_auc": auc_tol, "total_loss": 1e-5},
            exact_s=exact_s, streaming_s=stream_s)
        if set(stream) != set(exact) or set(stream["domain_auc"]) != set(
                exact["domain_auc"]):
            raise AssertionError("streaming eval: another result dict")
        if not (gaps["total_auc"] < auc_tol and gaps["total_loss"] < 1e-5):
            raise AssertionError(f"{name}: streaming eval gap {gaps}")


def state_max_diff(a, b) -> float:
    """Largest absolute difference between two trainers' weights, buffers
    and table moments; the step counts must be equal."""
    worst = 0.0
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        worst = max(worst, float((sa[k].float() - sb[k].float()).abs().max()))
    for k in ("m", "v"):
        worst = max(worst, float((a.opt_state[k].float()
                                  - b.opt_state[k].float()).abs().max()))
    for k in ("mu", "nu"):
        for n, v in a.opt_state["inner"][k].items():
            worst = max(worst, float(
                (v - b.opt_state["inner"][k][n]).abs().max()))
    if (a.opt_state["t"], a.opt_state["inner"]["count"]) != (
            b.opt_state["t"], b.opt_state["inner"]["count"]):
        raise AssertionError("resumed step counts differ")
    return worst


def serve_resume_dense(ctx, tmp: str):
    """fit(ckpt_dir=) for one epoch, a fresh trainer resumes at epoch 1:
    after the second epoch its weights and moments equal those of an
    uninterrupted 2-epoch run (dropout on: the generator's state is part
    of the checkpoint)."""
    import dataclasses

    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    n_steps = 12
    data = amazon_split(np.random.default_rng(6), n_steps * BS, 2048)
    d2g = ctx["serve_d2g"]

    def make():
        cfg = Config(model="deepfm", dataset_name="amazon", seed=0,
                     sparse_table_grad=False, table_dtype="float32",
                     early_stop=100)
        return Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                       cfg, N_DOMAIN, d2g)

    ckpt = os.path.join(tmp, "deepfm_elastic")
    whole, first, second = make(), make(), make()
    t0 = time.perf_counter()
    res_whole = counted(ctx, "serve/resume_deepfm_whole",
                        lambda: whole.fit(data, epochs=2, verbose=False))
    counted(ctx, "serve/resume_deepfm_first", lambda: first.fit(
        data, epochs=1, verbose=False, ckpt_dir=ckpt))
    ckpt_bytes = dir_bytes(ckpt)
    res = counted(ctx, "serve/resume_deepfm_resumed", lambda: second.fit(
        data, epochs=2, verbose=False, ckpt_dir=ckpt))
    secs = time.perf_counter() - t0
    launches = [ctx["launches_by_path"][f"serve/resume_deepfm_{k}"]
                for k in ("whole", "first", "resumed")]
    want = [{"sparse_adam": 0, "fused_adam": n}
            for n in (2 * n_steps, n_steps, n_steps)]
    if launches != want:
        raise AssertionError(f"resume launches {launches}, expected {want}")
    if len(res["history"]) != 1 or second.opt_state["t"] != 2 * n_steps:
        raise AssertionError("the resumed trainer did not start at epoch 1")
    diff = state_max_diff(second, whole)
    auc_gap = abs(res["history"][0]["total_auc"]
                  - res_whole["history"][1]["total_auc"])
    say("serve", part="resume", model="deepfm", steps_per_epoch=n_steps,
        resumable_ckpt_bytes=ckpt_bytes, seconds_three_fits=secs,
        max_abs_diff_vs_uninterrupted=diff, valid_auc_gap=auc_gap,
        tolerance=1e-5, launches=launches)
    if diff > 1e-5 or auc_gap > 1e-6:
        raise AssertionError(f"resumed != uninterrupted: {diff}, {auc_gap}")


def domain_batches(cfg, data) -> int:
    """Single-domain batches of one epoch of AREADTrainer.fit."""
    counts = np.bincount(data.train_x[:, data.spec.domain_idx],
                         minlength=data.n_domain)
    return int(np.sum(np.ceil(counts / cfg.bs)))


def regroups_per_epoch(cfg, data) -> int:
    """Regroup points inside one epoch of AREADTrainer.fit (the first
    regroup, at the start of training, is not among them)."""
    interval = cfg.regroup_interval * 1024 // cfg.bs
    return sum((i + 1) % interval == 0
               for i in range(domain_batches(cfg, data)))


def chains_of_fit(cfg, data, epochs: int) -> int:
    """Fast-adapt chains of ``epochs`` epochs of AREADTrainer.fit: one per
    domain and candidate at every regroup."""
    n_regroup = 1 + epochs * regroups_per_epoch(cfg, data)
    return sum(data.n_domain
               * max(1, int(cfg.candidate_mask_num * 0.99 ** (r + 1)))
               for r in range(n_regroup))


def sparse_adam_launches_of_fit(cfg, data, epochs: int) -> int:
    """sparse_adam launches of ``epochs`` epochs of AREADTrainer.fit: the
    warm-up steps, every bagging step, and every fast-adapt step of every
    regroup's chains (one chain per domain and candidate)."""
    warm = cfg.warm_up_interval * 1024 // cfg.bs
    return (warm + epochs * domain_batches(cfg, data)
            + chains_of_fit(cfg, data, epochs) * cfg.regroup_update_step)


def serve_resume_aread(ctx, tmp: str):
    """AREADTrainer.fit(ckpt_dir=) for one epoch at a cut depth, then a
    fresh trainer resumes at epoch 1: it enters the epoch holding exactly
    what was saved, and after it its weights, moments, masks and schedule
    equal those of an uninterrupted 2-epoch run (the checkpoint holds the
    batchers' and the mask generator's positions too). The sparse_adam
    launches of every run are the schedule's."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer

    depth = dict(RESUME_DEPTH)
    n_train = depth.pop("train_batches") * BS
    data = amazon_split(np.random.default_rng(7), n_train,
                        depth.pop("eval_rows"), aug=True)
    cfg = Config(model="aread", dataset_name="amazon", seed=0, **depth)

    def make():
        return AREADTrainer(build_model(cfg, data.spec, N_DOMAIN,
                                        device="cuda"), cfg, N_DOMAIN)

    ckpt = os.path.join(tmp, "aread_elastic")
    whole, first, second = make(), make(), make()
    t0 = time.perf_counter()
    res_whole = counted(ctx, "serve/resume_aread_whole", lambda: whole.fit(
        data, epochs=2, verbose=False))
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counted(ctx, "serve/resume_aread_first", lambda: first.fit(
        data, epochs=1, verbose=False, ckpt_dir=ckpt))
    first_s = time.perf_counter() - t0
    ckpt_bytes = dir_bytes(ckpt)
    saved = {"weights": first._snapshot(),
             "m": first.opt_state["m"].clone(),
             "v": first.opt_state["v"].clone(), "t": first.opt_state["t"],
             "masks": first._copy_masks(), "sched": first.hemp_schedule(),
             "gen": first.generator.get_state()}
    entered = {}
    epoch = second.train_epoch

    def train_epoch(epoch_i, *a, **kw):
        live = second.model.state_dict()
        entered["epoch_i"] = epoch_i
        entered["exact"] = (
            all(torch.equal(live[k], v) for k, v in saved["weights"].items())
            and torch.equal(second.opt_state["m"], saved["m"])
            and torch.equal(second.opt_state["v"], saved["v"])
            and second.opt_state["t"] == saved["t"]
            and all(masks_equal(a_, b_) for a_, b_ in zip(
                second.mask_state.domain_mask, saved["masks"]))
            and second.hemp_schedule() == saved["sched"]
            and torch.equal(second.generator.get_state(), saved["gen"]))
        return epoch(epoch_i, *a, **kw)

    second.train_epoch = train_epoch
    t0 = time.perf_counter()
    res = counted(ctx, "serve/resume_aread_resumed", lambda: second.fit(
        data, epochs=2, verbose=False, ckpt_dir=ckpt))
    resumed_s = time.perf_counter() - t0
    if entered != {"epoch_i": 1, "exact": True} or len(res["history"]) != 1:
        raise AssertionError(f"resume entered {entered}")
    diff = state_max_diff(second, whole)
    same_masks = all(masks_equal(a, b) for a, b in zip(
        res["domain_mask"], res_whole["domain_mask"]))
    auc_gap = abs(res["history"][0]["total_auc"]
                  - res_whole["history"][1]["total_auc"])
    # --- what the schedule implies
    per_epoch = regroups_per_epoch(cfg, data)
    want_first = sparse_adam_launches_of_fit(cfg, data, 1)
    want_whole = sparse_adam_launches_of_fit(cfg, data, 2)
    want = {"whole": want_whole, "first": want_first,
            "resumed": want_whole - want_first}
    launches = {k: ctx["launches_by_path"][f"serve/resume_aread_{k}"]
                for k in want}
    say("serve", part="resume", model="aread", depth=RESUME_DEPTH,
        resumable_ckpt_bytes=ckpt_bytes, whole_fit_s=whole_s,
        first_fit_s=first_s, resumed_fit_s=resumed_s,
        regroups={"whole": whole.regroup_times, "first": first.regroup_times,
                  "resumed": second.regroup_times},
        entered_epoch_1_with_saved_state=True,
        max_abs_diff_vs_uninterrupted=diff, masks_equal=same_masks,
        valid_auc_gap=auc_gap, schedule=second.hemp_schedule(),
        tolerance=1e-5, launches=launches,
        sparse_adam_launches_schedule=want)
    if per_epoch < 1 or (whole.regroup_times, first.regroup_times,
                         second.regroup_times) != (
            1 + 2 * per_epoch, 1 + per_epoch, 1 + 2 * per_epoch):
        raise AssertionError("the resumed run did not go on with the "
                             "saved schedule")
    if launches != {k: {"sparse_adam": n, "fused_adam": 0}
                    for k, n in want.items()}:
        raise AssertionError(f"resume launches {launches}, the schedule "
                             f"implies {want}")
    if diff > 1e-5 or auc_gap > 1e-6 or not same_masks or (
            second.hemp_schedule() != whole.hemp_schedule()):
        raise AssertionError(f"resumed != uninterrupted: {diff}, {auc_gap}, "
                             f"masks equal: {same_masks}")


def canonical_aliccp_frame(n: int, seed: int, n_domain: int = 4,
                           vocab: int = 40):
    """A small canonical aliccp training frame made from a seed; the label
    follows the item id."""
    import pandas as pd

    from aread_tpu_torch.data.loader import dataset_columns

    rng = np.random.default_rng(seed)
    one_hot, _, label = dataset_columns("aliccp")
    cols = {c: rng.integers(0, {"itemid": vocab, "domain": n_domain}.get(c, 6),
                            n) for c in one_hot}
    cols[label] = ((cols["itemid"] % 7) / 3.0 - 1.0
                   + 0.3 * rng.standard_normal(n) > 0).astype(int)
    cols["train_tag"] = rng.choice([0, 1, 2], n, p=[0.8, 0.1, 0.1])
    return pd.DataFrame(cols)


def serve_cli(tmp: str):
    """Both CLIs as a user calls them, in subprocesses on the card, on a
    seed-made canonical CSV (small vocabulary: this part is about the
    entry points, not the width): train AREAD, then score a CSV; the
    written probabilities equal load_predictor(...).predict."""
    import pandas as pd

    from aread_tpu_torch.data.loader import dataset_columns, tensorize
    from aread_tpu_torch.data.pipeline import preprocessed_csv_path
    from aread_tpu_torch.serve.predictor import load_predictor

    root = os.path.dirname(os.path.abspath(__file__))
    data_path, save_path = os.path.join(tmp, "dataset"), os.path.join(tmp, "save")
    csv = preprocessed_csv_path("aliccp", data_path)
    os.makedirs(os.path.dirname(csv))
    canonical_aliccp_frame(3000, seed=11).to_csv(csv, index=False)
    env = dict(os.environ, AREAD_TPU_CACHE="0")

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(
                f"python -m {' '.join(args)} exited {proc.returncode}\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        return proc.stdout, time.perf_counter() - t0

    out, train_s = run(
        "aread_tpu_torch", "--model", "aread", "--dataset_name", "aliccp",
        "--data_path", data_path, "--save_path", save_path, "--bs", "256",
        "--embed_dim", "8", "--epoch", "1", "--warm_up_interval", "1",
        "--regroup_interval", "8", "--candidate_mask_num", "2",
        "--regroup_update_step", "2", "--regroup_eval_step", "2",
        "--elastic")
    best = os.path.join(save_path, "aliccp", "aread_best")
    for piece in ("generated augmentation:", "regroup 1:", "epoch 1: train_loss=",
                  f"checkpoint saved: {best}", "test: {"):
        if piece not in out:
            raise AssertionError(f"the training CLI did not print {piece!r}:"
                                 f"\n{out[-2000:]}")
    if not os.path.exists(os.path.join(save_path, "aliccp", "aread_elastic",
                                       "meta.json")):
        raise AssertionError("--elastic wrote no resumable checkpoint")
    frame = canonical_aliccp_frame(1000, seed=12).drop(columns=["click"])
    inp, outp = os.path.join(tmp, "score.csv"), os.path.join(tmp, "preds.csv")
    frame.to_csv(inp, index=False)
    _, serve_s = run("aread_tpu_torch.serve", "--ckpt", best, "--input", inp,
                     "--output", outp)
    got = pd.read_csv(outp)["prob"].to_numpy()
    pred = load_predictor(best)
    one_hot, seq_cols, label = dataset_columns("aliccp")
    frame[label] = 0
    spec = pred.model.spec
    x, _ = tensorize(frame, one_hot, seq_cols, label, spec.seq_maxlen,
                     spec.one_hot_dims[spec.itemid_idx] - 1)
    want = pred.predict(x)
    diff = max_abs(got, want)
    say("serve", part="cli", train_cli_s=train_s, serve_cli_s=serve_s,
        scored_rows=len(got), masks_in_checkpoint=sum(
            m is not None for m in pred.domain_mask),
        scored_vs_predict=diff, tolerance=1e-6)
    if len(got) != 1000 or diff > 1e-6 or any(m is None
                                              for m in pred.domain_mask):
        raise AssertionError(f"the scored file differs from predict: {diff}")


def phase_serve(ctx):
    """From a trained model to an answered request, at full Amazon width
    (the CLI part apart), and what the trainers gained with it: streaming
    evaluation and resume."""
    from aread_tpu_torch.config import DOMAIN2GROUP

    torch.cuda.reset_peak_memory_stats()
    ctx["serve_d2g"] = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])
    trainers = serve_trainers(ctx)
    x, _ = amazon_rows(np.random.default_rng(4), amazon_spec(), SERVE_ROWS)
    if len(np.unique(x[:, amazon_spec().domain_idx])) != N_DOMAIN:
        raise AssertionError("the request rows do not cover all domains")
    with tempfile.TemporaryDirectory(prefix="aread_serve_") as tmp:
        preds = serve_checkpoints(ctx, trainers, tmp, x)
        http_ms = serve_http(preds["aread"], x)
        serve_times(preds, x, http_ms)
        del preds
        serve_streaming_eval(ctx, trainers)
        # the earlier phases' trainers are done with: free their tables
        trainers.clear()
        for key in ("hemp", "dense", "eval", "profile_args",
                    "dense_profile_args", "hemp_profile_args"):
            ctx.pop(key, None)
        torch.cuda.empty_cache()
        serve_resume_dense(ctx, tmp)
        serve_resume_aread(ctx, tmp)
        serve_cli(tmp)
    say("serve", part="done",
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


# ----------------------------------------------------------------- options
# One regroup of the hemp phase's shape: 25 domains x int(3 * 0.99) = 2
# candidates = 50 chains of 3 adapt steps and 2 probes
OPTIONS_HEMP = {"regroup_update_step": 3, "regroup_eval_step": 2,
                "candidate_mask_num": 3}
# the largest field scaled up so that the table passes the JAX package's
# 'auto' crossover (240M elements): 7,750,095 rows x 32 = 248,003,040
BIG_DIMS = (7_600_000,) + AMAZON_DIMS[1:]


def overlay_launches(chains: int, regroups: int, cfg) -> int:
    """fused_adam launches of overlay evolutions: per chain S compact
    steps, S drift steps per probe batch and S for the L2 correction; S
    per regroup for the whole-table drift (S = regroup_update_step)."""
    s = cfg.regroup_update_step
    return chains * s * (2 + cfg.regroup_eval_step) + regroups * s


def aread_overlay_trainer(dims, device="cuda", **cfg_kw):
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.train.hemp import AREADTrainer

    cfg = Config(model="aread", dataset_name="amazon", seed=0,
                 **{**OPTIONS_HEMP, **cfg_kw})
    return AREADTrainer(build_model(cfg, FeatureSpec(dims, 2, 0, 2, 5),
                                    N_DOMAIN, device=device), cfg, N_DOMAIN)


def options_overlay(ctx, tmp: str):
    """One 50-chain evolution of each engine at full Amazon width (bf16
    table and moments) from the same weights, masks and streams: ms per
    chain, each kernel's launches, peak memory (a chain's CUDA launches
    and device time: options_overlay_large)."""
    from aread_tpu_torch.data.loader import DomainBatcher

    rng = np.random.default_rng(6)
    runs = {}
    for engine in ("full", "overlay"):
        tr = aread_overlay_trainer(AMAZON_DIMS, hemp_fast_adapt=engine)
        if engine == "full":
            x, y = amazon_rows(rng, tr.model.spec, N_DOMAIN * 4 * BS)
            weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(weights)
        tr.init()
        if tr.overlay_enabled() != (engine == "overlay"):
            raise AssertionError(f"{engine}: the trainer picked the other "
                                 "engine")
        records = spy_evolutions(tr)
        batchers = [DomainBatcher(x, y, BS, tr.model.spec.domain_idx,
                                  N_DOMAIN, seed=s) for s in (1, 2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted(ctx, f"options/evolution_{engine}",
                lambda: tr._mask_evolution(*batchers, verbose=False))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log = tr.regroup_log[-1]
        runs[engine] = dict(
            trainer=tr, records=records, chains=log["chains"],
            ms_per_chain=log["seconds"] / log["chains"] * 1e3,
            peak_mem_gb=peak,
            kernel_launches=ctx["launches_by_path"][
                f"options/evolution_{engine}"])
    cfg = runs["overlay"]["trainer"].config
    chains = runs["full"]["chains"]
    want = {"full": {"sparse_adam": chains * cfg.regroup_update_step,
                     "fused_adam": 0},
            "overlay": {"sparse_adam": 0,
                        "fused_adam": overlay_launches(chains, 1, cfg)}}
    for engine, r in runs.items():
        if r["chains"] != 50 or r["kernel_launches"] != want[engine]:
            raise AssertionError(f"{engine}: {r['chains']} chains launched "
                                 f"{r['kernel_launches']}, the schedule "
                                 f"implies {want[engine]}")
    a = [l for d in runs["full"]["records"][0]["losses"] for z in d for l in z]
    b = [l for d in runs["overlay"]["records"][0]["losses"] for z in d
         for l in z]
    # on a bf16 table the engines differ by the full sweep's rounding of
    # w every step; a prune decision can flip with it
    same = [masks_equal(x, y) for d, e in zip(
        runs["full"]["records"][0]["candidates"],
        runs["overlay"]["records"][0]["candidates"]) for x, y in zip(d, e)]
    if not np.isfinite(b).all():
        raise AssertionError("non-finite overlay probe losses")
    elems = runs["full"]["trainer"].model.spec.n_rows * EMBED_DIM
    say("options", part="overlay_evolution", table_elems=elems,
        table_dtype=cfg.table_dtype, chains=chains, **{
            engine: {k: v for k, v in r.items()
                     if k not in ("trainer", "records")}
            for engine, r in runs.items()},
        kernel_launches_per_chain={
            e: {k: v / chains for k, v in r["kernel_launches"].items()}
            for e, r in runs.items()},
        fused_adam_per_regroup_beside_chains=cfg.regroup_update_step,
        pruned_masks_equal_between_engines_bf16=f"{sum(same)}/{len(same)}",
        probe_loss_max_abs_diff_bf16_engines=float(
            np.max(np.abs(np.array(a) - np.array(b)))))
    del runs
    torch.cuda.empty_cache()


# candidates of each chain_times regroup: 2 eager, a capture, 4 replays
CHAIN_CANDIDATES = 6


def chain_times(ctx, label: str, dims, rng):
    """Per engine on a table of ``dims`` (bf16 table and moments, the
    options' S and P): a regroup of CHAIN_CANDIDATES candidates through
    ``run_chains`` by graph and by an eager twin from one seed, in turns
    (graph, eager, eager, graph), bitwise after each pair, with each run's
    kernel launches held to the schedule; per dispatch the ms per chain
    (CUDA events and host clock) and per chain launch calls, kernels
    and device busy ms (``chain_replays``); and the whole-table drift
    L2's ms (once per regroup; 0 for the full sweep). Returns (the
    table's elements, whether 'auto' picks the overlay for it, per engine
    those numbers)."""
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.ops import overlay_adam as oa
    from aread_tpu_torch.train.trainer import TABLE_L2

    def make():
        t = aread_overlay_trainer(dims)
        t.init()
        return t

    trs = chain_twin_trainers(make)
    tr = trs["graph"]
    cfg, spec = tr.config, tr.model.spec
    x, y = amazon_rows(rng, spec, N_DOMAIN * 4 * BS)
    inputs = chain_inputs(tr, DomainBatcher(x, y, BS, spec.domain_idx,
                                            N_DOMAIN, seed=3),
                          CHAIN_CANDIDATES)
    n, S = CHAIN_CANDIDATES, cfg.regroup_update_step
    out = {}
    for engine in ("full", "overlay"):
        ov = engine == "overlay"
        want = ({"sparse_adam": 0, "fused_adam": overlay_launches(n, 1, cfg)}
                if ov else {"sparse_adam": n * S, "fused_adam": 0})
        runs = chain_twins(ctx, f"options/chains_{label}_{engine}", trs,
                           inputs, ov, (("graph", "eager"),
                                        ("eager", "graph")), want)
        per = {name: chain_replays(t, inputs, ov, ctx,
                                   f"options/replays_{label}_{engine}_{name}")
               for name, t in trs.items()}
        table = tr.model.embedding.table
        out[engine] = {
            "regroups": runs, "by_dispatch": per,
            # the graph's numbers: what a card's regroup takes
            "chain_ms_host_clock": per["graph"]["chain_ms_host_clock"],
            "device_busy_ms": per["graph"]["device_busy_ms"],
            "drift_l2_ms": event_ms(lambda: oa.drift_table_l2(
                table, S, cfg.update_lr, cfg.wd, TABLE_L2), n=3)[1]
            if ov else 0.0}
    elems, auto = spec.n_rows * EMBED_DIM, tr.overlay_enabled()
    del trs, tr, table
    torch.cuda.empty_cache()
    return elems, auto, out


def options_overlay_large(ctx, tmp: str):
    """Each engine's chains on the Amazon table and on one past 240M
    elements, by graph and by an eager twin (``chain_times``), and where
    the two engines cross: each engine's time per chain by graph (the
    overlay's whole-table drift shared by a regroup's 50 chains) taken as
    linear in the table's size between the two tables, once by the host
    clock (what a regroup takes) and once by device busy time."""
    from aread_tpu_torch.train.hemp import OVERLAY_AUTO_MIN_ELEMS

    rng = np.random.default_rng(9)
    e1, _, small = chain_times(ctx, "amazon", AMAZON_DIMS, rng)
    e2, auto, big = chain_times(ctx, "big", BIG_DIMS, rng)
    if e2 < OVERLAY_AUTO_MIN_ELEMS or not auto:
        raise AssertionError(f"{e2} elements: not past the crossover")

    def crossing(key):
        per = {e: [statistics.median(np.atleast_1d(t[e][key]))
                   + t[e]["drift_l2_ms"] / 50 for t in (small, big)]
               for e in ("full", "overlay")}
        slope = ((per["full"][1] - per["full"][0])
                 - (per["overlay"][1] - per["overlay"][0])) / (e2 - e1)
        gap = per["overlay"][0] - per["full"][0]
        return per, (e1 + gap / slope if slope > 0 else None)

    host, host_cross = crossing("chain_ms_host_clock")
    dev, dev_cross = crossing("device_busy_ms")
    say("options", part="overlay_crossover", table_elems=[e1, e2],
        amazon=small, big=big,
        ms_per_chain_with_drift_share={"host_clock": host, "device": dev},
        crossover_table_elems={"host_clock": host_cross, "device": dev_cross},
        jax_package_auto_threshold=OVERLAY_AUTO_MIN_ELEMS)


def options_overlay_reference(ctx, tmp: str):
    """A 2-domain evolution at full Amazon width with an f32 table and
    moments (2 candidates each, 2 adapt steps and 2 probes a chain): the
    overlay on the card against the overlay on the CPU (masks equal,
    probe losses atol 1e-5 + 2 f32 ulp, as `reference` holds the full
    sweep), and against the full sweep on the card (masks equal, probe
    losses rtol 2e-4 atol 2e-5, the JAX package's bound between its two
    engines)."""
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models.base import FeatureSpec

    n_domain = 2
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    rng = np.random.default_rng(5)
    x, y = amazon_rows(rng, spec, 8 * BS)
    x[:, spec.domain_idx] = rng.integers(0, n_domain, size=len(x))
    runs = {}
    pat = r"^(mmoe_experts|towers_\d+)/linear_\d+/bias$"
    for dev, engine in (("cpu", "overlay"), ("cuda", "overlay"),
                        ("cuda", "full")):
        tr = build_trainer(
            spec, dev, n_domain, n_tower=3, dataset_name="amazon", seed=0,
            dropout=0.0, table_dtype="float32", table_moments_dtype="float32",
            regroup_update_step=2, regroup_eval_step=2, candidate_mask_num=3,
            hemp_fast_adapt=engine)
        tr.optimizer = true_zero_adam(pat, tr.config.lr, tr.config.wd)
        tr.fast_optimizer = true_zero_adam(pat, tr.config.update_lr,
                                           tr.config.wd)
        if runs:
            tr.model.load_state_dict(runs["cpu"][0].model.state_dict())
        records = spy_evolutions(tr)
        batchers = [DomainBatcher(x, y, BS, spec.domain_idx, n_domain, seed=s)
                    for s in (1, 2)]
        t0 = time.perf_counter()
        key = f"options/reference_{engine}"
        if dev == "cuda":
            counted(ctx, key, lambda: tr._mask_evolution(*batchers,
                                                         verbose=False))
        else:
            tr._mask_evolution(*batchers, verbose=False)
        runs[dev if engine == "overlay" else "full"] = (
            tr, records[0], time.perf_counter() - t0)
    launches = {k: ctx["launches_by_path"].pop(f"options/reference_{k}")
                for k in ("overlay", "full")}
    cfg = runs["cuda"][0].config
    want = {"overlay": {"sparse_adam": 0,
                        "fused_adam": overlay_launches(4, 1, cfg)},
            "full": {"sparse_adam": 4 * 2, "fused_adam": 0}}
    if launches != want:
        raise AssertionError(f"reference evolutions launched {launches}, "
                             f"the schedule implies {want}")
    diffs = {}
    for other, rtol, atol in (("cpu", 2 * 2.0 ** -23, 1e-5),
                              ("full", 2e-4, 2e-5)):
        a, b = runs[other][1], runs["cuda"][1]
        diff = 0.0
        for d in range(n_domain):
            for ma, mb in zip(a["candidates"][d], b["candidates"][d]):
                if not masks_equal(ma, mb):
                    raise AssertionError(f"{other}: domain {d}: a pruned "
                                         "mask differs")
            if not masks_equal(a["after"][d], b["after"][d]):
                raise AssertionError(f"{other}: domain {d}: another mask")
            la, lb = np.array(a["losses"][d]), np.array(b["losses"][d])
            diff = max(diff, float(np.max(np.abs(la - lb))))
            if not np.allclose(lb, la, rtol=rtol, atol=atol):
                raise AssertionError(f"{other}: probe losses {la} {lb}")
        diffs[other] = diff
    say("options", part="overlay_reference", chains=4, adapt_steps=2,
        probes=2, masks_equal=True,
        probe_loss_max_abs_diff={"card_overlay_vs_cpu_overlay": diffs["cpu"],
                                 "card_overlay_vs_card_full": diffs["full"]},
        tolerance={"vs_cpu": "atol 1e-5 + 2 f32 ulp",
                   "vs_full": "rtol 2e-4, atol 2e-5"},
        launches=launches,
        seconds={k: v[2] for k, v in runs.items()})


def options_overlay_fit(ctx, tmp: str):
    """AREADTrainer.fit with the overlay engine at RESUME_DEPTH, with
    log_dir and a generous watchdog: finite AUCs, the kernels' launches
    the schedule's (no sparse-Adam sweep in any chain), the metric
    files."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer

    depth = dict(RESUME_DEPTH)
    n_train = depth.pop("train_batches") * BS
    data = amazon_split(np.random.default_rng(10), n_train,
                        depth.pop("eval_rows"), aug=True)
    logs = os.path.join(tmp, "overlay_logs")
    cfg = Config(model="aread", dataset_name="amazon", seed=0,
                 hemp_fast_adapt="overlay", log_dir=logs,
                 epoch_timeout_s=600.0, **depth)
    tr = AREADTrainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                      cfg, N_DOMAIN)
    t0 = time.perf_counter()
    res = counted(ctx, "options/overlay_fit",
                  lambda: tr.fit(data, verbose=False))
    fit_s = time.perf_counter() - t0
    launches = ctx["launches_by_path"]["options/overlay_fit"]
    counts = np.bincount(data.train_x[:, data.spec.domain_idx],
                         minlength=N_DOMAIN)
    n_seq = int(np.sum(np.ceil(counts / cfg.bs)))
    warm = cfg.warm_up_interval * 1024 // cfg.bs
    chains = sum(r["chains"] for r in tr.regroup_log)
    want = {"sparse_adam": warm + cfg.epoch * n_seq,
            "fused_adam": overlay_launches(chains, len(tr.regroup_log), cfg)}
    if launches != want:
        raise AssertionError(f"the overlay fit launched {launches}, the "
                             f"schedule implies {want}")
    check_metrics("overlay fit", [("valid", h) for h in res["history"]]
                  + [("test", res["test"])])
    (run,) = os.listdir(logs)
    lines = open(os.path.join(logs, run, "metrics.jsonl")).read().splitlines()
    keys = [sorted(set(json.loads(l)) - {"_ts", "_step"}) for l in lines]
    if keys != [["valid"]] * cfg.epoch + [["domain_mask_active", "test"]]:
        raise AssertionError(f"metrics.jsonl holds {keys}")
    if json.load(open(os.path.join(logs, run, "config.json")))[
            "hemp_fast_adapt"] != "overlay":
        raise AssertionError("config.json is not the run's")
    say("options", part="overlay_fit", depth=RESUME_DEPTH, fit_s=fit_s,
        regroups=len(tr.regroup_log), chains=chains,
        ms_per_chain=[r["seconds"] / r["chains"] * 1e3
                      for r in tr.regroup_log],
        launches=launches, launches_schedule=want,
        valid_mean_auc=[h["mean_auc"] for h in res["history"]],
        test_mean_auc=res["test"]["mean_auc"], metrics_lines=len(lines))


def options_regroup(ctx, tmp: str):
    """MMoE with the Amazon domain -> group map and the dense table
    gradient through Trainer.fit: 2 epochs of 12 steps under each
    dynamic_regroup mode, the loss matrix timed, the maps it chose; then
    tower_domain_losses on the card against the CPU at a small width."""
    from aread_tpu_torch.config import DOMAIN2GROUP, Config
    from aread_tpu_torch.data.loader import make_synthetic_data
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    d2g = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])
    data = amazon_split(np.random.default_rng(11), 12 * BS, 2048)
    out = {}
    for mode in ("towerfirst", "served,besttower"):
        cfg = Config(model="mmoe", dataset_name="amazon", seed=0,
                     sparse_table_grad=False, dynamic_regroup=mode,
                     early_stop=10, epoch_timeout_s=600.0,
                     log_dir=os.path.join(tmp, f"logs_{mode}"))
        tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                     cfg, N_DOMAIN, domain2group=d2g.copy())
        timing, maps = [], []
        losses, regroup = tr.tower_domain_losses, tr.apply_dynamic_regroup

        def tower_domain_losses(*a, **kw):
            t0 = time.perf_counter()
            m = losses(*a, **kw)
            timing.append(time.perf_counter() - t0)
            if m.shape != (3, N_DOMAIN):
                raise AssertionError(f"loss matrix {m.shape}")
            return m

        def apply_dynamic_regroup(*a, **kw):
            changed = regroup(*a, **kw)
            maps.append(tr.domain2group.copy())
            return changed

        tr.tower_domain_losses = tower_domain_losses
        tr.apply_dynamic_regroup = apply_dynamic_regroup
        res = counted(ctx, f"options/regroup_{mode}",
                      lambda: tr.fit(data, epochs=2, verbose=False))
        launches = ctx["launches_by_path"][f"options/regroup_{mode}"]
        steps = 2 * -(-len(data.train_x) // cfg.bs)
        if launches != {"sparse_adam": 0, "fused_adam": steps}:
            raise AssertionError(f"{mode}: launched {launches}, {steps} "
                                 "dense steps")
        check_metrics(f"regroup {mode}",
                      [("valid", h) for h in res["history"]]
                      + [("test", res["test"])])
        if len(maps) != 2:
            raise AssertionError(f"{mode}: {len(maps)} regroups in 2 epochs")
        out[mode] = {"loss_matrix_s": timing,
                     "domains_moved": [int(np.sum(m != p)) for p, m in
                                       zip([d2g] + maps[:-1], maps)],
                     "map_after": maps[-1].tolist(),
                     "test_mean_auc": res["test"]["mean_auc"],
                     "loss_matrix_twins": loss_matrix_twins(tr, data)}
    # the loss matrix, card against CPU, at a small width
    small = make_synthetic_data(n_rows=2048, n_domain=4, vocab=300, seed=3)
    cfg = Config(model="mmoe", embed_dim=8, mmoe_expert_dims=(16, 8),
                 mmoe_tower_dims=(8,), atten_embed_dim=8, dropout=0.0,
                 dataset_name="none")
    mats = {}
    for i, dev in enumerate(("cpu", "cuda")):
        m = build_model(cfg, small.spec, 4, device=dev)
        if i:
            m.load_state_dict(mats["model"])
        else:
            mats["model"] = m.state_dict()
        mats[dev] = Trainer(m, cfg, 4, domain2group=np.arange(4) % 3
                            ).tower_domain_losses(small.valid_x, small.valid_y)
    diff = float(np.nanmax(np.abs(mats["cpu"] - mats["cuda"])))
    if diff > 1e-6 or mats["cpu"].shape != (3, 4):
        raise AssertionError(f"loss matrix card vs CPU {diff}")
    say("options", part="dynamic_regroup", model="mmoe",
        steps_per_epoch=-(-len(data.train_x) // BS),
        epochs=2, n_tower=3, **out, small_width_card_vs_cpu_max_abs=diff,
        tolerance=1e-6)


def loss_matrix_twins(tr, data):
    """The valid split's loss matrix of ``tr`` by CUDA graph replays (the
    fit's regroups captured its graph) and by the eager twin
    (``eager_evals``), in turns (graph, eager, eager, graph): bitwise
    equal, NaN columns alike; the seconds of each."""
    captured = tr.evals.eval_captures
    mats, secs = [], {"graph": [], "eager": []}
    for name in ("graph", "eager", "eager", "graph"):
        with (contextlib.nullcontext() if name == "graph"
              else eager_evals(tr)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the class's method: the caller's timing wrapper is left out
            mats.append(type(tr).tower_domain_losses(tr, data.valid_x,
                                                     data.valid_y))
            secs[name].append(time.perf_counter() - t0)
    if not all(m.dtype == mats[0].dtype and np.array_equal(
            m, mats[0], equal_nan=True) for m in mats):
        raise AssertionError("the loss matrix by graph != by the eager twin")
    if tr.evals.eval_captures != captured or not captured:
        raise AssertionError("the loss matrix's graph calls were not replays")
    return {"bitwise": True, "seconds": secs, "captures": captured}


def options_bf16(ctx, tmp: str):
    """compute_dtype='bfloat16': the product against f64 on rounded
    operands and against the f32 product; a step's loss and gradients
    card vs CPU at a small width; 6 timed steps of DeepFM (dense) and of
    AREAD bagging under each dtype; one bf16 checkpoint served."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.models.base import FeatureSpec, gather_group
    from aread_tpu_torch.ops.precision import matmul, matmul_precision_ctx
    from aread_tpu_torch.serve.predictor import Predictor, load_predictor
    from aread_tpu_torch.train.checkpoint import save_checkpoint
    from aread_tpu_torch.train.trainer import Trainer, bce_with_logits

    # --- one product
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(1024, 512, device="cuda", generator=g)
    b = torch.randn(512, 256, device="cuda", generator=g)
    with matmul_precision_ctx("bfloat16"):
        got = matmul(a, b).double()
    f32 = (a @ b).double()
    a16, b16 = (t.to(torch.bfloat16).double() for t in (a, b))
    ref = a16 @ b16
    bound = 512 * 2.0 ** -24 * (a16.abs() @ b16.abs())
    err = (got - ref).abs()
    if not bool((err <= bound).all()) or torch.equal(got, f32):
        raise AssertionError(f"the bf16 product: max err {float(err.max())}")
    # --- a step's loss and gradients, card vs CPU, small width
    small = make_synthetic_data(n_rows=512, n_domain=4, vocab=300, seed=4)
    scfg = Config(model="mmoe", embed_dim=8, mmoe_expert_dims=(16, 8),
                  mmoe_tower_dims=(8,), atten_embed_dim=8, dropout=0.0,
                  dataset_name="none")
    grads = {}
    batch = pad_batch(small.train_x[:256], small.train_y[:256], 256)
    for i, dev in enumerate(("cpu", "cuda")):
        m = build_model(scfg, small.spec, 4, device=dev)
        if i:
            m.load_state_dict(grads["model"])
        else:
            grads["model"] = m.state_dict()
        x = torch.as_tensor(batch["x"], device=dev)
        grp = torch.as_tensor(batch["x"][:, small.spec.domain_idx] % 3,
                              device=dev)
        dense = m.dense_named_parameters()
        with matmul_precision_ctx("bfloat16"):
            out = m(x, group=grp, train=False)
            logit = gather_group(out["logit"], grp)
            loss = torch.mean(bce_with_logits(
                logit, torch.as_tensor(batch["y"], device=dev)))
            gs = torch.autograd.grad(loss, list(dense.values()))
        grads[dev] = [("loss", loss.detach().cpu()), ("logit",
                                                      logit.detach().cpu())] + [
            (n, t.cpu()) for n, t in zip(dense, gs)]
    worst = 0.0
    for (n, c), (_, d) in zip(grads["cpu"], grads["cuda"]):
        scale = max(float(c.abs().max()), 1e-3)
        rel = float((c - d).abs().max()) / scale
        worst = max(worst, rel)
        if rel > 2.0 ** -7:
            raise AssertionError(f"bf16 step card vs CPU: {n} {rel}")
    # --- step times under each dtype
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    rng = np.random.default_rng(12)
    dcfg = Config(model="deepfm", dataset_name="amazon", seed=0,
                  sparse_table_grad=False)
    dense_tr = Trainer(build_model(dcfg, spec, N_DOMAIN, device="cuda"),
                       dcfg, N_DOMAIN)
    dense_tr.init()
    x, y = amazon_rows(rng, dense_tr.model.spec, 8 * BS)
    batches = [dense_tr.place(pad_batch(x[i * BS:(i + 1) * BS],
                                        y[i * BS:(i + 1) * BS], BS))
               for i in range(8)]
    aread = build_trainer(spec, "cuda", N_DOMAIN, dataset_name="amazon",
                          seed=0)
    ms = aread.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d, 0.7)
    dm = ms.domain_mask[0]
    times = {"deepfm_dense": {}, "aread_bagging": {}}
    per_step = {}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        dense_tr.config = dataclasses.replace(dcfg, compute_dtype=dtype)
        aread.config = dataclasses.replace(aread.config, compute_dtype=dtype)
        timed_steps(dense_tr, batches[:2])
        t, _ = timed_steps(dense_tr, batches[2:])
        times["deepfm_dense"].setdefault(dtype, []).append(t)
        for bt in batches[:2]:
            aread.main_step(bt, dm)
        ev = []
        for bt in batches[2:]:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            aread.main_step(bt, dm)
            e.record()
            ev.append((s, e))
        torch.cuda.synchronize()
        times["aread_bagging"].setdefault(dtype, []).append(
            statistics.median(s.elapsed_time(e) for s, e in ev))
        if dtype not in per_step:
            per_step[dtype] = {
                "deepfm_dense": launches_and_busy_per_call(
                    lambda: dense_tr.step(batches[2]), n=2),
                "aread_bagging": launches_and_busy_per_call(
                    lambda: aread.main_step(batches[2], dm), n=2)}
    # --- serve a bf16 checkpoint
    dense_tr.config = dataclasses.replace(dcfg, compute_dtype="bfloat16")
    ck = os.path.join(tmp, "deepfm_bf16")
    save_checkpoint(ck, dense_tr.model.state_dict(), {}, epoch=1,
                    spec=dense_tr.model.spec, run_config=dense_tr.config,
                    n_domain=N_DOMAIN)
    pred = load_predictor(ck)
    xs, _ = amazon_rows(rng, spec, SERVE_ROWS)
    served = pred.predict(xs)
    same = Predictor(dense_tr.model, N_DOMAIN,
                     compute_dtype="bfloat16").predict(xs)
    f32p = Predictor(dense_tr.model, N_DOMAIN).predict(xs)
    gap = float(np.max(np.abs(served - f32p)))
    if (pred.compute_dtype != "bfloat16" or not np.isfinite(served).all()
            or float(np.max(np.abs(served - same))) > 1e-6
            or not 0 < gap < 1e-2):
        raise AssertionError(f"the bf16 checkpoint served {gap} from f32")
    say("options", part="compute_dtype",
        product={"shape": [1024, 512, 256], "max_abs_err_vs_f64_rounded":
                 float(err.max()), "bound": "512 * 2^-24 * |a||b|",
                 "max_abs_diff_vs_f32": float((got - f32).abs().max())},
        step_card_vs_cpu_max_rel=worst, step_tolerance="2^-7 of each "
        "tensor's scale",
        step_ms_events=times,
        cuda_launches_and_device_busy_ms_per_step=per_step,
        served_rows=SERVE_ROWS,
        served_bf16_vs_f32_max_abs=gap)
    del dense_tr, aread, pred
    torch.cuda.empty_cache()


COLD_START = r'''
import json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.train.hemp import AREADTrainer
data = make_synthetic_data(n_rows=4096, n_domain=3, vocab=300, seed=0)
cfg = Config(model="aread", embed_dim=8, mlp_dims=(16,), bs=256,
             aread_tower_dims=((8,), (4,)), warm_up_interval=1,
             regroup_interval=1, regroup_update_step=2, regroup_eval_step=1,
             candidate_mask_num=2, hemp_fast_adapt="overlay",
             epoch_timeout_s=float(sys.argv[1]), early_stop=10)
tr = AREADTrainer(build_model(cfg, data.spec, 3, n_tower=2, device="cuda"),
                  cfg, 3)
torch.cuda.synchronize()
setup_s = time.perf_counter() - t0
res = tr.fit(data, epochs=2, verbose=False)
print(json.dumps({"setup_s": setup_s, "epoch_time_s":
                  [h["epoch_time_s"] for h in res["history"]]}))
'''


def options_health_and_trace(ctx, tmp: str):
    """The watchdog: a deadline shorter than an epoch raises HealthError
    when the epoch returns; the first and the second epoch of a fresh
    process whose kernels are not built yet (a copy of the package with
    an empty build directory), under a generous deadline. Then trace()
    over an AREAD epoch of 2 bagging steps and an overlay evolution: the
    trace holds the hemp_mask_evolution range and both kernels."""
    import shutil

    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import make_synthetic_data
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.parallel.health import HealthError
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.train.trainer import Trainer

    small = make_synthetic_data(n_rows=1024, n_domain=3, vocab=300, seed=1)
    cfg = Config(model="deepfm", embed_dim=8, bs=128, dataset_name="none",
                 epoch_timeout_s=1e-3, epoch_timeout_first_mult=1.0)
    try:
        Trainer(build_model(cfg, small.spec, 3, device="cuda"), cfg,
                3).fit(small, epochs=1, verbose=False)
        raise AssertionError("a 1 ms epoch deadline did not raise")
    except HealthError as e:
        breach = str(e)
    # --- the cold start of a fresh process
    root = os.path.dirname(os.path.abspath(__file__))
    copy = os.path.join(tmp, "cold")
    shutil.copytree(os.path.join(root, "aread_tpu_torch"),
                    os.path.join(copy, "aread_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", COLD_START, "120"], cwd=copy,
                          capture_output=True, text=True, timeout=900,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    if proc.returncode != 0:
        raise AssertionError(f"the cold-start process exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    cold["process_s"] = time.perf_counter() - t0
    # --- trace() over an epoch
    trace_dir = os.path.join(tmp, "trace")
    os.environ["AREAD_TPU_TRACE"] = trace_dir
    try:
        tcfg = Config(model="aread", embed_dim=8, mlp_dims=(16,), bs=256,
                      aread_tower_dims=((8,), (4,)), warm_up_interval=1,
                      regroup_interval=1000, regroup_update_step=2,
                      regroup_eval_step=1, candidate_mask_num=2,
                      hemp_fast_adapt="overlay", dataset_name="none")
        tdata = make_synthetic_data(n_rows=640, n_domain=2, vocab=300, seed=2)
        tr = AREADTrainer(build_model(tcfg, tdata.spec, 2, n_tower=2,
                                      device="cuda"), tcfg, 2)
        tr.fit(tdata, epochs=1, verbose=False)
    finally:
        del os.environ["AREAD_TPU_TRACE"]
    (name,) = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    events = json.load(open(os.path.join(trace_dir, name)))["traceEvents"]
    names = [e.get("name", "") for e in events]
    # the sparse kernel's sweep is adam_sweep_*, the dense one fused_adam_*
    kernels = {k: sum(k in n for n, e in zip(names, events)
                      if e.get("cat") == "kernel")
               for k in ("adam_sweep", "fused_adam")}
    if "hemp_mask_evolution" not in names or not all(kernels.values()):
        raise AssertionError(f"the trace lacks the evolution or a kernel: "
                             f"{kernels}")
    say("options", part="health_and_trace", short_deadline_raised=breach,
        cold_process=cold, first_epoch_over_second=(
            cold["epoch_time_s"][0] / cold["epoch_time_s"][1]),
        trace_bytes=os.path.getsize(os.path.join(trace_dir, name)),
        trace_kernel_events=kernels,
        trace_has_hemp_mask_evolution=True)


def phase_options(ctx):
    """The trainers' options beside their main paths: the overlay
    fast-adapt engine, dynamic_regroup, compute_dtype, log_dir, the epoch
    watchdog and tracing."""
    torch.cuda.empty_cache()
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="aread_options_") as tmp:
        for part in (options_overlay, options_overlay_large,
                     options_overlay_reference, options_overlay_fit,
                     options_regroup, options_bf16,
                     options_health_and_trace):
            t0 = time.perf_counter()
            part(ctx, tmp)
            seconds[part.__name__] = time.perf_counter() - t0
    say("options", part="seconds", **seconds)


def profile_steps(ctx, name: str, step):
    """10 calls of ``step`` on the host clock (2 of them warm-up), then 4
    under torch.profiler: device busy time per step and the device's idle
    share, launches per step, the top kernels. The full tables and a
    Chrome trace go to --profile-dir/<name>."""
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            step()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    out = Path(ctx["profile_dir"]) / name
    out.mkdir(parents=True, exist_ok=True)
    by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=40)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=40)
    (out / "key_averages.txt").write_text(by_dev + "\n\n" + by_cpu)
    prof.export_chrome_trace(str(out / "trace.json"))
    # device-side events only (kernels, copies, memsets): an op row and
    # its kernel row both carry the kernel's time
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 4e3
    say("profile", path=name, step_ms_host_clock=step_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / step_ms,
        device_events_per_step=sum(e.count for e in dev) / 4,
        cuda_launches_per_step=sum(e.count for e in ka
                                   if e.key == "cudaLaunchKernel") / 4,
        top_device=[(e.key[:60], e.self_device_time_total / 4e3, e.count / 4)
                    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]])


def phase_profile(ctx):
    """Opt-in, after train: one chunk of AREAD bagging steps of each
    dispatch (graph replays, eager launches) under torch.profiler, per
    step; tables and a trace go to --profile-dir/aread_bagging_<dispatch>."""
    from pathlib import Path

    trs, (kind, feeds, masks) = ctx["profile_args"]
    for name, tr in trs.items():
        _, prof = chunk_profile(
            lambda: tr.chunks.run(kind, feeds, masks, tr.opt_state),
            len(feeds), Path(ctx["profile_dir"]) / f"aread_bagging_{name}")
        say("profile", path=f"aread_bagging_{name}", dispatch=name, **prof)


def phase_profile_dense(ctx):
    """Opt-in, after train_dense: the dense DeepFM step of the generic
    Trainer under torch.profiler."""
    tr, batches = ctx["dense_profile_args"]
    profile_steps(ctx, "deepfm_dense", lambda: tr.step(batches[0]))


def phase_profile_hemp(ctx):
    """Opt-in, after hemp: one fast-adapt chain (snapshot restore, adapt
    steps with their prunes, probes, the fetch of the probe losses) under
    torch.profiler; the numbers are per chain."""
    profile_steps(ctx, "hemp_chain", ctx["hemp_profile_args"])


# ------------------------------------------------------------------ mesh
# The mesh runs' ranks are processes of this script on cuda:0 (one card:
# gloo over CUDA tensors, staged through host memory). Their times are of
# "gloo, N ranks on one H100": not the cost of NCCL across cards.
MESH_LABEL = "gloo, {n} ranks on one H100"
# the DeepFM linear biases that feed a BatchNorm
DEEPFM_PRE_BN_BIAS = r"^mlp/linear_\d+/bias$"
AREAD_PRE_BN_BIAS = r"^(mmoe_experts|towers_\d+)/linear_\d+/bias$"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_spawn(part: str, world: int, workdir: str, timeout: float = 600.0):
    """``world`` ranks of this script running ``mesh_part_<part>`` on the
    card under gloo; returns each rank's result. Every rank is waited
    for, and killed if it outlives the deadline."""
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(os.path.join(workdir, f"{part}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", part,
             workdir], cwd=root, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    end = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in range(world):
            with open(os.path.join(workdir, f"{part}_rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {procs[r][0].returncode}):\n"
                             + f.read()[-3000:])
        raise AssertionError(f"mesh part {part}: ranks {bad} failed\n"
                             + "\n".join(tails))
    return [torch.load(os.path.join(workdir, f"{part}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def mesh_rank_main(part: str, workdir: str) -> int:
    """One rank of a mesh part: the process group from the environment
    (gloo: two ranks share the card), the kernels the parent built, the
    part, its result saved, a barrier."""
    from aread_tpu_torch.ops.cuda import build
    from aread_tpu_torch.parallel import distributed, health

    backend = distributed.initialize("cuda")
    if backend != "gloo":
        raise AssertionError(f"{backend}: ranks sharing one card take gloo")
    for name in KERNEL_SOURCES:
        build.load(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {"b": mesh_part_b, "c": mesh_part_c}[part](workdir)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["backend"] = backend
    torch.save(out, os.path.join(workdir, f"{part}_rank{rank}.pt"))
    health.barrier("done", 300.0)
    distributed.shutdown()
    return 0


def rank_counted(fn):
    """(result, this rank's launch counts) of ``fn``, the counts set to 0
    just before it and read just after (the card synchronised)."""
    from aread_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, path_counts(launch_counts)


def mesh_aread(mesh, device, **cfg_kw):
    """The train phase's AREAD (config defaults: bf16 table and moments,
    dropout 0.2) on ``mesh``, or on one process when ``mesh`` is None."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.hemp import AREADTrainer

    cfg = Config(**{"dataset_name": "amazon", "seed": 0, "bs": BS, **cfg_kw})
    tr = AREADTrainer(build_model(cfg, amazon_spec(), N_DOMAIN,
                                  device=device), cfg, N_DOMAIN, mesh=mesh)
    tr.init()
    return tr


def mesh_steps_plan(tr):
    """The train phase's 8 warm-up and 16 bagging steps (same rows, same
    'rand' masks from the config's seed)."""
    from aread_tpu_torch.data.loader import DomainBatcher

    spec = tr.model.spec
    x, y = amazon_rows(np.random.default_rng(0), spec, N_DOMAIN * 3 * BS)
    batcher = DomainBatcher(x, y, BS, spec.domain_idx, N_DOMAIN, seed=0)
    ms = tr.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d,
                                             tr.config.init_active_percent)
    seq = list(batcher.domain_batch_seq)
    plan = [("warmup", seq[i]) for i in range(8)] + \
        [("main", seq[8 + i]) for i in range(16)]
    return [(kind, d, batcher.next_batch(d)) for kind, d in plan]


def mesh_run_steps(tr, plan, snapshot_after=None):
    """Run ``plan``; (losses, step ms by kind, the table after
    ``snapshot_after`` steps)."""
    losses, times, snap = [], [], None
    for i, (kind, d, batch) in enumerate(plan):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if kind == "warmup":
            loss, _ = tr.warmup_step(batch)
        else:
            loss, _ = tr.main_step(batch, tr.mask_state.domain_mask[d])
        b.record()
        losses.append(loss)
        times.append((kind, a, b))
        if snapshot_after is not None and i + 1 == snapshot_after:
            snap = tr.model.embedding.table.cpu()
    torch.cuda.synchronize()
    ms = {k: statistics.median(a.elapsed_time(b) for kk, a, b in times
                               if kk == k)
          for k in ("warmup", "main") if any(p[0] == k for p in plan)}
    return [float(l) for l in losses], ms, snap


def mesh_part_b(workdir: str):
    """Mesh (1, 2), sparse table gradient: the production (bf16) steps,
    the same steps in f32 with the shard after 3 of them, one bf16 shard
    update against the CPU plain version, the a2a lookup at its measured
    capacity."""
    from aread_tpu_torch.ops.sparse_adam import (dedup_rows,
                                                 sparse_adam_reference)
    from aread_tpu_torch.parallel import embed_shard as es
    from aread_tpu_torch.parallel.mesh import gather_rows, make_mesh
    from aread_tpu_torch.parallel.sharded_adam import (
        shard_run, sharded_sparse_adam_deduped)

    mesh = make_mesh(1, 2)
    out = {"mesh": [mesh.data_index, mesh.model_index]}
    for name, kw in (("bf16", {}), ("f32", {"table_dtype": "float32",
                                            "table_moments_dtype": "float32"})):
        tr = mesh_aread(mesh, mesh.device, **kw)
        plan = mesh_steps_plan(tr)
        (losses, ms, snap), launches = rank_counted(
            lambda: mesh_run_steps(tr, plan, 3 if name == "f32" else None))
        out[name] = {"losses": losses, "step_ms": ms, "launches": launches,
                     "table_rows": list(tr.model.embedding.table.shape)}
        if snap is not None:
            out[name]["shard_after_3"] = snap
        if name == "bf16":
            # one more update of the bf16 shard, against the CPU plain
            # version of the sharded update with the rank's seed
            emb = tr.model.embedding
            rng = np.random.default_rng(21)
            ids = torch.as_tensor(amazon_table_ids(
                rng, tr.model.spec.one_hot_dims, emb.n_rows).reshape(-1),
                dtype=torch.int32, device=mesh.device)
            g = torch.as_tensor(rng.standard_normal((ids.numel(), 32)),
                                dtype=torch.float32, device=mesh.device)
            uids, gsum = dedup_rows(ids, g, emb.n_rows)
            w, m, v = (emb.table.clone(), tr.opt_state["m"].clone(),
                       tr.opt_state["v"].clone())
            t = tr.opt_state["t"] + 1
            cpu_in = [a.cpu().clone() for a in (w, m, v)]
            sharded_sparse_adam_deduped(w, m, v, uids, gsum, t, mesh,
                                        lr=1e-3, l2=1e-5)
            rows = w.shape[0]
            local, gloc = shard_run(uids.cpu(), gsum.cpu(),
                                    mesh.model_index * rows, rows)
            want = sparse_adam_reference(*cpu_in, local, gloc, t, lr=1e-3,
                                         l2=1e-5,
                                         sr_seed=t * 2 + mesh.model_index)
            out["bf16_update_bitwise"] = all(
                torch.equal(a.cpu(), b) for a, b in zip((w, m, v), want))
            out["bf16_update_max_abs_err"] = max(
                float((a.cpu().float() - b.float()).abs().max())
                for a, b in zip((w, m, v), want))
            # the a2a lookup of the lane-packed table at the measured
            # capacity, against the plain gather of the whole table
            from aread_tpu_torch.config import Config
            acfg = Config(embed_lookup="a2a", bs=BS, embed_dim=32)
            x, _ = amazon_rows(np.random.default_rng(0), tr.model.spec,
                               N_DOMAIN * 3 * BS)
            cap = es.resolve_a2a_capacity(acfg, mesh, tr.model.spec, 32,
                                          [(x, BS)])
            lids, n_flat = es.lookup_ids(tr.model.spec, 32, x[:BS])
            need = es.a2a_required_capacity(lids, n_flat, 2)
            xb = torch.as_tensor(x[:BS], device=mesh.device)
            tids = emb.table_ids(xb)
            with torch.no_grad():
                got = es.flat_a2a_lookup(emb.table, tids, mesh, cap, 4)
                full = gather_rows(emb.table, mesh)
                plain = full[tids].to(torch.float32)
            out["a2a"] = {"capacity": cap, "required_one_batch": need,
                          "bitwise": bool(torch.equal(got, plain)),
                          "ids": int(tids.numel()),
                          "unique_flat_rows": int(np.unique(lids).size)}
            del full, plain
        del tr
        torch.cuda.empty_cache()
    out["dense_bf16"] = mesh_dense_bf16_step(mesh)
    return out


def mesh_dense_bf16_step(mesh):
    """One dense-gradient DeepFM step with a bf16 table and moments (kernel
    2 on each shard, its rounding keyed on the global element index): the
    gathered weights, statistics and table moments, and the launches."""
    from aread_tpu_torch.train.checkpoint import full_state

    tr = mesh_dense_trainer(mesh, "cuda" if mesh is None else mesh.device,
                            "bfloat16")
    (losses, _), launches = rank_counted(
        lambda: mesh_timed_steps(tr, mesh_dense_batches()[:1]))
    sd, opt = full_state(tr.model.state_dict(), tr.opt_state, mesh)
    res = {"losses": losses, "launches": launches,
           "table_rows": list(tr.model.embedding.table.shape)}
    if mesh is None or mesh.rank == 0:
        res["state"] = {k: v.cpu() for k, v in sd.items()}
        res["m"], res["v"] = opt["m"].cpu(), opt["v"].cpu()
    del tr, sd, opt
    torch.cuda.empty_cache()
    return res


def mesh_evolution_trainer(mesh, device):
    """The reference phase's evolution trainer: full Amazon width, 2
    domains, 2 candidates of 2 adapt steps and 2 probes, f32 table and
    moments, dropout 0, the pre-BatchNorm biases at their true zero."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.train.hemp import AREADTrainer

    cfg = Config(dataset_name="amazon", seed=0, dropout=0.0, bs=BS,
                 table_dtype="float32", table_moments_dtype="float32",
                 regroup_update_step=2, regroup_eval_step=2,
                 candidate_mask_num=3)
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    tr = AREADTrainer(build_model(cfg, spec, 2, n_tower=3, device=device),
                      cfg, 2, mesh=mesh)
    tr.optimizer = true_zero_adam(AREAD_PRE_BN_BIAS, cfg.lr, cfg.wd)
    tr.fast_optimizer = true_zero_adam(AREAD_PRE_BN_BIAS, cfg.update_lr,
                                       cfg.wd)
    tr.init()
    return tr


def mesh_evolution_batchers():
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models.base import FeatureSpec

    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)
    rng = np.random.default_rng(5)
    x, y = amazon_rows(rng, spec, 8 * BS)
    x[:, spec.domain_idx] = rng.integers(0, 2, size=len(x))
    return [DomainBatcher(x, y, BS, spec.domain_idx, 2, seed=s)
            for s in (1, 2)]


def mesh_dense_trainer(mesh, device, dtype: str = "float32"):
    """DeepFM with the dense table gradient (kernel 2), table and moments
    in ``dtype`` (f32 by default), dropout 0.2, the pre-BatchNorm biases at
    their true zero."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    cfg = Config(model="deepfm", dataset_name="amazon", seed=0, bs=BS,
                 sparse_table_grad=False, table_dtype=dtype,
                 table_moments_dtype=dtype)
    tr = Trainer(build_model(cfg, amazon_spec(), N_DOMAIN, device=device),
                 cfg, N_DOMAIN, mesh=mesh)
    tr.optimizer = true_zero_adam(DEEPFM_PRE_BN_BIAS, cfg.lr, cfg.wd)
    tr.init()
    return tr


def mesh_dense_batches():
    from aread_tpu_torch.data.loader import GlobalBatcher

    x, y = amazon_rows(np.random.default_rng(11), amazon_spec(), 6 * BS)
    return list(GlobalBatcher(x, y, BS, amazon_spec().domain_idx, seed=3))


def mesh_timed_steps(tr, batches):
    losses, ms = [], []
    for b in batches:
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(tr.step(b))
        e.record()
        ms.append((a, e))
    torch.cuda.synchronize()
    return ([float(l) for l in losses],
            statistics.median(a.elapsed_time(e) for a, e in ms))


def mesh_fit_split():
    depth = dict(RESUME_DEPTH)
    n_train = depth.pop("train_batches") * BS
    return amazon_split(np.random.default_rng(9), n_train,
                        depth.pop("eval_rows"), aug=True), depth


def mesh_part_c(workdir: str):
    """Mesh (2, 2): the reference phase's evolution, 6 dense DeepFM steps
    (kernel 2 per shard), one AREADTrainer.fit epoch at RESUME_DEPTH with
    its checkpoint and the evaluation it is served against."""
    from aread_tpu_torch.parallel.mesh import make_mesh
    from aread_tpu_torch.train.checkpoint import full_state

    mesh = make_mesh(2, 2)
    out = {"mesh": [mesh.data_index, mesh.model_index]}
    # (1) the evolution
    tr = mesh_evolution_trainer(mesh, mesh.device)
    records = spy_evolutions(tr)
    batchers = mesh_evolution_batchers()
    t0 = time.perf_counter()
    _, launches = rank_counted(lambda: tr._mask_evolution(*batchers,
                                                          verbose=False))
    rec = records[0]
    out["evolution"] = {"seconds": time.perf_counter() - t0,
                        "launches": launches, "losses": rec["losses"],
                        "candidates": rec["candidates"],
                        "after": rec["after"]}
    del tr
    # (2) dense DeepFM steps
    tr = mesh_dense_trainer(mesh, mesh.device)
    (losses, step_ms), launches = rank_counted(
        lambda: mesh_timed_steps(tr, mesh_dense_batches()))
    sd, _ = full_state(tr.model.state_dict(), None, mesh)
    out["dense"] = {"losses": losses, "step_ms": step_ms,
                    "launches": launches}
    if mesh.rank == 0:
        out["dense"]["state"] = {k: v.cpu() for k, v in sd.items()}
    del tr, sd
    torch.cuda.empty_cache()
    # (3) one fit epoch at RESUME_DEPTH, its checkpoint, its evaluation
    data, depth = mesh_fit_split()
    tr = mesh_aread(mesh, mesh.device, **depth)
    t0 = time.perf_counter()
    res, launches = rank_counted(lambda: tr.fit(
        data, epochs=1, verbose=False,
        ckpt_dir=os.path.join(workdir, "c_elastic")))
    fit_s = time.perf_counter() - t0
    tr.save(os.path.join(workdir, "c_serve"), epoch=1,
            domain_mask=res["domain_mask"], spec=amazon_spec(),
            run_config=tr.config, n_domain=N_DOMAIN)
    x = data.test_x
    didx = amazon_spec().domain_idx
    probs = np.zeros(len(x), np.float32)
    for d in range(N_DOMAIN):
        idx = np.nonzero(x[:, didx] == d)[0]
        if not len(idx):
            continue
        pad = np.concatenate([idx, idx[:len(idx) % 2]])  # even rows
        p = tr.gather_rows(tr.eval_prob(tr.place({"x": x[pad]}),
                                        res["domain_mask"][d]))
        probs[idx] = p[:len(idx)].cpu().numpy()
    out["fit"] = {"seconds": fit_s, "launches": launches,
                  "history": res["history"], "test": res["test"],
                  "probs": probs, "x": x,
                  "masks": res["domain_mask"]}
    return out


def phase_mesh(ctx):
    """The mesh paths at full Amazon width (see the module docstring):
    (a) NCCL, world 1, one step on a 1 x 1 mesh; (b) gloo, 2 ranks, mesh
    (1, 2); (c) gloo, 4 ranks, mesh (2, 2); (d) the CLI under
    torch.distributed.run. Each against the single-process card run."""
    import torch.distributed as dist

    from aread_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    # the ranks load what the build phase built; build here when it did not
    from aread_tpu_torch.ops.cuda import build
    build.build_all(KERNEL_SOURCES)
    # (a) a world-1 NCCL group on the card
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        t = torch.full((4,), 3.0, device="cuda")
        dist.all_reduce(t)
        if not torch.equal(t, torch.full((4,), 3.0, device="cuda")):
            raise AssertionError(f"NCCL all_reduce over one rank: {t}")
        mesh = make_mesh(1, 1)
        tr = mesh_aread(mesh, "cuda")
        plan = mesh_steps_plan(tr)[:1]
        (losses, _, _), launches = rank_counted(
            lambda: mesh_run_steps(tr, plan))
        ctx.setdefault("launches_by_path", {})["mesh/a"] = launches
        if launches != {"sparse_adam": 1, "fused_adam": 0} or not np.isfinite(
                losses[0]):
            raise AssertionError(f"1 x 1 mesh step: {losses} {launches}")
        say("mesh", part="a", backend=dist.get_backend(), world=1,
            all_reduce="ok", loss=losses[0], launches=launches)
        del tr
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="aread_mesh_") as tmp:
        mesh_check_b(ctx, tmp)
        mesh_check_c(ctx, tmp)
        mesh_check_d(ctx, tmp)
    say("mesh", part="done", seconds=time.perf_counter() - t_phase)


def mesh_check_b(ctx, tmp):
    # the single-process card runs of the same steps
    ref = {}
    for name, kw in (("bf16", {}), ("f32", {"table_dtype": "float32",
                                            "table_moments_dtype": "float32"})):
        tr = mesh_aread(None, "cuda", **kw)
        losses, ms, snap = mesh_run_steps(tr, mesh_steps_plan(tr),
                                          3 if name == "f32" else None)
        ref[name] = {"losses": losses, "step_ms": ms, "snap": snap}
        del tr
    torch.cuda.empty_cache()
    ref_dense = mesh_dense_bf16_step(None)
    t0 = time.perf_counter()
    ranks = mesh_spawn("b", 2, tmp)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        for name in ("bf16", "f32"):
            ctx.setdefault("launches_by_path", {})[f"mesh/b_{name}/rank{r}"] = \
                res[name]["launches"]
            if res[name]["launches"] != {"sparse_adam": 24, "fused_adam": 0}:
                raise AssertionError(f"rank {r} {name}: launches "
                                     f"{res[name]['launches']}, 24 steps")
            if res[name]["losses"] != ranks[0][name]["losses"]:
                raise AssertionError(f"{name}: rank {r}'s losses differ")
    # the reference phase's bound: a reported loss holds the table's L2
    # term, in the hundreds at this width, where one f32 ulp is 6.1e-5, and
    # the shards' sums of squares are added in another order
    f32 = ranks[0]["f32"]["losses"]
    diff = max_abs(f32, ref["f32"]["losses"])
    if not np.allclose(f32, ref["f32"]["losses"], rtol=2 * 2.0**-23,
                       atol=1e-5):
        raise AssertionError(f"f32 mesh losses != single process: {diff}")
    bf16 = ranks[0]["bf16"]["losses"]
    bf16_first = abs(bf16[0] - ref["bf16"]["losses"][0])
    if not (np.isclose(bf16[0], ref["bf16"]["losses"][0], rtol=2 * 2.0**-23,
                       atol=1e-5) and np.isfinite(bf16).all()):
        raise AssertionError(f"bf16 mesh first loss off by {bf16_first}")
    snap = ref["f32"]["snap"]
    rows = snap.shape[0] // 2
    shards_bitwise = [bool(torch.equal(res["f32"]["shard_after_3"],
                                       snap[r * rows:(r + 1) * rows]))
                      for r, res in enumerate(ranks)]
    if not all(shards_bitwise):
        raise AssertionError(f"f32 shards after 3 steps: {shards_bitwise}")
    for r, res in enumerate(ranks):
        if not (res["bf16_update_bitwise"] and res["a2a"]["bitwise"]):
            raise AssertionError(f"rank {r}: bf16 shard update "
                                 f"{res['bf16_update_bitwise']}, a2a rows "
                                 f"{res['a2a']['bitwise']}")
    ctx["mesh_sharded_err"] = max(r["bf16_update_max_abs_err"] for r in ranks)
    # the bf16 dense step: the shards are one process's update, bitwise
    dense = ranks[0]["dense_bf16"]
    for r, res in enumerate(ranks):
        ctx["launches_by_path"][f"mesh/b_dense_bf16/rank{r}"] = \
            res["dense_bf16"]["launches"]
        if res["dense_bf16"]["launches"] != {"sparse_adam": 0,
                                             "fused_adam": 1}:
            raise AssertionError(f"rank {r} bf16 dense step launched "
                                 f"{res['dense_bf16']['launches']}")
    dense_bad = bits_differ({"state": dense["state"], "m": dense["m"],
                             "v": dense["v"]},
                            {"state": ref_dense["state"], "m": ref_dense["m"],
                             "v": ref_dense["v"]})
    if dense_bad:
        raise AssertionError(f"bf16 dense mesh step != one process at "
                             f"{dense_bad[:8]}")
    say("mesh", part="b", mesh=[1, 2], label=MESH_LABEL.format(n=2),
        backend=ranks[0]["backend"], table_rows_per_rank=ranks[0]["bf16"][
            "table_rows"],
        steps={"warmup": 8, "main": 16},
        step_ms_mesh={n: ranks[0][n]["step_ms"] for n in ("bf16", "f32")},
        step_ms_single_process={n: ref[n]["step_ms"] for n in ("bf16", "f32")},
        launches_per_rank=[{n: r[n]["launches"] for n in ("bf16", "f32")}
                           for r in ranks],
        f32_losses_max_abs_diff=diff, tolerance="atol 1e-5 + 2 f32 ulp",
        bf16_first_loss_diff=bf16_first,
        bf16_loss_last={"mesh": ranks[0]["bf16"]["losses"][-1],
                        "single": ref["bf16"]["losses"][-1]},
        f32_shards_after_3_steps_bitwise=shards_bitwise,
        bf16_shard_update_vs_cpu_plain_bitwise=[
            r["bf16_update_bitwise"] for r in ranks],
        bf16_dense_step_vs_one_process_bitwise=True,
        bf16_dense_table_rows_per_rank=dense["table_rows"],
        a2a=[r["a2a"] for r in ranks],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        ranks_wall_s=wall)


def mesh_check_c(ctx, tmp):
    from aread_tpu_torch.serve.predictor import load_predictor

    # single-process card references: the evolution and the dense steps
    tr = mesh_evolution_trainer(None, "cuda")
    records = spy_evolutions(tr)
    tr._mask_evolution(*mesh_evolution_batchers(), verbose=False)
    ref_evo = records[0]
    del tr
    tr = mesh_dense_trainer(None, "cuda")
    ref_losses, ref_ms = mesh_timed_steps(tr, mesh_dense_batches())
    ref_state = {k: v.cpu() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_spawn("c", 4, tmp)
    wall = time.perf_counter() - t0
    data, depth = mesh_fit_split()
    from aread_tpu_torch.config import Config
    want_fit = sparse_adam_launches_of_fit(Config(bs=BS, **depth), data, 1)
    evo_diff = 0.0
    for r, res in enumerate(ranks):
        lb = ctx.setdefault("launches_by_path", {})
        lb[f"mesh/c_evolution/rank{r}"] = res["evolution"]["launches"]
        lb[f"mesh/c_dense/rank{r}"] = res["dense"]["launches"]
        lb[f"mesh/c_fit/rank{r}"] = res["fit"]["launches"]
        if res["evolution"]["launches"] != {"sparse_adam": 8, "fused_adam": 0}:
            raise AssertionError(f"rank {r} evolution launched "
                                 f"{res['evolution']['launches']}")
        if res["dense"]["launches"] != {"sparse_adam": 0, "fused_adam": 6}:
            raise AssertionError(f"rank {r} dense launched "
                                 f"{res['dense']['launches']}")
        if res["fit"]["launches"] != {"sparse_adam": want_fit,
                                      "fused_adam": 0}:
            raise AssertionError(f"rank {r} fit launched "
                                 f"{res['fit']['launches']}, the schedule "
                                 f"{want_fit}")
        evo = res["evolution"]
        for d in range(2):
            for a, b in zip(ref_evo["candidates"][d], evo["candidates"][d]):
                if not masks_equal(a, b):
                    raise AssertionError(f"rank {r} domain {d}: a candidate "
                                         "mask differs from one process")
            if not masks_equal(ref_evo["after"][d], evo["after"][d]):
                raise AssertionError(f"rank {r} domain {d}: another mask")
            a, b = np.array(ref_evo["losses"][d]), np.array(evo["losses"][d])
            evo_diff = max(evo_diff, float(np.max(np.abs(a - b))))
            if not np.allclose(b, a, rtol=2 * 2.0 ** -23, atol=1e-5):
                raise AssertionError(f"probe losses: {a} {b}")
        if res["dense"]["losses"] != ranks[0]["dense"]["losses"]:
            raise AssertionError(f"rank {r}: dense losses differ by rank")
    dense_diff = max_abs(ranks[0]["dense"]["losses"], ref_losses)
    state = ranks[0]["dense"]["state"]
    # the losses at the reference phase's bound; weights and BatchNorm
    # statistics at atol 1e-4: the global batch's BatchNorm sums and the
    # dense gradients are added in another order, and where an entry's
    # gradient is near 0 Adam turns that round-off into a step of up to lr
    # (1e-3) per step (the reference phase gives such entries their true
    # zero; an entry of the first kernel here moved 2.4e-5 in 6 steps)
    worst = max(((max_abs(state[k].float(), v.float()), k)
                 for k, v in ref_state.items()))
    bad = [k for k, v in ref_state.items()
           if not torch.allclose(state[k].float(), v.float(), rtol=0,
                                 atol=1e-4)]
    if not np.allclose(ranks[0]["dense"]["losses"], ref_losses,
                       rtol=2 * 2.0**-23, atol=1e-5) or bad:
        raise AssertionError(f"dense mesh != one process: losses {dense_diff}"
                             f", tensors {bad}, worst {worst}")
    state_diff = worst[0]
    fit = ranks[0]["fit"]
    check_metrics("mesh fit", (("valid", fit["history"][0]),
                               ("test", fit["test"])))
    pred = load_predictor(os.path.join(tmp, "c_serve"))
    if pred.model.embedding.table.shape[0] != amazon_spec().with_flat_table(
            EMBED_DIM).n_rows:
        raise AssertionError("the served table is not the whole table")
    served = predict_per_domain(pred, fit["x"])
    served_diff = max_abs(served, fit["probs"])
    if served_diff > 1e-6:
        raise AssertionError(f"served != the mesh evaluation: {served_diff}")
    del pred
    say("mesh", part="c", mesh=[2, 2], label=MESH_LABEL.format(n=4),
        backend=ranks[0]["backend"],
        evolution={"chains": 4, "masks_equal": True,
                   "probe_loss_max_abs_diff": evo_diff,
                   "tolerance": "atol 1e-5 + 2 f32 ulp",
                   "seconds_per_rank": [r["evolution"]["seconds"]
                                        for r in ranks]},
        dense={"steps": 6, "loss_max_abs_diff": dense_diff,
               "state_max_abs_diff": state_diff, "state_worst": worst[1],
               "tolerance": "losses atol 1e-5 + 2 f32 ulp, state atol 1e-4",
               "step_ms_mesh": ranks[0]["dense"]["step_ms"],
               "step_ms_single_process": ref_ms},
        fit={"depth": RESUME_DEPTH, "seconds": fit["seconds"],
             "sparse_adam_schedule": want_fit,
             "test_total_auc": fit["test"]["total_auc"],
             "served_vs_mesh_eval": served_diff, "tolerance": 1e-6},
        launches_per_rank=[{k: r[k]["launches"] for k in
                            ("evolution", "dense", "fit")} for r in ranks],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        ranks_wall_s=wall)


def mesh_check_d(ctx, tmp):
    """The CLI as a user launches a mesh run, against the single-process
    CLI on the same seed-made CSV (f32 table and moments: a bf16 shard
    rounds with its own stream)."""
    from aread_tpu_torch.data.pipeline import preprocessed_csv_path

    root = os.path.dirname(os.path.abspath(__file__))
    data_path = os.path.join(tmp, "cli_dataset")
    csv = preprocessed_csv_path("aliccp", data_path)
    os.makedirs(os.path.dirname(csv))
    canonical_aliccp_frame(3000, seed=11).to_csv(csv, index=False)
    env = dict(os.environ, AREAD_TPU_CACHE="0")
    common = ["--model", "aread", "--dataset_name", "aliccp", "--data_path",
              data_path, "--bs", "256", "--embed_dim", "8", "--epoch", "1",
              "--warm_up_interval", "1", "--regroup_interval", "8",
              "--candidate_mask_num", "2", "--regroup_update_step", "2",
              "--regroup_eval_step", "2", "--table_dtype", "float32",
              "--table_moments_dtype", "float32"]
    results = {}
    for name, launcher in (
            ("single", [sys.executable, "-m", "aread_tpu_torch"]),
            ("mesh", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2", "-m",
                      "aread_tpu_torch", "--mesh_model", "2"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            launcher + common + ["--save_path", os.path.join(tmp, name)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{name} CLI exited {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        line = [l for l in proc.stdout.splitlines() if l.startswith("test: ")]
        if len(line) != 1:
            raise AssertionError(f"{name} CLI printed {len(line)} test lines")
        results[name] = (eval(line[0][len("test: "):], {"nan": float("nan")}),
                         time.perf_counter() - t0, proc.stdout)
    if "mesh: data=1 model=2 backend=gloo" not in results["mesh"][2]:
        raise AssertionError("the mesh CLI did not print its mesh line")
    one, mesh = results["single"][0], results["mesh"][0]
    diff = max(abs(mesh[k] - v) for k, v in one.items()
               if np.isfinite(v) or np.isfinite(mesh[k]))
    if diff > 1e-5 or set(one) != set(mesh):
        raise AssertionError(f"mesh CLI != single CLI: {one} {mesh}")
    say("mesh", part="d", launcher="torch.distributed.run --nproc_per_node 2",
        label=MESH_LABEL.format(n=2), test_metrics_max_abs_diff=diff,
        tolerance=1e-5, seconds={"single": results["single"][1],
                                 "mesh": results["mesh"][1]},
        test_total_auc=mesh["total_auc"])


# -------------------------------------------------------------------- data
# the 25 Amazon domain sizes of the real canonical file (aread_tpu/config.py
# DOMAIN_SIZE, the reference's config.py:59-65): 17,664,862 rows
AMAZON_DOMAIN_SIZES = (69360, 282546, 776105, 3001846, 88496, 449031,
                       2859592, 1893, 1437340, 16454, 601698, 1802, 2416380,
                       197170, 202176, 6931, 317131, 132650, 602500, 585227,
                       845268, 1107407, 997451, 623565, 44843)
AMAZON_CATEGORIES = (
    "Appliances", "Arts, Crafts & Sewing", "Automotive", "Books",
    "CDs & Vinyl", "Cell Phones & Accessories", "Clothing, Shoes & Jewelry",
    "Collectibles & Fine Art", "Electronics", "Gift Cards",
    "Grocery & Gourmet Food", "Home & Business Services", "Home & Kitchen",
    "Industrial & Scientific", "Kindle Store", "Magazine Subscriptions",
    "Movies & TV", "Musical Instruments", "Office Products",
    "Patio, Lawn & Garden", "Pet Supplies", "Sports & Outdoors",
    "Tools & Home Improvement", "Toys & Games", "Video Games")
CANONICAL_AMAZON_HEADER = (
    "userid,itemid,weekday,domain,sales_chart,sales_rank,brand,price,"
    "user_pos_6month_seq,user_neg_6month_seq,label,timestamp\n")
DATA_PANDAS_ROWS = 1_000_000
DATA_STEPS = 24
DATA_CHUNK_ROWS = 1_000_000
# the CLI runs of part (a): HEMP at a depth that regroups a few times
DATA_CLI_FLAGS = ["--bs", "256", "--epoch", "1", "--warm_up_interval", "1",
                  "--regroup_interval", "8", "--candidate_mask_num", "2",
                  "--regroup_update_step", "2", "--regroup_eval_step", "2"]


def raw_feat(field: str, feat: str, val: str = "1") -> str:
    return f"{field}\x02{feat}\x03{val}"


def aliccp_raw_dumps(base: str, seed: int, n_domain: int = 120,
                     n_users: int = 600, n_items: int = 600) -> None:
    """The four raw AliCCP files (\\x01 \\x02 \\x03 fields): one
    common-feature blob per user (101, the user fields, the user-side
    dense fields), skeleton rows over ``n_domain`` values of field 206
    with skewed sizes (150 to 2,650 rows), the item fields and the
    item-side dense fields, a few click=0 & purchase=1 rows. Enough
    domains pass thresh 15 for interval_random to pick 30."""
    rng = np.random.default_rng(seed)
    os.makedirs(base)
    common = []
    for u in range(n_users):
        blob = [raw_feat("101", f"u{u}")]
        blob += [raw_feat(f, f"{f}_{rng.integers(0, 4)}") for f in
                 ("121", "122", "124", "125", "126", "127", "128", "129")]
        blob += [raw_feat(f, f"{f}_{rng.integers(0, 3)}", f"{rng.random():.4f}")
                 for f in ("109_14", "110_14", "127_14", "150_14")]
        common.append(f"c{u},{len(blob)},{chr(1).join(blob)}\n")
    sizes = 150 + (2500 * 0.96 ** np.arange(n_domain)).astype(int)

    def skeleton(n_rows, first):
        dom = rng.permutation(np.repeat(np.arange(n_domain),
                                        np.maximum(1, n_rows)))
        user = rng.integers(0, n_users, len(dom))
        item = rng.integers(0, n_items, len(dom))
        lines = []
        for i in range(len(dom)):
            blob = [raw_feat("205", f"i{item[i]}"),
                    raw_feat("206", f"d{dom[i]}")]
            blob += [raw_feat(f, f"{f}_{item[i] % 7}")
                     for f in ("207", "210", "216", "301")]
            blob += [raw_feat(f, f"{f}_{rng.integers(0, 3)}",
                              f"{rng.random() * 9:.3f}")
                     for f in ("508", "509", "702", "853")]
            click = int(rng.random() < 0.15 + 0.5 * (item[i] % 3 == 0))
            buy = int(rng.random() < (0.3 if click else 0.01))
            lines.append(f"{first + i},{click},{buy},c{user[i]},{len(blob)},"
                         f"{chr(1).join(blob)}\n")
        return lines

    train = skeleton(sizes, 0)
    for name, lines in (("sample_skeleton_train", train),
                        ("sample_skeleton_test",
                         skeleton(sizes * 3 // 10, len(train))),
                        ("common_features_train", common),
                        ("common_features_test", common)):
        with open(os.path.join(base, f"{name}.csv"), "w") as f:
            f.writelines(lines)


def amazon_raw_dumps(base: str, seed: int, n: int = 40_000,
                     n_users: int = 2500, n_items: int = 1500) -> None:
    """all_csv_files.csv (no header: itemid,userid,rating,timestamp, two
    years to Aug 2018) and All_Amazon_Meta.json (json lines; items over
    the 25 categories, the price / salesRank / brand forms the pipeline
    parses)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(base)
    items = np.array([f"B{i:09d}" for i in range(n_items)])
    pd.DataFrame({
        "itemid": items[rng.integers(0, n_items, n)],
        "userid": [f"A{u:08d}" for u in rng.integers(0, n_users, n)],
        "rating": rng.integers(1, 6, n).astype(float),
        "timestamp": rng.integers(1471000000, 1534291200, n),
    }).to_csv(os.path.join(base, "all_csv_files.csv"), index=False,
              header=False)
    with open(os.path.join(base, "All_Amazon_Meta.json"), "w") as f:
        for i, asin in enumerate(items):
            cat = AMAZON_CATEGORIES[i % 25]
            rank = ({cat: int(rng.integers(1, 3_000_000))} if i % 3 else
                    f"{int(rng.integers(1, 90_000)):,} in {cat}")
            f.write(json.dumps({
                "asin": asin,
                "price": f"${rng.integers(1, 900)}.{rng.integers(0, 99):02d}"
                if i % 9 else "",
                "salesRank": rank, "brand": f"brand{i % 40}",
                "category": [cat, "sub"]}) + "\n")


def cloudtheme_raw_dump(base: str, seed: int, n: int = 20_000) -> None:
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(base)
    pd.DataFrame({
        "user_id": rng.integers(0, 400, n), "item_id": rng.integers(0, 500, n),
        "theme_id": rng.integers(0, 40, n),
        "leaf_cate_id": rng.integers(0, 60, n),
        "cate_level1_id": rng.integers(0, 8, n),
        "reach_time": rng.permutation(n) + 1_560_000_000,
        "clk_cnt": rng.integers(1, 6, n),
    }).to_csv(os.path.join(base, "theme_click_log.csv"), index=False)


def data_cli_run(ctx, path: str, argv):
    """``python -m aread_tpu_torch``'s main in this process (so its kernel
    launches are counted): (stdout, its stages line, its test metrics)."""
    import io

    from aread_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counted(ctx, path, lambda: cli_main(argv))
    out = buf.getvalue()
    return out, *data_cli_lines(out)


def data_cli_lines(out: str):
    stages = [l for l in out.splitlines() if l.startswith("stages: ")]
    test = [l for l in out.splitlines() if l.startswith("test: {")]
    if len(stages) != 1 or len(test) != 1:
        raise AssertionError(f"the CLI printed no stages or test line:\n"
                             f"{out[-3000:]}")
    return (json.loads(stages[0][len("stages: "):]),
            eval(test[0][len("test: "):], {"nan": float("nan")}))


def data_cli(ctx, tmp: str):
    """Part (a): seed-made raw dumps -> the training CLI on the card.
    AliCCP -> AREAD (kernel 1); Amazon -> AREAD with the overlay engine
    (kernel 1 for its steps, kernel 2 for its fast-adapt chains: at the
    CLI's defaults, sparse_table_grad, every model's update runs kernel
    1 alone). Launches against the schedule's; a second invocation, a
    process of its own, takes the skip path; the Cloud-Theme build."""
    from aread_tpu_torch.__main__ import load_config
    from aread_tpu_torch.data.loader import load_split_data, parser_of
    from aread_tpu_torch.data.pipeline import (preprocessed_csv_path,
                                               run_preprocessing)

    raw, save = os.path.join(tmp, "raw"), os.path.join(tmp, "save")
    t0 = time.perf_counter()
    aliccp_raw_dumps(os.path.join(raw, "aliccp"), seed=21)
    amazon_raw_dumps(os.path.join(raw, "amazon"), seed=22)
    cloudtheme_raw_dump(os.path.join(raw, "cloudtheme"), seed=23)
    dumps_s = time.perf_counter() - t0
    for dataset, extra in (("aliccp", []),
                           ("amazon", ["--hemp_fast_adapt", "overlay"])):
        argv = ["--model", "aread", "--dataset_name", dataset, "--data_path",
                raw, "--save_path", save, *extra, *DATA_CLI_FLAGS]
        t0 = time.perf_counter()
        out, stages, test = data_cli_run(ctx, f"data/cli_{dataset}", argv)
        wall_s = time.perf_counter() - t0
        csv = preprocessed_csv_path(dataset, raw)
        if f"[preprocess:{dataset}] wrote {csv}" not in out or \
                "generated augmentation:" not in out:
            raise AssertionError(f"the CLI built no CSV:\n{out[-3000:]}")
        if (stages["parser"], stages["aug_parser"]) != ("native", "native"):
            raise AssertionError(f"parsed by {stages}: the native parser "
                                 "must read both files")
        cfg, _ = load_config(argv)
        aug = os.path.join(save, dataset, os.path.basename(csv).replace(
            ".csv", f"_aug{cfg.aug_ratio}.csv"))
        data = load_split_data(
            csv, dataset, cfg.seq_maxlen, aug_path=aug,
            itemid_all=cfg.itemid_all if dataset == "amazon" else None)
        if extra:
            want = {"sparse_adam": cfg.warm_up_interval * 1024 // cfg.bs
                    + domain_batches(cfg, data),
                    "fused_adam": overlay_launches(
                        chains_of_fit(cfg, data, 1),
                        1 + regroups_per_epoch(cfg, data), cfg)}
        else:
            want = {"sparse_adam": sparse_adam_launches_of_fit(cfg, data, 1),
                    "fused_adam": 0}
        got = ctx["launches_by_path"][f"data/cli_{dataset}"]
        say("data", part=f"cli_{dataset}", model="aread",
            engine="overlay" if extra else "full", csv_rows=len(
                data.train_x) + len(data.valid_x) + len(data.test_x),
            n_domain=data.n_domain, table_rows=int(sum(data.spec.one_hot_dims)),
            stages=stages, wall_s=wall_s, launches=got, schedule=want,
            test_total_auc=test["total_auc"], test_total_loss=test["total_loss"])
        if got != want:
            raise AssertionError(f"{dataset} CLI launches {got}, the "
                                 f"schedule implies {want}")
        if not (np.isfinite(test["total_loss"])
                and 0.0 <= test["total_auc"] <= 1.0):
            raise AssertionError(f"{dataset} CLI test metrics {test}")
        if dataset == "aliccp" and data.n_domain != 30:
            raise AssertionError(f"{data.n_domain} aliccp domains, not 30")
        if dataset == "amazon" and data.n_domain != 25:
            raise AssertionError(f"{data.n_domain} amazon domains, not 25")
    # the CLI again on the same directory, as a user types it (DeepFM: the
    # skip path is the point, not a second AREAD fit): the CSV is left as
    # it is and the parse cache read
    csv = preprocessed_csv_path("aliccp", raw)
    mtime = os.stat(csv).st_mtime_ns
    argv = ["--model", "deepfm", "--dataset_name", "aliccp", "--data_path",
            raw, "--save_path", save, *DATA_CLI_FLAGS]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "aread_tpu_torch", *argv],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    again_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"second CLI run exited {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    stages, test = data_cli_lines(proc.stdout)
    if os.stat(csv).st_mtime_ns != mtime or "[preprocess:" in proc.stdout:
        raise AssertionError("the second run rebuilt the CSV")
    if stages["parser"] != "cache":
        raise AssertionError(f"the second run parsed with {stages['parser']}")
    # Cloud-Theme: the pipeline and the native parse of what it wrote
    t0 = time.perf_counter()
    ct = run_preprocessing("cloudtheme", raw, verbose=False)
    ct_s = time.perf_counter() - t0
    ct_data = load_split_data(ct, "cloudtheme")
    ct_rows = len(ct_data.train_x) + len(ct_data.valid_x) + len(ct_data.test_x)
    say("data", part="skip_and_cloudtheme", raw_dumps_s=dumps_s,
        second_run={"model": "deepfm", "wall_s": again_s, "stages": stages,
                    "test_total_auc": test["total_auc"],
                    "csv_mtime_unchanged": True},
        cloudtheme={"preprocess_s": ct_s, "rows": ct_rows,
                    "n_domain": ct_data.n_domain, "parser": parser_of(ct)})
    if parser_of(ct) != "native" or ct_rows < 20_000 or not (
            0 < ct_data.train_y.mean() < 1):
        raise AssertionError("the Cloud-Theme CSV did not come out right")


# One process of the canonical Amazon file's writer (numpy only: the
# script's own imports would cost each of them torch's): the rows of the
# given chunks, pandas' to_csv text (a list of 2+ ids quoted, of 0 or 1
# bare), fields drawn over the dims, 0-5 ids per history cell, the label
# tied to the item id, each chunk to ``<prefix><chunk>``. Every token is
# gathered from a table of fixed-width NUL-filled words (the last row of
# each: an absent token) and the NULs dropped.
WRITE_CHILD = r'''
import json, sys
import numpy as np

prefix, order, seed, rows, dims = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                                   int(sys.argv[4]), json.loads(sys.argv[5]))
chunks = [int(c) for c in sys.argv[6].split(",")]
domains_all = np.load(order, mmap_mode="r")


def table(words, width):
    out = np.zeros((len(words) + 1, width), np.uint8)
    out[:-1] = np.frombuffer("".join(w.ljust(width, "\0") for w in words)
                             .encode(), np.uint8).reshape(len(words), width)
    return out


nums = [str(i) for i in range(1_400_000)]
ints, seps = table(nums, 7), table([", " + w for w in nums], 9)
opens, closes = table(["[]", "[", '"['], 2), table(["", "]", ']"'], 2)
low5 = table([f"{i:05d}" for i in range(100_000)], 5)
absent = len(ints) - 1
for chunk in chunks:
    domains = np.asarray(domains_all[chunk * rows:(chunk + 1) * rows],
                         np.int64)
    rng = np.random.default_rng([seed, chunk])
    n = len(domains)
    item = rng.integers(0, dims[0], n)
    cols = [rng.integers(0, 1_000_000, n), item, rng.integers(0, dims[1], n),
            domains, *(rng.integers(0, d, n) for d in dims[3:])]
    comma = np.full((n, 1), ord(","), np.uint8)
    parts = []
    for c in cols:
        parts += [ints[c], comma]
    for _ in range(2):
        count = rng.integers(0, 6, n)
        ids = rng.integers(0, dims[0], (n, 5))
        parts += [opens[np.minimum(count, 2)],
                  ints[np.where(count > 0, ids[:, 0], absent)]]
        parts += [seps[np.where(count > j, ids[:, j], absent)]
                  for j in range(1, 5)]
        parts += [closes[np.minimum(count, 2)], comma]
    label = (item % 7) / 3.0 - 1.0 + 0.3 * rng.standard_normal(n) > 0
    ts = 1_502_000_000 + rng.integers(0, 31_536_000, n)
    parts += [ints[label.astype(np.int64)], comma, ints[ts // 100_000],
              low5[ts % 100_000], np.full((n, 1), ord("\n"), np.uint8)]
    text = np.concatenate(parts, axis=1)
    text[text != 0].tofile(f"{prefix}{chunk}")
'''


def write_canonical_amazon(path: str, sizes, seed: int) -> int:
    """The canonical Amazon CSV with ``sizes[d]`` rows of domain d in a
    seeded order, written chunk by chunk by one process per CPU
    (WRITE_CHILD); returns its bytes."""
    import shutil

    order = path + ".domains.npy"
    np.save(order, np.random.default_rng(seed).permutation(
        np.repeat(np.arange(len(sizes), dtype=np.int8), sizes)))
    n_chunks = -(-sum(sizes) // DATA_CHUNK_ROWS)
    workers = min(n_chunks, len(os.sched_getaffinity(0)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WRITE_CHILD, path + ".part", order, str(seed),
         str(DATA_CHUNK_ROWS), json.dumps(AMAZON_DIMS),
         ",".join(str(c) for c in range(w, n_chunks, workers))],
        stderr=subprocess.PIPE, text=True) for w in range(workers)]
    try:
        errors = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"the CSV writer failed: {errors}")
    with open(path, "wb") as f:
        f.write(CANONICAL_AMAZON_HEADER.encode())
        for c in range(n_chunks):
            with open(f"{path}.part{c}", "rb") as part:
                shutil.copyfileobj(part, f, 64 << 20)
            os.remove(f"{path}.part{c}")
    os.remove(order)
    return os.path.getsize(path)


# The native parse of the whole file in a fresh process that has imported
# numpy and the binding alone (torch's CUDA libraries come with the
# loader, after it), then pandas on the first rows, the two held bitwise;
# the native line goes out at once. Resident memory: the high-water mark
# (ru_maxrss), and the largest /proc/self/statm reading of a thread that
# polls it during the parse (None where the file is not there).
PARSE_CHILD = r'''
import json, os, resource, sys, threading, time
from aread_tpu_torch import native


def gb(kb):
    return kb / 2**20


def statm_gb():
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30


path, n_pandas, pad = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cols = tuple(json.loads(sys.argv[4]))
native.build()
before = gb(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
samples, done = [statm_gb()], threading.Event()


def poll():
    while not done.wait(0.005):
        samples.append(statm_gb())


poller = threading.Thread(target=poll)
poller.start()
t0 = time.perf_counter()
x, y, split = native.load_csv(path, *cols, 5, pad)
native_s = time.perf_counter() - t0
done.set()
poller.join()
print(json.dumps({"rows": len(y), "x_cols": x.shape[1],
                  "threads": native.default_threads(), "native_s": native_s,
                  "maxrss_before_parse_gb": before,
                  "maxrss_gb": gb(resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss),
                  "statm_before_parse_gb": samples[0],
                  "statm_peak_gb": None if None in samples else max(samples),
                  "statm_samples": len(samples),
                  "arrays_gb": (x.nbytes + y.nbytes + split.nbytes) / 2**30}),
      flush=True)
from aread_tpu_torch.data import loader

t0 = time.perf_counter()
px, py, ps = loader.read_with_pandas(path, *cols, 5, pad, nrows=n_pandas)
pandas_s = time.perf_counter() - t0
print(json.dumps({"pandas_rows": len(py), "pandas_s": pandas_s,
                  "bitwise_equal": all(
                      a.dtype == b.dtype and a[:n_pandas].tobytes() == b.tobytes()
                      for a, b in ((x, px), (y, py), (split, ps)))}),
      flush=True)
'''
# A child's ru_maxrss starts from the resident size of the process it was
# started from (exec keeps the old image's high-water mark), and this
# script's is gigabytes by now: PARSE_CHILD is started by a small Python
# process, in a session of its own so that both can be killed together.
LAUNCH = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"


def data_big_file(tmp: str):
    """Part (b), first half: the canonical Amazon CSV at the real file's
    17,664,862 rows, and the native parse in a process of its own, which
    then goes on to pandas while part (a) runs. Returns (path, facts,
    the process)."""
    path = os.path.join(tmp, "prepare2train_filter_12month.csv")
    t0 = time.perf_counter()
    size = write_canonical_amazon(path, AMAZON_DOMAIN_SIZES, seed=31)
    write_s = time.perf_counter() - t0
    from aread_tpu_torch.data.loader import dataset_columns

    one_hot, seq, label = dataset_columns("amazon")
    proc = subprocess.Popen(
        [sys.executable, "-c", LAUNCH, sys.executable, "-c", PARSE_CHILD, path,
         str(DATA_PANDAS_ROWS), str(AMAZON_DIMS[0]),
         json.dumps([one_hot, seq, label, "timestamp"])],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    line = proc.stdout.readline()
    if not line:
        proc.wait()
        raise AssertionError(f"the parse process exited {proc.returncode}\n"
                             f"{proc.stderr.read()[-3000:]}")
    return path, {"bytes": size, "write_s": write_s,
                  **json.loads(line)}, proc


def data_parse(ctx, path: str, facts, proc):
    """Part (b), second half: pandas' result on the first DATA_PANDAS_ROWS
    rows; load_split_data cold and warm; DATA_STEPS AREAD bagging steps of
    the train phase's model on batches drawn from the parsed arrays."""
    from aread_tpu_torch.data.loader import (AMAZON_FEATURES, DomainBatcher,
                                             load_split_data, parser_of)

    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the parse process exited {proc.returncode}\n"
                             f"{err[-3000:]}")
    parse = {**facts, **json.loads(out.strip().splitlines()[-1])}
    n_rows = sum(AMAZON_DOMAIN_SIZES)
    t0 = time.perf_counter()
    data = load_split_data(path, "amazon", 5, itemid_all=AMAZON_DIMS[0])
    cold_s = time.perf_counter() - t0
    cold_parser = parser_of(path)
    t0 = time.perf_counter()
    warm = load_split_data(path, "amazon", 5, itemid_all=AMAZON_DIMS[0])
    warm_s = time.perf_counter() - t0
    same = all(np.array_equal(getattr(data, k), getattr(warm, k)) for k in
               ("train_x", "train_y", "valid_x", "test_x", "test_y"))
    spec = data.spec
    say("data", part="parse", **parse,
        native_rows_per_s=n_rows / parse["native_s"],
        pandas_rows_per_s=parse["pandas_rows"] / parse["pandas_s"],
        load_split_data_s={"cold": cold_s, "warm": warm_s},
        parsers={"cold": cold_parser, "warm": parser_of(path)},
        one_hot_dims=list(spec.one_hot_dims))
    if parse["rows"] != n_rows or not parse["bitwise_equal"] or \
            parse["pandas_rows"] != DATA_PANDAS_ROWS:
        raise AssertionError(f"native != pandas on the first rows: {parse}")
    if (cold_parser, parser_of(path)) != ("native", "cache") or not same:
        raise AssertionError("load_split_data: not native then the cache")
    if tuple(spec.one_hot_dims) != AMAZON_DIMS or \
            len(AMAZON_FEATURES) + 10 != data.train_x.shape[1]:
        raise AssertionError(f"not the train phase's layout: {spec}")
    del warm
    # the train phase's model on the parsed rows
    tr = build_trainer(spec, "cuda", N_DOMAIN, dataset_name="amazon", seed=0)
    if tr.model.spec.n_rows != 1518384:
        raise AssertionError("not the train phase's table")
    batcher = DomainBatcher(data.train_x, data.train_y, BS, spec.domain_idx,
                            N_DOMAIN, seed=0)
    ms = tr.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d,
                                             tr.config.init_active_percent)
    batches = [(d, tr.place(batcher.next_batch(d)))
               for d in batcher.domain_batch_seq[:DATA_STEPS]]
    table0 = tr.model.embedding.table.clone()
    losses, times = [], []

    def loop():
        for d, batch in batches:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(tr.main_step(batch, ms.domain_mask[d])[0])
            b.record()
            times.append((a, b))

    counted(ctx, "data/steps", loop)
    launches = ctx["launches_by_path"]["data/steps"]
    losses = torch.stack(losses).cpu().numpy()
    say("data", part="steps", steps=DATA_STEPS, launches=launches,
        step_ms_median=statistics.median(a.elapsed_time(b) for a, b in times),
        loss_first=float(losses[0]), loss_last=float(losses[-1]))
    if launches != {"sparse_adam": DATA_STEPS, "fused_adam": 0} or \
            not np.isfinite(losses).all() or \
            torch.equal(tr.model.embedding.table, table0):
        raise AssertionError(f"steps on the parsed rows: {launches}, "
                             f"{losses}")


def phase_data(ctx):
    """The data pipeline (layer L1) on the card's host, with a fresh parse
    cache: the native parser built; (b) the big file written and parsed
    natively; (a) raw dumps -> the CLI -> kernels 1 and 2, while pandas
    parses the big file's first rows in (b)'s process; (b) the rest."""
    from aread_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build()  # raises if it does not build
    say("data", part="build", library=lib.name,
        seconds=time.perf_counter() - t0, threads=native.default_threads())
    before = os.environ.get("AREAD_TPU_CACHE")
    with tempfile.TemporaryDirectory(prefix="aread_data_") as tmp:
        os.environ["AREAD_TPU_CACHE"] = os.path.join(tmp, "cache")
        proc = None
        try:
            path, facts, proc = data_big_file(tmp)
            data_cli(ctx, tmp)
            data_parse(ctx, path, facts, proc)
        finally:
            if proc is not None and proc.poll() is None:
                # the launcher and PARSE_CHILD
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            if before is None:
                os.environ.pop("AREAD_TPU_CACHE", None)
            else:
                os.environ["AREAD_TPU_CACHE"] = before

# ------------------------------------------------------------------ probes
PROBE_T = 3  # the attribution checks' step: bias corrections below 1


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise, -0.0 and +0.0 told apart (torch.equal compares values)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))


def probes_lazy_profile(dma) -> None:
    """CUDA launches and device busy ms of one lazy_sparse_adam_ update and
    of one kernel 1 update on the probe's bf16 Amazon table and batch, in
    turns in one torch.profiler window, told apart by kernel 1's kernel
    names: the lazy step's back-to-back time holds host waits, its busy
    time does not. A window that saw no device time reports None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aread_tpu_torch.ops.sparse_adam import (lazy_sparse_adam_,
                                                 sparse_adam_cuda)

    w, m, v, uids, gsum = dma.lazy_inputs(BS, "cuda")
    n = 5

    def both():
        lazy_sparse_adam_(w, m, v, uids, gsum, 1, **SPARSE_KW)
        sparse_adam_cuda(w, m, v, uids, gsum, 1, **SPARSE_KW)

    both()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            both()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel") / n
    busy = {"lazy": 0.0, "kernel1": 0.0}
    for e in ka:
        if e.device_type == DeviceType.CUDA:
            who = ("kernel1" if "adam_sweep_vec8" in e.key
                   or "slot_scatter" in e.key else "lazy")
            busy[who] += e.self_device_time_total / n / 1e3
    say("probes", part="lazy_profile", table=list(w.shape),
        lazy={"cuda_launches": launches - 2,
              "busy_ms": busy["lazy"] or None},
        kernel1={"cuda_launches": 2, "busy_ms": busy["kernel1"] or None})


def probes_gather_check(dma) -> float:
    """Both forms of gather_rows_sum, each against its own plain version
    (the ring: chunks in order, then the partials; the serial form: in
    order), on the probe's table and ids, rows 1 and 8, at 16,384 copies
    and short runs (an odd count, one copy, none, one chunk and one more):
    bitwise; then ring calls on two streams at once, bitwise, and the ids'
    range (probes_id_range_check). Returns the worst absolute error."""
    from aread_tpu_torch.ops.gather_rows import (CHUNK, FORMS, PLAIN,
                                                 gather_rows_sum, ring_plan)

    data = dma.make_inputs(dma.N_FLAT, dma.N_COPIES, "cuda")
    worst = 0.0
    for rows in dma.ROWS:
        for n in (dma.N_COPIES, 37, 1, 0, CHUNK, CHUNK + 1):
            ids = data[rows][:n]
            for form in FORMS:
                got = gather_rows_sum(data["table"], ids, rows, form)
                want = PLAIN[form](data["table"], ids, rows)
                line = {"rows": rows, "n": n, "form": form,
                        "sum": float(got), "bitwise": bits_equal(got, want),
                        "max_abs_err": abs(float(got) - float(want))}
                if form == "ring":
                    line["ctas_stages_smem"] = ring_plan(n, rows)
                say("probes", part="gather_check", **line)
                if not line["bitwise"]:
                    raise AssertionError(f"gather_rows != plain version: "
                                         f"{line}")
                worst = max(worst, line["max_abs_err"])
    # the ring on two streams at once: each call has its own ticket
    table, ids = data["table"], data[8]
    streams = [torch.cuda.Stream() for _ in range(2)]
    calls = []
    for k in range(16):
        stream = streams[k % 2]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            part = ids[(k % 8) * 2048:(k % 8 + 1) * 2048]
            calls.append((part, gather_rows_sum(table, part, 8)))
    torch.cuda.synchronize()
    line = {"calls": len(calls), "streams": len(streams), "bitwise": all(
        bits_equal(got, PLAIN["ring"](table, part, 8))
        for part, got in calls)}
    say("probes", part="gather_two_streams", **line)
    if not line["bitwise"]:
        raise AssertionError(f"ring calls on two streams: {line}")
    probes_id_range_check()
    return worst


# a process of its own for each gather form: the block that ends at the
# table's last row is summed bitwise, then an id one past it must make the
# launch fail (the kernel traps; the CUDA context is lost with it)
RANGE_CHILD = r"""
import json, sys
import torch
from aread_tpu_torch.ops.gather_rows import PLAIN, gather_rows_sum
form, rows, n_table = sys.argv[1], 8, 1000
table = torch.arange(n_table * 128, dtype=torch.float32,
                     device="cuda").view(n_table, 128)
edge = torch.tensor([0, 5, n_table - rows], dtype=torch.int32, device="cuda")
got = gather_rows_sum(table, edge, rows, form).cpu()
want = PLAIN[form](table, edge, rows).cpu()
line = {"form": form, "last_block_bitwise": torch.equal(
    got.reshape(1).view(torch.int32), want.reshape(1).view(torch.int32))}
try:
    past = torch.tensor([0, 5, n_table - rows + 1], dtype=torch.int32,
                        device="cuda")
    gather_rows_sum(table, past, rows, form)
    torch.cuda.synchronize()
    line["refused"] = None
except RuntimeError as e:
    line["refused"] = str(e).strip().splitlines()[0]
print(json.dumps(line), flush=True)
"""


def probes_id_range_check() -> None:
    """Each gather form in a process of its own (RANGE_CHILD): the last
    block of the table read bitwise, an id past it refused by the kernel
    (the launch fails)."""
    from aread_tpu_torch.ops.gather_rows import FORMS

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {form: subprocess.Popen(
        [sys.executable, "-c", RANGE_CHILD, form], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for form in FORMS}
    try:
        for form, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            lines = [x for x in out.splitlines() if x.startswith("{")]
            if not lines:
                raise AssertionError(f"the id-range child of {form} printed "
                                     f"nothing: {err[-2000:]}")
            line = json.loads(lines[-1])
            say("probes", part="gather_id_range", **line)
            if not (line["last_block_bitwise"] and line["refused"]):
                raise AssertionError(f"gather_rows id range: {line}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def probes_attrib_check(attrib) -> float:
    """Every adam_attrib mode in every sweep (vec8, tma) against its
    plain version, and full against kernel 1 (sparse_adam_cuda), bitwise
    with -0.0 told apart: at the probe's full table and at small tables of
    D = 8, 64 and 256, on seed-made w (some weights -0.0), m, v and
    batches. Returns the worst absolute error."""
    from aread_tpu_torch.ops.adam_attrib import (FORMS, MODES, adam_attrib_,
                                                 adam_attrib_reference)
    from aread_tpu_torch.ops.sparse_adam import dedup_rows, sparse_adam_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for n_rows, d, bs in ((attrib.N_ROWS, attrib.D, attrib.BS), (5003, 8, 64),
                          (5003, 64, 64), (5003, 256, 16)):
        def draw(scale, fn):
            return (scale * fn((n_rows, d), generator=gen, device=dev)
                    ).to(torch.bfloat16)

        w, m, v = draw(1.0, torch.randn), draw(0.1, torch.randn), \
            draw(0.01, torch.rand)
        w.view(-1)[::97] = -0.0
        ids = torch.randint(0, n_rows, (bs * 17,), generator=gen,
                            device=dev, dtype=torch.int32)
        uids, gsum = dedup_rows(
            ids, torch.randn((bs * 17, d), generator=gen, device=dev), n_rows)
        k1 = w.clone(), m.clone(), v.clone()
        sparse_adam_cuda(*k1, uids, gsum, PROBE_T, **SPARSE_KW)
        for mode, form in ((mode, form) for mode in MODES for form in FORMS):
            if form == FORMS[0]:
                want = adam_attrib_reference(mode, w, m, v, uids, gsum,
                                             PROBE_T, **SPARSE_KW)
            got = w.clone(), m.clone(), v.clone()
            adam_attrib_(mode, *got, uids, gsum, PROBE_T, form=form,
                         **SPARSE_KW)
            torch.cuda.synchronize()
            line = {"table": [n_rows, d], "mode": mode, "form": form,
                    "bitwise": all(bits_equal(a, b)
                                   for a, b in zip(got, want)),
                    "max_abs_err": max(float((a.float() - b.float()).abs()
                                             .max()) for a, b in zip(got, want)),
                    "changed": [not bits_equal(a, b)
                                for a, b in zip(got, (w, m, v))]}
            if mode == "full":
                line["equals_kernel1"] = all(bits_equal(a, b)
                                             for a, b in zip(got, k1))
            if mode == "noadam":
                line["neg_zero_to_pos"] = int(
                    ((w.view(torch.int16) == -32768)
                     & (got[0].view(torch.int16) == 0)).sum())
            say("probes", part="attrib_check", **line)
            if not line["bitwise"] or not line.get("equals_kernel1", True):
                raise AssertionError(f"adam_attrib != plain version or "
                                     f"kernel 1: {line}")
            # what each mode writes: Adam moves w, m and v; noadam only
            # flips -0.0 weights; copy nothing
            moved = {"noadam": [True, False, False],
                     "copy": [False, False, False]}.get(mode, [True] * 3)
            if line["changed"] != moved or \
                    line.get("neg_zero_to_pos", 1) == 0:
                raise AssertionError(f"{mode} wrote what it should not: "
                                     f"{line}")
            worst = max(worst, line["max_abs_err"])
        del w, m, v, ids, uids, gsum
    return worst


def gather_row_times(g) -> dict:
    """The gather's times in the ``kernels`` row from one of the probe's
    gather lines: device times under ``ms`` / ``scalar_ms`` (the
    ``device_ms`` clock: a ring launch is shorter than its host time, so
    the back-to-back clock reads the host; kept as ``back_to_back_ms``),
    the ring's ns a copy by that clock, the cold clock and its share of
    the bound, the library call's clocks."""
    return {"ms": g["device_ms"], "call_ms": g["call_ms"],
            "cold_ms": g["cold_ms"], "back_to_back_ms": g["ms"],
            "ns_per_copy": g["device_ns_per_copy"],
            "cold_ns_per_copy": g["cold_ns_per_copy"],
            "scalar_ms": g["serial_device_ms"],
            "scalar_call_ms": g["serial_call_ms"],
            "scalar_cold_ms": g["serial_cold_ms"],
            "scalar_back_to_back_ms": g["serial_ms"],
            "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "bound_share_cold": g["bound_share_cold"],
            "library_ms": g["library_device_ms"],
            "library_call_ms": g["library_call_ms"],
            "library_cold_ms": g["library_cold_ms"],
            "library_back_to_back_ms": g["library_ms"]}


def phase_probes(ctx):
    """The two probes' entry points at their full sizes, counted
    (aread_tpu_torch.benchmarks.prof_dma_issue: scattered-copy ns at rows
    1 and 8, the lazy-step projection, lazy_sparse_adam_ and kernel 1 on
    the Amazon table; prof_kernel_attrib: every mode's ms per update, the
    shares of the bound, the gaps); then each kernel against its plain
    version, bitwise."""
    from aread_tpu_torch.benchmarks import prof_dma_issue as dma
    from aread_tpu_torch.benchmarks import prof_kernel_attrib as attrib
    from aread_tpu_torch.ops.adam_attrib import DEFAULT_FORM

    gather, attribution = counted(
        ctx, "probes", lambda: (dma.run("cuda"), attrib.run("cuda")))
    launches = ctx["launches_by_path"]["probes"]
    say("probes", part="launches", launches=launches)
    probes_lazy_profile(dma)
    worst_gather = probes_gather_check(dma)
    worst_attrib = probes_attrib_check(attrib)
    g1, g8 = gather["gather"][1], gather["gather"][8]
    full = attribution["modes"]["full"]
    rows = ctx.setdefault("kernel_rows", {})
    rows["gather_rows"] = {
        "name": "gather_rows", "route": "cuda",
        "source": "aread_tpu_torch/ops/cuda/gather_rows.cu",
        "replaces": REPLACES["gather_rows"], "max_abs_err": worst_gather,
        "form": "ring", **gather_row_times(g1), "bound_by": "bytes",
        "rows": 1, "n": g1["n"], "rows8": gather_row_times(g8)}
    forms = full["forms"]
    copy = attribution["modes"]["copy"]["forms"]
    rows["adam_attrib"] = {
        "name": "adam_attrib", "route": "cuda",
        "source": "aread_tpu_torch/ops/cuda/adam_attrib.cu",
        "replaces": REPLACES["adam_attrib"], "max_abs_err": worst_attrib,
        "form": DEFAULT_FORM, "ms": forms[DEFAULT_FORM]["ms"],
        "call_ms": forms[DEFAULT_FORM]["call_ms"],
        "scalar_ms": forms["vec8"]["ms"],
        "scalar_call_ms": forms["vec8"]["call_ms"],
        "plain_ms": attribution["beside"]["plain_full_ms"],
        "bound_ms": full["bound_ms"], "bound_by": "bytes",
        "library_ms": attribution["beside"]["library_ms"],
        "library_call_ms": attribution["beside"]["library_call_ms"],
        "library_copy_ms": attribution["beside"]["library_copy_ms"],
        "library_copy_call_ms": attribution["beside"]["library_copy_call_ms"],
        "copy_ms": {f: copy[f]["ms"] for f in copy},
        "modes_ms": {k: {f: x["ms"] for f, x in v["forms"].items()}
                     for k, v in attribution["modes"].items()}}
    if not (launches["gather_rows"] and launches["adam_attrib"]):
        raise AssertionError(f"the probes launched no kernel: {launches}")


# ------------------------------------------------------------------- spans
# the spans phase: bagging steps in segments of 64 (the first captures),
# a regroup's candidates, 1,024-row chunks of generic Trainer steps
SPANS_SEGMENT, SPANS_CHAINS, SPANS_ROWS = 64, 6, 131072
SPANS_COST_N = 2000  # replays a cost reading (under RING: no slot reused)


def under_sync_error(failed: dict, what: str, fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode('error'), synchronised
    before and after; a host wait inside is kept in ``failed`` under
    ``what`` (and ``fn`` run again, outside the mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        failed[what] = str(e).splitlines()[0]
        torch.cuda.set_sync_debug_mode("default")
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def span_costs() -> dict:
    """Host ns a span costs, a replay's span and its event pair, a pair
    read back, and a span under a running profiler: each the best of 5
    loops on a store of its own, less the bare loop's or call's time."""
    from aread_tpu_torch.utils.profiling import Store

    class Null:  # a graph whose replay launches nothing
        def replay(self):
            pass

    null, n, now = Null(), SPANS_COST_N, time.perf_counter_ns

    def best(fn, timed=False):
        out = []
        for _ in range(5):
            st = Store()
            if timed:  # the pool made and each event created, untimed
                p = st._slot("step")
                for e in p.start + p.end:
                    e.record()
                torch.cuda.synchronize()
            t0 = now()
            fn(st)
            out.append((now() - t0) / n)
        return min(out), st

    def bare(st):
        for _ in range(n):
            null.replay()

    def spans(st):
        for _ in range(n):
            with st.span("x"):
                pass

    def replays(st, timed):
        for _ in range(n):
            st.replay("step", null, False, timed)

    def traced(st):
        with torch.profiler.profile():
            t0 = now()
            spans(st)
            traced.ns = now() - t0

    base, _ = best(bare)
    span_ns, _ = best(spans)
    replay_ns, _ = best(lambda st: replays(st, False))
    timed_ns, st = best(lambda st: replays(st, True), timed=True)
    torch.cuda.synchronize()
    t0 = now()
    st.harvest()
    read_ns = (now() - t0) / n
    traced(Store())
    return {"span_ns": span_ns - base, "replay_span_ns": replay_ns - base,
            "event_pair_ns": timed_ns - replay_ns,
            "pair_read_ns": read_ns,
            "span_under_profiler_ns": traced.ns / n - base,
            "pairs_read": st.counts["device.pairs"]}


def phase_spans(ctx):
    """The store of spans, counters and device event pairs
    (utils/profiling.py) at full Amazon width: AREAD bagging steps fed row
    ids into a resident split, a regroup's candidate chains, generic
    Trainer (DeepFM) chunks staged as train_epoch_device stages them, and
    a Predictor's requests, each replay inside an event pair; a segment of
    steps, a chunk with its staging, the chains and a request's replay run
    under torch.cuda.set_sync_debug_mode('error'), and so does reading the
    pairs back; then every kind has its pairs read, none dropped, and the
    host's cost of a span, a replay's span, an event pair and a pair read
    back."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher, GlobalBatcher
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.ops.sparse_adam import to_device
    from aread_tpu_torch.serve.predictor import Predictor
    from aread_tpu_torch.train.step_graph import SCAN_CHUNK
    from aread_tpu_torch.train.trainer import Trainer
    from aread_tpu_torch.utils.masks import HempMaskState
    from aread_tpu_torch.utils.profiling import PAIR_EVERY, STORE

    spec = amazon_spec()
    x, y = amazon_rows(np.random.default_rng(20), spec, SPANS_ROWS)
    tr = build_trainer(spec, "cuda", N_DOMAIN, dataset_name="amazon", seed=0)
    if not tr.stage_device_data(x, y, x, y):
        raise AssertionError("the spans phase's split is not resident")
    bs = tr.config.bs
    batcher = DomainBatcher(x, y, bs, spec.domain_idx, N_DOMAIN, seed=0)
    ms = HempMaskState(tr.model.n_tower, N_DOMAIN, seed=0)
    masks = [ms.generate_mask("rand", d, 0.7) for d in range(N_DOMAIN)]

    def segment():
        steps = [(d, batcher.next_batch_indices(d),
                  [np.array(m) for m in masks[d]], False)
                 for d in (np.arange(SPANS_SEGMENT) % N_DOMAIN)]
        return tr.run_segment("main", steps)[0]

    failed = {}
    for _ in range(2):  # the first captures
        float(torch.cat(segment()).mean())
    losses = under_sync_error(failed, "AREAD bagging steps", segment)
    float(torch.cat(losses).mean())
    under_sync_error(failed, "reading the steps' pairs", STORE.harvest)

    inputs = chain_inputs(tr, batcher, SPANS_CHAINS)
    for _ in range(2):  # the first captures
        tr.run_chains(*inputs, False)
    chain, _ = tr._stage_chains(False, *inputs)
    under_sync_error(failed, "HEMP chain replays",
                     lambda: tr.chunks.run_chains(chain, SPANS_CHAINS))
    tr._restore(tr._chain_snap)
    under_sync_error(failed, "reading the chains' pairs",
                     lambda: STORE.harvest("chain"))

    pred = Predictor(tr.model, N_DOMAIN, domain_mask=masks)
    req = x[x[:, spec.domain_idx] == 3][:600]
    for _ in range(3):  # eager, the capture, a replay
        pred.predict(req)
    (graph,) = [g for k, g in pred.evals.graphs.items()
                if k.startswith("serve single")]
    under_sync_error(failed, "a request's replays", lambda: [
        STORE.replay("request", graph.graph, True, True, -1)
        for _ in range(PAIR_EVERY["request"])])
    under_sync_error(failed, "reading the request's pair",
                     lambda: STORE.harvest("request"))
    del pred

    cfg = Config(model="deepfm", dataset_name="amazon", seed=0)
    gt = Trainer(build_model(cfg, spec, N_DOMAIN, device="cuda"), cfg,
                 N_DOMAIN)
    gt.init()
    gb = GlobalBatcher(x, y, bs, spec.domain_idx, None, shuffle=True, seed=0)
    gt.stage_device_data(gb)
    perm = gb.epoch_perm()

    def chunk(lo):
        with STORE.span("trainer.stage"):
            staged = to_device(perm[lo:lo + SCAN_CHUNK], gt.device)
        return gt._train_chunk(list(perm[lo:lo + SCAN_CHUNK]), staged=staged)

    for lo in (0, SCAN_CHUNK):  # the first captures
        float(chunk(lo).mean())
    float(under_sync_error(failed, "generic Trainer steps",
                           lambda: chunk(2 * SCAN_CHUNK)).mean())
    under_sync_error(failed, "reading the Trainer's pairs", STORE.harvest)

    summary = STORE.summary()
    say("spans", sync_debug_error=failed or "passed",
        replays=summary["replays"], counters=summary["counters"],
        spans={k: v for k, v in summary["spans"].items()
               if k.startswith(("step_graph.", "hemp.", "serve.",
                                "trainer."))},
        costs=span_costs())
    del tr, gt
    torch.cuda.empty_cache()
    missing = {"step", "chain", "request"} - set(summary["replays"])
    if failed or missing or summary["counters"].get("device.dropped", 0):
        raise AssertionError(f"sync debug: {failed}; pairs: "
                             f"{summary['replays']}; counters "
                             f"{summary['counters']}")


PHASES = {"device": phase_device, "build": phase_build,
          "kernels": phase_kernels, "reference": phase_reference,
          "train": phase_train, "eval": phase_eval,
          "train_dense": phase_train_dense, "zoo": phase_zoo,
          "zoo2": phase_zoo2, "hemp": phase_hemp,
          "serve": phase_serve, "options": phase_options,
          "mesh": phase_mesh, "data": phase_data, "probes": phase_probes,
          "spans": phase_spans}
OPT_IN = {"profile": phase_profile, "profile_dense": phase_profile_dense,
          "profile_hemp": phase_profile_hemp}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile-dir", default="profile",
                    help="where the profile phase writes its tables and trace")
    ap.add_argument("--mesh-rank", nargs=2, metavar=("PART", "WORKDIR"),
                    help=argparse.SUPPRESS)  # a rank of the mesh phase
    args = ap.parse_args(argv)
    if args.mesh_rank and torch.cuda.is_available():
        return mesh_rank_main(*args.mesh_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"profile_dir": args.profile_dir}
    wanted = args.phases.split(",")
    if "device" not in wanted:
        wanted.insert(0, "device")
    for name in wanted:
        t0 = time.perf_counter()
        {**PHASES, **OPT_IN}[name](ctx)
        print(f"# phase {name} done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    for name in KERNEL_SOURCES:
        if LAUNCHED_IN[name] in wanted and not any(
                c.get(name, 0) for c in ctx["launches_by_path"].values()):
            raise AssertionError(f"no path launched {name}")
    say("launches", by_path=ctx.get("launches_by_path", {}))
    rows = []
    for name, row in ctx.get("kernel_rows", {}).items():
        row = dict(row)
        row["launches"] = sum(c.get(name, 0) for c in
                              ctx.get("launches_by_path", {}).values())
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
