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
           CUDA launches of one update (torch.profiler);
  train    the AREAD path at full Amazon width: AREADTrainer.init,
           warm-up steps (wo_mask) and bagging steps (domain_mask_bagging)
           under per-domain 'rand' masks, with the kernel launch counts;
  eval     AREADTrainer.evaluate over a few per-domain batches;
  train_dense  the generic Trainer at full Amazon width with the dense
           table gradient: build_model + Trainer.fit for DeepFM (one epoch,
           valid and test passes), then a few steps each of DCN and MMoE,
           and of DeepFM with the sparse table gradient;
  zoo      the zoo's first half at full Amazon width: build_model +
           Trainer.fit (12 dense-gradient steps, valid and test passes) for
           dcnv2, autoint, ple, pepnet, epnet, epnet-single and star, each
           step timed with its launches, device busy time and peak memory;
           one step of each on the card against the CPU at a small width;
           then AREAD on a PLE base (bf16 table and moments): 8 warm-up +
           16 bagging steps, 3 steps card vs CPU, one epoch of
           AREADTrainer.fit at RESUME_DEPTH, the model saved, rebuilt by
           load_predictor and served against the trainer's evaluation;
  zoo2     the zoo's second half at full Amazon width: build_model +
           Trainer.fit (12 dense-gradient steps, valid and test passes) for
           hinet, adasparse and adl, timed as in zoo; ADL's DLM centres
           unit vectors after fit, left bitwise alone by an evaluation and
           moved by one with eval_dlm_update; one step of each card vs CPU
           at a small width, and ADL's centres after such an evaluation;
           MAMDR at the CLI defaults (sparse table gradient, bf16 table and
           moments) through MamdrTrainer.fit for one epoch, its sparse_adam
           launches held to the Reptile schedule's, a Reptile update, a
           merge and a weight swap timed, and one small epoch card vs CPU;
           the four models saved, rebuilt by load_predictor and served
           against their trainers' evaluation; each FM op this slice
           added to ops/fm.py card vs CPU at the Amazon field count;
  hemp     the HEMP loop at full Amazon width: build_model +
           AREADTrainer.fit — warm-up, bagging steps, a mask evolution at
           every regroup point (fresh fast-Adam chains from a snapshot,
           a prune after each step, probes), the valid pass, the
           final-gate phase, the test pass; depth cut to HEMP_DEPTH. Then
           the evolution's parts timed one by one (adapt step, probe,
           snapshot restore, the prune by both routes);
  serve    the path from a trained model to an answered request, at full
           Amazon width: the hemp phase's AREAD (evolved masks), the
           train_dense phase's DeepFM and MMoE each saved with
           save_checkpoint and rebuilt by load_predictor from the
           directory alone; served probabilities against the trainers'
           evaluation, the per-domain loop and the same checkpoint on the
           CPU; the HTTP server on a thread (requests of 1 to 8,192 rows,
           a malformed one); request times per bucket by both clocks;
           streaming evaluation against the exact one; fit(ckpt_dir=) and
           a resume; both CLIs in subprocesses on a seed-made CSV;
  options  the trainers' options at full Amazon width: one 50-chain
           evolution under each fast-adapt engine (the full sweep, kernel
           1; the overlay, kernel 2 alone, on the schedule's launch
           counts) with ms, launches and device time per chain; both
           engines' chains on a 248M-element table and the crossover
           they imply; the overlay card vs CPU and vs the full sweep (f32,
           2 domains); an overlay AREADTrainer.fit with log_dir; MMoE
           fits under each dynamic_regroup mode and the loss matrix card
           vs CPU; compute_dtype='bfloat16' (a product against f64 on
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
           a2a lookup at its measured capacity bitwise the plain gather;
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
           [rows, 128] f32 block copies of a [380,000, 128] table through
           two shared-memory stages, rows 1 and 8: ns per copy, the TPU
           script's lazy-step projection, lazy_sparse_adam_ and kernel 1
           on the bf16 Amazon table by both clocks) and
           aread_tpu_torch.benchmarks.prof_kernel_attrib (kernel 1's sweep
           with parts taken out, six modes at [1,521,664, 32] bf16: ms per
           update over 200 back-to-back updates, shares of the byte bound,
           the gaps); then gather_rows bitwise against its plain version
           (rows 1 and 8; 16,384, 37, 1 and 0 copies) and every adam_attrib
           mode bitwise against its plain version, full against kernel 1
           too (-0.0 told apart), at the full table and at D = 8, 64, 256;
  reference three steps from the same weights on the card and on the CPU
           (plain versions) at a small width, for the AREAD step and for
           the dense DeepFM step, and one small evolution at full width
           (2 domains' chains): they must agree;
  profile, profile_dense, profile_hemp  (opt-in, after train /
           train_dense / hemp) torch.profiler over 4 AREAD bagging steps /
           4 dense DeepFM steps / 4 fast-adapt chains; tables and a trace
           go to --profile-dir.

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
                "gather_rows": ("gather_rows_sum", 1),
                "adam_attrib": ("attrib_sweep", 6)}
# per-kernel times of the final ``kernels`` line (beside library_ms):
# ms / scalar_ms are device times (back-to-back clock) of the vector and the
# scalar kernel, call_ms the vector kernel's per-call median (host included)
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
    out, plus with an f32 table the device-to-device copy of the gathered
    rows. Held on the host-side call count; the device-side kinds are
    printed beside it but a profiler window can lose one of them."""
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
        count=torch.cuda.device_count(), peak_hbm_bytes_per_s=ctx["peak_bw"])


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
    check_fused_adam(ctx)


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


def fused_case(label, w, m, v, g, t, kw, want_vector):
    """Vector (the wrapper's choice, which must be the vector kernel iff
    ``want_vector``) and scalar kernel against the plain version: bitwise,
    repeatable, and the leaf really changed. Returns the worst absolute
    error."""
    from aread_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                fused_adam_reference,
                                                takes_vector_kernel)
    from aread_tpu_torch.ops.sparse_adam import is_aligned16

    ref = fused_adam_reference(w, m, v, g, t, **kw)
    vec = takes_vector_kernel(w.numel(), is_aligned16(w, m, v, g))
    if vec != want_vector:
        raise AssertionError(f"{label}: the wrapper picks vector={vec}")
    worst = 0.0
    for form, forced in kernel_forms():
        if form == "vector" and not vec:
            continue
        line = {"kernel": "fused_adam", **label, "form": form}
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
    gradient; and its times at the full table."""
    from aread_tpu_torch.models.base import FeatureSpec
    from aread_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                fused_adam_reference)
    from aread_tpu_torch.ops.sparse_adam import dedup_rows, sparse_adam_cuda

    dev = torch.device("cuda")
    spec = FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5)  # the dense path pads nothing
    n_rows, d = spec.n_rows, EMBED_DIM
    kw = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-8, l2=1e-5)
    bf16, f32 = torch.bfloat16, torch.float32
    variants = {  # name: (w, moments, g) storage
        "f32": (f32, f32, f32),
        "f32_bf16m": (f32, bf16, f32),
        "bf16_sr": (bf16, bf16, bf16),
        "bf16_f32m": (bf16, f32, f32),
    }
    gen = torch.Generator(device=dev).manual_seed(2)
    t = 7
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


def phase_train(ctx):
    """The main path at full Amazon width (bench.py's configuration and the
    config defaults): 8 warm-up and 16 bagging steps."""
    from aread_tpu_torch.data.loader import DomainBatcher
    from aread_tpu_torch.models.base import FeatureSpec

    # the config defaults are bench.py's Amazon configuration
    t0 = time.perf_counter()
    tr = build_trainer(FeatureSpec(AMAZON_DIMS, 2, 0, 2, 5), "cuda",
                       N_DOMAIN, dataset_name="amazon", seed=0)
    spec, cfg = tr.model.spec, tr.config
    if (spec.n_rows, tr.model.n_tower, cfg.bs) != (1518384, (3, 6, 12), BS):
        raise AssertionError("not the Amazon configuration of bench.py")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x, y = amazon_rows(rng, spec, N_DOMAIN * 3 * BS)
    ex, ey = amazon_rows(rng, spec, N_DOMAIN * 200)
    batcher = DomainBatcher(x, y, BS, spec.domain_idx, N_DOMAIN, seed=0)
    ctx["eval"] = (tr, DomainBatcher(ex, ey, BS, spec.domain_idx, N_DOMAIN,
                                     seed=1),
                   np.bincount(x[:, spec.domain_idx], minlength=N_DOMAIN) / len(x))
    ms = tr.mask_state
    for d in range(N_DOMAIN):
        ms.domain_mask[d] = ms.generate_mask("rand", d,
                                             cfg.init_active_percent)
    table0 = tr.model.embedding.table.clone()
    seq = list(batcher.domain_batch_seq)
    plan = [("warmup", seq[i]) for i in range(8)] + \
        [("main", seq[8 + i]) for i in range(16)]
    batches = [(kind, d, tr.place(batcher.next_batch(d))) for kind, d in plan]
    torch.cuda.synchronize()

    losses, times = [], []

    def loop():
        for kind, d, batch in batches:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if kind == "warmup":
                loss, _ = tr.warmup_step(batch)
            else:
                loss, _ = tr.main_step(batch, ms.domain_mask[d])
            b.record()
            losses.append(loss)
            times.append((kind, a, b))

    t_loop = time.perf_counter()
    counted(ctx, "train", loop)
    loop_s = time.perf_counter() - t_loop
    launches = ctx["launches_by_path"]["train"]
    ctx["profile_args"] = (tr, batches[-1][2], ms.domain_mask[batches[-1][1]])

    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    step_ms = {k: statistics.median(a.elapsed_time(b) for kk, a, b in times
                                    if kk == k) for k in ("warmup", "main")}
    table = tr.model.embedding.table
    if torch.equal(table, table0):
        raise AssertionError("the table did not change")
    st = tr.opt_state
    if not (st["m"].float().abs().sum() > 0 and st["v"].float().abs().sum() > 0):
        raise AssertionError("the table's Adam moments did not change")
    if launches["sparse_adam"] != len(batches):
        raise AssertionError(f"sparse_adam launched "
                             f"{launches['sparse_adam']} times in "
                             f"{len(batches)} steps")
    say("train", table_rows=spec.n_rows, embed_dim=cfg.embed_dim, bs=cfg.bs,
        n_tower=[3, 6, 12], steps={"warmup": 8, "main": 16},
        init_s=init_s, loop_s=loop_s, step_ms_median=step_ms,
        examples_per_s_main=BS / (step_ms["main"] * 1e-3),
        loss_first=float(losses[0]), loss_last=float(losses[-1]),
        launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def phase_eval(ctx):
    tr, batcher, weight = ctx["eval"]
    t0 = time.perf_counter()
    res = tr.evaluate(batcher, weight)
    secs = time.perf_counter() - t0
    for k in ("total_auc", "mean_auc", "total_loss"):
        if not np.isfinite(res[k]) or (k.endswith("auc") and not 0 <= res[k] <= 1):
            raise AssertionError(f"{k}={res[k]}")
    say("eval", total_auc=res["total_auc"], mean_auc=res["mean_auc"],
        total_loss=res["total_loss"], n_batches=len(batcher.domain_batch_seq),
        seconds=secs)


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


def phase_train_dense(ctx):
    """The generic Trainer at full Amazon width. DeepFM with the dense
    table gradient, an f32 table and bf16 moments — the configuration in
    which the JAX package reaches its fused-Adam Pallas kernel — through
    build_model and Trainer.fit: one epoch of 24 steps, the valid pass, the
    test pass with the best weights. Then timed steps of the same trainer,
    a few dense steps each of DCN and MMoE (3 towers, DCN and attention
    side nets, Amazon domain2group), and DeepFM steps with the sparse
    table gradient (the sparse-Adam kernel through the same Trainer)."""
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

    def make(model, sparse=False):
        cfg = Config(model=model, dataset_name="amazon", seed=0,
                     sparse_table_grad=sparse, table_dtype="float32")
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
        def update_(self, params, grads, state):
            super().update_(params, {n: true_zero(n, g)
                                     for n, g in grads.items()}, state)

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
        probe_losses_card=gpu["losses"],
        seconds={"cpu": runs["cpu"][2], "cuda": runs["cuda"][2]})


def reference_aread(ctx, **model_kw):
    """The same three steps, from the same weights, on the card (kernel)
    and on the CPU (plain versions), at a small width with an f32 table,
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
    for step in range(3):
        sl = slice(256 * step, 256 * (step + 1))
        batch = pad_batch(data.train_x[sl], data.train_y[sl], 256)
        for dev, tr in trainers.items():
            loss, _ = (tr.warmup_step(batch) if step == 0
                       else tr.main_step(batch, dm))
            losses[dev].append(float(loss))
    worst, diff = state_diffs(trainers["cpu"], trainers["cuda"], losses)
    if diff > 1e-5:
        raise AssertionError(f"card and CPU disagree after 3 steps: {worst} "
                             f"{diff}")
    say("reference", path="aread AREADTrainer steps",
        base_model=trainers["cpu"].config.base_model, steps=3,
        max_abs_diff=diff, worst=worst, tolerance=1e-5)


# ------------------------------------------------------------------- zoo
ZOO_MODELS = ("dcnv2", "autoint", "ple", "pepnet", "epnet", "epnet-single",
              "star")
ZOO_STEPS = 12
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
    zoo_reference(ctx)
    zoo_aread_ple(ctx)


def zoo_fit(ctx, models=ZOO_MODELS, phase: str = "zoo", keep: bool = False):
    """Each of ``models`` through build_model + Trainer.fit: one epoch of
    ZOO_STEPS dense-gradient steps (f32 table, bf16 moments, dropout 0.2,
    Amazon domain2group), the valid and test passes; then its step timed
    alone, its launches and device busy time per step (torch.profiler) and
    its peak memory. With ``keep``, returns ({name: trainer}, the split);
    else each trainer is dropped before the next is built."""
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
        t0 = time.perf_counter()
        tr = Trainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                     cfg, N_DOMAIN, d2g)
        model = tr.model
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = counted(ctx, f"{phase}/{name}_fit",
                      lambda: tr.fit(data, epochs=1, verbose=False))
        fit_s = time.perf_counter() - t0
        launches = ctx["launches_by_path"][f"{phase}/{name}_fit"]
        if launches != {"fused_adam": ZOO_STEPS, "sparse_adam": 0}:
            raise AssertionError(f"{name}: fit of {ZOO_STEPS} dense steps "
                                 f"launched {launches}")
        hist = res["history"][0]
        check_metrics(name, (("valid", hist), ("test", res["test"])))
        if not np.isfinite(hist["train_loss"]) or tr.opt_state["t"] != ZOO_STEPS:
            raise AssertionError(f"{name}: train loss {hist['train_loss']}, "
                                 f"t={tr.opt_state['t']}")
        batches = [tr.place(b) for b, _ in zip(GlobalBatcher(
            data.train_x, data.train_y, BS, data.spec.domain_idx, d2g,
            seed=1), range(6))]
        with torch.no_grad():
            logit = model(batches[0]["x"], group=batches[0]["group"],
                          train=False)["logit"]
        multi = (name in MULTI_TOWER_MODELS
                 and name not in TOWER_SELECTED_IN_FORWARD)
        want = (BS, 3) if multi else (BS,)
        if tuple(logit.shape) != want or not torch.isfinite(logit).all():
            raise AssertionError(f"{name}: logit {tuple(logit.shape)}, "
                                 f"want {want}")
        step_ms, losses = counted(ctx, f"{phase}/{name}_steps",
                                  lambda: timed_steps(tr, batches))
        per_step, busy_ms = launches_and_busy_per_call(
            lambda: tr.step(batches[0]))
        table = model.embedding.table
        say(phase, model=name, logit_shape=list(want),
            params=sum(p.numel() for p in model.parameters()) + table.numel(),
            dense_params=sum(p.numel() for p in model.parameters()),
            table=[list(table.shape), str(table.dtype)],
            init_s=init_s, fit_s=fit_s, fit_launches=launches,
            train_loss=hist["train_loss"], valid_total_auc=hist["total_auc"],
            valid_mean_auc=hist["mean_auc"],
            test_total_auc=res["test"]["total_auc"],
            test_mean_auc=res["test"]["mean_auc"], step_ms_median=step_ms,
            examples_per_s=BS / (step_ms * 1e-3),
            step_launches=ctx["launches_by_path"][f"{phase}/{name}_steps"],
            cuda_launches_per_step=per_step,
            device_busy_ms_per_step=busy_ms,
            device_idle_share=1 - busy_ms / step_ms,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        if keep:
            kept[name] = tr
        del tr, model, table, batches
    return kept, data


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
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    data = make_synthetic_data(n_rows=1024, n_domain=4, vocab=300, seed=3)
    d2g = np.array([0, 1, 2, 1])
    batch = pad_batch(data.train_x[:256], data.train_y[:256], 256)
    batch["group"] = d2g[batch["x"][:, data.spec.domain_idx]].astype(np.int32)
    diffs, pairs = {}, {}
    for name in models:
        trainers = {}
        for dev in ("cpu", "cuda"):
            cfg = Config(model=name, embed_dim=8, dropout=0.0,
                         sparse_table_grad=False, table_dtype="float32",
                         table_moments_dtype="float32", mlp_dims=(16, 8),
                         tower_dims=(16, 8), sei_dims=(16, 8),
                         ple_expert_dims=((16,), (8,)),
                         ple_tower_dims=(8, 4), atten_embed_dim=8,
                         att_layer_num=1)
            tr = Trainer(build_model(cfg, data.spec, 4, device=dev), cfg, 4,
                         d2g)
            tr.optimizer = true_zero_adam(ZOO_PRE_BN_BIAS[name], cfg.lr,
                                          cfg.wd, cfg.atten_embed_dim)
            tr.init()
            trainers[dev] = tr
        trainers["cuda"].model.load_state_dict(
            trainers["cpu"].model.state_dict())
        losses = {"cpu": [float(trainers["cpu"].step(batch))],
                  "cuda": [float(counted(ctx, "zoo_reference",
                                         lambda: trainers["cuda"].step(batch)))]}
        if ctx["launches_by_path"].pop("zoo_reference")["fused_adam"] != 1:
            raise AssertionError(f"{name}: the card's step did not launch "
                                 "fused_adam")
        diffs[name] = state_diffs(trainers["cpu"], trainers["cuda"], losses)
        pairs[name] = trainers
    say("reference", path="zoo Trainer.step (dense)", steps=1,
        max_abs_diff={n: d for n, (_, d) in diffs.items()},
        worst={n: w for n, (w, _) in diffs.items()}, tolerance=1e-5)
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
    them (and keeps them unit vectors)."""
    model = tr.model
    centres = model.cluster_centers
    norm_err = float((torch.linalg.vector_norm(centres, dim=1) - 1).abs().max())
    before = centres.clone()
    tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
    pure = torch.equal(centres, before)
    model.eval_dlm_update = True
    try:
        res = tr.evaluate(data.valid_x, data.valid_y, data.domain_cnt_weight)
    finally:
        model.eval_dlm_update = False
    moved = float((centres - before).abs().max())
    norm_err_after = float(
        (torch.linalg.vector_norm(centres, dim=1) - 1).abs().max())
    say("zoo2", model="adl", part="centres", shape=list(centres.shape),
        norm_err_after_fit=norm_err, eval_bitwise_unchanged=pure,
        moved_by_eval_dlm_update=moved, norm_err_after_update=norm_err_after,
        valid_total_auc_with_update=res["total_auc"])
    if max(norm_err, norm_err_after) > 1e-5 or not pure or moved == 0.0:
        raise AssertionError("adl: centres not unit vectors, moved by a pure "
                             "evaluation or not moved by eval_dlm_update")


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


def zoo2_mamdr(ctx):
    """MAMDR at the CLI defaults (sparse table gradient, bf16 table and
    moments, 2 auxiliary domains) through build_model + MamdrTrainer.fit:
    one epoch on MAMDR_TRAIN_ROWS rows, valid and test passes of 2,048;
    the sparse_adam launches must be the schedule's; then one Reptile
    update, one merge and one weight swap timed alone (the table
    included), and 6 training steps as zoo times its models'."""
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
    tr = MamdrTrainer(build_model(cfg, data.spec, N_DOMAIN, device="cuda"),
                      cfg, N_DOMAIN)
    table = tr.model.embedding.table
    if tuple(table.shape) != (1518384, EMBED_DIM):
        raise AssertionError(f"table {tuple(table.shape)}")
    want = mamdr_sparse_adam_launches(cfg, data)
    t0 = time.perf_counter()
    res = counted(ctx, "zoo2/mamdr_fit",
                  lambda: tr.fit(data, epochs=1, verbose=False))
    epoch_s = time.perf_counter() - t0
    launches = ctx["launches_by_path"]["zoo2/mamdr_fit"]
    if launches != {"sparse_adam": want, "fused_adam": 0}:
        raise AssertionError(f"mamdr fit launched {launches}, the schedule "
                             f"implies {want} sparse_adam")
    hist = res["history"][0]
    check_metrics("mamdr", (("valid", hist), ("test", res["test"])))
    meta = res["meta_weights"]
    live = tr.live_weights()
    if tr.model.embedding.table is not table or not all(
            torch.equal(v, meta[k]) for k, v in live.items()):
        raise AssertionError("mamdr: the model does not hold the meta weights")
    peak = torch.cuda.max_memory_allocated() / 2**30
    reptile_ms = event_ms(lambda: reptile_update(meta, live, meta,
                                                 cfg.mamdr_meta_lr))
    merge_ms = event_ms(lambda: tree_add(meta, res["domain_weights"][0]))
    swap_ms = event_ms(lambda: tr.load_weights(meta))
    # one training step of the meta-trainer alone (the model's state is
    # put back afterwards: it serves the meta weights)
    saved = {k: v.clone() for k, v in tr.model.state_dict().items()}
    batcher = DomainBatcher(data.train_x, data.train_y, BS,
                            data.spec.domain_idx, N_DOMAIN, seed=1)
    batches = [tr.place(batcher.next_batch(d)) for d in range(6)]
    step_ms, _ = counted(ctx, "zoo2/mamdr_steps",
                         lambda: timed_steps(tr, batches))
    per_step, busy_ms = launches_and_busy_per_call(lambda: tr.step(batches[0]))
    tr.model.load_state_dict(saved)
    say("zoo2", model="mamdr", part="fit", rows=MAMDR_TRAIN_ROWS,
        table=[list(table.shape), str(table.dtype)],
        params=sum(t.numel() for t in live.values()),
        epoch_s=epoch_s, steps=want, launches=launches,
        sparse_adam_launches_schedule=want, step_ms_median=step_ms,
        cuda_launches_per_step=per_step, device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / step_ms,
        valid_total_auc=hist["total_auc"],
        valid_mean_auc=hist["mean_auc"],
        test_total_auc=res["test"]["total_auc"],
        reptile_update_ms=reptile_ms, merge_ms=merge_ms, swap_ms=swap_ms,
        peak_mem_gb=peak)
    del res, meta, live, saved, batches
    return tr


def zoo2_mamdr_reference(ctx):
    """One MamdrTrainer.fit epoch from the same weights on the card
    (sparse-Adam kernel) and on the CPU (plain version): a small width
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
    diffs = {}
    for what, pick in (("meta", lambda r: r["meta_weights"]),
                       ("domain0", lambda r: r["domain_weights"][0])):
        a, b = pick(res["cpu"]), pick(res["cuda"])
        for k in a:
            diffs[f"{what}:{k}"] = float((a[k] - b[k].cpu()).abs().max())
    worst = max(diffs, key=diffs.get)
    say("reference", path="mamdr MamdrTrainer.fit (one epoch)",
        launches=launches, max_abs_diff=diffs[worst], worst=worst,
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

    # a whole chain by either prune route, in turns (host, device, device,
    # host), from the snapshot each time. The trainer prunes on the host;
    # the tensor twin stands in for it here, the mask kept on the card
    card_mask = {}

    def device_prune(_, gate_means):
        card_mask["m"] = prune_mask_tensor(card_mask["m"], gate_means)
        return card_mask["m"]

    def chain():
        card_mask["m"] = mask_t
        tr._restore(snap)
        tr._fast_adapt(mask, fa, probes)[1].cpu()

    host_prune = tr._prune
    chain_ms = {"host": [], "device": []}
    for route in ("host", "device", "device", "host"):
        tr._prune = device_prune if route == "device" else host_prune
        chain_ms[route].append(event_ms(chain, n=6)[1])
    tr._prune = host_prune
    tr._restore(snap)
    ctx["hemp_profile_args"] = chain
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
        chain_ms_host_clock_by_prune_route=chain_ms,
        prune_route_in_use="host",
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


def serve_times(preds, x: np.ndarray, http_ms):
    """Request time per bucket: median of 20 predict calls by CUDA events
    and by the host clock (each call ends in its device-to-host copy),
    single- and mixed-domain, the HTTP round trip beside them; CUDA
    launches and copies per request (torch.profiler; one copy in and one
    out, or the run fails); the host's JSON work of a request apart from
    the device's."""
    pred = preds["aread"]
    rows = []
    for n in SERVE_BUCKETS:
        for kind, req in (("single", single_domain(x[:n], 3)),
                          ("mixed", x[:n])):
            ev, host = event_ms(lambda: pred.predict(req), n=20)
            copies, kinds = cuda_copies_per_call(lambda: pred.predict(req))
            assert_copies(f"a {kind} request of {n} rows", copies, kinds, 2)
            rows.append({"rows": n, "kind": kind, "events_ms": ev,
                         "host_clock_ms": host,
                         "http_round_trip_ms": http_ms[f"{n}_{kind}"],
                         "launches": cuda_launches_per_call(
                             lambda: pred.predict(req)),
                         "copies": copies, "copy_kinds": kinds})
    ev, host = event_ms(lambda: predict_per_domain(pred, x), n=5)
    per_domain = {"rows": len(x), "events_ms": ev, "host_clock_ms": host}
    others = {}
    for name in ("deepfm", "mmoe"):
        ev, host = event_ms(lambda: preds[name].predict(x), n=20)
        copies, kinds = cuda_copies_per_call(lambda: preds[name].predict(x))
        assert_copies(f"{name}: a request of {len(x)} rows", copies, kinds, 3)
        others[name] = {"rows": len(x), "events_ms": ev, "host_clock_ms": host,
                        "launches": cuda_launches_per_call(
                            lambda: preds[name].predict(x)),
                        "copies": copies, "copy_kinds": kinds}
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


def chain_fn(tr, d: int, rng, overlay: bool):
    """One chain of domain ``d`` from a snapshot (restore, adapt steps with
    their prunes, probes, the fetch of the probe losses), as a callable;
    the regroup's whole-table drift L2 as another (None for the full
    sweep); and the snapshot, which the caller restores when it is done
    timing (a chain leaves the weights as it moved them)."""
    from aread_tpu_torch.ops import overlay_adam as oa
    from aread_tpu_torch.train.trainer import TABLE_L2

    cfg, spec = tr.config, tr.model.spec
    x, y = amazon_rows(rng, spec, (cfg.regroup_update_step
                                   + cfg.regroup_eval_step) * BS)
    x[:, spec.domain_idx] = d
    bs = [tr.place({"x": x[i * BS:(i + 1) * BS], "y": y[i * BS:(i + 1) * BS]
                    .astype(np.float32), "valid": np.ones(BS, np.float32)})
          for i in range(len(x) // BS)]
    fa, probes = bs[:cfg.regroup_update_step], bs[cfg.regroup_update_step:]
    mask = tr.mask_state.generate_mask("rand", d, 0.7)
    table = tr.model.embedding.table
    snap = tr._snapshot(table=not overlay)
    drift = ((lambda: oa.drift_table_l2(table, cfg.regroup_update_step,
                                        cfg.update_lr, cfg.wd, TABLE_L2))
             if overlay else None)
    state = {"drift": drift() if overlay else None}

    def chain():
        tr._restore(snap)
        tr._fast_adapt(mask, fa, probes, state["drift"])[1].cpu()

    return chain, drift, snap


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
    ctx["overlay_amazon"] = (runs["full"]["trainer"], elems)
    del runs
    torch.cuda.empty_cache()


def chain_times(tr):
    """Per engine, on ``tr``'s table: the host-clock ms of one chain
    (median of 5, the engines in turns full, overlay, overlay, full), its
    CUDA launches and device busy ms (torch.profiler, 2 chains), and the
    whole-table drift L2's ms (once per regroup; 0 for the full sweep)."""
    fns = {e: chain_fn(tr, 0, np.random.default_rng(9), e == "overlay")
           for e in ("full", "overlay")}
    out = {e: {"chain_ms_host_clock": []} for e in fns}
    for e in ("full", "overlay", "overlay", "full"):
        chain, _, snap = fns[e]
        out[e]["chain_ms_host_clock"].append(event_ms(chain, n=5)[1])
        tr._restore(snap)
    for e, (chain, drift, snap) in fns.items():
        launches, busy = launches_and_busy_per_call(chain, n=2)
        tr._restore(snap)
        out[e].update(cuda_launches=launches, device_busy_ms=busy,
                      drift_l2_ms=event_ms(drift, n=3)[1] if drift else 0.0)
    return out


def options_overlay_large(ctx, tmp: str):
    """Each engine's chain on the Amazon table and on one past 240M
    elements, and where the two cross: each engine's time per chain (the
    overlay's whole-table drift shared by a regroup's 50 chains) taken as
    linear in the table's size between the two tables, once by the host
    clock (what a regroup takes) and once by device busy time."""
    from aread_tpu_torch.train.hemp import OVERLAY_AUTO_MIN_ELEMS

    small_tr, e1 = ctx.pop("overlay_amazon")
    small = chain_times(small_tr)
    del small_tr
    torch.cuda.empty_cache()
    tr = aread_overlay_trainer(BIG_DIMS)
    e2 = tr.model.spec.n_rows * EMBED_DIM
    if e2 < OVERLAY_AUTO_MIN_ELEMS or not tr.overlay_enabled():
        raise AssertionError(f"{e2} elements: not past the crossover")
    tr.init()
    big = chain_times(tr)

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
    del tr
    torch.cuda.empty_cache()


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
                     "test_mean_auc": res["test"]["mean_auc"]}
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
    """Opt-in, after train: the AREAD bagging step under torch.profiler."""
    tr, batch, dm = ctx["profile_args"]
    profile_steps(ctx, "aread_bagging", lambda: tr.main_step(batch, dm))


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
    return out


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


def mesh_dense_trainer(mesh, device):
    """DeepFM with the dense table gradient (kernel 2), f32 table and
    moments, dropout 0.2, the pre-BatchNorm biases at their true zero."""
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer

    cfg = Config(model="deepfm", dataset_name="amazon", seed=0, bs=BS,
                 sparse_table_grad=False, table_dtype="float32",
                 table_moments_dtype="float32")
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
    """gather_rows_sum against its plain version on the probe's table and
    ids, rows 1 and 8, 16,384 copies and a few short runs (an odd count,
    one copy, none): bitwise. Returns the worst absolute error."""
    from aread_tpu_torch.ops.gather_rows import (gather_rows_reference,
                                                 gather_rows_sum)

    data = dma.make_inputs(dma.N_FLAT, dma.N_COPIES, "cuda")
    worst = 0.0
    for rows in dma.ROWS:
        for n in (dma.N_COPIES, 37, 1, 0):
            ids = data[rows][:n]
            got = gather_rows_sum(data["table"], ids, rows)
            want = gather_rows_reference(data["table"], ids, rows)
            line = {"rows": rows, "n": n, "sum": float(got),
                    "bitwise": bits_equal(got, want),
                    "max_abs_err": abs(float(got) - float(want))}
            say("probes", part="gather_check", **line)
            if not line["bitwise"]:
                raise AssertionError(f"gather_rows != plain version: {line}")
            worst = max(worst, line["max_abs_err"])
    return worst


def probes_attrib_check(attrib) -> float:
    """Every adam_attrib mode against its plain version, and full against
    kernel 1 (sparse_adam_cuda), bitwise with -0.0 told apart: at the
    probe's full table and at small tables of D = 8, 64 and 256, on
    seed-made w (some weights -0.0), m, v and batches. Returns the worst
    absolute error."""
    from aread_tpu_torch.ops.adam_attrib import (MODES, adam_attrib_,
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
        for mode in MODES:
            got = w.clone(), m.clone(), v.clone()
            adam_attrib_(mode, *got, uids, gsum, PROBE_T, **SPARSE_KW)
            want = adam_attrib_reference(mode, w, m, v, uids, gsum, PROBE_T,
                                         **SPARSE_KW)
            torch.cuda.synchronize()
            line = {"table": [n_rows, d], "mode": mode,
                    "bitwise": all(bits_equal(a, b)
                                   for a, b in zip(got, want)),
                    "max_abs_err": max(float((a.float() - b.float()).abs()
                                             .max()) for a, b in zip(got, want)),
                    "changed": [not bits_equal(a, b)
                                for a, b in zip(got, (w, m, v))]}
            if mode == "full":
                k1 = w.clone(), m.clone(), v.clone()
                sparse_adam_cuda(*k1, uids, gsum, PROBE_T, **SPARSE_KW)
                torch.cuda.synchronize()
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


def phase_probes(ctx):
    """The two probes' entry points at their full sizes, counted
    (aread_tpu_torch.benchmarks.prof_dma_issue: scattered-copy ns at rows
    1 and 8, the lazy-step projection, lazy_sparse_adam_ and kernel 1 on
    the Amazon table; prof_kernel_attrib: every mode's ms per update, the
    shares of the bound, the gaps); then each kernel against its plain
    version, bitwise."""
    from aread_tpu_torch.benchmarks import prof_dma_issue as dma
    from aread_tpu_torch.benchmarks import prof_kernel_attrib as attrib

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
        "ms": g1["ms"], "call_ms": g1["call_ms"], "plain_ms": g1["plain_ms"],
        "bound_ms": g1["bound_ms"], "bound_by": "bytes",
        "library_ms": g1["library_ms"], "rows": 1, "n": g1["n"],
        "ns_per_copy": g1["ns_per_copy"], "rows8_ms": g8["ms"],
        "rows8_ns_per_copy": g8["ns_per_copy"],
        "rows8_plain_ms": g8["plain_ms"], "rows8_library_ms": g8["library_ms"],
        "rows8_bound_ms": g8["bound_ms"]}
    rows["adam_attrib"] = {
        "name": "adam_attrib", "route": "cuda",
        "source": "aread_tpu_torch/ops/cuda/adam_attrib.cu",
        "replaces": REPLACES["adam_attrib"], "max_abs_err": worst_attrib,
        "ms": full["ms"], "call_ms": full["call_ms"],
        "plain_ms": attribution["beside"]["plain_full_ms"],
        "bound_ms": full["bound_ms"], "bound_by": "bytes",
        "library_ms": attribution["beside"]["library_ms"],
        "modes_ms": {k: v["ms"] for k, v in attribution["modes"].items()}}
    if not (launches["gather_rows"] and launches["adam_attrib"]):
        raise AssertionError(f"the probes launched no kernel: {launches}")


PHASES = {"device": phase_device, "build": phase_build,
          "kernels": phase_kernels, "reference": phase_reference,
          "train": phase_train, "eval": phase_eval,
          "train_dense": phase_train_dense, "zoo": phase_zoo,
          "zoo2": phase_zoo2, "hemp": phase_hemp,
          "serve": phase_serve, "options": phase_options,
          "mesh": phase_mesh, "data": phase_data, "probes": phase_probes}
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
