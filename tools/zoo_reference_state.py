"""What moves the last bits of ``chip_smoke.py``'s card-vs-CPU zoo check?

``chip_smoke.py``'s ``zoo_reference`` runs one dense Adam step of each
model of phase ``zoo`` on the card and on the CPU, from the same weights,
and holds the two at atol 1e-5. A first Adam step moves an entry by
lr * g / (|g| + eps), so an entry whose gradient is within a few eps of 0
turns the round-off of its sum on either side into a visible difference.
This script asks which side's bits can move, and with what.

Default (one CUDA card): ``zoo_reference`` in fresh processes, before and
after the zoo phase's fits (``zoo_fit``, ``zoo_regroup_twins``), with the
graph runner as it is and with two of its earlier behaviours put back:

* ``streams``: a new side stream for every capture's eager warm-up steps
  (PyTorch keeps a cuBLAS workspace for every stream that ran a product);
* ``refs``: runners that hold their trainer by a strong reference (a
  dropped trainer and its graphs are freed at the next garbage collection,
  not at once).

For every check it prints, per model, the largest difference and its
tensor and a digest of each side's state after the step
(``chip_smoke.state_digest``), so that a change shows which side moved,
and the process state that could pick other kernels: the matmul and TF32
switches, the cuBLAS library and workspace setting, the CPU threads, the
streams made, the memory held.

``--cpu-paths`` (no card needed): the CPU side of the dcnv2 check alone, in
a fresh process for each of the instruction paths that MKL, oneDNN and
ATen can be held to by their environment switches, and the largest
difference of each from the host's own path.

    python3 tools/zoo_reference_state.py                  # every variant
    python3 tools/zoo_reference_state.py --variant plain  # one, in-process
    python3 tools/zoo_reference_state.py --cpu-paths

The lines go to standard output and, with ``--out PATH``, are appended
to that file too.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# each variant: the behaviours put back, then the steps in order
VARIANTS = {
    "plain": ((), ("ref", "ref_side_stream", "fit", "ref")),
    "leaky": (("streams", "refs"), ("ref", "fit", "ref")),
    "leaky_streams": (("streams",), ("ref", "fit", "ref")),
    "leaky_refs": (("refs",), ("ref", "fit", "ref")),
}
# the CPU paths: environment switches read when the libraries load
CPU_PATHS = {
    "host": {},
    "threads_1": {"OMP_NUM_THREADS": "1"},
    "aten_avx2": {"ATEN_CPU_CAPABILITY": "avx2"},
    "aten_default": {"ATEN_CPU_CAPABILITY": "default"},
    "onednn_avx2": {"ONEDNN_MAX_CPU_ISA": "AVX2"},
    "mkl_avx512": {"MKL_ENABLE_INSTRUCTIONS": "AVX512"},
    "mkl_avx2": {"MKL_ENABLE_INSTRUCTIONS": "AVX2"},
    "mkl_sse4_2": {"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"},
    "mkl_cbwr_compatible": {"MKL_CBWR": "COMPATIBLE"},
    "all_avx2": {"ATEN_CPU_CAPABILITY": "avx2", "ONEDNN_MAX_CPU_ISA": "AVX2",
                 "MKL_ENABLE_INSTRUCTIONS": "AVX2"},
}
CPU_PATH_MODEL = "dcnv2"
OUT = []  # the --out file, if any


def emit(**kw) -> None:
    line = json.dumps(kw)
    print(line, flush=True)
    for path in OUT:
        with open(path, "a") as f:
            f.write(line + "\n")


def process_state(made_streams) -> dict:
    from aread_tpu_torch.ops import precision

    m = torch.backends.cuda.matmul
    return {
        "allow_tf32": m.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "fp32_precision": torch.get_float32_matmul_precision(),
        "bf16_reduced_reduction": m.allow_bf16_reduced_precision_reduction,
        "fp16_reduced_reduction": m.allow_fp16_reduced_precision_reduction,
        "blas": str(torch.backends.cuda.preferred_blas_library()),
        "CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "port_bf16_products": precision.bf16_products(),
        "cpu_threads": torch.get_num_threads(),
        "streams_made": made_streams[0],
        "allocated_gb": torch.cuda.memory_allocated() / 2**30,
        "reserved_gb": torch.cuda.memory_reserved() / 2**30,
        "gc_counts": gc.get_count(),
    }


def run_variant(name: str) -> int:
    import chip_smoke as cs
    from aread_tpu_torch.train import step_graph

    put_back, steps = VARIANTS[name]
    made = [0]
    stream_cls = torch.cuda.Stream

    class CountedStream(stream_cls):
        def __new__(cls, *a, **kw):
            made[0] += 1
            return stream_cls.__new__(cls, *a, **kw)

    torch.cuda.Stream = CountedStream
    if "streams" in put_back:
        step_graph.side_stream = lambda dev: torch.cuda.Stream(dev)
    if "refs" in put_back:
        step_graph.weakref = types.SimpleNamespace(proxy=lambda o: o)

    record = {}
    state_diffs = cs.state_diffs

    def recording(cpu_tr, gpu_tr, losses):
        worst, d = state_diffs(cpu_tr, gpu_tr, losses)
        record[cpu_tr.model_name] = {"max_abs_diff": d, "worst": worst,
                                     "cpu": cs.state_digest(cpu_tr),
                                     "cuda": cs.state_digest(gpu_tr)}
        return worst, d

    cs.state_diffs = recording
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"profile_dir": os.path.join(ROOT, "profile")}
    cs.phase_device(ctx)
    cs.phase_build(ctx)
    for i, step in enumerate(steps):
        if step == "fit":
            cs.zoo_fit(ctx)
            cs.zoo_regroup_twins(ctx)
            emit(variant=name, step=i, what="fit", state=process_state(made))
            continue
        record.clear()
        state = process_state(made)
        passed = True
        try:
            if step == "ref_side_stream":
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    cs.zoo_reference(ctx)
                torch.cuda.current_stream().wait_stream(side)
            else:
                cs.zoo_reference(ctx)
        except AssertionError:
            passed = False
        emit(variant=name, step=i, what=step, passed=passed, state=state,
             models=dict(record))
    return 0


def cpu_side(out: str) -> int:
    """The CPU side of the dcnv2 check: its state after the step to
    ``out`` (.npz), its digest to standard output."""
    import chip_smoke as cs

    data, batch = cs.zoo_reference_batch()
    tr = cs.zoo_reference_trainer(CPU_PATH_MODEL, data, "cpu")
    tr.step(batch)
    state = {k: v.detach().float().numpy()
             for k, v in tr.model.state_dict().items()}
    np.savez(out, **state)
    print(json.dumps({"digest": cs.state_digest(tr),
                      "cpu_capability":
                          torch.backends.cpu.get_cpu_capability(),
                      "threads": torch.get_num_threads()}))
    return 0


def cpu_paths() -> int:
    import chip_smoke as cs

    rows, base = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for name, env in CPU_PATHS.items():
            out = os.path.join(tmp, name + ".npz")
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cpu-side",
                 out], cwd=ROOT, env={**os.environ, **env},
                capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"{name}: {r.stderr[-2000:]}")
            row = json.loads(r.stdout.strip().splitlines()[-1])
            state = dict(np.load(out))
            base = base or state
            diffs = {k: float(np.abs(v - base[k]).max())
                     for k, v in state.items()}
            worst = max(diffs, key=diffs.get)
            rows[name] = {**row, "env": env, "max_abs_diff_from_host":
                          diffs[worst], "worst": worst}
    emit(what="cpu_paths", model=CPU_PATH_MODEL, host_cpu=cs.host_cpu(),
         paths=rows)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--cpu-paths", action="store_true")
    ap.add_argument("--out", help="a file the result lines go to as well")
    ap.add_argument("--cpu-side", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.out:
        OUT.append(os.path.abspath(args.out))
    if args.cpu_side:
        return cpu_side(args.cpu_side)
    if args.cpu_paths:
        return cpu_paths()
    if not torch.cuda.is_available():
        print("zoo_reference_state: needs a CUDA card (or --cpu-paths)",
              file=sys.stderr)
        return 2
    if args.variant:
        return run_variant(args.variant)
    rc = 0
    for name in VARIANTS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--variant", name] + (
                                ["--out", OUT[0]] if OUT else []),
                           cwd=ROOT, timeout=900)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
