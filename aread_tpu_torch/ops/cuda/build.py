"""Builds the port's CUDA kernels and registers them as PyTorch operators.

Each kernel ``<name>`` has two sources in this directory:

* ``<name>.cu`` — the kernels and a plain C launcher, no PyTorch headers,
  compiled by ``nvcc`` for ``sm_90a``;
* ``<name>_op.cpp`` — the ``TORCH_LIBRARY`` registration of the operator
  ``torch.ops.aread_tpu_torch.<name>_``, compiled by the host C++
  compiler against PyTorch's headers.

The two compile at once and ``nvcc`` links them into one shared library
in ``aread_tpu_torch/_build/`` (ignored by git), named by a hash of the
sources, every header beside them (``*.cuh``: device code the kernels
share), the flags and the PyTorch version, so a changed source or header is
rebuilt and an unchanged one is loaded as it is. ``load`` registers it with
``torch.ops.load_library``. Neither ninja nor ``torch.utils.cpp_extension``
is needed. Nothing is built when the module is imported: the first call
of a kernel's wrapper on a CUDA tensor builds it. A failed build raises;
there is no fallback.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that a*b+c
is never contracted into an FMA — the kernels then match their plain
PyTorch versions bitwise. No fast-math: IEEE division and sqrt stay.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "_build"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
]
TORCH_DIR = Path(torch.__file__).resolve().parent

_LOCK = threading.Lock()
_LOADED: Dict[str, Path] = {}
# ptxas report (registers, spills) and seconds per step of each build in
# this process
BUILD_LOGS: Dict[str, str] = {}
BUILD_TIMES: Dict[str, Dict[str, float]] = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def cxx_flags() -> List[str]:
    """Host-compiler flags for a ``TORCH_LIBRARY`` source."""
    return ["-O2", "-std=c++20", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            "-I", str(TORCH_DIR / "include"),
            "-I", str(TORCH_DIR / "include" / "torch" / "csrc" / "api" / "include")]


def link_flags() -> List[str]:
    lib = str(TORCH_DIR / "lib")
    return ["-shared", f"-L{lib}", "-lc10", "-ltorch_cpu", "-ltorch",
            "-Xlinker", f"-rpath={lib}"]


def sources(name: str) -> List[Path]:
    return [SRC_DIR / f"{name}.cu", SRC_DIR / f"{name}_op.cpp"]


def headers() -> List[Path]:
    """Every header of the source directory: the kernels share device
    code through them (``rounding.cuh``)."""
    return sorted(p for p in SRC_DIR.iterdir()
                  if p.suffix in (".cuh", ".h", ".hpp"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sources(name) + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + cxx_flags() + link_flags()).encode())
    h.update(torch.__version__.encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _run(cmd: List[str], what: str) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc


def build(name: str, nvcc: Optional[str] = None) -> Path:
    """Compile ``<name>.cu`` and ``<name>_op.cpp`` (at once) and link them
    into the build directory, unless the library for these exact sources
    and flags is already there."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = nvcc or find_nvcc()
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    cu, op = sources(name)
    kobj, oobj = tmp / "kernel.o", tmp / "op.o"
    t0 = time.perf_counter()
    times: Dict[str, float] = {}

    def compile_(key, cmd, what):
        proc = _run(cmd, what)
        times[key] = time.perf_counter() - t0
        return proc

    with ThreadPoolExecutor(max_workers=2) as ex:
        kf = ex.submit(compile_, "nvcc_s",
                       [nvcc, *NVCC_FLAGS, "-c", "-o", str(kobj), str(cu)],
                       f"nvcc {cu.name}")
        of = ex.submit(compile_, "cxx_s",
                       [os.environ.get("CXX", "c++"), *cxx_flags(), "-c",
                        "-o", str(oobj), str(op)], f"c++ {op.name}")
        ptxas = kf.result().stderr
        of.result()
    lib = tmp / out.name
    _run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(kobj), str(oobj),
          *link_flags()], f"linking {out.name}")
    times["total_s"] = time.perf_counter() - t0
    os.replace(lib, out)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_LOGS[name] = ptxas
    BUILD_TIMES[name] = times
    return out


def load(name: str) -> None:
    """Build if needed and register ``<name>``'s operator with PyTorch
    (once per process)."""
    with _LOCK:
        if name not in _LOADED:
            path = build(name)
            torch.ops.load_library(str(path))
            _LOADED[name] = path


def build_all(names: List[str]) -> Dict[str, Path]:
    """Build every named kernel at once (for a cold build directory) and
    wait for all of them."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futures = {n: ex.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}
