"""ctypes binding of the port's native CSV parser (counterpart of
``aread_tpu/native/__init__.py``).

``load_csv`` parses a canonical CSV into (x int32 [N, n_onehot +
n_seq * maxlen], y int8 [N], split float64 [N]) in one multi-threaded pass
of ``csv_loader.cc``: the one-hot columns as ints, each sequence cell's
last ``maxlen`` ids padded on the right, the label and the split column.

The library is built at first use: ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` (``$CXX`` replaces ``g++``) straight into
``aread_tpu_torch/_build/``, named by a hash of the source, the compiler
and the flags, so a changed source is rebuilt and an unchanged one loaded
as it is. Nothing is written into the package directory.
``python -m aread_tpu_torch.native`` builds it explicitly.

A failed build raises ``RuntimeError`` with the compiler's output (the JAX
package falls back to pandas instead). ``AREAD_TPU_NO_NATIVE=1`` is the
only way to choose pandas: ``available()`` is then False.

The arrays that ``load_csv`` returns are the parser's own buffers, freed
when the last of the three is collected: no copy, so the peak is one set
of arrays and the file's bytes, not two sets.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csv_loader.cc"
BUILD_DIR = SRC.parent.parent / "_build"
CXX = os.environ.get("CXX", "g++")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib = None


class _CsvResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_x_cols", ctypes.c_int64),
        ("x", ctypes.POINTER(ctypes.c_int32)),
        ("y", ctypes.POINTER(ctypes.c_int8)),
        ("split", ctypes.POINTER(ctypes.c_double)),
    ]


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CXX] + CXX_FLAGS).encode())
    return BUILD_DIR / f"libaread_csv_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csv_loader.cc`` into the build directory unless the
    library for this source, compiler and flags is already there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native CSV parser failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native CSV parser failed "
                           f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: processes that build at once agree
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.aread_csv_load.restype = ctypes.POINTER(_CsvResult)
            lib.aread_csv_load.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int,
            ]
            lib.aread_csv_free.argtypes = [ctypes.POINTER(_CsvResult)]
            lib.aread_csv_last_error.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def available() -> bool:
    """False when ``AREAD_TPU_NO_NATIVE`` is set; else True once the
    library is built and loaded (a failed build raises)."""
    if os.environ.get("AREAD_TPU_NO_NATIVE"):
        return False
    _load()
    return True


def default_threads() -> int:
    """The parse's thread count: the CPUs this process may run on. The
    C++ side's own default, ``hardware_concurrency()``, counts every CPU of
    the host, which on a shared machine can be many times the process's
    share."""
    return len(os.sched_getaffinity(0))


class _Buffers:
    """Owns one parse result; frees it when the last array is gone."""

    def __init__(self, lib, res):
        weakref.finalize(self, lib.aread_csv_free, res)


def _view(ptr, ctype, dtype, n: int, owner: _Buffers) -> np.ndarray:
    buf = (ctype * n).from_address(ctypes.addressof(ptr.contents))
    buf._owner = owner  # the array -> buf -> owner chain keeps it alive
    return np.frombuffer(buf, dtype=dtype)


def load_csv(path: str, onehot_cols: Sequence[str], seq_cols: Sequence[str],
             label_col: str, split_col: str, seq_maxlen: int,
             pad_value: int, n_threads: int = 0
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``path`` natively with ``n_threads`` threads (0:
    ``default_threads()``). Raises RuntimeError on a parse failure."""
    lib = _load()
    res = lib.aread_csv_load(
        path.encode(), ",".join(onehot_cols).encode(),
        ",".join(seq_cols).encode(), label_col.encode(), split_col.encode(),
        int(seq_maxlen), int(pad_value),
        int(n_threads) or default_threads())
    if not res:
        raise RuntimeError("native csv load failed: "
                           + lib.aread_csv_last_error().decode())
    r = res.contents
    n, c = r.n_rows, r.n_x_cols
    if n == 0:
        lib.aread_csv_free(res)
        return (np.zeros((0, c), np.int32), np.zeros(0, np.int8),
                np.zeros(0, np.float64))
    owner = _Buffers(lib, res)
    x = _view(r.x, ctypes.c_int32, np.int32, n * c, owner).reshape(n, c)
    y = _view(r.y, ctypes.c_int8, np.int8, n, owner)
    split = _view(r.split, ctypes.c_double, np.float64, n, owner)
    return x, y, split
