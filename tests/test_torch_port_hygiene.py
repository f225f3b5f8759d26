"""The port's boundaries: aread_tpu_torch and chip_smoke.py import nothing
of JAX or of the JAX package; without a card every entry point raises
instead of running on the CPU; the CUDA wrapper never takes CPU tensors;
the kernel build keeps IEEE arithmetic."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.device import resolve_device
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.ops.cuda import build
from aread_tpu_torch.ops.sparse_adam import sparse_adam_cuda

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "aread_tpu")
PORT_FILES = sorted((ROOT / "aread_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the card-less refusal")


def test_entry_points_raise_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    spec = make_synthetic_data(n_rows=64, n_domain=2, vocab=20).spec
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AREAD(spec, 8, (2, 4), 2, expert_dims=(8,), tower_dims=((4,), (4,)))
    assert AREAD(spec, 8, (2, 4), 2, expert_dims=(8,),
                 tower_dims=((4,), (4,)), device="cpu").device.type == "cpu"


def test_cuda_wrapper_refuses_cpu_tensors():
    w = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_adam_cuda(w, w.clone(), w.clone(),
                         torch.zeros(4, dtype=torch.int32),
                         torch.zeros((4, 8)), 1, lr=1e-3)


def test_build_flags_keep_ieee_arithmetic():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert build.BUILD_DIR == ROOT / "aread_tpu_torch" / "_build"
    assert all(src.exists() for src in build.sources("sparse_adam"))


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    _no_card()
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
