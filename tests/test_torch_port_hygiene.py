"""The port's boundaries: aread_tpu_torch and chip_smoke.py import nothing
of JAX or of the JAX package; without a card every entry point (the
models, load_predictor, both CLIs) raises instead of running on the CPU; the CUDA wrappers never take CPU tensors;
the kernel build keeps IEEE arithmetic, names a library by its sources and
every shared header; both kernels count their launches in one place; the
sparse kernel's slot map has one key; chip_smoke.py knows the four
kernels, drives both trainers, the HEMP loop, the serving path, the mesh,
the data pipeline from raw dumps and the probes and ends with the fixed
line; the probes' modules are framework-free; the data
pipeline's modules and the native parser's binding are framework-free; what the trainers had left unported runs
(streaming_eval, warm_start, ckpt_dir, the overlay engine,
compute_dtype, log_dir, the epoch watchdog, a mesh and
embed_lookup='a2a'), and no module of the port refuses a mesh, a2a or
the barrier as not ported."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import aread_tpu_torch.ops.cuda as cuda_ops
from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import make_synthetic_data, pad_batch
from aread_tpu_torch.device import resolve_device
from aread_tpu_torch.models import build_model
from aread_tpu_torch.models.aread import AREAD
from aread_tpu_torch.ops import fused_adam, sparse_adam
from aread_tpu_torch.ops.cuda import build
from aread_tpu_torch.ops.sparse_adam import sparse_adam_cuda
from aread_tpu_torch.train.hemp import AREADTrainer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "aread_tpu")
PARALLEL_MODULES = ("parallel/mesh.py", "parallel/distributed.py",
                    "parallel/health.py", "parallel/embed_shard.py",
                    "parallel/sharded_adam.py", "parallel/train_step.py")
DATA_MODULES = ("native/__init__.py", "native/__main__.py",
                "data/preprocess.py", "data/aliccp_raw.py",
                "data/pipeline.py", "data/loader.py", "data/augment.py")
# the probes that replace the benchmark folder's TPU kernels
PROBE_MODULES = ("ops/gather_rows.py", "ops/adam_attrib.py",
                 "benchmarks/__init__.py", "benchmarks/prof_dma_issue.py",
                 "benchmarks/prof_kernel_attrib.py")
SERVING_MODULES = ("config.py", "convert.py", "__main__.py",
                   "train/checkpoint.py", "train/metrics.py",
                   "data/loader.py", "data/augment.py", "data/pipeline.py",
                   "serve/__init__.py", "serve/predictor.py",
                   "serve/server.py", "serve/__main__.py")
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


def test_serving_modules_are_among_the_checked_files():
    checked = {str(p.relative_to(ROOT / "aread_tpu_torch"))
               for p in PORT_FILES[:-1]}
    assert set(SERVING_MODULES) <= checked
    # the mesh layer too: it imports torch.distributed, never jax
    assert set(PARALLEL_MODULES) <= checked
    for m in PARALLEL_MODULES:
        roots = set(_imported_roots(ROOT / "aread_tpu_torch" / m))
        assert roots <= {"__future__", "contextlib", "os", "datetime",
                         "threading", "time", "typing", "numpy", "torch",
                         "aread_tpu_torch"}, (m, roots)
    # the server is standard library and numpy only
    roots = set(_imported_roots(ROOT / "aread_tpu_torch/serve/server.py"))
    assert roots <= {"__future__", "json", "threading", "http", "numpy"}


def test_data_pipeline_modules_are_checked_and_framework_free():
    """The raw-dump pipeline and the native parser's binding are among the
    checked files and import the standard library, numpy, pandas and the
    port only (the loader and augment.py are host code too)."""
    checked = {str(p.relative_to(ROOT / "aread_tpu_torch"))
               for p in PORT_FILES[:-1]}
    assert set(DATA_MODULES) <= checked
    for m in DATA_MODULES:
        roots = set(_imported_roots(ROOT / "aread_tpu_torch" / m))
        assert roots <= {"__future__", "ast", "ctypes", "dataclasses",
                         "datetime", "hashlib", "json", "logging", "os",
                         "pathlib", "re", "subprocess", "threading", "typing",
                         "weakref", "argparse", "numpy", "pandas",
                         "aread_tpu_torch"}, (m, roots)
    src = (ROOT / "aread_tpu_torch/native/csv_loader.cc").read_text()
    for name in ("aread_csv_load(", "aread_csv_free(",
                 "aread_csv_last_error("):
        assert name in src, name


def test_probe_modules_are_checked_and_framework_free():
    """The probes' wrappers and entry points are among the checked files,
    import the standard library, numpy, torch and the port only, and
    chip_smoke.py runs them in its default phase list."""
    checked = {str(p.relative_to(ROOT / "aread_tpu_torch"))
               for p in PORT_FILES[:-1]}
    assert set(PROBE_MODULES) <= checked
    for m in PROBE_MODULES:
        roots = set(_imported_roots(ROOT / "aread_tpu_torch" / m))
        assert roots <= {"__future__", "argparse", "json", "statistics",
                         "subprocess", "time", "typing", "numpy", "torch",
                         "aread_tpu_torch"}, (m, roots)
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    phases = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "PHASES")
    assert "probes" in [k.value for k in phases.keys]


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


def test_serving_entry_points_raise_without_a_card(tmp_path):
    """load_predictor (and so the predictor behind make_server) and both
    CLIs resolve their device first: no card and no request for the CPU is
    an error, not a CPU run."""
    _no_card()
    from aread_tpu_torch.__main__ import main as train_main
    from aread_tpu_torch.serve.__main__ import main as serve_main
    from aread_tpu_torch.serve.predictor import load_predictor
    from aread_tpu_torch.serve.server import make_server
    from aread_tpu_torch.train.checkpoint import save_checkpoint

    data = make_synthetic_data(n_rows=64, n_domain=2, vocab=20)
    cfg = Config(model="deepfm", embed_dim=8, dataset_name="none")
    model = build_model(cfg, data.spec, 2, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, model.state_dict(), {}, epoch=1, spec=data.spec,
                    run_config=cfg, n_domain=2)
    for call in (lambda: load_predictor(ckpt),
                 lambda: load_predictor(ckpt, device="cuda"),
                 lambda: make_server(load_predictor(ckpt)),
                 lambda: serve_main(["--ckpt", ckpt, "--http", "0"]),
                 lambda: serve_main(["--ckpt", ckpt, "--input", "a.csv",
                                     "--output", "b.csv"]),
                 lambda: train_main(["--model", "deepfm", "--data_path",
                                     str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pred = load_predictor(ckpt, device="cpu")
    assert pred.device.type == "cpu"
    srv = make_server(pred, port=0)
    srv.server_close()
    # and as a process: a non-zero exit code, nothing trained or saved
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for args in (["-m", "aread_tpu_torch", "--save_path", str(tmp_path / "s")],
                 ["-m", "aread_tpu_torch.serve", "--ckpt", ckpt, "--http", "0"]):
        proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert not (tmp_path / "s").exists()


ZOO = ["deepfm", "dcn", "mmoe", "aread", "dcnv2", "autoint", "ple",
       "pepnet", "epnet", "epnet-single", "star", "hinet", "adasparse", "adl",
       "mamdr"]
# every model name the JAX package's build_model takes
MODEL_NAMES = ZOO + ["aread_womask"]


def _jax_build_model_names():
    """The names aread_tpu/models/__init__.py's build_model compares
    ``name`` with (read from the source: this file imports no JAX)."""
    tree = ast.parse((ROOT / "aread_tpu" / "models" / "__init__.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Compare)
                and getattr(node.left, "id", "") == "name"):
            for c in ast.walk(node.comparators[0]):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    names.add(c.value)
    return names


@pytest.mark.parametrize("model", ZOO)
def test_build_model_raises_without_a_card(model):
    _no_card()
    spec = make_synthetic_data(n_rows=64, n_domain=2, vocab=20).spec
    cfg = Config(model=model, embed_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, spec, 2)
    assert build_model(cfg, spec, 2, device="cpu").device.type == "cpu"


def test_table_is_padded_only_for_the_sparse_path():
    spec = make_synthetic_data(n_rows=64, n_domain=2, vocab=20).spec
    assert spec.n_rows % 16 != 0
    for sparse, rows in ((True, -(-spec.n_rows // 16) * 16),
                         (False, spec.n_rows)):
        cfg = Config(model="deepfm", embed_dim=8, sparse_table_grad=sparse,
                     table_dtype="float32")
        table = build_model(cfg, spec, 2, device="cpu").embedding.table
        assert tuple(table.shape) == (rows, 8) and table.dtype == torch.float32


def test_cuda_wrapper_refuses_cpu_tensors():
    w = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_adam_cuda(w, w.clone(), w.clone(),
                         torch.zeros(4, dtype=torch.int32),
                         torch.zeros((4, 8)), 1, lr=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.fused_adam_cuda(w, w.clone(), w.clone(), w.clone(), 1,
                                   lr=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_adam.dedup_rows_cuda(torch.zeros(4, dtype=torch.int32),
                                    torch.zeros((4, 8)), 16)


KERNELS = ["sparse_adam", "fused_adam", "gather_rows", "adam_attrib",
           "dedup_rows"]
# the kernels built on rounding.cuh's Adam element and stores
ADAM_KERNELS = ["sparse_adam", "fused_adam", "adam_attrib"]


def test_build_flags_keep_ieee_arithmetic():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert build.BUILD_DIR == ROOT / "aread_tpu_torch" / "_build"
    for name in KERNELS:
        assert all(src.exists() for src in build.sources(name))
        cu, op = (p.read_text() for p in build.sources(name))
        assert "torch/" not in cu  # PyTorch's headers stay in the binding
        assert f"{name}_(" in op and \
            "TORCH_LIBRARY_FRAGMENT(aread_tpu_torch" in op


@pytest.mark.parametrize("name", ADAM_KERNELS)
def test_kernel_sources_share_the_rounding_header(name):
    cu, op = (p.read_text() for p in build.sources(name))
    assert '#include "rounding.cuh"' in cu
    assert "hash_bits" not in cu  # the hash lives in the header only
    assert "torch/" not in cu  # PyTorch's headers stay in the binding
    assert f"{name}_(" in op and "TORCH_LIBRARY_FRAGMENT(aread_tpu_torch" in op
    assert build.SRC_DIR / "rounding.cuh" in build.headers()


@pytest.mark.parametrize("changed", ["rounding.cuh", "fused_adam.cu",
                                     "fused_adam_op.cpp"])
def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch,
                                                  changed):
    """A changed source or shared header gives the library a new name, so
    it is rebuilt; an unchanged tree keeps the name."""
    for p in build.SRC_DIR.iterdir():
        if p.suffix in (".cu", ".cpp", ".cuh"):
            shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    before = build.library_path("fused_adam")
    assert before == build.library_path("fused_adam")
    assert before.parent == build.BUILD_DIR
    with open(tmp_path / changed, "a") as f:
        f.write("\n// changed\n")
    assert build.library_path("fused_adam") != before
    # the other kernel's library is renamed by the header alone
    monkeypatch.setattr(build, "SRC_DIR", ROOT / "aread_tpu_torch/ops/cuda")
    other = build.library_path("sparse_adam")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    assert (build.library_path("sparse_adam") != other) == (
        changed == "rounding.cuh")


def test_launch_counts_are_shared_by_both_kernels():
    from aread_tpu_torch.ops import adam_attrib, gather_rows

    assert set(cuda_ops.launch_counts) == set(KERNELS)
    for module in (sparse_adam, fused_adam, gather_rows, adam_attrib):
        assert module.launch_counts is cuda_ops.launch_counts
    cuda_ops.launch_counts["fused_adam"] += 2
    cuda_ops.launch_counts["adam_attrib"] += 1
    cuda_ops.reset_launch_counts()
    assert cuda_ops.launch_counts == dict.fromkeys(KERNELS, 0)
    # the plain versions on the CPU count nothing
    w = torch.zeros((4, 2))
    fused_adam.fused_adam_dispatch(w, w.clone(), w.clone(), w.clone(), 1,
                                   lr=1e-3)
    assert cuda_ops.launch_counts["fused_adam"] == 0


def test_slot_map_key_is_one_function(monkeypatch):
    """A table on plain "cuda" and the same table on "cuda:<current>" share
    one slot map, and the key that stores a map is the key that drops it
    after a failed launch."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    key = sparse_adam._slot_key
    assert key(torch.device("cuda"), 100) == key(torch.device("cuda:1"), 100)
    assert key(torch.device("cuda"), 100) == (1, 100)
    assert key(torch.device("cuda:0"), 100) == (0, 100)
    assert key(torch.device("cuda"), 100) != key(torch.device("cuda"), 101)
    src = Path(sparse_adam.__file__).read_text()
    assert src.count("_slot_key(") == 3  # its definition, the get, the pop
    assert "_SLOTS.pop(_slot_key(dev, n_rows), None)" in src


def test_chip_smoke_drives_both_kernels_and_trainers():
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in ("KERNEL_SOURCES",
                                                      "REPLACES")}
    assert consts["KERNEL_SOURCES"] == KERNELS
    assert consts["REPLACES"] == {
        "sparse_adam": "aread_tpu/ops/pallas/sparse_adam_kernel.py:252",
        "fused_adam": "aread_tpu/ops/pallas/fused_adam.py:63",
        "gather_rows": "benchmarks/prof_dma_issue.py:69",
        "adam_attrib": "benchmarks/prof_kernel_attrib.py:139"}
    funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"phase_device", "phase_build", "phase_kernels", "phase_reference",
            "phase_train", "phase_eval", "phase_train_dense",
            "check_sparse_adam", "check_fused_adam", "reference_aread",
            "reference_dense"} <= funcs
    assert "from aread_tpu_torch.ops.cuda import launch_counts" in src
    for name in ("Trainer", "AREADTrainer", "fused_adam_cuda",
                 "sparse_adam_cuda", "fused_adam_reference"):
        assert name in src
    # every kernel row carries both clocks, the scalar kernel's time and the
    # CUDA launches of one update beside the contract's fields
    assert {"scalar_kernels", "time_forms", "device_time_ms",
            "cuda_launches_per_call"} <= funcs
    row_times = next(ast.literal_eval(n.value) for n in tree.body
                     if isinstance(n, ast.Assign)
                     and isinstance(n.targets[0], ast.Name)
                     and n.targets[0].id == "ROW_TIMES")
    assert {"ms", "call_ms", "scalar_ms", "plain_ms", "bound_ms",
            "cuda_launches_per_update"} <= set(row_times)
    for key in ('"library_ms"', '"bound_by"', '"max_abs_err"', '"launches"',
                '"replaces"', '"route"', '"source"'):
        assert src.count(key) >= 1
    assert src.count("**{k: main[k] for k in ROW_TIMES}") == 2


def test_chip_smoke_runs_the_hemp_phase_and_keeps_its_last_line():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    dicts = {t.id: [k.value for k in n.value.keys] for n in tree.body
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
             for t in n.targets if isinstance(t, ast.Name)}
    # the default list is PHASES' keys; every earlier phase is still there
    assert dicts["PHASES"] == ["device", "build", "kernels", "reference",
                               "train", "eval", "train_dense", "zoo", "zoo2",
                               "hemp", "serve", "options", "mesh", "data",
                               "probes", "spans"]
    assert dicts["OPT_IN"] == ["profile", "profile_dense", "profile_hemp"]
    assert {"train_batches", "regroup_interval", "candidate_mask_num",
            "final_epoch"} <= set(dicts["HEMP_DEPTH"])
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"phase_hemp", "phase_profile_hemp", "reference_evolution",
            "phase_serve"} <= set(funcs)
    serve_src = "".join(ast.unparse(f) for n, f in funcs.items()
                        if n.startswith(("phase_serve", "serve_")))
    for name in ("save_checkpoint", "load_predictor", "make_server",
                 "/healthz", "/predict", "streaming_eval=", "ckpt_dir=",
                 "aread_tpu_torch.serve", "device='cpu'", "predict_per_domain",
                 "cuda_launches_per_call", "status != 200", "status != 400"):
        assert name in serve_src, name
    hemp_src = ast.unparse(funcs["phase_hemp"])
    for name in ("build_model", "AREADTrainer", ".fit(", "aread_final=True",
                 "sparse_adam_launches_schedule", "prune_mask_tensor"):
        assert name in hemp_src, name
    # the last thing main prints is the fixed line, with these keys only
    prints = sorted((n for n in ast.walk(funcs["main"])
                     if isinstance(n, ast.Call)
                     and getattr(n.func, "id", "") == "print"),
                    key=lambda n: n.lineno)
    last = prints[-1].args[0].args[0]  # print(json.dumps({...}))
    assert isinstance(last, ast.Dict)
    assert [k.value for k in last.keys] == ["ok", "device"]
    assert last.values[0].value is True
    assert [k.value for k in last.values[1].keys] == ["platform", "kind",
                                                      "count"]
    assert last.values[1].values[0].value == "gpu"


def test_chip_smoke_holds_the_chains_graph_against_eager():
    """The hemp phase runs a regroup at the default depth by graph and by
    an eager twin through ``_mask_evolution`` and requires every
    candidate bitwise, times the chains of each dispatch, holds their
    counted launches to the profiler's kernel records and runs a chain
    under sync debug mode 'error'; the reference phase requires the card's
    chains to be graphs; the options phase holds both engines' chains by
    graph and by eager bitwise, with their launches held to the schedule,
    on the Amazon table and on BIG_DIMS'."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    assert "hemp_chain_twins(ctx, data)" in funcs["phase_hemp"]
    twins = funcs["hemp_chain_twins"]
    for name in ("chain_twin_trainers(", "spy_evolutions(", "_mask_evolution(",
                 "N_DOMAIN * 9", "(5, 5, 10, False)", "stage_device_data(",
                 "bits_differ(", "chain_replays(", "sync_debug_chain(",
                 "hemp_profile_args"):
        assert name in twins, name
    assert "EagerChunks" in funcs["chain_twin_trainers"]
    assert "set_sync_debug_mode('error')" in funcs["sync_debug_chain"]
    for name in ("chunk_profile(", "KERNEL_RECORDS", "event_ms(",
                 "run_chains("):
        assert name in funcs["chain_replays"], name
    for name in ("run_chains(", "tobytes()", "bits_differ(", "counted(",
                 "launches != want"):
        assert name in funcs["chain_twins"], name
    assert "'dispatch'" in funcs["reference_evolution"]
    times = funcs["chain_times"]
    for name in ("chain_twins(", "chain_replays(", "overlay_launches(",
                 "('graph', 'eager'), ('eager', 'graph')", "drift_table_l2"):
        assert name in times, name
    for dims in ("AMAZON_DIMS", "BIG_DIMS"):
        assert f"chain_times(ctx" in funcs["options_overlay_large"]
        assert dims in funcs["options_overlay_large"], dims


def test_chip_smoke_holds_evaluation_and_serving_graph_against_eager():
    """The eval, serve, options and zoo2 phases run evaluation, requests,
    the loss matrix and ADL's evaluated centres by CUDA graph and by the
    eager twin (the dispatch rule answering False), in turns, and require
    them bitwise; the eval phase covers both AREAD modes, exact and
    streaming, over at least 100 batches of BS rows and DeepFM at 8 * BS;
    requests make 2 copies by graph for every model; a captured batch and
    a captured request run under sync debug mode 'error'; the zoo fits'
    twins evaluate eagerly too."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in ("EVAL_BATCHES", "BS",
                                                      "SERVE_BUCKETS")}
    assert consts["EVAL_BATCHES"] >= 100
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    for name in ("step_graph.eval_dispatch = ", "o._evals = None",
                 "o._evals = runner"):
        assert name in funcs["eager_evals"], name
    assert "step_graph.eval_dispatch = " in funcs["fit_twins"]
    for name in ("eager_evals(tr)", "('graph', 'eager')", "bits_differ(",
                 "fit_results_equal(", "chunk_profile(", "spied_pass(",
                 "batch_ms_events", "batch_ms_host_clock", "pass_s"):
        assert name in funcs["eval_twins"], name
    for name in ("device_busy_ms", "device_idle_share_unprofiled",
                 "cudaLaunchKernel", "kernels_run", "run_eval_batch_ms_events"):
        assert name in funcs["eval_twins"], name
    phase = funcs["phase_eval"]
    for name in ("eval_twins('eval/aread'", "eval_twins('eval/deepfm'",
                 "for f in (False, True) for s in (False, True)",
                 "EVAL_BATCHES * 8 * BS", "model='deepfm'",
                 "sync_debug_eval(", "tr.evals is not tr.chunks"):
        assert name in phase, name
    # the AREAD split, drawn by the train phase for its graph trainer
    assert "amazon_rows(rng, spec, EVAL_BATCHES * BS)" in funcs["phase_train"]
    assert "set_sync_debug_mode('error')" in funcs["sync_debug_eval"]
    times = funcs["serve_times"]
    for name in ("serve_request_twins(", "{'graph': 2, 'eager': 2}",
                 "{'graph': 2, 'eager': 3}", "for n in SERVE_BUCKETS",
                 "('deepfm', 'mmoe')", "sync_debug_request("):
        assert name in times, name
    for name in ("eager_evals(pred)", "view(np.uint32)", "'bitwise'"):
        assert name in funcs["serve_request_twins"], name
    for name in ("assert_copies(", "chunk_profile(", "cudaGraphLaunch",
                 "event_ms("):
        assert name in funcs["serve_request_numbers"], name
    assert "set_sync_debug_mode('error')" in funcs["sync_debug_request"]
    assert "loss_matrix_twins(tr, data)" in funcs["options_regroup"]
    for name in ("eager_evals(tr)", "equal_nan=True",
                 "('graph', 'eager', 'eager', 'graph')"):
        assert name in funcs["loss_matrix_twins"], name
    for name in ("eager_evals(tr)", "update_graph_bitwise_eager",
                 "centres.copy_(before)", "bits_differ("):
        assert name in funcs["zoo2_adl_centres"], name


def test_chip_smoke_holds_lazy_adam_and_mamdr_graphs_against_eager():
    """The train phase's lazy part runs, under table_optimizer='lazy_adam',
    AREAD's steps, a regroup's chains at the default depth and a DeepFM
    Trainer.fit, each by CUDA graph and by its eager twin in turns and
    required bitwise, with no kernel of ours launched, a step and a chain
    under sync debug mode 'error', and lazy_sparse_adam_ alone by its
    call and by a replay, bitwise; the zoo2 phase fits MAMDR by graph and
    by an eager twin, requires the meta weights, every domain's weights
    and the history bitwise, one step capture and the Reptile schedule's
    launches, and its card-vs-CPU epoch runs on graphs."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in (
                  "LAZY_CHUNKS", "LAZY_CHAINS", "LAZY_DENSE_CHUNKS",
                  "MAMDR_CHUNKS")}
    assert [k for k, _ in consts["LAZY_CHUNKS"]].count("main") >= 3
    assert consts["LAZY_CHAINS"] >= 3
    assert len(consts["LAZY_DENSE_CHUNKS"]) >= 3
    assert len(consts["MAMDR_CHUNKS"]) >= 3
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    assert "train_lazy(ctx)" in funcs["phase_train"]
    lazy = funcs["train_lazy"]
    for name in ("table_optimizer='lazy_adam'", "chain_twin_trainers(make)",
                 "twin_chunks(ctx, 'train/lazy'", "chain_twins(",
                 "('graph', 'eager'), ('eager', 'graph')", "chain_replays(",
                 "fit_twins(", "model='deepfm'",
                 "twin_chunks(ctx, 'train/lazy_deepfm_steps'",
                 "sync_debug_step(", "sync_debug_chain(", "lazy_call(dma)",
                 "no_launches(ctx, 'train/lazy_fit', 'train/lazy_fit_eager')"):
        assert name in lazy, name
    for name in ("torch.cuda.graph(", "bits_differ(", "scalars=block",
                 "chunk_profile(", "event_ms("):
        assert name in funcs["lazy_call"], name
    mamdr = funcs["zoo2_mamdr"]
    for name in ("fit_twins(", "bits_differ(", "['meta_weights']",
                 "['domain_weights']", "captures != 1", "twin_chunks(",
                 "MAMDR_CHUNKS", "zoo2/mamdr_fit_eager"):
        assert name in mamdr, name
    assert "['dispatch'] != 'graph'" in funcs["zoo2_mamdr_reference"]
    for name in ("step_graph.graph_dispatch = ", "fit_results_equal(",
                 "bits_differ(trainer_bits"):
        assert name in funcs["fit_twins"], name


def test_chip_smoke_chain_inputs_have_the_regroup_shape():
    """``chain_inputs`` on the CPU, at a toy size: ``n`` candidates in
    domain order, each a valid mask and S adapt / P probe feeds as the
    trainer feeds a chain (host batches here, row ids with the split
    resident)."""
    import importlib.util

    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data.loader import DomainBatcher, make_synthetic_data
    from aread_tpu_torch.models.aread import AREAD
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.utils.masks import has_output

    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    data = make_synthetic_data(n_rows=300, n_domain=3, vocab=50, seed=1)
    cfg = Config(model="aread", bs=16, embed_dim=8, regroup_update_step=3,
                 regroup_eval_step=2)
    tr = AREADTrainer(AREAD(data.spec, embed_dim=8, n_tower=(2, 3),
                            n_domain=3, expert_dims=(8,),
                            tower_dims=((4,), (4,)), device="cpu"), cfg, 3)
    batcher = DomainBatcher(data.train_x, data.train_y, 16,
                            data.spec.domain_idx, 3, seed=0)
    masks, fa, probe = cs.chain_inputs(tr, batcher, 5)
    assert len(masks) == len(fa) == len(probe) == 5
    assert all(len(f) == 3 for f in fa) and all(len(p) == 2 for p in probe)
    assert all(has_output(m) for m in masks)
    for c, cand in enumerate(fa):
        for b in cand:
            assert b["x"].shape[0] == 16
            live = b["x"][b["valid"] > 0]
            assert (live[:, data.spec.domain_idx] == c % 3).all()
    tr._device_data = (None, None, 0)
    _, ids, _ = cs.chain_inputs(tr, batcher, 2)
    assert ids[0][0].dtype == np.int32 and ids[0][0].shape == (16,)


def test_chip_smoke_runs_the_options_phase():
    """The options phase drives each option through the entry points and
    holds the overlay's kernel launches to the schedule's."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    src = "".join(v for k, v in funcs.items() if k.startswith(
        ("phase_options", "options_", "overlay_launches", "chain_")))
    for name in ("_mask_evolution", "hemp_fast_adapt=engine",
                 "overlay_launches(", "'sparse_adam': 0", "BIG_DIMS",
                 "OVERLAY_AUTO_MIN_ELEMS", ".fit(", "dynamic_regroup=mode",
                 "tower_domain_losses", "matmul_precision_ctx",
                 "compute_dtype='bfloat16'", "load_predictor",
                 "epoch_timeout_s=", "HealthError", "log_dir=",
                 "AREAD_TPU_TRACE", "hemp_mask_evolution", "counted("):
        assert name in src, name


def test_chip_smoke_runs_the_mesh_phase():
    """The mesh phase drives both trainers and the CLI on a mesh (NCCL at
    world 1, then gloo ranks of the script itself on the one card), holds
    each rank's kernel launches to the schedule's and adds them to the
    kernels' counts, labels its times as gloo on one card, and the kernels
    phase holds kernel 1 on a row shard with its own seed."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    src = "".join(v for k, v in funcs.items() if k.startswith("mesh"))
    phase = funcs["phase_mesh"]
    for name in ("'nccl'", "all_reduce", "make_mesh(1, 1)", "mesh_check_b",
                 "mesh_check_c", "mesh_check_d"):
        assert name in phase, name
    for name in ("make_mesh(1, 2)", "make_mesh(2, 2)", "'--mesh-rank'",
                 "torch.distributed.run", "'--mesh_model', '2'",
                 "sharded_sparse_adam_deduped", "flat_a2a_lookup",
                 "resolve_a2a_capacity", "_mask_evolution", ".fit(",
                 "load_predictor", "launches_by_path", "MESH_LABEL",
                 "rank_counted(", "sparse_adam_launches_of_fit",
                 "'fused_adam': 6", "'sparse_adam': 24", "sr_seed=t * 2"):
        assert name in src, name
    assert "gloo, {n} ranks on one H100" in (ROOT / "chip_smoke.py").read_text()
    shard = funcs["sparse_shard_case"]
    assert "sr_seed=seed" in shard and "shard_run" in shard
    assert "sparse_shard_case(" in funcs["check_sparse_adam"]
    main = funcs["main"]
    assert "mesh_rank_main" in main
    assert main.index("mesh_rank") < main.index("is_available() is False")


def test_chip_smoke_runs_the_zoo_phase():
    """The zoo phase fits every model of the slice through the Trainer,
    checks each against the CPU, and takes AREAD on a PLE base through
    its steps, its fit and load_predictor."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in ("ZOO_MODELS",
                                                      "ZOO2_MODELS",
                                                      "ZOO_PRE_BN_BIAS")}
    assert consts["ZOO_MODELS"] == ("dcnv2", "autoint", "ple", "pepnet",
                                    "epnet", "epnet-single", "star")
    assert set(consts["ZOO_PRE_BN_BIAS"]) == (set(consts["ZOO_MODELS"])
                                              | set(consts["ZOO2_MODELS"]))
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    for name in ("Trainer(build_model(", ".fit(data, epochs=1",
                 "MULTI_TOWER_MODELS", "fused_adam"):
        assert name in funcs["zoo_fit"], name
    assert "true_zero_adam" in funcs["zoo_reference_trainer"]
    assert "zoo_reference_trainer(" in funcs["zoo_reference"]
    ple = funcs["zoo_aread_ple"]
    for name in ("base_model='ple'", "main_step", "reference_aread(",
                 "sparse_adam_launches_of_fit", "serve_checkpoints(",
                 "validate_mask"):
        assert name in ple, name


def _say_keys(func: ast.FunctionDef, **match):
    """The keyword names of each ``say(...)`` call in ``func`` whose
    constant keywords equal ``match``."""
    out = []
    for n in ast.walk(func):
        if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "say":
            kw = {k.arg: k.value for k in n.keywords}
            if all(isinstance(kw.get(k), ast.Constant) and kw[k].value == v
                   for k, v in match.items()):
                out.append({k.arg for k in n.keywords})
    return out


def test_chip_smoke_holds_the_generic_trainer_graph_against_eager():
    """The train_dense phase runs DeepFM's graph and eager twins for both
    table gradients and both feeds in chunks (a full chunk captures, one
    is timed, a remainder is profiled), and the zoo phases fit each
    model by both dispatches over a full chunk and a remainder, and a
    dynamic_regroup fit: the shape of their lines."""
    from aread_tpu_torch.train.step_graph import SCAN_CHUNK

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            t = n.targets[0]
            names = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                     else [getattr(t, "id", None)])
            if set(names) & {"DENSE_CHUNKS", "DENSE_TIMED", "ZOO_STEPS",
                             "ZOO_CHUNKS"}:
                value = ast.literal_eval(n.value)
                consts.update(zip(names, value) if len(names) > 1
                              else [(names[0], value)])
    chunks = consts["DENSE_CHUNKS"]
    assert chunks[:2] == (SCAN_CHUNK,) * 2 and 0 < chunks[2] < SCAN_CHUNK
    assert (consts["DENSE_TIMED"], consts["DENSE_PROFILED"]) == (1, 2)
    assert consts["ZOO_STEPS"] // SCAN_CHUNK >= 1
    assert consts["ZOO_STEPS"] % SCAN_CHUNK > 0  # a remainder
    assert len(consts["ZOO_CHUNKS"]) == 3
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    src = {k: ast.unparse(v) for k, v in funcs.items()}
    assert "dense_twins(ctx, make, spec, d2g, sparse, resident)" in src[
        "phase_train_dense"]
    assert "dense_twins(ctx, make, spec, d2g, False, False, 'bfloat16')" in \
        src["phase_train_dense"]
    for name in ("twin_chunks(", "sync_debug_step(", "stage_device_data(",
                 "epoch_perm()", "EagerChunks", "2 * n_steps",
                 "compute_dtype"):
        assert name in src["dense_twins"], name
    (keys,) = _say_keys(funcs["dense_twins"], part="graph_vs_eager")
    assert {"table_grad", "feed", "per_step", "bitwise_after_chunks",
            "launches", "captures", "graph_launches_per_replay",
            "sync_debug_error_step", "chunk_event_ms"} <= keys
    for name in ("fit_twins(", "twin_chunks(", ".fit(data, epochs=1"):
        assert name in src["zoo_fit"], name
    (keys,) = _say_keys(funcs["zoo_fit"])
    assert {"model", "step_ms", "per_step", "fit_graph_bitwise_eager",
            "bitwise_after_chunks", "fit_launches", "step_launches",
            "captures"} <= keys
    for name in ("step_graph.graph_dispatch = ", "trainer_bits(",
                 "fit_results_equal("):
        assert name in src["fit_twins"], name
    assert "zoo_regroup_twins(ctx)" in src["phase_zoo"]
    (keys,) = _say_keys(funcs["zoo_regroup_twins"], part="dynamic_regroup")
    assert {"map_moved", "captures", "fit_graph_bitwise_eager"} <= keys
    assert "dynamic_regroup='towerfirst'" in src["zoo_regroup_twins"]
    # kernel 2 fed a row of a chunk's staged blocks, in every mode
    assert "scalars=blocks[2]" in src["check_fused_adam"]
    assert "by_t" in src["fused_case"]
    # the per-step numbers of both dispatches
    for name in ("step_ms_events", "device_idle_share_unprofiled",
                 "peak_mem_gb", "KERNEL_RECORDS"):
        assert name in src["twin_chunks"], name


def test_chip_smoke_runs_the_zoo2_phase():
    """The zoo2 phase fits HiNet, AdaSparse and ADL through the Trainer
    and MAMDR through its meta-trainer at Amazon width, holds MAMDR's
    sparse_adam launches to the Reptile schedule, checks ADL's centres and
    each model card vs CPU, serves the four from their checkpoints and
    checks each new FM op card vs CPU."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id == "ZOO2_MODELS"}
    assert consts["ZOO2_MODELS"] == ("hinet", "adasparse", "adl")
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    zoo2 = funcs["phase_zoo2"]
    for name in ("zoo_fit(ctx, ZOO2_MODELS", "zoo_reference(ctx, ZOO2_MODELS",
                 "zoo2_adl_centres", "zoo2_mamdr(", "zoo2_mamdr_reference",
                 "serve_checkpoints(", "zoo2_fm_ops"):
        assert name in zoo2, name
    mamdr = funcs["zoo2_mamdr"]
    for name in ("MamdrTrainer(build_model(", ".fit(data, epochs=1",
                 "mamdr_sparse_adam_launches", "'sparse_adam': want",
                 "'fused_adam': 0", "reptile_update", "event_ms"):
        assert name in mamdr, name
    for name in ("eval_dlm_update = True", "torch.equal(centres, before)"):
        assert name in funcs["zoo2_adl_centres"], name
    for name in ("InnerProductNetwork", "OuterProductNetwork",
                 "AttentionalFactorizationMachine",
                 "CompressedInteractionNetwork", "AnovaKernel"):
        assert name in funcs["zoo2_fm_ops"], name


def test_chip_smoke_runs_the_data_phase():
    """The data phase builds the native parser, drives the CLI from raw
    dumps of AliCCP (AREAD, kernel 1) and Amazon (AREAD with the overlay
    engine, kernels 1 and 2) with their launches held to the schedule,
    requires the native parser, runs the CLI again as a process on the
    skip path, builds Cloud-Theme, and parses a canonical Amazon CSV at the
    real 25 domain sizes (written by numpy-only processes), held bitwise
    against pandas, before AREAD steps on the parsed rows."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in (
                  "AMAZON_DOMAIN_SIZES", "DATA_PANDAS_ROWS", "DATA_STEPS")}
    from aread_tpu_torch.data.preprocess import AMAZON_DOMAIN2ENCODER

    assert len(consts["AMAZON_DOMAIN_SIZES"]) == len(AMAZON_DOMAIN2ENCODER)
    assert sum(consts["AMAZON_DOMAIN_SIZES"]) == 17_664_862
    assert consts["DATA_PANDAS_ROWS"] == 1_000_000
    assert consts["DATA_STEPS"] == 24
    funcs = {n.name: ast.unparse(n) for n in tree.body
             if isinstance(n, ast.FunctionDef)}
    phase = funcs["phase_data"]
    for name in ("native.build()", "data_big_file(tmp)", "data_cli(ctx",
                 "data_parse(ctx", "AREAD_TPU_CACHE", "os.killpg("):
        assert name in phase, name
    cli = funcs["data_cli"] + funcs["data_cli_run"]
    for name in ("aliccp_raw_dumps(", "amazon_raw_dumps(",
                 "cloudtheme_raw_dump(", "'--hemp_fast_adapt', 'overlay'",
                 "sparse_adam_launches_of_fit(", "overlay_launches(",
                 "chains_of_fit(", "counted(ctx, path", "cli_main(argv)",
                 "'native'", "'cache'", "st_mtime_ns", "'aread_tpu_torch'",
                 "run_preprocessing('cloudtheme'"):
        assert name in cli, name
    parse = funcs["data_big_file"] + funcs["data_parse"]
    for name in ("write_canonical_amazon(", "PARSE_CHILD", "bitwise_equal",
                 "load_split_data(", "parser_of(path)", "build_trainer(",
                 "main_step", "counted(ctx, 'data/steps'",
                 "'sparse_adam': DATA_STEPS"):
        assert name in parse, name
    child = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "PARSE_CHILD")
    for name in ("native.load_csv(", "read_with_pandas(", "ru_maxrss",
                 "default_threads()"):
        assert name in child, name
    assert "import torch" not in next(
        ast.literal_eval(n.value) for n in tree.body
        if isinstance(n, ast.Assign)
        and getattr(n.targets[0], "id", "") == "WRITE_CHILD")


def _toy_aread():
    data = make_synthetic_data(n_rows=256, n_domain=3, vocab=40)
    cfg = Config(model="aread", embed_dim=8, mlp_dims=(8,),
                 aread_tower_dims=((4,), (4,)), table_dtype="float32",
                 table_moments_dtype="float32")
    return data, cfg, build_model(cfg, data.spec, 3, n_tower=2, device="cpu")


@pytest.mark.parametrize("name,value", [("hemp_fast_adapt", "overlay"),
                                        ("compute_dtype", "bfloat16"),
                                        ("log_dir", "logs"),
                                        ("epoch_timeout_s", 5.0),
                                        ("embed_lookup", "a2a")])
def test_unported_hemp_options_raise_by_name(name, value, tmp_path):
    """The five options, refused until they were ported, each run one
    epoch of AREADTrainer.fit at toy size and show their effect;
    embed_lookup='a2a' (a mesh's gather) on a 1 x 1 mesh, which one
    process takes without a process group, and by name without a mesh."""
    from aread_tpu_torch.parallel.mesh import make_mesh

    data, cfg, model = _toy_aread()
    mesh = None
    if name == "embed_lookup":
        with pytest.raises(ValueError, match="a2a.*mesh"):
            AREADTrainer(model, dataclasses.replace(cfg, **{name: value}), 3)
        mesh = make_mesh(1, 1, device="cpu")
    if name == "log_dir":
        value = str(tmp_path / value)
    if name == "epoch_timeout_s":
        value = 600.0  # generous: met on a loaded machine too
    cfg = dataclasses.replace(cfg, bs=64, warm_up_interval=1,
                              regroup_interval=1000, regroup_update_step=2,
                              regroup_eval_step=1, candidate_mask_num=2,
                              **{name: value})
    tr = AREADTrainer(model, cfg, 3, mesh=mesh)
    res = tr.fit(data, epochs=1, verbose=False)
    assert len(res["history"]) == 1 and np.isfinite(res["test"]["total_auc"])
    if name == "hemp_fast_adapt":
        # the chains ran on the compact copy: no table-sized fast moments
        assert tr.regroup_log[0]["overlay"] and "m" not in tr._fast_state
    elif name == "compute_dtype":
        # one warm-up step from the same weights moves the loss, a little
        batch = pad_batch(data.train_x[:64], data.train_y[:64], 64)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        losses = []
        for dtype in ("bfloat16", "float32"):
            tr.config = dataclasses.replace(cfg, compute_dtype=dtype)
            model.load_state_dict(sd)
            tr.init()
            losses.append(float(tr.warmup_step(batch)[0]))
        assert 0 < abs(losses[0] - losses[1]) < 1e-2
    elif name == "embed_lookup":
        # the lookup ran through the exchange, at a measured capacity
        assert tr.config.a2a_capacity > 0 and model.embedding.mesh is mesh
    elif name == "log_dir":
        (run,) = list((tmp_path / value).iterdir())
        lines = (run / "metrics.jsonl").read_text().splitlines()
        assert [sorted(json.loads(l))[2:] for l in lines] == [
            ["valid"], ["domain_mask_active", "test"]]
        assert json.loads((run / "config.json").read_text())["log_dir"] == value
    else:
        assert tr.config.epoch_timeout_s == value  # a generous deadline


def test_unported_fit_arguments_and_ple_raise_by_name(tmp_path):
    data, cfg, model = _toy_aread()
    # ported since: streaming_eval, warm_start and ckpt_dir run
    cfg = dataclasses.replace(cfg, bs=64, warm_up_interval=0,
                              regroup_interval=1000, regroup_update_step=1,
                              regroup_eval_step=1, candidate_mask_num=1,
                              streaming_eval=True)
    tr = AREADTrainer(model, cfg, 3)
    warm = {"state_dict": {k: v.clone()
                           for k, v in model.state_dict().items()}}
    res = tr.fit(data, epochs=1, verbose=False, warm_start=warm,
                 ckpt_dir=str(tmp_path / "ckpt"))
    assert len(res["history"]) == 1
    assert (tmp_path / "ckpt" / "meta.json").exists()
    # a mesh is ported: one process takes a 1 x 1 mesh and refuses a
    # larger one by name; the overlay engine is one device's
    from aread_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="data=1 x model=2 needs 2"):
        AREADTrainer(model, cfg, 3, mesh=make_mesh(1, 2, device="cpu"))
    with pytest.raises(ValueError, match="overlay.*single-device"):
        AREADTrainer(model, dataclasses.replace(cfg, hemp_fast_adapt="overlay"),
                     3, mesh=make_mesh(1, 1, device="cpu"))
    # the PLE base builds; an unknown base is refused as in the JAX package
    ple = build_model(dataclasses.replace(cfg, base_model="ple"), data.spec,
                      3, device="cpu")
    assert hasattr(ple, "cgc_1") and not hasattr(ple, "mmoe_experts")
    with pytest.raises(ValueError, match="base_model"):
        build_model(dataclasses.replace(cfg, base_model="moe"), data.spec, 3,
                    device="cpu")
    with pytest.raises(ValueError, match="hemp_fast_adapt"):
        AREADTrainer(model, dataclasses.replace(cfg, hemp_fast_adapt="x"), 3)
    # 'full', and 'auto' on a table below the crossover, are the full sweep
    for mode in ("full", "auto"):
        assert not AREADTrainer(model, dataclasses.replace(
            cfg, hemp_fast_adapt=mode), 3).overlay_enabled()


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_every_model_name_builds_and_runs(model):
    """Every model name of the JAX package's build_model builds on the CPU
    at toy width and gives a finite eval forward of the shape the trainers
    expect; an unknown name raises ValueError as there."""
    assert set(MODEL_NAMES) == _jax_build_model_names()
    data = make_synthetic_data(n_rows=64, n_domain=3, vocab=20)
    cfg = Config(model=model, embed_dim=8, dataset_name="none",
                 mlp_dims=(8,), tower_dims=(8, 4), sei_dims=(4,),
                 mmoe_expert_dims=(8,), mmoe_tower_dims=(4,),
                 ple_expert_dims=((8,), (4,)), ple_tower_dims=(4,),
                 aread_tower_dims=((4,), (4,)), atten_embed_dim=8,
                 att_layer_num=1, n_cross_layers=1)
    m = build_model(cfg, data.spec, 3, device="cpu")
    x = torch.tensor(data.train_x[:16])
    group = x[:, data.spec.domain_idx].long()
    with torch.no_grad():
        logit = m(x, group=group, train=False)["logit"]
    n_out = getattr(m, "n_tower", 1)
    want = ((16, n_out) if model in ("mmoe", "ple", "pepnet", "epnet", "star")
            else (16,))
    assert tuple(logit.shape) == want and torch.isfinite(logit).all()
    with pytest.raises(ValueError, match="Unknown model"):
        build_model(dataclasses.replace(cfg, model="nomodel"), data.spec, 3,
                    device="cpu")


def test_batch_with_mask_refuses_training():
    data, _, model = _toy_aread()
    x = torch.tensor(data.train_x[:4])
    dm = [torch.ones((4,) + s, dtype=torch.bool)
          for s in ((1, 2), (2, 4), (4, 1))]
    with pytest.raises(ValueError, match="batch_with_mask"):
        model(x, domain_mask=dm, mode="batch_with_mask", train=True)
    assert tuple(model(x, domain_mask=dm, mode="batch_with_mask")["prob"].shape) == (4,)


def test_resolved_fast_adapt_engine_is_logged_once(caplog):
    import logging

    _, cfg, model = _toy_aread()
    with caplog.at_level(logging.INFO, logger="aread_tpu_torch.train.hemp"):
        AREADTrainer(model, cfg, 3)
    lines = [r.getMessage() for r in caplog.records
             if "hemp_fast_adapt" in r.getMessage()]
    assert len(lines) == 1 and "full-sweep" in lines[0]


def test_no_mesh_refusal_is_left():
    """No module of the port refuses a mesh, the a2a lookup or the
    barrier as not ported."""
    import re

    for p in PORT_FILES[:-1]:
        for m in re.finditer(r"NotImplementedError\([^)]*", p.read_text()):
            assert not re.search(r"mesh|a2a|barrier", m.group(0), re.I), (
                p, m.group(0))


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


def test_chip_smoke_counts_every_probe_kernel_form():
    """MAIN_KERNELS names each probe kernel's __global__ functions by a
    part of their names and the instantiations ptxas must report: the
    gather's two forms (the ring and the serial form), the attribution's
    two sweeps in six modes each."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "MAIN_KERNELS")
    from aread_tpu_torch.ops import adam_attrib, gather_rows

    assert main["gather_rows"] == ("gather_rows_", len(gather_rows.FORMS))
    assert main["adam_attrib"] == (
        "attrib_sweep", len(adam_attrib.FORMS) * len(adam_attrib.MODES))
    cu = build.sources("gather_rows")[0].read_text()
    assert cu.count("__global__ void") == 2
    assert "gather_rows_sum(" in cu and "gather_rows_ring(" in cu
    cu = build.sources("adam_attrib")[0].read_text()
    sweeps = [n for n in ("attrib_sweep(", "attrib_sweep_tma(") if n in cu]
    assert len(sweeps) == len(adam_attrib.FORMS) == 2
