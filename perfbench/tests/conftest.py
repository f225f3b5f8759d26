"""A checkout of the benchmark at a tiny size, on the CPU: the cells of
``BENCHMARK.json`` with their configurations shrunk (vocabularies, rows,
batch and embedding width), their mixes made short; the traffic, limits
and layer-metric files copied as they are."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY = {"one_hot_dims": [300, 7, 5, 10, 11, 50, 12],
        "domain_size": [400, 300, 200, 100, 50],
        "domain2group": [0, 1, 0, 2, 1],
        "n_train_rows": 4096, "bs": 128, "embed_dim": 8,
        "candidate_mask_num": 3}
SEED = 3_000_000_019  # above 2**31, as the checks' seeds are
# the limits at this size on the CPU (the cells' own, in perfbench/limits/,
# are set from readings on the chip at the cells' size): above the CPU's
# sound readings at this size, below its control's and faults'
TINY_LIMITS = {
    "aread-amazon25.bagging": {"loss_gap": 1e-5, "grad_gap": 1e-3,
                               "change_gap": 5e-3},
    "mmoe-amazon25.train": {"loss_gap": 1e-5, "grad_gap": 1e-3,
                            "change_gap": 5e-3},
    "aread-amazon25.evolve": {"probe_loss_gap": 3e-4,
                              "mask_edges_differ": 0.01},
    "aread-amazon25.serve": {"prob_gap": 3e-6},
    "aread-amazon25.serve-saturated": {"prob_gap": 3e-6},
}


def make_tiny_root(dst: Path) -> Path:
    src = REPO / "perfbench"
    for d in ("traffic", "limits", "layer_metrics"):
        shutil.copytree(src / d, dst / "perfbench" / d, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY)
        out = dst / c["file"]
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(cfg))
    for name in ("serve", "serve-saturated"):
        mix = json.loads((src / "traffic" / f"{name}.json").read_text())
        mix.update(payloads=12, rows_max=300, rate_per_s=40, trace_s=0.25,
                   check_requests=8)
        (dst / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for cell, lim in TINY_LIMITS.items():
        (dst / "perfbench" / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
