"""The check that decides ``correct`` has to fail what it exists to catch,
at a size a CPU test holds:

* the control, the reference put in the package's place with TF32
  products (the next precision below the configuration's float32 with
  TF32 off), fails one of each cell's numbers;
* a whole run, the look for a card skipped and the timed path broken
  underneath, comes out ``correct: false`` for each fault the cell can
  have: a training step that returns its state unchanged, a step that
  leaves half of its batch out and takes the mean over the rest, an answer
  altered where the Predictor produces it. (No cell runs on more than one
  chip, so none has an exchange between chips to leave out.)"""

import io
import json

import numpy as np
import pytest
import torch

from perfbench import check, registry, run
from perfbench.tests.conftest import SEED

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    c = run.Cell(cell, tiny_root)
    drv = registry.driver(c.mix["driver"])(c.config, c.mix, SEED, 1.0,
                                           device="cpu")
    drv.setup()
    if drv.kind == "serve":
        drv.window(1.0)
    nums = drv.check((("program", "f32", None), ("control", "tf32", None)))
    assert check.is_correct(check.compared(nums["program"], c.limits))
    assert not check.is_correct(check.compared(nums["control"], c.limits))


def run_cell(root, cell, monkeypatch):
    monkeypatch.setattr(run, "FORBIDDEN", ("aread_tpu",))
    buf = io.StringIO()
    assert run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                     "0.5", "--trace", "0"], device="cpu", stream=buf,
                    root=root) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def frozen_update(*args, **kw):
    """``hybrid_update_sparse`` that counts the step and changes nothing."""
    opt_state = args[7]
    opt_state["t"] += 1
    opt_state["inner"]["count"] += 1
    return (torch.zeros((), device=args[5].device)
            if kw.get("want_table_l2") else None)


def half_batch(orig):
    def gather(dxc, dyc, idx):
        b = orig(dxc, dyc, idx)
        keep = (torch.arange(len(idx), device=idx.device) % 2 == 0).float()
        return dict(b, valid=b["valid"] * keep, y=b["y"] * keep)
    return gather


TRAIN_CELLS = [c for c in CELLS if "serve" not in c]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    from aread_tpu_torch.train import hemp, trainer

    for mod in (hemp, trainer):
        if fault == "unchanged_state":
            monkeypatch.setattr(mod, "hybrid_update_sparse", frozen_update)
        else:
            monkeypatch.setattr(mod, "gather_batch",
                                half_batch(trainer.gather_batch))
    res = run_cell(tiny_root, cell, monkeypatch)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_altered_answer_is_caught(tiny_root, monkeypatch, cell):
    from aread_tpu_torch.serve.predictor import Predictor

    orig = Predictor.predict

    def altered(self, x):
        p = orig(self, x)
        p[len(p) // 2] = np.float32(1.0) - p[len(p) // 2]
        return p

    monkeypatch.setattr(Predictor, "predict", altered)
    res = run_cell(tiny_root, cell, monkeypatch)
    assert res["correct"] is False, res["compared"]
