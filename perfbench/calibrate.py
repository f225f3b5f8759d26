"""The readings that a cell's limits are set from, on the chip at the
cell's own size, in one process:

    python3 -m perfbench.calibrate --workload <cell> --seeds a,b,... \
        [--faulty 3] [--seconds 3] [--out FILE]

For every seed the package's run (its set-up, for a serving cell a short
window at the cell's own load, its check) gives the numbers that
``correct`` compares; for the first ``--faulty`` seeds the control (the
reference in the package's place with TF32 products, the next precision
below the configuration's float32 with TF32 off) and each fault the cell
can have (a training cell: half of each batch left out, the mean over the
rest; a serving cell: one answer altered where it is produced) give theirs
on the same inputs. A state left unchanged reads 1 on every training
number by construction and needs no run.

Per number it prints the lower reading (the largest over the package's
seeds) and the upper one (the smallest of the control's readings, where
they are three times the lower or more, and of each fault's, where they
are ten times the lower or more), as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import run

VARIANTS = {
    "train": (("program", "f32", None), ("control", "tf32", None),
              ("half_batch", "f32", "half")),
    "evolve": (("program", "f32", None), ("control", "tf32", None),
               ("half_batch", "f32", "half"),
               ("unchanged_state", "f32", "unchanged")),
    "serve": (("program", "f32", None), ("control", "tf32", None),
              ("altered_answer", "f32", "answer")),
}


def bounds(readings):
    """Per number (lower, upper) from the readings of every seed."""
    out = {}
    names = readings[0]["numbers"]["program"]
    for k in names:
        lower = max(r["numbers"]["program"][k] for r in readings)
        ups = []
        for r in readings:
            for label, nums in r["numbers"].items():
                if label == "program":
                    continue
                need = 3 if label == "control" else 10
                if nums[k] >= need * lower:
                    ups.append(nums[k])
        out[k] = {"lower": lower, "upper": min(ups) if ups else None}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faulty", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = run.Cell(args.workload)
    run.cache_env()
    import torch

    from perfbench import registry
    from perfbench.driving import free_cuda

    if not torch.cuda.is_available():
        print("perfbench.calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    run.steady(torch)
    torch.backends.cudnn.allow_tf32 = False
    readings = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        drv = registry.driver(cell.mix["driver"])(cell.config, cell.mix,
                                                  seed, args.seconds)
        drv.setup()
        if drv.kind == "serve":
            drv.window(args.seconds)
        variants = VARIANTS[drv.kind]
        nums = drv.check(variants if i < args.faulty else variants[:1])
        rec = {"seed": seed, "numbers": nums, "s": time.time() - t0}
        if getattr(drv, "detail", None):
            rec["worst_leaves"] = drv.detail
        readings.append(rec)
        print(json.dumps(rec), flush=True)
        del drv
        free_cuda()
    summary = {"workload": args.workload,
               "kind": torch.cuda.get_device_name(0),
               "bounds": bounds(readings)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"readings": readings, **summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
