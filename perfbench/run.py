"""One run of one cell of ``BENCHMARK.json``:

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names its configuration
(``perfbench/configs/<config>.json``) and its traffic mix
(``perfbench/traffic/<mix>.json``, whose ``driver`` names the driver
``perfbench/drivers/<driver>.py``); the configuration names its model's
plain reference ``perfbench/reference/<model>.py``; its per-layer metrics
are readers ``perfbench/layer_metrics/<metric>.py``; the limits of its
correctness check are ``perfbench/limits/<cell>.json``. All are found by
name (``perfbench.registry``), so a cell, a configuration, a model, a mix,
a driver or a metric is added as files and entries.

The run refuses to start without as many cards as the cell asks for, then
sets up (measured from the process's start as ``setup_s``), runs the timed
window (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: the
window, then a traced stretch of the same calls, and the cell's per-layer
metrics, host-clock ones from the window and device ones from the
stretch, with the device's busy and window seconds and a breakdown),
reads the peak memory, runs the correctness
check against the reference, and prints one JSON line as the last line of
its standard output, the numbers compared beside their limits last. It
exits with 3, printing no result, when the process has loaded JAX or the
JAX package.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

from perfbench import registry  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aread_tpu")
THREADS = 2  # the host's intra-op threads of a run
CACHE = ROOT / ".perfbench_cache"


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    package builds its kernels into its own ``_build`` directory there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by its
    names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root = Path(root)
        registry.use(root)
        bench = load_json(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if len(found) != 1:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        conf = [c for c in bench["configs"] if c["name"] == self.entry["config"]]
        self.config = load_json(root / conf[0]["file"])
        here = root / "perfbench"
        self.mix = load_json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          or ("workloads" not in m and any(
                              e["name"] == m["moves"] for e in self.end_to_end))]


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's loaded modules), each compared whole."""
    mods = list(sys.modules) if modules is None else modules
    tops = {m.split(".")[0] for m in mods}
    return sorted(tops & set(FORBIDDEN))


def device_info(torch) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def steady(torch) -> None:
    """One process with few threads, and the set-up's objects out of the
    collector's way: the host's share of a run varies less."""
    torch.set_num_threads(THREADS)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", stream=None, root: Path = ROOT
         ) -> int:
    """A run; returns the exit code. ``device`` other than 'cuda' skips the
    look for a card (tests drive the rest of a run on the CPU); ``root``
    is the checkout whose files name the cell."""
    args = parse(argv)
    out = stream or sys.stdout
    cell = Cell(args.workload, root)
    cache_env()
    import torch

    if device == "cuda":
        need = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"perfbench: {args.workload} needs {need} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    from perfbench import check as chk

    # the timed path's products as the configuration states them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steady(torch)
    drv = registry.driver(cell.mix["driver"])(cell.config, cell.mix,
                                              args.seed, args.seconds,
                                              device=device)
    drv.setup()
    gc.collect()
    gc.freeze()
    setup_s = time.time() - T_START
    metrics: Dict[str, Dict] = {}
    dev: Dict = ({"platform": "cpu", "kind": "cpu", "count": 1}
                 if device != "cuda" else device_info(torch))
    breakdown = None
    window = drv.window(args.seconds)
    if args.trace:
        data = drv.traced()
        ctx = Context(cell, drv, window, data)
        for m in cell.per_layer:
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = data.busy_s(), data.window_s
        breakdown = data.breakdown()
    else:
        window["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": window[m["name"]],
                                  "unit": m["unit"]}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if device == "cuda" else 0)
    numbers = drv.check()["program"]
    cmp = chk.compared(numbers, cell.limits)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result = {"correct": chk.is_correct(cmp), "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in cmp.items()}
    for k, (v, lim) in cmp.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


class Context:
    """What a per-layer reader reads: the cell (its configuration, mix and
    name), the driver's kind ('train', 'serve', ...), the untraced window's
    readings (``window``: its end-to-end metrics, its timed ``units`` and
    ``seconds``, and host-clock ``spans``) and the traced stretch that
    follows it (``data``, ``perfbench.trace.TraceData``)."""

    def __init__(self, cell: Cell, drv, window: Dict, data):
        self.cell, self.cfg, self.mix = cell, cell.config, cell.mix
        self.kind, self.window, self.data = drv.kind, window, data


if __name__ == "__main__":
    sys.exit(main())
