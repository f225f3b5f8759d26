"""PEPNet at the Amazon width on one card, at the CLI defaults (the sparse
table gradient, kernel 1, a bf16 table and bf16 moments):

* ``fit``: ``build_model`` + ``Trainer.fit`` of 40 steps (a full chunk
  and a remainder) on a resident split, with the valid and test passes,
  by CUDA graph replays and by an eager twin from one seed
  (``chip_smoke.fit_twins``), bitwise equal after the fit; kernel 1
  launched once a step by each, kernel 2 never; the graph trainer's
  captured pairs read at its fetch (``pepnet.gate`` and ``pepnet.step``,
  none missed) and the eager twin's ordinary ones; peak memory.
* ``cost``: the benchmark cell's driver (``perfbench``'s
  ``pepnet-amazon25.train``, its configuration and seed) built twice, one
  of them with the store's stretch pairs turned off while it builds and
  captures its step, so that its graph has no event node; then whole
  epochs of each in turns (off, on, on, off, ...), each on the host clock
  to a synchronize, and each step replay's device time from its event
  pair: examples/s and device ms a step of each, the pairs' cost, the on
  side's ``gate_fwd_pct`` reads.
* ``nodes``: the graphs of each of ``--cells`` as its driver captures them
  in the checkout ``--root`` (default this one), kept and their nodes
  counted by type (``cudaGraphGetNodes``): a checkout without the stretch
  pairs against one with them.

    python3 tools/pepnet_card.py [--parts fit,cost,nodes] [--rounds 4]
        [--root DIR] [--cells a,b]

One JSON line a part on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIT_STEPS = 40
CELL = "pepnet-amazon25.train"
SEED = 2_718_281_828  # above 2**31, as the benchmark's seeds are


def say(part: str, **kw) -> None:
    print(json.dumps({"part": part, **kw}), flush=True)


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return {"card": q.stdout.strip(), "torch": torch.__version__}


def captured(st) -> dict:
    return {name: [list(r) for r in st.captured_records(name)]
            for name in ("pepnet.gate", "pepnet.step")}


def gate_pct(st, since=None) -> list:
    """100 x the gates' ms over the step's, per read (the reader's
    arithmetic), of the reads after ``since`` (a ``mark()``)."""
    since = (since or {}).get("captured", {})
    gates = {}
    for replay, ms in st.captured_records(
            "pepnet.gate", since=since.get("pepnet.gate", 0)):
        gates[replay] = gates.get(replay, 0.0) + ms
    return [100.0 * gates[r] / ms for r, ms in st.captured_records(
        "pepnet.step", since=since.get("pepnet.step", 0)) if r in gates]


def part_fit() -> None:
    import chip_smoke as cs
    from aread_tpu_torch.config import DOMAIN2GROUP, Config
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.train.trainer import Trainer
    from aread_tpu_torch.utils.profiling import STORE

    data = cs.amazon_split(np.random.default_rng(5), FIT_STEPS * cs.BS, 2048)
    d2g = np.asarray(DOMAIN2GROUP["amazon"]["dcn_3groups_kl"])
    cfg = Config(model="pepnet", dataset_name="amazon", seed=0)
    if (cfg.sparse_table_grad, cfg.table_dtype, cfg.table_moments_dtype,
            cfg.table_optimizer) != (True, "bfloat16", "bfloat16", "adam"):
        raise AssertionError("not the CLI defaults")
    torch.cuda.reset_peak_memory_stats()
    before = dict(STORE.counts)

    def make():
        return Trainer(build_model(cfg, data.spec, cs.N_DOMAIN,
                                   device="cuda"), cfg, cs.N_DOMAIN, d2g)

    ctx = {}
    t0 = time.perf_counter()
    trs, res, secs = cs.fit_twins(
        ctx, "pepnet_fit", make,
        lambda t: t.fit(data, epochs=1, verbose=False))
    launches = {k: ctx["launches_by_path"][p] for k, p in
                (("graph", "pepnet_fit"), ("eager", "pepnet_fit_eager"))}
    for k, got in launches.items():
        if got != {"fused_adam": 0, "sparse_adam": FIT_STEPS}:
            raise AssertionError(f"the {k} fit launched {got}")
    counts = {k: STORE.counts[k] - before.get(k, 0)
              for k in ("device.captured_pairs", "device.captured_missed",
                        "device.pairs", "step.replays", "step.captures")}
    if counts["device.captured_missed"] or not counts[
            "device.captured_pairs"]:
        raise AssertionError(f"captured pairs: {counts}")
    hist = res["graph"]["history"][0]
    eager = {name: len(STORE.device_records(name))
             for name in ("pepnet.gate", "pepnet.step")}
    say("fit", **card(), steps=FIT_STEPS, graph_bitwise_eager=True,
        launches=launches, fit_s=secs, seconds=time.perf_counter() - t0,
        dispatch={k: r["dispatch"] for k, r in res.items()},
        train_loss=hist["train_loss"], valid_total_auc=hist["total_auc"],
        counts=counts, captured=captured(STORE), gate_pct=gate_pct(STORE),
        eager_pairs_read=eager,
        peak_memory_bytes=torch.cuda.max_memory_allocated())


def part_cost(rounds: int) -> None:
    from aread_tpu_torch.utils import profiling
    from perfbench import registry, run
    from perfbench.driving import free_cuda

    run.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.steady(torch)
    cell = run.Cell(CELL)
    st = profiling.STORE
    drv = {}
    for side in ("off", "on"):
        d = registry.driver(cell.mix["driver"])(cell.config, cell.mix, SEED,
                                                1.0)
        if side == "off":
            real = st.pair
            st.pair = lambda name, on=True: profiling.NO_PAIR
            try:
                d.setup()
            finally:
                st.pair = real
        else:
            d.setup()
        drv[side] = d
    ex = {"off": [], "on": []}
    dev_ms = {"off": [], "on": []}
    order = []
    mark = st.mark()
    counts0 = dict(st.counts)
    for r in range(rounds):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            d = drv[side]
            d.sync()
            r0, n0 = d.rows_fed(), st.counts["step.replays"]
            t0 = time.perf_counter()
            loss = d.epoch(r)
            d.sync()
            dt = time.perf_counter() - t0
            if not np.isfinite(loss):
                raise AssertionError(f"{side}: loss {loss}")
            ex[side].append((d.rows_fed() - r0) / dt)
            n1 = st.counts["step.replays"]
            st.harvest()
            dev_ms[side].append(statistics.median(
                ms for uid, ms, _, _ in st.device_records("step")
                if n0 <= uid < n1))
            order.append(side)
    med = {k: statistics.median(v) for k, v in ex.items()}
    med_ms = {k: statistics.median(v) for k, v in dev_ms.items()}
    pct = gate_pct(st, mark)
    say("cost", **card(), cell=CELL, seed=SEED, order=order,
        examples_per_s=ex, median=med,
        pairs_cost_pct=100.0 * (med["off"] - med["on"]) / med["off"],
        step_device_ms=dev_ms, step_device_ms_median=med_ms,
        pairs_device_cost_pct=100.0 * (med_ms["on"] - med_ms["off"])
        / med_ms["off"],
        gate_fwd_pct=pct, gate_fwd_pct_median=(statistics.median(pct)
                                               if pct else None),
        step_ms=[ms for _, ms in st.captured_records(
            "pepnet.step", since=mark["captured"].get("pepnet.step", 0))],
        **{k: st.counts[k] - counts0.get(k, 0)
           for k in ("device.captured_missed", "device.captured_pairs")},
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    for d in drv.values():
        d.release()
    free_cuda()


# cudaGraphNodeType
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "event_wait", 7: "event_record",
              8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
              11: "mem_free", 13: "conditional"}


def cudart():
    import ctypes

    for name in ("libcudart.so.12", "libcudart.so",
                 "/usr/local/cuda/lib64/libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise OSError("no CUDA runtime library to load")


def node_types(graph) -> dict:
    """The nodes of a kept graph (``keep_graph=True``), counted by type
    (``cudaGraphGetNodes``, ``cudaGraphNodeGetType``)."""
    import collections
    import ctypes

    rt = cudart()

    def check(err):
        if err:
            raise RuntimeError(f"CUDA runtime error {err}")

    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(h, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(h, nodes, ctypes.byref(n)))
    kinds = collections.Counter()
    for nd in nodes:
        t = ctypes.c_int(-1)
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(nd), ctypes.byref(t)))
        kinds[NODE_TYPES.get(t.value, str(t.value))] += 1
    return dict(kinds)


def part_nodes(root: str, cells) -> None:
    """Each cell's graphs as its driver's set-up captures them, kept
    (``keep_graph=True``) and their nodes counted by type."""
    from perfbench import registry, run

    made = []
    real = torch.cuda.CUDAGraph

    class KeptGraph(real):
        def __new__(cls, *args, **kw):
            return super().__new__(cls, keep_graph=True)

        def __init__(self, *args, **kw):
            # the binding's constructor takes keep_graph
            super().__init__(keep_graph=True)
            made.append(self)

    torch.cuda.CUDAGraph = KeptGraph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name in cells:
            cell = run.Cell(name, root)
            del made[:]
            d = registry.driver(cell.mix["driver"])(cell.config, cell.mix,
                                                    SEED, 1.0)
            d.setup()
            out[name] = [node_types(g) for g in made]
            d.release()
            del d
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    finally:
        torch.cuda.CUDAGraph = real
    say("nodes", **card(), root=root, graphs=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parts", default="fit,cost")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--cells", default="mmoe-amazon25.train,"
                   "aread-amazon25.bagging,pepnet-amazon25.train")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the checkout whose package is measured
    if not torch.cuda.is_available():
        print("tools/pepnet_card.py needs a CUDA device", file=sys.stderr)
        return 2
    parts = args.parts.split(",")
    if "fit" in parts:
        part_fit()
    if "cost" in parts:
        part_cost(args.rounds)
    if "nodes" in parts:
        part_nodes(root, args.cells.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
