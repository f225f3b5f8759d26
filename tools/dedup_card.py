"""The table update's row dedup (``ops/sparse_adam.py::dedup_rows``) on one
card: the hand-written kernel ``ops/cuda/dedup_rows.cu`` against its plain
version, and its time against the plain version's chain of launches.

* ``check``: on the ordering cases (``dedup_case``: one id K times, all
  ids distinct, a pad run of ~30% beside Zipf ids at D 8, 20, 32, 33 and
  64, runs no multiple of 32 or of a staging tile at D 32 and 264, the
  latter staged in two column slices, and with gradients one float into
  their buffer, which takes the 4-byte copies; one id 17,408 times), on
  an Amazon batch's ids (``chip_smoke.amazon_table_ids``) and on a batch
  of the benchmark cell ``mmoe-amazon25.train`` (its rows from the seed,
  the embedding's table ids): uids and gsum bitwise the plain version's
  on the card and on the CPU, eagerly and as a CUDA graph replay; the
  kernel's counters (rows staged, all rows) against the runs' lengths;
  the launches counted.
* ``time``: at the cell's batch (17,408 ids, D = 32), in turns (plain,
  kernel, kernel, plain, ...): device ms a call of the plain version's
  chain (``dedup_rows_reference`` on the card: the parent's
  ``dedup_rows``), of ``dedup_rows`` (the sort and the kernel's two
  launches) and of the two launches alone, each back to back (one event
  pair around 20 calls) and as replays of a graph of 20 calls; the
  kernels a call launches and each one's device ms (the profiler);
  against the bound of bytes (the gradient rows
  read once, gsum written once) and the serial bound of the longest run's
  adds (4 cycles an add at the card's highest SM clock).

    python3 tools/dedup_card.py [--parts check,time] [--rounds 3]

One JSON line a part on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "mmoe-amazon25.train"
SEED = 2_718_281_828  # above 2**31, as the benchmark's seeds are
# (case, K, D): the ordering cases the CPU tests hold the plain version to
# (tests/test_torch_port_sparse_adam.py), and one run of a whole batch
CASES = [("one_id", 1000, 32), ("all_distinct", 1000, 32),
         ("pad_zipf", 2176, 8), ("pad_zipf", 2176, 32),
         ("pad_zipf", 2176, 64), ("ragged", 1001, 32),
         ("one_id", 17408, 32), ("pad_zipf", 2176, 20),
         ("pad_zipf", 2176, 33), ("ragged", 1001, 264)]
SHORT_MAX = 32  # a longer run is staged (dedup_rows.cu)
ADD_CYCLES = 4  # a dependent f32 add


def dedup_case(case, k, d, seed=3):
    """(ids [k] int32, row gradients [k, d] f32, n_rows) of a case:
    ``one_id`` one id k times; ``all_distinct`` k ids, no two equal;
    ``pad_zipf`` the cells' shape at a small k: ~30% of the rows on the
    history's pad id 0, a tenth on five small fields' few values, the rest
    Zipf(1.0) over 5,000 items; ``ragged`` runs of 300, 129, 33, 32, 31, 2
    and 1 rows (k and the runs no multiple of 32 or of a staging tile),
    shuffled."""
    rng = np.random.default_rng(seed)
    n_rows = 6000
    if case == "one_id":
        ids = np.full(k, 17)
    elif case == "all_distinct":
        ids = rng.permutation(n_rows)[:k]
    elif case == "pad_zipf":
        ids = 5000 + rng.integers(0, 50, k)  # five fields of ten values
        ranks = np.minimum(rng.zipf(1.0001, k), 4999)
        ids = np.where(rng.random(k) < 0.9, ranks, ids)
        ids[rng.random(k) < 0.3] = 0
    else:
        lengths = [300, 129, 33, 32, 31, 2]
        ids = np.concatenate([np.full(n, 100 + i)
                              for i, n in enumerate(lengths)])
        ids = np.concatenate([ids, 3000 + np.arange(k - len(ids))])
        ids = rng.permutation(ids)
    g = rng.normal(size=(k, d)).astype(np.float32)
    return ids.astype(np.int32), g, n_rows


def say(part: str, **kw) -> None:
    print(json.dumps({"part": part, **kw}), flush=True)


def smi(query: str) -> str:
    q = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True)
    return q.stdout.strip().splitlines()[0]


def cell_batch(dev):
    """(ids [17,408] int32 on ``dev``, n_rows): one batch of the cell's rows
    from the seed, as the embedding gathers them (offsets, clipped into the
    trainer's table)."""
    from aread_tpu_torch.ops.embedding import compute_offsets
    from perfbench import inputs, run
    from perfbench.driving import feature_spec

    cell = run.Cell(CELL)
    cfg = cell.config
    x, _ = inputs.make_rows(cfg, cell.mix, SEED, cfg["bs"], dev)
    n_rows = feature_spec(cfg).with_flat_table(cfg["embed_dim"]).n_rows
    offs = torch.as_tensor(compute_offsets(
        tuple(cfg["one_hot_dims"]), cfg["n_seq_fields"] * cfg["seq_maxlen"],
        cfg["itemid_idx"]), device=dev)
    ids = torch.clamp(x.to(torch.int64) + offs[None, :], 0, n_rows - 1)
    return ids.reshape(-1).to(torch.int32), n_rows


def runs_of(ids: torch.Tensor):
    """(the runs' lengths, rows in runs longer than a warp)."""
    _, counts = torch.unique(ids.cpu(), return_counts=True)
    return counts, int(counts[counts > SHORT_MAX].sum())


def batches(dev):
    """(name, ids, grads, n_rows) of every case checked on the card."""
    import chip_smoke as cs
    from aread_tpu_torch.models.base import FeatureSpec

    gen = torch.Generator(device=dev).manual_seed(7)
    out = []
    for case, k, d in CASES:
        ids, g, n_rows = dedup_case(case, k, d)
        out.append((f"{case}/{k}/{d}", torch.tensor(ids, device=dev),
                    torch.tensor(g, device=dev), n_rows))
    # gradients one float into their buffer: no 16-byte copies
    ids, g, n_rows = dedup_case("ragged", 1001, 32)
    buf = torch.zeros(g.size + 1, device=dev)
    out.append(("ragged/1001/32/misaligned", torch.tensor(ids, device=dev),
                buf[1:].view(g.shape).copy_(torch.tensor(g)), n_rows))
    spec = FeatureSpec(cs.AMAZON_DIMS, 2, 0, 2, 5).with_flat_table(
        cs.EMBED_DIM)
    ids = torch.as_tensor(cs.amazon_table_ids(
        np.random.default_rng(1), spec.one_hot_dims, spec.n_rows).reshape(-1),
        dtype=torch.int32, device=dev)
    out.append(("amazon_table_ids", ids, torch.randn(
        (ids.numel(), cs.EMBED_DIM), generator=gen, device=dev), spec.n_rows))
    ids, n_rows = cell_batch(dev)
    out.append((CELL, ids, torch.randn((ids.numel(), 32), generator=gen,
                                       device=dev), n_rows))
    return out


def part_check() -> None:
    from aread_tpu_torch.ops import sparse_adam as sa
    from aread_tpu_torch.ops.cuda import captured_counts, launch_counts

    dev = torch.device("cuda")
    rows = []
    for name, ids, grads, n_rows in batches(dev):
        want = sa.dedup_rows_reference(ids, grads, n_rows)
        cpu = sa.dedup_rows_reference(ids.cpu(), grads.cpu(), n_rows)
        counters = sa._slot_map(dev, n_rows).dedup
        before, launched = counters.tolist(), launch_counts["dedup_rows"]
        got = sa.dedup_rows(ids, grads, n_rows)
        torch.cuda.synchronize()
        counted = [a - b for a, b in zip(counters.tolist(), before)]
        launches = launch_counts["dedup_rows"] - launched
        # a graph of the same call on static inputs, replayed twice
        static = [ids.clone(), grads.clone()]
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        captured_before = captured_counts["dedup_rows"]
        with torch.cuda.stream(side):
            sa.dedup_rows(*static, n_rows)  # warm on the capture's stream
            with torch.cuda.graph(graph, stream=side):
                out = sa.dedup_rows(*static, n_rows)
        torch.cuda.current_stream().wait_stream(side)
        in_graph = captured_counts["dedup_rows"] - captured_before
        out[1].fill_(float("nan"))
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        lengths, staged = runs_of(ids)
        row = {
            "case": name, "k": int(ids.numel()), "d": int(grads.shape[1]),
            "runs": int(lengths.numel()), "longest": int(lengths.max()),
            "bitwise_plain_card": all(torch.equal(a, b)
                                      for a, b in zip(got, want)),
            "bitwise_plain_cpu": all(torch.equal(a.cpu(), b)
                                     for a, b in zip(got, cpu)),
            "replay_bitwise_eager": all(torch.equal(a, b)
                                        for a, b in zip(out, got)),
            "counted": counted, "staged_want": [staged, int(ids.numel())],
            "launches": launches, "launches_in_graph": in_graph}
        rows.append(row)
        if not (row["bitwise_plain_card"] and row["bitwise_plain_cpu"]
                and row["replay_bitwise_eager"]):
            raise AssertionError(f"dedup_rows differs: {row}")
        if counted != row["staged_want"] or launches != 1 or in_graph != 1:
            raise AssertionError(f"counters or launches: {row}")
    cell = rows[-1]
    say("check", card=smi("name,power.limit"), torch=torch.__version__,
        cases=rows, staged_pct_cell=100.0 * cell["counted"][0] / cell["k"])


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device ms a call as replays of one graph of ``n`` calls: the median
    over ``reps`` replays of an event pair around the replay, over ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def kernels_ms(fn, n: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by name (the
    profiler's records over ``n`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:72]: e.self_device_time_total / n / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def part_time(rounds: int) -> None:
    import chip_smoke as cs
    from aread_tpu_torch.ops import sparse_adam as sa

    dev = torch.device("cuda")
    ids, n_rows = cell_batch(dev)
    k, d = ids.numel(), 32
    grads = torch.randn((k, d), generator=torch.Generator(
        device=dev).manual_seed(11), device=dev)
    sid, order = torch.sort(ids, stable=True)
    uids = torch.empty((k,), dtype=torch.int32, device=dev)
    gsum = torch.empty((k, d), dtype=torch.float32, device=dev)
    work = torch.empty((2 * k + 3,), dtype=torch.int32, device=dev)
    counters = sa._slot_map(dev, n_rows).dedup
    width, tile = sa.dedup_plan(d)

    def launches_only():
        torch.ops.aread_tpu_torch.dedup_rows_(
            sid, order, grads, uids, gsum, work, counters, n_rows, width, tile,
            torch.cuda.current_stream().cuda_stream)

    forms = {"plain": lambda: sa.dedup_rows_reference(ids, grads, n_rows),
             "kernel": lambda: sa.dedup_rows(ids, grads, n_rows),
             "launches": launches_only,
             "sort": lambda: torch.sort(ids, stable=True)}
    got = {name: {"ms": [], "graph_ms": []} for name in forms}
    for r in range(rounds):
        turn = list(forms) if r % 2 == 0 else list(reversed(forms))
        for name in turn:
            got[name]["ms"].append(cs.device_time_ms(forms[name]))
            got[name]["graph_ms"].append(graph_ms(forms[name]))
    for name, fn in forms.items():
        got[name]["cuda_launches"], got[name]["busy_ms"] = \
            cs.launches_and_busy_per_call(fn)
        got[name]["kernels_ms"] = kernels_ms(fn)
    lengths, staged = runs_of(ids)
    clock_mhz = float(smi("clocks.max.sm"))
    bytes_ = 2 * k * d * 4 + 2 * k * 4 + k * 8  # grads, gsum; ids, uids; order
    say("time", card=smi("name,power.limit"), sm_clock_mhz_max=clock_mhz,
        sm_clock_mhz_now=smi("clocks.sm"), k=k, d=d,
        runs=int(lengths.numel()), longest=int(lengths.max()),
        staged_pct=100.0 * staged / k, times=got,
        bound_bytes=bytes_, bytes_bound_ms=bytes_ / 3.35e12 * 1e3,
        serial_bound_ms=int(lengths.max()) * ADD_CYCLES / (clock_mhz * 1e3))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parts", default="check,time")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tools/dedup_card.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = args.parts.split(",")
    if "check" in parts:
        part_check()
    if "time" in parts:
        part_time(args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
