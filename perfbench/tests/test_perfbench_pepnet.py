"""The PEPNet cell's own pieces: its two per-layer entries and their
readers on a stub context, in the style of ``test_perfbench_spans.py``
(``gate_fwd_pct.pepnet`` from a synthetic store's captured pairs,
``step_mfu.pepnet`` from a window), each None where it has nothing to
read; and the reference's multiply-adds against a count by hand."""

import json
import types

import pytest

from perfbench import registry, roofline
from perfbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "pepnet-amazon25.train"
CFG = json.loads((REPO / "perfbench/configs/pepnet-amazon25.json")
                 .read_text())


def ctx(kind="train", window=None):
    return types.SimpleNamespace(kind=kind, cfg=CFG, window=window or {})


def test_entries_name_the_cell_and_its_metric():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, better, source in (
            ("gate_fwd_pct.pepnet", "lower", "program_span"),
            ("step_mfu.pepnet", "higher", "host_clock")):
        m = entries[name]
        assert (m["better"], m["source"], m["moves"], m["workloads"]) == (
            better, source, "zoo_examples_per_s", [CELL])
        assert callable(registry.reader(name))
    (zoo,) = [m for m in BENCH["end_to_end"]
              if m["name"] == "zoo_examples_per_s"]
    assert zoo["workloads"] == ["mmoe-amazon25.train", CELL]


def synthetic_store():
    """Two reads of the step graph's pairs: replays 1,023 and 2,047, five
    gates and the step each; a traced read beside them that would move
    the value; a gate read without its step's."""
    from aread_tpu_torch.utils.profiling import Store

    st = Store()

    def put(name, replay, ms, traced=False):
        st._ring(name, traced, st.captured).put((replay, ms))

    for replay, step, gate in ((1023, 4.0, 0.08), (2047, 5.0, 0.2)):
        for _ in range(5):
            put("pepnet.gate", replay, gate)
        put("pepnet.step", replay, step)
    put("pepnet.gate", 3071, 9.0)
    put("pepnet.gate", 4095, 9.0, traced=True)
    put("pepnet.step", 4095, 1.0, traced=True)
    return st


def test_gate_share_reads_the_untraced_reads(monkeypatch):
    from aread_tpu_torch.utils import profiling

    read = registry.reader("gate_fwd_pct.pepnet")
    monkeypatch.setattr(profiling, "STORE", profiling.Store())
    assert read(ctx()) is None  # no reads
    monkeypatch.setattr(profiling, "STORE", synthetic_store())
    # per read 100 x 5 x gate / step: 10% and 20%, the median 15%
    assert read(ctx()) == pytest.approx(15.0)
    assert read(ctx("serve")) is None
    # a store without captured pairs (the parent's) reads nothing
    monkeypatch.setattr(profiling.Store, "captured_records", None)
    assert read(ctx()) is None
    monkeypatch.delattr(profiling, "STORE")
    assert read(ctx()) is None


def test_step_mfu_reads_the_window():
    read = registry.reader("step_mfu.pepnet")
    assert read(ctx()) is None
    w = {"units": 1000, "seconds": 4.0}
    want = 100.0 * 1000 * roofline.step_seconds_bound(CFG) / 4.0
    assert read(ctx(window=w)) == pytest.approx(want)
    assert read(ctx("serve", w)) is None


def test_multiply_adds_by_hand():
    ref = registry.model(CFG)
    # the five Gate NUs: EPNet (288 + 32) x 64 + 64 x 288; PPNet's before
    # the layers of 288, 256, 128 and 64 inputs, each 576 x 64 + 64 x 3d
    gates = (320 * 64 + 64 * 288) + sum(576 * 64 + 64 * 3 * d
                                        for d in (288, 256, 128, 64))
    assert ref.gate_macs_per_row(CFG) == gates == 327_680
    towers = 3 * (288 * 256 + 256 * 128 + 128 * 64 + 64 * 32) + 3 * 32
    attention = 9 * 32 * 64 * 2 + 3 * (9 * 64 * 192 + 2 * 81 * 64
                                       + 9 * 64 * 64) + 9 * 64
    side = 288 + 3 * 288 + 288  # linear head, cross net, its Linear(1)
    total = gates + towers + attention + side
    assert roofline.forward_macs_per_row(CFG) == total == 1_190_336
    # the gates' share of the forward's products
    assert 0.27 < gates / total < 0.28
    # the table is the whole vocabulary, padded as the packed storage is
    assert roofline.table_shape(CFG) == (1_518_384, 32)
    assert roofline.sparse_adam_bytes(CFG) == 585_357_312
