"""The readers of the measured package's own spans, counters and device
event pairs (``layer_metrics/port_spans.py`` and the metrics that use it):
every such entry of ``BENCHMARK.json`` has its reader and one cell; each
reader returns None from a store without its records, from a package
without a store and in a cell of another kind, and the right value from a
synthetic store."""

import json
import types

import pytest

from perfbench import registry
from perfbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KIND = {w["name"]: w for w in BENCH["workloads"]}
# each metric's cell kind and the value the synthetic store gives it
READS = {
    "replay_gap_us.train": ("train", 30.0),
    "replay_gap_us.zoo": ("train", 30.0),
    "replay_host_ms.train": ("train", 4.0),
    "replay_host_ms.zoo": ("train", 4.0),
    "chain_gap_us.evolve": ("evolve", 10.0),
    "regroup_host_ms.evolve": ("evolve", 150.0),
    "request_host_ms.serve_tail": ("serve", 0.1),
    "request_host_ms.serve": ("serve", 0.1),
    "request_device_ms.serve_tail": ("serve", 0.4),
    "request_device_ms.serve": ("serve", 0.4),
    "pad_waste_pct.serve": ("serve", 25.0),
}
MS = 1_000_000  # ns


def test_every_store_metric_has_its_reader_and_one_cell():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(READS) <= set(entries)
    for name in READS:
        m = entries[name]
        assert m["source"] == "host_clock" and m["better"] == "lower"
        (cell,) = m["workloads"]
        assert cell in KIND
        assert callable(registry.reader(name))


def synthetic_store():
    """A store whose untraced records give each metric ``READS``' value,
    with traced records beside them that would move every one."""
    from aread_tpu_torch.utils.profiling import Store

    st = Store()

    def span(name, t0, ms, parent=None, uid=-1, traced=False):
        st._ring(name, traced).put((t0, t0 + int(ms * MS), parent, uid))

    def pair(kind, uid, dev_ms, gap_ms, first, traced=False):
        st._ring(kind, traced, st.device).put((uid, dev_ms, gap_ms, first))

    for i, ms in enumerate((3.0, 4.0, 5.0)):
        span("step_graph.replay", 10 * i * MS, ms, "step_graph.run", i)
        # gaps 0.02 and 0.04 ms within a call, 0.03 at its first replay
        pair("step", i, 4.5, (0.03, 0.02, 0.04)[i], i == 0)
        span("step_graph.replay", 0, 50.0, uid=i, traced=True)
        pair("step", i, 9.0, 9.0, False, traced=True)
    for i, gap in enumerate((5.0, 0.01, 0.01)):
        pair("chain", i, 22.0, gap, i == 0)
    # regroups 1-3: 1,000 ms, chains 850 / 860 / 800: 150, 140 and 200 own
    for uid, chains in ((1, 850.0), (2, 860.0), (3, 800.0)):
        span("hemp_mask_evolution", 0, 1000.0, uid=uid)
        span("hemp.chains", 0, chains, "hemp_mask_evolution", uid)
    span("hemp.chains", 0, 5.0, uid=-1)  # a traced stretch's call, alone
    # requests 0-2: 0.5 ms each, fetches 0.4 / 0.45 / 0.3 ms
    for uid, fetch in ((0, 0.4), (1, 0.45), (2, 0.3)):
        span("serve.predict", 0, 0.5, uid=uid)
        span("serve.fetch", 0, fetch, "serve.predict", uid)
        pair("request", uid, (0.3, 0.4, 0.5)[uid], 1.0, True)
    st.counts["serve.rows"] = 3 * 384
    st.counts["serve.padded_rows"] = 3 * 512
    return st


def ctx(kind):
    return types.SimpleNamespace(kind=kind)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_the_untraced_records(metric, monkeypatch):
    from aread_tpu_torch.utils import profiling

    kind, want = READS[metric]
    read = registry.reader(metric)
    monkeypatch.setattr(profiling, "STORE", profiling.Store())
    assert read(ctx(kind)) is None  # no records
    monkeypatch.setattr(profiling, "STORE", synthetic_store())
    assert read(ctx(kind)) == pytest.approx(want)
    assert read(ctx("other")) is None
    # a package without a store (the parent's) reads nothing
    monkeypatch.delattr(profiling, "STORE")
    assert read(ctx(kind)) is None
