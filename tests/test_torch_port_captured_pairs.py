"""The store's stretch pairs (``aread_tpu_torch/utils/profiling.py``
``Store.pair``) on the CPU, with a stub event and a stand-in graph in
place of CUDA's:

* pairs opened during a capture go to the graph replayed next, which
  notes on each replay its replay number; ``read_captured`` reads each
  pair of a graph once per replay of it, keeping the newest replay's
  number, and the replays between two reads leave no record;
* a pair that cannot be read (its events never recorded or not complete,
  or a capture's pairs that no replay took up) is counted as missed;
* the trainer reads them only after its loss fetch (``mean_losses``),
  not at the ``harvest`` before it;
* outside a capture a pair is an ordinary one, read back by ``harvest``
  under the stretch's name;
* only PEPNet asks for pairs: its five Gate NUs and its step; MMoE's step
  asks for none, and none is opened off a card.

Torch runs on one thread: the suite's workers share the host's cores."""

import numpy as np
import pytest
import torch

from aread_tpu_torch.config import Config
from aread_tpu_torch.data.loader import make_synthetic_data
from aread_tpu_torch.models import build_model
from aread_tpu_torch.train import trainer as trainer_lib
from aread_tpu_torch.train.trainer import Trainer, mean_losses
from aread_tpu_torch.utils import profiling
from aread_tpu_torch.utils.profiling import Store


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    """The stub device's clock: each record takes the next tick."""
    now = 0.0


class StubEvent:
    """A timing event of the stub device: a record during a capture is a
    node of the graph (it records nothing then), and the graph's replay
    records it; ``elapsed_time`` refuses an event never recorded or not
    complete, as CUDA's does."""

    def __init__(self, *args, **kw):
        self.t, self.complete, self.nodes = None, True, 0

    def record(self, stream=None):
        if profiling.in_capture():
            self.nodes += 1
            return
        Clock.now += 1.0
        self.t = Clock.now

    def elapsed_time(self, other):
        if (self.t is None or other.t is None or not self.complete
                or not other.complete):
            raise RuntimeError("Both events must be completed")
        return other.t - self.t


class StubGraph:
    """A captured graph's stand-in: a replay records its captured pairs'
    events in order, a pair's stretch ``ms[name]`` long."""

    def __init__(self, ms):
        self.ms, self.replays = ms, 0

    def replay(self):
        self.replays += 1
        cap = getattr(self, "captured_pairs", None)
        for name, a, b in [] if cap is None else cap.pairs:
            Clock.now += 1.0
            a.t = Clock.now
            Clock.now += self.ms[name]
            b.t = Clock.now


@pytest.fixture
def stub(monkeypatch):
    """The stub event in place of CUDA's; ``capturing[0]`` is what the
    store sees of the current stream."""
    capturing = [False]
    monkeypatch.setattr(profiling, "captured_event", StubEvent)
    monkeypatch.setattr(profiling, "in_capture", lambda: capturing[0])
    return capturing


def capture(st, capturing, names):
    capturing[0] = True
    for name in names:
        with st.pair(name, True):
            pass
    capturing[0] = False


def test_pairs_of_a_capture_go_to_the_next_graph_replayed(stub):
    st = Store()
    capture(st, stub, ["gate", "gate", "step"])
    events = [e for _, a, b in st._capturing.pairs for e in (a, b)]
    assert all(e.nodes == 1 and e.t is None for e in events)
    g = StubGraph({"gate": 2.0, "step": 10.0})
    st.replay("step", g)
    assert g.captured_pairs.replay == 0 and st._capturing is None
    st.read_captured()
    assert st.captured_records("gate") == [(0, 2.0), (0, 2.0)]
    assert st.captured_records("step") == [(0, 10.0)]
    assert st.counts["device.captured_pairs"] == 3
    # three replays, then one read: the newest replay's number, once
    for _ in range(3):
        st.replay("step", g)
    assert g.replays == 4
    st.read_captured()
    assert st.captured_records("step") == [(0, 10.0), (3, 10.0)]
    # no replay since: nothing new
    st.read_captured()
    assert len(st.captured_records("gate")) == 4
    assert st.counts["device.captured_pairs"] == 6
    assert st.counts["device.captured_missed"] == 0
    assert st.summary()["captured"] == {
        "gate": {"reads": 4, "median_ms": 2.0},
        "step": {"reads": 2, "median_ms": 10.0}}


def test_a_graph_without_pairs_is_left_alone(stub):
    st = Store()
    g = StubGraph({})
    st.replay("step", g)
    assert not hasattr(g, "captured_pairs")
    st.read_captured()
    assert st.counts["device.captured_pairs"] == 0


def test_missed_reads_are_counted(stub):
    st = Store()
    capture(st, stub, ["gate", "step"])
    # a capture's pairs that no replay took up: never recorded
    st.read_captured()
    assert st.counts["device.captured_missed"] == 2
    # an event not complete at the read
    g = StubGraph({"gate": 1.0, "step": 5.0})
    st.replay("step", g)
    g.captured_pairs.pairs[1][2].complete = False
    st.read_captured()
    assert st.counts["device.captured_missed"] == 4
    assert st.captured_records("gate") == []
    # the next replay and read are whole again
    g.captured_pairs.pairs[1][2].complete = True
    st.replay("step", g)
    st.read_captured()
    assert st.captured_records("step") == [(1, 5.0)]
    assert st.counts["device.captured_missed"] == 4


def test_a_dropped_graph_takes_its_pairs_along(stub):
    st = Store()
    capture(st, stub, ["step"])
    g = StubGraph({"step": 1.0})
    st.replay("step", g)
    assert len(st._graphs) == 1
    del g
    st.read_captured()
    assert st._graphs == [] and st.captured_records("step") == []


def test_the_trainer_reads_them_after_its_fetch(stub, monkeypatch):
    st = Store()
    monkeypatch.setattr(trainer_lib, "STORE", st)
    capture(st, stub, ["step"])
    g = StubGraph({"step": 3.0})
    st.replay("step", g)
    st.harvest()  # what the fetch does before it waits: no read
    assert st.captured_records("step") == []
    assert mean_losses([torch.ones(4), torch.zeros(4)]) == 0.5
    assert st.captured_records("step") == [(0, 3.0)]


def test_outside_a_capture_a_pair_is_an_ordinary_one(stub, monkeypatch):
    class Stream:
        pass

    monkeypatch.setattr(torch.cuda, "Event", StubEvent)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 7, raising=False)
    st = Store()
    for uid in (4, 5):
        with st.span("unit", uid):
            with st.pair("gate", True):
                Clock.now += 2.0
    st.harvest()
    assert [r[:2] for r in st.device_records("gate")] == [(4, 3.0),
                                                           (5, 3.0)]
    assert st.counts["device.pairs"] == 2
    assert st.captured_records("gate") == []


# ----------------------------------------------------- who asks for pairs
@pytest.fixture(scope="module")
def world():
    data = make_synthetic_data(n_rows=256, n_domain=3, vocab=40, seed=2)
    return data


def pair_calls(monkeypatch):
    calls = []
    real = profiling.STORE.pair

    def spy(name, on=True):
        calls.append((name, on))
        return real(name, on)

    monkeypatch.setattr(profiling.STORE, "pair", spy)
    return calls


@pytest.mark.parametrize("name,want", [
    ("pepnet", ["pepnet.step"] + ["pepnet.gate"] * 5),
    ("mmoe", [None])])
def test_only_pepnet_asks_for_pairs(world, monkeypatch, name, want):
    data = world
    cfg = Config(model=name, embed_dim=8, bs=64, sparse_table_grad=True,
                 tower_dims=(16, 8, 8, 4), mmoe_expert_dims=(16, 8),
                 mmoe_tower_dims=(8,))
    model = build_model(cfg, data.spec, 3, n_tower=2, device="cpu")
    tr = Trainer(model, cfg, 3, domain2group=np.array([0, 1, 0]))
    tr.init()
    calls = pair_calls(monkeypatch)
    rows = slice(0, 64)
    batch = {"x": data.train_x[rows], "y": data.train_y[rows].astype(
        np.float32), "valid": np.ones(64, np.float32)}
    batch["domain"] = batch["x"][:, data.spec.domain_idx].astype(np.int32)
    batch["group"] = np.array([0, 1, 0])[batch["domain"]].astype(np.int32)
    tr.step(batch)
    assert [c[0] for c in calls] == want
    assert not any(on for _, on in calls)  # off a card: none opened
    calls.clear()
    with torch.no_grad():
        model(torch.as_tensor(batch["x"]), train=False)
    assert all(not on for _, on in calls)
