"""Spans, counters and device event pairs: the port's one record of where
its time goes (counterpart of ``aread_tpu/utils/profiling.py``, grown past
it).

* ``STORE`` (``Store``): always on, in memory. A span (``STORE.span(name,
  uid)``, a context manager) records its name, a start and an end on
  ``time.perf_counter_ns``, its parent (the enclosing span of the same
  thread), an id shared by every span of one unit (a step, a chain or a
  request: the replay count, or the request's sequence number; a span
  given none takes its parent's) and whether a torch profiler was running.
  Each name keeps its newest ``RING`` records in a preallocated ring, one
  ring for records taken under a profiler and one for the rest, so a
  traced stretch never pushes the untraced window's records out. Counters
  are plain integers kept at the same boundaries (``STORE.count``;
  ``STORE.counter`` hands an owner its own share of one, as
  ``GraphChunks.captures`` reads it). While a torch profiler runs, a span
  also opens a range of its name in the profiler's host records, so the
  profiler's records and ``trace``'s Chrome trace name the port's spans
  beside the kernels; otherwise a span costs its two clock reads and one
  ring write. The range is the profiler's fast host range, which, unlike
  ``record_function``, puts nothing on the device's timeline (there it
  would cover the idle time between the kernels it encloses). No NVTX
  range is opened: the profiler's ranges are what the traces read.
* Device event pairs: on a card a step, chain or request replay
  (``STORE.replay``) records a timing ``torch.cuda.Event`` just before and
  just after ``graph.replay()``, from a preallocated pool per kind: every
  step and chain replay, every ``PAIR_EVERY['request']``-th request (a pair
  costs more host time than a request can hide). The pairs are read back
  (``STORE.harvest``) without waiting, only where the port waits for the
  device anyway: an epoch's loss fetch, a regroup's one fetch, a request's
  copy out. For replay i the store keeps its device time (end_i - start_i)
  and, where replay i - 1 took a pair too, the device's idle time before it
  (start_i - end_{i-1}: the stream reaches start_i only once the host has
  enqueued it). A pair still incomplete when its slot comes round is
  dropped and counted (``device.dropped``), never waited for. No event is
  recorded inside a capture or on the side stream of the eager calls
  before one, except by a stretch's pair, below.
* A stretch's event pair (``STORE.pair(name, on)``, a context manager):
  opened by the code that does the work where it asks for one (PEPNet's
  Gate NUs and its training step), and nowhere else, so no other graph
  gains a node. Outside a capture it is an ordinary pair, kept and read
  as a replay's are, by the stretch's name. Inside a capture its two
  events are made with ``external=True``: each record becomes a node of
  the graph, so every replay records the pair again and it times that
  stretch inside that replay. The pairs of one capture go to the graph
  replayed next (``STORE.replay``: the graph it captured, in every
  runner), which then notes on each replay its replay number. They are
  read (``STORE.read_captured``) only right after the host has waited for
  the device, where no queued replay can record them again
  (``train.trainer.mean_losses``, after its fetch): each read keeps the
  newest replay's number and milliseconds per pair
  (``captured_records``), one read a graph between fetches, counted as
  ``device.captured_pairs``. A pair that cannot be read there (its graph
  never replayed, or an event not complete) is counted as
  ``device.captured_missed``. The replays between two reads leave no
  record.
* ``STORE.summary()``: per span name over its untraced records the count,
  median and total ms; per kind of replay the mean gap (all, within one
  ``run`` / ``run_chains`` call, at its first replay) and the median device
  ms; per captured pair's name its reads and median ms; every counter.
  ``summary(since=STORE.mark())`` gives what happened after the mark
  (``fit`` adds it to each epoch's result as ``spans``).
* ``StepTimer``: rolling stats of a loop's steps, fed the step spans'
  durations (one clock pair a step). On the card a replay returns when
  its kernels are queued, so these durations time the launch; the
  trainers' ``examples_per_s`` divides an epoch's rows by the epoch's
  synchronised seconds instead.
* ``trace(log_dir)``: ``torch.profiler.profile`` over the block, with the
  CUDA activity on a machine with a card, written as a Chrome trace
  (``<log_dir>/<host>_<pid>_<ms>.pt.trace.json``) that TensorBoard's
  profiler plugin and Perfetto load. A no-op unless ``log_dir`` or the
  variable ``AREAD_TPU_TRACE`` is set: the JAX package reads the same
  variable, so one setting traces a run of either package.
* ``annotate(name)``: a span of that name (in the trace while it runs).

The JAX package's ``start_server`` (its on-demand profiler server) has no
counterpart in torch and is not ported.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import statistics
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# records kept per span name, and event pairs per kind of replay
RING = 2048
MASK = RING - 1  # RING is a power of two
# each replay kind's span name
REPLAYS = {"step": "step_graph.replay", "chain": "step_graph.chain_replay",
           "request": "serve.replay"}
# one replay in this many takes an event pair. On the card's machine a
# pair costs ~6 us of host to record and ~15 us to read back; a step (4 ms)
# or a chain (24 ms) hides that, a request (0.5 ms) does not
PAIR_EVERY = {"step": 1, "chain": 1, "request": 8}

_now = time.perf_counter_ns
# a range in the profiler's host records only: ``record_function`` would
# also put a range on the device's timeline, covering the idle time between
# the kernels it encloses
_ProfilerRange = torch._C._profiler._RecordFunctionFast


class Ring:
    """The newest ``RING`` records of one name, oldest first by
    ``tail()``; ``n`` counts every record written."""

    __slots__ = ("slots", "n")

    def __init__(self):
        self.slots: List = [None] * RING
        self.n = 0

    def put(self, rec) -> None:
        self.slots[self.n & MASK] = rec
        self.n += 1

    def tail(self, since: int = 0) -> List:
        lo = max(since, self.n - RING)
        return [self.slots[i & MASK] for i in range(lo, self.n)]


class Span:
    """One span; ``ns`` holds its duration once it has ended."""

    __slots__ = ("store", "name", "uid", "t0", "ns", "parent", "traced",
                 "stack", "_range")

    def __init__(self, store: "Store", name: str, uid: Optional[int]):
        self.store, self.name, self.uid = store, name, uid
        self.ns = 0

    def __enter__(self) -> "Span":
        stack = self.stack = self.store._local.stack
        if stack:
            parent = stack[-1]
            self.parent = parent.name
            if self.uid is None:
                self.uid = parent.uid
        else:
            self.parent = None
            if self.uid is None:
                self.uid = -1
        # read at each call: the profiler rebinds the flag
        self.traced = _autograd_profiler._is_profiler_enabled
        if self.traced:
            self._range = _ProfilerRange(self.name)
            self._range.__enter__()
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now()
        self.ns = t1 - self.t0
        self.stack.pop()
        if self.traced:
            self._range.__exit__(*exc)
        r = self.store.rings[self.traced].get(self.name)
        if r is None:
            r = self.store._ring(self.name, self.traced)
        r.slots[r.n & MASK] = (self.t0, t1, self.parent, self.uid)
        r.n += 1
        return False

    @property
    def seconds(self) -> float:
        """The span's seconds: to its end, or so far while it is open."""
        return (self.ns or _now() - self.t0) / 1e9


class Count:
    """An owner's own share of a store counter: ``add`` counts into both."""

    __slots__ = ("n", "name", "counts")

    def __init__(self, counts: Dict[str, int], name: str):
        self.n, self.name, self.counts = 0, name, counts

    def add(self, k: int = 1) -> None:
        self.n += k
        self.counts[self.name] += k


class Pairs:
    """The timing event pairs of one kind of replay on a card: a pool of
    ``RING`` pairs reused in turn. ``meta`` holds a pair's (replay number,
    uid, first, traced) until it is read, then (replay number,); a dropped
    pair's is None."""

    def __init__(self):
        self.start = [torch.cuda.Event(enable_timing=True)
                      for _ in range(RING)]
        self.end = [torch.cuda.Event(enable_timing=True)
                    for _ in range(RING)]
        self.meta: List = [None] * RING
        self.n = 0      # pairs recorded
        self.read = 0   # the next pair to read, in recording order
        # the current stream, kept by its handle: looking it up through
        # torch.cuda.current_stream() costs more than recording the pair
        self.dev = torch.cuda.current_device()
        self.raw, self.stream = None, None

    def current_stream(self):
        raw = torch._C._cuda_getCurrentRawStream(self.dev)
        if raw != self.raw:
            self.raw, self.stream = raw, torch.cuda.current_stream(self.dev)
        return self.stream


# a stretch nobody times (``Store.pair`` where none is asked for)
NO_PAIR = contextlib.nullcontext()


def in_capture() -> bool:
    """Whether the current stream is capturing a CUDA graph."""
    return torch.cuda.is_current_stream_capturing()


def captured_event():
    """A timing event whose record, inside a capture, is a node of the
    graph."""
    return torch.cuda.Event(enable_timing=True, external=True)


class Captured:
    """The stretch pairs recorded inside one capture: (name, start, end)
    in the order they closed; ``replay``, the number of the graph's newest
    replay (None before its first), ``traced`` whether it ran under a
    profiler, ``read`` the replay number last read."""

    __slots__ = ("pairs", "replay", "traced", "read", "__weakref__")

    def __init__(self):
        self.pairs: List = []
        self.replay: Optional[int] = None
        self.traced = False
        self.read: Optional[int] = None


class DevicePair:
    """A timing event pair around a stretch of device work on the current
    stream (module docstring). Pairs of one name may not nest."""

    __slots__ = ("store", "name", "start", "slot")

    def __init__(self, store: "Store", name: str):
        self.store, self.name = store, name

    def __enter__(self) -> "DevicePair":
        if in_capture():
            self.slot = None
            self.start = captured_event()
            self.start.record()
        else:
            p = self.store._slot(self.name)
            self.slot = (p, p.n & MASK)
            p.start[self.slot[1]].record(p.current_stream())
        return self

    def __exit__(self, *exc) -> bool:
        st = self.store
        if self.slot is None:
            end = captured_event()
            end.record()
            if st._capturing is None:
                st._capturing = Captured()
            st._capturing.pairs.append((self.name, self.start, end))
            return False
        p, s = self.slot
        p.end[s].record(p.current_stream())
        p.meta[s] = (p.n, st.current_uid(), False,
                     _autograd_profiler._is_profiler_enabled)
        p.n += 1
        return False


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []


class Store:
    """Spans, counters and device event pairs (module docstring)."""

    def __init__(self):
        self.rings: Dict[bool, Dict[str, Ring]] = {False: {}, True: {}}
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.pairs: Dict[str, Pairs] = {}
        self.device: Dict[bool, Dict[str, Ring]] = {False: {}, True: {}}
        # (replay number, ms) of each captured pair read, by its name
        self.captured: Dict[bool, Dict[str, Ring]] = {False: {}, True: {}}
        # the pairs of the capture under way, and those of the graphs
        # that hold some (weak: a dropped graph takes its pairs along)
        self._capturing: Optional[Captured] = None
        self._graphs: List[weakref.ref] = []
        self._local = _Local()

    # ------------------------------------------------------------ record
    def _ring(self, name: str, traced: bool, rings=None) -> Ring:
        rings = (self.rings if rings is None else rings)[traced]
        r = rings.get(name)
        if r is None:
            r = rings[name] = Ring()
        return r

    def span(self, name: str, uid: Optional[int] = None) -> Span:
        return Span(self, name, uid)

    def current_uid(self) -> int:
        """The id of the innermost open span of this thread, or -1."""
        stack = self._local.stack
        return stack[-1].uid if stack else -1

    def count(self, name: str, k: int = 1) -> int:
        """Add ``k`` to a counter; returns its value before."""
        n = self.counts[name]
        self.counts[name] = n + k
        return n

    def counter(self, name: str) -> Count:
        return Count(self.counts, name)

    def pair(self, name: Optional[str], on: bool = True):
        """A timing event pair of ``name`` around the block where ``on``
        (its work on a card) and a name is given; else nothing."""
        if name is None or not on:
            return NO_PAIR
        return DevicePair(self, name)

    def replay(self, kind: str, graph, first: bool = False,
               timed: bool = False, uid: Optional[int] = None) -> int:
        """``graph.replay()`` as one span of ``REPLAYS[kind]`` (its id
        ``uid``, by default the kind's replay count), the clock pair just
        around the call; with ``timed`` (a graph on a card) inside an event
        pair too. ``first``: the first replay of its ``run`` or
        ``run_chains`` call. Returns the span's nanoseconds."""
        n = self.count(kind + ".replays")
        uid = n if uid is None else uid
        name = REPLAYS[kind]
        traced = _autograd_profiler._is_profiler_enabled
        stack = self._local.stack
        parent = stack[-1].name if stack else None
        timed = timed and n % PAIR_EVERY[kind] == 0
        cap = getattr(graph, "captured_pairs", None)
        if cap is None and self._capturing is not None:
            # the graph captured last: its first replay
            cap = graph.captured_pairs = self._capturing
            self._capturing = None
            self._graphs.append(weakref.ref(cap))
        rng = None
        if traced:
            rng = _ProfilerRange(name)
            rng.__enter__()
        try:
            if timed:
                p = self._slot(kind)
                s = p.n & MASK
                stream = p.current_stream()
                p.start[s].record(stream)
            t0 = _now()
            graph.replay()
            t1 = _now()
            if timed:
                p.end[s].record(stream)
                p.meta[s] = (n, uid, first, traced)
                p.n += 1
            if cap is not None:
                cap.replay, cap.traced = n, traced
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
        self._ring(name, traced).put((t0, t1, parent, uid))
        return t1 - t0

    def _slot(self, kind: str) -> Pairs:
        """The kind's pool, its next slot free: an unread pair there is
        read if complete (with every complete pair before it), else
        dropped and counted."""
        p = self.pairs.get(kind)
        if p is None:
            p = self.pairs[kind] = Pairs()
        if p.n - p.read >= RING:
            self._harvest(kind, p)
            if p.n - p.read >= RING:
                p.meta[p.read & MASK] = None
                p.read += 1
                self.counts["device.dropped"] += 1
        return p

    def harvest(self, kind: Optional[str] = None) -> None:
        """Read back every complete event pair (of ``kind``, else of every
        kind), in order, without waiting: ``elapsed_time`` queries both
        events and refuses an incomplete pair, where reading stops. Called
        where the host waits for the device anyway."""
        if kind is None:
            for k, p in self.pairs.items():
                self._harvest(k, p)
        elif kind in self.pairs:
            self._harvest(kind, self.pairs[kind])

    def _harvest(self, kind: str, p: Pairs) -> None:
        while p.read < p.n:
            s = p.read & MASK
            try:
                dev = p.start[s].elapsed_time(p.end[s])
            except RuntimeError:  # not complete: read at a later call
                return
            n, uid, first, traced = p.meta[s]
            # the device's idle time since the previous replay's end, where
            # that replay took a pair, read already, still in its slot
            prev = p.meta[(p.read - 1) & MASK] if p.read else None
            gap = (p.end[(p.read - 1) & MASK].elapsed_time(p.start[s])
                   if prev and prev[0] == n - 1 and p.read > p.n - RING
                   else None)
            p.meta[s] = (n,)
            p.read += 1
            self.counts["device.pairs"] += 1
            self._ring(kind, traced, self.device).put(
                (uid, dev, gap, first))

    def read_captured(self) -> None:
        """Read every captured pair whose graph replayed since its last
        read: the newest replay's milliseconds, under its replay number.
        Call only right after the host waited for the device (module
        docstring)."""
        live = []
        for ref in self._graphs:
            cap = ref()
            if cap is None:
                continue
            live.append(ref)
            if cap.replay is None or cap.replay == cap.read:
                continue
            cap.read = cap.replay
            try:
                ms = [a.elapsed_time(b) for _, a, b in cap.pairs]
            except RuntimeError:  # not recorded, or not complete
                self.counts["device.captured_missed"] += len(cap.pairs)
                continue
            for (name, _, _), t in zip(cap.pairs, ms):
                self._ring(name, cap.traced, self.captured).put(
                    (cap.replay, t))
            self.counts["device.captured_pairs"] += len(ms)
        self._graphs = live
        if self._capturing is not None and not in_capture():
            # a capture's pairs that no replay took up
            self.counts["device.captured_missed"] += len(
                self._capturing.pairs)

    # -------------------------------------------------------------- read
    def records(self, name: str, traced: bool = False, since: int = 0
                ) -> List:
        """The ring's (start ns, end ns, parent, uid) records of ``name``
        (untraced by default), oldest first, from record ``since`` on."""
        r = self.rings[traced].get(name)
        return [] if r is None else r.tail(since)

    def device_records(self, kind: str, traced: bool = False,
                       since: int = 0) -> List:
        """(uid, device ms, gap ms or None, first) of the kind's pairs read
        back, oldest first."""
        r = self.device[traced].get(kind)
        return [] if r is None else r.tail(since)

    def captured_records(self, name: str, traced: bool = False,
                         since: int = 0) -> List:
        """(replay number, ms) of the captured pairs of ``name`` read,
        oldest first."""
        r = self.captured[traced].get(name)
        return [] if r is None else r.tail(since)

    def mark(self) -> Dict:
        """Where every ring and counter stands (``summary(since=)``)."""
        return {"spans": {k: r.n for k, r in self.rings[False].items()},
                "device": {k: r.n for k, r in self.device[False].items()},
                "captured": {k: r.n
                             for k, r in self.captured[False].items()},
                "counts": dict(self.counts)}

    def summary(self, since: Optional[Dict] = None) -> Dict:
        """What the benchmark's readers and an operator read (module
        docstring): per span name and per kind of replay over the untraced
        records (after ``since``, a ``mark()``), and every counter (less
        its value at the mark), and per captured pair's name its reads.
        Complete event pairs are read back first."""
        self.harvest()
        since = since or {"spans": {}, "device": {}, "captured": {},
                          "counts": {}}
        spans = {}
        for name in sorted(self.rings[False]):
            ms = [(b - a) / 1e6 for a, b, _, _ in
                  self.records(name, since=since["spans"].get(name, 0))]
            if ms:
                spans[name] = {"count": len(ms),
                               "median_ms": statistics.median(ms),
                               "total_ms": sum(ms)}
        replays = {}
        for kind in sorted(self.device[False]):
            recs = self.device_records(
                kind, since=since["device"].get(kind, 0))
            if not recs:
                continue

            def mean_us(sel):
                g = [r[2] for r in recs if r[2] is not None and sel(r)]
                return 1e3 * sum(g) / len(g) if g else None

            replays[kind] = {
                "pairs": len(recs),
                "gap_us": mean_us(lambda r: True),
                "gap_us_within": mean_us(lambda r: not r[3]),
                "gap_us_first": mean_us(lambda r: r[3]),
                "device_ms": statistics.median(r[1] for r in recs)}
        captured = {}
        for name in sorted(self.captured[False]):
            recs = self.captured_records(
                name, since=since["captured"].get(name, 0))
            if recs:
                captured[name] = {"reads": len(recs), "median_ms":
                                  statistics.median(r[1] for r in recs)}
        counts = {k: v - since["counts"].get(k, 0)
                  for k, v in sorted(self.counts.items())}
        return {"spans": spans, "replays": replays, "captured": captured,
                "counters": counts}


STORE = Store()


class StepTimer:
    """Rolling stats of a loop's steps, fed the step spans' durations
    (``add``; or ``step()`` around a step, one span of ``name``).

    >>> timer = StepTimer(window=100)
    >>> with timer.step(n_examples=1024): ...
    >>> timer.summary()  # {'steps', 'mean_ms', 'examples_per_s', 'total_s'}
    """

    def __init__(self, window: int = 100):
        self.window = window
        self.durations = collections.deque(maxlen=window)
        self.examples = collections.deque(maxlen=window)
        self.total_steps = 0
        self.total_time = 0.0
        self.total_examples = 0
        # how the timed steps were dispatched ('graph' or 'eager', set by
        # the loop that drives them), or None
        self.dispatch = None

    def add(self, ns: int, n_examples: int = 0) -> None:
        """One step of ``ns`` nanoseconds (its span's)."""
        dt = ns / 1e9
        self.durations.append(dt)
        self.examples.append(n_examples)
        self.total_steps += 1
        self.total_time += dt
        self.total_examples += n_examples

    @contextlib.contextmanager
    def step(self, n_examples: int = 0, name: str = "step") -> Iterator[None]:
        sp = STORE.span(name)
        try:
            with sp:
                yield
        finally:
            self.add(sp.ns, n_examples)

    def summary(self) -> dict:
        n = len(self.durations)
        if n == 0:
            return {"steps": 0, "mean_ms": 0.0, "examples_per_s": 0.0,
                    "dispatch": self.dispatch}
        window_time = sum(self.durations)
        return {
            "steps": self.total_steps,
            "mean_ms": 1000.0 * window_time / n,
            "examples_per_s": (sum(self.examples) / window_time
                               if window_time > 0 else 0.0),
            "total_s": self.total_time,
            "dispatch": self.dispatch,
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block into ``log_dir`` (default: ``AREAD_TPU_TRACE``);
    a no-op when neither is set."""
    log_dir = log_dir or os.environ.get("AREAD_TPU_TRACE")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}_"
                 f"{int(time.time() * 1e3)}.pt.trace.json"))


def annotate(name: str) -> Span:
    """A span of ``name`` around the block (in the profiler's trace while
    one runs)."""
    return STORE.span(name)
