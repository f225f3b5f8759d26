"""Chunks of training steps, each chunk in as few dispatches as the device
allows (counterpart of the JAX package's scanned steps: ``make_scan`` /
``make_scan_idx`` and the ``SCAN_CHUNK`` chunk loop of
``aread_tpu/train/hemp.py``; ``_build_train_scan`` / ``_build_epoch_scan``
of ``aread_tpu/train/trainer.py``).

The JAX package runs ``SCAN_CHUNK`` steps as one jitted ``lax.scan``,
because a step launched from Python pays host dispatch several times the
device step itself. The same holds for the port: an AREAD step is some
1,200 small launches, a zoo model's step 300 to 1,000, and the card sits
idle while the host issues them. The counterpart of a jitted program
replayed over a chunk is a captured CUDA graph. Two dispatches run a chunk:

* ``GraphChunks``: one CUDA graph per step function (AREAD's warm-up,
  bagging and final gate; the generic ``Trainer``'s step), captured once
  and replayed once per step. Its inputs are static device buffers for a
  whole chunk — the batches (or, with the split resident on the device,
  their row ids), the domain masks and the step's scalar blocks
  (``ops/sparse_adam.py::step_scalars``: lr, the bias corrections, the
  seed, which both Adam kernels and ``DenseAdam`` read) — staged in one
  asynchronous copy each; a step counter on the device picks the step's
  slice, and the step writes its loss and per-step outputs (AREAD's gate
  means) into static outputs at that slice. The losses are read once per
  chunk, on the device. A graph is made by PyTorch's whole-network recipe:
  a few eager steps on a side stream (they are the chunk's first steps,
  and they build the kernels and their scratch before the capture), then
  the capture, with the dropout generator registered so that each replay
  draws the next numbers. Host counters that a captured step would advance
  (the optimizer's ``t``, the dense leaves' ``count``) are put back after
  the capture and advanced once per replay; so are the kernels' launch
  counts (``ops/cuda.count_launch``). A capture that fails raises by name;
  nothing falls back to the eager loop.
* ``EagerChunks``: the same steps launched one by one, the loop the port
  always ran.

The candidates of a HEMP regroup (the JAX package's ``fast_adapt_many*``,
a whole regroup as one ``lax.map`` of chains) take the same two routes
(``run_chains``): a trainer stages every candidate's inputs in static
buffers and states its chain as a ``Chain``, whose body runs the candidate
that a device counter picks and writes its outputs at that slice; the
graph route captures the body once per (engine, feed form, S, P), after
its first candidates ran eagerly, and replays it once per candidate. A
chain sets its host counters (the fast optimizer's ``t`` and ``count``)
from zero, so each replay puts them where one chain leaves them.

Evaluation and serving, forward only, take the same two routes (the JAX
package jits its eval step, the streaming ``accum``, AREAD's
``eval_prob*``, ``all_tower_probs`` and the Predictor's per-bucket
programs): a trainer states a pass as an ``Eval`` (``run_eval``: its
batches staged ``SCAN_CHUNK`` at a time in static buffers, one
asynchronous copy per array, a device counter picking the batch, each
batch's output written at its slice of a static output that is read once
at the end of the pass, or added into static histograms), and a
``Predictor`` states a request as a ``Request`` (``serve``: the padded
rows copied into a static input, one replay, the static output read). A
pass's graph is captured after its first batches ran eagerly (after all
of a pass of one or two batches, for its next pass), a request's after
two eager calls of the first request of its (mode, shape); a pass is
captured again when it would read another object, shape, mode or final
flag, not when the weights were rewritten in place (a Predictor's model
and masks are its own and never change). An evaluation runs no
optimizer: ``eval_dispatch`` picks graphs on one CUDA device without a
mesh, and a trainer whose steps are graphs too evaluates through the
same runner (``Evals``), one memory pool for both.

A trainer states each of its step functions as a ``Step``
(``trainer.chunk_step(kind, state)``): the function, the keys of a host
feed, the host counters one step advances, its step count, learning rate
and betas, and what a captured step holds besides the model; and it turns
a feed into a batch (``trainer.feed_batch``). The configuration alone picks
the dispatch (``graph_dispatch``): the graph on one CUDA device, under
either table optimizer (``lazy_adam``'s touched-rows update keeps static
shapes and reads nothing back); the eager loop on the CPU and on a mesh
(its collectives are not captured: gloo stages them through the host).
Both leave the same bits. A trainer's ``chunks`` (``Chunks``) makes its
dispatch at the first chunk. ``MamdrTrainer`` runs each Reptile sequence
as chunks of its one step function (the JAX package jits
``_train_on_sequence``'s ``_train_step``), on one optimizer state that
``trainer.hybrid_reset_`` puts back to step 0 in place before each
sequence, so one graph serves every sequence of a fit; its merged
evaluation is one pass a domain.

A graph holds the storage of everything it touches: the model's tensors,
the optimizer state, the resident split and its domain -> group map. Mask
evolution, ``_load_best``, a warm start's or a resume's weights and the
best weights' reload write those in place, so a graph stays valid across
them, as do MAMDR's weight swaps and Reptile passes; a graph is captured
again when a step would read another tensor (a new optimizer state, a new
resident split, a regrouped domain -> group map of the resident split,
which is a new tensor as the JAX package's regroup drops its
``_epoch_scan``) or another learning rate. Host state that picks
the kernels, as ``matmul_precision_ctx``'s TF32 switch, is set inside the
step and so holds at the capture; a replay runs the kernels it picked.

Both runners record into the store of ``utils/profiling.py``, never inside
a captured body (a span there would run at the capture only): a chunk is a
``step_graph.run`` span with ``step_graph.stage``, its eager steps (and
every eager call before a capture) ``step_graph.eager``, a capture
``step_graph.capture``, a ``run_chains`` call ``step_graph.chains``. Each
step, chain and request replay is one span (``step_graph.replay``,
``step_graph.chain_replay``, ``serve.replay``: the clock pair just around
``graph.replay()``, which is also what the trainer's ``StepTimer`` reads)
inside one timing event pair on the card, the first replay of a call
flagged so that the gaps at call boundaries and within a call are told
apart. Eager steps, captures and replays are counted by kind; a runner's
``captures`` and ``eval_captures`` read its own share of the captures.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aread_tpu_torch.ops import cuda as cuda_ops
from aread_tpu_torch.ops.sparse_adam import chunk_scalars, to_device
from aread_tpu_torch.utils.profiling import STORE

# steps a chunk; the JAX package's SCAN_CHUNK
SCAN_CHUNK = 32
# eager steps on a side stream before a capture (PyTorch's recipe)
WARMUP_STEPS = 2


def graph_dispatch(trainer) -> bool:
    """Whether ``trainer``'s steps run as CUDA graphs: one CUDA device, no
    mesh."""
    return trainer.device.type == "cuda" and trainer.mesh is None


def eval_dispatch(owner) -> bool:
    """Whether ``owner``'s evaluation passes (a trainer's) or requests (a
    ``Predictor``'s) run as CUDA graphs: one CUDA device, no mesh."""
    return (owner.device.type == "cuda"
            and getattr(owner, "mesh", None) is None)


def make_chunks(trainer):
    """The dispatch ``trainer``'s configuration asks for."""
    return GraphChunks(trainer) if graph_dispatch(trainer) else \
        EagerChunks(trainer)


class Chunks:
    """A trainer's ``chunks``: the dispatch of its epochs' steps
    (``make_chunks``), made at the first use and kept in
    ``trainer._chunks``, which a new optimizer state sets back to None; the
    trainer's ``step_timer`` records which dispatch it is."""

    def __get__(self, trainer, owner=None):
        if trainer is None:
            return self
        if trainer._chunks is None:
            trainer._chunks = make_chunks(trainer)
            trainer.step_timer.dispatch = trainer._chunks.name
        return trainer._chunks


def make_evals(owner):
    """The dispatch ``owner``'s evaluation asks for: on a card its
    trainer's step runner where that replays graphs too (one memory pool
    for both), else a graph runner of its own; elsewhere the eager loop."""
    if not eval_dispatch(owner):
        return EagerChunks(owner)
    steps = getattr(owner, "chunks", None)
    return steps if isinstance(steps, GraphChunks) else GraphChunks(owner)


class Evals:
    """A trainer's or a ``Predictor``'s ``evals``: the dispatch of its
    evaluation passes or requests (``make_evals``), made at the first use
    and kept in ``owner._evals``, which a trainer's new optimizer state
    sets back to None with ``_chunks``."""

    def __get__(self, owner, cls=None):
        if owner is None:
            return self
        if owner._evals is None:
            owner._evals = make_evals(owner)
        return owner._evals


@dataclasses.dataclass
class Step:
    """One step function of a trainer, as a chunk runs it."""
    name: str                   # for messages: "AREAD main", ...
    fn: Callable                # (batch, dm, scalars) -> (loss, outputs)
    feed_keys: Tuple[str, ...]  # the arrays of a host feed
    counters: List[Tuple[Dict, str]]  # host counters a step advances
    count: int                  # the optimizer's step count before a step
    lr: float
    betas: Tuple[float, float]  # the optimizer's (b1, b2)
    holds: Tuple                # objects a captured step reads
    resident: Tuple = ()        # ... and, fed row ids, the resident split's
    lrs: Tuple = ()             # the learning rates it is captured with


@dataclasses.dataclass
class Chain:
    """One HEMP candidate chain of a trainer, as a regroup runs it
    (``AREADTrainer.chain_step``): ``fn`` runs the candidate that a device
    counter picks from the regroup's staged buffers, writes its outputs at
    that slice and advances the counter."""
    name: str                   # for messages: "HEMP full-sweep chain", ...
    key: str                    # its graph: engine, feed form, S and P
    fn: Callable[[], None]
    counters: List[Tuple[Dict, str]]  # host counters a chain sets
    holds: Tuple                # objects a captured chain reads
    lrs: Tuple                  # the learning rates it is captured with


@dataclasses.dataclass
class Eval:
    """One evaluation pass of a trainer, as both dispatches run it:
    ``fn`` scores one batch (its domain mask ``dm``, or None) in eval mode,
    with the mode and contexts set inside it, and returns the batch's
    per-row output, which the pass stacks [n, ...], or None where it adds
    into tensors that it holds (the streaming histograms)."""
    name: str                   # for messages: "AREAD evaluation", ...
    key: str                    # its graph, beside the batch's shapes
    fn: Callable                # (batch, dm) -> [B, ...] or None
    feed_keys: Tuple[str, ...]  # the arrays of a host batch it reads
    holds: Tuple = ()           # objects a captured pass reads


@dataclasses.dataclass
class Request:
    """One request of a ``Predictor``: ``fn`` maps its padded rows on the
    device [B, F] to their probabilities [B], reading nothing back to the
    host; one graph per ``key`` (the mode) and padded shape."""
    name: str                   # for messages: "mixed request", ...
    key: str
    fn: Callable[[torch.Tensor], torch.Tensor]


def stage_into(dst: torch.Tensor, arr: np.ndarray) -> None:
    """``arr`` into the leading rows of the buffer ``dst``: on a card one
    asynchronous copy from pinned memory (the caching host allocator keeps
    the pinned block until the copy has run)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst[:len(arr)].copy_(src, non_blocking=True)


# ----------------------------------------------------- the AREAD trainer
@dataclasses.dataclass
class Kind:
    """One step function of the AREAD trainer: ``mode`` is the model's
    mode, ``final`` the final-gate step (``final_core``)."""
    mode: str
    final: bool = False


KINDS = {"warmup": Kind("wo_mask"), "main": Kind("domain_mask_bagging"),
         "final": Kind("domain_mask_final", final=True)}
# a host feed of the AREAD steps (``pad_batch``)
AREAD_FEED = ("x", "y", "valid")


def step_fn(trainer, kind: str, state: Dict) -> Callable:
    """``(batch, dm, scalars) -> (loss, gate means)`` of one AREAD step of
    ``kind`` with the optimizer state ``state`` (the main state, or the
    final gate's)."""
    k = KINDS[kind]
    if k.final:
        return lambda batch, dm, scalars: trainer.final_core(
            state, batch, dm, scalars=scalars)
    return lambda batch, dm, scalars: trainer.step_core(
        trainer.optimizer, trainer.config.lr, state, k.mode, batch, dm,
        scalars=scalars)


def step_lr(trainer, kind: str) -> float:
    return trainer.config.final_lr if KINDS[kind].final else trainer.config.lr


def counters(kind: str, state: Dict) -> List[Tuple[Dict, str]]:
    """The host counters one AREAD step of ``kind`` advances: (dict,
    key)."""
    if KINDS[kind].final:
        return [(state, "count")]
    return [(state, "t"), (state["inner"], "count")]


def step_count(kind: str, state: Dict) -> int:
    """The optimizer's step count before the next step; the table's ``t``
    and the dense leaves' ``count`` move together."""
    if KINDS[kind].final:
        return state["count"]
    if state["t"] != state["inner"]["count"]:
        raise RuntimeError(f"the table's t={state['t']} and the dense "
                           f"leaves' count={state['inner']['count']} differ")
    return state["t"]


def aread_step(trainer, kind: str, state: Dict) -> Step:
    """``AREADTrainer.chunk_step``: its warm-up, bagging or final-gate
    step on ``state``."""
    opt = trainer.final_optimizer if KINDS[kind].final else trainer.optimizer
    data = trainer._device_data
    lr = step_lr(trainer, kind)
    return Step(name=f"AREAD {kind}", fn=step_fn(trainer, kind, state),
                feed_keys=AREAD_FEED, counters=counters(kind, state),
                count=step_count(kind, state), lr=lr, betas=(opt.b1, opt.b2),
                holds=(opt, state),
                resident=(None if data is None else data[0],),
                lrs=(opt.lr, lr))


# --------------------------------------------------- the generic Trainer
def trainer_step(trainer, kind: str, state: Dict) -> Step:
    """``Trainer.chunk_step``: the generic step (``kind`` 'train') on
    ``state``, fed a ``GlobalBatcher`` batch or row ids into the resident
    split."""
    if kind != "train":
        raise ValueError(f"the generic Trainer has no {kind!r} step")
    opt = trainer.optimizer
    data, d2g = trainer._device_data, trainer._device_d2g
    keys = ("x", "y", "valid", "domain") + (
        () if trainer.domain2group is None else ("group",))
    return Step(name="generic Trainer", fn=lambda batch, dm, scalars: (
        trainer.step_core(batch, scalars=scalars), ()),
        feed_keys=keys, counters=[(state, "t"), (state["inner"], "count")],
        count=step_count("main", state), lr=trainer.config.lr,
        betas=(opt.b1, opt.b2), holds=(opt, state),
        resident=(None if data is None else data[2],
                  None if d2g is None else d2g[1]),
        lrs=(opt.lr, trainer.config.lr))


_SIDE_STREAMS: Dict[str, object] = {}


def side_stream(dev):
    """The stream of the recipe's eager steps before a capture, one per
    device, kept: PyTorch keeps a cuBLAS workspace (64 MiB on the H100)
    for every stream that ran a product, so a new stream per capture
    would hold another workspace each time."""
    key = str(dev)
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[key]


def capture(graph, pool, fn: Callable) -> None:
    """Record one call of ``fn`` into ``graph``: CUDA stream capture, its
    allocations from the memory pool ``pool``; nothing runs."""
    with torch.cuda.graph(graph, pool=pool):
        fn()


def feed_examples(feed) -> int:
    """The rows a step's host feed holds."""
    if isinstance(feed, dict):
        return int(feed["valid"].sum())
    return int((np.asarray(feed) >= 0).sum())


def stage_ids(feeds, staged, dev) -> torch.Tensor:
    """[n, bs] int32 row ids of a chunk on ``dev``: ``staged`` when the
    caller staged them (a slice of a larger block already on the device),
    else the host ids in one asynchronous copy."""
    if staged is not None:
        return staged
    return to_device(np.stack(feeds).astype(np.int32), dev)


class EagerChunks:
    """The steps of a chunk launched one by one."""

    name = "eager"

    def __init__(self, trainer):
        # the trainer owns its runner: a weak reference, so that a dropped
        # trainer (its model, optimizer state and graphs) is freed at once
        self.tr = weakref.proxy(trainer)

    def run(self, kind: str, feeds: Sequence, masks: Sequence,
            state: Dict, staged: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Run ``len(feeds)`` steps of ``kind`` on ``state``. ``feeds``: per
        step its host batch or, with the split on the device, its host row
        ids (``staged``: the same ids already on the device, [n, bs]);
        ``masks``: per step its domain mask (None without one). Returns the
        losses [n] and the per-step outputs, each [n, ...], on the device,
        not fetched."""
        tr = self.tr
        with STORE.span("step_graph.run"):
            fn = tr.chunk_step(kind, state).fn
            if not isinstance(feeds[0], dict):
                with STORE.span("step_graph.stage"):
                    staged = stage_ids(feeds, staged, tr.device)
            losses, outs = [], []
            for j, (feed, mask) in enumerate(zip(feeds, masks)):
                STORE.count("step.eager")
                with tr.step_timer.step(feed_examples(feed),
                                        "step_graph.eager"):
                    batch = tr.feed_batch(feed if staged is None
                                          else staged[j])
                    loss, out = fn(batch, mask, None)
                losses.append(loss)
                outs.append(out)
            return torch.stack(losses), tuple(torch.stack(x)
                                              for x in zip(*outs))

    @staticmethod
    def run_chains(chain: Chain, n: int) -> None:
        """Run ``n`` candidates of a staged regroup, one ``chain.fn`` each."""
        with STORE.span("step_graph.chains"):
            for _ in range(n):
                STORE.count("chain.eager")
                with STORE.span("step_graph.eager"):
                    chain.fn()

    @torch.no_grad()
    def run_eval(self, ev: Eval, feeds: Sequence[Dict],
                 masks: Optional[Sequence] = None
                 ) -> Optional[torch.Tensor]:
        """One evaluation pass: ``ev.fn`` on each host batch of ``feeds``
        (its ``ev.feed_keys``, placed: on a mesh this rank's rows) with its
        domain mask (``masks``: per batch, or None). Returns the batches'
        outputs [n, ...] on the device, not fetched, or None where
        ``ev.fn`` returns none."""
        place = self.tr.place
        outs = []
        for j, feed in enumerate(feeds):
            out = ev.fn(place({k: feed[k] for k in ev.feed_keys}),
                        None if masks is None else masks[j])
            if out is not None:
                outs.append(out)
        return torch.stack(outs) if outs else None

    def serve(self, req: Request, xb: np.ndarray) -> torch.Tensor:
        """One request: ``req.fn`` on the padded rows ``xb``, copied to the
        device."""
        with STORE.span("serve.copy_in"):
            x = torch.from_numpy(xb).to(self.tr.device)
        STORE.count("request.eager")
        with STORE.span("step_graph.eager"):
            return req.fn(x)


@dataclasses.dataclass
class _Graph:
    """One captured step or chain and what it reads and writes."""
    graph: object
    holds: Tuple          # the objects it reads (``GraphChunks._reads``)
    lrs: Tuple            # the learning rates it was captured with
    launches: Dict[str, int]  # kernel launches per replay
    # the host counters as the captured call left them: where a chain's
    # replay puts them (a step's replay advances each by one instead)
    sets: List


class GraphChunks:
    """The steps of a chunk as replays of a captured CUDA graph (one per
    step function and feed form), on static chunk buffers; and the
    candidates of a HEMP regroup as replays of one captured chain each."""

    name = "graph"

    def __init__(self, trainer):
        self.tr = weakref.proxy(trainer)  # as EagerChunks'
        self.dev = trainer.device
        self.graphs: Dict[str, _Graph] = {}
        # this runner's captures, re-captures included, counted into the
        # store (``captures`` and ``eval_captures`` read them)
        self._captured = {k: STORE.counter(f"{k}.captures")
                          for k in ("step", "chain", "eval", "request")}
        # replays on a card record device event pairs (utils/profiling.py)
        self.timed = self.dev.type == "cuda"
        self.pool = None
        self.buf: Dict[str, object] = {}

    @property
    def captures(self) -> int:
        """Graphs captured of steps and chains."""
        return self._captured["step"].n + self._captured["chain"].n

    @property
    def eval_captures(self) -> int:
        """Graphs captured of evaluation passes and requests."""
        return self._captured["eval"].n + self._captured["request"].n

    # ----------------------------------------------------------- buffers
    def _buffers(self, key, step: Step, feeds, masks) -> Dict:
        """The static buffers of a graph (``key``: its step function and
        feed form), made at its first chunk: inputs for ``SCAN_CHUNK``
        steps, the step counter; the outputs follow at its first step."""
        buf = self.buf.get(key)
        if buf is not None:
            return buf
        S, dev = SCAN_CHUNK, self.dev
        first = feeds[0]
        buf = {"i": torch.zeros((1,), dtype=torch.int64, device=dev),
               "scalars": torch.zeros((S, 4), dtype=torch.int32, device=dev)}
        if isinstance(first, dict):
            buf["feed"] = {}
            for k in step.feed_keys:
                a = np.asarray(first[k])
                buf["feed"][k] = torch.empty(
                    (S,) + a.shape, dtype=torch.from_numpy(a).dtype,
                    device=dev)
        else:
            buf["ids"] = torch.empty((S,) + np.shape(first),
                                     dtype=torch.int32, device=dev)
        buf["masks"] = (None if masks[0] is None else
                        [torch.empty((S,) + np.shape(m), dtype=torch.bool,
                                     device=dev) for m in masks[0]])
        self.buf[key] = buf
        return buf

    def _stage(self, buf: Dict, kind: str, feeds, masks, state: Dict,
               staged: Optional[torch.Tensor] = None) -> None:
        """The chunk's inputs into the static buffers: one asynchronous copy
        each (the batches' arrays or their row ids, each layer's masks, the
        scalar blocks), and the step counter to 0."""
        n = len(feeds)
        step = self.tr.chunk_step(kind, state)
        if "ids" in buf:
            buf["ids"][:n].copy_(stage_ids(feeds, staged, self.dev))
        else:
            for k, dst in buf["feed"].items():
                dst[:n].copy_(to_device(
                    np.stack([np.asarray(f[k]) for f in feeds]), self.dev))
        if buf["masks"] is not None:
            for li, dst in enumerate(buf["masks"]):
                dst[:n].copy_(to_device(
                    np.stack([np.asarray(m[li], dtype=bool) for m in masks]),
                    self.dev))
        buf["scalars"][:n].copy_(to_device(
            chunk_scalars(step.count, n, step.lr, *step.betas), self.dev))
        buf["i"].zero_()

    def _body(self, kind: str, buf: Dict, state: Dict) -> Callable:
        """One step that reads its inputs at the device counter's slice of
        the static buffers and writes its loss and outputs there."""
        tr = self.tr
        fn = tr.chunk_step(kind, state).fn

        def body():
            i = buf["i"]
            if "ids" in buf:
                batch = tr.feed_batch(buf["ids"].index_select(0, i)[0])
            else:
                batch = {k: v.index_select(0, i)[0]
                         for k, v in buf["feed"].items()}
            dm = (None if buf["masks"] is None else
                  tuple(m.index_select(0, i)[0] for m in buf["masks"]))
            loss, outs = fn(batch, dm, buf["scalars"].index_select(0, i)[0])
            if "loss" not in buf:
                # the outputs, shaped at the first (eager) step
                buf["loss"] = torch.zeros((SCAN_CHUNK,), dtype=loss.dtype,
                                          device=self.dev)
                buf["outs"] = [torch.zeros((SCAN_CHUNK,) + tuple(g.shape),
                                           dtype=g.dtype, device=self.dev)
                               for g in outs]
            buf["loss"].index_copy_(0, i, loss.reshape(1))
            for out, g in zip(buf["outs"], outs):
                out.index_copy_(0, i, g[None])
            i.add_(1)

        return body

    @staticmethod
    def _reads(step: Step, idx: bool) -> Tuple:
        """The objects a captured step holds besides the model: its
        optimizer and state and, fed row ids, the resident split."""
        return step.holds + (step.resident if idx else ())

    def _current(self, key: str, holds: Tuple, lrs: Tuple
                 ) -> Optional[_Graph]:
        """The graph of ``key`` if it still reads what a step (or chain)
        would read now: the same objects ``holds`` and learning rates."""
        g = self.graphs.get(key)
        if g is None:
            return None
        if lrs != g.lrs or len(holds) != len(g.holds) or any(
                a is not b for a, b in zip(holds, g.holds)):
            return None
        return g

    def _capture(self, kind: str, what: str, counters, body: Callable,
                 holds: Tuple, lrs: Tuple, generator=None) -> _Graph:
        """Capture one call of ``body`` (``kind``: 'step', 'chain', 'eval'
        or 'request', counted; ``what``: the step, chain, pass or request,
        for the message), ``generator`` (dropout's, for steps and chains)
        registered with the graph; the host counters and launch counts that
        the capture advanced are put back, and a chain's end values kept
        for its replays."""
        if generator is not None and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a torch.Generator with a CUDA "
                "graph (CUDAGraph.register_generator_state): the captured "
                "step's dropout would replay one mask")
        saved = [(d, k, d[k]) for d, k in counters]
        for k in cuda_ops.captured_counts:
            cuda_ops.captured_counts[k] = 0
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        try:
            with STORE.span("step_graph.capture"):
                capture(graph, self.pool, body)
            sets = [d[k] for d, k in counters]
        except Exception as e:
            raise RuntimeError(f"capturing the {what} into a CUDA graph "
                               f"failed: {e}") from e
        finally:
            for d, k, v in saved:
                d[k] = v
        self._captured[kind].add()
        return _Graph(graph=graph, holds=holds, lrs=lrs,
                      launches=dict(cuda_ops.captured_counts), sets=sets)

    def _eager_first(self, kind: str, fn: Callable, n: int,
                     examples=None) -> int:
        """The recipe's eager calls on a side stream before a capture: the
        first ``min(WARMUP_STEPS, n)`` steps, chains, batches or requests
        (``kind``), real ones (with ``examples``, each step timed), each a
        span and counted. Returns how many ran."""
        warm = min(WARMUP_STEPS, n)
        side = side_stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            for j in range(warm):
                STORE.count(kind + ".eager")
                with (STORE.span("step_graph.eager") if examples is None
                      else self.tr.step_timer.step(examples[j],
                                                   "step_graph.eager")):
                    fn()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        return warm

    def _count_replay(self, g: _Graph) -> None:
        for k, c in g.launches.items():
            cuda_ops.launch_counts[k] += c

    def run(self, kind: str, feeds: Sequence, masks: Sequence,
            state: Dict, staged: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``EagerChunks.run`` as graph replays: at most ``SCAN_CHUNK``
        steps."""
        n = len(feeds)
        if not 0 < n <= SCAN_CHUNK:
            raise ValueError(f"a chunk holds 1 to {SCAN_CHUNK} steps, not {n}")
        with STORE.span("step_graph.run"):
            tr = self.tr
            step = tr.chunk_step(kind, state)
            # a graph per step function and feed form: host batches, or row ids
            # into the resident split (the JAX package's scan and index scan)
            idx = not isinstance(feeds[0], dict)
            key = f"{kind}_idx" if idx else kind
            buf = self._buffers(key, step, feeds, masks)
            with STORE.span("step_graph.stage"):
                self._stage(buf, kind, feeds, masks, state, staged)
            examples = [feed_examples(f) for f in feeds]
            body = self._body(kind, buf, state)
            done = 0
            holds = self._reads(step, idx)
            g = self._current(key, holds, step.lrs)
            if g is None:
                done = self._eager_first("step", body, n, examples)
                if done == n:
                    return self._outputs(buf, n)
                self.graphs.pop(key, None)
                g = self.graphs[key] = self._capture(
                    "step", f"{step.name} step", step.counters, body, holds,
                    step.lrs, tr.generator)
            timer = tr.step_timer
            for j in range(done, n):
                timer.add(STORE.replay("step", g.graph, j == done, self.timed),
                          examples[j])
                for d, k in step.counters:
                    d[k] += 1
                self._count_replay(g)
            return self._outputs(buf, n)

    def run_chains(self, chain: Chain, n: int) -> None:
        """``EagerChunks.run_chains`` as replays of the chain's graph: its
        first candidates run eagerly when it is (re)captured, the rest are
        one replay each."""
        with STORE.span("step_graph.chains"):
            done = 0
            g = self._current(chain.key, chain.holds, chain.lrs)
            if g is None:
                done = self._eager_first("chain", chain.fn, n)
                if done == n:
                    return
                self.graphs.pop(chain.key, None)
                g = self.graphs[chain.key] = self._capture(
                    "chain", chain.name, chain.counters, chain.fn,
                    chain.holds, chain.lrs, self.tr.generator)
            for j in range(done, n):
                STORE.replay("chain", g.graph, j == done, self.timed)
                for (d, k), v in zip(chain.counters, g.sets):
                    d[k] = v
                self._count_replay(g)

    # ------------------------------------------------- evaluation passes
    @staticmethod
    def eval_key(ev: Eval, feed: Dict, mask) -> str:
        """The graph and buffers of a pass: its ``ev.key`` and the shapes
        of a batch's arrays and masks."""
        shapes = [f"{k}{list(np.shape(feed[k]))}" for k in ev.feed_keys]
        if mask is not None:
            shapes += [f"dm{list(np.shape(m))}" for m in mask]
        return f"eval {ev.key} {' '.join(shapes)}"

    def eval_buffers(self, key: str, ev: Eval, feed: Dict, mask) -> Dict:
        """The static buffers of a pass's graph, made at its first pass:
        inputs for ``SCAN_CHUNK`` batches and their masks, the counters of
        the chunk's batch (``i``) and of the pass's (``o``); the output
        follows at the first batch."""
        buf = self.buf.get(key)
        if buf is not None:
            return buf
        S, dev = SCAN_CHUNK, self.dev
        buf = {"i": torch.zeros((1,), dtype=torch.int64, device=dev),
               "o": torch.zeros((1,), dtype=torch.int64, device=dev),
               "feed": {k: torch.empty(
                   (S,) + np.shape(feed[k]),
                   dtype=torch.from_numpy(np.asarray(feed[k])).dtype,
                   device=dev) for k in ev.feed_keys},
               "masks": None if mask is None else [
                   torch.empty((S,) + np.shape(m), dtype=torch.bool,
                               device=dev) for m in mask]}
        self.buf[key] = buf
        return buf

    @staticmethod
    def stage_eval(buf: Dict, feeds: Sequence[Dict], masks) -> None:
        """A chunk of a pass's batches into the static buffers, one
        asynchronous copy per array and mask level, and the chunk's
        counter to 0."""
        for k, dst in buf["feed"].items():
            stage_into(dst, np.stack([np.asarray(f[k]) for f in feeds]))
        if buf["masks"] is not None:
            for li, dst in enumerate(buf["masks"]):
                stage_into(dst, np.stack([np.asarray(m[li], dtype=bool)
                                          for m in masks]))
        buf["i"].zero_()

    def eval_body(self, ev: Eval, buf: Dict) -> Callable:
        """One batch that reads its inputs at the chunk counter's slice and
        writes its output at the pass counter's slice of the static
        output."""
        dev = self.dev

        def body():
            i, o = buf["i"], buf["o"]
            batch = {k: v.index_select(0, i)[0]
                     for k, v in buf["feed"].items()}
            dm = (None if buf["masks"] is None else
                  tuple(m.index_select(0, i)[0] for m in buf["masks"]))
            out = ev.fn(batch, dm)
            if out is not None:
                if "out" not in buf:
                    # shaped at the first (eager) batch, for the pass
                    buf["out"] = torch.zeros((buf["n"],) + tuple(out.shape),
                                             dtype=out.dtype, device=dev)
                buf["out"].index_copy_(0, o, out[None])
            i.add_(1)
            o.add_(1)

        return body

    @staticmethod
    def _eval_reads(ev: Eval, buf: Dict) -> Tuple:
        return ev.holds + (buf.get("out"),)

    @torch.no_grad()
    def run_eval(self, ev: Eval, feeds: Sequence[Dict],
                 masks: Optional[Sequence] = None
                 ) -> Optional[torch.Tensor]:
        """``EagerChunks.run_eval`` as graph replays: the batches staged
        ``SCAN_CHUNK`` at a time, one replay each; at a (re)capture the
        first ``WARMUP_STEPS`` batches run eagerly, and a pass no longer
        than that captures after them, for its next pass. The output
        [n, ...] is a view of the static output: read it before the next
        pass of this graph."""
        n = len(feeds)
        if n == 0:
            return None
        masks = [None] * n if masks is None else list(masks)
        key = self.eval_key(ev, feeds[0], masks[0])
        buf = self.eval_buffers(key, ev, feeds[0], masks[0])
        if "out" in buf and buf["out"].shape[0] < n:
            del buf["out"]  # a longer pass: a larger output, a new capture
        if "out" not in buf:
            buf["n"] = n
        buf["o"].zero_()
        body = self.eval_body(ev, buf)
        g = self._current(key, self._eval_reads(ev, buf), ())
        for lo in range(0, n, SCAN_CHUNK):
            m = min(SCAN_CHUNK, n - lo)
            self.stage_eval(buf, feeds[lo:lo + m], masks[lo:lo + m])
            done = 0
            if g is None:
                done = self._eager_first("eval", body, m)
                self.graphs.pop(key, None)
                g = self.graphs[key] = self._capture(
                    "eval", ev.name, [], body, self._eval_reads(ev, buf), ())
            for _ in range(done, m):
                g.graph.replay()
                self._count_replay(g)
        out = buf.get("out")
        return None if out is None else out[:n]

    # ----------------------------------------------------------- requests
    @staticmethod
    def serve_body(req: Request, buf: Dict) -> Callable:
        """A request on the static input, its probabilities copied into the
        static output."""
        def body():
            prob = req.fn(buf["x"])
            if "out" not in buf:
                buf["out"] = torch.empty_like(prob)  # at the first call
            buf["out"].copy_(prob)

        return body

    def serve(self, req: Request, xb: np.ndarray) -> torch.Tensor:
        """``EagerChunks.serve`` as a replay: the padded rows copied into
        the static input of the request's (mode, shape) in one copy, then
        one replay. The first request of a (mode, shape) runs eagerly
        ``WARMUP_STEPS`` times (the same answer each time) and captures.
        Returns the static output: read it before the next request."""
        key = f"serve {req.key} {list(xb.shape)}"
        buf = self.buf.get(key)
        if buf is None:
            buf = self.buf[key] = {"x": torch.empty(
                xb.shape, dtype=torch.from_numpy(xb).dtype, device=self.dev)}
        with STORE.span("serve.copy_in"):
            buf["x"].copy_(torch.from_numpy(xb))
        g = self.graphs.get(key)
        if g is None:
            body = self.serve_body(req, buf)
            self._eager_first("request", body, WARMUP_STEPS)
            self.graphs[key] = self._capture("request", req.name, [], body,
                                             (), ())
        else:
            # one unit: the request's own id, from its enclosing span
            STORE.replay("request", g.graph, True, self.timed,
                         STORE.current_uid())
            self._count_replay(g)
        return buf["out"]

    @staticmethod
    def _outputs(buf: Dict, n: int):
        # copies: the next chunk overwrites the static outputs
        return (buf["loss"][:n].clone(),
                tuple(g[:n].clone() for g in buf["outs"]))
