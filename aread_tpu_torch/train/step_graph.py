"""Chunks of training steps, each chunk in as few dispatches as the device
allows (counterpart of ``make_scan`` / ``make_scan_idx`` and of the
``SCAN_CHUNK`` chunk loop of ``aread_tpu/train/hemp.py``).

The JAX package runs ``SCAN_CHUNK`` steps of a segment as one jitted
``lax.scan``, because a step launched from Python pays host dispatch
several times the device step itself. The same holds for the port: an
AREAD step is some 1,200 small launches, and the card sits idle while the
host issues them. The counterpart of a jitted program replayed over a
chunk is a captured CUDA graph. Two dispatches run a chunk:

* ``GraphChunks``: one CUDA graph per step function (warm-up, bagging,
  final gate), captured once and replayed once per step. Its inputs are
  static device buffers for a whole chunk — the batches (or, with the
  split resident on the device, their row ids), the domain masks and the
  step's scalar blocks (``ops/sparse_adam.py::step_scalars``: lr, the bias
  corrections, the seed) — staged in one asynchronous copy each; a step
  counter on the device picks the step's slice, and the step writes its
  loss and gate means into static outputs at that slice. The losses and
  gate means are read once per chunk, on the device. A graph is made by
  PyTorch's whole-network recipe: a few eager steps on a side stream (they
  are the chunk's first steps, and they build kernel 1 and its scratch
  before the capture), then the capture, with the dropout generator
  registered so that each replay draws the next numbers. Host counters
  that a captured step would advance (the optimizer's ``t``, the dense
  leaves' ``count``) are put back after the capture and advanced once per
  replay; so are the kernels' launch counts (``ops/cuda.count_launch``).
  A capture that fails raises; nothing falls back to the eager loop.
* ``EagerChunks``: the same steps launched one by one, the loop the port
  always ran.

The configuration alone picks (``graph_dispatch``): the graph on one CUDA
device with ``table_optimizer='adam'``; the eager loop on the CPU, on a
mesh (its collectives are not captured: gloo stages them through the
host) and with ``lazy_adam`` (whose update waits for the device). Both
leave the same bits.

A graph holds the storage of everything it touches: the model's tensors,
the optimizer state, the resident split. Mask evolution, ``_load_best``
and ``_resume`` write those in place, so a graph stays valid across them;
a graph is captured again when a step would read another tensor (a new
optimizer state, a new resident split) or another learning rate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aread_tpu_torch.ops import cuda as cuda_ops
from aread_tpu_torch.ops.sparse_adam import chunk_scalars, to_device

# steps a chunk; the JAX package's SCAN_CHUNK
SCAN_CHUNK = 32
# eager steps on a side stream before a capture (PyTorch's recipe)
WARMUP_STEPS = 2


def graph_dispatch(trainer) -> bool:
    """Whether ``trainer``'s steps run as CUDA graphs: one CUDA device, no
    mesh, the dense-semantics table Adam."""
    return (trainer.device.type == "cuda" and trainer.mesh is None
            and trainer.config.table_optimizer == "adam")


def make_chunks(trainer):
    """The dispatch ``trainer``'s configuration asks for."""
    return GraphChunks(trainer) if graph_dispatch(trainer) else \
        EagerChunks(trainer)


@dataclasses.dataclass
class Kind:
    """One step function of the AREAD trainer: ``mode`` is the model's
    mode, ``final`` the final-gate step (``final_core``)."""
    mode: str
    final: bool = False


KINDS = {"warmup": Kind("wo_mask"), "main": Kind("domain_mask_bagging"),
         "final": Kind("domain_mask_final", final=True)}


def step_fn(trainer, kind: str, state: Dict) -> Callable:
    """``(batch, dm, scalars) -> (loss, gate means)`` of one step of
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
    """The host counters one step of ``kind`` advances: (dict, key)."""
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


def capture(graph, pool, fn: Callable) -> None:
    """Record one call of ``fn`` into ``graph``: CUDA stream capture, its
    allocations from the memory pool ``pool``; nothing runs."""
    with torch.cuda.graph(graph, pool=pool):
        fn()


class EagerChunks:
    """The steps of a chunk launched one by one."""

    name = "eager"

    def __init__(self, trainer):
        self.tr = trainer

    def run(self, kind: str, feeds: Sequence, masks: Sequence,
            state: Dict) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Run ``len(feeds)`` steps of ``kind`` on ``state``. ``feeds``: per
        step its host batch (x, y, valid) or, with the split on the device,
        its row ids; ``masks``: per step its domain mask (None in the
        warm-up). Returns the losses [n] and the gate means, each [n, ...],
        on the device, not fetched."""
        tr = self.tr
        fn = step_fn(tr, kind, state)
        losses, gms = [], []
        for feed, mask in zip(feeds, masks):
            with tr.step_timer.step(n_examples=feed_examples(feed)):
                loss, g = fn(tr.feed_batch(feed), mask, None)
            losses.append(loss)
            gms.append(g)
        return torch.stack(losses), tuple(torch.stack(x) for x in zip(*gms))


def feed_examples(feed) -> int:
    """The rows a step's feed holds."""
    if isinstance(feed, dict):
        return int(feed["valid"].sum())
    return int((feed >= 0).sum())


@dataclasses.dataclass
class _Graph:
    """One captured step and what it reads and writes."""
    graph: object
    holds: Tuple          # the objects it reads (``GraphChunks._reads``)
    lrs: Tuple            # the learning rates it was captured with
    launches: Dict[str, int]  # kernel launches per replay


class GraphChunks:
    """The steps of a chunk as replays of a captured CUDA graph (one per
    step function), on static chunk buffers."""

    name = "graph"

    def __init__(self, trainer):
        self.tr = trainer
        self.dev = trainer.device
        self.graphs: Dict[str, _Graph] = {}
        self.pool = None
        self.buf: Dict[str, object] = {}

    # ----------------------------------------------------------- buffers
    def _buffers(self, key, feeds, masks) -> Dict:
        """The static buffers of a graph (``key``: its step function and
        feed), made at its first chunk: inputs for ``SCAN_CHUNK`` steps,
        the step counter; the outputs follow at its first step."""
        buf = self.buf.get(key)
        if buf is not None:
            return buf
        S, dev = SCAN_CHUNK, self.dev
        first = feeds[0]
        buf = {"i": torch.zeros((1,), dtype=torch.int64, device=dev),
               "scalars": torch.zeros((S, 4), dtype=torch.int32, device=dev)}
        if isinstance(first, dict):
            for k in ("x", "y", "valid"):
                a = np.asarray(first[k])
                buf[k] = torch.empty((S,) + a.shape,
                                     dtype=torch.from_numpy(a).dtype,
                                     device=dev)
        else:
            buf["ids"] = torch.empty((S,) + first.shape, dtype=torch.int32,
                                     device=dev)
        buf["masks"] = (None if masks[0] is None else
                        [torch.empty((S,) + np.shape(m), dtype=torch.bool,
                                     device=dev) for m in masks[0]])
        self.buf[key] = buf
        return buf

    def _stage(self, buf: Dict, kind: str, feeds, masks, state: Dict) -> None:
        """The chunk's inputs into the static buffers: one asynchronous copy
        each (the batches or their row ids, each layer's masks, the scalar
        blocks), and the step counter to 0."""
        n = len(feeds)
        tr = self.tr
        if "ids" in buf:
            buf["ids"][:n].copy_(to_device(
                np.stack(feeds).astype(np.int32), self.dev))
        else:
            for k in ("x", "y", "valid"):
                buf[k][:n].copy_(to_device(
                    np.stack([np.asarray(f[k]) for f in feeds]), self.dev))
        if buf["masks"] is not None:
            for li, dst in enumerate(buf["masks"]):
                dst[:n].copy_(to_device(
                    np.stack([np.asarray(m[li], dtype=bool) for m in masks]),
                    self.dev))
        opt = tr.final_optimizer if KINDS[kind].final else tr.optimizer
        buf["scalars"][:n].copy_(to_device(
            chunk_scalars(step_count(kind, state), n, step_lr(tr, kind),
                          opt.b1, opt.b2), self.dev))
        buf["i"].zero_()

    def _body(self, kind: str, buf: Dict, state: Dict) -> Callable:
        """One step that reads its inputs at the device counter's slice of
        the static buffers and writes its loss and gate means there."""
        tr = self.tr
        fn = step_fn(tr, kind, state)

        def body():
            i = buf["i"]
            if "ids" in buf:
                batch = tr.feed_batch(buf["ids"].index_select(0, i)[0])
            else:
                batch = {k: buf[k].index_select(0, i)[0]
                         for k in ("x", "y", "valid")}
            dm = (None if buf["masks"] is None else
                  tuple(m.index_select(0, i)[0] for m in buf["masks"]))
            loss, gms = fn(batch, dm, buf["scalars"].index_select(0, i)[0])
            if "loss" not in buf:
                # the outputs, shaped at the first (eager) step
                buf["loss"] = torch.zeros((SCAN_CHUNK,), dtype=loss.dtype,
                                          device=self.dev)
                buf["gms"] = [torch.zeros((SCAN_CHUNK,) + tuple(g.shape),
                                          dtype=g.dtype, device=self.dev)
                              for g in gms]
            buf["loss"].index_copy_(0, i, loss.reshape(1))
            for out, g in zip(buf["gms"], gms):
                out.index_copy_(0, i, g[None])
            i.add_(1)

        return body

    def _reads(self, kind: str, state: Dict) -> Tuple[Tuple, Tuple]:
        """What a captured step of ``kind`` holds besides the model: the
        optimizer, its state and the resident split (objects), and the
        learning rates (the optimizer's, the table's)."""
        tr = self.tr
        opt = tr.final_optimizer if KINDS[kind].final else tr.optimizer
        data = tr._device_data
        return ((opt, state, None if data is None else data[0]),
                (opt.lr, step_lr(tr, kind)))

    def _current(self, key: str, kind: str, state: Dict) -> Optional[_Graph]:
        """The graph of ``key`` if it still reads what a step would read
        now."""
        g = self.graphs.get(key)
        if g is None:
            return None
        holds, lrs = self._reads(kind, state)
        if lrs != g.lrs or any(a is not b for a, b in zip(holds, g.holds)):
            return None
        return g

    def _capture(self, kind: str, body: Callable, state: Dict) -> _Graph:
        """Capture one step of ``body``; the host counters and launch counts
        that the capture advanced are put back."""
        tr = self.tr
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a torch.Generator with a CUDA "
                "graph (CUDAGraph.register_generator_state): the captured "
                "step's dropout would replay one mask")
        saved = [(d, k, d[k]) for d, k in counters(kind, state)]
        for k in cuda_ops.captured_counts:
            cuda_ops.captured_counts[k] = 0
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(tr.generator)
        try:
            capture(graph, self.pool, body)
        except Exception as e:
            raise RuntimeError(f"capturing the AREAD {kind} step into a CUDA "
                               f"graph failed: {e}") from e
        finally:
            for d, k, v in saved:
                d[k] = v
        holds, lrs = self._reads(kind, state)
        return _Graph(graph=graph, holds=holds, lrs=lrs,
                      launches=dict(cuda_ops.captured_counts))

    def run(self, kind: str, feeds: Sequence, masks: Sequence,
            state: Dict) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``EagerChunks.run`` as graph replays: at most ``SCAN_CHUNK``
        steps."""
        n = len(feeds)
        if not 0 < n <= SCAN_CHUNK:
            raise ValueError(f"a chunk holds 1 to {SCAN_CHUNK} steps, not {n}")
        tr = self.tr
        # a graph per step function and feed: host batches, or row ids into
        # the resident split (the JAX package's make_scan / make_scan_idx)
        key = kind if isinstance(feeds[0], dict) else f"{kind}_idx"
        buf = self._buffers(key, feeds, masks)
        self._stage(buf, kind, feeds, masks, state)
        examples = [feed_examples(f) for f in feeds]
        body = self._body(kind, buf, state)
        done = 0
        g = self._current(key, kind, state)
        if g is None:
            # the recipe's eager steps on a side stream: the chunk's first
            # steps, real ones
            warm = min(WARMUP_STEPS, n)
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(side):
                for _ in range(warm):
                    with tr.step_timer.step(n_examples=examples[done]):
                        body()
                    done += 1
            torch.cuda.current_stream(self.dev).wait_stream(side)
            if done == n:
                return self._outputs(buf, n)
            self.graphs.pop(key, None)
            g = self.graphs[key] = self._capture(kind, body, state)
        for j in range(done, n):
            with tr.step_timer.step(n_examples=examples[j]):
                g.graph.replay()
            for d, k in counters(kind, state):
                d[k] += 1
            for k, c in g.launches.items():
                cuda_ops.launch_counts[k] += c
        return self._outputs(buf, n)

    @staticmethod
    def _outputs(buf: Dict, n: int):
        # copies: the next chunk overwrites the static outputs
        return (buf["loss"][:n].clone(),
                tuple(g[:n].clone() for g in buf["gms"]))
