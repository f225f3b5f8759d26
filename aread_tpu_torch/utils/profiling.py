"""Tracing and step timing (counterpart of ``aread_tpu/utils/profiling.py``).

* ``StepTimer``: rolling host-clock stats per training step. On the card
  a step returns when its kernels are queued, not when they have run, so
  a ``StepTimer`` around an unsynchronised step times the launches; the
  trainers' ``examples_per_s`` therefore divides an epoch's rows by the
  epoch's synchronised seconds instead.
* ``trace(log_dir)``: ``torch.profiler.profile`` over the block, with the
  CUDA activity on a machine with a card, written as a Chrome trace
  (``<log_dir>/<host>_<pid>_<ms>.pt.trace.json``) that TensorBoard's
  profiler plugin and Perfetto load. A no-op unless ``log_dir`` or the
  variable ``AREAD_TPU_TRACE`` is set: the JAX package reads the same
  variable, so one setting traces a run of either package.
* ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``) and, on a machine with a card, in
  an NVTX timeline.

The JAX package's ``start_server`` (its on-demand profiler server) has no
counterpart in torch and is not ported.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch


class StepTimer:
    """Rolling wall-clock stats for a training loop.

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

    @contextlib.contextmanager
    def step(self, n_examples: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.durations.append(dt)
            self.examples.append(n_examples)
            self.total_steps += 1
            self.total_time += dt
            self.total_examples += n_examples

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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range around the block in the profiler's trace and, on a
    machine with a card, in the NVTX timeline."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
