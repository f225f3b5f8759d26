"""Failure detection (counterpart of ``aread_tpu/parallel/health.py``).

* ``watchdog(timeout_s, tag)``: a context manager whose daemon timer
  records a breach when the wrapped block runs past ``timeout_s`` (and,
  with ``kill_process``, prints and hard-exits with code 42, so that an
  orchestrator can reschedule a job whose epoch never returns); the block
  raises ``HealthError`` when it does return. The trainers wrap each
  train epoch in one (``config.epoch_timeout_s``).
* ``epoch_deadline``: the per-epoch deadline, with a grace for the first
  wrapped epoch of the process.
* ``barrier``: a cross-process rendezvous with a deadline
  (``torch.distributed.barrier``, ``monitored_barrier`` under gloo, which
  names the rank that did not arrive), guarded by the watchdog; a no-op
  in a single process. The trainers of a mesh run meet at it before and
  after each checkpoint write.

A CUDA call that hangs cannot be interrupted from Python either, so the
timer thread is the escape here as it is in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional


class HealthError(RuntimeError):
    """A watchdog deadline expired (a stalled epoch or a rank that did not
    reach a barrier)."""


@contextlib.contextmanager
def watchdog(timeout_s: Optional[float], tag: str = "",
             kill_process: bool = False) -> Iterator[None]:
    """Raise ``HealthError`` when the block has run longer than
    ``timeout_s`` (None or 0: no watchdog). The timer fires on a daemon
    thread: it records the breach, so that the block raises as soon as it
    returns, and with ``kill_process`` hard-exits the process (code 42)."""
    if not timeout_s:
        yield
        return
    breached = threading.Event()
    completed = threading.Event()

    def _fire():
        # a block that already returned (``completed`` is set before
        # cancel()) is neither flagged nor killed: the timer may fire in
        # the gap between the two
        if completed.is_set():
            return
        breached.set()
        print(f"[aread_tpu_torch.health] watchdog '{tag}' exceeded "
              f"{timeout_s}s (process {os.getpid()})", flush=True)
        if kill_process and not completed.is_set():
            os._exit(42)

    timer = threading.Timer(timeout_s, _fire)
    timer.daemon = True
    timer.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        # set here so that an exception leaving the block counts as
        # completed too: the kill is for work that never returns, and
        # must not mask a traceback that is on its way out
        completed.set()
        timer.cancel()
    if breached.is_set():
        raise HealthError(
            f"watchdog '{tag}': block took {time.perf_counter() - t0:.1f}s "
            f"(> {timeout_s}s deadline)")


# whether this process has handed out its first-epoch grace
_first_epoch_done = False


def epoch_deadline(timeout_s: Optional[float],
                   first_mult: float = 5.0) -> Optional[float]:
    """The watchdog deadline of the next train epoch: ``timeout_s``, and
    ``timeout_s * max(first_mult, 1)`` for the first wrapped epoch of the
    process, which pays the cold start (on the card: CUDA context
    creation, the first build of the kernels, the caching allocator's
    first blocks). Process-global, because the cold start is paid once
    per process, not per trainer. A deadline of 0 or None is off and
    keeps the grace."""
    global _first_epoch_done
    if not timeout_s:
        return timeout_s
    if _first_epoch_done:
        return timeout_s
    _first_epoch_done = True
    return timeout_s * max(first_mult, 1.0)


def barrier(tag: str = "barrier", timeout_s: Optional[float] = None,
            kill_process: bool = False) -> None:
    """A cross-process rendezvous with an optional deadline: a dead or
    straggling rank shows at a known point (an epoch boundary, a
    checkpoint) instead of hanging an arbitrary later collective. Raises
    ``HealthError`` when the deadline passes. Single process: no-op."""
    import datetime

    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return
    with watchdog(timeout_s, tag=f"barrier:{tag}", kill_process=kill_process):
        if timeout_s and dist.get_backend() == "gloo":
            try:
                dist.monitored_barrier(
                    timeout=datetime.timedelta(seconds=timeout_s))
            except RuntimeError as e:
                raise HealthError(f"barrier '{tag}': {e}") from e
        else:
            dist.barrier()
