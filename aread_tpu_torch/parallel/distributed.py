"""Process-group start-up, the collective backend rule and the
host-coordinated domain-grouped input (counterpart of
``aread_tpu/parallel/distributed.py``).

* ``collective_backend(device)``: ``gloo`` on the CPU; on CUDA ``nccl``,
  unless this node runs more ranks than it has cards — NCCL refuses two
  ranks on one card — and then ``gloo``, whose collectives on CUDA tensors
  go through host memory (``mesh.Mesh`` stages them). The rule is decided
  before ``init_process_group`` and is never a switch made after a
  failure.
* ``initialize()``: ``torch.distributed.init_process_group`` from the
  standard ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
  environment (``python -m torch.distributed.run`` sets it); a no-op in a
  single process.
* ``HostShardedDomainBatcher``: every process derives the same shuffled
  domain sequence and per-domain permutations from the shared seed
  (``_perm``, counter-based Philox: no communication) and materializes only
  its rows of each global batch; the data ranks' slices, concatenated in
  rank order, are the single-process ``DomainBatcher`` batch. Torch has no
  global array: ``device_batch`` returns this rank's slice on its device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def collective_backend(device) -> str:
    """``gloo`` for the CPU or for more ranks on this node than cards,
    else ``nccl``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def initialize(device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> Optional[str]:
    """Start the process group and return its backend; None (nothing
    started) in a single process. Arguments fall back to the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``); the backend to
    ``collective_backend(device)``. Under NCCL the rank's card becomes the
    current one."""
    if dist.is_initialized():
        return dist.get_backend()
    world = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None and "MASTER_ADDR" not in os.environ:
        return None  # one process: nothing to start
    backend = backend or collective_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0))
                              % torch.cuda.device_count())
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    return backend


def shutdown() -> None:
    """Tear the process group down, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _perm(n: int, *key_parts: int) -> np.ndarray:
    """Shared-seed permutation of [0, n): identical on every process for
    the same key parts (counter-based Philox — no state to synchronize; the
    parts fold into Philox's 128-bit key with a Fibonacci-hash chain,
    deterministic across processes and runs)."""
    acc, mix = 0, 0
    for p in key_parts:
        acc = (acc * 0x9E3779B97F4A7C15 + (int(p) & (2**64 - 1)) + 1) % 2**64
        mix = (mix ^ acc) * 0xBF58476D1CE4E5B9 % 2**64
    rng = np.random.Generator(np.random.Philox(key=[acc, mix]))
    return rng.permutation(n)


class HostShardedDomainBatcher:
    """This process's slice of the globally coordinated domain-grouped
    stream: the loader's ``DomainBatcher`` semantics at global batch
    granularity (a shuffled ``domain_batch_seq`` with ceil(n_d /
    global_bs) entries per domain, cyclic per-domain cursors reshuffled on
    wrap), every random draw keyed on (seed, structural counters).
    Process ``pi`` returns global-batch positions ``[pi * local_bs, (pi + 1)
    * local_bs)``. On a mesh the processes are the data ranks:
    ``process_index = mesh.data_index``, ``process_count = mesh.data``
    (the model ranks of one data index take the same slice)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, global_bs: int,
                 domain_idx: int, n_domain: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0):
        if process_index is None or process_count is None:
            started = dist.is_available() and dist.is_initialized()
            process_index = dist.get_rank() if started else 0
            process_count = dist.get_world_size() if started else 1
        assert global_bs % process_count == 0, (global_bs, process_count)
        self.x, self.y = x, y
        self.global_bs = global_bs
        self.local_bs = global_bs // process_count
        self.pi, self.pc = process_index, process_count
        self.domain_idx, self.n_domain = domain_idx, n_domain
        self.shuffle = shuffle
        self.seed = seed
        domains = x[:, domain_idx]
        self.domain_indices: List[np.ndarray] = [
            np.nonzero(domains == d)[0] for d in range(n_domain)]
        self._epoch = 0
        self._wraps = [0] * n_domain
        self._cursors = [0] * n_domain
        self.domain_batch_seq = self._make_seq()

    # ---- schedule (identical on every process) ----
    def _make_seq(self) -> List[int]:
        seq: List[int] = []
        for d in range(self.n_domain):
            seq.extend([d] * int(np.ceil(len(self.domain_indices[d])
                                         / self.global_bs)))
        if not self.shuffle:
            return seq
        order = _perm(len(seq), self.seed, 0xD0, self._epoch)
        return [seq[i] for i in order]

    def shuffle_seq(self):
        """New epoch: reshuffle the domain sequence."""
        self._epoch += 1
        self.domain_batch_seq = self._make_seq()

    # ---- batches ----
    def next_batch(self, d: int) -> Dict[str, np.ndarray]:
        """This process's slice of the next global batch of domain d: the
        global cursor advances by global_bs over the shared permutation of
        the domain's rows, wrapping with a reshuffle; rows beyond the
        domain's end pad with valid=0."""
        idxs = self.domain_indices[d]
        n = len(idxs)
        if n == 0:
            raise ValueError(f"domain {d} has no rows")
        if self._cursors[d] >= n:
            self._wraps[d] += 1
            self._cursors[d] = 0
        lo = self._cursors[d]
        self._cursors[d] = lo + self.global_bs
        if self.shuffle:
            order = _perm(n, self.seed, 1 + d, self._wraps[d])
        else:
            order = np.arange(n)
        # this process's positions within the global batch
        plo = lo + self.pi * self.local_bs
        sel = order[plo:min(plo + self.local_bs, n)]
        rows = idxs[sel]

        xb = np.zeros((self.local_bs,) + self.x.shape[1:], self.x.dtype)
        yb = np.zeros((self.local_bs,), self.y.dtype)
        validb = np.zeros((self.local_bs,), np.float32)
        k = len(rows)
        xb[:k] = self.x[rows]
        yb[:k] = self.y[rows]
        validb[:k] = 1.0
        return {"x": xb, "y": yb, "valid": validb,
                "domain": np.full((self.local_bs,), d, np.int32)}

    def device_batch(self, d: int, mesh) -> Dict[str, torch.Tensor]:
        """``next_batch`` on the rank's device (``mesh.device``)."""
        return {k: torch.as_tensor(v, device=mesh.device)
                for k, v in self.next_batch(d).items()}
