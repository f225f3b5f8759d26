"""The (data, model) rank grid of a mesh run (counterpart of
``aread_tpu/parallel/mesh.py``).

The JAX package runs one program over a 2-D device mesh and lets GSPMD
partition it. Here every rank is a process of its own, and ``Mesh`` says
which cell of the grid this process is:

  * batches shard their rows over 'data': the data rank ``i`` holds rows
    ``[i * b, (i + 1) * b)`` of every global batch of ``data * b`` rows;
  * the fused embedding table — every 2-D tensor whose path ends in
    ``table`` — row-shards over 'model': the model rank ``j`` holds table
    rows ``[j * r, (j + 1) * r)`` of ``model * r``;
  * everything else is replicated, and the ranks of one data index compute
    it alike.

Rank ``data_index * model + model_index`` is the cell ``(data_index,
model_index)``, the row-major order of the JAX package's device mesh.
The 'data' group of a rank is the ranks of its model index (they hold the
same table rows and different batch rows: gradients and batch statistics
are summed there); its 'model' group is the ranks of its data index (they
hold the same batch rows and different table rows: lookups are
exchanged there). A group of one rank is no group: its collectives are
skipped, so a 1 x 1 mesh needs no process group at all.

Under the ``gloo`` backend a collective on CUDA tensors is staged through
host memory here, explicitly: the rule that picks gloo for a card that
holds more than one rank (``distributed.collective_backend``) is made
before the process group exists, and staging is part of it.

``use(mesh)`` makes a mesh the active one for a block: the layers whose
training forward reduces over the batch (BatchNorm's moments, dropout's
mask, AREAD's gate means, ADL's centres) read it and reduce over 'data'.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from aread_tpu_torch.device import resolve_device


class Mesh:
    """One rank's view of the (data, model) grid: its indices, its two
    groups, its device and the collectives over each axis."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, backend: Optional[str],
                 groups: Dict[str, Optional[object]]):
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, self.model)
        self.device = device
        self.backend = backend
        self.groups = groups
        self.host_staged = backend == "gloo" and device.type == "cuda"

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}"
                f", device={self.device}, backend={self.backend})")

    # ------------------------------------------------------------ layout
    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.data:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"data={self.data}")
        b = n // self.data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def table_rows(self, n_rows: int) -> slice:
        """This rank's rows of a table of ``n_rows`` rows."""
        if n_rows % self.model:
            raise ValueError(
                f"table rows {n_rows} not divisible by model={self.model} "
                "(FeatureSpec.pad_vocab)")
        r = n_rows // self.model
        return slice(self.model_index * r, (self.model_index + 1) * r)

    # ------------------------------------------------------- collectives
    def _run(self, fn, *tensors: torch.Tensor):
        """``fn`` on the tensors, through host copies under gloo with CUDA
        tensors; the results are copied back in place."""
        if not self.host_staged or tensors[0].device.type != "cuda":
            fn(*tensors)
            return
        host = [t.cpu() for t in tensors]
        fn(*host)
        for t, h in zip(tensors, host):
            t.copy_(h)

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """In-place sum over ``axis``."""
        group = self.groups[axis]
        if group is not None:
            self._run(lambda x: dist.all_reduce(x, group=group), t)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``axis`` ranks' tensors concatenated along dim 0 in rank
        order."""
        group = self.groups[axis]
        if group is None:
            return t
        t = t.contiguous()
        n = self.size(axis)
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self._run(lambda o, x: dist.all_gather(list(o.chunk(n)), x,
                                               group=group), out, t)
        return out

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Block ``s`` of dim 0 goes to the ``axis`` rank ``s``; block
        ``s`` of the result came from it."""
        group = self.groups[axis]
        if group is None:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        self._run(lambda o, x: dist.all_to_all_single(o, x, group=group),
                  out, t)
        return out


class _SumOver(torch.autograd.Function):
    """Sum over a mesh axis whose gradient is the sum of the ranks'
    gradients (each rank's loss reaches every rank's summand)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(), ctx.axis), None, None


def sum_over(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``axis``."""
    if mesh.groups[axis] is None:
        return x
    return _SumOver.apply(x, mesh, axis)


# --------------------------------------------------------- the active mesh
_ACTIVE: List[Optional[Mesh]] = []


@contextlib.contextmanager
def use(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block ``active()`` is ``mesh`` (None: no mesh)."""
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def data_parallel() -> Optional[Mesh]:
    """The active mesh when its batches are split (data > 1), else None."""
    mesh = active()
    return mesh if mesh is not None and mesh.data > 1 else None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active mesh's data ranks, with gradient; ``x``
    itself without a data-parallel mesh."""
    mesh = data_parallel()
    return x if mesh is None else sum_over(x, mesh, "data")


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over the batch rows, ``x``, completed over the global batch
    (no gradient)."""
    mesh = data_parallel()
    return x if mesh is None else mesh.all_reduce_(x.detach().clone(), "data")


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over dim 0 of the global batch (no gradient)."""
    mesh = data_parallel()
    if mesh is None:
        return x.mean(dim=0)
    s = mesh.all_reduce_(x.detach().sum(dim=0), "data")
    return s / (x.shape[0] * mesh.data)


# ------------------------------------------------------------------ build
def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_available() and dist.is_initialized()
                              else 0))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else the card
    ``local_rank % device_count`` (``None`` and ``"cuda"`` alike)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The (data, model) layout over the initialized process group, whose
    world must be ``data * model`` processes. Every rank calls it (the
    groups are made collectively). A process with no process group is a
    world of one: it takes a 1 x 1 mesh, and a larger one raises."""
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh data={data} model={model}")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n != world:
        raise ValueError(
            f"a mesh of data={data} x model={model} needs {n} processes; "
            f"this world has {world}"
            + ("" if initialized else
               " (no process group: launch the ranks with "
               "python -m torch.distributed.run --nproc_per_node "
               f"{n} ...)"))
    groups: Dict[str, Optional[object]] = {"data": None, "model": None}
    if world > 1:
        # every rank makes every group, in the same order
        for mi in range(model):
            ranks = [di * model + mi for di in range(data)]
            g = dist.new_group(ranks) if data > 1 else None
            if rank in ranks:
                groups["data"] = g
        for di in range(data):
            ranks = [di * model + mi for mi in range(model)]
            g = dist.new_group(ranks) if model > 1 else None
            if rank in ranks:
                groups["model"] = g
    backend = dist.get_backend() if initialized else None
    return Mesh(data, model, rank, rank_device(device), backend, groups)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def param_shardings(state_dict: Dict[str, torch.Tensor],
                    table_path: str = "table") -> Dict[str, str]:
    """'model' for each 2-D tensor whose '/'-joined path ends in
    ``table_path`` (row-sharded), 'replicated' for the rest."""
    return {k: ("model" if k.replace(".", "/").endswith(table_path)
                and v.dim() == 2 else "replicated")
            for k, v in state_dict.items()}


def shard_rows(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``[n_rows / model, D]`` rows of a full table (a copy)."""
    return full[mesh.table_rows(full.shape[0])].clone()


def gather_rows(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full table from the model ranks' shards (every rank of the
    model group gets it)."""
    return mesh.all_gather(shard, "model")
