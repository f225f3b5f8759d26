"""Row-sharded embedding lookup over the mesh (counterpart of
``aread_tpu/parallel/embed_shard.py``).

The table is held as this rank's rows ``[n_rows / model, E]``; the ids are
this rank's batch rows, the same on every model rank of a data index. Two
lookups, both returning f32 rows (a bf16 table's compute is f32, and the
rows cross the collectives as f32):

  * ``sharded_lookup`` (``embed_lookup='gspmd'``, the default): each model
    rank gathers the ids that fall in its rows, zeros the rest, and the
    model group sums — exactly one rank contributes each row, so the
    result is the plain gather, bitwise;
  * ``a2a_lookup`` (``embed_lookup='a2a'``): dedup the local ids, bucket
    the unique ids by owner rank into a static per-owner ``capacity``,
    exchange the buckets and then the rows with two ``all_to_all``s over
    'model', and undo the dedup. Row traffic is O(unique ids) instead of
    O(ids). An id that overflows its owner's bucket NaN-poisons the whole
    output: an undersized capacity must fail loudly (the trainers' epoch
    finite check raises), never train on zero rows. ``resolve_a2a_capacity``
    measures the requirement before the first step.

Both are ``torch.autograd.Function``s whose backward is a scatter-add of
the output gradient into the rank's own rows followed by a sum over
'data': the gradient of a row lands on the one rank that owns it, and the
model ranks of a data index hold the same output gradient, so no
model-axis exchange is needed on the way back (the JAX package's
``_bwd_local``). The trainers take the table's gradient through the
embedding's tap instead and sum it themselves; the backward serves
callers that differentiate the lookup directly.

The capacity functions are numpy, copied from the JAX package with the
same semantics and messages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from aread_tpu_torch.parallel.mesh import Mesh


def pad_table_rows(table: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Pad the row count to a multiple of the model-axis size."""
    rows = table.shape[0]
    padded = ((rows + n_shards - 1) // n_shards) * n_shards
    if padded == rows:
        return table
    return torch.cat([table, torch.zeros((padded - rows, table.shape[1]),
                                         dtype=table.dtype,
                                         device=table.device)])


def _local_rows(table_l: torch.Tensor, ids: torch.Tensor, lo: int):
    """(rows f32 [..., E] of the ids in [lo, lo + rows_per) — zero
    elsewhere — , the in-range mask, the local index)."""
    rows_per = table_l.shape[0]
    local = ids.to(torch.int64) - lo
    ok = (local >= 0) & (local < rows_per)
    rows = table_l[torch.clamp(local, 0, rows_per - 1)].to(torch.float32)
    return torch.where(ok[..., None], rows, torch.zeros((), device=rows.device)
                       ), ok, local


def _scatter_local(g: torch.Tensor, local: torch.Tensor, ok: torch.Tensor,
                   rows_per: int) -> torch.Tensor:
    """Sum the gradient rows ``g`` [k, E] into ``[rows_per, E]`` at
    ``local``, dropping those where ``ok`` is false."""
    out = torch.zeros((rows_per + 1, g.shape[-1]), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, torch.where(ok, local, rows_per), g.to(torch.float32))
    return out[:rows_per]


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_l, ids, mesh):
        lo = mesh.model_index * table_l.shape[0]
        rows, ok, local = _local_rows(table_l, ids, lo)
        ctx.mesh, ctx.rows_per = mesh, table_l.shape[0]
        ctx.save_for_backward(ok, local)
        return mesh.all_reduce_(rows, "model")

    @staticmethod
    def backward(ctx, g):
        ok, local = ctx.saved_tensors
        e = g.shape[-1]
        d = _scatter_local(g.reshape(-1, e), local.reshape(-1),
                           ok.reshape(-1), ctx.rows_per)
        return ctx.mesh.all_reduce_(d, "data"), None, None


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """Rows ``[..., E]`` (f32) of the row-sharded table at the global row
    ids ``ids`` (this rank's batch rows). ``table`` is this rank's shard
    ``[n_rows / model, E]``."""
    return _ShardedLookup.apply(table, ids, mesh)


def lookup_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Unsharded ground truth."""
    return table[ids.to(torch.int64)]


# ---------------------------------------------------------------------------
# Dedup + all-to-all exchange. Per rank, with m = model-axis size and n =
# local id count:
#   1. sort + dedup the local ids (the model ranks of a data index hold the
#      same ids, so each derives the same request list, no id exchange);
#   2. bucket the unique ids by owner rank (contiguous after the sort) into
#      a static per-owner ``capacity`` — all_to_all_single takes equal
#      splits here;
#   3. all_to_all the id buckets over 'model', each owner gathers its rows,
#      all_to_all the rows back;
#   4. un-dedup: out[i] = unique_rows[searchsorted(unique, ids[i])].
# ---------------------------------------------------------------------------
class _A2ACfg(NamedTuple):
    mesh: Mesh
    capacity: int
    rows_per: int
    n_rows: int


def _routing(cfg: _A2ACfg, ids_l: torch.Tensor):
    """Shared forward/backward routing plan, recomputed from the local ids.

    Returns (compact, inv, start, gather_idx, valid_send) where
      compact   [n]   sorted unique ids, tail filled with the sentinel n_rows
      inv       [n]   index of each original flat id inside ``compact``
      start     [m]   bucket start offset per owner rank
      gather_idx[m,c] compact index feeding each send slot
      valid_send[m,c] send-slot validity (bucket member and under capacity)
    """
    m = cfg.mesh.model
    dev = ids_l.device
    flat = ids_l.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    sorted_ids = torch.sort(flat).values
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    pos = torch.cumsum(first, 0) - 1
    compact = torch.full((n,), cfg.n_rows, dtype=torch.int32, device=dev)
    compact[pos[first]] = sorted_ids[first]
    inv = torch.searchsorted(compact, flat, side="left")
    edges = (torch.arange(m + 1, device=dev) * cfg.rows_per).to(torch.int32)
    bounds = torch.searchsorted(compact, edges, side="left")
    start, end = bounds[:-1], bounds[1:]
    j = torch.arange(cfg.capacity, device=dev)
    gather_idx = start[:, None] + j[None, :]                  # [m, c]
    valid_send = gather_idx < end[:, None]
    gather_idx = torch.clamp(gather_idx, max=n - 1)
    return compact, inv, start, gather_idx, valid_send


def _fwd_local(cfg: _A2ACfg, table_l: torch.Tensor, ids_l: torch.Tensor):
    mesh = cfg.mesh
    m, c, e = mesh.model, cfg.capacity, table_l.shape[-1]
    n = ids_l.numel()
    dev = ids_l.device
    compact, inv, start, gather_idx, valid_send = _routing(cfg, ids_l)
    send_ids = torch.where(valid_send, compact[gather_idx],
                           torch.full((), -1, dtype=torch.int32, device=dev))
    recv_ids = mesh.all_to_all(send_ids, "model")               # [m, c]
    rows, _, _ = _local_rows(table_l, recv_ids,
                             mesh.model_index * cfg.rows_per)   # [m, c, E]
    urows = mesh.all_to_all(rows, "model")  # block s: my bucket, from s
    # un-bucket: unique k lives at (owner_k, k - start[owner_k])
    owner_k = torch.clamp(compact.to(torch.int64) // cfg.rows_per, 0, m - 1)
    slot_k = torch.arange(n, device=dev) - start[owner_k]
    real = compact < cfg.n_rows
    in_cap = (slot_k < c) & real
    flat_idx = owner_k * c + torch.clamp(slot_k, 0, c - 1)
    unique_rows = torch.where(in_cap[:, None],
                              urows.reshape(m * c, e)[flat_idx],
                              torch.zeros((), device=dev))
    # an undersized static capacity fails loudly: NaN-poison the batch so
    # that the trainers' epoch finite check raises
    overflowed = torch.any((slot_k >= c) & real)
    unique_rows = unique_rows + torch.where(
        overflowed, torch.tensor(float("nan"), device=dev),
        torch.zeros((), device=dev))
    return unique_rows[inv].reshape(tuple(ids_l.shape) + (e,))


def _bwd_local(cfg: _A2ACfg, ids_l: torch.Tensor, g_l: torch.Tensor):
    # ids and the output gradient are the same on every model rank of a
    # data index, so every rank computes the same per-owner gradient
    # buckets: each owner reads its own bucket, scatter-adds, and the data
    # ranks sum
    mesh = cfg.mesh
    e = g_l.shape[-1]
    n = ids_l.numel()
    compact, inv, _, gather_idx, valid_send = _routing(cfg, ids_l)
    g_unique = torch.zeros((n, e), dtype=torch.float32, device=g_l.device)
    g_unique.index_add_(0, inv, g_l.reshape(n, e).to(torch.float32))
    mi = mesh.model_index
    my_slots = gather_idx[mi]                                   # [c]
    my_ok = valid_send[mi]
    my_g = torch.where(my_ok[:, None], g_unique[my_slots],
                       torch.zeros((), device=g_l.device))
    local = compact[my_slots].to(torch.int64) - mi * cfg.rows_per
    ok = my_ok & (local >= 0) & (local < cfg.rows_per)
    d = _scatter_local(my_g, local, ok, cfg.rows_per)
    return mesh.all_reduce_(d, "data")


class _A2ALookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_l, ids, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(ids)
        return _fwd_local(cfg, table_l, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _bwd_local(ctx.cfg, ids, g), None, None


def a2a_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
               capacity: Optional[int] = None) -> torch.Tensor:
    """Dedup + all-to-all gather of rows ``[..., E]`` (f32) of the
    row-sharded table (this rank's shard ``table`` ``[n_rows / model, E]``)
    at the global row ids ``ids`` (this rank's batch rows).

    capacity: static per-owner bucket size. None = always exact (the local
      id count): correct for any id distribution, with no traffic win;
      pass a measured bound (``a2a_required_capacity``) for the
      O(unique rows) exchange. An overflowing batch NaN-poisons its output.
    """
    n_local = int(ids.numel())
    cap = n_local if capacity is None else min(int(capacity), n_local)
    cfg = _A2ACfg(mesh=mesh, capacity=max(cap, 1), rows_per=table.shape[0],
                  n_rows=table.shape[0] * mesh.model)
    return _A2ALookup.apply(table, ids, cfg)


def flat_a2a_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                    capacity: Optional[int], rows_per_flat: int
                    ) -> torch.Tensor:
    """``a2a_lookup`` in the JAX package's lane-packed row space: the
    shard viewed as ``[rows / rpf, rpf * E]`` flat rows, exchanged at the
    flat ids ``ids // rpf`` (the space ``lookup_ids`` and the capacity are
    measured in), each logical row then cut out of its flat row. Equal to
    ``a2a_lookup`` on the logical ids, with the JAX package's traffic and
    capacity."""
    rpf = rows_per_flat
    if rpf == 1:
        return a2a_lookup(table, ids, mesh, capacity)
    e = table.shape[-1]
    if table.shape[0] % rpf:
        raise ValueError(f"shard rows {table.shape[0]} not divisible by "
                         f"{rpf} table rows per flat row")
    ids64 = ids.to(torch.int64)
    flat = a2a_lookup(table.reshape(-1, rpf * e), ids64 // rpf, mesh,
                      capacity)
    flat = flat.reshape(tuple(ids.shape) + (rpf, e))
    return torch.gather(flat, -2, (ids64 % rpf)[..., None, None].expand(
        tuple(ids.shape) + (1, e)))[..., 0, :]


# ------------------------------------------------- capacity, on the host
def a2a_required_capacity(ids: np.ndarray, n_rows: int, n_model: int,
                          n_data: int = 1) -> int:
    """Host-side exact capacity bound for a batch of ids: the max, over
    data shards, of the largest per-owner unique-id bucket."""
    ids = np.asarray(ids).reshape(n_data, -1)
    rows_per = -(-n_rows // n_model)
    worst = 1
    for shard_ids in ids:
        uniq = np.unique(shard_ids)
        cnt = np.bincount(np.minimum(uniq // rows_per, n_model - 1),
                          minlength=n_model)
        worst = max(worst, int(cnt.max()))
    return worst


def lookup_ids(spec, embed_dim: int, x_np) -> Tuple[np.ndarray, int]:
    """The exact (row ids, table row count) the lookup exchanges for a
    batch under the active storage mode: under flat storage
    (``FeatureSpec.with_flat_table``) the flat ids ``fids // rpf`` against
    ``n_rows / rpf`` flat rows (``flat_a2a_lookup``)."""
    from aread_tpu_torch.ops.embedding import compute_offsets

    offsets = np.asarray(compute_offsets(
        spec.one_hot_dims, spec.n_seq_fields * spec.seq_maxlen,
        spec.itemid_idx))
    n_rows = int(np.sum(spec.one_hot_dims))
    x = np.asarray(x_np).reshape(-1, offsets.shape[0])
    ids = np.clip(x + offsets, 0, n_rows - 1)
    if getattr(spec, "flat_table", False):
        rpf = 128 // embed_dim
        return ids // rpf, n_rows // rpf
    return ids, n_rows


def check_a2a_capacity(config, mesh, spec, embed_dim: int, x_np) -> None:
    """Fail-fast host check for a bounded ``config.a2a_capacity`` against a
    real batch. No-op when embed_lookup != 'a2a' or capacity <= 0 (auto /
    always-exact)."""
    if getattr(config, "embed_lookup", "gspmd") != "a2a" or mesh is None:
        return
    cap = int(getattr(config, "a2a_capacity", 0) or 0)
    if cap <= 0:
        return
    ids, n_rows = lookup_ids(spec, embed_dim, x_np)
    need = a2a_required_capacity(ids, n_rows, mesh.shape["model"],
                                 n_data=mesh.shape.get("data", 1))
    if cap < need:
        raise ValueError(
            f"a2a_capacity={cap} is below this batch's requirement {need} "
            f"(largest per-owner unique-id bucket; see "
            f"a2a_required_capacity). An undersized capacity NaN-poisons "
            f"the step — raise --a2a_capacity to >= {need}, pass 0 to "
            f"auto-calibrate, or -1 for the always-exact setting.")


def resolve_a2a_capacity(config, mesh, spec, embed_dim: int, pools, *,
                         n_batches: int = 32, headroom: float = 1.25,
                         seed: int = 0, verbose: bool = False) -> int:
    """Resolve ``config.a2a_capacity`` before the first step.

    ``pools``: sequence of ``(rows_array, batch_size)`` — the batch streams
    the run dispatches (train batches at cfg.bs and eval batches at their
    larger batch size; one capacity serves every lookup). The knob:

      0/None (default) -> AUTO: ``a2a_required_capacity`` over up to
          ``n_batches`` seeded random sample batches per pool, times
          ``headroom``, rounded up to a multiple of 8. A later batch that
          still overflows NaN-poisons its step and the epoch finite check
          raises.
      >0 -> manual bound, validated against the same calibration sample.
      <0 -> always-exact (capacity = local id count).

    Returns the resolved capacity; the knob untouched when embed_lookup !=
    'a2a' or there is no mesh. Host numpy from one seed: every rank
    resolves the same number."""
    if getattr(config, "embed_lookup", "gspmd") != "a2a" or mesh is None:
        return getattr(config, "a2a_capacity", 0)
    cap = int(getattr(config, "a2a_capacity", 0) or 0)
    if cap < 0:
        return cap
    n_model = mesh.shape["model"]
    n_data = mesh.shape.get("data", 1)
    rng = np.random.default_rng(seed)
    need = 1
    for arr, bs in pools:
        if arr is None or len(arr) == 0:
            continue
        arr = np.asarray(arr)
        size = min(int(bs), len(arr))
        size = max(n_data, size - size % n_data)
        for _ in range(n_batches):
            idx = rng.choice(len(arr), size=size, replace=size > len(arr))
            ids, n_rows = lookup_ids(spec, embed_dim, arr[idx])
            need = max(need, a2a_required_capacity(ids, n_rows, n_model,
                                                   n_data=n_data))
    if cap > 0:
        if cap < need:
            raise ValueError(
                f"a2a_capacity={cap} is below the calibrated requirement "
                f"{need} (largest per-owner unique-id bucket over "
                f"{n_batches} sample batches per pool). An undersized "
                f"capacity NaN-poisons the step — raise --a2a_capacity to "
                f">= {need}, pass 0 to auto-calibrate, or -1 for the "
                f"always-exact setting.")
        return cap
    auto = int(-(-int(np.ceil(need * headroom)) // 8) * 8)
    if verbose:
        print(f"a2a_capacity auto-calibrated: {auto} "
              f"(measured requirement {need} x{headroom} headroom)")
    return auto
