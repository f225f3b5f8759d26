"""A mesh training step outside the trainers (counterpart of
``aread_tpu/parallel/train_step.py``).

``shard_params`` cuts a model's row-sharded tensors (``mesh.param_shardings``:
the embedding table) to this rank's rows; the rest stays replicated.
``make_sharded_train_step`` returns the generic ``Trainer``'s step on the
mesh — the same function one device runs, with the rank's batch rows, the
loss and gradients summed over 'data' and the table updated per shard —
and the function that places a global host batch as this rank's rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from aread_tpu_torch.parallel.mesh import Mesh, param_shardings


def shard_params(model, mesh: Mesh) -> Dict[str, str]:
    """Cut the model's row-sharded tensors to this rank's rows (in place,
    once: an already sharded model is left as it is). Returns the
    shardings by state_dict key."""
    if model.embedding.mesh is None:
        table = model.embedding.table.device
        if table.type != mesh.device.type or (
                table.type == "cuda" and table.index != mesh.device.index):
            raise ValueError(f"the model is on {table}, this rank's device "
                             f"is {mesh.device}")
        model.embedding.shard_(mesh)
    elif model.embedding.mesh is not mesh:
        raise ValueError("the model's table is sharded over another mesh")
    return param_shardings(model.state_dict())


def make_sharded_train_step(model, optimizer, mesh: Mesh, reg_rules,
                            is_multi_tower: bool,
                            embed_lookup: str = "gspmd",
                            a2a_capacity: Optional[int] = None
                            ) -> Tuple[Callable, Callable]:
    """(step, place_batch): ``step(batch)`` takes one training step in
    place and returns the global loss; ``place_batch(host_batch)`` is this
    rank's rows of a global batch on its device. ``optimizer`` is the
    dense leaves' ``DenseAdam`` (its ``lr`` and ``wd`` serve the table's
    Adam too: the fused dense Adam on the rank's rows of the dense table
    gradient, as the JAX package's optax chain covers the table); the
    dropout stream is the config's default seed; ``reg_rules`` the model's
    L2 rules, the table's folded into its update. ``embed_lookup``: 'gspmd' (the shard-select lookup) or
    'a2a' (dedup + all-to-all; ``a2a_capacity`` its per-owner bound, None
    = always exact)."""
    if embed_lookup not in ("gspmd", "a2a"):
        raise ValueError(f"embed_lookup={embed_lookup!r}")
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.train.trainer import Trainer, strip_table_rule

    cfg = Config(model=model.model_name, lr=optimizer.lr, wd=optimizer.wd,
                 embed_lookup=embed_lookup,
                 a2a_capacity=-1 if a2a_capacity is None else a2a_capacity,
                 sparse_table_grad=False, table_moments_dtype=None)
    trainer = Trainer(model, cfg, n_domain=1, mesh=mesh)
    trainer.optimizer = optimizer
    trainer.reg_rules = strip_table_rule(reg_rules)
    trainer.is_multi_tower = is_multi_tower
    trainer.init()
    return trainer.step, trainer.place
