"""Carries the JAX package's weights and optimizer state into the port.

``convert_checkpoint`` turns a checkpoint of the JAX package (the dict its
``load_checkpoint`` returns) into the port's checkpoint dict, which the
port's trainers warm-start or resume from and its ``Predictor`` serves.
``convert_final_opt_state`` carries the final-gate phase's optimizer
state, ``convert_mask_state`` and ``copy_hemp_schedule`` the HEMP state
(masks, gate records, candidates, probe losses, the mask generator's
position; the trainer's schedule values), so that both sides can start
from one state.

Input trees hold numpy arrays (``jax.tree_util.tree_map(np.asarray, t)``
on the JAX side); nothing here imports JAX. Flax paths map to the port's
module paths one to one ('/' becomes '.'); kernels keep their [in, out]
(or stacked [T, in, out]) layout; the lane-packed flat table
[n_rows*D/128, 128] — and its Adam moments — become [n_rows, D] by a plain
reshape (row-major order is the same element order).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _to_torch(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    # always a copy: the port updates in place, and the source may be
    # memory that JAX still owns
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: move the bits
        t = torch.from_numpy(np.array(a.view(np.int16)))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def _table_rows(a, embed_dim: int):
    a = np.asarray(a)
    return a.reshape(-1, embed_dim) if a.shape[-1] != embed_dim else a


def convert_variables(params: Mapping, batch_stats: Mapping, embed_dim: int,
                      device=None, **collections) -> Dict[str, torch.Tensor]:
    """flax ``params``, ``batch_stats`` and every other collection of
    carried state, by name in ``collections`` (ADL's ``model_state``, whose
    ``cluster_centers`` is the port's buffer of that name) -> the port's
    ``state_dict``. Each collection's paths map to the port's module paths
    as the parameters' do."""
    sd = {}
    for path, leaf in flatten(params).items():
        if path == "embedding/table":
            leaf = _table_rows(leaf, embed_dim)
        sd[path.replace("/", ".")] = _to_torch(leaf, device)
    for tree in (batch_stats, *collections.values()):
        for path, leaf in flatten(tree).items():
            sd[path.replace("/", ".")] = _to_torch(leaf, device)
    return sd


def _adam_fields(chain) -> Dict:
    """{'count', 'mu', 'nu'} of the Adam state inside an optax chain
    state."""
    for s in (chain.values() if isinstance(chain, Mapping) else chain):
        if isinstance(s, Mapping) and "mu" in s:
            return {k: s[k] for k in ("count", "mu", "nu")}
        if hasattr(s, "mu"):
            return {"count": s.count, "mu": s.mu, "nu": s.nu}
    raise ValueError("no Adam state (mu / nu / count) in the chain state")


def convert_opt_state(opt_state: Mapping, embed_dim: int, device=None) -> Dict:
    """The JAX package's hybrid optimizer state {'inner': optax chain
    state, 'm', 'v', 't'} -> the port's (``train.trainer.hybrid_init``'s
    layout). The chain's Adam state is found by its ``mu``/``nu``/
    ``count`` fields, in the chain's tuple of NamedTuples or in the nested
    dicts that a checkpoint restored without a template holds."""
    adam = _adam_fields(opt_state["inner"])
    return {
        "inner": {
            "count": int(np.asarray(adam["count"])),
            "mu": {p: _to_torch(a, device)
                   for p, a in flatten(adam["mu"]).items()},
            "nu": {p: _to_torch(a, device)
                   for p, a in flatten(adam["nu"]).items()},
        },
        "m": _to_torch(_table_rows(opt_state["m"], embed_dim), device),
        "v": _to_torch(_table_rows(opt_state["v"], embed_dim), device),
        "t": int(np.asarray(opt_state["t"])),
    }


def convert_final_opt_state(opt_state, device=None) -> Dict:
    """The final-gate phase's optax chain state over the ``final_gate``
    leaf ({'kernel': ...}) -> the port's ``DenseAdam`` state over
    {'final_gate/kernel': ...}."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    return {
        "count": int(np.asarray(adam.count)),
        "mu": {f"final_gate/{p}": _to_torch(a, device)
               for p, a in flatten(adam.mu).items()},
        "nu": {f"final_gate/{p}": _to_torch(a, device)
               for p, a in flatten(adam.nu).items()},
    }


def _copy_mask(mask):
    return None if mask is None else [np.array(m, dtype=bool) for m in mask]


def convert_mask_state(src):
    """A ``HempMaskState`` of the port holding a copy of every field of
    the JAX package's object ``src`` (read by attribute, as numpy): the
    per-domain masks, the gate records, thresholds, candidates and probe
    losses of a running evolution, the last fast-adapt gate record, and
    the generator's position, so that both draw the same masks next."""
    from aread_tpu_torch.utils.masks import HempMaskState

    dst = HempMaskState(src.n_tower, src.n_domain)
    dst.rng.bit_generator.state = src.rng.bit_generator.state
    dst.domain_mask = [_copy_mask(m) for m in src.domain_mask]
    for d in range(src.n_domain):
        for rec in src.gate_acc[d]._records:
            dst.gate_acc[d].add([np.array(g) for g in rec])
        dst.candidate_domain_mask[d] = [
            _copy_mask(m) for m in src.candidate_domain_mask[d]]
        dst.eval_loss[d] = [[float(x) for x in losses]
                            for losses in src.eval_loss[d]]
    dst.gate_value_threshold = list(src.gate_value_threshold)
    dst.tmp_gate_record = (None if src.tmp_gate_record is None else
                           tuple(np.array(g) for g in src.tmp_gate_record))
    return dst


HEMP_SCHEDULE_FIELDS = ("random_modify_sigma", "init_active_percent",
                        "candidate_mask_num", "regroup_times")


def copy_hemp_schedule(src, dst) -> None:
    """The HEMP schedule values of the JAX package's ``AREADTrainer``
    ``src`` onto the port's trainer ``dst``."""
    for name in HEMP_SCHEDULE_FIELDS:
        setattr(dst, name, type(getattr(dst, name))(getattr(src, name)))


def convert_checkpoint(ck: Mapping, embed_dim: int, device=None) -> Dict:
    """The dict that the JAX package's ``load_checkpoint`` returns (arrays
    as numpy) -> the port's checkpoint dict, as the port's
    ``load_checkpoint`` returns it: meta.json's keys as they are (epoch,
    n_domain, best_result, hemp_schedule, spec, config), 'state_dict',
    'opt_state' ({} where the checkpoint holds none) and 'domain_mask'
    where present. The JAX PRNG key has no counterpart in a torch
    generator and is left out: a converted checkpoint warm-starts and
    serves, and a run resumed from it draws a new dropout stream."""
    out = {k: v for k, v in ck.items()
           if k not in ("params", "state", "opt_state", "rng_key",
                        "domain_mask")}
    # every collection of the state but 'perturbations', the step's input
    # (the JAX package's split_variables)
    state = {k: v for k, v in (ck.get("state") or {}).items()
             if k != "perturbations"}
    out["state_dict"] = convert_variables(
        ck["params"], state.pop("batch_stats", {}), embed_dim, device,
        **state)
    opt_state = ck.get("opt_state")
    out["opt_state"] = (convert_opt_state(opt_state, embed_dim, device)
                        if opt_state else {})
    if ck.get("domain_mask") is not None:
        out["domain_mask"] = [_copy_mask(m) for m in ck["domain_mask"]]
    return out
