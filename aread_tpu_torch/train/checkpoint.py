"""Checkpoint / resume (counterpart of ``aread_tpu/train/checkpoint.py``).

A checkpoint is a directory: ``arrays/tree.pt`` (one ``torch.save`` of the
tensor tree: the model's ``state_dict()`` with the table in its storage
dtype, the optimizer state, the HEMP domain masks, the dropout generator's
state, and the state of the trainer's host-side streams) and
``meta.json`` (epoch, best metrics, HEMP schedule, and — for serving —
the FeatureSpec, the run Config and n_domain, from which
``serve.load_predictor`` rebuilds the model with no data or flags at
hand). ``meta.json`` has the JAX package's keys and coercions, so either
package's file is read by ``load_predictor``.

The write is crash-safe: the arrays go into a temporary sibling first, the
old ``meta.json`` is dropped before the swap, and the new one is written
last, so a ``meta.json`` that exists always describes complete arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aread_tpu_torch.utils.masks import mask_shapes

ARRAYS_FILE = "tree.pt"


def _mask_to_flat(domain_mask) -> Dict[str, np.ndarray]:
    out = {}
    for d, mask in enumerate(domain_mask):
        if mask is None:
            continue
        for li, m in enumerate(mask):
            out[f"d{d}_l{li}"] = np.asarray(m)
    return out


def _mask_from_flat(flat: Dict[str, np.ndarray], n_domain: int) -> List:
    masks: List[Optional[List[np.ndarray]]] = [None] * n_domain
    for d in range(n_domain):
        levels = sorted((k for k in flat if k.startswith(f"d{d}_l")),
                        key=lambda k: int(k.split("_l")[1]))
        if levels:
            masks[d] = [np.asarray(flat[k]).astype(bool) for k in levels]
    return masks


def mask_template(n_tower, n_domain: int) -> Dict[str, np.ndarray]:
    """The flat domain-mask tree of a model with ``n_tower`` (all domains,
    all levels, zeros): the names and shapes a saved tree must have to be
    resumed from."""
    shapes = mask_shapes(n_tower)
    return {f"d{d}_l{li}": np.zeros(s, bool)
            for d in range(n_domain) for li, s in enumerate(shapes)}


def generator_state(generator: torch.Generator) -> Dict[str, Any]:
    """A generator's state with its device type beside it: the state
    layouts of a CPU and a CUDA generator differ, so a state resumes only
    on the type it was taken on."""
    return {"device": generator.device.type, "state": generator.get_state()}


def set_generator_state(generator: torch.Generator, saved: Dict) -> None:
    if saved["device"] != generator.device.type:
        raise ValueError(
            f"the checkpoint's dropout generator state was saved on "
            f"'{saved['device']}' and cannot resume a generator on "
            f"'{generator.device.type}': resume on the device type the run "
            "was saved on")
    generator.set_state(saved["state"].cpu())


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def _host_leaf_to_saved(a):
    """numpy arrays as tensors, numpy scalars as Python's: what
    ``torch.load(weights_only=True)`` reads back."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a.item() if isinstance(a, np.generic) else a


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict], epoch: int,
                    best_result: Optional[Dict] = None, domain_mask=None,
                    hemp_schedule: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None,
                    host_state: Optional[Dict] = None, spec=None,
                    run_config=None, n_domain: Optional[int] = None) -> None:
    """Write a full training checkpoint to ``path`` (a directory).

    ``state_dict`` is the model's (weights and buffers), ``opt_state`` the
    trainer's optimizer state (nested dicts of tensors and step counts; {}
    for a checkpoint that only serves). ``host_state`` is a tree (dicts,
    lists, numpy arrays, numbers, strings, None) of what the trainer's
    host-side random streams stand at. ``spec`` (the data's FeatureSpec)
    and ``run_config`` go into meta.json so that serving can rebuild the
    model from the checkpoint alone."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree: Dict[str, Any] = {"state_dict": dict(state_dict),
                            "opt_state": opt_state or {}}
    if generator is not None:
        tree["rng_state"] = generator_state(generator)
    if domain_mask is not None:
        tree["domain_mask"] = {k: torch.from_numpy(np.array(v, dtype=bool))
                               for k, v in _mask_to_flat(domain_mask).items()}
    if host_state is not None:
        tree["host_state"] = _map_leaves(host_state, _host_leaf_to_saved)
    arrays_dir = os.path.join(path, "arrays")
    tmp_dir = os.path.join(path, "arrays.tmp")
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    torch.save(tree, os.path.join(tmp_dir, ARRAYS_FILE))
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        os.unlink(meta_path)  # an old meta must not describe swapped arrays
    shutil.rmtree(arrays_dir, ignore_errors=True)
    os.replace(tmp_dir, arrays_dir)
    meta: Dict[str, Any] = {"epoch": epoch}
    if n_domain is not None:
        meta["n_domain"] = int(n_domain)
    if best_result is not None:
        meta["best_result"] = {
            k: (float(v) if isinstance(v, (int, float, np.floating)) else None)
            for k, v in best_result.items() if not isinstance(v, dict)}
    if hemp_schedule is not None:
        meta["hemp_schedule"] = hemp_schedule
    if spec is not None:
        meta["spec"] = {k: (list(v) if isinstance(v, tuple) else v)
                        for k, v in dataclasses.asdict(spec).items()}
    if run_config is not None:
        meta["config"] = {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(run_config).items()
            if isinstance(v, (int, float, str, bool, tuple, list,
                              type(None)))}
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)


def load_checkpoint(path: str, n_domain: Optional[int] = None,
                    map_location="cpu") -> Dict:
    """meta.json's keys plus 'state_dict', 'opt_state', and where saved
    'rng_state', 'host_state' (its arrays as numpy) and (with
    ``n_domain``) 'domain_mask' as numpy bool arrays per domain, None for
    a domain without a mask. Tensors land on
    ``map_location``. A directory without meta.json is no checkpoint (the
    save was interrupted) and raises FileNotFoundError."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tree = torch.load(os.path.join(path, "arrays", ARRAYS_FILE),
                      weights_only=True, map_location=map_location)
    out = dict(meta)
    out["state_dict"] = tree["state_dict"]
    out["opt_state"] = tree.get("opt_state")
    if "rng_state" in tree:
        out["rng_state"] = tree["rng_state"]
    if "host_state" in tree:
        out["host_state"] = _map_leaves(
            tree["host_state"],
            lambda a: a.cpu().numpy() if torch.is_tensor(a) else a)
    if "domain_mask" in tree and n_domain is not None:
        out["domain_mask"] = _mask_from_flat(
            {k: v.cpu().numpy() for k, v in tree["domain_mask"].items()},
            n_domain)
    return out


@torch.no_grad()
def restore_tree_(live: Dict, saved: Dict, path: str = "") -> None:
    """Copy ``saved`` into ``live`` with the same structure: tensors in
    place, each cast to the live tensor's dtype (the sparse-Adam kernel's
    scratch and the trainers' snapshots hold on to the live storage), step
    counts by assignment."""
    if set(live) != set(saved):
        raise KeyError(f"checkpoint tree {path or '/'}: keys differ: "
                       f"{sorted(set(live) ^ set(saved))}")
    for k, v in saved.items():
        where = f"{path}/{k}"
        if isinstance(v, dict):
            restore_tree_(live[k], v, where)
        elif torch.is_tensor(v):
            if live[k].shape != v.shape:
                raise ValueError(
                    f"checkpoint tensor {where}: saved {tuple(v.shape)}, "
                    f"live {tuple(live[k].shape)}")
            live[k].copy_(v)
        else:
            live[k] = v
