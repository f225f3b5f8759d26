"""Inference / serving layer (counterpart of
``aread_tpu/serve/predictor.py``).

  * checkpoints are self-contained: meta.json carries the FeatureSpec, the
    model config and n_domain (``train.checkpoint.save_checkpoint``), so
    ``load_predictor(ckpt_dir)`` rebuilds the network with no training
    data or flags at hand;
  * requests are padded to a few fixed sizes (``BUCKETS``; above 8,192
    rows multiples of 8,192), and on a card each (mode, padded shape) is
    one captured CUDA graph, the counterpart of the JAX package's trace
    per shape: a request is one copy of its rows into the graph's static
    input, one replay and one copy of ``prob[:n]`` back
    (``train/step_graph.py`` ``GraphChunks.serve``; the first request of
    a (mode, shape) runs eagerly and captures). Elsewhere the same forward
    runs op by op (``EagerChunks.serve``); ``step_graph.eval_dispatch``
    decides;
  * AREAD single-domain requests run through that domain's HEMP mask
    (mode='domain_with_mask'), the evaluation contract of training, the
    masks picked on the device by row 0's domain; mixed-domain requests
    run as one forward in mode='batch_with_mask', the per-example masks
    gathered on the device from the stacked [n_domain, ...] masks,
    instead of one forward per domain; multi-tower models gather the
    sample's group tower; results come back in input order;
  * the two copies are a request's only host calls besides the replay
    (eagerly a DeepFM or MMoE with an f32 table also copies its gathered
    rows on the device, a node of the graph), and no other
    synchronization;
  * predictions are probabilities, equal to the trainers' evaluation
    path's to f32 round-off (a padded bucket and an evaluation batch may
    take different GEMM paths on the card);
  * ``compute_dtype='bfloat16'`` (the checkpoint's config) serves every
    product as one bf16 pass (``ops/precision.py``), as the JAX Predictor
    does; the trainers evaluate in f32 either way.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import functools
from typing import List, Optional

import numpy as np
import torch

from aread_tpu_torch.config import DOMAIN_SIZE, Config
from aread_tpu_torch.device import DeviceLike, resolve_device
from aread_tpu_torch.models import build_model
from aread_tpu_torch.models.aread import AREAD, full_mask
from aread_tpu_torch.models.base import FeatureSpec, gather_group
from aread_tpu_torch.ops.precision import matmul_precision_ctx
from aread_tpu_torch.train.checkpoint import load_checkpoint
from aread_tpu_torch.train.step_graph import Evals, Request
from aread_tpu_torch.train.trainer import (MULTI_TOWER_MODELS,
                                           adopt_state_dict)
from aread_tpu_torch.utils.profiling import STORE

BUCKETS = (128, 512, 2048, 8192)


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return -(-n // BUCKETS[-1]) * BUCKETS[-1]


class Predictor:
    """Serves one model. The module is the Predictor's own, a frozen copy
    in eval state: a trainer that goes on stepping the model it was made
    from does not move what is served. ``predict`` may be called from any
    thread; callers serialize the calls (``serve.server`` holds a lock
    around each): a request's graph writes a static output that the call
    reads before the next request."""

    # the dispatch of the requests: CUDA graph replays on a card, the
    # forward op by op elsewhere (step_graph.Evals)
    evals = Evals()

    def __init__(self, model, n_domain: int,
                 domain_mask: Optional[List] = None,
                 domain2group: Optional[np.ndarray] = None,
                 compute_dtype: str = "float32"):
        self.model = copy.deepcopy(model).eval()
        self.model.requires_grad_(False)
        self.device = self.model.device
        self.n_domain = n_domain
        self.domain_mask = domain_mask
        self.compute_dtype = compute_dtype
        self._evals = None
        self.is_aread = isinstance(self.model, AREAD)
        self.domain2group = domain2group
        self._d2g = (None if domain2group is None else torch.as_tensor(
            np.asarray(domain2group), dtype=torch.int64, device=self.device))
        if self.is_aread:
            fm = [np.asarray(m, bool) for m in full_mask(self.model.n_tower)]
            if domain_mask is not None and any(m is not None
                                               for m in domain_mask):
                # a domain without an evolved mask serves through the full
                # (all-edges) mask, as training does before an evolution
                masks = [fm if m is None else m for m in domain_mask]
            else:
                masks = [fm] * n_domain
            # every domain's masks stacked: [n_domain, T_prev, T] per level
            self._stacked_masks = tuple(
                torch.as_tensor(np.stack([np.asarray(masks[d][li], bool)
                                          for d in range(n_domain)]),
                                device=self.device)
                for li in range(len(masks[0])))

    # ------------------------------------------------------------- helpers
    def _check(self, x: np.ndarray) -> None:
        """Refuse a malformed request on the host. The embedding clips
        feature ids into the table, but a domain id indexes the stacked
        masks (or the group map) directly: out of range it would be a
        device-side assert, which ends the process's CUDA context instead
        of one request."""
        spec = self.model.spec
        if x.ndim != 2 or x.shape[1] != spec.n_columns:
            raise ValueError(f"x must be [N, {spec.n_columns}], got "
                             f"{x.shape}")
        if self.is_aread or self._d2g is not None:
            domain = x[:, spec.domain_idx]
            if domain.min() < 0 or domain.max() >= self.n_domain:
                raise ValueError(
                    f"x holds a domain outside [0, {self.n_domain})")

    def _forward(self, mode: str, xb: torch.Tensor) -> torch.Tensor:
        """Probabilities [B] of the padded rows ``xb`` on the device in
        ``mode`` ('generic', 'single' or 'mixed'), in the checkpoint's
        precision (entered here, so that it holds at a capture); nothing
        is read back to the host."""
        model = self.model
        dom = xb[:, model.spec.domain_idx].to(torch.int64)
        with matmul_precision_ctx(self.compute_dtype):
            if mode == "generic":
                # the mapped domain group, else the domain itself: the
                # trainer's gather falls back the same way
                group = dom if self._d2g is None else self._d2g[dom]
                prob = model(xb, group=group, train=False)["prob"]
                return gather_group(prob, group) if prob.dim() == 2 else prob
            if mode == "mixed":
                # per-example masks (pad rows are zeros, so they take
                # domain 0's mask)
                dm = tuple(sm[dom] for sm in self._stacked_masks)
                return model(xb, domain_mask=dm, mode="batch_with_mask",
                             train=False)["prob"]
            # one domain: its masks picked on the device by row 0's domain
            dm = tuple(sm.index_select(0, dom[:1])[0]
                       for sm in self._stacked_masks)
            return model(xb, domain_mask=dm, mode="domain_with_mask",
                         train=False)["prob"]

    def request(self, mode: str) -> Request:
        """A request in ``mode`` as both dispatches run it
        (``step_graph.Request``)."""
        return Request(name=f"{mode} request", key=mode,
                       fn=functools.partial(self._forward, mode))

    def mode_of(self, x: np.ndarray) -> str:
        """'generic' for a model without masks; for AREAD 'single' when
        every row is of one domain, else 'mixed'."""
        if not self.is_aread:
            return "generic"
        domain = x[:, self.model.spec.domain_idx]
        return "mixed" if len(np.unique(domain)) > 1 else "single"

    # -------------------------------------------------------------- public
    def predict(self, x: np.ndarray) -> np.ndarray:
        """``x``: int array [N, n_columns] of encoded feature ids (the
        canonical CSV's layout: the one-hot columns, then the flattened
        padded history sequences). Returns [N] float32 probabilities.

        Each request is a ``serve.predict`` span, its id the request's
        sequence number (``serve.requests``), with the children
        ``serve.prepare`` (check, mode, pad), ``serve.copy_in``,
        ``serve.replay`` (a graph's, with a device event pair) or
        ``step_graph.eager``, ``serve.fetch`` (the copy out, which waits for
        the device) and ``serve.convert``; its rows and padded rows are
        counted (``utils/profiling.py``)."""
        with STORE.span("serve.predict", STORE.count("serve.requests")):
            with STORE.span("serve.prepare"):
                x = np.asarray(x, np.int32)
                n = x.shape[0]
                if n == 0:
                    return np.zeros((0,), np.float32)
                if getattr(self.model, "eval_dlm_update", False):
                    # the JAX Predictor applies the model without a
                    # mutable collection, and flax refuses ADL's centre
                    # update there
                    raise ValueError(
                        "ADL with adl_eval_dlm_update moves its cluster "
                        "centres at every forward; a Predictor serves a "
                        "frozen model (rebuild it with "
                        "adl_eval_dlm_update=False to serve these weights)")
                self._check(x)
                xb = np.zeros((_bucket(n), x.shape[1]), np.int32)
                xb[:n] = x
                req = self.request(self.mode_of(x))
            # entered here and not at construction: the modes are
            # thread-local, and a threaded server calls from a new thread
            # per request; every static buffer of a graph is made and
            # written in inference mode
            with torch.inference_mode():
                prob = self.evals.serve(req, xb)
                with STORE.span("serve.fetch"):
                    host = prob[:n].cpu()
                STORE.harvest("request")
                with STORE.span("serve.convert"):
                    out = host.numpy().astype(np.float32)
            STORE.count("serve.rows", n)
            STORE.count("serve.padded_rows", len(xb))
            return out


def _coerce_like(template, value):
    """A JSON round trip turns tuples into lists; restore tuples
    (recursively) wherever the dataclass default is a tuple."""
    if isinstance(template, tuple) and isinstance(value, list):
        return tuple(_coerce_like(template[0] if template else None, v)
                     for v in value)
    if isinstance(value, list) and value and isinstance(value[0], list):
        return tuple(tuple(v) for v in value)
    return value


def load_predictor(ckpt_path: str, device: DeviceLike = None) -> Predictor:
    """Rebuild a Predictor from a self-contained checkpoint directory
    (written by ``python -m aread_tpu_torch`` or ``save_checkpoint`` with
    spec / run_config / n_domain) on ``device`` (default: the card; raises
    without one unless 'cpu' is asked for). Config fields of meta.json
    that this package does not have are dropped, so the JAX package's
    meta.json reads as well."""
    dev = resolve_device(device)
    with open(os.path.join(ckpt_path, "meta.json")) as f:
        meta = json.load(f)
    if "spec" not in meta or "config" not in meta:
        raise ValueError(
            f"{ckpt_path} lacks spec/config metadata; re-save with spec= "
            "and run_config= to serve from it")

    spec_fields = {f.name for f in dataclasses.fields(FeatureSpec)}
    spec_kwargs = {k: v for k, v in meta["spec"].items() if k in spec_fields}
    spec_kwargs["one_hot_dims"] = tuple(spec_kwargs["one_hot_dims"])
    spec = FeatureSpec(**spec_kwargs)

    cfg_fields = {f.name: f.default for f in dataclasses.fields(Config)}
    cfg = Config(**{k: _coerce_like(cfg_fields.get(k), v)
                    for k, v in meta["config"].items() if k in cfg_fields})
    n_domain = meta.get("n_domain")
    if n_domain is None:
        n_domain = len(DOMAIN_SIZE.get(cfg.dataset_name, ()))
    n_domain = int(n_domain)
    # the table's row count follows from meta.json alone: build_model pads
    # it exactly when config.sparse_table_grad says so, as training did
    model = build_model(cfg, spec, n_domain, device=dev)
    ck = load_checkpoint(ckpt_path, n_domain=n_domain, map_location=dev)
    adopt_state_dict(model, ck["state_dict"])

    d2g = cfg.domain2group()
    if d2g is not None:
        d2g = np.array(d2g)
    elif cfg.model in MULTI_TOWER_MODELS:
        # the training CLI's modulo fallback for a dataset without a
        # precomputed grouping; must match training
        d2g = np.arange(n_domain) % min(cfg.n_tower, n_domain)
    return Predictor(model, n_domain, domain_mask=ck.get("domain_mask"),
                     domain2group=d2g, compute_dtype=cfg.compute_dtype)
