"""Run-metrics sink (counterpart of ``aread_tpu/utils/runlog.py``).

The reference calls ``wandb.log`` at its epoch and test points but never
``wandb.init``, so nothing is recorded. Here the same call points write
JSON lines to ``<log_dir>/<run_name>/metrics.jsonl`` (one object per log
call, with a monotonic ``_step`` and the wall clock ``_ts``) and a
``config.json`` snapshot of the run's config, a format that ``tail -f``,
pandas or a dashboard reads without dependencies.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _jsonable(v: Any):
    """``v`` as JSON-serialisable values: numpy and torch scalars and
    arrays as Python numbers and lists, NaN and inf as None (they are not
    valid JSON; a single-class domain's AUC is NaN), anything else
    unknown as its repr."""
    if isinstance(v, (float, np.floating)) and not np.isfinite(v):
        return None
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return _jsonable(v.tolist())
    if isinstance(v, torch.Tensor):
        return _jsonable(v.detach().cpu().tolist())
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class RunLogger:
    """Append-only JSONL metric logger.

    >>> logger = RunLogger("save/aliccp/logs", config=cfg)
    >>> logger.log({"valid": result}, step=1)
    >>> logger.close()

    ``RunLogger(None)`` (or an empty directory) is a no-op sink, so the
    trainers call it unconditionally."""

    def __init__(self, log_dir: Optional[str], config: Any = None,
                 run_name: Optional[str] = None):
        self._fh = None
        self._step = 0
        self.log_dir = None
        if not log_dir:
            return
        run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.log_dir = os.path.join(log_dir, run_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._fh = open(os.path.join(self.log_dir, "metrics.jsonl"), "a",
                        buffering=1)
        if config is not None:
            cfg = (dataclasses.asdict(config)
                   if dataclasses.is_dataclass(config) else dict(config))
            with open(os.path.join(self.log_dir, "config.json"), "w") as f:
                json.dump(_jsonable(cfg), f, indent=1)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if self._fh is None:
            return
        self._step = self._step + 1 if step is None else int(step)
        rec = {"_step": self._step, "_ts": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
