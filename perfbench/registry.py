"""Code found by the names in ``BENCHMARK.json`` and the files it names,
so that a cell, a configuration, a model, a driver or a per-layer metric
is added as new files and entries, and no file there is edited:

* ``drivers/<name>.py``: the driver a traffic mix names (``"driver"``),
  its class ``Driver``;
* ``reference/<model>.py``: the plain reference of the model a
  configuration names (``"model"``): its parameters, forward, loss and
  multiply-add count;
* ``layer_metrics/<metric>.py``: a per-layer metric's reader, ``read``.

A checkout's own ``perfbench/`` is searched first, then this package.
"""

from __future__ import annotations

import importlib
import importlib.util
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
_roots: List[Path] = [HERE]
_loaded: Dict[Path, object] = {}
_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def use(root: Path) -> None:
    """Search the checkout at ``root`` first."""
    here = (Path(root) / "perfbench").resolve()
    _roots[:] = [here] + ([HERE] if here != HERE else [])


def find(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the first root that has it."""
    for root in _roots:
        path = root / kind / f"{name}.py"
        if path.is_file():
            break
    else:
        raise SystemExit(f"perfbench: no {kind}/{name}.py")
    if root == HERE and _IDENT.match(name):
        return importlib.import_module(f"perfbench.{kind}.{name}")
    if path not in _loaded:
        spec = importlib.util.spec_from_file_location(
            "perfbench_found_" + re.sub(r"\W", "_", f"{kind}_{name}"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def driver(name: str):
    return find("drivers", name).Driver


def model(cfg: Dict):
    """The reference module of the configuration's model."""
    return find("reference", cfg["model"])


def reader(metric: str):
    return find("layer_metrics", metric).read
