"""The port's hand-written CUDA kernels: sources, the build script
(``build.py``) and the launch counts of their Python wrappers."""

from __future__ import annotations

from typing import Dict

# launches of each kernel's wrapper (one per launch of its kernel, nowhere
# else); chip_smoke.py zeroes them before a path and reads them after it
launch_counts: Dict[str, int] = {"sparse_adam": 0, "fused_adam": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
