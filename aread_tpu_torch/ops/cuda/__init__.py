"""The port's hand-written CUDA kernels: sources, the build script
(``build.py``) and the launch counts of their Python wrappers."""

from __future__ import annotations

from typing import Dict

# launches of each kernel's wrapper (one per launch of its kernel, nowhere
# else); chip_smoke.py zeroes them before a path and reads them after it
launch_counts: Dict[str, int] = {"sparse_adam": 0, "fused_adam": 0,
                                 "gather_rows": 0, "adam_attrib": 0,
                                 "dedup_rows": 0}
# launches recorded into the CUDA graph being captured: a capture runs no
# kernel, so ``count_launch`` puts them here, and ``train/step_graph.py``
# adds a graph's launches to ``launch_counts`` once per replay
captured_counts: Dict[str, int] = dict.fromkeys(launch_counts, 0)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel on the current CUDA stream: counted
    now, or, while that stream is capturing a CUDA graph, recorded for the
    graph's replays."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        captured_counts[name] += 1
    else:
        launch_counts[name] += 1
