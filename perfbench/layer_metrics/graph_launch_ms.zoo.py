"""Host milliseconds a generic ``Trainer`` step spends in
``cudaGraphLaunch``: the profiler's host records of the call over the
traced stretch, their durations summed, over the steps. None when no step
was a graph replay."""

from perfbench.layer_metrics import graph_launch_ms


def read(ctx):
    return graph_launch_ms(ctx, "train")
