"""The median host milliseconds inside a generic ``Trainer`` step's
``graph.replay()`` over the untraced window's newest steps (the
``step_graph.replay`` span): the launch with no profiler running, the
counterpart of ``graph_launch_ms.zoo``."""

from perfbench.layer_metrics.port_spans import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "train", "step_graph.replay")
