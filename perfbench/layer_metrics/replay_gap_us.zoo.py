"""The device's mean idle time before a generic ``Trainer`` step's graph
replay, in microseconds: start_i - end_{i-1} of the replays' device event
pairs over the untraced window's newest steps, chunk and epoch boundaries
included (the permutation staged, the loss fetch)."""

from perfbench.layer_metrics.port_spans import replays


def read(ctx):
    return replays(ctx, "train", "step", "gap_us")
