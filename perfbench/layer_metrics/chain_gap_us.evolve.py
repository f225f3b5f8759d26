"""The device's mean idle time before a HEMP candidate chain's graph
replay within one ``run_chains`` call, in microseconds: start_i - end_{i-1}
of the chains' device event pairs over the untraced window's newest
chains, each call's first replay left out."""

from perfbench.layer_metrics.port_spans import replays


def read(ctx):
    return replays(ctx, "evolve", "chain", "gap_us_within")
