"""The median over the untraced window's regroups of the
``hemp_mask_evolution`` span less its ``hemp.chains`` child, in
milliseconds: the host's draw, staging, fetch and selection around the
chains."""

from perfbench.layer_metrics.port_spans import own_p50_ms


def read(ctx):
    return own_p50_ms(ctx, "evolve", "hemp_mask_evolution", "hemp.chains")
