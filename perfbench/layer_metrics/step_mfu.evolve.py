"""The chains' share of the chip's peak over a regroup cell's untraced
window: the least time a chain could take (its adapt steps at
``roofline.step_seconds_bound`` each, its probes' forward products at the
float32 peak, ``roofline.chain_seconds_bound``) times the window's chains,
over the window's seconds."""

from perfbench import roofline
from perfbench.layer_metrics import step_mfu


def read(ctx):
    return step_mfu(ctx, "evolve", roofline.chain_seconds_bound)
