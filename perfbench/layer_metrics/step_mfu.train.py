"""The whole AREAD bagging step's share of the chip's peak over the untraced
window: the least time a step could take (the larger of its operations at
the float32 peak and its compulsory bytes at the HBM bandwidth,
``roofline.step_seconds_bound``; at these widths the bytes bound it)
times the window's steps, over the window's seconds."""

from perfbench import roofline
from perfbench.layer_metrics import step_mfu


def read(ctx):
    return step_mfu(ctx, "train", roofline.step_seconds_bound)
