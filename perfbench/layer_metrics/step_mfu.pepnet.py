"""PEPNet's whole generic ``Trainer`` step's share of the chip's peak over
the untraced window: the least time a step could take
(``roofline.step_seconds_bound``, with the multiply-adds and parameters
of ``reference/pepnet.py``; at these widths the bytes bound it) times the
window's steps, over the window's seconds."""

from perfbench import roofline
from perfbench.layer_metrics import step_mfu


def read(ctx):
    return step_mfu(ctx, "train", roofline.step_seconds_bound)
