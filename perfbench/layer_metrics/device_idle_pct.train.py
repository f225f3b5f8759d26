"""The device's idle share over the traced stretch of AREAD's bagging
steps: 100 x (1 - the union of its kernel, copy and set intervals / the
stretch's length)."""

from perfbench.layer_metrics import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
