"""The table update's row dedup in the generic Trainer's epochs (MMoE),
over the untraced window: the share of the rows summed through the
kernel's staged long-run path (a run longer than a warp's 32 lanes, its
rows staged in shared memory by a block ahead of the adds), 100 x staged /
all rows from the package's counters (``dedup_counts``)."""

from perfbench.layer_metrics.dedup_counts import staged_pct


def read(ctx):
    return staged_pct(ctx, "train")
