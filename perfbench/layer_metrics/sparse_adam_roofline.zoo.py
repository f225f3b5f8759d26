"""Kernel 1's share of its byte bound over the generic ``Trainer``'s traced
steps: its compulsory bytes an update (``roofline.sparse_adam_bytes``) at
the chip's HBM bandwidth, times the updates the device ran (its sweep
records), over the summed time of every kernel of the update (the slot
scatter, the sweep, the slot reset where one runs)."""

from perfbench.layer_metrics import sparse_adam_pct


def read(ctx):
    return sparse_adam_pct(ctx, "train")
