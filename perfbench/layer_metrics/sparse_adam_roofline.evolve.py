"""Kernel 1's share of its byte bound over the chains of a regroup cell's
traced stretch: its compulsory bytes an update at the chip's HBM
bandwidth, times the updates the device ran, over the summed time of every
kernel of the updates."""

from perfbench.layer_metrics import sparse_adam_pct


def read(ctx):
    return sparse_adam_pct(ctx, "evolve")
