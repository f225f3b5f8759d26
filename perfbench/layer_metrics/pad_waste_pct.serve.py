"""The share of the rows a serving cell computed that were padding: 100 x
(padded rows - rows) / padded rows, from the Predictor's counters over the
run's requests (each padded to one of its buckets)."""

from perfbench.layer_metrics.port_spans import pad_waste_pct


def read(ctx):
    return pad_waste_pct(ctx, "serve")
