"""The median over the untraced window's newest requests of the
``serve.predict`` span less its ``serve.fetch`` child (the copy out, which
waits for the device), in milliseconds: the host's own share of a request,
in a serving cell below capacity."""

from perfbench.layer_metrics.port_spans import own_p50_ms


def read(ctx):
    return own_p50_ms(ctx, "serve", "serve.predict", "serve.fetch")
