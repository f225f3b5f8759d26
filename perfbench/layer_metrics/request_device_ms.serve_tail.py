"""The median device milliseconds of a request's graph replay (its event
pair) over the untraced window's newest requests: the forward alone, in a
serving cell below capacity."""

from perfbench.layer_metrics.port_spans import replays


def read(ctx):
    return replays(ctx, "serve", "request", "device_ms")
