"""The median of the benchmark's own host-clock span around each
``Predictor.predict`` call of the untraced window, without the request's
wait in the queue, in milliseconds: a serving cell below capacity."""

from perfbench.layer_metrics import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "serve", "predict_s")
