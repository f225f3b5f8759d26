"""Per-layer metrics, one reader a file named by the metric:
``<metric>.py`` holds ``read(ctx) -> float | None`` (``ctx``: the cell,
its configuration and mix, the driver's kind, the untraced window's
readings and the traced stretch after it, ``perfbench.run.Context``).
Host-clock metrics read the window, where no profiler runs; device
metrics read the stretch. A reader that finds nothing to read returns
None, and the metric is left out of the result line. This module holds
what several readers share."""

import statistics

import re

from perfbench import roofline

# kernel 1's kernels by the names the profiler gives them
SPARSE_ADAM = re.compile(r"(?<![A-Za-z_])(slot_scatter|slot_reset|"
                         r"adam_sweep_\w+)")


def idle_pct(ctx, kind):
    if ctx.kind != kind or not ctx.data.device:
        return None
    return 100.0 * (1.0 - ctx.data.busy_s() / ctx.data.window_s)


def sparse_adam_pct(ctx, kind):
    if ctx.kind != kind:
        return None
    recs = [(n, a, b) for n, a, b in ctx.data.device if SPARSE_ADAM.search(n)]
    updates = sum(1 for n, _, _ in recs if "adam_sweep" in n)
    if not updates:
        return None
    seconds = sum(b - a for _, a, b in recs) / 1e9
    bound = updates * roofline.sparse_adam_bytes(ctx.cfg) / roofline.PEAK_HBM_BYTES
    return 100.0 * bound / seconds


def step_mfu(ctx, kind, seconds_bound):
    """100 x the least time of the window's units (``seconds_bound(cfg)``
    each, ``perfbench.roofline``) over the window's seconds."""
    w = ctx.window
    if ctx.kind != kind or not w.get("units"):
        return None
    return 100.0 * w["units"] * seconds_bound(ctx.cfg) / w["seconds"]


def graph_launch_ms(ctx, kind):
    if ctx.kind != kind:
        return None
    n, s = ctx.data.host_time("cudaGraphLaunch")
    return 1e3 * s / ctx.data.units if n else None


def span_p50_ms(ctx, kind, span):
    spans = ctx.window.get("spans", {}).get(span)
    if ctx.kind != kind or not spans:
        return None
    return 1e3 * statistics.median(spans)
