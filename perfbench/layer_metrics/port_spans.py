"""What the readers of the measured package's own records share: its store
of spans, counters and device event pairs (``STORE`` of
``aread_tpu_torch/utils/profiling.py``), imported inside a reader's call,
as the drivers import the package inside theirs. The readers take the
records of the untraced window (the store keeps a traced stretch's apart)
and return None where the package has no store or the store has no such
record: on the CPU no replay records a device event pair."""

import statistics


def store(ctx, kind: str):
    """The package's store, or None in a cell of another kind or where the
    package keeps none."""
    if ctx.kind != kind:
        return None
    from aread_tpu_torch.utils import profiling

    st = getattr(profiling, "STORE", None)
    return st if hasattr(st, "summary") else None


def replays(ctx, kind: str, replay: str, key: str):
    """A figure of one kind of replay ('step', 'chain', 'request') over its
    untraced event pairs (``STORE.summary()['replays']``): 'gap_us',
    'gap_us_within', 'gap_us_first' or 'device_ms'."""
    st = store(ctx, kind)
    if st is None:
        return None
    return st.summary()["replays"].get(replay, {}).get(key)


def span_p50_ms(ctx, kind: str, name: str):
    """The median of a span's untraced records, in milliseconds."""
    st = store(ctx, kind)
    recs = [] if st is None else st.records(name)
    if not recs:
        return None
    return statistics.median(b - a for a, b, _, _ in recs) / 1e6


def own_p50_ms(ctx, kind: str, outer: str, inner: str):
    """The median over units (a request, a regroup) of the span ``outer``
    less its child ``inner`` of the same id, in milliseconds."""
    st = store(ctx, kind)
    if st is None:
        return None
    within = {uid: b - a for a, b, _, uid in st.records(inner)}
    own = [(b - a) - within[uid] for a, b, _, uid in st.records(outer)
           if uid in within]
    return statistics.median(own) / 1e6 if own else None


def pad_waste_pct(ctx, kind: str):
    """100 x (padded rows - rows) / padded rows over the requests served."""
    st = store(ctx, kind)
    if st is None:
        return None
    padded = st.counts.get("serve.padded_rows", 0)
    if not padded:
        return None
    return 100.0 * (padded - st.counts.get("serve.rows", 0)) / padded
