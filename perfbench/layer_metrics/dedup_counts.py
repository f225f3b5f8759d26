"""What the readers of the dedup kernel's own counters share: the measured
package's store counters ``dedup_rows.staged_rows`` and
``dedup_rows.rows`` (the rows the table update's row dedup summed through
its staged long-run path, and all the rows it summed), which the trainers
add at the fetches they make anyway (an epoch's losses, a regroup's masks
and losses). A traced stretch's reads go to counters of their own, so
these are the untraced fetches: the window's units and the set-up's steps
before its first fetch. None where the package counts nothing (a package
without the dedup kernel, or none run on a card)."""

from perfbench.layer_metrics.port_spans import store


def staged_pct(ctx, kind: str):
    """100 x the rows summed through the staged path over all rows."""
    st = store(ctx, kind)
    if st is None:
        return None
    rows = st.counts.get("dedup_rows.rows", 0)
    if not rows:
        return None
    return 100.0 * st.counts.get("dedup_rows.staged_rows", 0) / rows
