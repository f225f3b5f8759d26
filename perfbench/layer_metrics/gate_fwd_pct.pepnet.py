"""The share of PEPNet's training step that its five Gate NUs' forward
takes on the device, in percent: per read of the step graph's captured
event pairs (the package's store, read at the untraced window's loss
fetches, one read an epoch, of the replay that ran last), 100 x the sum of
that replay's ``pepnet.gate`` pairs (each Gate NU's MLP, its 2 * sigmoid
and the multiply that applies it) over its ``pepnet.step`` pair (the
whole captured step); the median over the reads.

The forward only: autograd interleaves the gates' backward with the
towers' and the attention's, so no pair can enclose it. None where the
package keeps no captured pairs (a package before them, or the CPU)."""

import collections
import statistics

from perfbench.layer_metrics.port_spans import store


def read(ctx):
    st = store(ctx, "train")
    records = getattr(st, "captured_records", None)
    if records is None:
        return None
    gates = collections.defaultdict(float)
    for replay, ms in records("pepnet.gate"):
        gates[replay] += ms
    pct = [100.0 * gates[replay] / ms for replay, ms in records("pepnet.step")
           if replay in gates and ms > 0]
    return statistics.median(pct) if pct else None
