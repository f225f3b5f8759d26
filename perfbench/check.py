"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the reference works out, held to its limit in
``perfbench/limits/<cell>.json``.

Training cells compare, over the first steps the set-up drove through the
window's own call:

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps (the reported loss: data loss, L2 terms, the table's);
* ``grad_gap``: the first step's gradient as each optimizer holds it
  (its first moment over 1 - b1), by the worst leaf: |‖g‖ - ‖g_ref‖|
  over the larger of ‖g_ref‖ and the median leaf's ‖g_ref‖;
* ``change_gap``: the parameters' change over the steps, by the worst
  leaf, measured the same way. Leaves whose data gradient in the
  reference is under a thousandth of the median leaf's (a linear bias
  before a BatchNorm, a head the step does not use) move under Adam by
  round-off and the decay alone, and are left out.

Serving cells compare ``prob_gap``: the largest |p - p_ref| over every
row of a sample of the requests served in the window.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

EXCLUDE_BELOW = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves=None) -> Tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    names = list(ref) if leaves is None else list(leaves)
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    med = statistics.median(ref[n] for n in ref)
    worst, which = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g >= worst:
            worst, which = g, n
    return worst, which


def moving_leaves(gdata: Dict[str, float]) -> List[str]:
    med = statistics.median(gdata.values())
    return [n for n, v in gdata.items() if v >= EXCLUDE_BELOW * med]


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    leaves) -> float:
    """The gap of the median leaf's change: |‖d‖ - ‖d_ref‖| of the leaf
    whose reference change is the median one, over its reference change."""
    order = sorted(leaves, key=lambda n: ref[n])
    n = order[len(order) // 2]
    return abs(prog[n] - ref[n]) / max(ref[n], 1e-30)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of a training cell from each side's readings:
    ``losses`` [steps], ``m1`` and ``change`` {leaf: norm}; the reference's
    ``gdata`` {leaf: norm of its data gradient at step 1}. Beside the three,
    ``change_gap_median``: the median leaf's change gap."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("step counts differ")
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    grad, _ = leaf_gap(prog["m1"], ref["m1"])
    moving = moving_leaves(ref["gdata"])
    change, _ = leaf_gap(prog["change"], ref["change"], moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "change_gap_median": median_leaf_gap(prog["change"],
                                                 ref["change"], moving)}


def worst_leaves(prog: Dict, ref: Dict, k: int = 3):
    """The ``k`` leaves of the largest change gaps, with their gaps and
    their data gradients over the median leaf's: where a gap comes from."""
    med_c = statistics.median(ref["change"].values())
    med_g = statistics.median(ref["gdata"].values())
    gaps = sorted(((abs(prog["change"][n] - ref["change"][n])
                    / max(ref["change"][n], med_c), n)
                   for n in moving_leaves(ref["gdata"])), reverse=True)[:k]
    return [[n, g, ref["gdata"][n] / med_g] for g, n in gaps]


def compared(numbers: Dict[str, float], limits: Dict[str, float]
             ) -> Dict[str, List[float]]:
    """{name: [value, limit]} of every number the cell's limits name, in
    their order; a limit without a number is an error."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"limits {sorted(missing)} have no number")
    return {k: [numbers[k], limits[k]] for k in limits}


def is_correct(cmp: Dict[str, List[float]]) -> bool:
    return all(v == v and v <= lim for v, lim in cmp.values())
