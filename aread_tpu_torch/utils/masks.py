"""HEMP mask machinery (counterpart of ``aread_tpu/utils/masks.py``).

Masks are lists of boolean arrays shaped [1,T0], [T0,T1], ..., [T_last,1].
Generation, validation, pruning, gate accumulation and candidate selection
run on the host in numpy; the random stream is numpy's
``default_rng(seed)``, drawn in the JAX package's order, so the same seed
gives the same masks.

``validate_mask_tensor`` and ``prune_mask_tensor`` are the twins of the
JAX package's device-side ``validate_mask_jax`` / ``prune_mask_jax`` on
``torch`` tensors of either device: the same results as the host
functions, without a fetch of the gate values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Mask = List[np.ndarray]


def mask_shapes(n_tower: Sequence[int]) -> List[Tuple[int, int]]:
    shapes = [(1, n_tower[0])]
    for l in range(1, len(n_tower)):
        shapes.append((n_tower[l - 1], n_tower[l]))
    shapes.append((n_tower[-1], 1))
    return shapes


def edge_num(n_tower: Sequence[int]) -> int:
    return int(sum(a * b for a, b in mask_shapes(n_tower)))


def count_active_edge(mask: Mask) -> int:
    return int(sum(int(np.sum(m)) for m in mask))


def create_single_full_mask(n_tower: Sequence[int], fill_value: float,
                            rng: np.random.Generator) -> Mask:
    """All-zero, all-one or Bernoulli(fill_value) masks."""
    shapes = mask_shapes(n_tower)
    if fill_value == 0:
        return [np.zeros(s, bool) for s in shapes]
    if fill_value == 1:
        return [np.ones(s, bool) for s in shapes]
    if 0 < fill_value < 1:
        return [rng.random(s) < fill_value for s in shapes]
    raise ValueError("fill_value in mask must be 0 or 1 or (0, 1)")


def validate_mask(mask: Mask, add_input: bool = True, add_output: bool = True,
                  remove_hidden: bool = True) -> Mask:
    """Graph repair: input edges for live level-0 towers, output edges for
    live leaves, then sever hidden towers with no in- or out-edges until
    none is left (worklist)."""
    mask = [m.copy() for m in mask]
    n_level = len(mask) - 1
    n_tower = [m.shape[1] for m in mask[:-1]]
    if add_input:
        for t in range(n_tower[0]):
            if mask[1][t, :].any():
                mask[0][:, t] = True
    if add_output:
        for t in range(n_tower[-1]):
            if mask[-2][:, t].any():
                mask[-1][t, :] = True
    if remove_hidden:
        to_check = [(l, t) for l in range(1, n_level) for t in range(n_tower[l])]
        while to_check:
            l, t = to_check.pop(0)
            if not mask[l][:, t].any():
                mask[l + 1][t, :] = False
            if not mask[l + 1][t, :].any():
                if l > 1:
                    for prev_t in np.nonzero(mask[l][:, t])[0].tolist():
                        if (l - 1, prev_t) not in to_check:
                            to_check.append((l - 1, prev_t))
                mask[l][:, t] = False
    return mask


def has_output(mask: Mask) -> bool:
    return bool(mask[-1].any())


def prune_threshold(gate_values: Sequence[np.ndarray],
                    prun_ratio: float) -> Optional[float]:
    """min over levels of quantile(prun_ratio) over a level's positive
    gate values; None when no level has one."""
    threshold = 1.0
    for gv in gate_values:
        pos = gv[gv > 1e-8]
        if pos.size:
            threshold = min(threshold,
                            float(np.quantile(pos.ravel(), prun_ratio)))
    return None if threshold == 1.0 else threshold


def prune_mask(mask: Mask, gate_means: Sequence[np.ndarray],
               prun_ratio: float = 0.05) -> Mask:
    """One progressive-pruning step on the host: AND ``gate >= threshold``
    into the hidden-level masks, validate, and revert to ``mask`` if the
    output dies or no gate value is positive (the semantics of the JAX
    package's ``prune_mask_jax``, with ``prun_single_mask``'s numpy
    quantile)."""
    gate_values = [np.asarray(g) for g in gate_means]
    threshold = prune_threshold(gate_values, prun_ratio)
    before = [np.asarray(m).copy() for m in mask]
    if threshold is None:
        return before
    new_mask = [m.copy() for m in before]
    for li, gv in enumerate(gate_values):
        new_mask[li + 1] = new_mask[li + 1] & (gv >= threshold)
    valid = validate_mask(new_mask)
    return valid if has_output(valid) else before


# ------------------------------------------------------------- tensor twins
def validate_mask_tensor(mask: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``validate_mask`` on bool tensors, with no host round trip. The
    removal operator is monotone, so the fixpoint does not depend on the
    order: one ascending pass severs every tower without an in-edge (and,
    through it, the towers behind it), one descending pass every tower
    without an out-edge; a tower severed in the second pass had no
    out-edge left, so it starves no later tower and the result is the
    worklist's."""
    m = list(mask)
    n_level = len(m) - 1
    m[0] = m[0] | m[1].any(dim=1)[None, :]
    m[-1] = m[-1] | m[-2].any(dim=0)[:, None]
    for l in range(1, n_level):
        m[l + 1] = m[l + 1] & m[l].any(dim=0)[:, None]
    for l in range(n_level - 1, 0, -1):
        m[l] = m[l] & m[l + 1].any(dim=1)[None, :]
    return tuple(m)


def prune_mask_tensor(mask: Sequence[torch.Tensor],
                      gate_means: Sequence[torch.Tensor],
                      prun_ratio: float = 0.05) -> Tuple[torch.Tensor, ...]:
    """``prune_mask`` on tensors (bool masks, f32 gate means) of either
    device, with no host round trip: the threshold is quantile(prun_ratio)
    over the positive entries by numpy's 'linear' rule, spelled out on the
    sorted values; the pruned mask is validated and the input kept if the
    output dies or no gate value is positive. Nothing is read back to the
    host and nothing is copied from it, so a CUDA graph can capture it:
    the quantile's two order statistics are gathers by device indices."""
    f32 = torch.float32
    dev = gate_means[0].device
    inf = torch.full((), float("inf"), dtype=f32, device=dev)
    threshold = inf
    any_pos = torch.zeros((), dtype=torch.bool, device=dev)
    for gv in gate_means:
        flat = torch.sort(gv.reshape(-1)).values  # non-positives first
        n = flat.shape[0]
        npos = torch.sum(flat > 1e-8)
        any_pos = any_pos | (npos > 0)
        start = n - npos
        q = prun_ratio * (npos - 1).to(f32)
        lo = torch.clamp(torch.floor(q).to(torch.int64), 0, n - 1)
        frac = q - lo.to(f32)
        a, b = flat.index_select(0, torch.clamp(
            start + lo + torch.arange(2, device=dev), 0, n - 1)).unbind()
        lvl = torch.where(npos > 0,
                          torch.where(lo + 1 < npos,
                                      a * (1 - frac) + b * frac, a), inf)
        threshold = torch.minimum(threshold, lvl)
    new = list(mask)
    for li, gv in enumerate(gate_means):
        new[li + 1] = new[li + 1] & (gv >= threshold)
    valid = validate_mask_tensor(new)
    keep = any_pos & valid[-1].any()
    return tuple(torch.where(keep, v, o) for v, o in zip(valid, mask))


def cluster_domain_masks(cluster_z: np.ndarray, n_tower: Sequence[int],
                         n_domain: int):
    """Per-domain masks from a hierarchical-clustering linkage matrix
    (scipy style: row i merges clusters ``int(z[i,0])`` and ``int(z[i,1])``
    into cluster ``n_domain + i``). Walking the merges from n_domain
    clusters down to n_tower[0], whenever the number of live clusters
    equals a level's tower count those clusters become that level's
    towers; each domain activates the outgoing edges of every tower whose
    cluster holds it, and ``validate_mask`` repairs input and output
    edges. Returns (masks, tower2cluster): tower2cluster[l][t] lists the
    domains of tower t of level l."""
    n_tower = tuple(int(t) for t in n_tower)
    n_level = len(n_tower)
    shapes = mask_shapes(n_tower)
    masks: List[Mask] = [[np.zeros(s, bool) for s in shapes]
                         for _ in range(n_domain)]
    clusters: List[List[int]] = [[i] for i in range(n_domain)]
    cluster_exist: List[int] = list(range(n_domain))
    tower2cluster: List[Optional[List[int]]] = [None] * n_level
    # n_domain itself may be a level's tower count: the identity
    # clustering is then that level's assignment
    if n_domain in n_tower:
        tower2cluster[n_tower.index(n_domain)] = list(cluster_exist)
    n_merge = n_domain - n_tower[0]
    if len(cluster_z) < n_merge:
        raise ValueError(
            f"linkage matrix has {len(cluster_z)} rows; need at least "
            f"{n_merge} (= n_domain - n_tower[0]) to reach {n_tower[0]} clusters")
    for i in range(n_merge):
        line = cluster_z[i]
        clusters.append(clusters[int(line[0])] + clusters[int(line[1])])
        cluster_exist.append(i + n_domain)
        cluster_exist.remove(int(line[0]))
        cluster_exist.remove(int(line[1]))
        if len(cluster_exist) in n_tower:
            tower2cluster[n_tower.index(len(cluster_exist))] = list(cluster_exist)
    for l in range(n_level):
        if tower2cluster[l] is None:
            raise ValueError(
                f"clustering never passed through {n_tower[l]} clusters for "
                f"level {l} (n_domain={n_domain}, n_tower={n_tower})")
    t2c_domains: List[List[List[int]]] = []
    for l in range(n_level):
        level_clusters = []
        for t in range(n_tower[l]):
            domain_cluster = clusters[tower2cluster[l][t]]
            level_clusters.append(list(domain_cluster))
            for d in domain_cluster:
                # outgoing edges of level-l tower t live in mask[l+1]
                masks[d][l + 1][t, :] = True
        t2c_domains.append(level_clusters)
    valid = [validate_mask(m) for m in masks]
    return valid, t2c_domains


@dataclasses.dataclass
class GateAccumulator:
    """One domain's recorded mean gate values; each record is a tuple of
    [T_{l-1}, T_l] matrices for levels 1..n_level-1."""

    n_tower: Tuple[int, ...]

    def __post_init__(self):
        self.reset()

    def reset(self):
        self._records: List[Tuple[np.ndarray, ...]] = []

    def add(self, gate_means: Sequence[np.ndarray]):
        self._records.append(tuple(np.asarray(g) for g in gate_means))

    def __len__(self):
        return len(self._records)

    def mean_values(self) -> List[np.ndarray]:
        """Level-indexed list: zeros for level 0 and the output level, the
        mean over the records for levels 1..n_level-1. A domain with no
        record yields all-zero matrices; the threshold is then None and
        mask generation falls back to 'rand'."""
        n_level = len(self.n_tower)
        values = [np.zeros((1, self.n_tower[0]), np.float32)]
        for li in range(n_level - 1):
            if self._records:
                stacked = np.stack([r[li] for r in self._records], axis=0)
                values.append(stacked.mean(axis=0))
            else:
                values.append(np.zeros((self.n_tower[li], self.n_tower[li + 1]),
                                       np.float32))
        values.append(np.zeros((self.n_tower[-1], 1), np.float32))
        return values


def gate_threshold(mean_values: List[np.ndarray],
                   active_percent: float) -> Optional[float]:
    """Quantile(1 - active_percent) over the positive mid-level gate
    means; None if there is none."""
    threshold = 1.0
    for ts in mean_values[1:-1]:
        pos = ts[ts > 1e-8]
        if pos.size:
            threshold = min(threshold, float(np.quantile(pos.ravel(), 1 - active_percent)))
    return None if threshold == 1.0 else threshold


class HempMaskState:
    """Host-side HEMP state of all domains: the current masks, the
    candidates of the running evolution, the gate accumulators and the
    candidates' probe losses."""

    def __init__(self, n_tower: Sequence[int], n_domain: int, seed: int = 0):
        self.n_tower = tuple(int(t) for t in n_tower)
        self.n_domain = n_domain
        self.rng = np.random.default_rng(seed)
        self.edge_num = edge_num(n_tower)
        self.domain_mask: List[Optional[Mask]] = [None] * n_domain
        self.reset_for_mask_update()
        # the last fast-adapt step's gate values
        self.tmp_gate_record: Optional[Tuple[np.ndarray, ...]] = None

    def reset_for_mask_update(self, d: Optional[int] = None):
        if d is None:
            self.gate_acc = [GateAccumulator(self.n_tower) for _ in range(self.n_domain)]
            self.gate_value_threshold: List[Optional[float]] = [None] * self.n_domain
            self.candidate_domain_mask: List[List[Mask]] = [[] for _ in range(self.n_domain)]
            self.eval_loss: List[List[List[float]]] = [[] for _ in range(self.n_domain)]
        else:
            self.gate_acc[d] = GateAccumulator(self.n_tower)
            self.gate_value_threshold[d] = None
            self.candidate_domain_mask[d] = []
            self.eval_loss[d] = []

    def get_state(self) -> Dict:
        """What the next evolution depends on beside ``domain_mask`` (which
        a checkpoint holds by itself): the generator's position and the
        gate records waiting for the next regroup. Candidates and probe
        losses live only inside an evolution."""
        return {"rng": self.rng.bit_generator.state,
                "gate_records": [[[np.array(g) for g in rec]
                                  for rec in acc._records]
                                 for acc in self.gate_acc]}

    def set_state(self, state: Dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.reset_for_mask_update()
        for d, records in enumerate(state["gate_records"]):
            for rec in records:
                self.gate_acc[d].add(rec)

    # ------------------------------------------------------------ recording
    def record_gates(self, d: int, gate_means: Sequence[np.ndarray]):
        self.gate_acc[d].add(gate_means)

    def record_tmp_gates(self, gate_means: Sequence[np.ndarray], current_mask: Mask):
        """One fast-adapt step's gate values (the forward has masked
        them)."""
        self.tmp_gate_record = tuple(np.asarray(g) for g in gate_means)

    def add_eval_loss(self, loss_mean: float, d: int, mask_z: int):
        if len(self.eval_loss[d]) <= mask_z:
            self.eval_loss[d].append([loss_mean])
        else:
            self.eval_loss[d][mask_z].append(loss_mean)

    # ----------------------------------------------------------- generation
    def generate_mask(self, generate_mode: str, d: int,
                      init_active_percent: float = 0.7,
                      random_modify_sigma: float = 0.2) -> Mask:
        rng = self.rng
        if generate_mode == "rand":
            while True:
                mask = create_single_full_mask(self.n_tower, init_active_percent, rng)
                valid = validate_mask(mask)
                if has_output(valid):
                    return valid
        if generate_mode == "mask_norm_rand":
            original = [m.copy() for m in self.domain_mask[d]]
            active = count_active_edge(original)
            while True:
                rand_percent = min(1.0, abs(rng.normal(0, random_modify_sigma)))
                mask = []
                for m in original:
                    r = rng.random(m.shape) < rand_percent
                    mask.append((m | r) if active < self.edge_num * rand_percent else (m ^ r))
                valid = validate_mask(mask)
                if has_output(valid) and any(
                        not np.array_equal(valid[l], original[l]) for l in range(len(original))):
                    return valid
        if generate_mode in ("max_gate", "max_gate_norm_rand", "mask_max_gate"):
            mean_values = self.gate_acc[d].mean_values()
            thr = gate_threshold(mean_values, init_active_percent)
            self.gate_value_threshold[d] = thr
            if thr is None:
                prun_mask = self.generate_mask("rand", d, init_active_percent,
                                               random_modify_sigma)
            else:
                prun_mask = [mv >= thr for mv in mean_values]
            if generate_mode == "max_gate":
                valid = validate_mask(prun_mask)
                if not has_output(valid):
                    raise ValueError(f"max_gate mask for domain {d} has no output")
                return valid
            if generate_mode == "max_gate_norm_rand":
                rand_percent = min(1.0, abs(rng.normal(0, random_modify_sigma)))
                while True:
                    mask = [m ^ (rng.random(m.shape) < rand_percent) for m in prun_mask]
                    valid = validate_mask(mask)
                    if has_output(valid):
                        return valid
            # mask_max_gate, the mode the trainer uses
            rand_percent = min(1.0, abs(rng.normal(0, random_modify_sigma)))
            origin = self.domain_mask[d] if self.domain_mask[d] is not None else prun_mask
            is_nor = (count_active_edge(origin) / self.edge_num) > init_active_percent
            while True:
                mask = []
                for om, pm in zip(origin, prun_mask):
                    r = rng.random(om.shape) < rand_percent
                    base = om | pm
                    mask.append((base ^ r) if is_nor else (base | r))
                valid = validate_mask(mask)
                if has_output(valid) and any(
                        not np.array_equal(valid[l], origin[l]) for l in range(len(origin))):
                    return valid
        raise ValueError(f"unknown generate_mode {generate_mode}")

    # -------------------------------------------------------------- pruning
    def prun_single_mask(self, d: int, current_mask: Mask,
                         prun_ratio: float = 0.05) -> Mask:
        """Progressive pruning during fast adaptation: threshold the last
        recorded step's gate values at quantile ``prun_ratio``, AND into
        the mask, revert if the output dies."""
        if self.tmp_gate_record is None:
            raise ValueError("no tmp gate record for pruning")
        gate_values = list(self.tmp_gate_record)
        if prune_threshold(gate_values, prun_ratio) is None:
            raise ValueError("no valid tmp_tower_gate_values in candidate mask")
        self.tmp_gate_record = None
        return prune_mask(current_mask, gate_values, prun_ratio)

    # ------------------------------------------------------------ selection
    def update_all_mask(self) -> None:
        """Each domain takes its candidate of the lowest mean probe
        loss."""
        for d in range(self.n_domain):
            if not self.candidate_domain_mask[d]:
                continue
            loss_means = [float(np.mean(losses)) for losses in self.eval_loss[d]]
            best = int(np.argmin(loss_means))
            self.domain_mask[d] = self.candidate_domain_mask[d][best]

    def current_active_ratio(self) -> float:
        total = 0.0
        for d in range(self.n_domain):
            if self.domain_mask[d] is not None:
                total += count_active_edge(self.domain_mask[d]) / self.edge_num
        return total / self.n_domain

    def init_full_masks(self):
        shapes = mask_shapes(self.n_tower)
        for d in range(self.n_domain):
            self.domain_mask[d] = [np.ones(s, bool) for s in shapes]

    def init_cluster_masks(self, cluster_z: np.ndarray):
        """Cluster-based mask initialization; returns tower2cluster (the
        domain lists per level and tower)."""
        masks, tower2cluster = cluster_domain_masks(
            cluster_z, self.n_tower, self.n_domain)
        self.domain_mask = masks
        return tower2cluster
