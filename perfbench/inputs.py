"""What the benchmark makes from ``--seed`` and hands to both the measured
package and the reference: the weights, the domain masks and the rows.

Everything is drawn on the device with ``torch.Generator``s in a few large
calls: the table in one normal draw, every other weight and statistic
from one uniform draw sliced per leaf, the rows column by column. The
traffic mix's parameters (``perfbench/traffic/<mix>.json``) and the
configuration (``perfbench/configs/<config>.json``) say what to draw; this
module is the one generator that reads them.

Rows follow the configuration's layout: the one-hot columns, then
``n_seq_fields`` histories of ``seq_maxlen`` item ids. A row's domain is
drawn by the configuration's per-domain row counts (``domain_size``); its
item and history ids by a Zipf law over the item vocabulary (id 0, the
history's padding, excluded; ranks spread over the ids by a fixed
multiplicative map); every other column uniformly over its vocabulary;
its label from a fixed logistic of the item, two other columns and the
domain.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import registry
from perfbench.reference.hemp import repair

# odd constants that key the streams drawn from one seed
_WEIGHTS, _TABLE, _ROWS, _MASKS = 0x57E1, 0x7AB1, 0x1205, 0x3A5C
_SPREAD = 2_654_435_761  # a prime: rank -> item id


def sub_seed(seed: int, key: int) -> int:
    """A 63-bit seed of stream ``key`` of the run's seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + key * 0xBF58476D1CE4E5B9) % (2**63)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight and statistic of the configuration's model by name: the
    table N(0, 1) stored in ``table_dtype``; kernels and biases U(-b, b) with
    b = 1 / sqrt(fan_in); BatchNorm scales U(0.9, 1.1), biases, running
    means U(-0.05, 0.05), running variances U(0.9, 1.1); AREAD's group
    embedding U(-1, 1)."""
    specs = registry.model(cfg).param_specs(cfg)
    dense = [s for s in specs if s[0] != "embedding.table"]
    total = sum(math.prod(shape) for _, shape, _ in dense)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, _WEIGHTS))
    u = torch.rand((total,), generator=gen, device=device)
    out, lo = {}, 0
    for name, shape, how in dense:
        n = math.prod(shape)
        x = u[lo:lo + n].reshape(shape)
        lo += n
        if how == "kernel":
            x = (2 * x - 1) / math.sqrt(shape[-2])
        elif isinstance(how, tuple):  # ("bias", fan_in)
            x = (2 * x - 1) / math.sqrt(how[1])
        elif how in ("bn_scale", "bn_var"):
            x = 0.9 + 0.2 * x
        elif how in ("bn_bias", "bn_mean"):
            x = 0.1 * x - 0.05
        elif how == "embed":
            x = 2 * x - 1
        else:
            raise ValueError(how)
        out[name] = x.contiguous()
    (name, shape, _), = [s for s in specs if s[0] == "embedding.table"]
    gen_t = torch.Generator(device=device).manual_seed(sub_seed(seed, _TABLE))
    out[name] = torch.randn(shape, generator=gen_t, device=device).to(
        getattr(torch, cfg["table_dtype"]))
    return out


def make_masks(cfg: Dict, seed: int) -> List[List[np.ndarray]]:
    """For a model of HEMP's tower levels (its reference's ``n_towers``):
    one mask per domain, its levels [1, T0], [T0, T1], ...,
    [T_last, 1]: each edge on with probability ``mask_active``, repaired as
    HEMP repairs its candidates (``reference.hemp.repair``: no hidden tower
    without an in- or an out-edge), drawn again until a leaf is live. They
    stand for the masks an evolution leaves; none is evolved here."""
    towers = registry.model(cfg).n_towers(cfg)
    rng = np.random.default_rng(sub_seed(seed, _MASKS))
    shapes = [(1, towers[0])] + [(towers[l - 1], towers[l])
                                 for l in range(1, len(towers))] + [
                                     (towers[-1], 1)]
    p = cfg.get("mask_active", 0.7)
    masks = []
    for _ in range(len(cfg["domain_size"])):
        while True:
            m = repair([rng.random(s) < p for s in shapes])
            if m[-1].any():
                break
        masks.append(m)
    return masks


def zipf_cdf(n: int, s: float, device) -> torch.Tensor:
    """Cumulative Zipf(s) probabilities of ranks 1..n (float64)."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** (-s)
    c = torch.cumsum(w, 0)
    return c / c[-1]


def make_rows(cfg: Dict, mix: Dict, seed: int, n: int, device,
              key: int = _ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` rows (x int32 [n, columns], y float32 [n]) on the device."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, key))
    dims = cfg["one_hot_dims"]
    n_items = dims[cfg["itemid_idx"]] - 1  # id 0 pads the histories
    cdf = zipf_cdf(n_items, mix["item_zipf"], device)

    def items(shape):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float64)
        rank = torch.clamp(torch.searchsorted(cdf, u), max=n_items - 1)
        return 1 + (rank * _SPREAD) % n_items

    sizes = torch.tensor(cfg["domain_size"], dtype=torch.float64,
                         device=device)
    cols = []
    for j, d in enumerate(dims):
        if j == cfg["domain_idx"]:
            cols.append(torch.multinomial(sizes / sizes.sum(), n,
                                          replacement=True, generator=gen))
        elif j == cfg["itemid_idx"]:
            cols.append(items((n,)))
        else:
            cols.append(torch.randint(0, d, (n,), generator=gen,
                                      device=device))
    hist = items((n, cfg["n_seq_fields"], cfg["seq_maxlen"]))
    # a history holds 0 to seq_maxlen items, the rest padding
    length = torch.randint(0, cfg["seq_maxlen"] + 1,
                           (n, cfg["n_seq_fields"], 1), generator=gen,
                           device=device)
    slot = torch.arange(cfg["seq_maxlen"], device=device)
    hist = torch.where(slot < length, hist, 0).reshape(n, -1)
    x = torch.cat([torch.stack(cols, 1), hist], 1).to(torch.int32)
    lab = mix["label"]
    item = cols[cfg["itemid_idx"]].to(torch.float64)
    logit = (lab["bias"] + lab["item"] * torch.cos(item * 0.37)
             + lab["field"] * ((cols[lab["field_a"]] % 5) - 2).to(
                 torch.float64) / 2
             + lab["domain"] * torch.sin(cols[cfg["domain_idx"]].to(
                 torch.float64) * 1.3))
    u = torch.rand((n,), generator=gen, device=device, dtype=torch.float64)
    y = (u < torch.sigmoid(logit)).to(torch.float32)
    return x, y
