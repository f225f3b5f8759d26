"""Batching and synthetic data (counterpart of the batching half of
``aread_tpu/data/loader.py``): fixed-shape padded batches with a validity
mask, shuffled batches over a whole split (``GlobalBatcher``), per-domain
streams with a shuffled single-domain batch sequence, and the small
synthetic dataset of the tests. The numpy random streams
are the JAX package's, draw for draw. Reading and caching the dataset
CSVs is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from aread_tpu_torch.models.base import FeatureSpec


@dataclasses.dataclass
class SplitData:
    train_x: np.ndarray
    train_y: np.ndarray
    valid_x: np.ndarray
    valid_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    spec: FeatureSpec
    domain_cnt_weight: np.ndarray
    n_domain: int
    # augmented train rows for the HEMP fast-adapt chains; None = the
    # chains draw from the train rows
    aug_train_x: Optional[np.ndarray] = None
    aug_train_y: Optional[np.ndarray] = None


def pad_batch(x: np.ndarray, y: np.ndarray, bs: int) -> Dict[str, np.ndarray]:
    """Pad a ragged batch to exactly ``bs`` rows with a validity mask; pad
    rows replicate row 0 so their lookups stay in range."""
    n = x.shape[0]
    valid = np.zeros((bs,), dtype=np.float32)
    valid[:n] = 1.0
    if n < bs:
        pad_x = np.broadcast_to(x[:1], (bs - n,) + x.shape[1:])
        pad_y = np.zeros((bs - n,), dtype=y.dtype)
        x = np.concatenate([x, pad_x], axis=0)
        y = np.concatenate([y, pad_y], axis=0)
    return {"x": x, "y": y.astype(np.float32), "valid": valid}


class GlobalBatcher:
    """Shuffled fixed-shape batches over the full split. Each batch
    carries ``domain`` and, with a ``domain2group`` map, ``group``.

    The shuffle is keyed by (seed, epoch) through a counter-based Philox
    generator rather than drawn from a running stream, so ``set_epoch``
    can fast-forward to any epoch and replay its exact permutation."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 domain_idx: int, domain2group: Optional[np.ndarray] = None,
                 shuffle: bool = True, seed: int = 0):
        self.x, self.y = x, y
        self.bs = batch_size
        self.domain_idx = domain_idx
        self.domain2group = domain2group
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return int(np.ceil(self.x.shape[0] / self.bs))

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the shuffle stream."""
        self._epoch = int(epoch)

    def _batch(self, sel: np.ndarray) -> Dict[str, np.ndarray]:
        batch = pad_batch(self.x[sel], self.y[sel], self.bs)
        domain = batch["x"][:, self.domain_idx].astype(np.int32)
        batch["domain"] = domain
        if self.domain2group is not None:
            batch["group"] = np.asarray(self.domain2group)[domain].astype(np.int32)
        return batch

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """A shape-complete batch that does not advance the epoch
        stream."""
        return self._batch(np.arange(min(self.bs, self.x.shape[0])))

    def epoch_indices(self) -> np.ndarray:
        """One epoch's (shuffled) row order — the stream ``__iter__``
        consumes; advances the epoch."""
        idx = np.arange(self.x.shape[0])
        if self.shuffle:
            rng = np.random.Generator(
                np.random.Philox(key=[self.seed & (2**64 - 1),
                                      0xA5EAD ^ self._epoch]))
            rng.shuffle(idx)
        self._epoch += 1
        return idx

    def epoch_perm(self) -> np.ndarray:
        """``epoch_indices`` padded with -1 to whole batches, as
        [n_batches, bs] int32 — the schedule of the device-resident
        epoch."""
        idx = self.epoch_indices()
        n_batches = -(-len(idx) // self.bs)
        pad = n_batches * self.bs - len(idx)
        if pad:
            idx = np.concatenate([idx, np.full(pad, -1, idx.dtype)])
        return idx.reshape(n_batches, self.bs).astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.epoch_indices()
        for i in range(0, len(idx), self.bs):
            yield self._batch(idx[i:i + self.bs])


class DomainBatcher:
    """Per-domain streams and the shuffled sequence of single-domain
    batches, ceil(n_d / bs) entries per domain; each domain's stream is
    cyclic and reshuffles when it runs out."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 domain_idx: int, n_domain: int, shuffle: bool = True,
                 seed: int = 0):
        self.bs = batch_size
        self.domain_idx = domain_idx
        self.n_domain = n_domain
        self.rng = np.random.default_rng(seed)
        domains = x[:, domain_idx]
        self.domain_indices: List[np.ndarray] = [
            np.nonzero(domains == d)[0] for d in range(n_domain)]
        self.x, self.y = x, y
        self.shuffle = shuffle
        self._cursors = [0] * n_domain
        self._orders = [None] * n_domain
        self.domain_batch_seq: List[int] = []
        for d in range(n_domain):
            n_batches = int(np.ceil(len(self.domain_indices[d]) / batch_size))
            self.domain_batch_seq.extend([d] * n_batches)
        if shuffle:
            self.domain_batch_seq = list(
                self.rng.permutation(self.domain_batch_seq).astype(int))

    def shuffle_seq(self):
        self.domain_batch_seq = list(
            self.rng.permutation(self.domain_batch_seq).astype(int))

    def next_batch_indices(self, d: int) -> np.ndarray:
        """Row ids of domain ``d``'s next batch, padded to bs with -1."""
        idxs = self.domain_indices[d]
        if len(idxs) == 0:
            raise ValueError(f"domain {d} has no rows")
        if self._orders[d] is None or self._cursors[d] >= len(idxs):
            self._orders[d] = self.rng.permutation(idxs) if self.shuffle else idxs
            self._cursors[d] = 0
        sel = self._orders[d][self._cursors[d]:self._cursors[d] + self.bs]
        self._cursors[d] += self.bs
        out = np.full((self.bs,), -1, np.int32)
        out[:len(sel)] = sel
        return out

    def next_batch(self, d: int) -> Dict[str, np.ndarray]:
        idx = self.next_batch_indices(d)
        sel = idx[idx >= 0]
        batch = pad_batch(self.x[sel], self.y[sel], self.bs)
        batch["domain"] = np.full((self.bs,), d, dtype=np.int32)
        return batch


def make_synthetic_data(n_rows: int = 4096, n_domain: int = 5,
                        n_one_hot: int = 6, n_seq_fields: int = 2,
                        seq_maxlen: int = 5, vocab: int = 200,
                        seed: int = 0) -> SplitData:
    """Small random dataset whose label follows the item id (AUC is
    learnable)."""
    rng = np.random.default_rng(seed)
    dims = [vocab, 8, n_domain, 12, 20, 30][:n_one_hot]
    while len(dims) < n_one_hot:
        dims.append(10)
    itemid_idx, domain_idx = 0, 2
    cols = [rng.integers(0, d, size=n_rows) for d in dims]
    seq = rng.integers(0, vocab, size=(n_rows, n_seq_fields * seq_maxlen))
    x = np.concatenate([np.stack(cols, axis=1), seq], axis=1).astype(np.int32)
    logits = (x[:, itemid_idx] % 7) / 3.0 - 1.0 + 0.3 * rng.standard_normal(n_rows)
    y = (logits > 0).astype(np.int8)
    dims[itemid_idx] = vocab + 1  # the sequences' pad id row
    spec = FeatureSpec(tuple(dims), n_seq_fields, itemid_idx, domain_idx,
                       seq_maxlen)
    n_train = int(0.8 * n_rows)
    n_valid = int(0.9 * n_rows)
    cnt = np.bincount(x[:n_train, domain_idx], minlength=n_domain).astype(np.float64)
    return SplitData(
        train_x=x[:n_train], train_y=y[:n_train],
        valid_x=x[n_train:n_valid], valid_y=y[n_train:n_valid],
        test_x=x[n_valid:], test_y=y[n_valid:],
        spec=spec, domain_cnt_weight=cnt / n_train, n_domain=n_domain)
