"""Data loading, splitting and batching (counterpart of
``aread_tpu/data/loader.py``).

Loading: the canonical CSV's columns per dataset, history sequences
parsed, padded with the item vocab's pad id and cut to the last
``seq_maxlen``; the split by timestamp quantiles 0.9 / 0.95 (amazon) or by
the ``train_tag`` column; one-hot dims as column max + 1 over the file
(the augmented file included), the amazon itemid dim pinned to
``itemid_all``; train-frequency domain weights. A CSV is parsed by the
native C++ parser (``aread_tpu_torch/native``), by pandas when
``AREAD_TPU_NO_NATIVE`` is set or the native parser rejects the file
(with a warning that carries its error); ``parser_of`` says which. Parsed
arrays are cached as ``.npy`` files keyed on the file's identity and the
parse options.

Batching: fixed-shape padded batches with a validity mask, shuffled
batches over a whole split (``GlobalBatcher``), per-domain streams with a
shuffled single-domain batch sequence, and the small synthetic dataset of
the tests. The numpy random streams are the JAX package's, draw for
draw."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from aread_tpu_torch import native
from aread_tpu_torch.models.base import FeatureSpec

log = logging.getLogger(__name__)

AMAZON_FEATURES = [
    "itemid", "weekday", "domain", "sales_chart", "sales_rank", "brand", "price",
]
AMAZON_SEQ_FEATURES = ["user_pos_6month_seq", "user_neg_6month_seq"]
ALICCP_FEATURES = [
    "userid", "121", "122", "124", "125", "126", "127", "128", "129", "itemid",
    "domain", "207", "210", "216", "508", "509", "702", "853", "109_14",
    "110_14", "127_14", "150_14", "301",
]
CLOUDTHEME_FEATURES = ["userid", "itemid", "domain", "leaf_cate_id", "cate_level1_id"]


def _parse_seq(seq_str, maxlen: int, pad_value: int) -> List[int]:
    seq = ast.literal_eval(seq_str) if isinstance(seq_str, str) else list(seq_str)
    if len(seq) >= maxlen:
        return list(seq[-maxlen:])
    return list(seq) + [pad_value] * (maxlen - len(seq))


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


def dataset_columns(dataset_name: str, history: bool = True,
                    only_id: bool = False):
    """(one-hot columns, sequence columns, label column) of a dataset's
    canonical CSV."""
    if only_id:
        return (["userid", "itemid", "domain"], [],
                "label" if dataset_name == "amazon" else "click")
    if dataset_name == "amazon":
        return (list(AMAZON_FEATURES),
                list(AMAZON_SEQ_FEATURES) if history else [], "label")
    if dataset_name == "aliccp":
        return list(ALICCP_FEATURES), [], "click"
    if dataset_name == "cloudtheme":
        return list(CLOUDTHEME_FEATURES), [], "click"
    raise ValueError(f"unknown dataset {dataset_name}")


def tensorize(df: pd.DataFrame, one_hot_cols: Sequence[str],
              seq_cols: Sequence[str], label_col: str, seq_maxlen: int,
              pad_value: int) -> Tuple[np.ndarray, np.ndarray]:
    """DataFrame -> (x int32 [N, n_onehot + n_seq * maxlen], y int8 [N])."""
    parts = [df[list(one_hot_cols)].to_numpy(dtype=np.int64)]
    for col in seq_cols:
        seqs = df[col].map(lambda s: _parse_seq(s, seq_maxlen, pad_value))
        parts.append(np.stack(seqs.to_numpy()).astype(np.int64))
    x = np.concatenate(parts, axis=1).astype(np.int32)
    y = df[label_col].to_numpy(dtype=np.int8)
    return x, y


def read_with_pandas(path: str, one_hot_cols: Sequence[str],
                     seq_cols: Sequence[str], label_col: str, split_col: str,
                     seq_maxlen: int, pad_value: int, nrows: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, split) of the first ``nrows`` rows (all: None) of one CSV,
    parsed by pandas and one ``literal_eval`` per sequence cell."""
    df = pd.read_csv(path, usecols=list(one_hot_cols) + list(seq_cols)
                     + [label_col, split_col], nrows=nrows)
    x, y = tensorize(df, one_hot_cols, seq_cols, label_col, seq_maxlen,
                     pad_value)
    return x, y, df[split_col].to_numpy(dtype=np.float64)


def _cache_dir() -> Optional[str]:
    """Where parsed arrays are cached: the dataset directory may be
    read-only, so the default is ~/.cache/aread_tpu_torch. AREAD_TPU_CACHE=0
    turns the cache off; a directory there relocates it."""
    env = os.environ.get("AREAD_TPU_CACHE")
    if env == "0":
        return None
    return env or os.path.join(os.path.expanduser("~"), ".cache",
                               "aread_tpu_torch")


# what produced each file's arrays in this process, by absolute path:
# 'cache', 'native' or 'pandas'
_PARSED_BY: Dict[str, str] = {}


def parser_of(path: str) -> Optional[str]:
    """'cache', 'native' or 'pandas': what produced the arrays of the
    last ``_read_arrays`` of ``path`` in this process (None: not read)."""
    return _PARSED_BY.get(os.path.abspath(path))


def _read_arrays(path: str, one_hot_cols: Sequence[str],
                 seq_cols: Sequence[str], label_col: str, split_col: str,
                 seq_maxlen: int, pad_value: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, split) of one CSV: the memory-mapped .npy cache when warm
    (keyed on the file's identity and the parse options), else the native
    parser's one multi-threaded pass, else pandas (``AREAD_TPU_NO_NATIVE``
    set, or a file the native parser rejects)."""
    where = os.path.abspath(path)
    cache_root = _cache_dir()
    cdir = None
    if cache_root is not None:
        st = os.stat(path)
        key = hashlib.sha1(repr((where, st.st_mtime_ns,
                                 st.st_size, tuple(one_hot_cols),
                                 tuple(seq_cols), label_col, split_col,
                                 seq_maxlen, pad_value)).encode()).hexdigest()
        cdir = os.path.join(cache_root, key)
        if os.path.exists(os.path.join(cdir, "split.npy")):
            # mmap: downstream only fancy-indexes the arrays (the split
            # filters make copies), so pages load on demand
            _PARSED_BY[where] = "cache"
            return (np.load(os.path.join(cdir, "x.npy"), mmap_mode="r"),
                    np.load(os.path.join(cdir, "y.npy"), mmap_mode="r"),
                    np.load(os.path.join(cdir, "split.npy"), mmap_mode="r"))

    out = None
    if native.available():  # a failed build raises
        try:
            out = native.load_csv(path, one_hot_cols, seq_cols, label_col,
                                  split_col, seq_maxlen, pad_value)
            _PARSED_BY[where] = "native"
        except RuntimeError as e:  # a cell it cannot read: pandas may
            log.warning("native parse of %s failed (%s); parsing with "
                        "pandas", path, e)
    if out is None:
        out = read_with_pandas(path, one_hot_cols, seq_cols, label_col,
                               split_col, seq_maxlen, pad_value)
        _PARSED_BY[where] = "pandas"

    if cdir is not None:
        try:
            os.makedirs(cdir, exist_ok=True)
            for name, arr in zip(("x", "y", "split"), out):
                # per process: the ranks of a mesh run parse at once
                tmp = os.path.join(cdir, f".{name}.npy.{os.getpid()}.tmp")
                with open(tmp, "wb") as f:  # np.save(path) would add .npy
                    np.save(f, arr)
                os.replace(tmp, os.path.join(cdir, f"{name}.npy"))
        except OSError:
            pass  # the cache is best-effort
    return out


def load_split_data(path: str, dataset_name: str, seq_maxlen: int = 5,
                    itemid_all: Optional[int] = None,
                    aug_path: Optional[str] = None,
                    domain_filter: Optional[Sequence[int]] = None,
                    history: bool = True, only_id: bool = False) -> SplitData:
    """The canonical CSV at ``path`` (and the augmented one at
    ``aug_path``, whose train-time rows become ``aug_train_x / _y``) as
    train / valid / test arrays with their FeatureSpec."""
    one_hot_cols, seq_cols, label_col = dataset_columns(dataset_name, history,
                                                        only_id)
    split_col = "timestamp" if dataset_name == "amazon" else "train_tag"
    n_one = len(one_hot_cols)

    # Without a configured item vocab the pad id is known only after the
    # data is scanned: parse with -1 and substitute below (ids are not
    # negative, so -1 can only be padding).
    pad0 = int(itemid_all) if itemid_all is not None else -1
    x, y, split = _read_arrays(path, one_hot_cols, seq_cols, label_col,
                               split_col, seq_maxlen, pad0)
    if aug_path is not None:
        aug_x_all, aug_y_all, aug_split = _read_arrays(
            aug_path, one_hot_cols, seq_cols, label_col, split_col,
            seq_maxlen, pad0)
    else:
        aug_x_all = aug_y_all = aug_split = None

    itemid_idx = one_hot_cols.index("itemid")
    domain_idx = one_hot_cols.index("domain")

    if domain_filter is not None:
        keep = np.isin(x[:, domain_idx], list(domain_filter))
        x, y, split = x[keep], y[keep], split[keep]
        if aug_x_all is not None:
            keep = np.isin(aug_x_all[:, domain_idx], list(domain_filter))
            aug_x_all, aug_y_all, aug_split = (
                aug_x_all[keep], aug_y_all[keep], aug_split[keep])

    if dataset_name == "amazon":
        train_valid = np.quantile(split, 0.9)
        valid_test = np.quantile(split, 0.95)
    else:
        train_valid, valid_test = 1, 2

    one_hot_dims = (x[:, :n_one].max(axis=0).astype(np.int64) + 1)
    if aug_x_all is not None:
        # the augmented file is train-time input: the vocab covers it too
        aug_dims = aug_x_all[:, :n_one].max(axis=0).astype(np.int64) + 1
        one_hot_dims = np.maximum(one_hot_dims, aug_dims)
    if dataset_name == "amazon" and itemid_all is not None:
        one_hot_dims[itemid_idx] = itemid_all
    pad_value = (int(one_hot_dims[itemid_idx] - 1) if itemid_all is None
                 else int(itemid_all))
    if itemid_all is None and seq_cols:
        # no configured item vocab: one extra row is the sequences' pad id
        one_hot_dims[itemid_idx] += 1
        pad_value = int(one_hot_dims[itemid_idx] - 1)
    if pad0 == -1 and seq_cols:
        x = np.array(x)  # a warm cache hands out read-only memory maps
        x[x == -1] = pad_value
        if aug_x_all is not None:
            aug_x_all = np.array(aug_x_all)
            aug_x_all[aug_x_all == -1] = pad_value

    spec = FeatureSpec(
        one_hot_dims=tuple(int(d) for d in one_hot_dims),
        n_seq_fields=len(seq_cols), itemid_idx=itemid_idx,
        domain_idx=domain_idx, seq_maxlen=seq_maxlen, method="mean")
    n_domain = int(np.unique(x[:, domain_idx]).size)

    tr = split < train_valid
    va = (split >= train_valid) & (split < valid_test)
    te = split >= valid_test
    train_x, train_y = x[tr], y[tr]

    cnt = np.bincount(train_x[:, domain_idx], minlength=n_domain).astype(np.float64)
    domain_cnt_weight = cnt / max(1, train_x.shape[0])

    aug_x = aug_y = None
    if aug_x_all is not None:
        keep = aug_split < train_valid
        aug_x, aug_y = aug_x_all[keep], aug_y_all[keep]

    return SplitData(
        train_x=train_x, train_y=train_y, valid_x=x[va], valid_y=y[va],
        test_x=x[te], test_y=y[te], spec=spec,
        domain_cnt_weight=domain_cnt_weight, n_domain=n_domain,
        aug_train_x=aug_x, aug_train_y=aug_y)


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

    def get_state(self) -> Dict:
        """What the next draws depend on: the generator's position, each
        domain's order and cursor, the batch sequence. With it a resumed
        run draws the batches the interrupted one would have drawn."""
        return {"rng": self.rng.bit_generator.state,
                "cursors": [int(c) for c in self._cursors],
                # row ids fit int32: next_batch_indices hands them out so
                "orders": [None if o is None else np.asarray(o, np.int32)
                           for o in self._orders],
                "domain_batch_seq": [int(d) for d in self.domain_batch_seq]}

    def set_state(self, state: Dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._cursors = [int(c) for c in state["cursors"]]
        self._orders = [None if o is None else np.asarray(o, np.int64)
                        for o in state["orders"]]
        self.domain_batch_seq = [int(d) for d in state["domain_batch_seq"]]

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
