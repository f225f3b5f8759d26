"""The port's data loading (aread_tpu_torch/data/loader.py, augment.py,
pipeline.py) against the JAX package's on seed-made canonical CSVs: the
amazon columns (two history fields, the timestamp split, with and without
``itemid_all``) and the aliccp columns (the ``train_tag`` split), with an
augmented file and a ``domain_filter``. Every array and the FeatureSpec
are equal, not close: both sides are numpy and pandas. Each side gets a
cache directory of its own (the two packages key their caches alike), and
the JAX side's native parser is what it is on the machine: it must give
the arrays the port's pandas parser gives."""

import dataclasses

import numpy as np
import pandas as pd
import pytest

from aread_tpu.data import augment as jaugment
from aread_tpu.data import loader as jloader
from aread_tpu.data import pipeline as jpipeline
from aread_tpu_torch.data import augment, loader, pipeline

N_DOMAIN = 4
ARRAYS = ("train_x", "train_y", "valid_x", "valid_y", "test_x", "test_y",
          "domain_cnt_weight", "aug_train_x", "aug_train_y")


def make_canonical_frame(dataset: str, n: int, seed: int, vocab: int = 40,
                         n_domain: int = N_DOMAIN) -> pd.DataFrame:
    """A canonical training frame with the dataset's columns; the label
    follows the item id, so an AUC is learnable."""
    rng = np.random.default_rng(seed)
    one_hot, seq_cols, label = loader.dataset_columns(dataset)
    cols = {}
    for c in one_hot:
        hi = {"itemid": vocab, "domain": n_domain}.get(c, 6)
        cols[c] = rng.integers(0, hi, n)
    for c in seq_cols:
        cols[c] = [str(rng.integers(0, vocab, rng.integers(0, 9)).tolist())
                   for _ in range(n)]
    cols[label] = ((cols["itemid"] % 7) / 3.0 - 1.0
                   + 0.3 * rng.standard_normal(n) > 0).astype(int)
    if dataset == "amazon":
        cols["timestamp"] = rng.permutation(n) + 1_500_000_000
    else:
        cols["train_tag"] = rng.choice([0, 1, 2], n, p=[0.8, 0.1, 0.1])
    return pd.DataFrame(cols)


def _spec_tuple(spec):
    return dataclasses.astuple(spec)


def _assert_same_split(got, want):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert _spec_tuple(got.spec) == _spec_tuple(want.spec)
    assert got.n_domain == want.n_domain


CASES = [
    ("amazon", dict(itemid_all=64), False),
    ("amazon", dict(itemid_all=None), False),
    ("amazon", dict(itemid_all=64), True),
    ("amazon", dict(itemid_all=None, domain_filter=[0, 2]), True),
    ("amazon", dict(itemid_all=64, history=False), False),
    ("aliccp", dict(), False),
    ("aliccp", dict(), True),
    ("aliccp", dict(domain_filter=[1, 2, 3]), True),
    ("aliccp", dict(only_id=True), False),
]


@pytest.mark.parametrize("dataset,kw,with_aug", CASES, ids=[
    f"{d}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'plain'}"
    f"{'-aug' if a else ''}" for d, kw, a in CASES])
def test_load_split_data_equals_jax(dataset, kw, with_aug, tmp_path,
                                    monkeypatch):
    df = make_canonical_frame(dataset, 400, seed=3)
    path = tmp_path / "data.csv"
    df.to_csv(path, index=False)
    aug_path = None
    if with_aug:
        # the augmented file holds an item id beyond the main file's
        adf = make_canonical_frame(dataset, 120, seed=4, vocab=47)
        aug_path = str(tmp_path / "data_aug.csv")
        adf.to_csv(aug_path, index=False)
    seq_maxlen = 5
    monkeypatch.setenv("AREAD_TPU_CACHE", str(tmp_path / "cache_jax"))
    want = jloader.load_split_data(str(path), dataset, seq_maxlen,
                                   aug_path=aug_path, **kw)
    monkeypatch.setenv("AREAD_TPU_CACHE", str(tmp_path / "cache_port"))
    cold = loader.load_split_data(str(path), dataset, seq_maxlen,
                                  aug_path=aug_path, **kw)
    _assert_same_split(cold, want)
    assert len(cold.train_y) > 100 and len(cold.valid_y) and len(cold.test_y)
    assert (cold.aug_train_x is not None) == with_aug
    # the second read is served from the port's own cache
    assert any((tmp_path / "cache_port").iterdir())
    warm = loader.load_split_data(str(path), dataset, seq_maxlen,
                                  aug_path=aug_path, **kw)
    _assert_same_split(warm, want)
    # and with the cache off
    monkeypatch.setenv("AREAD_TPU_CACHE", "0")
    assert loader._cache_dir() is None
    _assert_same_split(loader.load_split_data(
        str(path), dataset, seq_maxlen, aug_path=aug_path, **kw), want)


def test_cache_lives_under_the_ports_own_directory(monkeypatch):
    monkeypatch.delenv("AREAD_TPU_CACHE", raising=False)
    assert loader._cache_dir().endswith(".cache/aread_tpu_torch")
    assert jloader._cache_dir().endswith(".cache/aread_tpu")
    monkeypatch.setenv("AREAD_TPU_CACHE", "/some/where")
    assert loader._cache_dir() == "/some/where"


def test_cache_is_dropped_when_the_file_changes(tmp_path, monkeypatch):
    import time

    csv = tmp_path / "mini.csv"
    csv.write_text("itemid,domain,click,train_tag\n"
                   "0,0,1,0\n1,1,0,1\n2,0,1,2\n3,1,0,0\n")
    monkeypatch.setenv("AREAD_TPU_CACHE", str(tmp_path / "cache"))
    args = (str(csv), ["itemid", "domain"], [], "click", "train_tag", 5, -1)
    x1, y1, s1 = loader._read_arrays(*args)
    x2, y2, s2 = loader._read_arrays(*args)
    assert isinstance(x2, np.memmap) and not isinstance(x1, np.memmap)
    for a, b in ((x1, x2), (y1, y2), (s1, s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    time.sleep(0.01)
    csv.write_text("itemid,domain,click,train_tag\n"
                   "5,0,1,0\n6,1,0,1\n7,0,1,2\n8,1,0,0\n")
    x3, _, _ = loader._read_arrays(*args)
    assert int(np.asarray(x3)[:, 0].max()) == 8


@pytest.mark.parametrize("dataset", ["amazon", "aliccp", "cloudtheme"])
@pytest.mark.parametrize("history,only_id", [(True, False), (False, False),
                                             (True, True)])
def test_dataset_columns_equal_jax(dataset, history, only_id):
    assert loader.dataset_columns(dataset, history, only_id) == \
        jloader.dataset_columns(dataset, history, only_id)


def test_dataset_columns_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        loader.dataset_columns("movielens")


def test_tensorize_and_parse_seq_equal_jax():
    df = make_canonical_frame("amazon", 64, seed=1)
    one_hot, seq_cols, label = loader.dataset_columns("amazon")
    for maxlen, pad in ((5, 40), (3, -1), (9, 40)):
        x, y = loader.tensorize(df, one_hot, seq_cols, label, maxlen, pad)
        jx, jy = jloader.tensorize(df, one_hot, seq_cols, label, maxlen, pad)
        assert x.dtype == jx.dtype == np.int32 and y.dtype == jy.dtype == np.int8
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.shape == (64, len(one_hot) + 2 * maxlen)
    for seq in ("[1, 2, 3]", "[]", [4, 5, 6, 7, 8, 9, 10], "[1,2,3,4,5,6]"):
        assert loader._parse_seq(seq, 5, 99) == jloader._parse_seq(seq, 5, 99)
    assert loader._parse_seq("[1, 2, 3, 4, 5, 6]", 5, 99) == [2, 3, 4, 5, 6]
    assert loader._parse_seq("[7]", 3, 99) == [7, 99, 99]


def _aug_frame(dataset, seed):
    """Cold items with a few positives inside large domains, two small
    domains: the augmentation has a pool and somewhere to send it."""
    rng = np.random.default_rng(seed)
    label = "label" if dataset == "amazon" else "click"
    if dataset == "amazon":  # cold = at most 4 exposures
        cold_items = np.repeat(np.arange(200), 3)
        cold_label = np.tile([1, 0, 0], 200)
    else:  # cold = popularity under 0.05
        cold_items = np.repeat(np.arange(10), 100)
        cold_label = np.tile([1, 1] + [0] * 98, 10)
    warm_n = 4000
    df = pd.DataFrame({
        "itemid": np.concatenate([cold_items, rng.integers(300, 500, warm_n)]),
        label: np.concatenate([cold_label, rng.integers(0, 2, warm_n)])})
    df["domain"] = rng.choice([0, 1, 2, 3], len(df),
                              p=[0.60, 0.388, 0.007, 0.005])
    return df


@pytest.mark.parametrize("dataset", ["amazon", "aliccp"])
def test_make_augmentation_equals_jax(dataset):
    df = _aug_frame(dataset, seed=0)
    got = augment.make_augmentation(df, dataset, 0.1,
                                    rng=np.random.default_rng(5))
    want = jaugment.make_augmentation(df, dataset, 0.1,
                                      rng=np.random.default_rng(5))
    pd.testing.assert_frame_equal(got, want)
    added = got[got["is_augmented"]]
    assert len(added) == int(len(df) * 0.1) > 0
    assert set(added["domain"].unique()) <= {2, 3}
    # no rng given: both default to the same stream
    pd.testing.assert_frame_equal(augment.make_augmentation(df, dataset, 0.05),
                                  jaugment.make_augmentation(df, dataset, 0.05))
    # nothing to add: the frame comes back flagged and unchanged
    none = augment.make_augmentation(df, dataset, 0.0)
    assert len(none) == len(df) and not none["is_augmented"].any()
    with pytest.raises(ValueError):
        augment.make_augmentation(
            df, "movielens", 0.1,
            label_name="label" if dataset == "amazon" else "click")


@pytest.mark.parametrize("dataset", ["amazon", "aliccp", "cloudtheme"])
def test_preprocessed_csv_path_equals_jax(dataset, tmp_path):
    kw = dict(prepare2train_month=6, thresh=10, n_domain=12,
              sample_mode="nlargest")
    assert pipeline.preprocessed_csv_path(dataset, str(tmp_path), **kw) == \
        jpipeline.preprocessed_csv_path(dataset, str(tmp_path), **kw)
    assert pipeline.preprocessed_csv_path(dataset, "d") == \
        jpipeline.preprocessed_csv_path(dataset, "d")


def test_run_preprocessing_returns_the_csv_or_raises_by_name(tmp_path):
    """The JAX contract: an existing CSV is returned untouched; with
    neither the CSV nor the raw dumps, FileNotFoundError names both, with
    the JAX package's message; an unknown dataset is a ValueError."""
    with pytest.raises(ValueError):
        pipeline.preprocessed_csv_path("movielens", "d")
    for name in ("amazon", "aliccp", "cloudtheme"):
        errors = []
        for run in (pipeline.run_preprocessing, jpipeline.run_preprocessing):
            with pytest.raises(FileNotFoundError,
                               match="missing and raw dump") as e:
                run(name, str(tmp_path), verbose=False)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    csv = tmp_path / "aliccp" / "thresh15_ndomain30_modeinterval_random.csv"
    csv.parent.mkdir(exist_ok=True)
    csv.write_text("itemid\n0\n")
    assert pipeline.run_preprocessing("aliccp", str(tmp_path)) == str(csv)
    assert jpipeline.run_preprocessing("aliccp", str(tmp_path),
                                       verbose=False) == str(csv)
    assert csv.read_text() == "itemid\n0\n"
    other = tmp_path / "other.csv"
    with pytest.raises(FileNotFoundError, match="other.csv"):
        pipeline.run_preprocessing("aliccp", str(tmp_path),
                                   out_path=str(other))
    with pytest.raises(ValueError):
        pipeline.run_preprocessing("movielens", str(tmp_path),
                                   out_path=str(other))
