"""The port's native CSV parser (aread_tpu_torch/native) against the JAX
package's (aread_tpu.native.load_csv) and against the port's own pandas
path on seed-made canonical CSVs: x, y and split bitwise equal (dtype,
shape and every value; no tolerance). Also: the library is built into
aread_tpu_torch/_build/ and nothing into the package; a failed build
raises with the compiler's output instead of falling back;
AREAD_TPU_NO_NATIVE=1 is the one way to pandas; the loader records the
parser it used and falls back, with a warning, on a file the native
parser rejects; load_split_data equals the JAX package's."""

import gc
import logging
import os

import numpy as np
import pytest

from aread_tpu import native as jnative
from aread_tpu.data import loader as jloader
from aread_tpu_torch import native
from aread_tpu_torch.data import loader
from tests.test_torch_port_data import make_canonical_frame


def _columns(dataset):
    one_hot, seq, label = loader.dataset_columns(dataset)
    return one_hot, seq, label, ("timestamp" if dataset == "amazon"
                                 else "train_tag")


def _assert_bitwise(got, want):
    for g, w, name in zip(got, want, ("x", "y", "split")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("dataset,maxlen,pad", [
    ("amazon", 5, 64), ("amazon", 3, -1), ("amazon", 9, 7),
    ("aliccp", 5, 0)], ids=["amazon", "amazon-short", "amazon-long",
                             "aliccp"])
def test_native_equals_jax_and_pandas(dataset, maxlen, pad, tmp_path):
    """Amazon with its two history columns (0 to 8 ids a cell, so maxlen 3
    keeps the last 3 of a long one), AliCCP without sequences."""
    path = str(tmp_path / "data.csv")
    make_canonical_frame(dataset, 3000, seed=21).to_csv(path, index=False)
    cols = _columns(dataset)
    got = native.load_csv(path, *cols, maxlen, pad)
    _assert_bitwise(got, jnative.load_csv(path, *cols, maxlen, pad))
    _assert_bitwise(got, loader.read_with_pandas(path, *cols, maxlen, pad))
    # one thread or many: the same arrays
    _assert_bitwise(got, native.load_csv(path, *cols, maxlen, pad,
                                         n_threads=1))
    _assert_bitwise(loader.read_with_pandas(path, *cols, maxlen, pad,
                                            nrows=100),
                    tuple(a[:100] for a in got))


def test_long_sequences_keep_their_last_ids(tmp_path):
    p = tmp_path / "seq.csv"
    p.write_text('itemid,domain,seq,label,train_tag\n'
                 '3,0,"[1, 2, 3, 4, 5, 6, 7]",1,0\n'
                 '4,1,[9],0,1\n'
                 '5,1,[],0,2\n')
    args = (str(p), ["itemid", "domain"], ["seq"], "label", "train_tag", 5, 99)
    x, y, split = native.load_csv(*args)
    np.testing.assert_array_equal(x, [[3, 0, 3, 4, 5, 6, 7],
                                      [4, 1, 9, 99, 99, 99, 99],
                                      [5, 1, 99, 99, 99, 99, 99]])
    np.testing.assert_array_equal(y, [1, 0, 0])
    np.testing.assert_array_equal(split, [0.0, 1.0, 2.0])
    _assert_bitwise((x, y, split), jnative.load_csv(*args))
    _assert_bitwise((x, y, split), loader.read_with_pandas(*args))


def test_missing_column_and_bad_value_raise(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("a,b\n1,2\n")
    for lib in (native, jnative):
        with pytest.raises(RuntimeError, match="column not found: zzz"):
            lib.load_csv(str(p), ["a", "zzz"], [], "b", "a", 5, 0)
        with pytest.raises(RuntimeError, match="label/split column"):
            lib.load_csv(str(p), ["a"], [], "nope", "a", 5, 0)
    q = tmp_path / "text.csv"
    q.write_text("a,b\n1,2\nx,3\n")
    with pytest.raises(RuntimeError, match="row 1: parse error"):
        native.load_csv(str(q), ["a"], [], "b", "b", 5, 0, n_threads=1)
    with pytest.raises(RuntimeError, match="cannot open"):
        native.load_csv(str(tmp_path / "none.csv"), ["a"], [], "b", "b", 5, 0)


def test_arrays_outlive_the_call_without_a_copy(tmp_path):
    """load_csv hands out the parser's buffers (writable, not copied);
    they stay valid after every other reference is gone."""
    path = str(tmp_path / "data.csv")
    make_canonical_frame("amazon", 500, seed=3).to_csv(path, index=False)
    cols = _columns("amazon")
    want = [a.copy() for a in jnative.load_csv(path, *cols, 5, 40)]
    x, y, split = native.load_csv(path, *cols, 5, 40)
    assert x.flags.writeable and not x.flags.owndata
    del y, split
    gc.collect()
    np.testing.assert_array_equal(x, want[0])
    x[0, 0] = -5  # its own memory: no other array sees it
    assert native.load_csv(path, *cols, 5, 40)[0][0, 0] == want[0][0, 0]
    e = tmp_path / "empty.csv"
    e.write_text("itemid,label,timestamp\n")
    x, y, split = native.load_csv(str(e), ["itemid"], [], "label",
                                  "timestamp", 5, 0)
    assert x.shape == (0, 1) and y.shape == split.shape == (0,)


def test_library_builds_into_the_build_directory():
    lib = native.build()
    assert lib == native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.name == "aread_tpu_torch"
    assert lib.exists() and lib.name.startswith("libaread_csv_")
    pkg = native.SRC.parent
    assert sorted(p.name for p in pkg.iterdir()
                  if p.name != "__pycache__") == [
        "__init__.py", "__main__.py", "csv_loader.cc"]


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                      monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'csv_loader.cc:1: error: broken' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "_lib", None)
    # the library's name follows the compiler: nothing built to load
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match="(?s)exit 1.*error: broken"):
        native.available()
    path = str(tmp_path / "data.csv")
    make_canonical_frame("aliccp", 50, seed=1).to_csv(path, index=False)
    monkeypatch.setenv("AREAD_TPU_CACHE", "0")
    with pytest.raises(RuntimeError, match="error: broken"):
        loader.load_split_data(path, "aliccp")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
    assert not any(native.BUILD_DIR.glob(".libaread_csv_*"))
    # AREAD_TPU_NO_NATIVE: pandas, and no build is attempted
    monkeypatch.setenv("AREAD_TPU_NO_NATIVE", "1")
    assert not native.available()
    loader.load_split_data(path, "aliccp")
    assert loader.parser_of(path) == "pandas"


def test_loader_records_its_parser_and_falls_back_with_a_warning(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("AREAD_TPU_CACHE", str(tmp_path / "cache"))
    path = str(tmp_path / "data.csv")
    make_canonical_frame("amazon", 400, seed=5).to_csv(path, index=False)
    cold = loader.load_split_data(path, "amazon", itemid_all=64)
    assert loader.parser_of(path) == "native"
    warm = loader.load_split_data(path, "amazon", itemid_all=64)
    assert loader.parser_of(path) == "cache"
    np.testing.assert_array_equal(cold.train_x, warm.train_x)
    # a cell the native parser rejects and pandas reads: a float label
    df = make_canonical_frame("aliccp", 200, seed=6)
    df["click"] = df["click"].astype(str)
    df.loc[3, "click"] = "1e0"
    bad = str(tmp_path / "bad.csv")
    df.to_csv(bad, index=False)
    with pytest.raises(RuntimeError, match="parse error"):
        native.load_csv(bad, *_columns("aliccp"), 5, 0)
    with caplog.at_level(logging.WARNING, logger=loader.__name__):
        data = loader.load_split_data(bad, "aliccp")
    assert loader.parser_of(bad) == "pandas"
    assert "native parse of" in caplog.text and "parse error" in caplog.text
    assert data.train_x.shape[0] + data.valid_x.shape[0] + \
        data.test_x.shape[0] == 200
    assert loader.parser_of(str(tmp_path / "unread.csv")) is None


@pytest.mark.parametrize("dataset,kw", [
    ("amazon", dict(itemid_all=1368287)), ("amazon", dict(itemid_all=None)),
    ("aliccp", dict())], ids=["amazon-vocab", "amazon", "aliccp"])
def test_load_split_data_with_native_equals_jax(dataset, kw, tmp_path,
                                                monkeypatch):
    path = str(tmp_path / "data.csv")
    make_canonical_frame(dataset, 2000, seed=8).to_csv(path, index=False)
    monkeypatch.setenv("AREAD_TPU_CACHE", "0")
    got = loader.load_split_data(path, dataset, **kw)
    assert loader.parser_of(path) == "native"
    want = jloader.load_split_data(path, dataset, **kw)
    for name in ("train_x", "train_y", "valid_x", "valid_y", "test_x",
                 "test_y", "domain_cnt_weight"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tuple(got.spec.one_hot_dims) == tuple(want.spec.one_hot_dims)
    assert got.n_domain == want.n_domain


def test_python_dash_m_builds_the_library(tmp_path):
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "aread_tpu_torch.native"],
                          cwd=native.BUILD_DIR.parent.parent, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"native library: {native.library_path()}"
