"""The port's data pipeline (aread_tpu_torch/data/preprocess.py,
aliccp_raw.py, pipeline.py and the CLI's CSV step) against the JAX
package's on the same seed-made raw dumps. Both sides are pandas and
numpy: every frame is equal (``assert_frame_equal``, dtypes included),
every CSV byte-identical (sha1), no tolerance. The CLI trains from a raw
AliCCP directory on the CPU and its test metrics equal, exactly, those of
the CLI on the CSV the JAX package's ``run_preprocessing`` wrote."""

import hashlib
import json
import os
import subprocess
import sys
import threading
from datetime import timedelta

import numpy as np
import pandas as pd
import pytest

from aread_tpu.data import aliccp_raw as jraw
from aread_tpu.data import pipeline as jpipeline
from aread_tpu.data import preprocess as jpre
from aread_tpu_torch.data import aliccp_raw as raw
from aread_tpu_torch.data import pipeline, preprocess as pre

AMAZON_CATEGORIES = list(pre.AMAZON_DOMAIN2ENCODER)
USER_FIELDS = ("121", "122", "124", "125", "126", "127", "128", "129")
USER_DENSE = ("109_14", "110_14", "127_14", "150_14")
ITEM_FIELDS = ("207", "210", "216", "301")
ITEM_DENSE = ("508", "509", "702", "853")


# ------------------------------------------------------------ raw dumps
def _feat(field, feat, val="1"):
    return f"{field}\x02{feat}\x03{val}"


def aliccp_lines(seed, n_domain=6, rows_per_domain=300, n_users=100,
                 n_items=100, test_frac=0.3):
    """(skeleton_train, common_train, skeleton_test, common_test) lines
    in the raw AliCCP format, the order ``preprocess_raw_aliccp`` takes: one common-feature blob per user (101, the user
    fields and the 4 user-side dense fields), skeleton rows with the item
    fields and the 4 item-side dense fields; a few click=0 & purchase=1
    rows, which the parser drops."""
    rng = np.random.default_rng(seed)
    common = []
    for u in range(n_users):
        blob = [_feat("101", f"u{u}")]
        blob += [_feat(f, f"{f}_{rng.integers(0, 3)}") for f in USER_FIELDS]
        blob += [_feat(f, f"{f}_{rng.integers(0, 2)}", f"{rng.random():.4f}")
                 for f in USER_DENSE]
        common.append(f"c{u},{len(blob)},{chr(1).join(blob)}")

    def skeleton(n, first_id):
        lines = []
        dom = rng.integers(0, n_domain, n)
        user = rng.integers(0, n_users, n)
        item = rng.integers(0, n_items, n)
        for i in range(n):
            blob = [_feat("205", f"i{item[i]}"), _feat("206", f"d{dom[i]}")]
            blob += [_feat(f, f"{f}_{item[i] % 5}") for f in ITEM_FIELDS]
            blob += [_feat(f, f"{f}_{rng.integers(0, 2)}",
                           f"{rng.random() * 9:.3f}") for f in ITEM_DENSE]
            click = int(rng.random() < 0.2 + 0.5 * (item[i] % 3 == 0))
            buy = int(rng.random() < (0.3 if click else 0.01))
            lines.append(f"{first_id + i},{click},{buy},c{user[i]},"
                         f"{len(blob)},{chr(1).join(blob)}")
        return lines

    n_train = n_domain * rows_per_domain
    train = skeleton(n_train, 0)
    test = skeleton(int(n_train * test_frac), n_train)
    return train, common, test, common


def write_aliccp_raw(data_path, seed, **kw):
    base = data_path / "aliccp"
    base.mkdir(parents=True)
    for name, lines in zip(("sample_skeleton_train", "common_features_train",
                            "sample_skeleton_test", "common_features_test"),
                           aliccp_lines(seed, **kw)):
        (base / f"{name}.csv").write_text("\n".join(lines) + "\n")


def amazon_raw_frames(seed, n=3000, n_users=40, n_items=60):
    """(ratings, meta json rows): ratings over ~2 years ending in Aug 2018
    (so the windows and the history cut bite), items over the 25
    categories, the price / salesRank / brand forms the parser meets
    (ranges, dicts and strings, empty, missing), some items unlisted."""
    rng = np.random.default_rng(seed)
    t0, t1 = 1471000000, 1534291200
    items = [f"B{i:09d}" for i in range(n_items)]
    ratings = pd.DataFrame({
        "itemid": rng.choice(items, n),
        "userid": [f"A{u:06d}" for u in rng.integers(0, n_users, n)],
        "rating": rng.integers(1, 6, n).astype(float),
        "timestamp": rng.integers(t0, t1, n),
    })
    meta = []
    for i, asin in enumerate(items[:-3]):  # the last three have no meta
        cat = AMAZON_CATEGORIES[i % 25]
        price = (f"${rng.integers(1, 300)}.{rng.integers(0, 99):02d}"
                 if i % 7 else ("$5.00 - $9.50" if i % 14 else ""))
        rank = ({cat: int(rng.integers(1, 2_000_000))} if i % 3 == 0 else
                f"{int(rng.integers(1, 90_000)):,} in {cat} (See Top 100)"
                if i % 3 == 1 else None)
        meta.append({"asin": asin, "price": price, "salesRank": rank,
                     "brand": f"brand{i % 4}" if i % 5 else f"rare{i}",
                     "category": [cat, "sub"] if i % 11 else []})
    meta.append("not json")
    return ratings, meta


def write_amazon_raw(data_path, seed, **kw):
    ratings, meta = amazon_raw_frames(seed, **kw)
    base = data_path / "amazon"
    base.mkdir(parents=True)
    ratings.to_csv(base / "all_csv_files.csv", index=False, header=False)
    (base / "All_Amazon_Meta.json").write_text("\n".join(
        m if isinstance(m, str) else json.dumps(m) for m in meta) + "\n")


def cloudtheme_frame(seed, n=1500):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "user_id": rng.integers(0, 40, n),
        "item_id": rng.integers(0, 40, n),
        "theme_id": rng.integers(0, 8, n),
        "leaf_cate_id": rng.integers(0, 10, n),
        "cate_level1_id": rng.integers(0, 4, n),
        "reach_time": rng.permutation(n),
        "clk_cnt": rng.integers(1, 5, n),
    })


def write_cloudtheme_raw(data_path, seed):
    base = data_path / "cloudtheme"
    base.mkdir(parents=True)
    cloudtheme_frame(seed).to_csv(base / "theme_click_log.csv", index=False)


def sha1(path):
    return hashlib.sha1(open(path, "rb").read()).hexdigest()


# ------------------------------------------------------------ preprocess
def test_value_parsers_equal_jax():
    for s in ("$12.99", "$5.00 - $9.50", "", None, 3.0, "free", "$1,299.00",
              "-", "12"):
        assert pre.process_price(s) == jpre.process_price(s), s
    for s in ("1,500 in Books", "3,200 in Electronics (See Top 100)", None,
              "no rank", 17, "x in y in z"):
        assert pre.process_rank(s) == jpre.process_rank(s), s
    series = pd.Series(["b", "a", 3, "b", "-1", "a"], index=[5, 4, 3, 2, 1, 0])
    (got, gmap), (want, wmap) = pre.label_encode(series), jpre.label_encode(series)
    pd.testing.assert_series_equal(got, want)
    assert gmap == wmap
    rng = np.random.default_rng(0)
    train, other = rng.random(500) * 7, rng.random(300) * 9 - 1
    for bins in (10, 3):
        np.testing.assert_array_equal(
            pre.uniform_discretize(train, bins)(other),
            jpre.uniform_discretize(train, bins)(other))


def test_k_core_and_user_history_equal_jax():
    ratings, _ = amazon_raw_frames(1, n=800, n_users=30, n_items=40)
    for k in (1, 3, 9):
        pd.testing.assert_frame_equal(pre.k_core_filter(ratings, k),
                                      jpre.k_core_filter(ratings, k))
    df = ratings.assign(label=(ratings["rating"] > 3).astype(int))
    for months in (1, 6):
        pd.testing.assert_frame_equal(pre.build_user_history(df, months),
                                      jpre.build_user_history(df, months))


@pytest.mark.parametrize("kw", [{}, {"k_cores": 2, "domains": ("Books",
                                                               "Electronics")},
                                {"prepare2train_month": 6,
                                 "history_months": (6,)}],
                         ids=["defaults", "domains", "6month"])
def test_preprocess_amazon_equals_jax(kw):
    ratings, meta_rows = amazon_raw_frames(2)
    meta = pd.DataFrame([m for m in meta_rows if isinstance(m, dict)])
    meta = meta.rename(columns={"asin": "itemid"}).assign(
        salesRank=meta["salesRank"].map(
            lambda r: f"{next(iter(r.values())):,} in {next(iter(r))}"
            if isinstance(r, dict) else r),
        category=meta["category"].map(repr))
    got = pre.preprocess_amazon(ratings, meta, **kw)
    want = jpre.preprocess_amazon(ratings, meta, **kw)
    assert len(got) > 50
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("mode", ["nlargest", "random", "interval",
                                  "weighted", "interval_random"])
def test_sample_domains_equals_jax(mode):
    counts = pd.Series(np.random.default_rng(3).integers(50, 5000, 140),
                       index=[f"d{i}" for i in range(140)]
                       ).sort_values(ascending=False)
    for n_domain in (5, 30):
        assert pre.sample_domains(counts, n_domain, mode,
                                  np.random.default_rng(4)) == \
            jpre.sample_domains(counts, n_domain, mode,
                                np.random.default_rng(4))
    with pytest.raises(ValueError):
        pre.sample_domains(counts, 5, "bogus")


def test_aliccp_and_cloudtheme_preprocess_equal_jax():
    frames = raw.preprocess_raw_aliccp(*aliccp_lines(5), seed=9)
    for thresh, mode in ((15, "interval_random"), (2, "random"),
                         (5, "nlargest")):
        got = pre.preprocess_aliccp(*frames, thresh=thresh, n_domain=4,
                                    sample_mode=mode,
                                    rng=np.random.default_rng(1))
        want = jpre.preprocess_aliccp(*frames, thresh=thresh, n_domain=4,
                                      sample_mode=mode,
                                      rng=np.random.default_rng(1))
        assert len(got) > 0
        pd.testing.assert_frame_equal(got, want)
    df = frames[0].rename(columns={"101": "userid", "205": "itemid",
                                   "206": "domain"})
    for dataset, names in (("aliccp", ()),
                           ("cloudtheme", ("userid", "itemid", "domain"))):
        got = pre.filter_by_threshold(df, 3, 3, "interval", dataset, names)
        want = jpre.filter_by_threshold(df, 3, 3, "interval", dataset, names)
        pd.testing.assert_frame_equal(got[0], want[0])
        assert got[1:] == want[1:]
    ct = cloudtheme_frame(6)
    for ratio, mode in ((4, "interval_random"), (1, "nlargest")):
        pd.testing.assert_frame_equal(
            pre.preprocess_cloudtheme(ct, k_cores=2, sample_mode=mode,
                                      negative_sampling_ratio=ratio,
                                      rng=np.random.default_rng(2)),
            jpre.preprocess_cloudtheme(ct, k_cores=2, sample_mode=mode,
                                       negative_sampling_ratio=ratio,
                                       rng=np.random.default_rng(2)))


# ------------------------------------------------------------ aliccp_raw
def test_aliccp_raw_functions_equal_jax():
    assert raw.SPARSE_COLUMNS == jraw.SPARSE_COLUMNS
    assert raw.DENSE_COLUMNS == jraw.DENSE_COLUMNS
    assert raw.USES_COLUMNS == jraw.USES_COLUMNS
    train, common, test, _ = aliccp_lines(7, n_domain=3, rows_per_domain=80)
    blob = "\x01".join([_feat("101", "u7"), _feat("508", "f3", "0.25"),
                        _feat("999", "x", "2"), ""])
    assert raw.parse_feat_str(blob) == jraw.parse_feat_str(blob)
    assert raw.parse_feat_str(blob) == {"101": "u7", "508": "f3",
                                        "D508": "0.25"}
    cf = raw.load_common_features(common)
    assert cf == jraw.load_common_features(common)
    for vocab in (False, True):
        got, gv = raw.join_skeleton(train, cf, build_vocab=vocab)
        want, wv = jraw.join_skeleton(train, cf, build_vocab=vocab)
        pd.testing.assert_frame_equal(got, want)
        assert gv == wv
    assert len(got) < len(train)  # the click=0 & purchase=1 rows went
    fmap = raw.build_feat_map(gv)
    assert fmap == jraw.build_feat_map(wv)
    assert fmap == raw.build_feat_map(gv, min_freq=10)
    enc = raw.encode_frame(got, fmap)
    pd.testing.assert_frame_equal(enc, jraw.encode_frame(got, fmap))
    halves = [enc.iloc[:100], enc.iloc[100:]]
    for g, w in zip(raw.minmax_scale_dense(halves),
                    jraw.minmax_scale_dense(halves)):
        pd.testing.assert_frame_equal(g, w)
    for seed in (2022, 3):
        for g, w in zip(raw.preprocess_raw_aliccp(train, common, test, common,
                                                  seed=seed),
                        jraw.preprocess_raw_aliccp(train, common, test, common,
                                                   seed=seed)):
            pd.testing.assert_frame_equal(g, w)


# ------------------------------------------------------------ pipeline
def test_amazon_meta_frame_equals_jax(tmp_path):
    write_amazon_raw(tmp_path, 3)
    path = str(tmp_path / "amazon" / "All_Amazon_Meta.json")
    for keep in (None, [f"B{i:09d}" for i in range(0, 60, 2)], []):
        got = pipeline.amazon_meta_frame(path, keep_items=keep)
        pd.testing.assert_frame_equal(
            got, jpipeline.amazon_meta_frame(path, keep_items=keep))
    assert len(pipeline.amazon_meta_frame(path)) == 57  # 3 unlisted, 1 bad


def test_stream_amazon_ratings_equals_jax(tmp_path):
    """With k-core casualties holding the newest ratings: the window anchor
    is the post-k-core maximum in both, and the streaming result equals
    the in-memory k-core + margin cut."""
    ratings, _ = amazon_raw_frames(4, n=6000, n_users=120, n_items=200)
    t_hi = int(ratings["timestamp"].max())
    casualties = pd.DataFrame({
        "itemid": [f"IX{i}" for i in range(4)],
        "userid": [f"UX{i}" for i in range(4)],
        "rating": [5.0] * 4,
        "timestamp": [t_hi + 3_456_000 + i for i in range(4)]})
    ratings = pd.concat([ratings, casualties], ignore_index=True)
    path = tmp_path / "raw.csv"
    ratings.to_csv(path, index=False, header=False)
    logs = []
    got, mean = pipeline.stream_amazon_ratings(str(path), chunksize=1700,
                                               log=logs.append)
    want, wmean = jpipeline.stream_amazon_ratings(str(path), chunksize=1700)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_series_equal(mean, wmean)
    assert len(logs) == 4
    core = pre.k_core_filter(ratings, 3)
    margin = (core["timestamp"].max()
              - int(timedelta(days=30 * 12 + 6 - 1).total_seconds())
              - int(timedelta(days=30 * 6 - 1).total_seconds()))
    cut = core.loc[core["timestamp"] >= margin]
    assert len(got) == len(cut) < len(core)
    assert not got["userid"].str.startswith("UX").any()
    (tmp_path / "none.csv").write_text("I1,U1,5.0,1500000000\n")
    with pytest.raises(ValueError, match="no k-core survivors"):
        pipeline.stream_amazon_ratings(str(tmp_path / "none.csv"))


@pytest.mark.parametrize("dataset,kw", [
    ("amazon", {}),
    ("amazon", {"k_cores": 2, "prepare2train_month": 6}),
    ("aliccp", {}),
    ("aliccp", {"thresh": 5, "n_domain": 4, "sample_mode": "random",
                "seed": 11}),
    ("cloudtheme", {"k_cores": 2}),
    ("cloudtheme", {"k_cores": 2, "n_domain": 5, "sample_mode": "weighted",
                    "seed": 3}),
], ids=["amazon", "amazon-6month", "aliccp", "aliccp-random",
        "cloudtheme", "cloudtheme-weighted"])
def test_run_preprocessing_writes_the_jax_bytes(dataset, kw, tmp_path,
                                                capsys):
    writer = {"amazon": write_amazon_raw, "aliccp": write_aliccp_raw,
              "cloudtheme": write_cloudtheme_raw}[dataset]
    for side in ("port", "jax"):
        writer(tmp_path / side, 8)
    got = pipeline.run_preprocessing(dataset, str(tmp_path / "port"), **kw)
    want = jpipeline.run_preprocessing(dataset, str(tmp_path / "jax"),
                                       verbose=False, **kw)
    assert got.startswith(str(tmp_path / "port"))
    assert got[len(str(tmp_path / "port")):] == \
        want[len(str(tmp_path / "jax")):]
    assert len(pd.read_csv(got)) > 50
    assert sha1(got) == sha1(want)
    out = capsys.readouterr().out
    assert f"[preprocess:{dataset}] wrote {got}" in out  # verbose
    # the skip path: the file is left as it is
    mtime = (tmp_path / got).stat().st_mtime_ns
    assert pipeline.run_preprocessing(dataset, str(tmp_path / "port"),
                                      **kw) == got
    assert (tmp_path / got).stat().st_mtime_ns == mtime


def test_pipeline_main_builds_a_csv(tmp_path, monkeypatch, capsys):
    write_cloudtheme_raw(tmp_path, 2)
    out = str(tmp_path / "ct.csv")
    monkeypatch.setattr("sys.argv", [
        "pipeline", "--dataset_name", "cloudtheme", "--data_path",
        str(tmp_path), "--out_path", out, "--k_cores", "2", "--seed", "4"])
    pipeline._main()
    assert capsys.readouterr().out.splitlines()[-1] == out
    want = jpipeline.run_preprocessing(
        "cloudtheme", str(tmp_path), out_path=str(tmp_path / "jax.csv"),
        k_cores=2, seed=4, verbose=False)
    assert sha1(out) == sha1(want)


# ------------------------------------------------------------ the CLI
CLI = ["--device", "cpu", "--dataset_name", "aliccp", "--model", "deepfm",
       "--bs", "64", "--embed_dim", "8", "--epoch", "1"]


def _cli_run(main, capsys, data_path, save_path, *extra):
    main(CLI + ["--data_path", str(data_path), "--save_path", str(save_path),
                *extra])
    out = capsys.readouterr().out
    test = [l for l in out.splitlines() if l.startswith("test: {")]
    stages = [l for l in out.splitlines() if l.startswith("stages: ")]
    assert len(test) == 1 and len(stages) == 1, out[-2000:]
    return (eval(test[0][len("test: "):], {"nan": float("nan")}),
            json.loads(stages[0][len("stages: "):]))


def test_cli_trains_from_raw_aliccp_dumps(tmp_path, capsys, monkeypatch):
    """The CLI builds the CSV from the raw dumps with its --seed (the JAX
    package's bytes for that seed, not the default seed's), parses it
    natively and trains; its test metrics equal, exactly, the CLI's on the
    CSV the JAX package wrote. A second run takes the skip path. At the
    CLI's defaults (sparse_table_grad) DeepFM's update is the sparse
    table update (kernel 1 on a card) and never the fused one (kernel
    2)."""
    from aread_tpu_torch.__main__ import main
    from aread_tpu_torch.train import trainer

    calls = {"sparse_adam": 0, "fused_adam": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(trainer, f"{name}_dispatch", counting(
            name, getattr(trainer, f"{name}_dispatch")))
    monkeypatch.setenv("AREAD_TPU_CACHE", "0")
    write_aliccp_raw(tmp_path / "raw", 12)
    raw_res, stages = _cli_run(main, capsys, tmp_path / "raw",
                               tmp_path / "s1", "--seed", "7")
    assert calls["sparse_adam"] > 0 and calls["fused_adam"] == 0
    csv = pipeline.preprocessed_csv_path("aliccp", str(tmp_path / "raw"))
    assert stages["parser"] == "native" and stages["aug_parser"] is None
    assert set(stages) >= {"preprocess_s", "augment_s", "load_s", "fit_s"}
    for seed, same in ((7, True), (2000, False)):
        ref = tmp_path / f"jax{seed}"
        write_aliccp_raw(ref, 12)
        jcsv = jpipeline.run_preprocessing("aliccp", str(ref), seed=seed,
                                           verbose=False)
        assert (sha1(csv) == sha1(jcsv)) is same, seed
    (tmp_path / "jax2000" / "aliccp" / "sample_skeleton_train.csv").unlink()
    csv_res, _ = _cli_run(main, capsys, tmp_path / "jax7", tmp_path / "s2",
                          "--seed", "7")
    assert np.isfinite(raw_res["total_loss"])
    assert raw_res.keys() == csv_res.keys()
    for k, v in raw_res.items():
        assert v == csv_res[k] or (np.isnan(v) and np.isnan(csv_res[k])), k
    mtime = (tmp_path / csv).stat().st_mtime_ns
    _, again = _cli_run(main, capsys, tmp_path / "raw", tmp_path / "s3",
                        "--seed", "7")
    assert (tmp_path / csv).stat().st_mtime_ns == mtime
    assert again["preprocess_s"] < stages["preprocess_s"]


class _Rank:
    def __init__(self, rank):
        self.rank = rank


def test_mesh_rank_zero_alone_builds_the_csv(tmp_path, monkeypatch):
    """On a mesh the CSV step runs on the local rank 0 of each node while
    the node's other ranks poll for the finished file; they then take the
    skip path. Four threads stand for four ranks on two nodes, each node
    with a disk of its own; the raw-dump build runs once a node and no
    collective is called."""
    import aread_tpu_torch.__main__ as cli
    from aread_tpu_torch.config import Config
    from aread_tpu_torch.data import preprocess as port_pre
    from aread_tpu_torch.parallel import health
    from aread_tpu_torch.parallel import mesh as port_mesh

    cfgs = {}
    for node in (0, 1):
        write_cloudtheme_raw(tmp_path / f"node{node}", 1)
        cfgs[node] = Config(dataset_name="cloudtheme",
                            data_path=str(tmp_path / f"node{node}"), seed=5)
    builds, events = [], []
    real = port_pre.preprocess_cloudtheme

    def counting(*a, **kw):
        builds.append(threading.current_thread().name)
        return real(*a, **kw)

    def barrier(tag, *a, **kw):
        events.append((threading.current_thread().name, tag))

    monkeypatch.setattr(port_pre, "preprocess_cloudtheme", counting)
    monkeypatch.setattr(health, "barrier", barrier)
    # rank r is local rank r % 2 of node r // 2
    monkeypatch.setattr(port_mesh, "local_rank", lambda: int(
        threading.current_thread().name[-1]) % 2)
    out, errors = {}, []

    def rank(r):
        try:
            out[r] = cli.canonical_csv(cfgs[r // 2], _Rank(r))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), name=f"rank{r}")
               for r in (1, 3, 0, 2)]  # the waiting ranks arrive first
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not errors, errors
    assert sorted(builds) == ["rank0", "rank2"]
    assert events == []
    for node in (0, 1):
        assert out[2 * node] == out[2 * node + 1] == \
            pipeline.preprocessed_csv_path("cloudtheme",
                                           str(tmp_path / f"node{node}"))
    write_cloudtheme_raw(tmp_path / "jax", 1)
    want = jpipeline.run_preprocessing("cloudtheme", str(tmp_path / "jax"),
                                       seed=5, verbose=False)
    assert sha1(out[0]) == sha1(out[2]) == sha1(want)
    assert not list((tmp_path / "node0" / "cloudtheme").glob("*.tmp"))
    # one process: no barrier and no wait
    cfg = cfgs[0]
    assert cli.canonical_csv(cfg) == out[0] and events == []


SLOW_BUILD_RANK = """
import datetime, os, sys, time
import torch.distributed as dist
rank, store, data_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["LOCAL_RANK"] = str(rank)
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=2))
import aread_tpu_torch.__main__ as cli
from aread_tpu_torch.config import Config
from aread_tpu_torch.data import preprocess
from aread_tpu_torch.parallel.mesh import make_mesh

real = preprocess.preprocess_cloudtheme


def slow(*a, **kw):
    time.sleep(4.0)  # twice the process group's timeout
    return real(*a, **kw)


preprocess.preprocess_cloudtheme = slow
mesh = make_mesh(1, 2, device="cpu")
cfg = Config(dataset_name="cloudtheme", data_path=data_path, seed=5)
print(cli.canonical_csv(cfg, mesh), flush=True)
dist.destroy_process_group()
"""


def test_mesh_csv_build_may_outlast_the_process_group_timeout(tmp_path):
    """Two gloo ranks whose process group times out after 2 s, and a CSV
    build of about 4 s on local rank 0: rank 1 waits for the file, not at
    a collective, and both ranks return the same path."""
    write_cloudtheme_raw(tmp_path, 1)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", SLOW_BUILD_RANK, str(r),
         str(tmp_path / "store"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = [out.strip().splitlines()[-1] for out, _ in outs]
    assert paths[0] == paths[1] == pipeline.preprocessed_csv_path(
        "cloudtheme", str(tmp_path))
