"""Raw dumps -> the canonical training CSV (counterpart of
``aread_tpu/data/pipeline.py``; the same bytes for the same dumps and
seed).

``run_preprocessing`` builds the CSV when it is missing and skips when it
exists, from the raw files of each dataset:

  amazon      all_csv_files.csv (no header: itemid,userid,rating,
              timestamp) + All_Amazon_Meta.json (json lines)
              -> prepare2train_filter_{N}month.csv; the ratings are
              streamed in three passes (``stream_amazon_ratings``)
  aliccp      sample_skeleton_{train,test}.csv +
              common_features_{train,test}.csv (the raw \\x01 \\x02 \\x03
              format, data/aliccp_raw.py) -> thresh{T}_ndomain{D}_mode{M}.csv
  cloudtheme  theme_click_log.csv -> kcore3_ndomain{D}_mode{M}_neg4.csv

The counterfactual augmentation (``*_aug{ratio}.csv``) is made by the
training CLI (data/augment.py). Standalone:

  python -m aread_tpu_torch.data.pipeline --dataset_name amazon --data_path ...
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import pandas as pd


def amazon_meta_frame(meta_path: str, keep_items=None) -> pd.DataFrame:
    """All_Amazon_Meta.json (json-lines, huge) -> the 5 columns the
    pipeline joins (preprocess.py:139-175), streaming line-by-line and
    keeping only asins present in the filtered ratings."""
    rows = []
    keep = set(keep_items) if keep_items is not None else None
    with open(meta_path) as f:
        for line in f:
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            asin = d.get("asin")
            if not asin or (keep is not None and asin not in keep):
                continue
            rank = d.get("salesRank")
            if isinstance(rank, dict) and rank:
                chart, r = next(iter(rank.items()))
                rank_str = f"{r:,} in {chart}"
            else:
                rank_str = rank if isinstance(rank, str) else None
            rows.append({
                "itemid": asin,
                "price": d.get("price"),
                "salesRank": rank_str,
                "brand": d.get("brand"),
                "category": repr(d["category"]) if isinstance(
                    d.get("category"), list) else d.get("categories"),
            })
    return pd.DataFrame(rows, columns=["itemid", "price", "salesRank",
                                       "brand", "category"])


def stream_amazon_ratings(ratings_path: str, k_cores: int = 3,
                          prepare2train_month: int = 12,
                          history_months: int = 6,
                          chunksize: int = 5_000_000, log=None):
    """Three streaming passes over the raw ratings CSV so the full
    ~100M-row dump never materializes in RAM (the reference pd.concat's
    everything, preprocess.py:489-505).

    Pass 1: per-chunk user/item rating counts.
    Pass 2: over k-core survivors only —
      * the POST-k-core max timestamp. The window anchor must come from
        the surviving frame, exactly as the in-memory path computes it
        (preprocess.py:188-191 takes df['timestamp'].max() AFTER k-core):
        if the newest raw rating belongs to a k-core casualty, an anchor
        from the raw dump would sit too late and the margin prefilter
        below would drop early-window survivors the reference keeps;
      * per-user rating sums/counts over ALL k-core survivors — the
        reference's label = rating > user-mean uses the user's full
        post-k-core history, not just the window.
    Pass 3: per-chunk filter with
      * the reference's single-pass k-core (preprocess.py:130-137) using
        the FULL-dump counts from pass 1 — identical to filtering the
        concatenated frame;
      * a time prefilter at window_start - history_months: rows older
        than that can influence neither the final trailing window
        (preprocess.py:514-520) nor any kept row's trailing history
        sequence (preprocess.py:189-236), so dropping them is lossless.

    Returns (ratings_df, user_mean) where ratings_df holds only the
    margin-window k-core survivors and user_mean is a Series indexed by
    userid. Callers pass user_mean to preprocess_amazon and disable its
    internal k-core (k_cores=1): re-running k-core on the reduced frame
    would use reduced counts and drop borderline users the reference keeps.
    """
    from datetime import timedelta

    def _log(msg):
        if log:
            log(msg)

    names = ["itemid", "userid", "rating", "timestamp"]
    read = dict(header=None, names=names, engine="c", on_bad_lines="skip",
                chunksize=chunksize)

    _log("pass 1/3: counting users/items (streaming)")
    user_count = pd.Series(dtype=np.int64)
    item_count = pd.Series(dtype=np.int64)
    for chunk in pd.read_csv(ratings_path, **read):
        user_count = user_count.add(chunk["userid"].value_counts(),
                                    fill_value=0)
        item_count = item_count.add(chunk["itemid"].value_counts(),
                                    fill_value=0)
    keep_users = set(user_count[user_count >= k_cores].index)
    keep_items = set(item_count[item_count >= k_cores].index)
    del user_count, item_count

    _log("pass 2/3: post-k-core window anchor + user means (streaming)")
    end_ts = None
    rating_sum = pd.Series(dtype=np.float64)
    rating_cnt = pd.Series(dtype=np.int64)
    for chunk in pd.read_csv(ratings_path, **read):
        core = chunk.loc[chunk["userid"].isin(keep_users)
                         & chunk["itemid"].isin(keep_items)]
        if len(core):
            m = core["timestamp"].max()
            end_ts = m if end_ts is None else max(end_ts, m)
        g = core.groupby("userid")["rating"]
        rating_sum = rating_sum.add(g.sum(), fill_value=0.0)
        rating_cnt = rating_cnt.add(g.count(), fill_value=0)
    if end_ts is None:
        raise ValueError(
            f"no k-core survivors in ratings file {ratings_path}")
    user_mean = rating_sum / rating_cnt

    days_n = 30 * prepare2train_month + prepare2train_month // 2
    window_start = int(end_ts) - int(timedelta(days=days_n - 1).total_seconds())
    margin_start = window_start - int(
        timedelta(days=30 * history_months - 1).total_seconds())

    _log("pass 3/3: k-core + window-margin filter (streaming)")
    kept = []
    for chunk in pd.read_csv(ratings_path, **read):
        core = chunk.loc[chunk["userid"].isin(keep_users)
                         & chunk["itemid"].isin(keep_items)]
        kept.append(core.loc[core["timestamp"] >= margin_start])
    ratings = pd.concat(kept, ignore_index=True)
    _log(f"{len(ratings)} rows kept "
         f"(k-core users={len(keep_users)}, items={len(keep_items)})")
    return ratings, user_mean


def preprocessed_csv_path(dataset_name: str, data_path: str,
                          prepare2train_month: int = 12,
                          thresh: int = 15, n_domain: int = 30,
                          sample_mode: str = "interval_random") -> str:
    base = os.path.join(data_path, dataset_name)
    if dataset_name == "amazon":
        return os.path.join(
            base, f"prepare2train_filter_{prepare2train_month}month.csv")
    if dataset_name == "aliccp":
        return os.path.join(
            base, f"thresh{thresh}_ndomain{n_domain}_mode{sample_mode}.csv")
    if dataset_name == "cloudtheme":
        return os.path.join(
            base, f"kcore3_ndomain{n_domain}_mode{sample_mode}_neg4.csv")
    raise ValueError(dataset_name)


def run_preprocessing(dataset_name: str, data_path: str,
                      out_path: Optional[str] = None,
                      prepare2train_month: int = 12, k_cores: int = 3,
                      thresh: int = 15, n_domain: int = 30,
                      sample_mode: str = "interval_random",
                      seed: int = 2022, verbose: bool = True) -> str:
    """Build the canonical CSV from raw dumps if it does not exist yet.
    Returns the CSV path (existing or newly written). Raises
    FileNotFoundError when neither the CSV nor the raw files are present."""
    from aread_tpu_torch.data.preprocess import (preprocess_aliccp,
                                                 preprocess_amazon,
                                                 preprocess_cloudtheme)

    base = os.path.join(data_path, dataset_name)
    csv_path = out_path or preprocessed_csv_path(
        dataset_name, data_path, prepare2train_month, thresh, n_domain,
        sample_mode)
    if os.path.exists(csv_path):
        return csv_path  # preprocess.py:477-478 skip

    def log(msg):
        if verbose:
            print(f"[preprocess:{dataset_name}] {msg}")

    rng = np.random.default_rng(seed)
    if dataset_name == "amazon":
        ratings_path = os.path.join(base, "all_csv_files.csv")
        meta_path = os.path.join(base, "All_Amazon_Meta.json")
        if not (os.path.exists(ratings_path) and os.path.exists(meta_path)):
            raise FileNotFoundError(
                f"{csv_path} missing and raw dumps not found "
                f"({ratings_path}, {meta_path})")
        # streaming: the raw dump never fully materializes (see
        # stream_amazon_ratings); k-core + user means computed there with
        # full-dump statistics, so the in-memory pipeline skips its k-core
        ratings, user_mean = stream_amazon_ratings(
            ratings_path, k_cores=k_cores,
            prepare2train_month=prepare2train_month, log=log)
        log("streaming metadata join (keep-set from filtered ratings)")
        meta = amazon_meta_frame(meta_path,
                                 keep_items=ratings["itemid"].unique())
        df = preprocess_amazon(ratings, meta, k_cores=1,
                               prepare2train_month=prepare2train_month,
                               user_mean=user_mean)
    elif dataset_name == "aliccp":
        raw = {name: os.path.join(base, f"{name}.csv")
               for name in ("sample_skeleton_train", "common_features_train",
                            "sample_skeleton_test", "common_features_test")}
        if not all(os.path.exists(p) for p in raw.values()):
            raise FileNotFoundError(
                f"{csv_path} missing and raw dumps not found ({raw})")
        from aread_tpu_torch.data.aliccp_raw import preprocess_raw_aliccp

        log("parsing raw skeleton/common features")
        with open(raw["sample_skeleton_train"]) as st, \
                open(raw["common_features_train"]) as ct, \
                open(raw["sample_skeleton_test"]) as se, \
                open(raw["common_features_test"]) as ce:
            train_df, val_df, test_df = preprocess_raw_aliccp(st, ct, se, ce,
                                                              seed=seed)
        log("discretize + domain sampling")
        df = preprocess_aliccp(train_df, val_df, test_df, thresh=thresh,
                               n_domain=n_domain, sample_mode=sample_mode,
                               rng=rng)
    elif dataset_name == "cloudtheme":
        raw_path = os.path.join(base, "theme_click_log.csv")
        if not os.path.exists(raw_path):
            raise FileNotFoundError(
                f"{csv_path} missing and raw dump not found ({raw_path})")
        log("reading click log")
        raw_df = pd.read_csv(raw_path, engine="c", on_bad_lines="skip")
        df = preprocess_cloudtheme(raw_df, k_cores=k_cores,
                                   n_domain=n_domain,
                                   sample_mode=sample_mode, rng=rng)
    else:
        raise ValueError(dataset_name)

    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    df.to_csv(csv_path, index=False)
    log(f"wrote {csv_path} ({len(df)} rows)")
    return csv_path


def _main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_name", required=True,
                   choices=["amazon", "aliccp", "cloudtheme"])
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_path", default=None)
    p.add_argument("--prepare2train_month", type=int, default=12)
    p.add_argument("--k_cores", type=int, default=3)
    p.add_argument("--thresh", type=int, default=15)
    p.add_argument("--n_domain", type=int, default=30)
    p.add_argument("--sample_mode", default="interval_random")
    p.add_argument("--seed", type=int, default=2022)
    a = p.parse_args()
    path = run_preprocessing(a.dataset_name, a.data_path, a.out_path,
                             a.prepare2train_month, a.k_cores, a.thresh,
                             a.n_domain, a.sample_mode, a.seed)
    print(path)


if __name__ == "__main__":
    _main()
