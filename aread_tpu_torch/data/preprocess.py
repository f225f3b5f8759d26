"""Offline preprocessing pipelines (counterpart of
``aread_tpu/data/preprocess.py``; the same frames, row for row):

  * amazon: k-core filter, item-metadata join (price parse and binning,
    salesRank split, rare-brand collapse, category[0] -> domain), label =
    rating > the user's mean, per-user pos/neg history sequences over
    trailing windows, the last-N-month window, log2-spaced binning of
    sales_rank / price, label encoding, the fixed 25-category domain dict;
  * aliccp: uniform binning of the 8 dense columns (fit on train only),
    the user / item frequency filter, the per-domain viability filter,
    domain sampling by one of 5 modes, ids re-encoded, train_tag 0 / 1 / 2;
  * cloudtheme: encoding, k-core + domain sampling, the time-ordered
    80/10/10 split, popularity-weighted 4:1 negative sampling from pools
    that avoid leakage.

Pure pandas / numpy host work; the card's path starts at data/loader.py.
The counterfactual augmenter is data/augment.py (``make_augmentation`` is
importable from here too, as from the JAX module).
"""

from __future__ import annotations

import ast
import re
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from aread_tpu_torch.data.augment import make_augmentation  # noqa: F401

AMAZON_DOMAIN2ENCODER: Dict[str, int] = {
    "Appliances": 0, "Arts, Crafts & Sewing": 1, "Automotive": 2, "Books": 3,
    "CDs & Vinyl": 4, "Cell Phones & Accessories": 5,
    "Clothing, Shoes & Jewelry": 6, "Collectibles & Fine Art": 7,
    "Electronics": 8, "Gift Cards": 9, "Grocery & Gourmet Food": 10,
    "Home & Business Services": 11, "Home & Kitchen": 12,
    "Industrial & Scientific": 13, "Kindle Store": 14,
    "Magazine Subscriptions": 15, "Movies & TV": 16,
    "Musical Instruments": 17, "Office Products": 18,
    "Patio, Lawn & Garden": 19, "Pet Supplies": 20, "Sports & Outdoors": 21,
    "Tools & Home Improvement": 22, "Toys & Games": 23, "Video Games": 24,
}  # preprocess.py:50-57


def label_encode(series: pd.Series) -> Tuple[pd.Series, Dict]:
    """sklearn.LabelEncoder equivalent: sorted-unique -> ordinal."""
    cats, codes = np.unique(series.astype(str).to_numpy(), return_inverse=True)
    return pd.Series(codes, index=series.index), {c: i for i, c in enumerate(cats)}


def uniform_discretize(train_col: np.ndarray, n_bins: int = 10):
    """KBinsDiscretizer(strategy='uniform', encode='ordinal') fit on train
    (preprocess.py:576-582): equal-width bins between train min/max."""
    lo, hi = float(np.min(train_col)), float(np.max(train_col))
    edges = np.linspace(lo, hi, n_bins + 1)

    def transform(col: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(edges[1:-1], col, side="right")
        return np.clip(idx, 0, n_bins - 1).astype(int)

    return transform


# --------------------------------------------------------------------------
# amazon
# --------------------------------------------------------------------------

def process_price(price_str) -> Optional[float]:
    """preprocess.py:102-114."""
    try:
        if not isinstance(price_str, str) or pd.isnull(price_str) or price_str == "":
            return None
        cleaned = re.sub(r"[^\d.-]", "", price_str)
        if "-" in cleaned:
            price = np.mean([float(p) for p in cleaned.split("-")])
        else:
            price = float(cleaned)
        return float(np.ceil(price))
    except ValueError:
        return None


def process_rank(sales_rank_str) -> Tuple[Optional[int], Optional[str]]:
    """preprocess.py:116-125."""
    if not isinstance(sales_rank_str, str):
        return None, None
    try:
        rank_part, chart_part = sales_rank_str.split(" in ")
        rank = int(rank_part.replace(",", ""))
        chart = chart_part.split(" (")[0]
        return rank, chart
    except ValueError:
        return None, None


def k_core_filter(df: pd.DataFrame, k: int) -> pd.DataFrame:
    """preprocess.py:130-137 (single pass, as in the reference)."""
    user_count = df.groupby("userid")["userid"].transform("count")
    item_count = df.groupby("itemid")["itemid"].transform("count")
    return df.loc[(user_count >= k) & (item_count >= k)].copy()


def build_user_history(df: pd.DataFrame, months: int = 6) -> pd.DataFrame:
    """Per-user pos/neg item sequences within a trailing time window
    (preprocess.py:189-236). df must have label/itemid/timestamp/userid."""
    delta = int(timedelta(days=30 * months - 1).total_seconds())
    df = df.sort_values("timestamp", kind="mergesort").copy()
    pos_seqs: List[List[int]] = []
    neg_seqs: List[List[int]] = []
    # group rows per user preserving time order
    out_pos = np.empty(len(df), object)
    out_neg = np.empty(len(df), object)
    order = np.arange(len(df))
    df = df.reset_index(drop=True)
    for _, g in df.groupby("userid", sort=False):
        ts = g["timestamp"].to_numpy()
        items = g["itemid"].to_numpy()
        labels = g["label"].to_numpy()
        pos_mask = labels == 1
        pos_ts, pos_items = ts[pos_mask], items[pos_mask]
        neg_ts, neg_items = ts[~pos_mask], items[~pos_mask]
        for row_i, t in zip(g.index.to_numpy(), ts):
            lo = t - delta
            out_pos[row_i] = pos_items[(pos_ts >= lo) & (pos_ts < t)].tolist()
            out_neg[row_i] = neg_items[(neg_ts >= lo) & (neg_ts < t)].tolist()
    df[f"user_pos_{months}month_seq"] = out_pos
    df[f"user_neg_{months}month_seq"] = out_neg
    return df


def preprocess_amazon(ratings: pd.DataFrame, item_meta: pd.DataFrame,
                      k_cores: int = 3, prepare2train_month: int = 12,
                      domains: Sequence[str] = (),
                      user_mean: Optional[pd.Series] = None,
                      history_months: Sequence[int] = (1, 2, 6)
                      ) -> pd.DataFrame:
    """Amazon pipeline on in-memory frames (the reference streams from huge
    CSVs, preprocess.py:480-545; IO is orthogonal to the semantics).

    ratings: columns itemid(str asin), userid, rating, timestamp
    item_meta: columns itemid(asin), price(str), salesRank(str), brand,
               category (stringified list)
    history_months: trailing windows for the user pos/neg item-sequence
        columns. The reference's declared CSV schema carries 1-, 2- and
        6-month pairs (preprocess.py:44-49) although its history code only
        fills m=6 (preprocess.py:227-234) and training consumes only the
        6-month pair (run.py:54); we emit all declared windows so the
        output schema is a drop-in superset.
    """
    df = k_core_filter(ratings, k_cores)

    meta = item_meta.copy()
    meta.replace("", None, inplace=True)
    meta["price"] = meta["price"].apply(process_price)
    meta["sales_rank"], meta["sales_chart"] = zip(*meta["salesRank"].apply(process_rank))
    meta["tags"] = meta["category"].apply(
        lambda x: ast.literal_eval(x) if isinstance(x, str) else x)
    meta["domain"] = meta["tags"].apply(
        lambda x: x[0] if isinstance(x, list) and len(x) > 0 else None)
    brand_counts = meta["brand"].value_counts()
    rare = set(brand_counts[brand_counts < 10].index)
    meta["brand"] = meta["brand"].apply(lambda b: None if b in rare else b)

    # label = rating above the user's own mean (preprocess.py:177-179).
    # A streaming caller (data/pipeline.stream_amazon_ratings) passes the
    # mean over the user's FULL post-k-core history — the in-frame
    # transform would only see the retained time-margin rows.
    if user_mean is None:
        um = df.groupby("userid")["rating"].transform("mean")
    else:
        um = df["userid"].map(user_mean)
    df["label"] = (df["rating"] > um).astype(int)

    # encode itemid jointly across ratings+meta (preprocess.py:181-187)
    df["itemid"], item_mapping = label_encode(df["itemid"])
    meta = meta[meta["itemid"].astype(str).isin(item_mapping)].copy()
    meta["itemid"] = meta["itemid"].astype(str).map(item_mapping)

    for m in history_months:
        df = build_user_history(df, months=m)
    df = df.merge(meta[["itemid", "price", "sales_rank", "sales_chart",
                        "brand", "domain"]], on="itemid", how="left")
    dt = pd.to_datetime(df["timestamp"], unit="s")
    df["weekday"] = dt.dt.dayofweek

    # trailing window (preprocess.py:514-520)
    end_date = df["timestamp"].max()
    days_n = 30 * prepare2train_month + prepare2train_month // 2
    start_date = end_date - int(timedelta(days=days_n - 1).total_seconds())
    df = df.loc[(df["timestamp"] >= start_date) & (df["timestamp"] <= end_date)].copy()

    # dense binning (preprocess.py:523-529)
    df["sales_rank"] = df["sales_rank"].fillna(df["sales_rank"].quantile()).astype(int)
    sales_rank_bins = [0] + list(np.exp2(np.arange(2, 21, 2)).astype(int)) + [np.inf]
    df["sales_rank"] = pd.cut(df["sales_rank"], bins=sales_rank_bins, labels=False)
    df["price"] = df["price"].fillna(df["price"].quantile()).astype(int)
    price_bins = [-1] + list(np.exp2(np.arange(1, 13, 1.2)).astype(int)) + [np.inf]
    df["price"] = pd.cut(df["price"], bins=price_bins, labels=False)
    df["timestamp"] = df["timestamp"].astype(int)

    # label-encode remaining one-hot fields (preprocess.py:532-537)
    for fea in ["weekday", "sales_chart", "brand"]:
        df[fea], _ = label_encode(df[fea].fillna("-1"))

    if domains:
        df = df.loc[df["domain"].isin(list(domains))]
    df = df.dropna(subset=["domain"])
    df["domain"] = df["domain"].map(AMAZON_DOMAIN2ENCODER)
    df = df.dropna(subset=["domain"])
    df["domain"] = df["domain"].astype(int)

    cols = ["userid", "itemid", "weekday", "domain", "sales_chart",
            "sales_rank", "brand", "price"]
    for m in history_months:  # reference schema order (preprocess.py:47-49)
        cols += [f"user_pos_{m}month_seq", f"user_neg_{m}month_seq"]
    return df[cols + ["label", "timestamp"]]


# --------------------------------------------------------------------------
# aliccp / cloudtheme domain filtering + sampling
# --------------------------------------------------------------------------

def sample_domains(sort_by_count: pd.Series, n_domain: int, sample_mode: str,
                   rng: Optional[np.random.Generator] = None) -> List:
    """Domain sampling modes (preprocess.py:300-331)."""
    rng = rng or np.random.default_rng(0)
    sorted_domains = list(sort_by_count.index)
    if sample_mode == "nlargest":
        return list(sort_by_count.nlargest(n_domain).index)
    if sample_mode == "random":
        k = min(n_domain, len(sorted_domains))
        return list(rng.choice(sorted_domains, size=k, replace=False))
    if sample_mode == "interval":
        step = max(1, len(sorted_domains) // n_domain)
        return sorted_domains[::step][:n_domain]
    if sample_mode == "weighted":
        counts = sort_by_count
        mid = counts.median()
        f = (counts + 0.2 * mid ** 2 / counts) ** 0.8
        weights = (f / f.sum()).to_numpy()
        return list(rng.choice(counts.index, n_domain, p=weights, replace=False))
    if sample_mode == "interval_random":
        split = int(0.05 * len(sorted_domains))
        large, small = sorted_domains[:split], sorted_domains[split:]
        selected: List = []
        large_cnt = max(5, int(n_domain * 0.15))
        for k, pool in zip([large_cnt, n_domain - large_cnt], [large, small]):
            step = max(1, len(pool) // k) if k else 1
            selected.extend(pool[::step][:k])
        return selected
    raise ValueError("Invalid sample_mode")


def filter_by_threshold(df: pd.DataFrame, thresh: int, n_domain: int,
                        sample_mode: str, dataset_name: str = "aliccp",
                        feature_names: Sequence[str] = (),
                        rng: Optional[np.random.Generator] = None):
    """Frequency filter + domain viability filter + domain sampling +
    re-encoding (preprocess.py:247-366)."""
    if thresh > 1:
        user_counts = df["userid"].value_counts()
        item_counts = df["itemid"].value_counts()
        valid_users = set(user_counts[user_counts >= thresh].index)
        valid_items = set(item_counts[item_counts >= thresh].index)
        df = df[df["userid"].isin(valid_users) & df["itemid"].isin(valid_items)]

    df = df.groupby("domain").filter(
        lambda g: (g["userid"].nunique() >= thresh * 5)
        and (g["itemid"].nunique() >= thresh * 5))
    sort_by_count = df["domain"].value_counts().sort_values(ascending=False)
    selected = sample_domains(sort_by_count, n_domain, sample_mode, rng)
    df = df[df["domain"].isin(selected)].copy()

    domain_id_mapping = {d: i for i, d in enumerate(selected)}
    df["domain"] = df["domain"].map(domain_id_mapping)
    if dataset_name == "aliccp":
        reencode = ["userid", "itemid"]
    else:
        reencode = [c for c in feature_names if c != "domain"]
    for fea in reencode:
        df[fea], _ = label_encode(df[fea])
    inverse = {i: d for d, i in domain_id_mapping.items()}
    return df, domain_id_mapping, inverse


def preprocess_aliccp(train_df: pd.DataFrame, val_df: pd.DataFrame,
                      test_df: pd.DataFrame, thresh: int = 15,
                      n_domain: int = 30, sample_mode: str = "interval_random",
                      n_bins: int = 10,
                      rng: Optional[np.random.Generator] = None) -> pd.DataFrame:
    """AliCCP: rename 101/205/206 -> userid/itemid/domain, uniform-bin the 8
    dense D* columns fit on train only, tag splits, filter + sample domains
    (preprocess.py:546-599)."""
    dense = ["D109_14", "D110_14", "D127_14", "D150_14", "D508", "D509",
             "D702", "D853"]
    frames = []
    for tag, frame in enumerate((train_df, val_df, test_df)):
        f = frame.rename(columns={"101": "userid", "205": "itemid",
                                  "206": "domain"}).copy()
        f["train_tag"] = tag
        frames.append(f)
    for col in dense:
        if col in frames[0].columns:
            tf = uniform_discretize(frames[0][col].to_numpy(), n_bins)
            for f in frames:
                f[col] = tf(f[col].to_numpy())
    df = pd.concat(frames, ignore_index=True)
    df, mapping, inverse = filter_by_threshold(df, thresh, n_domain,
                                               sample_mode, "aliccp", rng=rng)
    return df


def preprocess_cloudtheme(df: pd.DataFrame, k_cores: int = 3,
                          n_domain: int = 30,
                          sample_mode: str = "interval_random",
                          negative_sampling_ratio: int = 4,
                          rng: Optional[np.random.Generator] = None) -> pd.DataFrame:
    """Cloud-Theme: encode, k-core + domain sampling, time-ordered 80/10/10
    split, popularity-weighted negative sampling with leakage-avoiding pools
    (preprocess.py:600-669). Input columns: user_id, item_id, theme_id,
    leaf_cate_id, cate_level1_id, reach_time, clk_cnt."""
    rng = rng or np.random.default_rng(0)
    feature_names = ["userid", "itemid", "domain", "leaf_cate_id", "cate_level1_id"]
    df = df.rename(columns={"user_id": "userid", "item_id": "itemid",
                            "theme_id": "domain"}).copy()
    for fea in feature_names:
        df[fea], _ = label_encode(df[fea])
    df, _, _ = filter_by_threshold(df, k_cores, n_domain, sample_mode,
                                   "cloudtheme", feature_names, rng)
    df = df.sort_values(by="reach_time", kind="mergesort")
    i80, i90 = int(len(df) * 0.8), int(len(df) * 0.9)
    df["train_tag"] = 0
    df.iloc[i80:i90, df.columns.get_loc("train_tag")] = 1
    df.iloc[i90:, df.columns.get_loc("train_tag")] = 2
    train, val, test = df.iloc[:i80], df.iloc[i80:i90], df.iloc[i90:]

    def negatives(sample_pool: pd.DataFrame, user_pool: pd.DataFrame,
                  n_neg: int, all_pos: pd.DataFrame, tag: int) -> pd.DataFrame:
        """preprocess.py:624-644: popularity-smoothed item draw, random user
        replacement, drop accidental positives."""
        if n_neg == 0 or len(sample_pool) == 0:
            return sample_pool.iloc[:0].copy()
        w = np.log1p(sample_pool["clk_cnt"].to_numpy().astype(float))
        w = w / w.sum() if w.sum() > 0 else None
        idx = rng.choice(len(sample_pool), size=n_neg, replace=True, p=w)
        neg = sample_pool.iloc[idx].copy()
        neg["userid"] = rng.choice(user_pool["userid"].to_numpy(), size=n_neg,
                                   replace=True)
        merged = neg.merge(all_pos[["userid", "itemid"]].drop_duplicates(),
                           on=["userid", "itemid"], how="left", indicator=True)
        neg = merged[merged["_merge"] == "left_only"].drop(columns=["_merge"])
        neg["train_tag"], neg["click"], neg["clk_cnt"] = tag, 0, 0
        return neg

    r = negative_sampling_ratio
    neg_train = negatives(train, train, int(len(train) * r), df, 0)
    neg_val = negatives(df.iloc[:i90], val, int(len(val) * r), df, 1)
    neg_test = negatives(df, test, int(len(test) * r), df, 2)
    df["click"] = 1
    cols = feature_names + ["click", "train_tag", "clk_cnt"]
    return pd.concat([df[cols], neg_train[cols], neg_val[cols], neg_test[cols]],
                     ignore_index=True)
