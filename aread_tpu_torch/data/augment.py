"""Popularity-based counterfactual augmentation (counterpart of
``aread_tpu/data/augment.py``).

  1. item popularity = (pos + 1) / (total + 2);
  2. cold items: amazon by exposure <= 4, aliccp popularity < 0.05,
     cloudtheme popularity < 0.2;
  3. candidate pool = positive-label rows of cold items inside LARGE
     domains;
  4. sample aug_ratio * N rows weighted by 1 / popularity;
  5. reassign each sampled row's domain to a SMALL domain drawn with
     exp-shaped deficit weights;
  6. concat, flagged ``is_augmented``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd


def make_augmentation(data: pd.DataFrame, dataset_name: str, aug_ratio: float,
                      label_name: Optional[str] = None,
                      rng: Optional[np.random.Generator] = None) -> pd.DataFrame:
    rng = rng or np.random.default_rng(0)
    if label_name is None:
        label_name = "label" if dataset_name == "amazon" else "click"
    aug_len = int(data.shape[0] * aug_ratio)

    if dataset_name == "cloudtheme":
        pop = data.groupby("itemid").agg(total_count=("clk_cnt", "count"),
                                         positive_count=("clk_cnt", "sum"))
    else:
        pop = data.groupby("itemid").agg(total_count=(label_name, "count"),
                                         positive_count=(label_name, "sum"))
    pop["popularity"] = (pop["positive_count"] + 1) / (pop["total_count"] + 2)

    domain_counts = data["domain"].value_counts()
    data = data.copy()
    data["is_augmented"] = False

    if dataset_name == "amazon":
        cold_items = pop[pop["total_count"] <= 4].index.to_numpy()
        small_thr = int(data.shape[0] * 0.02)
        large_domains = domain_counts[domain_counts > 1.5 * small_thr].index
        small_domains = domain_counts[domain_counts <= small_thr].index
    elif dataset_name == "aliccp":
        cold_items = pop[pop["popularity"] < 0.05].index.to_numpy()
        small_thr = int(data.shape[0] * 0.015)
        large_domains = domain_counts[domain_counts > small_thr].index
        small_domains = domain_counts[domain_counts <= small_thr].index
    elif dataset_name == "cloudtheme":
        cold_items = pop[pop["popularity"] < 0.2].index.to_numpy()
        small_thr = int(data.shape[0] * 0.015)
        large_domains = domain_counts[domain_counts > 1.5 * small_thr].index
        small_domains = domain_counts[domain_counts <= small_thr].index
    else:
        raise ValueError(dataset_name)

    pool = data[data["itemid"].isin(cold_items)
                & data["domain"].isin(large_domains)
                & (data[label_name] == 1)]
    if len(pool) == 0 or len(small_domains) == 0 or aug_len == 0:
        return data

    inv_pop = 1.0 / pop.loc[pool["itemid"], "popularity"].to_numpy()
    item_w = inv_pop / inv_pop.sum()
    take = rng.choice(len(pool), size=aug_len, replace=True, p=item_w)
    augmented = pool.iloc[take].copy()

    # domain deficit weights
    each = (domain_counts.loc[small_domains].sum() + aug_len) / len(small_domains)
    weights = each - domain_counts.loc[small_domains]
    weights.loc[weights < 100] = 100
    weights = np.exp(weights / weights.quantile(0.3))
    dw = (weights / weights.sum()).to_numpy()
    augmented["domain"] = rng.choice(np.asarray(list(small_domains)),
                                     size=aug_len, p=dw)
    augmented["is_augmented"] = True
    return pd.concat([data, augmented], ignore_index=True)
