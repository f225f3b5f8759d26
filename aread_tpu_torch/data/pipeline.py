"""Where the canonical training CSV lives (counterpart of the path half of
``aread_tpu/data/pipeline.py``). Building that CSV from the raw dumps
(the amazon ratings and metadata, the aliccp skeleton and common-feature
files, the cloudtheme click log) is not ported yet: ``run_preprocessing``
returns the CSV when it exists and raises otherwise."""

from __future__ import annotations

import os
from typing import Optional


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
                      prepare2train_month: int = 12, thresh: int = 15,
                      n_domain: int = 30,
                      sample_mode: str = "interval_random") -> str:
    """The canonical CSV's path when the file exists."""
    csv_path = out_path or preprocessed_csv_path(
        dataset_name, data_path, prepare2train_month, thresh, n_domain,
        sample_mode)
    if os.path.exists(csv_path):
        return csv_path
    raise NotImplementedError(
        f"{csv_path} is missing and building it from the raw dumps "
        "(run_preprocessing's raw-dump half: preprocess_amazon / "
        "preprocess_aliccp / preprocess_cloudtheme) is not ported yet")
