"""Raw AliCCP parser (counterpart of ``aread_tpu/data/aliccp_raw.py``):
the sample skeleton joined with the common features, fields in the
\\x01 / \\x02 / \\x03 encoding, the min-frequency-10 vocab filter, ordinal
encoding, MinMax scaling of the 8 dense columns, train / val / test frames.
Pure functions over line iterables: the caller opens the files.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import pandas as pd

SPARSE_COLUMNS = ['101', '121', '122', '124', '125', '126', '127', '128',
                  '129', '205', '206', '207', '210', '216', '508', '509',
                  '702', '853', '301', '109_14', '110_14', '127_14', '150_14']
DENSE_COLUMNS = ['109_14', '110_14', '127_14', '150_14', '508', '509',
                 '702', '853']
USES_COLUMNS = list(SPARSE_COLUMNS) + ['D' + c for c in DENSE_COLUMNS]


def parse_feat_str(feat_strs: str) -> Dict[str, str]:
    """Parse one \\x01-joined field\\x02feat\\x03val blob
    (preprocess_ali_ccp.py:46-52)."""
    feat_dict: Dict[str, str] = {}
    for fstr in feat_strs.split('\x01'):
        if not fstr:
            continue
        field, feat_val = fstr.split('\x02')
        feat, val = feat_val.split('\x03')
        if field in SPARSE_COLUMNS:
            feat_dict[field] = feat
        if field in DENSE_COLUMNS:
            feat_dict['D' + field] = val
    return feat_dict


def load_common_features(lines: Iterable[str]) -> Dict[str, Dict[str, str]]:
    """common_features file: id,count,feat_str (preprocess_ali_ccp.py:40-53)."""
    out = {}
    for line in lines:
        parts = line.strip().split(',')
        out[parts[0]] = parse_feat_str(parts[2])
    return out


def join_skeleton(lines: Iterable[str], common: Dict[str, Dict[str, str]],
                  build_vocab: bool = True
                  ) -> Tuple[pd.DataFrame, Optional[Dict[str, Dict[str, int]]]]:
    """sample_skeleton file: id,click,purchase,common_id,?,feat_str.
    Skips click=0&purchase=1 rows (preprocess_ali_ccp.py:62-63); returns the
    joined frame and raw vocab counts per sparse column."""
    rows: List[List[str]] = []
    vocab: Dict[str, Dict[str, int]] = {k: {} for k in SPARSE_COLUMNS}
    for line in lines:
        parts = line.strip().split(',')
        if parts[1] == '0' and parts[2] == '1':
            continue
        feat_dict = parse_feat_str(parts[5])
        feat_dict.update(common.get(parts[3], {}))
        row = parts[1:3] + [feat_dict.get(k, '0') for k in USES_COLUMNS]
        rows.append(row)
        if build_vocab:
            for k, v in feat_dict.items():
                if k in SPARSE_COLUMNS:
                    vocab[k][v] = vocab[k].get(v, 0) + 1
    df = pd.DataFrame(rows, columns=['click', 'purchase'] + USES_COLUMNS)
    return df, (vocab if build_vocab else None)


def build_feat_map(vocab: Dict[str, Dict[str, int]], min_freq: int = 10
                   ) -> Dict[str, Dict[str, int]]:
    """Keep values with freq >= 10; ids start at 1, 0 = OOV
    (preprocess_ali_ccp.py:90-105)."""
    feat_map = {}
    for k, counts in vocab.items():
        kept = [v for v, c in counts.items() if c >= min_freq]
        feat_map[k] = dict(zip(kept, range(1, len(kept) + 1)))
    return feat_map


def encode_frame(df: pd.DataFrame, feat_map: Dict[str, Dict[str, int]]
                 ) -> pd.DataFrame:
    df = df.copy()
    for col in SPARSE_COLUMNS:
        df[col] = df[col].map(lambda v: feat_map[col].get(v, 0)).astype(np.int64)
    for col in ['D' + c for c in DENSE_COLUMNS]:
        df[col] = pd.to_numeric(df[col])
    df['click'] = df['click'].astype(np.int8)
    df['purchase'] = df['purchase'].astype(np.int8)
    return df


def minmax_scale_dense(frames: List[pd.DataFrame]) -> List[pd.DataFrame]:
    """MinMax over the CONCATENATION of all splits, like the reference
    (preprocess_ali_ccp.py:166-173 fits on all_data)."""
    dense = ['D' + c for c in DENSE_COLUMNS]
    allv = pd.concat([f[dense] for f in frames], axis=0)
    lo, hi = allv.min(axis=0), allv.max(axis=0)
    span = (hi - lo).replace(0, 1.0)
    out = []
    for f in frames:
        f = f.copy()
        f[dense] = (f[dense] - lo) / span
        out.append(f)
    return out


def preprocess_raw_aliccp(skeleton_train: Iterable[str],
                          common_train: Iterable[str],
                          skeleton_test: Iterable[str],
                          common_test: Iterable[str],
                          val_fraction: float = 0.5,
                          seed: int = 2022
                          ) -> Tuple[pd.DataFrame, pd.DataFrame, pd.DataFrame]:
    """Full pipeline -> (train, val, test) frames; val/test are a random
    split of the test file (preprocess_ali_ccp.py:154-183)."""
    common_tr = load_common_features(common_train)
    train_df, vocab = join_skeleton(skeleton_train, common_tr, build_vocab=True)
    feat_map = build_feat_map(vocab)
    train_df = encode_frame(train_df, feat_map)

    common_te = load_common_features(common_test)
    test_all, _ = join_skeleton(skeleton_test, common_te, build_vocab=False)
    test_all = encode_frame(test_all, feat_map)

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(test_all))
    n_val = int(len(test_all) * val_fraction)
    val_df = test_all.iloc[perm[:n_val]].reset_index(drop=True)
    test_df = test_all.iloc[perm[n_val:]].reset_index(drop=True)

    train_df, val_df, test_df = minmax_scale_dense([train_df, val_df, test_df])
    return train_df, val_df, test_df
