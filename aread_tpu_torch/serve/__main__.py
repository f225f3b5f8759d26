"""Serving CLI (counterpart of ``aread_tpu/serve/__main__.py``).

Batch scoring:
    python -m aread_tpu_torch.serve --ckpt save/aliccp/aread_best \\
        --input dataset/aliccp/thresh15_....csv --output preds.csv

HTTP server:
    python -m aread_tpu_torch.serve --ckpt save/aliccp/aread_best --http 8000

Runs on the card; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir written by python -m aread_tpu_torch "
                         "(self-contained: meta.json carries spec + model "
                         "config)")
    ap.add_argument("--input", help="canonical CSV to score")
    ap.add_argument("--output", help="where to write the prob CSV")
    ap.add_argument("--http", type=int, default=None,
                    help="serve an HTTP endpoint on this port instead")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    from aread_tpu_torch.serve.predictor import load_predictor
    pred = load_predictor(args.ckpt, device=args.device)

    if args.http is not None:
        from aread_tpu_torch.serve.server import serve_forever
        serve_forever(pred, host=args.host, port=args.http)
        return

    if not args.input or not args.output:
        ap.error("--input/--output required without --http")

    import pandas as pd

    from aread_tpu_torch.data.loader import dataset_columns, tensorize

    spec = pred.model.spec
    with open(os.path.join(args.ckpt, "meta.json")) as f:
        meta_cfg = json.load(f)["config"]
    dataset_name = meta_cfg["dataset_name"]
    one_hot_cols, seq_cols, label_col = dataset_columns(dataset_name)
    df = pd.read_csv(args.input)
    if label_col not in df.columns:
        df[label_col] = 0
    # the sequences' pad id: amazon pads with the global itemid_all, the
    # other datasets' loader with the last itemid row
    pad_id = (meta_cfg.get("itemid_all") if dataset_name == "amazon"
              else spec.one_hot_dims[spec.itemid_idx] - 1)
    x, _ = tensorize(df, one_hot_cols, seq_cols, label_col, spec.seq_maxlen,
                     int(pad_id))
    prob = pred.predict(x)
    out = pd.DataFrame({"prob": prob})
    out.to_csv(args.output, index=False)
    print(f"wrote {len(out)} predictions to {args.output}")


if __name__ == "__main__":
    main()
