"""Training CLI of the port (counterpart of the JAX package's root
``main.py``), with the reference's flag names:

  python -m aread_tpu_torch --model aread --dataset_name aliccp \\
      --data_path dataset ...

Flow: load the config -> the canonical CSV, built from the raw dumps
under ``data_path`` when missing (``data/pipeline.py``) -> (AREAD: the
augmented CSV, generated under ``save_path`` when missing) -> train and
evaluate -> save ``save/{dataset}/{model}_best``, a self-contained
checkpoint that ``python -m aread_tpu_torch.serve`` serves from. A
``stages:`` line gives the seconds of each step and the parser that read
the CSVs.

Runs on the card; ``--device cpu`` asks for the CPU. Every flag of
``main.py`` but ``--platform`` is accepted, and ``--compute_dtype`` and
``--epoch_timeout_first_mult`` set the config fields of those names, which
``main.py`` has no flags for. ``--model mamdr`` trains with the Reptile
meta-trainer (``train/mamdr.py``), AREAD with ``AREADTrainer``, every
other model with the generic ``Trainer``.

A mesh run (``--mesh_data`` x ``--mesh_model`` > 1) is one process per
rank, started by ``torch.distributed.run``:

  python -m torch.distributed.run --nproc_per_node 4 -m aread_tpu_torch \
      --mesh_data 2 --mesh_model 2 [--embed_lookup a2a] ...

The process group's backend is ``gloo`` on the CPU and ``nccl`` on cards,
unless a node runs more ranks than it has cards (NCCL refuses two ranks on
one card): then ``gloo`` (``parallel/distributed.py``); the ``mesh:`` line
names it. The vocab is padded to a multiple of ``--mesh_model``, ``--bs``
must divide over ``--mesh_data``, rank 0 builds the canonical and the
augmented CSV while the others wait, rank 0 prints and writes the
checkpoint, and a single process asked for a mesh raises by name.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import json
import os
import random
import time

import numpy as np

from aread_tpu_torch.config import Config

def load_config(argv=None):
    """(Config, device) from the command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="aread")
    parser.add_argument("--dataset_name", default="aliccp")
    parser.add_argument("--base_model", default="mmoe")
    parser.add_argument("--seed", type=int, default=2000)
    parser.add_argument("--is_set_seed", type=int, default=1,
                        help="0: derive a seed from the argument set "
                             "instead of --seed")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--bs", type=int, default=1024)
    parser.add_argument("--epoch", type=int, default=10)
    parser.add_argument("--embed_dim", type=int, default=32)
    parser.add_argument("--prepare2train_month", type=int, default=12)
    parser.add_argument("--domain_filter", default=None)
    parser.add_argument("--group_strategy", default="dcn_3groups_kl")
    # AREAD / HEMP
    parser.add_argument("--update_lr", type=float, default=1e-2)
    parser.add_argument("--aug_ratio", type=float, default=0.1)
    parser.add_argument("--warm_up_interval", type=int, default=100)
    parser.add_argument("--regroup_interval", type=int, default=2000)
    parser.add_argument("--regroup_update_step", type=int, default=5)
    parser.add_argument("--regroup_eval_step", type=int, default=5)
    parser.add_argument("--candidate_mask_num", type=int, default=10)
    parser.add_argument("--random_modify_sigma", type=float, default=0.2)
    parser.add_argument("--init_active_percent", type=float, default=0.7)
    parser.add_argument("--aread_final", action="store_true",
                        help="train the leaf final gate after HEMP")
    parser.add_argument("--final_lr", type=float, default=1e-3)
    parser.add_argument("--final_epoch", type=int, default=10)
    # infra
    parser.add_argument("--data_path", default="dataset")
    parser.add_argument("--save_path", default="save")
    parser.add_argument("--is_increment", action="store_true",
                        help="warm-start from the saved best checkpoint")
    parser.add_argument("--elastic", action="store_true",
                        help="crash-safe training: save a full resumable "
                             "checkpoint (weights / optimizer state / HEMP "
                             "masks and schedule / dropout generator / "
                             "epoch) on every improvement and resume from "
                             "it if present")
    parser.add_argument("--log_dir", default="",
                        help="JSONL metric sink dir; empty = off")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or "
                             "'cpu'")
    parser.add_argument("--mesh_data", type=int, default=1)
    parser.add_argument("--mesh_model", type=int, default=1)
    parser.add_argument("--table_optimizer", default="adam",
                        choices=["adam", "lazy_adam"],
                        help="'adam' = dense-Adam semantics (exact); "
                             "'lazy_adam' = only touched rows update")
    parser.add_argument("--loss_report_table_l2", type=int, default=1,
                        help="include the (gradient-free) table L2 term in "
                             "reported losses")
    parser.add_argument("--prng_impl", default="rbg",
                        choices=["rbg", "threefry"],
                        help="the JAX package's dropout PRNG; no meaning "
                             "here (dropout draws from a torch.Generator "
                             "seeded by --seed): accepted and ignored")
    parser.add_argument("--table_moments_dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="storage dtype of the table's Adam moments")
    parser.add_argument("--table_dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="storage dtype of the embedding table "
                             "(bfloat16: stochastic-rounded writes, f32 "
                             "compute)")
    parser.add_argument("--use_dcn", type=int, default=1,
                        help="side CrossNetwork tower in multi-tower models")
    parser.add_argument("--use_atten", type=int, default=1,
                        help="side attention tower")
    parser.add_argument("--grad_clip_norm", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off)")
    parser.add_argument("--dynamic_regroup", default="off",
                        help="between-epoch domain->group regrouping of a "
                             "multi-tower model from per-(tower, domain) "
                             "valid BCE: 'off' or comma-separated modes "
                             "(served, besttower, towerfirst)")
    parser.add_argument("--hemp_fast_adapt", default="auto",
                        choices=["auto", "overlay", "full"],
                        help="HEMP fast-adapt engine: 'overlay' runs each "
                             "chain on a compact working-set copy, 'full' "
                             "sweeps the table every step, 'auto' picks")
    parser.add_argument("--adl_eval_dlm_update", action="store_true",
                        help="ADL: move the DLM cluster centres during "
                             "evaluation too, as the reference does")
    parser.add_argument("--device_data", default="auto",
                        choices=("auto", "1", "0"),
                        help="device-resident train split (auto: on when "
                             "the split fits the budget)")
    parser.add_argument("--streaming_eval", action="store_true",
                        help="histogram AUC evaluation on the device (only "
                             "[n_domain, auc_bins] histograms reach the "
                             "host)")
    parser.add_argument("--auc_bins", type=int, default=16384)
    parser.add_argument("--embed_lookup", default="gspmd",
                        choices=("gspmd", "a2a"),
                        help="the row-sharded table's lookup on a mesh: "
                             "'gspmd' shard-select, 'a2a' dedup + "
                             "all-to-all")
    parser.add_argument("--a2a_capacity", type=int, default=0,
                        help="per-owner id-bucket bound of --embed_lookup "
                             "a2a: 0 measured before the first step, > 0 "
                             "checked, < 0 always exact")
    parser.add_argument("--epoch_timeout_s", type=float, default=0.0,
                        help="watchdog deadline per train epoch (0 = off); "
                             "raises once a late epoch returns")
    parser.add_argument("--epoch_timeout_kill", action="store_true",
                        help="hard exit (code 42) when the epoch watchdog "
                             "fires")
    parser.add_argument("--epoch_timeout_first_mult", type=float,
                        default=5.0,
                        help="the first epoch's deadline is this multiple "
                             "of --epoch_timeout_s (the cold start)")
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="bfloat16: every product of a training step "
                             "and of serving takes bf16-rounded operands "
                             "and sums in f32")
    args = parser.parse_args(argv)

    if args.is_set_seed == 0:
        # hashlib and not hash(): python randomizes str hashes per process
        digest = hashlib.sha1(repr(sorted(vars(args).items())).encode())
        args.seed = int(digest.hexdigest(), 16) % 10000
        print("set args.seed:", args.seed)

    cfg_fields = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in vars(args).items() if k in cfg_fields}
    if isinstance(kwargs.get("domain_filter"), str):
        # "[0,1,2]" -> [0, 1, 2]
        kwargs["domain_filter"] = ast.literal_eval(kwargs["domain_filter"])
    cfg = Config(**kwargs)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    return cfg, args.device


def main(argv=None):
    cfg, device = load_config(argv)
    from aread_tpu_torch.device import resolve_device
    device = resolve_device(device)  # no card and no --device cpu: raise now
    mesh = backend = None
    if cfg.mesh_data * cfg.mesh_model > 1:
        from aread_tpu_torch.parallel.distributed import initialize
        from aread_tpu_torch.parallel.mesh import make_mesh
        backend = initialize(device)
        # one process (no process group) asked for a mesh raises by name
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_model, device=device)
        device = mesh.device
        assert cfg.bs % cfg.mesh_data == 0, "bs must divide the data axis"
    try:
        _run(cfg, device, mesh, backend)
    finally:
        if mesh is not None:
            from aread_tpu_torch.parallel.distributed import shutdown
            shutdown()


def canonical_csv(cfg, mesh=None) -> str:
    """The canonical CSV's path, built from the raw dumps when it is
    missing, as ``main.py`` builds it. On a mesh the local rank 0 of each
    node (``LOCAL_RANK``) builds it; the node's other ranks poll for the
    finished file, which ``run_preprocessing`` makes appear whole, and then
    take the skip path. No collective: a build may outlast the process
    group's timeout. The wait is bounded by the epoch watchdog's deadline
    (``epoch_timeout_s``; 0, the default, is no bound, as in the JAX CLI,
    where every process builds)."""
    from aread_tpu_torch.data.pipeline import (preprocessed_csv_path,
                                               run_preprocessing)
    from aread_tpu_torch.parallel.health import HealthError, watchdog
    from aread_tpu_torch.parallel.mesh import local_rank

    def build():
        return run_preprocessing(cfg.dataset_name, cfg.data_path,
                                 prepare2train_month=cfg.prepare2train_month,
                                 seed=cfg.seed)

    if mesh is None or local_rank() == 0:
        return build()
    path = preprocessed_csv_path(cfg.dataset_name, cfg.data_path,
                                 cfg.prepare2train_month)
    timeout = cfg.epoch_timeout_s
    t0 = time.monotonic()
    with watchdog(timeout, tag="preprocessing",
                  kill_process=cfg.epoch_timeout_kill):
        while not os.path.exists(path):
            if timeout and time.monotonic() - t0 > timeout:
                raise HealthError(f"preprocessing: {path} not built within "
                                  f"{timeout}s by local rank 0")
            time.sleep(0.1)
    return build()


def _run(cfg, device, mesh, backend):
    is_main = mesh is None or mesh.rank == 0

    import pandas as pd

    from aread_tpu_torch.data.augment import make_augmentation
    from aread_tpu_torch.data.loader import load_split_data, parser_of
    from aread_tpu_torch.models import build_model
    from aread_tpu_torch.parallel.health import barrier
    from aread_tpu_torch.train.checkpoint import (full_state,
                                                  load_checkpoint,
                                                  save_checkpoint)
    from aread_tpu_torch.train.hemp import AREADTrainer
    from aread_tpu_torch.train.mamdr import MamdrTrainer
    from aread_tpu_torch.train.trainer import MULTI_TOWER_MODELS, Trainer

    stages = {}
    t0 = time.perf_counter()
    path = canonical_csv(cfg, mesh)
    stages["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    is_aread = "aread" in cfg.model
    aug_path = (path.replace(".csv", f"_aug{cfg.aug_ratio}.csv")
                if is_aread else None)
    if aug_path is not None and not os.path.exists(aug_path):
        # generate the counterfactually augmented file; the dataset dir
        # may be read-only, so it goes under save_path. On a mesh rank 0
        # writes it and the others wait
        out_dir = os.path.join(cfg.save_path, cfg.dataset_name)
        os.makedirs(out_dir, exist_ok=True)
        gen_path = os.path.join(out_dir, os.path.basename(aug_path))
        if is_main and not os.path.exists(gen_path):
            df = pd.read_csv(path)
            aug_df = make_augmentation(df, cfg.dataset_name, cfg.aug_ratio,
                                       rng=np.random.default_rng(cfg.seed))
            aug_df.to_csv(gen_path, index=False)
            print(f"generated augmentation: {gen_path} "
                  f"({len(aug_df) - len(df)} augmented rows)")
        if mesh is not None:
            barrier("augmentation")
        aug_path = gen_path
    stages["augment_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    itemid_all = cfg.itemid_all if cfg.dataset_name == "amazon" else None
    data = load_split_data(path, cfg.dataset_name, cfg.seq_maxlen,
                           itemid_all=itemid_all, aug_path=aug_path,
                           domain_filter=cfg.domain_filter)
    stages["load_s"] = time.perf_counter() - t0
    stages["parser"] = parser_of(path)
    stages["aug_parser"] = None if aug_path is None else parser_of(aug_path)

    if is_main:
        print(f"model:{cfg.model}, lr:{cfg.lr}, bs:{cfg.bs}, embed_dim:"
              f"{cfg.embed_dim}, epoch:{cfg.epoch}, seed:{cfg.seed}, "
              f"dataset:{cfg.dataset_name}, n_domain:{data.n_domain}")
    if mesh is not None:
        # the table's rows must divide over the model ranks; the a2a
        # lookup of a lane-packed table exchanges flat rows of 128 / E
        # table rows, whose count must divide too
        rows_per_flat = (128 // cfg.embed_dim
                         if cfg.embed_lookup == "a2a" and cfg.sparse_table_grad
                         and 128 % cfg.embed_dim == 0 else 1)
        data = dataclasses.replace(data, spec=data.spec.pad_vocab(
            cfg.mesh_model * rows_per_flat))
        if is_main:
            print(f"mesh: data={cfg.mesh_data} model={cfg.mesh_model} "
                  f"backend={backend}")

    # is_increment: weights, BatchNorm statistics and AREAD masks from the
    # saved best checkpoint, a fresh optimizer
    warm_start = None
    ckpt_path = os.path.join(cfg.save_path, cfg.dataset_name,
                             f"{cfg.model}_best")
    if cfg.is_increment and os.path.exists(os.path.join(ckpt_path,
                                                        "meta.json")):
        warm_start = load_checkpoint(ckpt_path, n_domain=data.n_domain,
                                     map_location=device)
        print(f"warm-start from {ckpt_path} (epoch {warm_start.get('epoch')})")

    elastic_dir = (os.path.join(cfg.save_path, cfg.dataset_name,
                                f"{cfg.model}_elastic")
                   if cfg.elastic else None)
    model = build_model(cfg, data.spec, data.n_domain, device=device)
    t0 = time.perf_counter()
    if is_aread and "wo" not in cfg.model:
        result = AREADTrainer(model, cfg, data.n_domain, mesh=mesh).fit(
            data, warm_start=warm_start, ckpt_dir=elastic_dir,
            verbose=is_main)
    elif cfg.model == "mamdr":
        # as main.py: a warm start but no resumable checkpoint; fit leaves
        # the meta weights in the model, and they are what is saved
        result = MamdrTrainer(model, cfg, data.n_domain, mesh=mesh).fit(
            data, warm_start=warm_start, verbose=is_main)
    else:
        d2g = cfg.domain2group()
        if d2g is not None:
            d2g = np.array(d2g)
        elif cfg.model in MULTI_TOWER_MODELS:
            # no precomputed grouping for this dataset: modulo grouping
            # over the group count (a multi-tower model needs some
            # domain->group map to gather its tower columns)
            n_groups = min(cfg.n_tower, data.n_domain)
            d2g = np.arange(data.n_domain) % n_groups
            if is_main:
                print(f"no precomputed domain2group for {cfg.dataset_name}: "
                      f"using modulo-{n_groups} grouping")
        result = Trainer(model, cfg, data.n_domain, domain2group=d2g,
                         mesh=mesh).fit(data, warm_start=warm_start,
                                        ckpt_dir=elastic_dir, verbose=is_main)

    stages["fit_s"] = time.perf_counter() - t0

    # persist the best model, which fit leaves in the model: one final
    # save keeps the restart capability of the per-improvement saves. On a
    # mesh the table is gathered and rank 0 writes the one-device format
    state_dict, _ = full_state(model.state_dict(), None, mesh)
    if is_main:
        save_checkpoint(ckpt_path, state_dict, opt_state={},
                        epoch=len(result["history"]),
                        best_result={k: v for k, v in result["test"].items()
                                     if not isinstance(v, dict)},
                        domain_mask=result.get("domain_mask"),
                        spec=data.spec, run_config=cfg,
                        n_domain=data.n_domain)
    if mesh is not None:
        barrier("checkpoint")
    if not is_main:
        return
    print(f"checkpoint saved: {ckpt_path}")
    print("stages:", json.dumps(stages))

    print("test:", {k: v for k, v in result["test"].items()
                    if not isinstance(v, dict)})
    if "mean_auc" in result["test"]:
        print(f"test mean_auc: {result['test']['mean_auc']:.4f}")


if __name__ == "__main__":
    main()
