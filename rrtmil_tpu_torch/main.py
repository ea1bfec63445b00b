"""MIL training CLI of the PyTorch/CUDA port:

    python -m rrtmil_tpu_torch.main --dataset_root DIR [flags]

The flag surface of the JAX package's `main.py` (reference main.py:614-750),
defaults included, plus `--device` (default 'cuda'; 'cpu' runs the kernels'
plain versions).  The reference's inverted `store_false` booleans (--epeg,
--cr_msa, --qkv_bias, --epeg_bias, --early_stopping default ON; passing the
flag turns them OFF) are kept, so commands port unchanged.  `--model`
takes rrtmil, attmil, gattmil, clam_sb, clam_mb, dsmil, transmil, meanmil,
maxmil, ibmil and dtfd (`--only_rrt_enc` puts the RRT encoder into the
zoo's but TransMIL's; ibmil reads `--confounder_path` / `--confounder_k`,
the prototypes `python -m rrtmil_tpu_torch.build_confounders` writes; dtfd
reads `--numGroup`, `--total_instance`, `--distill_type` and
`--grad_clipping`).  Any other name fails as an unknown model (mhim is a
survival model alone, as in the JAX package).  `--fold_parallel` trains
the CV folds at once (harness/fold_parallel.py: every model but dtfd, which
raises as in the JAX package).  An encoder geometry the card's kernels do
not take (`--n_heads`, `--crmsa_heads`, `--epeg_k`, `--crmsa_k`) raises
before any work on the card, naming ROADMAP.md queue 3 item 1.
"""
from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="MIL Training Script (PyTorch/CUDA port)")

    # Dataset
    parser.add_argument("--datasets", default="camelyon16", type=str,
                        help="[camelyon16, tcga]")
    parser.add_argument("--dataset_root", default="/data/wsi", type=str)
    parser.add_argument("--tcga_max_patch", default=-1, type=int)
    parser.add_argument("--fix_loader_random", action="store_true")
    parser.add_argument("--fix_train_random", action="store_true")
    parser.add_argument("--val_ratio", default=0.0, type=float)
    parser.add_argument("--fold_start", default=0, type=int)
    parser.add_argument("--cv_fold", default=3, type=int)
    parser.add_argument("--persistence", action="store_true")
    parser.add_argument("--fold_parallel", action="store_true",
                        help="train all cv folds at once, each kernel "
                             "launched once a step for every fold (every "
                             "--model but dtfd)")
    parser.add_argument("--same_psize", default=0, type=int)
    parser.add_argument("--tcga_sub", default="nsclc", type=str)

    # Train
    parser.add_argument("--cls_alpha", default=1.0, type=float)
    parser.add_argument("--aux_alpha", default=1.0, type=float)
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--num_epoch", default=200, type=int)
    parser.add_argument("--early_stopping", action="store_false")
    parser.add_argument("--max_epoch", default=130, type=int)
    parser.add_argument("--input_dim", default=1024, type=int)
    parser.add_argument("--n_classes", default=2, type=int)
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--num_workers", default=2, type=int)
    # no reference analog: the device bag cache -- bags transfer to the card
    # once and later epochs rebuild batches there (data/device_cache.py)
    parser.add_argument("--device_cache", default="auto", type=str,
                        choices=["auto", "on", "off"])
    parser.add_argument("--device_cache_gb", default=6.0, type=float)
    parser.add_argument("--loss", default="ce", type=str)
    parser.add_argument("--opt", default="adam", type=str)
    parser.add_argument("--save_best_model_stage", default=0.0, type=float)
    parser.add_argument("--model", default="rrtmil", type=str)
    parser.add_argument("--seed", default=2021, type=int)
    parser.add_argument("--lr", default=2e-4, type=float)
    parser.add_argument("--lr_sche", default="cosine", type=str)
    parser.add_argument("--lr_supi", action="store_true")
    parser.add_argument("--weight_decay", default=1e-5, type=float)
    parser.add_argument("--accumulation_steps", default=1, type=int)
    parser.add_argument("--clip_grad", default=0.0, type=float)
    parser.add_argument("--always_test", action="store_true")

    # Model
    parser.add_argument("--ds_average", action="store_true")
    parser.add_argument("--confounder_path", default="", type=str,
                        help="ibmil confounder prototypes: a directory laid "
                             "out as {path}/{fold}/train_bag_cls_agnostic_"
                             "feats_proto_{k}.npy (python -m "
                             "rrtmil_tpu_torch.build_confounders) or a "
                             "single .npy (reference "
                             "main.py:197-202; NB the reference never "
                             "registers this flag, so its --model ibmil "
                             "crashes as shipped)")
    parser.add_argument("--confounder_k", default=8, type=int,
                        help="number of k-means confounder prototypes")
    parser.add_argument("--dsmil_init", default="", type=str,
                        help="dsmil warm-start checkpoint (.pth or .npz from "
                             "tools/convert_dsmil_init.py); the reference "
                             "hardcodes ./modules/init_cpk/dsmil_init.pth "
                             "(main.py:215, a typo'd path)")
    parser.add_argument("--only_rrt_enc", action="store_true")
    parser.add_argument("--act", default="relu", type=str)
    parser.add_argument("--dropout", default=0.25, type=float)
    parser.add_argument("--attn", default="rmsa", type=str)
    parser.add_argument("--pool", default="attn", type=str)
    parser.add_argument("--ffn", action="store_true")
    parser.add_argument("--n_trans_layers", default=2, type=int)
    parser.add_argument("--mlp_ratio", default=4.0, type=float)
    parser.add_argument("--qkv_bias", action="store_false")
    parser.add_argument("--all_shortcut", action="store_true")
    parser.add_argument("--region_attn", default="native", type=str)
    parser.add_argument("--min_region_num", default=0, type=int)
    parser.add_argument("--region_num", default=8, type=int)
    parser.add_argument("--trans_dim", default=64, type=int)
    parser.add_argument("--n_heads", default=8, type=int)
    parser.add_argument("--trans_drop_out", default=0.1, type=float)
    parser.add_argument("--drop_path", default=0.0, type=float)
    parser.add_argument("--pos", default="none", type=str)
    parser.add_argument("--pos_pos", default=0, type=int)
    parser.add_argument("--peg_k", default=7, type=int)
    parser.add_argument("--peg_1d", action="store_true")
    parser.add_argument("--epeg", action="store_false")
    parser.add_argument("--epeg_bias", action="store_false")
    parser.add_argument("--epeg_2d", action="store_true")
    parser.add_argument("--epeg_k", default=15, type=int)
    parser.add_argument("--epeg_type", default="attn", type=str)
    parser.add_argument("--cr_msa", action="store_false")
    parser.add_argument("--crmsa_k", default=3, type=int)
    parser.add_argument("--crmsa_heads", default=8, type=int)
    parser.add_argument("--crmsa_mlp", action="store_true")
    parser.add_argument("--da_act", default="relu", type=str)

    # DTFD standalone (reference DTFD/main.py:704-711)
    parser.add_argument("--numGroup", default=4, type=int)
    parser.add_argument("--total_instance", default=4, type=int)
    parser.add_argument("--distill_type", default="AFS", type=str,
                        help="[MaxMinS, MaxS, AFS]")
    parser.add_argument("--grad_clipping", default=5.0, type=float)

    # Shuffle augs
    parser.add_argument("--patch_shuffle", action="store_true")
    parser.add_argument("--group_shuffle", action="store_true")
    parser.add_argument("--shuffle_group", default=0, type=int)

    # Misc
    parser.add_argument("--title", default="default", type=str)
    parser.add_argument("--project", default="mil_new_c16", type=str)
    parser.add_argument("--log_iter", default=100, type=int)
    parser.add_argument("--amp", action="store_true",
                        help="bfloat16 activations/matmuls and bags "
                             "transferred in bfloat16 (the reference's "
                             "autocast, main.py:101-102; params, norms, "
                             "softmax, loss stay fp32)")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--no_log", action="store_true")
    parser.add_argument("--model_path", type=str, default="./output")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card; raises when there is none) or "
                             "'cpu' (the kernels' plain PyTorch versions)")
    return parser


def postprocess_args(args):
    """Post-parse overrides (reference main.py:713-737)."""
    os.makedirs(os.path.join(args.model_path, args.project), exist_ok=True)
    args.model_path = os.path.join(args.model_path, args.project, args.title)
    os.makedirs(args.model_path, exist_ok=True)

    if args.model in ("clam_sb", "clam_mb"):
        args.cls_alpha, args.aux_alpha = 0.7, 0.3
    elif args.model == "dsmil":
        args.cls_alpha, args.aux_alpha = 0.5, 0.5

    if args.datasets == "camelyon16":
        args.fix_loader_random = True
        args.fix_train_random = True
    if args.datasets == "tcga":
        args.always_test = True
    return args


def main(argv=None):
    args = postprocess_args(build_parser().parse_args(argv))
    print(args)
    print(time.asctime(time.localtime(time.time())))
    if args.fold_parallel:
        from .harness.fold_parallel import run_cv_fold_parallel
        return run_cv_fold_parallel(args)
    from .harness.classification import run_cv
    return run_cv(args)


if __name__ == "__main__":
    main()
