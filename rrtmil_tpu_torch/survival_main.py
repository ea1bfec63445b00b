"""Survival prediction CLI of the PyTorch/CUDA port:

    python -m rrtmil_tpu_torch.survival_main --excel_file X.csv [flags]

The flag surface of the JAX package's `survival_main.py` (reference
Survival/main.py + Survival/utils/options.py), defaults included, plus
`--device` (default 'cuda'; 'cpu' runs the kernels' plain versions).  A
5-fold CV (`harness/survival.run_survival_cv`) for RRTMIL, MeanMIL,
MaxMIL, AttMIL, CLAM_SB, CLAM_MB, DSMIL, TransMIL, IBMIL, DTFD and
MHIM-MIL (the last two through engines of their own).  `--fold_parallel`
trains the 5 folds at once (`harness/survival.run_survival_fold_parallel`:
every model but DTFD and MHIM-MIL, which raise as in the JAX package);
`--sp_shards N` trains RRTMIL with each bag's grid rows split over N ranks,
as one command: it spawns N processes (torch.multiprocessing, start method
'spawn', a free localhost port), rank r on `cuda:(r % device_count)` (or
the CPU with `--device cpu`), each running `run_survival_cv` on its slab
(NCCL with a card a rank, else gloo: parallel/mesh.py).  The parent builds
the kernel libraries before it spawns, so no two ranks race on the build
directory; if a rank fails, the others are stopped and the command exits
non-zero.  `--fold_parallel` with `--sp_shards` raises.  An RRTMIL
`--epeg_k` / `--crmsa_k` the card's kernels do not take raises before any
work on the card (`models.rrt.check_kernel_geometry`).
"""
from __future__ import annotations

import argparse
import os
import time

from .harness.survival import (check_sp_shards, check_survival_geometry,
                               run_survival_cv, run_survival_fold_parallel)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="configurations for survival prediction (PyTorch/CUDA "
                    "port)")
    parser.add_argument("--excel_file", type=str, help="path to csv file")
    parser.add_argument("--folder", type=str, default="plip",
                        help="feature folder name [plip, resnet50]")
    parser.add_argument("--dataset_root", type=str, default=None,
                        help="root for relative WSI paths in the csv")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--log_data", action="store_true", default=True)
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--resume", type=str, default="")
    parser.add_argument("--model", type=str, default="MeanMIL",
                        help="[RRTMIL, MeanMIL, MaxMIL, AttMIL, CLAM_SB, "
                             "CLAM_MB, DSMIL, TransMIL, IBMIL, DTFD, "
                             "MHIM-MIL]")
    parser.add_argument("--optimizer", type=str, default="Adam",
                        choices=["SGD", "Adam", "AdamW", "RAdam",
                                 "PlainRAdam", "Lookahead"])
    parser.add_argument("--scheduler", type=str, default="cosine",
                        choices=["None", "exp", "step", "plateau", "cosine"])
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_epoch", type=int, default=30)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument("--loss", type=str, default="nll_surv")
    parser.add_argument("--input_dim", type=int, default=None,
                        help="feature dim override (default: 512 for plip, "
                             "1024 otherwise)")
    parser.add_argument("--epeg_k", type=int, default=15)
    parser.add_argument("--crmsa_k", type=int, default=3)
    parser.add_argument("--no_log", action="store_true")
    parser.add_argument("--amp", action="store_true",
                        help="bfloat16 encoder compute + bag transfer "
                             "(params, norms, softmax, loss stay fp32)")
    # no reference analog: the device bag cache (data/device_cache.py)
    parser.add_argument("--device_cache", default="auto", type=str,
                        choices=["auto", "on", "off"])
    parser.add_argument("--device_cache_gb", default=6.0, type=float)
    parser.add_argument("--fold_parallel", action="store_true",
                        help="train all 5 folds at once, each kernel "
                             "launched once a step for every fold (every "
                             "model but DTFD and MHIM-MIL)")
    parser.add_argument("--results_dir", type=str, default=None)
    parser.add_argument("--sp_shards", type=int, default=1,
                        help="sequence-parallel ranks for long bags: each "
                             "bag's grid rows split over this many processes "
                             "(RRTMIL only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card; raises when there is none) or "
                             "'cpu' (the kernels' plain PyTorch versions)")
    return parser


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.results_dir is None:
        dataset = os.path.basename(args.excel_file).split(".")[0] \
            if args.excel_file else "dataset"
        stamp = time.strftime("%Y-%m-%d]-[%H-%M-%S")
        args.results_dir = (f"./results/{dataset}/[{args.model}]-"
                            f"[{args.epeg_k}]-[{args.crmsa_k}]-"
                            f"[{args.folder}]-[{stamp}]")
    return args


def _rank_main(rank: int, args) -> None:
    run_survival_cv(args)


def run_sharded(args) -> None:
    """`run_survival_cv` on `args.sp_shards` spawned ranks."""
    from .parallel.mesh import launch
    from .utils.device import resolve_device
    check_survival_geometry(args)
    check_sp_shards(args)
    if resolve_device(args.device).type == "cuda":
        from .ops.kernels import build
        build.build_all()
    launch(_rank_main, args.sp_shards, device=args.device, args=(args,))


def main(argv=None):
    args = parse_args(argv)
    print(args)
    if args.fold_parallel:
        meter = run_survival_fold_parallel(args)
    elif args.sp_shards > 1:
        meter = run_sharded(args)
    else:
        meter = run_survival_cv(args)
    print("finished!")
    return meter


if __name__ == "__main__":
    main()
