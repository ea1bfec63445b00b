"""IBMIL's offline confounder pipeline, the port's counterpart of
`tools/build_confounders.py`:

    python -m rrtmil_tpu_torch.build_confounders --dataset_root DIR \\
        --confounder_out OUT [--confounder_epochs 20] [--confounder_k 8] \\
        [main.py's flags]

For each fold of the classification CLI's own splits (`make_splits`, the
folds `run_cv` trains): train AB-MIL on the fold's training bags for
`--confounder_epochs`, take the pooled 512-d embedding of every training
bag, PCA-whiten and cluster them (data/confounders.py), and save the k
prototypes (in the original feature space, the reference's quirk) as
{OUT}/{fold}/train_bag_cls_agnostic_feats_proto_{k}.npy, the path
`--model ibmil --confounder_path OUT` reads.  `--model` is ignored: stage
1 is always AB-MIL, as in the reference pipeline.  Runs on `--device`
(the card by default), AB-MIL and the k-means alike.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np


def build_fold_confounders(args, fold: int, splits, out_dir: str,
                           epochs: int, k: int) -> str:
    """Stage 1 and 2 for one fold; returns the written path."""
    import torch

    from .data.confounders import build_confounders, extract_bag_features
    from .harness.classification import (_make_datasets,
                                         engine_config_from_args)
    from .models import zoo
    from .train.engine import Engine

    train_set, _, _ = _make_datasets(args, fold, splits)
    model = zoo.build_model("attmil", input_dim=args.input_dim,
                            n_classes=args.n_classes, dropout=args.dropout,
                            act=args.act, device=args.device, seed=args.seed)
    ecfg = engine_config_from_args(args)
    ecfg.num_epochs, ecfg.aux_mode, ecfg.exact = epochs, None, False
    engine = Engine(model, ecfg, device=args.device)
    engine.generator.manual_seed(args.seed + 1000 * fold)
    for epoch in range(epochs):
        engine.train_epoch(train_set, epoch)
    engine.close()
    feats = extract_bag_features(engine.model, train_set)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(args.seed)
    protos = build_confounders(feats, k, gen)
    fold_dir = os.path.join(out_dir, str(fold))
    os.makedirs(fold_dir, exist_ok=True)
    path = os.path.join(fold_dir,
                        f"train_bag_cls_agnostic_feats_proto_{k}.npy")
    np.save(path, protos)
    return path


def run(args) -> List[str]:
    """Every fold of `args.cv_fold`; returns the written paths."""
    from .harness.classification import make_splits
    from .utils.device import resolve_device
    resolve_device(args.device)
    splits = make_splits(args)
    paths = []
    for fold in range(args.cv_fold):
        path = build_fold_confounders(args, fold, splits,
                                      args.confounder_out,
                                      args.confounder_epochs,
                                      args.confounder_k)
        print(f"fold {fold}: wrote {path}")
        paths.append(path)
    return paths


def build_parser():
    from .main import build_parser as cli_parser
    parser = cli_parser()
    parser.add_argument("--confounder_out", type=str, required=True,
                        help="output directory of the per-fold prototypes")
    parser.add_argument("--confounder_epochs", type=int, default=20,
                        help="AB-MIL training epochs per fold (stage 1)")
    return parser


def main(argv=None) -> List[str]:
    from .main import postprocess_args
    return run(postprocess_args(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
