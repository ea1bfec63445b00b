"""Survival experiment harness: 5-fold CV over discrete-hazard models.

Counterpart of `rrtmil_tpu/harness/survival.py:40-117,293-402` (reference
Survival/main.py:16-166): the reference's seeded splits, the survival model
factory, one `SurvivalEngine.learning` a fold with best-c-index weights
saved as `fold_{k}/model_best_{score:.4f}_{epoch}.pt`, `--resume` (a file,
or a directory of `fold_{k}/` whose last file in sorted order is taken),
`--evaluate` (validation only) and the CV_Meter CSV.

Every fold builds its model from `args.seed` (the JAX package initialises
each fold from PRNGKey(seed)); the engine's numpy order stream and its
torch.Generator (the dropout masks) start from the same seed.  Ported
models, each wrapped in `SurvivalHead`: RRTMIL, MeanMIL, MaxMIL, AttMIL,
CLAM_SB, CLAM_MB, DSMIL, TransMIL and IBMIL (the zoo's without an encoder,
at dropout 0.25, as the JAX package builds them; CLAM without subtyping or
instance loss, DSMIL's bag logits, TransMIL's cls token at std 1e-6,
IBMIL without confounders).  TransMIL sees the bucket's `repr_length`
rows, zero rows included, not the bag's true length: the JAX survival
engine passes it so (surv_engine.py:181,206), and the port keeps it.
"""
from __future__ import annotations

import csv
import os
from typing import List

import numpy as np

from ..config import PoolConfig, RRTEncoderConfig, RRTMILConfig
from ..data.survival import SurvivalDataset
from ..models import zoo
from ..models.survival import SurvivalHead
from ..train.checkpoint import load_params, save_params
from ..train.surv_engine import SurvivalEngine, SurvivalEngineConfig
from ..utils.device import resolve_device
from ..utils.logger import Logger

PARALLEL_ITEM = "ROADMAP.md queue 1 item 9"


class CVMeter:
    """CSV results writer (reference Survival/utils/util.py:53-72)."""

    def __init__(self, fold: int = 5):
        self.fold = fold
        self.epochs: List = ["epoch"]
        self.cindex: List = ["cindex"]

    def update(self, score: float, epoch: int):
        self.epochs.append(epoch)
        self.cindex.append(round(score, 4))

    def save(self, path: str):
        vals = self.cindex[1:self.fold + 1]
        self.cindex.append(round(float(np.mean(vals)), 4))
        self.cindex.append(round(float(np.std(vals)), 4))
        header = ["folds"] + [f"fold {i}" for i in range(self.fold)] + \
            ["mean", "std"]
        with open(path, "w", newline="") as fp:
            writer = csv.writer(fp)
            writer.writerow(header)
            writer.writerow(self.epochs)
            writer.writerow(self.cindex)


def _name(name: str) -> str:
    return name.lower().replace("-mil", "").replace("_mil", "")


def survival_rrtmil_config(n_features: int, n_classes: int = 4,
                           epeg_k: int = 15, crmsa_k: int = 3,
                           amp: bool = False) -> RRTMILConfig:
    """The survival RRTMIL config (reference Survival/main.py:109-130):
    R-MSA at region_num 16 (CR-MSA keeps 8); `amp` switches the encoder to
    bfloat16 compute."""
    return RRTMILConfig(
        input_dim=n_features, n_classes=n_classes,
        encoder=RRTEncoderConfig(region_num=16, epeg_k=epeg_k,
                                 crmsa_k=crmsa_k,
                                 compute_dtype="bfloat16" if amp
                                 else "float32"),
        pool=PoolConfig())


def build_survival_model(name: str, n_features: int, n_classes: int = 4,
                         epeg_k: int = 15, crmsa_k: int = 3,
                         amp: bool = False, device="cuda", seed: int = 0):
    """(SurvivalHead(backbone), the encoder config that buckets the bags)
    (reference Survival/main.py:70-153)."""
    name_l = _name(name)
    enc16 = RRTEncoderConfig(region_num=16, epeg_k=epeg_k, crmsa_k=crmsa_k,
                             compute_dtype="bfloat16" if amp else "float32")
    if name_l == "rrtmil":
        cfg = survival_rrtmil_config(n_features, n_classes, epeg_k, crmsa_k,
                                     amp=amp)
        backbone = zoo.build_model("rrtmil", rrtmil_cfg=cfg, device=device,
                                   seed=seed)
    else:
        # the zoo raises for the models it does not have, naming the
        # ROADMAP item that holds each; the survival TransMIL re-inits its
        # cls token to std 1e-6 (Survival/models/TransMIL/network.py:75-76)
        backbone = zoo.build_model(
            name_l, input_dim=n_features, n_classes=n_classes,
            cls_token_std=1e-6 if name_l == "transmil" else 1.0,
            device=device, seed=seed)
    return SurvivalHead(backbone), enc16


def make_survival_engine(name: str, model, cfg: SurvivalEngineConfig,
                         encoder_cfg=None, sp_shards: int = 1,
                         device="cuda") -> SurvivalEngine:
    if sp_shards > 1:
        raise ValueError(f"--sp_shards {sp_shards}: the sequence-sharded "
                         f"survival engine is not ported yet "
                         f"({PARALLEL_ITEM})")
    if _name(name) in ("dtfd", "mhim"):
        raise ValueError(f"the {name} survival engine: "
                         f"{zoo.not_ported(_name(name))}")
    return SurvivalEngine(model, cfg, encoder_cfg, device=device)


def resume_path(resume: str, fold: int) -> str:
    """The checkpoint `--resume` names for `fold`: the file itself, or the
    last `.pt` in sorted order under `{resume}/fold_{fold}/` ('' if none)."""
    if not os.path.isdir(resume):
        return resume
    fold_dir = os.path.join(resume, f"fold_{fold}")
    cand = sorted(c for c in (os.listdir(fold_dir)
                              if os.path.isdir(fold_dir) else [])
                  if c.endswith(".pt"))
    return os.path.join(fold_dir, cand[-1]) if cand else ""


def engine_config_from_args(args) -> SurvivalEngineConfig:
    """--amp -> bags cast to bfloat16 on the host before the transfer."""
    amp = getattr(args, "amp", False)
    return SurvivalEngineConfig(
        loss=args.loss, opt=args.optimizer.lower(), lr=args.lr,
        weight_decay=args.weight_decay, lr_schedule=args.scheduler,
        num_epochs=args.num_epoch, seed=args.seed,
        transfer_dtype="bfloat16" if amp else "float32",
        device_cache=getattr(args, "device_cache", "auto"),
        device_cache_bytes=int(getattr(args, "device_cache_gb", 6.0)
                               * (1 << 30)))


def run_survival_cv(args) -> CVMeter:
    """5-fold survival CV (reference Survival/main.py:16-166) on
    `args.device` (the card unless 'cpu')."""
    device = getattr(args, "device", "cuda")
    resolve_device(device)
    sp_shards = int(getattr(args, "sp_shards", 1) or 1)
    n_features = getattr(args, "input_dim", None) or \
        (512 if args.folder == "plip" else 1024)
    dataset = SurvivalDataset(args.excel_file, folder=args.folder,
                              root=getattr(args, "dataset_root", None))
    meter = CVMeter(fold=5)
    results_dir = args.results_dir
    os.makedirs(results_dir, exist_ok=True)
    logger = Logger(quiet=getattr(args, "no_log", False))
    resume = getattr(args, "resume", "") or ""

    for fold in range(5):
        train_idx, val_idx = dataset.get_split(fold)
        model, enc = build_survival_model(
            args.model, n_features, n_classes=4, epeg_k=args.epeg_k,
            crmsa_k=args.crmsa_k, amp=getattr(args, "amp", False),
            device=device, seed=args.seed)
        engine = make_survival_engine(args.model, model,
                                      engine_config_from_args(args), enc,
                                      sp_shards=sp_shards, device=device)

        # --resume: the best-checkpoint weights (reference Survival/models/
        # RRTMIL/engine.py:27-35)
        if resume:
            path = resume_path(resume, fold)
            if path and os.path.isfile(path):
                logger.print(f"=> loading checkpoint '{path}'")
                engine.load_state_dict(load_params(path))
            else:
                logger.print(f"=> no checkpoint found at '{resume}'")

        # --evaluate: validation only (engine.py:37-39)
        if getattr(args, "evaluate", False):
            val_loss, val_ci = engine.validate(dataset, val_idx)
            logger.print(f"fold {fold} evaluate: loss {val_loss:.4f} "
                         f"c-index {val_ci:.4f}")
            engine.close()
            meter.update(val_ci, 0)
            continue

        fold_dir = os.path.join(results_dir, f"fold_{fold}")
        os.makedirs(fold_dir, exist_ok=True)

        def save_best(epoch, score, state, fold_dir=fold_dir):
            save_params(os.path.join(
                fold_dir, f"model_best_{score:.4f}_{epoch}.pt"), state)

        score, epoch, _ = engine.learning(dataset, train_idx, val_idx,
                                          logger=logger,
                                          checkpoint_fn=save_best)
        logger.print(f"fold {fold}: best c-index {score:.4f} @ epoch {epoch}")
        engine.close()     # free the fold's device bag cache
        meter.update(score, epoch)

    meter.save(os.path.join(results_dir, f"results_{args.model}.csv"))
    return meter
