"""Classification experiment harness: the k-fold CV driver.

Counterpart of `rrtmil_tpu/harness/classification.py` (reference
main.py:23-413): seeded patient shuffle and stratified k-fold, per-fold
training with validation, early stopping on -AUC, the optional per-epoch
test (`always_test`), best-AUC weights, the rolling full-resume checkpoint
(every RNG stream included) and the cross-validation summary.  Models:
rrtmil, the zoo's attmil, gattmil, clam_sb, clam_mb, dsmil, transmil,
meanmil, maxmil and ibmil, and the standalone DTFD (no encoder, batch size
1, `DTFDClassificationEngine`: its two tiers' clipped gradients and its
permuted evaluation, classification.py:139-153), with `--only_rrt_enc`
injecting the RRT encoder
into the zoo's but TransMIL's (classification.py:68-81; CLAM's subtyping
is on unless the dataset is camelyon16), the loss weights and batch size 1
the reference forces on CLAM and DSMIL, DSMIL's `--ds_average` and
`--dsmil_init` warm start, TransMIL on the engine's exact mode
(classification.py:103) and IBMIL's per-fold confounder prototypes from
`--confounder_path` (classification.py:155-171; written by `python -m
rrtmil_tpu_torch.build_confounders`).

Random streams, as in the JAX package: every fold initialises the model
from `args.seed`; the engine's numpy `_rng` starts from `args.seed` and
its torch.Generator (the dropout masks) from `args.seed`, or
`args.seed + 1000 * fold` without `fix_train_random` (JAX's epoch key).
On resume the generator's state is restored, so the dropout masks are the
uninterrupted run's, as JAX's keys derived from (seed, epoch, global_iter)
are.  JAX restores `_rng` into a new Generator object while the train-order
stream stays bound to the one `Engine.__init__` / `reseed` made
(classification.py:214-220, engine.py:136-137): the order stream restarts
after a resume, and the port keeps that.
"""
from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import PoolConfig, PosEmbedConfig, RRTEncoderConfig, RRTMILConfig
from ..data.datasets import (C16Dataset, TCGADataset, get_kfold,
                             read_label_csv)
from ..models import zoo
from ..models.dsmil import load_warm_start
from ..models.dtfd import DTFD
from ..models.rrt import build_model, check_kernel_geometry
from ..train.checkpoint import FoldCheckpointer, load_host_state
from ..train.earlystop import EarlyStopping
from ..train.engine import Engine, EngineConfig
from ..train.metrics import five_scores
from ..utils.device import resolve_device
from ..utils.logger import Logger
from .dtfd_cls import DTFDClassificationEngine


def model_names() -> List[str]:
    """The `--model` names: the zoo's and the standalone DTFD, which the
    harness builds itself (the JAX registry holds no dtfd either)."""
    return sorted(zoo.model_names() + ["dtfd"])


def check_args(args) -> None:
    """Refuse an unknown model and what the port does not run yet, before
    any work: an encoder geometry the card's kernels do not take
    (`models.rrt.check_kernel_geometry`; --fold_parallel's own refusals:
    harness/fold_parallel.py)."""
    if args.model.lower() not in model_names():
        raise ValueError(f"--model {args.model}: unknown model; choose from "
                         f"{model_names()}")
    if args.model == "rrtmil" or (args.only_rrt_enc and args.model not in
                                  ("transmil", "dtfd")):
        check_kernel_geometry(encoder_config_from_args(args), args.device)
    resolve_device(args.device)


def encoder_config_from_args(args) -> RRTEncoderConfig:
    """The CLI surface onto the config tree (reference main.py:654-695);
    --amp -> bfloat16 activations and products, params, LayerNorm
    reductions, softmax, pooling and loss in float32."""
    return RRTEncoderConfig(
        dim=512,
        n_layers=args.n_trans_layers,
        n_heads=args.n_heads,
        crmsa_heads=args.crmsa_heads,
        region_num=args.region_num,
        min_region_num=args.min_region_num,
        attn_mode=args.attn,
        region_attn=args.region_attn,
        epeg=args.epeg,
        epeg_k=args.epeg_k,
        epeg_2d=args.epeg_2d,
        epeg_bias=args.epeg_bias,
        epeg_type=args.epeg_type,
        cr_msa=args.cr_msa,
        crmsa_k=args.crmsa_k,
        crmsa_mlp=args.crmsa_mlp,
        all_shortcut=args.all_shortcut,
        qkv_bias=args.qkv_bias,
        dropout=args.trans_drop_out,
        drop_path=args.drop_path,
        ffn=args.ffn,
        mlp_ratio=args.mlp_ratio,
        trans_dim=args.trans_dim,
        pos=PosEmbedConfig(kind=args.pos, k=args.peg_k, conv_1d=args.peg_1d,
                           pos_pos=args.pos_pos),
        compute_dtype="bfloat16" if args.amp else "float32",
    )


def model_config_from_args(args) -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=args.input_dim, n_classes=args.n_classes, act=args.act,
        dropout=args.dropout, encoder=encoder_config_from_args(args),
        pool=PoolConfig(kind=args.pool, act=args.da_act))


def build_model_from_args(args, device="cuda", confounders=None):
    """(model, the encoder config that buckets the bags)
    (classification.py:68-81,139-153): rrtmil from its config; the
    standalone DTFD (no encoder; --numGroup pseudo-bags, --distill_type,
    --total_instance // --numGroup instances a pseudo-bag); a zoo model with
    the encoder injected under --only_rrt_enc, CLAM's subtyping on unless
    the dataset is camelyon16, IBMIL's `confounders`; seeded from
    `args.seed` on every fold."""
    if args.model == "rrtmil":
        cfg = model_config_from_args(args)
        return build_model(cfg, device=device, seed=args.seed), cfg.encoder
    enc = encoder_config_from_args(args)
    if args.model == "dtfd":
        model = DTFD(input_dim=args.input_dim, n_classes=args.n_classes,
                     survival=False, group=args.numGroup,
                     distill=args.distill_type,
                     instance_per_group=max(
                         1, args.total_instance // args.numGroup))
        return zoo.seeded(model, device, args.seed), enc
    model = zoo.build_model(
        args.model, input_dim=args.input_dim, n_classes=args.n_classes,
        dropout=args.dropout, act=args.act,
        rrt_cfg=enc if args.only_rrt_enc else None,
        subtyping=args.datasets.lower() != "camelyon16",
        confounders=confounders, device=device, seed=args.seed)
    return model, enc


def confounder_file(args, fold: int) -> str:
    """IBMIL's prototypes for `fold` (classification.py:155-171, reference
    main.py:197-202): `--confounder_path` itself when it names a .npy, else
    {path}/{fold}/train_bag_cls_agnostic_feats_proto_{k}.npy."""
    path = args.confounder_path
    if path.endswith(".npy"):
        return path
    return os.path.join(path, str(fold), f"train_bag_cls_agnostic_feats_"
                                         f"proto_{args.confounder_k}.npy")


def engine_config_from_args(args) -> EngineConfig:
    """--amp -> bags cast to bfloat16 on the host before the transfer; the
    loss weights the reference forces on CLAM (0.7 / 0.3) and DSMIL (0.5 /
    0.5), and batch size 1 for those single-bag models and DTFD
    (classification.py:84-114,150)."""
    cls_alpha, aux_alpha = zoo.LOSS_WEIGHT_OVERRIDES.get(
        args.model, (args.cls_alpha, args.aux_alpha))
    # the aux models (CLAM's instance sampler, DSMIL's critical-instance
    # queries) take one bag at a time
    aux_mode = zoo.aux_mode(args.model)
    single = aux_mode or args.model == "dtfd"
    return EngineConfig(
        loss=args.loss, opt=args.opt, lr=args.lr,
        weight_decay=args.weight_decay, lr_schedule=args.lr_sche,
        lr_supi=args.lr_supi, num_epochs=args.num_epoch,
        batch_size=1 if single else args.batch_size,
        n_classes=args.n_classes, cls_alpha=cls_alpha, aux_alpha=aux_alpha,
        aux_mode=aux_mode,
        ds_average=args.model == "dsmil" and args.ds_average,
        exact=args.model == "transmil",
        accumulation_steps=args.accumulation_steps,
        clip_grad=args.clip_grad, patch_shuffle=args.patch_shuffle,
        group_shuffle=args.group_shuffle, shuffle_group=args.shuffle_group,
        seed=args.seed, fix_loader_random=args.fix_loader_random,
        log_iter=args.log_iter, num_workers=args.num_workers,
        transfer_dtype="bfloat16" if args.amp else "float32",
        device_cache=args.device_cache,
        device_cache_bytes=int(args.device_cache_gb * (1 << 30)))


def _make_datasets(args, fold: int, splits):
    train_p, train_l, test_p, test_l, val_p, val_l = splits[fold]
    psize = args.same_psize
    if args.datasets.lower() == "camelyon16":
        def mk(p, l, tr=False):
            return C16Dataset(p, l, root=args.dataset_root,
                              persistence=args.persistence,
                              keep_same_psize=psize, is_train=tr)
    else:
        def mk(p, l, tr=False):
            return TCGADataset(p, l, root=args.dataset_root,
                               max_patch=args.tcga_max_patch,
                               persistence=args.persistence,
                               subtype=args.tcga_sub, keep_same_psize=psize,
                               is_train=tr)
    train_set = mk(train_p, train_l, True)
    test_set = mk(test_p, test_l)
    val_set = mk(val_p, val_l) if args.val_ratio != 0.0 else test_set
    return train_set, val_set, test_set


def one_fold(args, fold: int, splits, metrics: Dict[str, List[float]],
             logger: Logger, resume_payload: Optional[Dict] = None):
    """Train, validate and test one fold (reference main.py:98-413)."""
    train_set, val_set, test_set = _make_datasets(args, fold, splits)
    if args.model == "ibmil" and args.confounder_path:
        path = confounder_file(args, fold)
        model, enc = build_model_from_args(args, device=args.device,
                                           confounders=np.load(path))
        logger.print(f"ibmil confounders loaded from {path}")
    else:
        model, enc = build_model_from_args(args, device=args.device)
    if args.model == "dtfd":
        engine = DTFDClassificationEngine(
            model, engine_config_from_args(args), enc,
            grad_clipping=args.grad_clipping, device=args.device)
    else:
        engine = Engine(model, engine_config_from_args(args), enc,
                        device=args.device)
    engine.logger = logger
    engine.fold = fold
    if args.model == "dsmil" and args.dsmil_init:
        # the reference's warm start, non-strict (main.py:215-218), from a
        # flag rather than its mistyped fixed path
        load_warm_start(engine.model, args.dsmil_init)
        logger.print(f"dsmil warm-start loaded from {args.dsmil_init}")

    sub_typing = args.datasets.lower() != "camelyon16"
    is_c16 = not sub_typing
    early = EarlyStopping(
        patience=30 if is_c16 else 20,
        stop_epoch=args.max_epoch if is_c16 else 70,
        save_best_model_stage=np.ceil(
            args.save_best_model_stage * args.num_epoch)) \
        if args.early_stopping else None

    ckpt = FoldCheckpointer(args.model_path)
    best = {"acc": 0, "pre": 0, "rec": 0, "fs": 0, "auc": 0, "epoch": 0,
            "te_auc": 0.0, "te_fs": 0.0}
    epoch_start = 0
    if args.fix_train_random:
        # the reference re-seeds every RNG right before the epoch loop
        # (seed_torch(args.seed), main.py:254-255); forced on for
        # camelyon16 (main.py:731)
        engine.reseed(args.seed)
    engine.generator.manual_seed(
        args.seed if args.fix_train_random else args.seed + 1000 * fold)

    if resume_payload is not None:
        host = ckpt.load_rolling(engine.model, engine.optimizer)
        epoch_start = host["epoch"]
        engine.global_iter = host["global_iter"]
        # a new Generator object, as JAX restores it: the order stream keeps
        # the one reseed / __init__ made
        engine._rng = np.random.default_rng()
        engine._rng.bit_generator.state = host["engine_rng"]
        engine.generator.set_state(host["torch_rng"])
        best = host["best"]
        if early is not None:
            early.load_state_dict(host["early_stop"])

    for epoch in range(epoch_start, args.num_epoch):
        t0 = time.time()
        train_loss = engine.train_epoch(train_set, epoch)
        train_time = time.time() - t0

        probs, labels, val_loss = engine.evaluate(val_set)
        acc, auc, pre, rec, fs = five_scores(labels, probs, sub_typing)

        stop = False
        if early is not None:
            early(epoch, -auc)
            stop = early.early_stop

        if args.always_test:
            te_probs, te_labels, te_loss = engine.evaluate(test_set)
            te_metrics = five_scores(te_labels, te_probs, sub_typing)
            if te_metrics[1] > best["te_auc"]:
                best["te_auc"], best["te_fs"] = te_metrics[1], te_metrics[4]
            logger.log({f"{fold}-fold/te_auc": te_metrics[1],
                        f"{fold}-fold/te_loss": te_loss}, step=epoch,
                       commit=False)

        logger.print(
            f"Epoch [{epoch + 1}/{args.num_epoch}] train loss: "
            f"{train_loss:.3E}, val loss: {val_loss:.3E}, acc: {acc:.3f}, "
            f"auc: {auc:.3f}, pre: {pre:.3f}, rec: {rec:.3f}, f1: {fs:.3f},"
            f" time: {train_time:.2f}s")
        logger.log({f"{fold}-fold/val_acc": acc, f"{fold}-fold/val_auc": auc,
                    f"{fold}-fold/val_loss": val_loss,
                    f"{fold}-fold/epoch": epoch}, step=epoch)

        if auc > best["auc"] and \
                epoch >= args.save_best_model_stage * args.num_epoch:
            best.update(acc=acc, pre=pre, rec=rec, fs=fs, auc=auc,
                        epoch=epoch)
            if not args.no_log:
                ckpt.save_best(fold, engine.model)

        if not args.no_log:
            ckpt.save_rolling(engine.model, engine.optimizer, {
                "epoch": epoch + 1, "fold": fold,
                "global_iter": engine.global_iter,
                "engine_rng": engine._rng.bit_generator.state,
                "torch_rng": engine.generator.get_state(),
                "best": best,
                "early_stop": early.state_dict() if early else None,
                "metrics": metrics,
                "wandb_id": logger.wandb_id,
            })

        if stop:
            break

    # final test with the fold's best weights (main.py:384-407)
    if not args.no_log and os.path.exists(ckpt.best_path(fold)):
        ckpt.load_best(fold, engine.model)
    probs, labels, _ = engine.evaluate(test_set)
    engine.close()
    acc, auc, pre, rec, fs = five_scores(labels, probs, sub_typing)
    logger.print(f"Fold {fold} test: acc {acc:.3f} auc {auc:.3f} "
                 f"pre {pre:.3f} rec {rec:.3f} f1 {fs:.3f}")
    logger.log({"test_acc": acc, "test_auc": auc, "test_fscore": fs})

    metrics["acs"].append(acc)
    metrics["pre"].append(pre)
    metrics["rec"].append(rec)
    metrics["fs"].append(fs)
    metrics["auc"].append(auc)
    if args.always_test:
        metrics["te_auc"].append(best["te_auc"])
        metrics["te_fs"].append(best["te_fs"])
    return metrics


def make_splits(args):
    """Seeded patient shuffle + stratified k-fold, as the JAX package builds
    them (reference main.py:28-42 + dataloader.py:65-93): seeds Python's
    and numpy's global streams with `args.seed`."""
    random.seed(args.seed)
    np.random.seed(args.seed)
    patients, labels = read_label_csv(os.path.join(args.dataset_root,
                                                   "label.csv"))
    index = list(range(len(patients)))
    random.shuffle(index)
    patients, labels = patients[index], labels[index]
    return get_kfold(args.cv_fold, patients, labels, args.val_ratio)


def run_cv(args) -> Dict[str, List[float]]:
    """The reference `main(args)` (main.py:23-96): every fold from
    `fold_start` (or the rolling checkpoint's fold with --auto_resume), then
    the cross-validation means."""
    check_args(args)
    splits = make_splits(args)

    fold_start = args.fold_start
    resume_payload = None
    if args.auto_resume and not args.no_log:
        ckpt = FoldCheckpointer(args.model_path)
        if ckpt.has_rolling():
            resume_payload = load_host_state(
                os.path.join(args.model_path, "ckp_host.pkl"))
            fold_start = resume_payload["fold"]

    # re-attach the same wandb run on resume (reference main.py:740-742)
    logger = Logger(use_wandb=args.wandb, project=args.project,
                    name=args.title, config=vars(args),
                    log_dir=args.model_path, quiet=args.no_log,
                    wandb_id=(resume_payload or {}).get("wandb_id") or None)

    metrics = {"acs": [], "pre": [], "rec": [], "fs": [], "auc": [],
               "te_auc": [], "te_fs": []}
    if resume_payload is not None:
        metrics = resume_payload["metrics"]

    for k in range(fold_start, args.cv_fold):
        logger.print(f"Start {args.cv_fold}-fold cross validation: fold {k}")
        metrics = one_fold(args, k, splits, metrics, logger,
                           resume_payload if k == fold_start else None)
        resume_payload = None

    for key in ("acs", "auc", "pre", "rec", "fs"):
        vals = np.array(metrics[key])
        logger.print(f"Cross validation {key} mean: {vals.mean():.3f}, "
                     f"std {vals.std():.3f}")
    logger.log({f"cross_val/{k}_mean": float(np.mean(v))
                for k, v in metrics.items() if v})
    logger.finish()
    return metrics
