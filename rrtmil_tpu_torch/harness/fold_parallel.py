"""Fold-parallel cross-validation harness: every fold trained at once.

Counterpart of `rrtmil_tpu/harness/fold_parallel.py:67-232`.  The
reference's k-fold CV is a sequential loop; `run_cv_fold_parallel` trains
the K folds together through the fold-parallel step of parallel/folds.py:
one step a bag per fold, every kernel launched once for all K folds.

Semantics, as in the JAX package:

* Each step trains one bag per fold; the folds step on one bucket, so every
  bag is zero-extended on the device to the largest bucket of the step's K
  bags (docs/PARITY.md:86-92).  With equal-length bags (or --same_psize)
  the buckets coincide and the folds reproduce the sequential harness.
* Ragged epoch tails (folds with more train bags than the shortest) run
  through each fold's own engine, so every fold sees its own bags once an
  epoch, in its own order.
* Early stopping is per fold; a stopped fold keeps stepping with the others,
  but its best weights and scores stay those of its stop.
* The step's loss is loss(logits) alone (folds.py:53-55), whatever
  --cls_alpha says: no label reaches the model, so CLAM's instance branch
  and DSMIL's max-instance stream do not enter a fold step.  The ragged
  tails' own engine steps keep the aux losses, CLAM's and DSMIL's batch 1
  and TransMIL's exact mode; inside a fold step TransMIL sees its bag
  zero-extended to the step's bucket, as in JAX.  One device bag cache
  serves every fold's engine.
* IBMIL is built without confounders (the JAX harness passes none).
* Refused (ValueError), before any work: --accumulation_steps > 1,
  --lr_supi, --auto_resume, and --model dtfd, which the JAX package's
  fold-parallel path refuses as an unknown zoo name (DTFD trains on an
  engine of its own, harness/dtfd_cls.py).

Each fold keeps its engine, optimizer, generator (its dropout masks, seeded
as the sequential harness seeds it), early stopper and checkpoints; the
fold models' parameters are views of the stacked tensors the step trains.
Under --no_log each fold is tested with its final weights, else with its
best (its initial weights if no epoch ever improved on 0), as in JAX.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.folds import make_fold_parallel_step, stack_states
from ..train.checkpoint import FoldCheckpointer
from ..train.earlystop import EarlyStopping
from ..train.engine import Engine
from ..train.metrics import five_scores
from ..utils.logger import Logger
from .classification import (_make_datasets, build_model_from_args,
                             check_args, engine_config_from_args, make_splits)

def check_fold_parallel(args) -> None:
    """Refuse what --fold_parallel does not run, before any work (every
    zoo model runs; check_args refuses a name it does not know)."""
    if args.model == "dtfd":
        raise ValueError("--fold_parallel --model dtfd: unknown model 'dtfd' "
                         "for the fold-parallel step, as in the JAX package "
                         "(its zoo has no dtfd; DTFD trains on an engine of "
                         "its own)")
    if args.accumulation_steps > 1:
        raise ValueError("--fold_parallel does not support "
                         "--accumulation_steps > 1")
    if args.lr_supi:
        raise ValueError("--fold_parallel requires epoch-level schedules, "
                         "not --lr_supi")
    if getattr(args, "auto_resume", False):
        raise ValueError("--fold_parallel does not support --auto_resume")


def pad_stack(parts, n: int):
    """Each fold's device bag (x (1, N_k, C), mask (1, N_k)) zero-extended
    to n rows, stacked: (K, 1, n, C), (K, 1, n)."""
    xs = [F.pad(p[0], (0, 0, 0, n - p[0].shape[1])) for p in parts]
    ms = [F.pad(p[1], (0, n - p[1].shape[1])) for p in parts]
    return torch.stack(xs), torch.stack(ms)


def _state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_cv_fold_parallel(args) -> Dict[str, List[float]]:
    """The K folds of `args` trained at once; returns the CV metrics."""
    check_fold_parallel(args)
    check_args(args)
    splits = make_splits(args)
    k_folds = args.cv_fold
    logger = Logger(use_wandb=args.wandb, project=args.project,
                    name=args.title, config=vars(args),
                    log_dir=args.model_path, quiet=args.no_log)
    logger.print(f"fold-parallel CV: {k_folds} folds trained at once")
    fold_sets = [_make_datasets(args, k, splits) for k in range(k_folds)]
    engines = []
    for k in range(k_folds):
        model, enc = build_model_from_args(args, device=args.device)
        engine = Engine(model, engine_config_from_args(args), enc,
                        device=args.device)
        engine.logger, engine.fold = logger, k
        if args.fix_train_random:
            engine.reseed(args.seed)
        engine.generator.manual_seed(
            args.seed if args.fix_train_random else args.seed + 1000 * k)
        engines.append(engine)
    # one device bag cache: K budgets would ask K times the memory, and the
    # path-keyed entries share each slide across the folds' splits
    shared = engines[0]._device_cache()
    for e in engines[1:]:
        e._dcache = shared
    models = [e.model for e in engines]
    stacked = stack_states(models)
    generators = [e.generator for e in engines]
    steps = {}     # the step of each bucket length, as the JAX harness's

    def step_of(length: int):
        if length not in steps:
            steps[length] = make_fold_parallel_step(
                models, stacked, engines[0]._loss, length)
        return steps[length]

    sub_typing = args.datasets.lower() != "camelyon16"
    is_c16 = not sub_typing
    earlys = [EarlyStopping(
        patience=30 if is_c16 else 20,
        stop_epoch=args.max_epoch if is_c16 else 70,
        save_best_model_stage=np.ceil(
            args.save_best_model_stage * args.num_epoch))
        if args.early_stopping else None for _ in range(k_folds)]
    ckpt = FoldCheckpointer(args.model_path)
    best = [{"acc": 0, "pre": 0, "rec": 0, "fs": 0, "auc": 0, "epoch": 0}
            for _ in range(k_folds)]
    best_state = [_state(m) for m in models]
    stopped = [False] * k_folds

    for epoch in range(args.num_epoch):
        t0 = time.time()
        orders = [list(e._order_rng.permutation(len(fold_sets[k][0])))
                  for k, e in enumerate(engines)]
        t_par = min(len(o) for o in orders)
        lr = engines[0].current_lr(epoch, t_par)
        for e in engines:
            e.model.train()
            e.optimizer.zero_grad(set_to_none=True)
        losses = []
        for t in range(t_par):
            # each fold's bag through its own engine (its augmentation
            # stream, the shared cache), padded to its own bucket, then
            # zero-extended on the device to the step's largest
            parts = [e._make_batch(fold_sets[k][0], [orders[k][t]], True)
                     for k, e in enumerate(engines)]
            spec = max((p[3] for p in parts), key=lambda s: s.data_length)
            x, mask = pad_stack(parts, spec.data_length)
            labels = torch.stack([p[2] for p in parts])
            losses.append(step_of(spec.repr_length)(x, mask, labels,
                                                    generators))
            for e in engines:
                e._apply_grads(lr)
                e.global_iter += 1
        # ragged tails: each fold's own engine, one bag a step, with its
        # aux losses (CLAM's instance branch reads the bag's host label)
        for k, e in enumerate(engines):
            for t in range(t_par, len(orders[k])):
                bag = [orders[k][t]]
                x, mask, labels, spec = e._make_batch(fold_sets[k][0], bag,
                                                      True)
                e._train_step(x, mask, labels, spec.repr_length,
                              label=e._host_label(fold_sets[k][0], bag))
                e._apply_grads(lr)
                e.global_iter += 1
        train_time = time.time() - t0
        train_loss = (torch.stack(losses).mean(0).cpu().numpy() if losses
                      else np.zeros(k_folds))

        msgs, row = [], {}
        for k, e in enumerate(engines):
            if stopped[k]:
                continue
            probs, labels_v, val_loss = e.evaluate(fold_sets[k][1])
            acc, auc, pre, rec, fs = five_scores(labels_v, probs, sub_typing)
            if (auc > best[k]["auc"]
                    and epoch >= args.save_best_model_stage * args.num_epoch):
                best[k].update(acc=acc, pre=pre, rec=rec, fs=fs, auc=auc,
                               epoch=epoch)
                best_state[k] = _state(e.model)
                if not args.no_log:
                    ckpt.save_best(k, e.model)
            if earlys[k] is not None:
                earlys[k](epoch, -auc)
                stopped[k] = earlys[k].early_stop
            msgs.append(f"f{k} loss {train_loss[k]:.3E} val {val_loss:.3E} "
                        f"auc {auc:.3f}")
            row.update({f"{k}-fold/val_auc": auc, f"{k}-fold/val_loss":
                        val_loss, f"{k}-fold/epoch": epoch})
        logger.print(f"Epoch [{epoch + 1}/{args.num_epoch}] "
                     + ", ".join(msgs) + f", time: {train_time:.2f}s")
        logger.log(row, step=epoch)
        if all(stopped):
            break

    metrics = {"acs": [], "pre": [], "rec": [], "fs": [], "auc": [],
               "te_auc": [], "te_fs": []}
    for k, e in enumerate(engines):
        if not args.no_log:
            e.model.load_state_dict(best_state[k])
        probs, labels_t, _ = e.evaluate(fold_sets[k][2])
        acc, auc, pre, rec, fs = five_scores(labels_t, probs, sub_typing)
        logger.print(f"Fold {k} test: acc {acc:.3f} auc {auc:.3f} "
                     f"pre {pre:.3f} rec {rec:.3f} f1 {fs:.3f}")
        for key, v in zip(("acs", "auc", "pre", "rec", "fs"),
                          (acc, auc, pre, rec, fs)):
            metrics[key].append(v)
    engines[0].close()
    for key in ("acs", "auc", "pre", "rec", "fs"):
        vals = np.array(metrics[key])
        logger.print(f"Cross validation {key} mean: {vals.mean():.3f}, "
                     f"std {vals.std():.3f}")
    logger.log({f"cross_val/{k}_mean": float(np.mean(v))
                for k, v in metrics.items() if v})
    logger.finish()
    return metrics
