"""Survival experiment harness: 5-fold CV over discrete-hazard models.

Counterpart of `rrtmil_tpu/harness/survival.py:40-117,293-402` (reference
Survival/main.py:16-166): the reference's seeded splits, the survival model
factory, one `SurvivalEngine.learning` a fold with best-c-index weights
saved as `fold_{k}/model_best_{score:.4f}_{epoch}.pt`, `--resume` (a file,
or a directory of `fold_{k}/` whose last `.pt` in sorted order is taken,
else its last `.msgpack`: a JAX results directory's weights),
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

DTFD and MHIM-MIL train through engines of their own (survival.py:
119-290) and are built bare, without an encoder: DTFD (group 8, MaxMinS)
returns (hazards, S) itself and trains on the surrogate loss0 + loss1
(`DTFDSurvivalEngine`); MHIM (the 'attn' baseline) keeps an EMA teacher
(`MHIMSurvivalEngine`).  Both see the bucket's `repr_length` rows too:
DTFD cuts its pseudo-bags over it, MHIM counts its keep-mask over it.
`--resume` loads MHIM's student alone, its teacher staying the initial
copy, and only the student is saved, as in the JAX package.

`--sp_shards N` (survival.py:295-311,331-355) trains RRTMIL alone, at
`survival_rrtmil_config`, on `SeqShardSurvivalEngine`: `run_survival_cv`
then runs on each of N ranks of a process group (survival_main.py spawns
them), every bag's grid rows split over the ranks.  Rank 0 alone writes the
results CSV, the checkpoints and the log; every rank takes the best-epoch
decisions from the validation numbers, which are rank 0's on every rank.

`run_survival_fold_parallel` (`--fold_parallel`, survival.py:404-559)
trains the 5 folds at once through parallel/folds.py's step: one bag a
fold a step, zero-extended on the device to the step's largest bucket;
ragged epoch tails through each fold's engine; each fold's lr from its own
schedule (the plateau on its own validation loss) and its own best-c-index
saves.  It takes every `SurvivalHead` model (`SURV_FOLD_MODELS`); DTFD,
MHIM-MIL and `--sp_shards > 1` are refused before any work, as in the JAX
package.
"""
from __future__ import annotations

import copy
import csv
import os
import time
from typing import List, Sequence

import numpy as np
import torch

from ..config import PoolConfig, RRTEncoderConfig, RRTMILConfig
from ..data.survival import SurvivalDataset
from ..models import mhim, zoo
from ..models.dtfd import DTFD
from ..models.rrt import check_kernel_geometry
from ..models.survival import SurvivalHead, risk_score
from ..train.checkpoint import load_params, save_params
from ..train.metrics import concordance_index_censored
from ..train.optim import fill_unreached_grads
from ..train.surv_engine import (SeqShardSurvivalEngine, SurvivalEngine,
                                 SurvivalEngineConfig)
from ..utils.device import resolve_device
from ..utils.logger import Logger
from .dtfd_cls import EVAL_PERM_SEED, eval_permutation

PARALLEL_ITEM = "ROADMAP.md queue 1 item 9(d)"
# the survival models fold-parallel training takes: every SurvivalHead
# model (RRTMIL on the kernels, the others no kernel at all)
SURV_FOLD_MODELS = ("rrtmil", "meanmil", "maxmil", "attmil", "clam_sb",
                    "clam_mb", "dsmil", "transmil", "ibmil")


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


def model_key(name: str) -> str:
    """The lower-case name without its -MIL / _MIL suffix (DTFD, dtfd and
    MHIM-MIL give dtfd and mhim)."""
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
    (reference Survival/main.py:70-153); DTFD and MHIM bare."""
    name_l = model_key(name)
    enc16 = RRTEncoderConfig(region_num=16, epeg_k=epeg_k, crmsa_k=crmsa_k,
                             compute_dtype="bfloat16" if amp else "float32")
    if name_l == "dtfd":
        return zoo.seeded(DTFD(input_dim=n_features, n_classes=n_classes),
                          device, seed), enc16
    if name_l == "mhim":
        return zoo.seeded(mhim.MHIM(input_dim=n_features,
                                    n_classes=n_classes),
                          device, seed), enc16
    if name_l == "rrtmil":
        cfg = survival_rrtmil_config(n_features, n_classes, epeg_k, crmsa_k,
                                     amp=amp)
        backbone = zoo.build_model("rrtmil", rrtmil_cfg=cfg, device=device,
                                   seed=seed)
    else:
        # the zoo raises for a name it does not have; the survival TransMIL
        # re-inits its cls token to std 1e-6 (Survival/models/TransMIL/
        # network.py:75-76)
        backbone = zoo.build_model(
            name_l, input_dim=n_features, n_classes=n_classes,
            cls_token_std=1e-6 if name_l == "transmil" else 1.0,
            device=device, seed=seed)
    return SurvivalHead(backbone), enc16


class DTFDSurvivalEngine(SurvivalEngine):
    """DTFD's protocol (survival.py:119-194): each step optimizes the
    surrogate loss0 + loss1, loss0 the survival loss of the G pseudo-bags'
    hazards against the label and censorship repeated G times, loss1 the
    bag's; the risk is -sum(S).  `validate` permutes each bag's true
    instances (the dataset's bag length) before chunking, the pad rows at
    the tail, from `np.random.default_rng(seed + 0xD7FD)` made anew in each
    call (the reference's shuffle, DTFD/network.py:231-233)."""

    def _train_step(self, x, mask, label, censorship, length: int):
        p_hazards, p_survival, hazards, survival = self.model(
            x, mask=mask, length=length, generator=self.generator,
            train=True)
        g = p_hazards.shape[0]
        loss = self._loss(p_hazards, p_survival, label.expand(g),
                          censorship.expand(g)) + \
            self._loss(hazards, survival, label, censorship)
        loss.backward()
        fill_unreached_grads(self.model)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach(), risk_score(survival).detach()

    @torch.no_grad()
    def _eval_step_perm(self, x, mask, label, censorship, perm, length: int):
        hazards, survival = self.model(x, mask=mask, length=length,
                                       eval_perm=perm)
        return (self._loss(hazards, survival, label, censorship),
                risk_score(survival))

    def validate(self, dataset, indices: Sequence[int]):
        self.model.eval()
        indices = list(indices)
        rng = np.random.default_rng(self.cfg.seed + EVAL_PERM_SEED)
        losses, risks = [], []
        for idx, targets in zip(indices,
                                self._epoch_targets(dataset, indices)):
            x, mask, spec = self._prep_indexed(dataset, idx)[:3]
            perm = eval_permutation(
                rng, min(dataset.length(idx), spec.repr_length),
                spec.repr_length)
            loss, risk = self._eval_step_perm(x, mask, *targets, perm,
                                              spec.repr_length)
            losses.append(loss)
            risks.append(risk)
        total, risk_np = self._sync_meters(losses, risks)
        c_index = concordance_index_censored(
            1 - np.asarray(dataset.censorship)[indices],
            np.asarray(dataset.events)[indices], risk_np)
        return total / max(len(indices), 1), c_index


class MHIMSurvivalEngine(SurvivalEngine):
    """MHIM-MIL's protocol (survival.py:196-290): each step runs the teacher
    in eval mode without gradients (its bag feature and raw attention),
    builds the keep-mask over the bucket's `repr_length` rows (draws from
    the engine's generator), trains the student on the survival loss plus
    `cl_alpha` soft_target_ce(student feature, teacher feature), steps the
    optimizer and moves the teacher by EMA.  `mrh_sche` (cosine
    `mask_ratio_h` -> 0, rounded to 4 places) and `mm_sche` (cosine `mm` ->
    1) run over `num_epochs * niter_per_ep` steps, indexed by a step count
    that carries across epochs and stops at the last entry.  Validation is
    the base engine's, through sigmoid and cumprod of the logits.  The teacher starts as a copy
    of the initial student; `load_state_dict` (--resume) loads the student
    alone."""

    def __init__(self, model, cfg: SurvivalEngineConfig, encoder_cfg=None,
                 device="cuda", niter_per_ep: int = 100,
                 mask_ratio: float = 0.7, mask_ratio_l: float = 0.2,
                 mask_ratio_h: float = 0.02, cl_alpha: float = 0.5,
                 mm: float = 0.9999):
        super().__init__(model, cfg, encoder_cfg, device=device)
        self.cl_alpha = cl_alpha
        self.mask_ratio, self.mask_ratio_l = mask_ratio, mask_ratio_l
        self.mrh_sche = mhim.cosine_schedule(mask_ratio_h, 0.0,
                                             cfg.num_epochs, niter_per_ep)
        self.mm_sche = mhim.cosine_schedule(mm, 1.0, cfg.num_epochs,
                                            niter_per_ep, start_warmup=1.0)
        self.teacher = copy.deepcopy(self.model).eval().requires_grad_(False)
        self._iter = 0

    def _train_step(self, x, mask, label, censorship, length: int):
        i = min(self._iter, len(self.mrh_sche) - 1)
        mask_ratio_h = round(float(self.mrh_sche[i]), 4)
        self._iter += 1
        with torch.no_grad():
            _, tea_feat, tea_attn = self.teacher(
                x, mask=mask, length=length, return_attn=True,
                return_feat=True)
        n = x.shape[1]
        draws = mhim.keep_mask_draws(n, length, self.mask_ratio,
                                     mask_ratio_h, 0.0, self.generator,
                                     self.device)
        keep = mhim.build_keep_mask(draws, tea_attn[0], length, n,
                                    self.mask_ratio, self.mask_ratio_l,
                                    mask_ratio_h)
        logits, stu_feat = self.model(
            x, mask=mask, length=length, keep_mask=keep[None],
            generator=self.generator, return_feat=True)
        hazards = torch.sigmoid(logits.float())
        survival = torch.cumprod(1 - hazards, dim=-1)
        loss = self._loss(hazards, survival, label, censorship) + \
            self.cl_alpha * mhim.soft_target_ce(stu_feat, tea_feat)
        loss.backward()
        fill_unreached_grads(self.model)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        mhim.ema_update(self.model, self.teacher, float(self.mm_sche[i]))
        return loss.detach(), risk_score(survival).detach()

    @torch.no_grad()
    def _eval_step(self, x, mask, label, censorship, length: int):
        hazards = torch.sigmoid(self.model(x, mask=mask,
                                           length=length).float())
        survival = torch.cumprod(1 - hazards, dim=-1)
        return (self._loss(hazards, survival, label, censorship),
                risk_score(survival))


def make_survival_engine(name: str, model, cfg: SurvivalEngineConfig,
                         encoder_cfg=None, sp_shards: int = 1,
                         device="cuda", niter_per_ep: int = 100,
                         mesh=None, seed: int = 0) -> SurvivalEngine:
    """The model's engine (survival.py:293-316): DTFD's and MHIM's own, the
    SurvivalEngine otherwise; `niter_per_ep` sizes MHIM's schedules.  With
    `sp_shards > 1`, `model` is RRTMIL's RRTMILConfig
    (`survival_rrtmil_config`), `mesh` this rank's (1, sp_shards) mesh and
    `seed` the weights' seed: the SeqShardSurvivalEngine."""
    name_l = model_key(name)
    if sp_shards > 1:
        if name_l != "rrtmil":
            raise ValueError(f"--sp_shards {sp_shards} (--model {name}): the "
                             f"sequence-sharded survival engine takes RRTMIL "
                             f"alone, as in the JAX package")
        if not isinstance(model, RRTMILConfig):
            raise TypeError("the sp_shards path takes the RRTMILConfig "
                            "(survival_rrtmil_config), not a model instance")
        if mesh is None or mesh.sp != sp_shards:
            raise ValueError(f"--sp_shards {sp_shards} runs on a mesh of "
                             f"{sp_shards} sp ranks (parallel/mesh.make_mesh)")
        return SeqShardSurvivalEngine(model, cfg, mesh, seed=seed)
    if name_l == "dtfd":
        return DTFDSurvivalEngine(model, cfg, encoder_cfg, device=device)
    if name_l == "mhim":
        return MHIMSurvivalEngine(model, cfg, encoder_cfg, device=device,
                                  niter_per_ep=niter_per_ep)
    return SurvivalEngine(model, cfg, encoder_cfg, device=device)


def resume_path(resume: str, fold: int) -> str:
    """The checkpoint `--resume` names for `fold`: the file itself, or under
    `{resume}/fold_{fold}/` the last `.pt` in sorted order, else the last
    `.msgpack` (a JAX results directory, rrtmil_tpu/harness/survival.py:
    362-376); '' if none."""
    if not os.path.isdir(resume):
        return resume
    fold_dir = os.path.join(resume, f"fold_{fold}")
    names = sorted(os.listdir(fold_dir)) if os.path.isdir(fold_dir) else []
    for ext in (".pt", ".msgpack"):
        cand = [c for c in names if c.endswith(ext)]
        if cand:
            return os.path.join(fold_dir, cand[-1])
    return ""


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


def check_survival_geometry(args) -> None:
    """Refuse, before any work, an RRTMIL geometry (--epeg_k, --crmsa_k)
    the card's kernels do not take (`models.rrt.check_kernel_geometry`)."""
    if model_key(args.model) == "rrtmil":
        check_kernel_geometry(survival_rrtmil_config(
            1, epeg_k=args.epeg_k, crmsa_k=args.crmsa_k).encoder,
            getattr(args, "device", "cuda"))


def check_sp_shards(args) -> int:
    """--sp_shards N, refused before any work for a model but RRTMIL."""
    sp_shards = int(getattr(args, "sp_shards", 1) or 1)
    if sp_shards > 1 and model_key(args.model) != "rrtmil":
        raise ValueError(f"--sp_shards {sp_shards} (--model {args.model}): "
                         f"the sequence-sharded survival engine takes RRTMIL "
                         f"alone, as in the JAX package")
    return sp_shards


def run_survival_cv(args) -> CVMeter:
    """5-fold survival CV (reference Survival/main.py:16-166) on
    `args.device` (the card unless 'cpu').  With `args.sp_shards` > 1 it
    runs on each rank of a process group of that many ranks
    (parallel/mesh.launch), on the rank's device."""
    device = getattr(args, "device", "cuda")
    check_survival_geometry(args)
    sp_shards = check_sp_shards(args)
    mesh = None
    if sp_shards > 1:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(dp=1, sp=sp_shards)
        device = mesh.device
    resolve_device(device)
    lead = mesh is None or mesh.rank == 0       # writes files and logs
    n_features = getattr(args, "input_dim", None) or \
        (512 if args.folder == "plip" else 1024)
    dataset = SurvivalDataset(args.excel_file, folder=args.folder,
                              root=getattr(args, "dataset_root", None))
    meter = CVMeter(fold=5)
    results_dir = args.results_dir
    if lead:
        os.makedirs(results_dir, exist_ok=True)
    logger = Logger(quiet=getattr(args, "no_log", False) or not lead)
    resume = getattr(args, "resume", "") or ""

    for fold in range(5):
        train_idx, val_idx = dataset.get_split(fold)
        if mesh is not None:
            model = survival_rrtmil_config(
                n_features, n_classes=4, epeg_k=args.epeg_k,
                crmsa_k=args.crmsa_k, amp=getattr(args, "amp", False))
            enc = model.encoder
        else:
            model, enc = build_survival_model(
                args.model, n_features, n_classes=4, epeg_k=args.epeg_k,
                crmsa_k=args.crmsa_k, amp=getattr(args, "amp", False),
                device=device, seed=args.seed)
        engine = make_survival_engine(args.model, model,
                                      engine_config_from_args(args), enc,
                                      sp_shards=sp_shards, device=device,
                                      niter_per_ep=len(train_idx), mesh=mesh,
                                      seed=args.seed)

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
        if lead:
            os.makedirs(fold_dir, exist_ok=True)

        def save_best(epoch, score, state, fold_dir=fold_dir):
            if lead:
                save_params(os.path.join(
                    fold_dir, f"model_best_{score:.4f}_{epoch}.pt"), state)

        score, epoch, _ = engine.learning(dataset, train_idx, val_idx,
                                          logger=logger,
                                          checkpoint_fn=save_best)
        logger.print(f"fold {fold}: best c-index {score:.4f} @ epoch {epoch}")
        engine.close()     # free the fold's device bag cache
        meter.update(score, epoch)

    if lead:
        meter.save(os.path.join(results_dir, f"results_{args.model}.csv"))
    return meter


def check_survival_fold_parallel(args) -> None:
    """Refuse what --fold_parallel does not run, before any work."""
    name_l = model_key(args.model)
    if int(getattr(args, "sp_shards", 1) or 1) > 1:
        raise ValueError(f"--fold_parallel is incompatible with --sp_shards "
                         f"{args.sp_shards}, as in the JAX package "
                         f"({PARALLEL_ITEM})")
    if name_l in ("dtfd", "mhim"):
        raise ValueError(
            f"--fold_parallel (--model {args.model}): --fold_parallel "
            f"supports the SurvivalEngine zoo only, as in the JAX package; "
            f"DTFD and MHIM-MIL train on engines of their own")
    if name_l not in SURV_FOLD_MODELS:
        raise ValueError(f"--fold_parallel --model {args.model}: unknown "
                         f"model; choose from {', '.join(SURV_FOLD_MODELS)}")


def _update(engine: SurvivalEngine) -> None:
    """The engine's own optimizer update at its own lr (set per epoch),
    as its `_train_step` makes it."""
    fill_unreached_grads(engine.model)
    engine.optimizer.step()
    engine.optimizer.zero_grad(set_to_none=True)


def run_survival_fold_parallel(args, folds=None) -> CVMeter:
    """All folds at once (the JAX package's run_survival_fold_parallel) on
    `args.device`; returns the CV meter, whose CSV is written as the
    sequential harness writes it."""
    from ..parallel.folds import make_fold_parallel_surv_step, stack_states
    from .fold_parallel import pad_stack

    check_survival_fold_parallel(args)
    check_survival_geometry(args)
    device = getattr(args, "device", "cuda")
    resolve_device(device)
    folds = list(folds if folds is not None else range(5))
    k_folds = len(folds)
    n_features = getattr(args, "input_dim", None) or \
        (512 if args.folder == "plip" else 1024)
    dataset = SurvivalDataset(args.excel_file, folder=args.folder,
                              root=getattr(args, "dataset_root", None))
    logger = Logger(quiet=getattr(args, "no_log", False))
    results_dir = args.results_dir
    os.makedirs(results_dir, exist_ok=True)
    meter = CVMeter(fold=k_folds)
    cfg = engine_config_from_args(args)
    engines = []
    for _ in folds:
        model, enc = build_survival_model(
            args.model, n_features, n_classes=4, epeg_k=args.epeg_k,
            crmsa_k=args.crmsa_k, amp=getattr(args, "amp", False),
            device=device, seed=args.seed)
        engines.append(SurvivalEngine(model, cfg, enc, device=device))
    shared = engines[0]._device_cache()
    for e in engines[1:]:
        e._dcache = shared
    models = [e.model for e in engines]
    stacked = stack_states(models)
    generators = [e.generator for e in engines]
    splits = [dataset.get_split(f) for f in folds]
    best_score, best_epoch = [0.0] * k_folds, [0] * k_folds
    steps = {}     # the step of each bucket length, as the JAX harness's

    def step_of(length: int):
        if length not in steps:
            steps[length] = make_fold_parallel_surv_step(
                models, stacked, engines[0]._loss, length)
        return steps[length]

    for epoch in range(cfg.num_epochs):
        t0 = time.perf_counter()
        orders = []
        for k, e in enumerate(engines):
            order = list(splits[k][0])
            e._rng.shuffle(order)
            orders.append(order)
            for group in e.optimizer.param_groups:
                group["lr"] = e.epoch_lr(epoch)
            e.model.train()
            e.optimizer.zero_grad(set_to_none=True)
        targets = [e._epoch_targets(dataset, o)
                   for e, o in zip(engines, orders)]
        t_par = min(len(o) for o in orders)
        losses = []
        for t in range(t_par):
            parts = [e._prep_indexed(dataset, orders[k][t])
                     for k, e in enumerate(engines)]
            spec = max((p[2] for p in parts), key=lambda s: s.data_length)
            x, mask = pad_stack(parts, spec.data_length)
            label = torch.stack([tg[t][0] for tg in targets])
            cens = torch.stack([tg[t][1] for tg in targets])
            loss, _ = step_of(spec.repr_length)(x, mask, label, cens,
                                                generators)
            losses.append(loss)
            for e in engines:
                _update(e)
        for k, e in enumerate(engines):
            for t in range(t_par, len(orders[k])):
                xk, mk, spec, _, _, _ = e._prep_indexed(dataset, orders[k][t])
                e._train_step(xk, mk, *targets[k][t], spec.repr_length)
        t1 = time.perf_counter()
        tr_loss = float(torch.stack(losses).mean()) if losses else 0.0
        msgs = []
        for k, e in enumerate(engines):
            val_loss, val_ci = e.validate(dataset, splits[k][1])
            if e._plateau is not None:
                e._plateau.step(val_loss)
            if val_ci > best_score[k]:
                best_score[k], best_epoch[k] = val_ci, epoch
                fold_dir = os.path.join(results_dir, f"fold_{folds[k]}")
                os.makedirs(fold_dir, exist_ok=True)
                save_params(os.path.join(
                    fold_dir, f"model_best_{val_ci:.4f}_{epoch}.pt"),
                    e.model.state_dict())
            msgs.append(f"f{folds[k]} ci {val_ci:.4f}")
        logger.print(f"epoch {epoch}: train loss {tr_loss:.4f} "
                     f"({sum(map(len, orders)) / (t1 - t0):.2f} bags/s) | "
                     + ", ".join(msgs))

    engines[0].close()
    for k in range(k_folds):
        logger.print(f"fold {folds[k]}: best c-index {best_score[k]:.4f} "
                     f"@ epoch {best_epoch[k]}")
        meter.update(best_score[k], best_epoch[k])
    meter.save(os.path.join(results_dir, f"results_{args.model}.csv"))
    return meter
