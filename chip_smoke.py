"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (one card)
    python3 chip_smoke.py --quick    # phases 0-2 only: build + kernel checks

Phases (each passes or the script exits non-zero; nothing is caught but
phase 9's own interruption):

0. device: `nvidia-smi` name and power limit, TF32 off for matmul and cuDNN;
1. build: nvcc of every `rrtmil_tpu_torch/csrc/*.cu` (one process each, in
   parallel), with -Xptxas -v;
2. kernels: the thirteen kernels against their plain PyTorch versions on the
   card in the three stream/mm dtype pairs: K1-K9 at the c16_r50 main-path
   shapes (K2 in both residual modes; K6 and K7 also at P = 144 with EPEG
   k = 15; K1-K5, K8, K9 also at L = 60000), K10 (both residual modes) and
   K11 at the c16_r50 + FFN shape (B = 8, G = 96) and at G = 24 (P = 9), K12
   and K13 at a 45000-patch survival bag (R = 64, P = 729, pad rows: tied
   logits) and at P = 9; K5, K6 and K7 also at ragged region sizes
   P in {1, 9, 63, 64, 65, 144, 961} (EPEG k = 15), at brca_r50's CR-MSA
   shape (one 512-wide head, P = 64, R = 6), K6 and K7 at hd = 128 (P = 64),
   256 (P = 65) and 512 (P = 144), and on strided inputs as the
   model passes them (the `kernel_weights()` views, the B = 1 cross-region
   view, q / k / v as views of one packed tensor); K2's four products on
   their own at m in {1, 37, 9224, 73728} tokens (the tensor-core product
   with bf16 products); K1 / K2 at EPEG k = 21 (both residual modes) and
   k = 9; K9 at P in {1, 9, 144, 729, 961} with k in {1, 3, 5, 8} on one
   bag (rows split over blocks), with and without the shortcut, and on 8
   bags at P = 9 and 144; K3 and K4 (each region's rows split over blocks)
   at the c16_r50 shape for B in {1, 8} and on one bag at P in {1, 9, 729,
   961} with k in {1, 3, 5, 8} (a row of regions pad rows but a token:
   tied logits), K12 at R = 64, P = 729 with k in {1, 5, 8} and at P = 9
   with k in {1, 8}; K8 and K11 (each region's rows split over blocks) for
   B in {1, 8} at P in {1, 9, 144, 729, 961} with k in {1, 3, 5, 8}, pad
   rows masked and tied, K8 with and without the shortcut; then each
   autograd
   Function's gradients against autograd through its plain forward
   (f32/f32, 8 seeded cotangents; the gradients that are zero in exact
   arithmetic held to NOISE_ABS), K5 -> K6 / K7 also at hd = 512, K1 ->
   K2 also at k = 21, K8 -> K9 also on one bag without the shortcut (k =
   5) and at P = 961 (k = 8), K10 -> K11 also on one bag at P = 729 (k =
   5); every kernel check calls the kernel twice and requires the same
   bits; K2's P = 961 f32 EPEG-bias gradient (zero in exact arithmetic)
   reported against its plain version over the 8 seeds (no limit here);
3. c16_r50: a seeded model through `Engine(device="cuda").evaluate` on bags
   of {37, 937, 2213, 9000, 9000, 30000} patches and `Engine.train_epoch`
   (dropout on) on {937, 2213, 9000, 9000, 30000, 30000}, batch size 2,
   every batch and step required to launch all of its kernels (K1-K9);
   evaluate's probabilities and two dropout-off train steps against the
   same weights on the CPU (f32 and bf16 products);
8. brca_r50 (its CR-MSA runs one 512-wide head): the same three checks as
   phase 3 on bags of {937, 9000, 9000, 30000} patches, batch size 2;
   nsclc_r50 (EPEG k = 21, CR-MSA k = 5, no shortcut), c16_plip (k = 9,
   CR-MSA k = 3, input 512), brca_plip (input 512) and nsclc_plip
   (`crmsa_mlp`: K1 / K5 in evaluate, K1, K2, K5, K6, K7 in training, never
   K3 / K4 / K8 / K9): evaluate on {937, 2213, 9000} and two dropout-off
   train steps against the CPU, every batch and step through its counted
   kernels and no other (phase 3's and 8's dropout-off steps are counted
   too);
9. the CLI: `rrtmil_tpu_torch.main` in this process on synthetic sets of 12
   bags of 800-9500 patches (planted signal) in a temporary directory,
   2 folds x 2 epochs, batch size 1: (a) c16_r50's flags launch K1-K9 and
   no other kernel, the second epoch's bags all come from the device bag
   cache, both checkpoint families are written; (b) the same run cut before
   fold 0's epoch 1 and resumed with --auto_resume equals, within 1e-6, an
   uninterrupted run handed the train order the resumed epoch draws (the
   reference's order stream restarts after a resume), and its fold 1 equals
   (a)'s; (c) (a) with --amp; (d) nsclc_plip's flags (TCGA layout) launch
   K1, K2, K5, K6 and K7 only; each run's per-epoch seconds, train and eval
   slides/s and cache hits printed;
10. the survival CLI: the golden RAdam / Lookahead trajectories replayed
   on the card (rtol 2e-5, atol 2e-6); `rrtmil_tpu_torch.survival_main` in
   this process on a synthetic TCGA-survival set of 10 cases of {937, 1500,
   ..., 45000, 50000} patches at width 1024 (~181 k patches, one case two
   files joined by ';'), 5 folds x 2 epochs: (a) --model RRTMIL (Adam,
   cosine), (b) with --amp, (c) --optimizer RAdam --scheduler plateau, (d)
   --optimizer Lookahead: each bag launches K1 and K2, a bag whose grids
   differ K12 and K13 (K5, K6, K7 around them), a matched one K3-K9, never
   K10 / K11, and every second-epoch bag comes from the device cache; (e)
   --evaluate --resume (a)'s results reproduces (a)'s best c-index and its
   validation loss, exactly, in each fold that saved weights (a fold whose
   best stayed 0 saves none, as in the reference); (f) --model MeanMIL
   launches no
   kernel; each fold's train and validation bags/s a epoch and the cache's
   hits printed;
11. the attention-MIL zoo with the R2T encoder injected (`--only_rrt_enc`,
   c16_r50's encoder, input 1024): (a) attmil, gattmil, clam_sb, clam_mb
   and dsmil (subtyping on) at batch 1 through `Engine.evaluate` on bags
   of {937, 2213, 9000} patches (every batch through K1, K3, K5, K8 and no
   other kernel; probabilities against the CPU) and `Engine.train_epoch`
   with dropout on (every step through K1-K9), two dropout-off steps on
   {937, 2213} against the CPU in f32 and with bf16 products, and a second
   forward and backward that must give the same bits; (b)
   `rrtmil_tpu_torch.main --model {each} --only_rrt_enc` in this process on
   phase 9's 12 bags, 2 folds x 2 epochs, and dsmil with --ds_average:
   K1-K9 and no other kernel, the second epoch all from the device cache,
   train and eval slides/s of the first and the cached epoch printed; (c)
   clam_sb on camelyon16's layout (subtyping off): each instance
   classifier's Adam step equals the count of its fold's steps whose label
   selected it, and one never selected has no optimizer state; (d)
   --dsmil_init from a checkpoint written here changes b_classifier.q
   alone; the CLI (clam_sb --only_rrt_enc) as a process of its own, its
   exit code and seconds; (e) the survival CLI's AttMIL, CLAM_SB and DSMIL
   on phase 10's set, 5 folds x 1 epoch: no kernel, bags/s printed;
12. TransMIL, IBMIL and the encoder's variants: (a) TransMIL (input 1024)
   through the engine's exact mode (batch 1, each bag at its true length)
   `Engine.evaluate` on bags of {937, 2213, 9000, 30000} patches and a
   dropout-on `train_epoch`, launching no kernel, the probabilities against
   the CPU, two dropout-off steps against the CPU (f32, TF32 off,
   TRANSMIL_TOL), a second forward of the same bits, its forward and train
   ms at L = 9000 and its survival step at L = 50000; (d) the CLI on phase
   9's 12 bags, 2 folds x 2 epochs: `--model transmil` launches no kernel
   and never touches the device cache, `python -m
   rrtmil_tpu_torch.build_confounders` writes each fold's prototypes (no
   kernel); (b) IBMIL with c16_r50's encoder and those prototypes, phase
   11 (a)'s checks (K1, K3, K5, K8 a batch, K1-K9 a step, the CPU, the same
   bits); `--model ibmil --only_rrt_enc --confounder_path` launches K1-K9
   and its second epoch comes from the cache, slides/s of each epoch
   printed; (c) c16_r50 with `--pos` ppeg / peg / sincos / ape at
   `--pos_pos -1`, ppeg with 3 layers (K1-K9), `--region_attn ntrans` and
   `--attn ntrans` (only the CR-MSA layer's kernels: K3, K5, K8 in
   evaluate, K3-K9 in training), each with phase 3's three checks; (e) the
   survival CLI's TransMIL and IBMIL on phase 10's set, 5 folds x 1 epoch,
   no kernel; (f) RRTMIL and TransMIL, 5 folds x 2 epochs on 20 cases of
   937-9000 patches, then `--evaluate --resume`: every fold that saved
   weights (at least two) reproduces its best c-index and validation loss
   exactly;
13. DTFD and MHIM-MIL (input 1024, inner / mlp_dim 512, f32, TF32 off;
   weights carried from the card's model to a CPU copy): (a)
   `DTFDClassificationEngine` (4 pseudo-bags, AFS and MaxMinS) on bags of
   {937, 9000, 30000} patches: `evaluate` twice (the same bits) and against
   the CPU with the same permutations (1e-4), a dropout-on `train_epoch`, a
   forward and backward twice of the same bits, two dropout-off steps
   against the CPU (losses 1e-4, parameters within Adam's drift bound); (b)
   `DTFDSurvivalEngine` (group 8, MaxMinS) on {937, 9000, 50000} with the
   same checks through `validate`; (c) `MHIMSurvivalEngine` on {937, 9000,
   50000}: the teacher's feature and raw attention against the CPU,
   `validate` against the CPU, a dropout-on `train_epoch` that moves the
   teacher, two dropout-off student steps against the CPU with the
   keep-masks the card built handed to the CPU (losses, then the student
   and the EMA teacher within the drift bound); (d) MHIM 'selfattn' at 9025
   tokens (PPEG runs) and 937 against the CPU, a second call the same
   bits; (e) every counter 0 on each path of (a)-(d); (f) `python -m
   rrtmil_tpu_torch.main --model dtfd` on phase 9's 12 bags (2 folds x 2
   epochs) and `survival_main --model DTFD` / `--model MHIM-MIL` on phase
   10's set (5 folds x 1 epoch), each a process of its own that exits 0,
   their train and validation rates read from their logs; DTFD and MHIM-MIL
   in this process, 5 folds x 2 epochs on phase 12 (f)'s 20 cases, then
   `--evaluate --resume`: every fold that saved weights reproduces its
   best c-index and validation loss exactly, no kernel launched; (g) DTFD's
   eval forward and train step at L = 9000, MHIM's train step at L = 9000
   and 50000, in ms;
14. the EPEG ablations, the native loader tier and the JAX package's
   weights: (a) c16_r50 (input 1024) with `epeg_type` value_bf, value_af,
   2-D 'attn' and 2-D value_af: `Engine.evaluate` on {937, 2213, 9000}
   against the CPU (K3, K5, K8 once a batch, K1 / K2 never), two
   dropout-off steps against the CPU in f32 (TF32 off; K3-K9 once a step),
   a forward and backward twice of the same bits, the forward and train
   step at L = 9000, B in {1, 8}; (b)
   `python -m rrtmil_tpu_torch.main` with c16_r50's flags and
   `--epeg_type value_af`, and with `--epeg_2d`, each a process of its own
   on phase 9's 12 bags that exits 0; (c) on those bags, every bag and
   batch through the native tier and the Python tier in fp32 and bf16: the
   same bits on the host and on the card; host ms a bag of each tier; the
   CLI with c16_r50's flags through the native tier in fp32 and --amp and
   through the Python tier in fp32 (first and cached epoch rates, batches
   by tier: every miss of a native run served natively), and with a device
   cache of OVER_BUDGET_SHARE of the set (3 epochs: hits, misses and rates
   by epoch; most bags stream every epoch); (d) the committed fixture of
   JAX-written `.msgpack` weights (attmil and a survival MeanMIL at input
   64) loaded on the card, their outputs within 1e-4 of the JAX package's,
   and `survival_main --evaluate --resume` over a JAX results directory as
   a process that exits 0;
15. fold-parallel cross-validation (`--fold_parallel`, FOLDS = 5 folds,
   each with weights of its own): (a) K1-K13 in their fold form (the folds'
   streams along the leading axis, their weights stacked) at the main
   path's shapes (one 9000-patch bag a fold; K12 / K13 at a 45000-patch
   survival bag; K6 / K7 also with per-fold EPEG taps) in the three dtype
   pairs: one launch for all folds (the wrapper's counter up by one, no
   other), against each fold's own launch and plain version (TOL), the same
   bits twice; the fold launch's ms against the five per-fold launches',
   the plain fold form's and the bound; (b) c16_r50 at full width, one
   9000-patch bag a fold: two fold-parallel steps (dropout off, f32
   products) against the folds' own batch-1 steps on the card and, at
   FOLD_CPU_BAG patches, against the CPU (losses 1e-4, parameters within
   Adam's drift bound), every step launching K1-K9 once and no other
   kernel; the step's ms against five batch-1 steps' (default config,
   dropout on) and its peak memory; (c) survival_default's RRTMIL, one
   45000-patch bag a fold (grids 224 / 216), each fold its own lr: (b)'s
   checks (the CPU at FOLD_SURV_CPU_BAG), K1, K2, K5-K7, K12 and K13 once a
   step; (d) `python -m rrtmil_tpu_torch.main --fold_parallel` (c16_r50's
   flags, phase 9's 12 bags, 5 folds x 2 epochs) and `python -m
   rrtmil_tpu_torch.survival_main --model RRTMIL --fold_parallel` (phase
   10's cases, 5 folds x 2 epochs), each a process that exits 0, beside
   the same commands without the flag: each epoch's train rate from the
   logs;
16. the head widths and k the kernels refused, and the zoo under
   `--fold_parallel` (`phase_slice16`);
17. sequence sharding and the dp step over SEQ_SP = 2 ranks sharing the
   card (gloo; the backend rule printed): (a) survival_default at full
   width (f32 stream, dropout off, TF32 off) on bags of 50000 and 45000
   patches (sharded bucket 224 x 224), f32 and bf16 products: each rank's
   sharded forward and value_and_grad launch K5, K6, K7, K12 and K13 and
   none of K1-K4 / K8-K11, and agree with the unsharded port on the same
   card and weights (TOL; the gradients that are zero in exact arithmetic
   within NOISE_ABS in f32); per-rank peak memory, the sharded and
   unsharded value_and_grad ms; (b) `python -m
   rrtmil_tpu_torch.survival_main --model RRTMIL --sp_shards 2` as a
   process on phase 10's set, 5 folds x 1 epoch: a finite c-index in every
   fold, one CSV; (c) `make_sharded_train_step` at dp = 2, c16_r50 at full
   width (f32 products), one 9000-patch bag a rank, against one process at
   B = 2: two steps' losses within 1e-4, parameters within Adam's drift
   bound, K1-K9 every step on each rank; a failing rank fails the phase;
6. survival: `SurvivalEngine.train_epoch` (dropout on) and `validate` on
   survival_default() at full width, bags of {937, 1500, 10000, 30000,
   45000, 50000} patches: each bag whose R-MSA grid exceeds its CR-MSA grid
   must launch K12 and K13, the others K1-K9; validate and two dropout-off
   train steps against the CPU on the {1500, 10000} bags;
7. FFN and unmasked: c16_r50 with ffn=True, drop_path=0.1 through
   `Engine.evaluate` (every batch through K10, never K8; against the CPU)
   and `Engine.train_epoch` (every step through K10 and K11); c16_r50
   called without a mask at L = 9000 (K5, K12, K13) against the CPU;
4. times: each kernel (CUDA events) beside its bound and its plain
   version's time; K5, K6 and K7 (B in {1, 8} at c16_r50's shapes, K6 / K7
   on bf16 operands as K5's backward passes them and on f32 ones, and with
   brca_r50's 512-wide head) and K13 each timed in one interleaved run
   against the one PyTorch call that computes the same function (K5:
   `F.multi_head_attention_forward`; K6 and K7:
   `scaled_dot_product_attention` forward and backward; K13: `torch.bmm`;
   median of PAIR_ROUNDS alternating rounds), beside its device time per
   call from the profiler and its host time per call; at hd = 512 also
   K7's device time with one and with two dq chunks a query-side block
   (its design choice); K1, K2, K3, K4, K8, K9, K11 and K12 also by device
   time and kernel name (K2's four products apart), K8, K9 and K11 by host
   time; K2's four products at B = 1 and 8
   interleaved with torch.matmul on the same bf16 operands; c16_r50 forward
   slides/s at L = 9000 for B in {1, 4, 8} and train slides/s for B in
   {1, 8}, and with --amp (bf16 compute on bf16 bags) forward and train
   for B in {1, 8}; survival train bags/s at L = 45000 and 50000; the FFN
   config's forward and train slides/s at L = 9000, B = 8; peak memory;
5. profile: torch.profiler over three B = 8 forwards, one B = 8 train step
   and one survival train step at L = 45000: device time by kernel, the
   device's busy share, and the window's steps by CUDA events; the train
   step must run K2's four products on the
   warpgroup tensor cores (each wgmma call listed) and no SIMT product;
   the forward, train and survival profiles must name the compression's
   kernels (compress_rows_kernel, compress_reps_kernel, and in the train
   step compress_bwd_kernel), the forward and train ones K8's
   (redistribute_ln_kernel), the train one K9's (redistribute_bwd_kernel);
   a window that misses one fails the run, unless the profiler dropped
   device records in it (fewer kernels recorded on the device than
   launches on the host): such a window is reported and taken again, up
   to three in all.

Every counter is set to 0 just before each path and read just after.
Prints the `{"kernels": [...]}` line (each kernel's launches from its own
path: K5-K7, K12 and K13 rank 0's sharded forward and value_and_grad at
L = 50000 (phase 17 (a), bf16 products), K1-K4, K8 and K9 rank 0's two
dp = 2 steps (phase 17 (c)), K10 / K11 the FFN train epoch;
`launches_by_path` adds every other path, phase 3's to 17's among them;
`fold_parallel` each kernel's phase 15 (a) times), the card's name and
power limit,
and as
its last line
`{"ok": true, "device": {...}}`.  Writes the full report to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import itertools
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
DTYPE_PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16)]
# tolerance on max|kernel - plain| / max(1, max|plain|), by mm dtype: fp32
# sums in another order; in bf16 a sum that lands near a rounding boundary
# rounds the other way (q, softmax, head outputs), ~2^-8 relative
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# autograd checks, run for each of AUTOGRAD_SEEDS cotangent draws: the
# gradients that are zero in exact arithmetic (a key-constant logit shift
# cancels in the softmax), by argument position: the key bias and the EPEG
# bias.  Both sides return rounding noise there (|plain| <= 5.4e-5 on an
# H100), so they are held to an absolute limit: over 8 seeds on an H100 the
# K1 -> K2 pair differed there by 5.7e-5 to 1.15e-4, K6 -> K7 by 1.9e-5 to
# 5.2e-5, K5 by ~1e-6; a wrong term would be of the size of the real
# gradients (>= 1e-2)
NOISE_LEAVES = {"K1->K2": (8, 11), "K1->K2 add_residual=False": (8, 11),
                "K1->K2 (k=21)": (8, 11),
                "K5->K6,K7": (5,), "K5->K6,K7 (hd=512)": (5,),
                "K6->K7 (P=144, k=15)": (4,)}
NOISE_ABS = 3e-4
AUTOGRAD_SEEDS = range(8)
# c16_r50 probabilities and mean loss, card kernels vs CPU plain versions:
# random weights put the probabilities within ~0.1 of 0.5, so the limit sits
# far below that spread (measured gap ~4e-5)
PROB_TOL = 1e-3
# the library call rounds at other points than K5 (bf16 output, unnormalised
# bf16 probabilities); this only checks that it computes the same function
LIBRARY_TOL = 5e-2
# Adam's bias-corrected step |m / sqrt(v)| stays below 1.0034 lr in its
# first steps (at most 1 in the first), so two runs whose gradients differ
# in sign can drift apart by at most 2 * ADAM_STEP * lr a step
ADAM_STEP = 1.01
# interleaved kernel-vs-library rounds (the median is reported)
PAIR_ROUNDS = 7
BAG_LENGTHS = (37, 937, 2213, 9000, 9000, 30000)
BRCA_BAGS = (937, 9000, 9000, 30000)
CANON_BAGS = (937, 2213, 9000)
RAGGED_P = (1, 9, 63, 64, 65, 144, 961)
RAGGED_K9_P = (1, 9, 144, 729, 961)
RAGGED_CR_P = (1, 9, 729, 961)
RAGGED_RD_P = (1, 9, 144, 729, 961)
TRAIN_BAGS = (937, 2213, 9000, 9000, 30000, 30000)
TPU_KERNELS = {
    "K1 region_layer_fused": ("rrtmil_tpu/ops/pallas/region_layer.py:44",
                              "_layer_fwd_pallas",
                              "rrtmil_tpu_torch/csrc/region_layer.cu"),
    "K2 region_layer_bwd": ("rrtmil_tpu/ops/pallas/region_layer.py:248",
                            "_layer_bwd_pallas",
                            "rrtmil_tpu_torch/csrc/region_layer_bwd.cu"),
    "K3 crmsa_compress_grid": ("rrtmil_tpu/ops/pallas/crmsa_kernels.py:228",
                               "_compress_grid_pallas",
                               "rrtmil_tpu_torch/csrc/crmsa.cu"),
    "K4 crmsa_compress_grid_bwd": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:381", "_cgrid_bwd_pallas",
        "rrtmil_tpu_torch/csrc/crmsa_bwd.cu"),
    "K5 region_block_fused": ("rrtmil_tpu/ops/pallas/region_block.py:44",
                              "_block_fwd_pallas",
                              "rrtmil_tpu_torch/csrc/region_layer.cu"),
    "K6 region_attention_fused": ("rrtmil_tpu/ops/pallas/region_attn.py:115",
                                  "_fused_fwd_pallas",
                                  "rrtmil_tpu_torch/csrc/region_layer.cu"),
    "K7 region_attention_bwd": (
        "rrtmil_tpu/ops/pallas/region_attn_bwd.py:51",
        "region_attention_bwd_pallas",
        "rrtmil_tpu_torch/csrc/region_layer_bwd.cu"),
    "K8 crmsa_redistribute_grid_ln": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:752", "_rgrid_ln_pallas",
        "rrtmil_tpu_torch/csrc/crmsa.cu"),
    "K9 crmsa_redistribute_grid_ln_bwd": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:859", "_rgrid_ln_bwd_pallas",
        "rrtmil_tpu_torch/csrc/crmsa_bwd.cu"),
    "K10 crmsa_redistribute_grid": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:251",
        "_redistribute_grid_pallas", "rrtmil_tpu_torch/csrc/crmsa.cu"),
    "K11 crmsa_redistribute_grid_bwd": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:649", "_rgrid_bwd_pallas",
        "rrtmil_tpu_torch/csrc/crmsa_bwd.cu"),
    "K12 crmsa_compress": ("rrtmil_tpu/ops/pallas/crmsa_kernels.py:52",
                           "_compress_pallas",
                           "rrtmil_tpu_torch/csrc/crmsa.cu"),
    "K13 crmsa_redistribute": ("rrtmil_tpu/ops/pallas/crmsa_kernels.py:138",
                               "_redistribute_pallas",
                               "rrtmil_tpu_torch/csrc/crmsa.cu"),
}
K = list(TPU_KERNELS)
C16_TRAIN = K[:9]                       # c16_r50 train step: K1-K9
C16_EVAL = [K[0], K[2], K[4], K[7]]     # its forward: K1, K3, K5, K8
# survival_default (R-MSA region_num 16, CR-MSA 8): a bucket whose grids
# differ runs CR-MSA unfused (K12 -> K5 -> K13), a matched one fused
SURV_MISMATCHED = [K[0], K[1], K[4], K[5], K[6], K[11], K[12]]
SURV_MATCHED = C16_TRAIN
# c16_r50 + FFN + drop_path: the CR-MSA stream goes through K10 (and K11),
# never K8 / K9
FFN_EVAL = [K[0], K[2], K[4], K[9]]
FFN_TRAIN = K[:7] + [K[9], K[10]]
# nsclc_plip (crmsa_mlp): the CR-MSA layer takes the XLA route (torch ops)
# around K5, so K3 / K4 / K8 / K9 never run
MLP_EVAL = [K[0], K[4]]
MLP_TRAIN = [K[0], K[1], K[4], K[5], K[6]]
SURV_BAGS = (937, 1500, 10000, 30000, 45000, 50000)
SURV_CPU_BAGS = (1500, 10000)
FFN_BAGS = (937, 2213, 9000, 9000)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def dname(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# inputs at the main-path shapes
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(shape, g, scale=1.0):
    return torch.randn(shape, generator=g) * scale


def stream_inputs(b, g_side, c, length, seed, dev):
    g = _gen(seed)
    n = g_side * g_side
    mask = (torch.arange(n) < length)[None].expand(b, n).clone()
    mask[-1, length - 37:] = False          # a second true length
    x = _randn((b, n, c), g) * mask[..., None]
    return x.to(dev), mask.to(dev), g


def layer_weights(c, h, hd, kk, g, dev):
    s = (2.0 / (c + h * hd)) ** 0.5
    scale = hd ** -0.5
    w = [_randn((h, c, hd), g, s) for _ in range(3)]
    b = [_randn((h, hd), g, 0.02) for _ in range(3)]
    pw = _randn((h, kk), g, 0.3) if kk else None
    pb = _randn((h,), g, 0.1) if kk else None
    wp = _randn((h, hd, c), g, s)
    bp = _randn((c,), g, 0.02)
    ws = (w[0] * scale, w[1], w[2], b[0] * scale, b[1], b[2], pw, pb, wp, bp)
    return tuple(None if t is None else t.to(dev) for t in ws)


def ln_params(c, g, dev):
    return ((1.0 + _randn((c,), g, 0.1)).to(dev), _randn((c,), g, 0.1).to(dev))


def kernel_cases(b, dev, stream_dtype, G=96, length=9000, seed=None):
    """{kernel: (wrapper, plain version, args)} at the c16_r50 main path shape
    for batch b (by default a 9000-patch bag: G = 96, C = 512, H = 8 x 64,
    P = 144, EPEG k = 15, CR-MSA k = 1 over 64 regions; K6 and K7 as K5's
    backward runs them, on (b, 8, 64, 64) at scale 1 without EPEG), drawn
    from `seed` (100 + b by default)."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl

    RS, C, H, HD, KK = G // 8, 512, 8, 64, 15
    x, mask, g = stream_inputs(b, G, C, length,
                               100 + b if seed is None else seed, dev)
    x = x.to(stream_dtype)
    ls, lb = ln_params(C, g, dev)
    w1 = layer_weights(C, H, HD, KK, g, dev)
    phi = _randn((C, 1), g, 1.0).to(dev)
    nr, p = (G // RS) ** 2, RS * RS
    reps = _randn((b, nr, 1, C), g, 1.0).to(dev)
    wgt = torch.rand((b, nr, 1, p), generator=g).to(dev)
    sc = (_randn((b, G * G, C), g) * mask.cpu()[..., None]).to(dev) \
        .to(stream_dtype)
    w5 = layer_weights(C, H, HD, 0, g, dev)
    x5 = _randn((b, nr, C), g).to(dev).to(stream_dtype)
    gx = (_randn((b, G * G, C), g, 0.1)).to(dev).to(stream_dtype)
    g32 = _randn((b, G * G, C), g, 0.1).to(dev)
    dreps = _randn((b, nr, 1, C), g, 0.1).to(dev)
    dwg = _randn((b, nr, 1, p), g, 0.1).to(dev)
    q, k, v, ga = (_randn((b, H, nr, HD), g).to(dev).to(stream_dtype)
                   for _ in range(4))
    return {
        "K1 region_layer_fused": (
            rl.region_layer_fused, rl.region_layer_plain,
            (x, mask, ls, lb, *w1, G, RS, True)),
        "K2 region_layer_bwd": (
            rl.region_layer_bwd, rl.region_layer_bwd_plain,
            (x, mask, ls, lb, *w1, gx, G, RS, True)),
        "K2 region_layer_bwd (add_residual=False)": (
            rl.region_layer_bwd, rl.region_layer_bwd_plain,
            (x, mask, ls, lb, *w1, gx, G, RS, False)),
        "K4 crmsa_compress_grid_bwd": (
            ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain,
            (x, mask, ls, lb, phi, dreps, dwg, G, RS)),
        "K6 region_attention_fused": (
            ra.region_attention_fused, ra.region_attention_plain,
            (q, k, v, None, None, 1.0)),
        "K7 region_attention_bwd": (
            rab.region_attention_bwd, rab.region_attention_bwd_plain,
            (q, k, v, None, None, ga, 1.0)),
        "K9 crmsa_redistribute_grid_ln_bwd": (
            ck.crmsa_redistribute_grid_ln_bwd,
            ck.redistribute_grid_ln_bwd_plain,
            (x, mask, wgt, reps, ls, lb, sc, g32, G, RS)),
        "K3 crmsa_compress_grid": (
            ck.crmsa_compress_grid, ck.compress_grid_plain,
            (x, mask, ls, lb, phi, G, RS)),
        "K5 region_block_fused": (
            rb.region_block_fused, rb.region_block_plain, (x5, *w5)),
        "K8 crmsa_redistribute_grid_ln": (
            ck.crmsa_redistribute_grid_ln, ck.redistribute_grid_ln_plain,
            (x, mask, wgt, reps, ls, lb, sc, G, RS)),
    }


def extra_cases(dev, stream_dtype):
    """K5 as the unfused R-MSA structure runs it, and K6 / K7 as K2 runs
    their core: P = 144, EPEG k = 15 (with pe_bias)."""
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    g = _gen(7)
    x = _randn((128, 144, 512), g).to(dev).to(stream_dtype)
    q, k, v, ga = (_randn((16, 8, 144, 64), g).to(dev).to(stream_dtype)
                   for _ in range(4))
    pw, pb = _randn((8, 15), g, 0.3).to(dev), _randn((8,), g, 0.1).to(dev)
    return {
        "K5 region_block_fused (P=144, k=15)": (
            rb.region_block_fused, rb.region_block_plain,
            (x, *layer_weights(512, 8, 64, 15, g, dev))),
        "K6 region_attention_fused (P=144, k=15)": (
            ra.region_attention_fused, ra.region_attention_plain,
            (q, k, v, pw, pb, 0.125)),
        "K7 region_attention_bwd (P=144, k=15)": (
            rab.region_attention_bwd, rab.region_attention_bwd_plain,
            (q, k, v, pw, pb, ga, 0.125)),
    }


def grid_redistribute_inputs(b, G, rs, kk, dev, sdt, seed):
    """K10 / K11 inputs on a (b, G*G, 512) stream with pad rows: x, mask,
    w (b, nR, kk, P) in [0, 1), reps, and an upstream gradient g."""
    x, mask, g = stream_inputs(b, G, 512, min(9000, G * G - 40), seed, dev)
    nr, p = (G // rs) ** 2, rs * rs
    w = torch.rand((b, nr, kk, p), generator=g).to(dev)
    reps = _randn((b, nr, kk, 512), g).to(dev)
    gout = _randn((b, G * G, 512), g, 0.1).to(dev).to(sdt)
    return x.to(sdt), mask, w, reps, gout


def surv_region_inputs(length, G, rs, dev, sdt, seed, kk=3):
    """K12 / K13 inputs as one survival bag of `length` patches gives them
    at the CR-MSA layer: its stream fit to the G x G grid (rows past the bag
    are zeros, so logits tie at 0) cut into (G / rs)^2 regions of rs^2
    tokens; phi (512, kk) with the init's U(+-1/sqrt(kk)); w, reps."""
    from rrtmil_tpu_torch.ops.regions import region_partition
    g = _gen(seed)
    x = _randn((1, G * G, 512), g)
    x[:, length:] = 0.0
    regions = region_partition(x.reshape(1, G, G, 512), rs)
    r, p = regions.shape[:2]
    phi = (torch.rand((512, kk), generator=g) * 2 - 1) / kk ** 0.5
    w = torch.rand((r, kk, p), generator=g)
    reps = _randn((r, kk, 512), g)
    return (regions.to(dev).to(sdt), phi.to(dev), w.to(dev), reps.to(dev))


def slice3_cases(dev, sdt):
    """K10 (both residual modes) and K11 at the c16_r50 + FFN shape of a
    9000-patch bag (B = 8, G = 96, P = 144, k = 1) and at G = 24 (P = 9,
    k = 3); K12 and K13 at a 45000-patch survival bag (CR-MSA grid 216:
    R = 64, P = 729, k = 3) and at a 500-patch bag (grid 24: P = 9)."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    cases = {}
    for b, G, rs, kk in ((8, 96, 12, 1), (2, 24, 3, 3)):
        x, mask, w, reps, gout = grid_redistribute_inputs(b, G, rs, kk, dev,
                                                          sdt, 300 + G)
        tag = f"B={b} G={G} P={rs * rs} k={kk}"
        for res in (True, False):
            cases[f"K10 crmsa_redistribute_grid ({tag}"
                  f"{'' if res else ' add_residual=False'})"] = (
                ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
                (x, mask, w, reps, G, rs, res))
        cases[f"K11 crmsa_redistribute_grid_bwd ({tag})"] = (
            ck.crmsa_redistribute_grid_bwd, ck.redistribute_grid_bwd_plain,
            (mask, w, reps, gout, G, rs))
    for length, G, rs in ((45000, 216, 27), (500, 24, 3)):
        regions, phi, w, reps = surv_region_inputs(length, G, rs, dev, sdt,
                                                   400 + G)
        tag = f"L={length} R={regions.shape[0]} P={rs * rs}"
        cases[f"K12 crmsa_compress ({tag})"] = (
            ck.crmsa_compress, ck.compress_plain, (regions, phi))
        cases[f"K13 crmsa_redistribute ({tag})"] = (
            ck.crmsa_redistribute, ck.redistribute_plain, (w, reps))
    return cases


def inner_attention(h, hd, g, dev):
    """An InnerAttention of C = 512 with h heads of hd and seeded weights:
    its `kernel_weights()` are what the model hands K5 (views of the qkv and
    proj Linear weights, wq and bq scaled)."""
    from rrtmil_tpu_torch.config import InnerAttentionConfig
    from rrtmil_tpu_torch.models.rrt import InnerAttention
    mod = InnerAttention(InnerAttentionConfig(dim=512, num_heads=h,
                                              head_dim=hd))
    with torch.no_grad():
        for t in mod.parameters():
            t.copy_(_randn(t.shape, g, (1.0 / 512) ** 0.5))
    return mod.to(dev)


def slice4_cases(dev, sdt):
    """K5, K6 and K7 at ragged region sizes (R = 2, 8 heads of 64, EPEG
    k = 15 with pe_bias), at brca_r50's CR-MSA shape (B = 2: R = 6 rows of
    the 64 regions, one 512-wide head, no EPEG), and on strided inputs as
    the model passes them: K5 on the B = 1 cross-region view (k = 3 rows of
    64 regions, strides (C, 3C, 1)) with an InnerAttention's
    `kernel_weights()` (8 x 64 and 1 x 512 heads), K6 and K7 on q, k, v
    that are views of one packed (R, P, 3, H, hd) tensor."""
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    g = _gen(11)
    cases = {}

    def attn(tag, q, k, v, ga, pw, pb, scale):
        cases[f"K6 region_attention_fused ({tag})"] = (
            ra.region_attention_fused, ra.region_attention_plain,
            (q, k, v, pw, pb, scale))
        cases[f"K7 region_attention_bwd ({tag})"] = (
            rab.region_attention_bwd, rab.region_attention_bwd_plain,
            (q, k, v, pw, pb, ga, scale))

    for p in RAGGED_P:
        x = _randn((2, p, 512), g).to(dev).to(sdt)
        cases[f"K5 region_block_fused (P={p}, k=15)"] = (
            rb.region_block_fused, rb.region_block_plain,
            (x, *layer_weights(512, 8, 64, 15, g, dev)))
        q, k, v, ga = (_randn((2, 8, p, 64), g).to(dev).to(sdt)
                       for _ in range(4))
        attn(f"P={p}, k=15", q, k, v, ga, _randn((8, 15), g, 0.3).to(dev),
             _randn((8,), g, 0.1).to(dev), 0.125)
    x = _randn((6, 64, 512), g).to(dev).to(sdt)
    cases["K5 region_block_fused (hd=512, P=64)"] = (
        rb.region_block_fused, rb.region_block_plain,
        (x, *layer_weights(512, 1, 512, 0, g, dev)))
    q, k, v, ga = (_randn((6, 1, 64, 512), g).to(dev).to(sdt)
                   for _ in range(4))
    attn("hd=512, P=64", q, k, v, ga, None, None, 512 ** -0.5)
    # every other head width the cores take, one key tile and several
    # (ragged), and hd = 512 past one key tile
    for h, hd, p in ((2, 128, 64), (2, 256, 65), (1, 512, 144)):
        q, k, v, ga = (_randn((3, h, p, hd), g).to(dev).to(sdt)
                       for _ in range(4))
        attn(f"hd={hd}, P={p}", q, k, v, ga, None, None, hd ** -0.5)
    for h, hd in ((8, 64), (1, 512)):
        view = _randn((1, 64, 3, 512), g).to(dev).to(sdt) \
            .transpose(1, 2).reshape(3, 64, 512)
        assert not view.is_contiguous()
        cases[f"K5 region_block_fused (strided, {h}x{hd})"] = (
            rb.region_block_fused, rb.region_block_plain,
            (view, *inner_attention(h, hd, g, dev).kernel_weights()))
        packed = _randn((4, 64, 3, h, hd), g).to(dev).to(sdt)
        q, k, v = (packed[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        ga = _randn((4, 64, h, hd), g).to(dev).to(sdt).permute(0, 2, 1, 3)
        attn(f"strided, {h}x{hd}", q, k, v, ga, None, None, hd ** -0.5)
    return cases


def k2_product_cases(dev, mdt, ms=(1, 37, 9216 + 8, 73728)):
    """K2's four products on their own at c16_r50's (and brca_r50's) R-MSA
    widths (C = 512, 8 x 64 heads) for token counts m: the weight gradients
    o^T gm (512 x 512) and z^T round(dqkv) (512 x 1536) summed over the m
    tokens, and the data gradients gm Wp^T (out in the mm dtype) and
    round(dqkv) Wqkv^T (f32 out); operands in the mm dtype, as K2 hands
    them over."""
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    cases = {}
    for m in ms:
        g = torch.Generator(device=dev).manual_seed(m)
        r = lambda *s: torch.randn(s, generator=g, device=dev).to(mdt)
        for what, args in (
                ("dWp", (r(m, 512), r(m, 512), True, torch.float32)),
                ("dWqkv", (r(m, 512), r(m, 1536), True, torch.float32)),
                ("d(o)", (r(m, 512), r(512, 512), False, mdt)),
                ("dz", (r(m, 1536), r(512, 1536), False, torch.float32))):
            cases[f"K2 products ({what} m={m})"] = (
                rl.k2_product, rl.k2_product_plain, args)
    return cases


def k9_inputs(b, p, kk, shortcut, dev, sdt, seed):
    """K9 inputs on b bags of 64 regions of p tokens (G = 8 sqrt(p)), C =
    512, kk representatives, pad rows at each bag's end."""
    rs = int(round(p ** 0.5))
    G = 8 * rs
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    n = G * G
    mask = (torch.arange(n, device=dev) < n - 3 * rs)[None].expand(b, n) \
        .contiguous()
    x = (r(b, n, 512) * mask[..., None]).to(sdt)
    sc = (r(b, n, 512) * mask[..., None]).to(sdt) if shortcut else None
    ls, lb = 1 + r(512, sc=0.1), r(512, sc=0.1)
    w = torch.rand((b, 64, kk, p), generator=g, device=dev)
    return (x, mask, w, r(b, 64, kk, 512), ls, lb, sc, r(b, n, 512, sc=0.1),
            G, rs)


def slice6_cases(dev, sdt, mdt):
    """K2's four products at ragged token counts; K1 and K2 at EPEG k = 21
    (nsclc_r50) and 9 (c16_plip) on the c16_r50 main-path shape (B = 2, G =
    96), both residual modes at k = 21; K9 at P in RAGGED_K9_P with k in
    {1, 3, 5, 8} on one bag (64 regions: each region's rows split over
    blocks), with the shortcut at k = 1 and 5 and without at k = 3 and 8,
    and on 8 bags (one block a region) at P = 9 and 144."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    cases = k2_product_cases(dev, mdt)
    x, mask, g = stream_inputs(2, 96, 512, 9000, 106, dev)
    x = x.to(sdt)
    ls, lb = ln_params(512, g, dev)
    gx = _randn((2, 96 * 96, 512), g, 0.1).to(dev).to(sdt)
    for kk, modes in ((21, (True, False)), (9, (True,))):
        w1 = layer_weights(512, 8, 64, kk, g, dev)
        for res in modes:
            tag = f"k={kk}" + ("" if res else ", add_residual=False")
            cases[f"K1 region_layer_fused ({tag})"] = (
                rl.region_layer_fused, rl.region_layer_plain,
                (x, mask, ls, lb, *w1, 96, 12, res))
            cases[f"K2 region_layer_bwd ({tag})"] = (
                rl.region_layer_bwd, rl.region_layer_bwd_plain,
                (x, mask, ls, lb, *w1, gx, 96, 12, res))
    runs = [(1, p, kk, kk in (1, 5)) for p in RAGGED_K9_P
            for kk in (1, 3, 5, 8)]
    runs += [(8, 9, 5, False), (8, 9, 3, True), (8, 144, 5, False),
             (8, 144, 3, True)]
    for b, p, kk, short in runs:
        cases[f"K9 crmsa_redistribute_grid_ln_bwd (B={b} P={p} k={kk}"
              f"{'' if short else ' no shortcut'})"] = (
            ck.crmsa_redistribute_grid_ln_bwd,
            ck.redistribute_grid_ln_bwd_plain,
            k9_inputs(b, p, kk, short, dev, sdt, 900 + 10 * p + kk + b))
    return cases


def compress_inputs(b, p, kk, dev, sdt, seed):
    """K3 / K4 inputs on b bags of 64 regions of p tokens (G = 8 sqrt(p)),
    C = 512, kk representatives with phi of the init's U(+-1/sqrt(kk)): the
    last row of regions is pad rows but for one token, so their logits tie
    at 0 (a region with one real token, regions with none); d(reps) and
    d(w) for the backward."""
    rs = int(round(p ** 0.5))
    G, n = 8 * rs, 64 * p
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    mask = (torch.arange(n, device=dev) < n - rs * G + 1)[None] \
        .expand(b, n).contiguous()
    x = (r(b, n, 512) * mask[..., None]).to(sdt)
    phi = (torch.rand((512, kk), generator=g, device=dev) * 2 - 1) / kk ** 0.5
    return (x, mask, 1 + r(512, sc=0.1), r(512, sc=0.1), phi,
            r(b, 64, kk, 512, sc=0.1), r(b, 64, kk, p, sc=0.1), G, rs)


def slice7_cases(dev, sdt):
    """K3 and K4 (each region's rows split over blocks) at the c16_r50
    main-path shape for B in {1, 8} (k = 1), and on one bag of 64 regions at
    P in RAGGED_CR_P with k in {1, 3, 5, 8}, pad rows tying at 0; K12 at a
    45000-patch survival bag (R = 64, P = 729, pad rows) with k in {1, 5, 8}
    and at P = 9 with k in {1, 8} (k = 3 in slice3_cases)."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    cases = {}
    runs = [(b, 144, 1, f"B={b}") for b in (1, 8)]
    runs += [(1, p, kk, f"P={p} k={kk}") for p in RAGGED_CR_P
             for kk in (1, 3, 5, 8)]
    for b, p, kk, tag in runs:
        if p == 144:
            x, mask, g = stream_inputs(b, 96, 512, 9000, 700 + b, dev)
            ls, lb = ln_params(512, g, dev)
            args = (x.to(sdt), mask, ls, lb, _randn((512, 1), g).to(dev),
                    _randn((b, 64, 1, 512), g, 0.1).to(dev),
                    _randn((b, 64, 1, 144), g, 0.1).to(dev), 96, 12)
        else:
            args = compress_inputs(b, p, kk, dev, sdt, 710 + 10 * p + kk)
        cases[f"K3 crmsa_compress_grid ({tag})"] = (
            ck.crmsa_compress_grid, ck.compress_grid_plain,
            args[:5] + args[7:])
        cases[f"K4 crmsa_compress_grid_bwd ({tag})"] = (
            ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain, args)
    for length, G, rs, kks in ((45000, 216, 27, (1, 5, 8)),
                               (500, 24, 3, (1, 8))):
        for kk in kks:
            regions, phi, _, _ = surv_region_inputs(length, G, rs, dev, sdt,
                                                    720 + G + kk, kk)
            cases[f"K12 crmsa_compress (L={length} P={rs * rs} k={kk})"] = (
                ck.crmsa_compress, ck.compress_plain, (regions, phi))
    return cases


def redistribute_inputs(b, p, kk, dev, sdt, seed):
    """K8 and K11 inputs on b bags of 64 regions of p tokens (G = 8
    sqrt(p)), C = 512, kk representatives: the last row of regions is pad
    rows but for one token, masked (K8 writes 0 there, K11's gm is 0 there)
    and tied (w one value a representative there, as K3 gives rows whose
    logits tie; x and the shortcut zero); the upstream gradient g is not
    zero on them.  Returns (K8's args with the shortcut, K11's args)."""
    from rrtmil_tpu_torch.ops.regions import region_partition
    rs = int(round(p ** 0.5))
    G, n = 8 * rs, 64 * p
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    mask = (torch.arange(n, device=dev) < n - rs * G + 1)[None] \
        .expand(b, n).contiguous()
    x = (r(b, n, 512) * mask[..., None]).to(sdt)
    sc = (r(b, n, 512) * mask[..., None]).to(sdt)
    pad = ~region_partition(mask.reshape(b, G, G, 1), rs).reshape(b, 64, 1, p)
    w = torch.rand((b, 64, kk, p), generator=g, device=dev)
    w = torch.where(pad, w[:, :1, :, :1], w).contiguous()
    reps = r(b, 64, kk, 512)
    ls, lb = 1 + r(512, sc=0.1), r(512, sc=0.1)
    gout = r(b, n, 512, sc=0.1).to(sdt)
    return ((x, mask, w, reps, ls, lb, sc, G, rs),
            (mask, w, reps, gout, G, rs))


def slice8_items(dev, sdt):
    """K8 and K11 (each region's rows split over blocks) on b bags of 64
    regions of p tokens for b in {1, 8}, p in RAGGED_RD_P and k in {1, 3, 5,
    8}, pad rows masked and tied (redistribute_inputs); K8 with the shortcut
    at k = 1 and 5 and without at k = 3 and 8.  Yields (name, (wrapper,
    plain version, args)) one run's inputs at a time (at B = 8, P = 961 a
    run holds ~3 GB)."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    for b in (1, 8):
        for p in RAGGED_RD_P:
            for kk in (1, 3, 5, 8):
                k8, k11 = redistribute_inputs(b, p, kk, dev, sdt,
                                              800 + 10 * p + kk + b)
                short = kk in (1, 5)
                if not short:
                    k8 = k8[:6] + (None,) + k8[7:]
                tag = f"B={b} P={p} k={kk}"
                yield (f"K8 crmsa_redistribute_grid_ln ({tag}"
                       f"{'' if short else ' no shortcut'})",
                       (ck.crmsa_redistribute_grid_ln,
                        ck.redistribute_grid_ln_plain, k8))
                yield (f"K11 crmsa_redistribute_grid_bwd ({tag})",
                       (ck.crmsa_redistribute_grid_bwd,
                        ck.redistribute_grid_bwd_plain, k11))
                del k8, k11


def work_from_args(name, args):
    """(flops, bytes) of K10-K13 on these inputs: each input read once, each
    output written once."""
    if name.startswith("K10"):
        x, mask, w, reps, _, _, res = args
        b, n, c = x.shape
        r, k, p = b * w.shape[1], w.shape[2], w.shape[3]
        return (2 * r * k * p * c, (2 if res else 1) * b * n * c
                * x.element_size() + b * n + r * k * (p + c) * 4)
    if name.startswith("K11"):
        mask, w, reps, g, _, _ = args
        b, n, c = g.shape
        r, k, p = b * w.shape[1], w.shape[2], w.shape[3]
        return (4 * r * k * p * c, b * n * c * g.element_size() + b * n
                + 2 * r * k * (p + c) * 4)
    if name.startswith("K12"):
        x, phi = args
        r, p, c = x.shape
        k = phi.shape[1]
        return (4 * r * k * p * c, r * p * c * x.element_size() + c * k * 4
                + r * k * (c + p) * 4)
    if name.startswith("K13"):
        w, reps = args
        r, k, p = w.shape
        c = reps.shape[2]
        return 2 * r * k * p * c, r * k * (p + c) * 4 + r * p * c * 4
    if name.startswith("K5"):
        x, wq, _, _, _, _, _, _, _, _, _ = args
        r, p, c = x.shape
        hh = wq.shape[0] * wq.shape[2]
        return (r * (3 * 2 * p * c * hh + 2 * 2 * p * p * hh + 2 * p * hh * c),
                2 * r * p * c * x.element_size() + 4 * c * hh
                * wq.element_size() + 4 * (3 * hh + c))
    if name.startswith(("K6", "K7")):
        q = args[0]
        r, h, p, hd = q.shape
        f, n = (4, 4) if name.startswith("K6") else (10, 7)
        return f * r * h * p * p * hd, n * r * h * p * hd * q.element_size()
    raise ValueError(f"no work count for {name}")


def work_of(name, b, stream_dtype, mm_dtype, hd=64, kk=15, k=1):
    """(flops, bytes) the function needs at the main-path shape for batch b:
    each input read once, each output written once; the products the
    algorithm needs (the EPEG pass as its kk taps).  The R-MSA layer has
    512 / hd heads of hd (c16_r50: 8 x 64, k = 15), the CR-MSA kernels k
    representatives a region (c16_r50: 1)."""
    G, RS, C, H, HD, KK = 96, 12, 512, 512 // hd, hd, kk
    n, p, nr = G * G, RS * RS, (G // RS) ** 2
    si, mi = torch.tensor([], dtype=stream_dtype).element_size(), \
        torch.tensor([], dtype=mm_dtype).element_size()
    hh = H * HD
    if name.startswith("K1"):
        r = b * nr
        flops = r * H * (3 * 2 * p * C * HD + 2 * KK * p * HD
                         + 2 * 2 * p * p * HD + 2 * p * HD * C)
        byts = 2 * b * n * C * si + b * n + 4 * C * H * HD * mi + 4 * 4 * C
    elif name.startswith("K2"):
        # recompute (qkv, logits + AV, EPEG taps), projection backward (dWp,
        # d(o)), core backward (dv, dA, dY, dk, the pre-EPEG logits and
        # their k diagonals, the transposed taps), qkv backward (dWqkv, dz)
        per_region = (2 * p * C * 3 * hh
                      + H * (4 * p * p * HD + 2 * KK * p * HD)
                      + 4 * p * hh * C
                      + H * (8 * p * p * HD + 2 * p * p * HD + 2 * KK * p * p
                             + 2 * KK * p * HD)
                      + 4 * p * 3 * hh * C)
        flops = b * nr * per_region
        byts = (3 * b * n * C * si + b * n + 4 * C * hh * mi
                + 4 * C * hh * 4 + H * KK * 4 * 2 + 8 * C * 4)
    elif name.startswith("K4"):
        # logits, d(combine), dz (two terms), dphi for each of k
        flops = b * nr * 5 * 2 * p * C * k
        byts = (2 * b * n * C * si + b * n + k * b * nr * (C + p) * 4
                + (20 + 8 * k) * C)
    elif name.startswith("K9"):
        # the stream's w^T reps again, dw, dreps for each of k
        flops = b * nr * 6 * p * C * k
        byts = (b * n * C * (3 * si + 4) + b * n
                + 2 * k * b * nr * (C + p) * 4 + 4 * C * 4)
    elif name.startswith("K3"):
        flops = b * nr * 2 * (2 * p * C) * k
        byts = (b * n * C * si + b * n + (2 + k) * 4 * C
                + k * b * nr * (C + p) * 4)
    elif name.startswith("K8"):
        flops = b * nr * 2 * p * C * k
        byts = (2 * b * n * C * si + b * n + k * b * nr * (C + p) * 4
                + b * n * C * 4 + 2 * 4 * C)
    else:
        raise ValueError(f"no work count for {name}")
    return flops, byts


def bound_ms(flops, byts, mm_dtype):
    t_ops = flops / PEAK_FLOPS[mm_dtype]
    t_bytes = byts / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare(fn, plain, args, mmd):
    """(max abs error, scaled error) of the kernel against its plain
    version; a second call must give the same bits (every cross-block sum
    is taken in a fixed order, no atomics)."""
    got = _as_tuple(fn(*args, mm_dtype=mmd))
    again = _as_tuple(fn(*args, mm_dtype=mmd))
    want = _as_tuple(plain(*args, mm_dtype=mmd))
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if a is not None and not torch.equal(a, b):
            raise AssertionError("two calls on the same inputs differ")
    err, rel = 0.0, 0.0
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs != {len(want)}")
    for a, b in zip(got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError("an output is None on one side only")
            continue
        if not a.is_cuda:
            raise AssertionError("the kernel's output is not on the card")
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{tuple(a.shape)} {a.dtype} != "
                                 f"{tuple(b.shape)} {b.dtype}")
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        e = (a - b).abs().max().item()
        err = max(err, e)
        rel = max(rel, e / max(1.0, b.abs().max().item()))
    return err, rel


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = nvidia_smi_line()
    log(f"[0] nvidia-smi: {smi}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[0] TF32 off: matmul.allow_tf32=False cudnn.allow_tf32=False")
    return smi


def phase_build():
    from rrtmil_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    info = build.build_all(verbose=True)
    secs = time.perf_counter() - t0
    for name, rec in info.items():
        log(f"[1] nvcc {name}.cu: {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"      {line.strip()}")
    log(f"[1] build: {secs:.1f} s for {len(info)} sources")
    return secs


def phase_kernels(dev):
    errors = {}
    for sdt, mdt in DTYPE_PAIRS:
        pair = f"{dname(sdt)}/{dname(mdt)}"
        cases = kernel_cases(2, dev, sdt)
        cases.update(extra_cases(dev, sdt))
        cases.update(slice3_cases(dev, sdt))
        cases.update(slice4_cases(dev, sdt))
        cases.update(slice6_cases(dev, sdt, mdt))
        cases.update(slice7_cases(dev, sdt))
        for name, (fn, plain, args) in itertools.chain(
                cases.items(), slice8_items(dev, sdt)):
            err, rel = compare(fn, plain, args, mdt)
            ok = rel <= TOL[mdt]
            log(f"[2] {name:40s} {pair:17s} max_abs_err {err:.3e} "
                f"scaled {rel:.3e} tol {TOL[mdt]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {pair} disagrees with its plain "
                                     f"version: {rel:.3e} > {TOL[mdt]}")
            key = name.split(" (")[0]
            errors.setdefault(key, {})[pair + ("" if key == name else " "
                                               + name[len(key) + 2:-1])] = err
        del cases
        torch.cuda.empty_cache()
    # the largest c16_r50 bucket: L = 60000 -> G = 248, P = 31 x 31 = 961
    sdt, mdt = DTYPE_PAIRS[0]
    for name, (fn, plain, args) in kernel_cases(1, dev, sdt, G=248,
                                                length=60000).items():
        if name.startswith(("K6", "K7")) or "(" in name:
            continue
        err, rel = compare(fn, plain, args, mdt)
        log(f"[2] {name:40s} L=60000 P=961 max_abs_err {err:.3e} scaled "
            f"{rel:.3e} tol {TOL[mdt]:.0e} {'ok' if rel <= TOL[mdt] else 'FAIL'}")
        if rel > TOL[mdt]:
            raise AssertionError(f"{name} at L=60000 disagrees with its plain "
                                 f"version: {rel:.3e} > {TOL[mdt]}")
        errors[name]["float32/bfloat16 L=60000"] = err
        torch.cuda.empty_cache()
    errors["autograd"] = autograd_checks(dev)
    errors["k2_bias_noise"] = k2_bias_noise(dev)
    torch.cuda.empty_cache()
    return errors


def k2_bias_noise(dev, seeds=AUTOGRAD_SEEDS):
    """K2's EPEG-bias gradient at P = 961 with f32 products (one 31 x 31
    region a bag, C = 128, 2 x 64 heads, EPEG k = 15: the shape of
    tests/test_torch_gpu.py::test_cuda_kernels_match_plain's K2 P = 961
    case).  It is zero in exact arithmetic, so the kernel and the plain
    version both return rounding noise; |kernel - plain| for each seeded
    incoming gradient is reported (that test holds it to 1e-4), not held to
    a limit here."""
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    g = _gen(31)
    c, n = 128, 31 * 31
    mask = torch.zeros((2, n), dtype=torch.bool)
    mask[0, :500], mask[1, :300] = True, True
    x = (_randn((2, n, c), g) * mask[..., None]).to(dev)
    w = layer_weights(c, 2, 64, 15, g, dev)
    ls, lb = ln_params(c, g, dev)
    mask = mask.to(dev)
    diffs = []
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        gx = torch.randn((2, n, c), generator=gen, device=dev)
        args = (x, mask, ls, lb, *w, gx, 31, 31, True)
        got = rl.region_layer_bwd(*args, mm_dtype=torch.float32)[10]
        want = rl.region_layer_bwd_plain(*args, mm_dtype=torch.float32)[10]
        diffs.append((got - want).abs().max().item())
    log("[2] K2 P=961 f32 EPEG-bias gradient (zero in exact arithmetic), "
        "|kernel - plain| by seed: " + ", ".join(f"{d:.3e}" for d in diffs)
        + f"; above the gpu test's 1e-4 in {sum(d > 1e-4 for d in diffs)} "
        f"of {len(diffs)}")
    return {"abs_diff_by_seed": diffs, "test_limit": 1e-4}


def autograd_checks(dev, seeds=AUTOGRAD_SEEDS):
    """Each autograd Function's gradients on the card (its backward kernel)
    against autograd through its plain forward, f32 stream and products:
    K1 -> K2 (both residual modes, and at EPEG k = 21), K3 -> K4, K5 ->
    block_ref (K6, K7), K5 at hd = 512, K6 -> K7 (with EPEG), K8 -> K9 (and
    on one bag with k = 5 and no shortcut, and with k = 8 at P = 961, pad
    rows tied: each region's rows split over blocks), K10 -> K11 (both
    residual modes, and on one bag at P = 729, k = 5), and
    K12 and K13, whose backwards are autograd through the plain forward (on
    the card, PyTorch ops).  The cotangents are drawn from each of `seeds`.
    Each gradient's max |card - plain| is scaled by max(1, max|plain|) and
    held to TOL; the NOISE_LEAVES, zero in exact arithmetic, are reported
    apart and held to NOISE_ABS.  Every check runs before any failure is
    raised."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    mmd = torch.float32
    cases = kernel_cases(2, dev, torch.float32)
    ex = extra_cases(dev, torch.float32)
    s3 = slice3_cases(dev, torch.float32)
    s4 = slice4_cases(dev, torch.float32)
    s6 = slice6_cases(dev, torch.float32, torch.float32)
    tag = "B=8 G=96 P=144 k=1"
    checks = {
        "K1->K2": (rl.region_layer_fused, rl.region_layer_plain,
                   cases["K1 region_layer_fused"][2]),
        "K1->K2 add_residual=False": (
            rl.region_layer_fused, rl.region_layer_plain,
            cases["K1 region_layer_fused"][2][:-1] + (False,)),
        "K3->K4": (ck.crmsa_compress_grid, ck.compress_grid_plain,
                   cases["K3 crmsa_compress_grid"][2]),
        "K5->K6,K7": (rb.region_block_fused, rb.region_block_plain,
                      cases["K5 region_block_fused"][2]),
        "K5->K6,K7 (hd=512)": s4["K5 region_block_fused (hd=512, P=64)"],
        "K6->K7 (P=144, k=15)": (
            ra.region_attention_fused, ra.region_attention_plain,
            ex["K6 region_attention_fused (P=144, k=15)"][2]),
        "K8->K9": (ck.crmsa_redistribute_grid_ln,
                   ck.redistribute_grid_ln_plain,
                   cases["K8 crmsa_redistribute_grid_ln"][2]),
        "K8->K9 (B=1, k=5, no shortcut)": (
            ck.crmsa_redistribute_grid_ln, ck.redistribute_grid_ln_plain,
            k9_inputs(1, 144, 5, False, dev, torch.float32, 950)[:6]
            + (None, 96, 12)),
        "K1->K2 (k=21)": (rl.region_layer_fused, rl.region_layer_plain,
                          s6["K1 region_layer_fused (k=21)"][2]),
        "K8->K9 (B=1, P=961, k=8)": (
            ck.crmsa_redistribute_grid_ln, ck.redistribute_grid_ln_plain,
            redistribute_inputs(1, 961, 8, dev, torch.float32, 960)[0]),
        "K10->K11": s3[f"K10 crmsa_redistribute_grid ({tag})"],
        "K10->K11 add_residual=False": s3[
            f"K10 crmsa_redistribute_grid ({tag} add_residual=False)"],
        "K10->K11 (B=1, P=729, k=5)": (
            ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
            redistribute_inputs(1, 729, 5, dev, torch.float32, 970)[0][:4]
            + (216, 27, True)),
        "K12 (L=45000)": s3["K12 crmsa_compress (L=45000 R=64 P=729)"],
        "K13 (L=45000)": s3["K13 crmsa_redistribute (L=45000 R=64 P=729)"],
    }
    out, failed = {}, []
    for name, (fn, plain, args) in checks.items():
        leaves = [a.detach().clone().requires_grad_(True)
                  if isinstance(a, torch.Tensor) and a.is_floating_point()
                  else a for a in args]
        live = [(i, a) for i, a in enumerate(leaves)
                if isinstance(a, torch.Tensor) and a.requires_grad]
        y = _as_tuple(fn(*leaves, mm_dtype=mmd))
        y_plain = _as_tuple(plain(*leaves, mm_dtype=mmd))
        rec = {"scaled": 0.0, "noise_abs": None, "noise_limit": None,
               "by_seed": []}
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            gs = [torch.randn(t.shape, generator=gen, device=t.device,
                              dtype=t.dtype) for t in y]
            got = torch.autograd.grad(y, [a for _, a in live], gs,
                                      allow_unused=True, retain_graph=True)
            want = torch.autograd.grad(y_plain, [a for _, a in live], gs,
                                       allow_unused=True, retain_graph=True)
            torch.cuda.synchronize()
            if any((a is None) != (b is None) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: a gradient is missing")
            rel, noise, noise_mag = 0.0, None, 0.0
            for (i, _), a, b in zip(live, got, want):
                if a is None:
                    continue
                d = (a - b).abs().max().item()
                if i in NOISE_LEAVES.get(name, ()):
                    noise = max(noise or 0.0, d)
                    noise_mag = max(noise_mag, b.abs().max().item())
                else:
                    rel = max(rel, d / max(1.0, b.abs().max().item()))
            ok = rel <= TOL[mmd] and (noise is None or noise <= NOISE_ABS)
            noise_txt = "" if noise is None else \
                (f", noise leaves abs diff {noise:.3e} (limit "
                 f"{NOISE_ABS:.0e}; max|plain| there {noise_mag:.3e})")
            log(f"[2] autograd {name:28s} seed {seed} f32/f32 grads vs "
                f"autograd of the plain forward: scaled {rel:.3e} (tol "
                f"{TOL[mmd]:.0e}){noise_txt} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name} seed {seed}")
            rec["by_seed"].append({"seed": seed, "scaled": rel,
                                   "noise_abs": noise,
                                   "noise_plain_max": noise_mag})
            rec["scaled"] = max(rec["scaled"], rel)
            if noise is not None:
                rec["noise_abs"] = max(rec["noise_abs"] or 0.0, noise)
                rec["noise_limit"] = NOISE_ABS
        out[name] = rec
    if failed:
        raise AssertionError(f"gradients disagree: {failed}")
    return out


def all_counters():
    """The thirteen kernels' wrappers, keyed as in TPU_KERNELS."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd,
           ck.crmsa_redistribute_grid, ck.crmsa_redistribute_grid_bwd,
           ck.crmsa_compress, ck.crmsa_redistribute)
    return dict(zip(TPU_KERNELS, fns))


def reset_counters():
    """Set every kernel's counter to 0."""
    for f in all_counters().values():
        f.launches = 0


def counting(engine_cls, describe=None):
    """`engine_cls` with `_train_step` and `_eval_step` recording each call
    in `engine.records["train"]` / `["eval"]`: every kernel's launches
    during it, the step's output (`out`) and the fields `describe(engine,
    *step_args)` returns."""
    fns = all_counters()

    class Counting(engine_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.records = {"train": [], "eval": []}

        def _record(self, key, step, *a, **k):
            before = {n: f.launches for n, f in fns.items()}
            out = step(*a, **k)
            rec = {"launches": {n: f.launches - before[n]
                                for n, f in fns.items()}, "out": out}
            rec.update(describe(self, *a) if describe else {})
            self.records[key].append(rec)
            return out

        def _train_step(self, *a, **k):
            return self._record("train", super()._train_step, *a, **k)

        def _eval_step(self, *a, **k):
            return self._record("eval", super()._eval_step, *a, **k)
    return Counting


def launches_now():
    return {n: f.launches for n, f in all_counters().items()}


def check_launches(per_step, expected, what, n=None):
    """`n` steps (when given) were recorded, and every one launched each
    kernel of `expected` (a list, or a function of the step's record), and
    no other."""
    if n is not None and len(per_step) != n:
        raise AssertionError(f"{what}: {len(per_step)} steps recorded, not "
                             f"{n}")
    for rec in per_step:
        want = expected(rec) if callable(expected) else expected
        counts = rec["launches"]
        missed = [n for n in want if counts[n] < 1]
        extra = [n for n, v in counts.items() if v and n not in want]
        if missed or extra:
            raise AssertionError(f"{what}: a step missed {missed} or ran "
                                 f"{extra}: {rec}")


def phase_main_path(dev, cfg=None, lengths=BAG_LENGTHS, tag="c16_r50",
                    ph="3", expect=C16_EVAL):
    """Engine.evaluate of `cfg` (c16_r50 by default) on bags of `lengths`
    patches, batch size 2: every batch through the kernels of `expect` (K1,
    K3, K5 and K8) and no other, and the probabilities and mean loss against
    the CPU run of the same weights."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    cfg = cfg or c16_r50()
    rng = np.random.default_rng(0)
    bags = [rng.standard_normal((n, cfg.input_dim), dtype=np.float32)
            for n in lengths]
    labels = [i % 2 for i in range(len(bags))]
    ds = ArrayDataset(bags, labels)
    model = build_model(cfg, device=dev, seed=0)
    ecfg = EngineConfig(batch_size=2)
    engine = counting(Engine)(model, ecfg, cfg.encoder, device=dev)
    n_batches = len(engine._batched_order(ds, range(len(ds))))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, labs, loss = engine.evaluate(ds)
    secs = time.perf_counter() - t0
    launches = launches_now()
    log(f"[{ph}] {tag} Engine.evaluate on {len(ds)} bags in {n_batches} "
        f"batches: {secs:.2f} s, mean loss {loss:.6f}, launches {launches}")
    check_launches(engine.records["eval"], expect, f"{tag} evaluate",
                   n_batches)
    if not (np.isfinite(probs).all() and probs.shape == (len(ds),)):
        raise AssertionError(f"bad probabilities {probs}")

    cpu_model = build_model(cfg, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    t0 = time.perf_counter()
    probs_c, labs_c, loss_c = Engine(cpu_model, ecfg, cfg.encoder,
                                     device="cpu").evaluate(ds)
    cpu_secs = time.perf_counter() - t0
    diff = float(np.abs(probs - probs_c).max())
    log(f"[{ph}] CPU plain versions: {cpu_secs:.1f} s, mean loss "
        f"{loss_c:.6f}; max |probs card - probs cpu| {diff:.3e} (tol "
        f"{PROB_TOL})")
    log(f"[{ph}] probs card {np.round(probs, 5).tolist()}")
    if not np.array_equal(labs, labs_c) or diff > PROB_TOL \
            or abs(loss - loss_c) > PROB_TOL:
        raise AssertionError(f"card and CPU disagree on {tag}'s evaluate")
    return {"batches": n_batches, "seconds": secs, "launches": launches,
            "max_prob_diff": diff, "loss": loss, "loss_cpu": loss_c,
            "probs": probs.tolist()}


def phase_train(dev, cfg=None, lengths=TRAIN_BAGS, tag="c16_r50", ph="3",
                expect=C16_TRAIN):
    """Engine.train_epoch on `cfg` (c16_r50 by default) at full width,
    dropout on, batch size 2: every kernel's counter set to 0 just before
    the epoch and read just after, each step required to launch every
    kernel of `expect` (all nine by default) and no other."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    cfg = cfg or c16_r50()
    rng = np.random.default_rng(1)
    bags = [rng.standard_normal((n, cfg.input_dim), dtype=np.float32)
            for n in lengths]
    ds = ArrayDataset(bags, [i % 2 for i in range(len(bags))])
    model = build_model(cfg, device=dev, seed=0)
    engine = counting(Engine)(model, EngineConfig(batch_size=2), cfg.encoder,
                              device=dev)
    order = list(range(len(ds)))
    n_steps = len(engine._batched_order(ds, order))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = engine.train_epoch(ds, 0, order=order)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launches_now()
    per_step = engine.records["train"]
    step_losses = [float(r["out"][0]) for r in per_step]
    log(f"[{ph}] {tag} Engine.train_epoch on bags {lengths} in {n_steps} "
        f"steps (dropout on): {secs:.2f} s, mean loss {loss:.6f}, step "
        f"losses {np.round(step_losses, 6).tolist()}")
    log(f"[{ph}] train launches {launches}")
    check_launches(per_step, expect, f"{tag} train", n_steps)
    if not (np.isfinite(loss) and np.isfinite(step_losses).all()):
        raise AssertionError(f"the train loss is not finite: {step_losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("a parameter is not finite after training")
    return {"steps": n_steps, "seconds": secs, "launches": launches,
            "per_step": [r["launches"] for r in per_step], "loss": loss,
            "step_losses": step_losses}


def _adam_params_close(got, want, lr, steps, frac):
    """Parameters after `steps` Adam steps: a weight whose gradient is at the
    noise level may step the other way (Adam's first steps are sign-like),
    so at most `frac` of a tensor's elements may differ by more than 1e-5
    (scaled), none by more than 2 * steps * lr * ADAM_STEP.  pe_bias and
    the key third of each qkv bias have gradients that are zero in exact
    arithmetic and are left out."""
    worst_frac, worst = 0.0, 0.0
    for name, a in got.items():
        b = want[name]
        if "pe_bias" in name:
            continue
        if name.endswith("qkv.bias"):
            t = a.shape[0] // 3
            a, b = torch.cat([a[:t], a[2 * t:]]), torch.cat([b[:t], b[2 * t:]])
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        worst_frac = max(worst_frac, (d > 1e-5 + 1e-4 * b.abs()).float()
                         .mean().item())
    ok = worst <= 2 * steps * lr * ADAM_STEP and (frac is None
                                              or worst_frac <= frac)
    return ok, worst, worst_frac


def phase_train_vs_cpu(dev, base=None, tag="c16_r50", ph="3",
                       expect=C16_TRAIN, dtypes=("float32", "bfloat16")):
    """Two train steps of `base` (c16_r50 by default) with dropout off on
    small bags, on the card and on the CPU from the same weights: each card
    step through the kernels of `expect` (K1-K9, counted), the step losses,
    the first step's
    gradients and the parameters after both updates, in f32/f32 (TF32 off)
    and with bf16 products (the products dtypes of `dtypes`)."""
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    base = base or c16_r50()
    rng = np.random.default_rng(2)
    ds = ArrayDataset([rng.standard_normal((n, base.input_dim),
                                           dtype=np.float32)
                       for n in (937, 2213)], [0, 1])
    ecfg = EngineConfig(batch_size=2)
    out = {}
    for mm in dtypes:
        tol = TOL[torch.float32 if mm == "float32" else torch.bfloat16]
        cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses
                                  .replace(base.encoder, dropout=0.0,
                                           mm_dtype=mm))
        runs = {}
        for key, d in (("card", dev), ("cpu", "cpu")):
            rec = {"losses": [], "grads": None, "steps": []}

            class Recording(Engine):
                def _train_step(self, *a, **k):
                    before = launches_now()
                    meters = super()._train_step(*a, **k)
                    rec["losses"].append(float(meters[0]))
                    rec["steps"].append({"launches": {
                        n: v - before[n] for n, v in launches_now().items()}})
                    return meters

                def _apply_grads(self, lr):
                    if rec["grads"] is None:
                        rec["grads"] = {n: p.grad.detach().float().cpu()
                                        for n, p in
                                        self.model.named_parameters()}
                    super()._apply_grads(lr)

            model = build_model(cfg, device=d, seed=0)
            t0 = time.perf_counter()
            Recording(model, ecfg, cfg.encoder, device=d).train_epoch(
                ds, 0, order=[0, 1])
            rec["seconds"] = time.perf_counter() - t0
            rec["params"] = {n: p.detach().float().cpu()
                             for n, p in model.named_parameters()}
            runs[key] = rec
        card, cpu = runs["card"], runs["cpu"]
        check_launches(card["steps"], expect, f"{tag} train ({mm})",
                       len(cpu["losses"]))
        dloss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
        dgrad = max((card["grads"][n] - g).abs().max().item()
                    / max(1.0, g.abs().max().item())
                    for n, g in cpu["grads"].items())
        ok_p, dparam, frac = _adam_params_close(
            card["params"], cpu["params"], ecfg.lr, 2,
            1e-3 if mm == "float32" else None)
        ok = dloss <= tol * max(1.0, max(map(abs, cpu["losses"]))) \
            and dgrad <= tol and ok_p
        log(f"[{ph}] {tag} train card vs CPU, dropout off, {mm} products: "
            f"step losses "
            f"{np.round(card['losses'], 6).tolist()} vs "
            f"{np.round(cpu['losses'], 6).tolist()} (max diff {dloss:.3e}); "
            f"first-step grads scaled {dgrad:.3e} (tol {tol:.0e}); params "
            f"after 2 steps max diff {dparam:.3e} (bound "
            f"{4 * ecfg.lr * ADAM_STEP:.2e}), "
            f"share past 1e-5 {frac:.2e}; card {card['seconds']:.1f} s, CPU "
            f"{cpu['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} train steps on the card and the "
                                 f"CPU disagree ({mm} products)")
        out[mm] = {"loss_diff": dloss, "grad_scaled_err": dgrad,
                   "param_max_diff": dparam, "param_share_past": frac,
                   "card_losses": card["losses"], "cpu_losses": cpu["losses"]}
    return out


def phase_brca(dev):
    """brca_r50, whose CR-MSA runs one 512-wide head (K5, and K6 / K7 in its
    backward, at hd = 512): evaluate, train_epoch and two dropout-off train
    steps against the CPU, as phase 3 checks c16_r50."""
    from rrtmil_tpu_torch.config import brca_r50
    cfg = brca_r50()
    return {"evaluate": phase_main_path(dev, cfg, BRCA_BAGS, "brca_r50", "8"),
            "train": phase_train(dev, cfg, BRCA_BAGS, "brca_r50", "8"),
            "train_vs_cpu": phase_train_vs_cpu(dev, cfg, "brca_r50", "8")}


def phase_canonical(dev):
    """The other canonical configs the port runs, each reaching the kernels
    at settings c16_r50 does not: nsclc_r50 (EPEG k = 21 in K1 / K2, CR-MSA
    k = 5 in K3 / K4 / K8 / K9, no shortcut into K8 / K9), c16_plip (k = 9,
    CR-MSA k = 3, input width 512), brca_plip (input width 512) and
    nsclc_plip (EPEG k = 13; `crmsa_mlp`: its CR-MSA layer runs torch ops
    around K5 at one 512-wide head, so only K1, K5 evaluate and K1, K2, K5,
    K6, K7 train): evaluate on CANON_BAGS and two dropout-off train steps
    against the CPU, every batch and step through its counted kernels."""
    from rrtmil_tpu_torch import config
    out = {}
    for tag, ev, tr in (("nsclc_r50", C16_EVAL, C16_TRAIN),
                        ("c16_plip", C16_EVAL, C16_TRAIN),
                        ("brca_plip", C16_EVAL, C16_TRAIN),
                        ("nsclc_plip", MLP_EVAL, MLP_TRAIN)):
        cfg = getattr(config, tag)()
        out[tag] = {
            "evaluate": phase_main_path(dev, cfg, CANON_BAGS, tag, "8", ev),
            "train_vs_cpu": phase_train_vs_cpu(dev, cfg, tag, "8", tr)}
    return out


# ---------------------------------------------------------------------------
# slice 9: the classification CLI (rrtmil_tpu_torch.main)
# ---------------------------------------------------------------------------

# `python -m rrtmil_tpu_torch.main` flags: c16_r50 (the defaults are its
# encoder but for CR-MSA k = 1 and the shortcut) and nsclc_plip
CLI_C16 = ["--crmsa_k", "1", "--all_shortcut", "--input_dim", "1024"]
CLI_NSCLC_PLIP = ["--datasets", "tcga", "--tcga_sub", "nsclc",
                  "--input_dim", "512", "--epeg_k", "13", "--crmsa_k", "3",
                  "--crmsa_heads", "1", "--all_shortcut", "--crmsa_mlp"]
CLI_RUN = ["--cv_fold", "2", "--num_epoch", "2", "--seed", "2021"]
CLI_BAGS = 12
CLI_LENGTHS = (800, 9500)
# a resumed run against the same computation uninterrupted: the same bits
# are expected (no kernel adds with atomics), held to 1e-6
RESUME_TOL = 1e-6


class CliInterrupt(Exception):
    """Raised inside a CLI run to cut it as a killed process would be."""


def write_cli_data(root, tcga, dim, seed):
    """A synthetic set of CLI_BAGS bags of CLI_LENGTHS patches, half of them
    with a planted signal (+0.3 on their first tenth): camelyon16's layout
    (root/pt/{slide}.npy, label.csv of slide,0|1) or TCGA's
    (root/pt_files/{patient}-01Z.npy, label.csv of patient,LUAD|LUSC)."""
    rng = np.random.default_rng(seed)
    sub = "pt_files" if tcga else "pt"
    os.makedirs(os.path.join(root, sub))
    rows, patches = [], 0
    for i in range(CLI_BAGS):
        n, label = int(rng.integers(*CLI_LENGTHS)), i % 2
        bag = rng.standard_normal((n, dim), dtype=np.float32)
        if label:
            bag[: n // 10] += 0.3
        name = f"TCGA-SM-{i:04d}" if tcga else f"slide_{i:03d}"
        np.save(os.path.join(root, sub, name + ("-01Z" if tcga else "")
                             + ".npy"), bag)
        tag = ("LUSC" if label else "LUAD") if tcga else label
        rows.append(f"{name},{tag}\n")
        patches += n
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("".join(rows))
    return patches


def cli_engine(stats, finals=None, stop_at=None, order_at=None, base=None):
    """The harness's Engine (or the `base` engine class), recording every
    train epoch and evaluation
    (fold, epoch, bags, seconds to the last sync, device cache hits and
    misses, the train loss) in `stats` and each fold's weights after its
    last train epoch in `finals` (a dict by fold, when given); raising CliInterrupt at (fold,
    epoch) `stop_at` before that epoch trains; training (fold, epoch)
    `order_at[0]` in the order `order_at[1]`."""
    from rrtmil_tpu_torch.train.engine import Engine

    class Measured(base or Engine):
        epoch = None

        def _cache_counts(self):
            c = self._dcache
            return (c.hits, c.misses) if c is not None else (0, 0)

        def _measure(self, kind, run, n):
            h0, m0 = self._cache_counts()
            t_before = dict(self.tier_batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            h1, m1 = self._cache_counts()
            stats.append({"kind": kind, "fold": self.fold,
                          "epoch": self.epoch, "bags": n, "seconds": secs,
                          "slides_per_s": n / secs, "cache_hits": h1 - h0,
                          "cache_misses": m1 - m0,
                          "tiers": {k: v - t_before[k] for k, v in
                                    self.tier_batches.items()}})
            return out

        def train_epoch(self, dataset, epoch, order=None):
            if (self.fold, epoch) == stop_at:
                raise CliInterrupt
            if order_at is not None and (self.fold, epoch) == order_at[0]:
                order = order_at[1]
            self.epoch = epoch
            loss = self._measure("train", lambda: super(
                Measured, self).train_epoch(dataset, epoch, order),
                len(dataset))
            stats[-1]["loss"] = loss
            if finals is not None:
                finals[self.fold] = {k: v.detach().cpu().clone() for k, v in
                                     self.model.state_dict().items()}
            return loss

        def evaluate(self, dataset, order=None):
            return self._measure("eval", lambda: super(
                Measured, self).evaluate(dataset, order), len(dataset))
    return Measured


def run_cli(argv, stats, finals=None, engine=None, name="Engine",
            **engine_kw):
    """`rrtmil_tpu_torch.main.main(argv)` in this process, the harness's
    `name` class (Engine or DTFDClassificationEngine) measured by
    cli_engine (or replaced by the given `engine` class)."""
    from rrtmil_tpu_torch import main as cli
    from rrtmil_tpu_torch.harness import classification
    orig = getattr(classification, name)
    setattr(classification, name, engine or cli_engine(
        stats, finals, base=orig, **engine_kw))
    try:
        return cli.main(argv)
    finally:
        setattr(classification, name, orig)


def cli_process(module, argv, what):
    """`python -m module argv` as a process of its own in the repo root:
    (stdout, seconds); fails unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + argv,
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit code {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.stdout, secs


def best_weights(out_dir, fold):
    return torch.load(os.path.join(out_dir, f"fold_{fold}_model_best_auc.pt"),
                      map_location="cpu", weights_only=True)


def weights_diff(a, b):
    if a.keys() != b.keys():
        raise AssertionError("best-AUC weights hold other tensors")
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def metrics_diff(a, b):
    return max(abs(x - y) for key in ("acs", "auc", "pre", "rec", "fs")
               for x, y in zip(a[key], b[key]))


def epoch_summary(stats, epoch):
    """Train and eval seconds and slides/s of one epoch, summed over folds,
    and its device cache hits and misses."""
    out = {}
    for kind in ("train", "eval"):
        rows = [r for r in stats if r["kind"] == kind and r["epoch"] == epoch]
        secs = sum(r["seconds"] for r in rows)
        bags = sum(r["bags"] for r in rows)
        out[kind] = {"seconds": secs, "bags": bags,
                     "slides_per_s": bags / secs if secs else None,
                     "cache_hits": sum(r["cache_hits"] for r in rows),
                     "cache_misses": sum(r["cache_misses"] for r in rows)}
    return out


def phase_cli(dev):
    """`python -m rrtmil_tpu_torch.main` in this process on the card, on
    synthetic sets written to a temporary directory, 2 folds x 2 epochs at
    batch size 1: (a) c16_r50's flags (input 1024): every kernel of K1-K9
    launched, none else; every second epoch's train and eval bags served
    from the device cache; both checkpoint families written; (b) the same
    run cut before fold 0's epoch 1 and restarted with --auto_resume: its
    best-AUC and final weights, epoch losses and metrics equal (RESUME_TOL)
    to an uninterrupted run handed the order the resumed epoch draws (the
    reference's order stream restarts after a resume), and its fold 1 equal
    to (a)'s; (c) (a) with
    --amp; (d) nsclc_plip's flags (TCGA layout, input 512): K1, K2, K5, K6
    and K7 launched, K3 / K4 / K8 / K9 not.  Counters set to 0 just before
    each run and read just after."""
    import tempfile
    from rrtmil_tpu_torch.train.engine import FIXED_LOADER_SEED
    report = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"c16": os.path.join(tmp, "c16"),
                 "nsclc": os.path.join(tmp, "nsclc")}
        t0 = time.perf_counter()
        patches = {"c16": write_cli_data(roots["c16"], False, 1024, 0),
                   "nsclc": write_cli_data(roots["nsclc"], True, 512, 1)}
        log(f"[9] wrote {CLI_BAGS} bags each ({patches} patches) in "
            f"{time.perf_counter() - t0:.1f} s")
        outs = os.path.join(tmp, "out")

        def argv(data, flags, title, *extra):
            return (CLI_RUN + flags + list(extra)
                    + ["--dataset_root", roots[data], "--model_path", outs,
                       "--title", title])

        def out_dir(title):
            return os.path.join(outs, "mil_new_c16", title)

        finals = {"a": {}, "resume": {}, "resume_ref": {}}

        def run(tag, data, flags, title, expect, *extra, finals=None):
            stats = []
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run_cli(argv(data, flags, title, *extra), stats,
                              finals)
            secs = time.perf_counter() - t0
            launches = launches_now()
            missed = [n for n in expect if launches[n] < 1]
            extra_k = [n for n, v in launches.items() if v and n not in expect]
            for r in stats:
                log(f"[9] {tag} fold {r['fold']} epoch {r['epoch']} "
                    f"{r['kind']}: {r['bags']} bags {r['seconds']:.3f} s "
                    f"({r['slides_per_s']:.2f} slides/s), device cache "
                    f"{r['cache_hits']} hits / {r['cache_misses']} misses")
            summary = {e: epoch_summary(stats, e) for e in (0, 1)}
            log(f"[9] {tag}: {secs:.1f} s, test AUC {metrics['auc']}, "
                f"launches {launches}")
            if missed or extra_k:
                raise AssertionError(f"{tag}: missed {missed}, ran {extra_k}")
            later = summary[1]
            if any(later[k]["cache_misses"] or later[k]["cache_hits"]
                   != later[k]["bags"] for k in later):
                raise AssertionError(f"{tag}: epoch 1 not served from the "
                                     f"device cache: {later}")
            if not all(np.isfinite(metrics[k]).all() for k in metrics):
                raise AssertionError(f"{tag}: metrics {metrics}")
            return {"seconds": secs, "launches": launches,
                    "metrics": metrics, "epochs": summary, "stats": stats}

        report["c16_r50"] = run("c16_r50", "c16", CLI_C16, "a", C16_TRAIN,
                                finals=finals["a"])
        need = {"ckp.pt", "ckp_host.pkl", "fold_0_model_best_auc.pt",
                "fold_1_model_best_auc.pt"}
        have = set(os.listdir(out_dir("a")))
        if not need <= have:
            raise AssertionError(f"checkpoints missing: {need - have}")

        stats = []
        try:
            run_cli(argv("c16", CLI_C16, "resume"), stats, stop_at=(0, 1))
            raise AssertionError("the run was not interrupted")
        except CliInterrupt:
            pass
        stats, ref_stats = [], []
        m_res = run_cli(argv("c16", CLI_C16, "resume", "--auto_resume"),
                        stats, finals["resume"])
        first = np.random.default_rng(FIXED_LOADER_SEED).permutation(
            CLI_BAGS // 2)
        m_ref = run_cli(argv("c16", CLI_C16, "resume_ref"), ref_stats,
                        finals["resume_ref"], order_at=((0, 1), first))
        # best-AUC weights (which an early best epoch can leave from before
        # the cut), each fold's final weights and the resumed epochs' losses
        d_ref = max(max(weights_diff(best_weights(out_dir("resume"), f),
                                     best_weights(out_dir("resume_ref"), f)),
                        weights_diff(finals["resume"][f],
                                     finals["resume_ref"][f]))
                    for f in (0, 1))
        losses = [(r["fold"], r["epoch"], r["loss"]) for r in stats
                  if r["kind"] == "train"]
        ref_losses = {(r["fold"], r["epoch"]): r["loss"] for r in ref_stats
                      if r["kind"] == "train"}
        d_loss = max(abs(l - ref_losses[(f, e)]) for f, e, l in losses)
        d_fold1 = max(weights_diff(best_weights(out_dir("resume"), 1),
                                   best_weights(out_dir("a"), 1)),
                      weights_diff(finals["resume"][1], finals["a"][1]))
        d_fold0 = weights_diff(finals["resume"][0], finals["a"][0])
        dm = metrics_diff(m_res, m_ref)
        dm1 = max(abs(m_res[k][1] - report["c16_r50"]["metrics"][k][1])
                  for k in ("acs", "auc", "pre", "rec", "fs"))
        resumed_epochs = [(f, e) for f, e, _ in losses]
        log(f"[9] resume: cut before fold 0 epoch 1, resumed epochs "
            f"{resumed_epochs}; against the uninterrupted run handed the "
            f"restarted order: best-AUC and final weights {d_ref:.3e}, "
            f"epoch losses {d_loss:.3e}, metrics {dm:.3e}; fold 1 against "
            f"(a): weights {d_fold1:.3e}, metrics {dm1:.3e}; fold 0's final "
            f"weights against (a) {d_fold0:.3e} (another train order: must "
            f"differ) (tol {RESUME_TOL})")
        if resumed_epochs != [(0, 1), (1, 0), (1, 1)] or max(
                d_ref, d_loss, dm, d_fold1, dm1) > RESUME_TOL or d_fold0 == 0:
            raise AssertionError("the resumed run differs")
        report["resume"] = {"weights_vs_reference": d_ref,
                            "losses_vs_reference": d_loss,
                            "metrics_vs_reference": dm,
                            "fold1_weights_vs_a": d_fold1,
                            "fold1_metrics_vs_a": dm1,
                            "fold0_final_weights_vs_a": d_fold0,
                            "resumed_epochs": resumed_epochs}

        report["c16_r50_amp"] = run("c16_r50 --amp", "c16", CLI_C16, "amp",
                                    C16_TRAIN, "--amp")
        report["nsclc_plip"] = run("nsclc_plip", "nsclc", CLI_NSCLC_PLIP,
                                   "plip", MLP_TRAIN)
    for tag in ("c16_r50", "c16_r50_amp", "nsclc_plip"):
        for e, name in ((0, "first"), (1, "cached")):
            t = report[tag]["epochs"][e]
            tr, ev = t["train"], t["eval"]
            log(f"[9] {tag} {name} epoch: train {tr['seconds']:.3f} s "
                f"({tr['slides_per_s']:.2f} slides/s), eval "
                f"{ev['seconds']:.3f} s ({ev['slides_per_s']:.2f} slides/s)")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[9] phase 9: {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# slice 10: the survival CLI (rrtmil_tpu_torch.survival_main)
# ---------------------------------------------------------------------------

# `python -m rrtmil_tpu_torch.survival_main` on a synthetic TCGA-survival
# set: bag lengths covering both CR-MSA routes up to the full 50000-patch
# scale (grids differ at 1500, 3000, 10000, 15000, 30000 and 45000), one
# case of two files joined by ';'
SCLI_LENGTHS = (937, 1500, 3000, 6000, 10000, 15000, 20000, 30000, 45000,
                50000)
SCLI_MULTI = 3                 # the case whose bag is two .npy files
SCLI_RUN = ["--num_epoch", "2", "--seed", "1"]
# the golden optimizer trajectories (tests/test_optim_parity.py's limits)
OPTIM_GOLDEN = os.path.join("tests", "goldens", "optim_trajectories.npz")
OPTIM_RTOL, OPTIM_ATOL = 2e-5, 2e-6


def write_survival_data(root, dim=1024, lengths=SCLI_LENGTHS, seed=0):
    """The reference's CSV (Study, ID, Event, Status, WSI) over one .npy bag
    a case (two for case SCLI_MULTI), a risk in [0, 1) planted on the first
    tenth of each bag (+0.5 risk) and an event time falling with it.  In
    each validation fold's pair the earlier case is an event and the later
    one censored, so every fold's pair is comparable."""
    from rrtmil_tpu_torch.data.survival import SurvivalDataset
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    risks = rng.uniform(size=len(lengths))
    times = 2000.0 * (1.05 - risks)
    wsi, patches = [], 0
    for i, n in enumerate(lengths):
        bag = rng.standard_normal((n, dim), dtype=np.float32)
        bag[: max(4, n // 10)] += 0.5 * risks[i]
        if i == SCLI_MULTI:
            cut = n // 3
            paths = [os.path.join(root, f"case_{i}_{j}.npy") for j in (0, 1)]
            np.save(paths[0], bag[:cut])
            np.save(paths[1], bag[cut:])
        else:
            paths = [os.path.join(root, f"case_{i}.npy")]
            np.save(paths[0], bag)
        wsi.append(";".join(paths))
        patches += n
    csv_file = os.path.join(root, "syn.csv")

    def write(status):
        with open(csv_file, "w") as f:
            f.write("Study,ID,Event,Status,WSI\n" + "".join(
                f"syn,case_{i},{times[i]:.1f},{status[i]},{wsi[i]}\n"
                for i in range(len(lengths))))
    status = [1] * len(lengths)
    write(status)
    ds = SurvivalDataset(csv_file)
    for fold in range(5):
        status[max(ds.get_split(fold)[1], key=lambda j: times[j])] = 0
    write(status)
    return csv_file, patches


def survival_cli_engine(records, base=None):
    """The harness's SurvivalEngine (or the `base` engine class) counting
    each step's launches (with its bucket's grids), timing each train epoch
    and validation to its last sync with the device cache's hits and
    misses, and keeping each fold's validations and best c-index in
    `records` (one dict a fold, in the order the harness builds the
    engines)."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.train.surv_engine import SurvivalEngine

    def describe(eng, x, mask, label, cens, length):
        return {"grids": bucket_for(length, eng.encoder_cfg).key,
                "tokens": int(x.shape[1])}

    class Measured(counting(base or SurvivalEngine, describe)):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.fold = {"fold": len(records), "epochs": [], "val_ci": [],
                         "records": self.records}
            records.append(self.fold)
            self._epoch = None

        def _cache_counts(self):
            c = self._dcache
            return (c.hits, c.misses) if c is not None else (0, 0)

        def _measure(self, kind, run, n):
            h0, m0 = self._cache_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            h1, m1 = self._cache_counts()
            self.fold["epochs"].append({
                "kind": kind, "epoch": self._epoch, "bags": n,
                "seconds": secs, "bags_per_s": n / secs,
                "cache_hits": h1 - h0, "cache_misses": m1 - m0,
                "loss": out[0], "c_index": out[1]})
            return out

        def train_epoch(self, dataset, indices, epoch):
            self._epoch = epoch
            return self._measure("train", lambda: super(
                Measured, self).train_epoch(dataset, indices, epoch),
                len(indices))

        def validate(self, dataset, indices):
            out = self._measure("val", lambda: super(
                Measured, self).validate(dataset, indices), len(indices))
            self.fold["val_ci"].append(out[1])
            return out

        def learning(self, *a, **k):
            out = super().learning(*a, **k)
            self.fold["best"] = (out[0], out[1])
            return out
    return Measured


def run_survival_cli(argv, records, engine="SurvivalEngine"):
    """`rrtmil_tpu_torch.survival_main.main(argv)` in this process, the
    harness's `engine` class (SurvivalEngine, DTFDSurvivalEngine or
    MHIMSurvivalEngine) measured by survival_cli_engine."""
    from rrtmil_tpu_torch import survival_main as cli
    from rrtmil_tpu_torch.harness import survival
    orig = getattr(survival, engine)
    setattr(survival, engine, survival_cli_engine(records, orig))
    try:
        return cli.main(argv)
    finally:
        setattr(survival, engine, orig)


def survival_epoch_summary(records, epoch, kind):
    rows = [r for f in records for r in f["epochs"]
            if r["kind"] == kind and r["epoch"] == epoch]
    secs = sum(r["seconds"] for r in rows)
    bags = sum(r["bags"] for r in rows)
    return {"seconds": secs, "bags": bags,
            "bags_per_s": bags / secs if secs else None,
            "cache_hits": sum(r["cache_hits"] for r in rows),
            "cache_misses": sum(r["cache_misses"] for r in rows)}


def replay_optimizer_goldens(dev):
    """The golden RAdam and Lookahead(Adam) trajectories (the reference's
    torch optimizers, recorded by tools/make_optim_goldens.py) replayed on
    the card with the port's optimizers: every step within rtol 2e-5, atol
    2e-6."""
    from rrtmil_tpu_torch.train.optim import make_optimizer
    data = np.load(OPTIM_GOLDEN)
    lr, wd = float(data["lr"]), float(data["wd"])
    out = {}
    for name in ("radam", "lookahead"):
        params = {k: torch.nn.Parameter(torch.tensor(
            data[f"{name}_init_{k}"], device=dev)) for k in ("b", "w")}
        opt = make_optimizer(name, [params["b"], params["w"]], lr, wd)
        worst = 0.0
        for t in range(int(data["steps"])):
            for k, p in params.items():
                p.grad = torch.tensor(data[f"{name}_grads_{k}"][t], device=dev)
            opt.step()
            for k, p in params.items():
                want = data[f"{name}_traj_{k}"][t]
                got = p.detach().cpu().numpy()
                worst = max(worst, float((np.abs(got - want) / (
                    OPTIM_ATOL + OPTIM_RTOL * np.abs(want))).max()))
        log(f"[10] {name} golden trajectory on the card, "
            f"{int(data['steps'])} steps: worst |got - want| / (atol + rtol "
            f"|want|) {worst:.3e} (must be <= 1)")
        if worst > 1.0:
            raise AssertionError(f"{name} leaves its golden trajectory")
        out[name] = worst
    return out


def phase_survival_cli(dev, lengths=SCLI_LENGTHS, dim=1024):
    """`python -m rrtmil_tpu_torch.survival_main` in this process on the
    card, on a synthetic TCGA-survival set written to a temporary directory
    (bags of `lengths` patches, one case of two files), 5 folds x 2 epochs:
    (a) --model RRTMIL with Adam and the cosine schedule, (b) (a) with
    --amp, (c) --optimizer RAdam --scheduler plateau, (d) --optimizer
    Lookahead, (e) --evaluate --resume (a)'s results: each fold that saved
    weights gives (a)'s best c-index and validation loss again, exactly; (f)
    the CLI's default --model MeanMIL: no kernel.
    Each bag launches K1 and K2, a bag whose R-MSA and CR-MSA grids differ
    K12 and K13, a matched one K3 / K8 and K4 / K9 in its backward; K10 and
    K11 never.  Every second-epoch bag comes from the device cache.
    Counters set to 0 just before each run and read just after; also the
    golden optimizer trajectories on the card."""
    import tempfile
    report = {"optimizer_goldens": replay_optimizer_goldens(dev)}
    t_phase = time.perf_counter()
    fwd = lambda rec: [n for n in _surv_expected(rec)
                       if n in (K[0], K[2], K[4], K[7], K[11], K[12])]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        csv_file, patches = write_survival_data(os.path.join(tmp, "data"),
                                                dim, lengths)
        log(f"[10] wrote {len(lengths)} cases ({patches} patches, "
            f"{patches * dim * 4 / 2 ** 30:.2f} GiB of fp32) in "
            f"{time.perf_counter() - t0:.1f} s")

        def run(tag, flags, train=True, kernels=True):
            records = []
            out = os.path.join(tmp, tag)
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meter = run_survival_cli(
                SCLI_RUN + flags + ["--input_dim", str(dim), "--excel_file",
                                    csv_file, "--results_dir", out,
                                    "--device", str(dev)], records)
            secs = time.perf_counter() - t0
            launches = launches_now()
            log(f"[10] {tag}: {secs:.1f} s, c-index by fold "
                f"{meter.cindex[1:6]}, launches "
                f"{ {n.split()[0]: v for n, v in launches.items() if v} }")
            if len(records) != 5:
                raise AssertionError(f"{tag}: {len(records)} folds ran")
            steps = [r for f in records for r in f["records"]["train"]]
            evals = [r for f in records for r in f["records"]["eval"]]
            if kernels:
                check_launches(steps, _surv_expected, f"{tag} train")
                check_launches(evals, fwd, f"{tag} validate")
                grids = {r["grids"][0] != r["grids"][1] for r in steps
                         + evals}
                if train and grids != {True, False}:
                    raise AssertionError(f"{tag}: not both CR-MSA routes")
            elif any(launches.values()):
                raise AssertionError(f"{tag} launched {launches}")
            if not all(np.isfinite(v) for v in meter.cindex[1:]):
                raise AssertionError(f"{tag}: c-index {meter.cindex}")
            rep = {"seconds": secs, "launches": launches,
                   "cindex": meter.cindex[1:], "folds": [
                       {k: f[k] for k in ("epochs", "val_ci", "best")
                        if k in f} for f in records]}
            if train:
                if not os.path.exists(os.path.join(
                        out, f"results_{flags[flags.index('--model') + 1]}"
                        ".csv")):
                    raise AssertionError(f"{tag}: no results csv")
                summary = {e: {k: survival_epoch_summary(records, e, k)
                               for k in ("train", "val")} for e in (0, 1)}
                for f in records:
                    for r in f["epochs"]:
                        log(f"[10] {tag} fold {f['fold']} epoch "
                            f"{r['epoch']} {r['kind']}: {r['bags']} bags "
                            f"{r['seconds']:.3f} s ({r['bags_per_s']:.2f} "
                            f"bags/s), device cache {r['cache_hits']} hits "
                            f"/ {r['cache_misses']} misses")
                later = summary[1]
                if any(later[k]["cache_misses"] or later[k]["cache_hits"]
                       != later[k]["bags"] for k in later):
                    raise AssertionError(f"{tag}: epoch 1 not served from "
                                         f"the device cache: {later}")
                rep["epochs"] = summary
            return rep, out

        report["rrtmil"], out_a = run("rrtmil", ["--model", "RRTMIL"])
        report["rrtmil_amp"], _ = run("rrtmil_amp",
                                      ["--model", "RRTMIL", "--amp"])
        report["radam"], _ = run("radam", ["--model", "RRTMIL",
                                           "--optimizer", "RAdam",
                                           "--scheduler", "plateau"])
        report["lookahead"], _ = run("lookahead", ["--model", "RRTMIL",
                                                   "--optimizer",
                                                   "Lookahead"])
        report["evaluate"], _ = run("evaluate", [
            "--model", "RRTMIL", "--evaluate", "--resume", out_a],
            train=False)
        # (e) against (a): a fold whose best c-index stayed 0 saved no
        # weights (the reference's `>` test), so evaluate ran its seeded
        # initial weights there
        saved = [os.path.isdir(os.path.join(out_a, f"fold_{k}")) and bool(
            os.listdir(os.path.join(out_a, f"fold_{k}"))) for k in range(5)]
        best = [f["best"][0] for f in report["rrtmil"]["folds"]]
        best_loss = [[r["loss"] for r in f["epochs"] if r["kind"] == "val"
                      and r["epoch"] == f["best"][1]][0]
                     for f in report["rrtmil"]["folds"]]
        got = [f["val_ci"][0] for f in report["evaluate"]["folds"]]
        got_loss = [f["epochs"][0]["loss"] for f in report["evaluate"]["folds"]]
        log(f"[10] evaluate --resume: c-index by fold {got}, loss "
            f"{got_loss}, against (a)'s best {best}, its loss {best_loss} "
            f"(weights saved for folds {[k for k in range(5) if saved[k]]}; "
            f"the others' best stayed 0, so they ran their seeded weights)")
        if not any(saved) or any(s and (g, gl) != (b, bl) for s, g, gl, b, bl
                                 in zip(saved, got, got_loss, best,
                                        best_loss)):
            raise AssertionError("--evaluate --resume does not reproduce "
                                 "(a)'s best c-indices and losses")
        report["evaluate"]["matches_a"] = {
            "saved": saved, "best_a": best, "c_index": got,
            "loss_a": best_loss, "loss": got_loss}
        report["meanmil"], _ = run("meanmil", ["--model", "MeanMIL"],
                                   kernels=False)
    for tag in ("rrtmil", "rrtmil_amp"):
        for e, name in ((0, "first"), (1, "cached")):
            t = report[tag]["epochs"][e]
            tr, va = t["train"], t["val"]
            log(f"[10] {tag} {name} epoch: train {tr['seconds']:.3f} s "
                f"({tr['bags_per_s']:.2f} bags/s), validation "
                f"{va['seconds']:.3f} s ({va['bags_per_s']:.2f} bags/s), "
                f"cache {tr['cache_hits'] + va['cache_hits']} hits / "
                f"{tr['cache_misses'] + va['cache_misses']} misses")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[10] phase 10: {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# slice 11: the attention-MIL zoo with the R2T encoder injected
# ---------------------------------------------------------------------------

ZOO_MODELS = ("attmil", "gattmil", "clam_sb", "clam_mb", "dsmil")
ZOO_BAGS = (937, 2213, 9000)
ZOO_CPU_BAGS = (937, 2213)
# the last layer's bias of each attention scorer shifts a whole softmax row:
# its gradient is zero in exact arithmetic, rounding noise on both sides,
# which Adam's first steps turn into lr-sized steps of either sign
ZOO_NOISE_PARAMS = ("attn_fc2.bias", "attn_net.attention_c.bias",
                    "W_k.bias")
# the stem's Linear (feature.fc, CLAM's fc, DSMIL's patch_to_emb): its
# gradient passes the relu at pre-activations within the two sides' GEMM
# rounding of zero (cuBLAS and the CPU's f32 sums over 1024 inputs differ
# by up to ~7e-6 on an H100), where a sign flip moves one row of the
# gradient by dh x (1.2e-3 at attmil's 937-patch bag: pre 259, feature 488,
# in a run with every kernel swapped for its plain version too); held by
# the parameters' drift bound after the steps
ZOO_STEM = ("feature.fc.", "fc.", "patch_to_emb.", "embedding.fc.")
# the survival CLI's zoo backbones (no encoder, as the JAX package builds
# them), 5 folds x 1 epoch on phase 10's set
ZOO_SURVIVAL = ("AttMIL", "CLAM_SB", "DSMIL")


def zoo_model(name, dev, dropout=True, mm_dtype=None, confounders=None):
    """(model, encoder config): a zoo model at full width (input 1024) with
    c16_r50's encoder injected (the CLI's --only_rrt_enc with c16_r50's
    flags), seed 0, subtyping on (TCGA's setting: every instance classifier
    trains), IBMIL's `confounders`; `dropout=False` turns every dropout
    off, GatedABMIL's fixed stem dropout included."""
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.models import zoo
    enc = c16_r50().encoder
    if not dropout:
        enc = dataclasses.replace(enc, dropout=0.0)
    if mm_dtype is not None:
        enc = dataclasses.replace(enc, mm_dtype=mm_dtype)
    model = zoo.build_model(name, input_dim=1024,
                            dropout=0.25 if dropout else 0.0, rrt_cfg=enc,
                            subtyping=True, confounders=confounders,
                            device=dev, seed=0)
    if not dropout and name == "gattmil":
        model.feature.p = 0.0      # its stem's dropout is fixed at 0.25
    return model, enc


def _zoo_engine_cfg(name, **kw):
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.train.engine import EngineConfig
    cls_a, aux_a = zoo.LOSS_WEIGHT_OVERRIDES.get(name, (1.0, 1.0))
    return EngineConfig(batch_size=1, cls_alpha=cls_a, aux_alpha=aux_a,
                        aux_mode=zoo.aux_mode(name), **kw)


def _zoo_params_close(got, want, lr, steps, frac, noise=ZOO_NOISE_PARAMS):
    """Parameters after `steps` Adam steps: every tensor within Adam's drift
    bound (2 steps lr ADAM_STEP); at most `frac` of a tensor's elements
    past 1e-5 (scaled), but the encoder's and the scorers' noise-gradient
    parameters (pe_bias, the key qkv biases, those ending in `noise`), held
    to the bound alone."""
    noisy = {n: v for n, v in got.items() if n.endswith(noise)}
    ok, worst, worst_frac = _adam_params_close(
        {n: v for n, v in got.items() if n not in noisy}, want, lr, steps,
        frac)
    for n, v in noisy.items():
        worst = max(worst, (v - want[n]).abs().max().item())
    return ok and worst <= 2 * steps * lr * ADAM_STEP, worst, worst_frac


def _grad_bits(model, loss_fn, what):
    """A forward and backward twice from the same weights: the loss and
    every gradient the same bits; returns the number of gradients."""
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        runs.append([loss.detach().clone()] + [
            p.grad.detach().clone() for p in model.parameters()
            if p.grad is not None])
    model.zero_grad(set_to_none=True)
    if len(runs[0]) != len(runs[1]) or not all(
            torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{what}: a second forward and backward gave "
                             f"other bits")
    return len(runs[0]) - 1


def _zoo_step_bits(name, model, ds, dev, enc):
    """One dropout-off forward and backward of bag 1 of `ds` on the card,
    twice: (loss, every gradient) of the two runs must be the same bits
    (every kernel of the path deterministic at the zoo's shapes)."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for, pad_bag
    from rrtmil_tpu_torch.models import zoo
    bag, label = ds[1]
    spec = bucket_for(bag.shape[0], enc)
    x, mask = pad_bag(bag, spec.data_length)
    x, mask = torch.from_numpy(x[None]).to(dev), \
        torch.from_numpy(mask[None]).to(dev)
    lab = torch.tensor([label], device=dev)
    kw = {"label": label} if name.startswith("clam") else {}
    ce = torch.nn.functional.cross_entropy

    def loss_fn():
        out = model(x, mask=mask, length=spec.repr_length, **kw)
        if isinstance(out, tuple):
            aux = out[1] if kw else ce(out[1], lab)
            return ce(out[0], lab) + aux
        return ce(out, lab)
    return _grad_bits(model, loss_fn, name)


def zoo_datasets():
    """(ds, cpu_ds): bags of ZOO_BAGS patches (labels alternating) and the
    first two of them (labels 1, 0), at input width 1024."""
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    rng = np.random.default_rng(11)
    bags = [rng.standard_normal((n, 1024), dtype=np.float32)
            for n in ZOO_BAGS]
    ds = ArrayDataset(bags, [i % 2 for i in range(len(bags))])
    cpu_ds = ArrayDataset(bags[:len(ZOO_CPU_BAGS)], [1, 0])
    assert tuple(b.shape[0] for b in cpu_ds._bags) == ZOO_CPU_BAGS
    return ds, cpu_ds


def zoo_model_checks(name, dev, ds, cpu_ds, confounders=None, ph="11"):
    """One zoo model with c16_r50's encoder injected (and IBMIL's
    `confounders`), at full width, batch 1: Engine.evaluate on `ds` (every
    batch through K1, K3, K5, K8 and no other kernel; probabilities against
    the CPU), Engine.train_epoch with dropout on (every step through K1-K9
    and no other), two dropout-off steps on `cpu_ds` against the CPU in f32
    and with bf16 products (losses, first-step gradients, parameters within
    Adam's drift bound; every card step through K1-K9), and the same bits
    from a second forward and backward."""
    from rrtmil_tpu_torch.train.engine import Engine
    t0 = time.perf_counter()
    rec = {}
    model, enc = zoo_model(name, dev, confounders=confounders)
    engine = counting(Engine)(model, _zoo_engine_cfg(name), enc, device=dev)
    reset_counters()
    torch.cuda.synchronize()
    probs, labs, loss = engine.evaluate(ds)
    rec["eval_launches"] = launches_now()
    check_launches(engine.records["eval"], C16_EVAL, f"{name} evaluate",
                   len(ds))
    cpu = zoo_model(name, "cpu", confounders=confounders)[0]
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    probs_c, labs_c, loss_c = Engine(cpu, _zoo_engine_cfg(name), enc,
                                     device="cpu").evaluate(ds)
    diff = float(np.abs(probs - probs_c).max())
    if not (np.isfinite(probs).all() and probs.shape == (len(ds),)) or \
            diff > PROB_TOL or abs(loss - loss_c) > PROB_TOL or \
            not np.array_equal(labs, labs_c):
        raise AssertionError(f"{name}: card and CPU evaluate disagree "
                             f"({diff:.3e})")
    rec.update(max_prob_diff=diff, loss=loss, loss_cpu=loss_c)

    reset_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    train_loss = engine.train_epoch(ds, 0, order=list(range(len(ds))))
    torch.cuda.synchronize()
    rec["train_seconds"] = time.perf_counter() - t1
    rec["launches"] = launches_now()
    check_launches(engine.records["train"], C16_TRAIN, f"{name} train",
                   len(ds))
    if not np.isfinite(train_loss) or not all(
            torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"{name}: the train epoch is not finite")
    rec["train_loss"] = train_loss
    rec["bits_checked_tensors"] = _zoo_step_bits(
        name, model.eval(), cpu_ds, dev, enc)
    del engine, model, cpu
    rec["vs_cpu"] = _zoo_train_vs_cpu(name, dev, cpu_ds, confounders, ph)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[{ph}] {name}: evaluate on {ZOO_BAGS} max |probs card - cpu| "
        f"{diff:.3e}, train epoch (dropout on) loss {train_loss:.6f} in "
        f"{rec['train_seconds']:.2f} s, second forward and backward the "
        f"same bits ({rec['bits_checked_tensors']} gradients), "
        f"{rec['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return rec


def phase_zoo_models(dev):
    """Phase 11 (a): zoo_model_checks for each of ZOO_MODELS."""
    ds, cpu_ds = zoo_datasets()
    return {name: zoo_model_checks(name, dev, ds, cpu_ds)
            for name in ZOO_MODELS}


def _zoo_train_vs_cpu(name, dev, ds, confounders=None, ph="11"):
    """train_steps_vs_cpu of zoo model `name` (c16_r50's encoder, IBMIL's
    `confounders`): every card step through K1-K9."""
    return train_steps_vs_cpu(
        lambda d, mm: zoo_model(name, d, dropout=False, mm_dtype=mm,
                                confounders=confounders),
        _zoo_engine_cfg(name), ds, dev, name, ph, C16_TRAIN)


def train_steps_vs_cpu(make, ecfg, ds, dev, tag, ph, expect,
                       tols=(("float32", TOL[torch.float32]),
                             ("bfloat16", TOL[torch.bfloat16]))):
    """Two dropout-off steps on `ds` (its bags 0 and 1, batch 1) of the
    model `make(device, mm_dtype)` returns (with its encoder config) on the
    card and on the CPU from the same weights, for each (products dtype,
    tolerance) of `tols` (TF32 off): every card step through the kernels
    of `expect` and no other, the losses and the first step's gradients
    (but the stem's, ZOO_STEM, and the noise-only ZOO_NOISE_PARAMS) within
    the tolerance, every parameter after both steps within Adam's drift
    bound."""
    from rrtmil_tpu_torch.train.engine import Engine
    out = {}
    for mm, tol in tols:
        runs = {}
        state = None
        for key, d in (("card", dev), ("cpu", "cpu")):
            rec = {"losses": [], "grads": None, "steps": []}

            class Recording(Engine):
                def _train_step(self, *a, **k):
                    before = launches_now()
                    meters = super()._train_step(*a, **k)
                    rec["losses"].append(float(meters[0]))
                    rec["steps"].append({"launches": {
                        n: v - before[n] for n, v in launches_now().items()}})
                    return meters

                def _apply_grads(self, lr):
                    if rec["grads"] is None:
                        rec["grads"] = {n: p.grad.detach().float().cpu()
                                        for n, p in
                                        self.model.named_parameters()
                                        if p.grad is not None}
                    super()._apply_grads(lr)

            model, enc = make(d, mm)
            if state is None:
                state = {k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            Recording(model, ecfg, enc, device=d).train_epoch(
                ds, 0, order=[0, 1])
            rec["params"] = {n: p.detach().float().cpu()
                             for n, p in model.named_parameters()}
            runs[key] = rec
        card, cpu = runs["card"], runs["cpu"]
        check_launches(card["steps"], expect, f"{tag} train ({mm})", 2)
        dloss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
        if card["grads"].keys() != cpu["grads"].keys():
            raise AssertionError(f"{tag}: other parameters have gradients")
        dgrad = max((card["grads"][n] - g).abs().max().item()
                    / max(1.0, g.abs().max().item())
                    for n, g in cpu["grads"].items()
                    if not n.endswith(ZOO_NOISE_PARAMS)
                    and not n.startswith(ZOO_STEM))
        ok_p, dparam, frac = _zoo_params_close(
            card["params"], cpu["params"], ecfg.lr, 2,
            1e-3 if mm == "float32" else None)
        ok = dloss <= tol * max(1.0, max(map(abs, cpu["losses"]))) \
            and dgrad <= tol and ok_p
        log(f"[{ph}] {tag} train card vs CPU, dropout off, {mm} products: "
            f"losses {np.round(card['losses'], 6).tolist()} vs "
            f"{np.round(cpu['losses'], 6).tolist()} (max diff {dloss:.3e}); "
            f"first-step grads scaled {dgrad:.3e} (tol {tol:.0e}); params "
            f"after 2 steps max diff {dparam:.3e}, share past 1e-5 "
            f"{frac:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} train steps on the card and the "
                                 f"CPU disagree ({mm} products)")
        out[mm] = {"loss_diff": dloss, "grad_scaled_err": dgrad,
                   "param_max_diff": dparam, "param_share_past": frac,
                   "card_losses": card["losses"], "cpu_losses": cpu["losses"]}
    return out


def zoo_cli_engine(stats, labels_seen, clf_steps, first_state):
    """cli_engine's measured Engine that also records each train step's
    (fold, host label), the Adam step of each instance classifier after
    every train epoch (None: no state), and the model's weights when a fold
    starts training."""
    base = cli_engine(stats)

    class ZooMeasured(base):
        def _train_step(self, x, mask, labels, length, label=None):
            labels_seen.append((self.fold, label))
            return super()._train_step(x, mask, labels, length, label=label)

        def train_epoch(self, dataset, epoch, order=None):
            if self.fold not in first_state:
                first_state[self.fold] = {
                    k: v.detach().cpu().clone()
                    for k, v in self.model.state_dict().items()}
            loss = super().train_epoch(dataset, epoch, order)
            clf_steps[self.fold] = {
                n: (int(self.optimizer.state[p]["step"])
                    if p in self.optimizer.state else None)
                for n, p in self.model.named_parameters()
                if n.startswith("instance_classifier_") and
                n.endswith(".weight")}
            return loss
    return ZooMeasured


def phase_zoo_cli(dev):
    """Phase 11 (b)-(e) and the CLI as its own command.  (b) `python -m
    rrtmil_tpu_torch.main --model {attmil, gattmil, clam_sb, clam_mb, dsmil}
    --only_rrt_enc` (c16_r50's flags) in this process on phase 9's 12
    synthetic bags, 2 folds x 2 epochs, and dsmil with --ds_average: each
    run launches K1-K9 and no other kernel, the second epoch's train and
    eval bags all come from the device cache; (c) clam_sb on the
    camelyon16 layout (subtyping off): after each fold, each
    instance_classifier's Adam step equals the number of that fold's steps
    whose label selected it (no state when none did), and an epoch of
    class-1 bags alone leaves instance_classifier_0 without state; (d)
    --dsmil_init from a checkpoint written here changes b_classifier.q and
    nothing else of the seeded model; (e) the survival CLI's AttMIL,
    CLAM_SB and DSMIL on phase 10's set, 5 folds x 1 epoch, launch no
    kernel; then `python -m rrtmil_tpu_torch.main --model clam_sb
    --only_rrt_enc` as a process of its own (exit code and seconds)."""
    import tempfile
    from rrtmil_tpu_torch import main as cli
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.harness import classification
    from rrtmil_tpu_torch.train.engine import Engine
    report = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "c16")
        patches = write_cli_data(root, False, 1024, 0)
        outs = os.path.join(tmp, "out")
        log(f"[11] wrote {CLI_BAGS} bags ({patches} patches)")

        def argv(name, title, *extra):
            return (["--model", name, "--only_rrt_enc"] + CLI_RUN + CLI_C16
                    + list(extra) + ["--dataset_root", root, "--model_path",
                                     outs, "--title", title])

        def run(tag, args):
            stats, labels_seen, clf_steps, first = [], [], {}, {}
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run_cli(args, stats, engine=zoo_cli_engine(
                stats, labels_seen, clf_steps, first))
            secs = time.perf_counter() - t0
            launches = launches_now()
            ran = [n for n, v in launches.items() if v]
            summary = {e: epoch_summary(stats, e) for e in (0, 1)
                       if any(r["epoch"] == e for r in stats)}
            log(f"[11] {tag}: {secs:.1f} s, test AUC {metrics['auc']}, "
                f"launches {launches}")
            if ran != C16_TRAIN:
                raise AssertionError(f"{tag} ran {ran}, not K1-K9")
            later = summary.get(1)
            if later is not None and any(
                    later[k]["cache_misses"] or later[k]["cache_hits"]
                    != later[k]["bags"] for k in later):
                raise AssertionError(f"{tag}: epoch 1 not served from the "
                                     f"device cache: {later}")
            if not all(np.isfinite(metrics[k]).all() for k in metrics):
                raise AssertionError(f"{tag}: metrics {metrics}")
            return {"seconds": secs, "launches": launches, "metrics": metrics,
                    "epochs": summary, "stats": stats}, labels_seen, \
                clf_steps, first

        cli_runs = report["cli"] = {}
        for name in ZOO_MODELS:
            cli_runs[name], labels_seen, clf_steps, _ = run(
                name, argv(name, name))
            if name == "clam_sb":
                # (c) the absent-parameter rule: camelyon16, subtyping off
                want = {f: {f"instance_classifier_{c}.weight": sum(
                    1 for ff, lab in labels_seen if ff == f and lab == c)
                    or None for c in (0, 1)} for f in clf_steps}
                log(f"[11] clam_sb instance classifiers' Adam steps by fold "
                    f"{clf_steps}, steps whose label selected each {want}")
                if clf_steps != want or None in [
                        lab for _, lab in labels_seen]:
                    raise AssertionError("CLAM's instance classifiers' Adam "
                                         "steps differ from their branch's")
                cli_runs[name]["instance_classifier_steps"] = clf_steps
        cli_runs["dsmil_ds_average"], _, _, _ = run(
            "dsmil --ds_average", argv("dsmil", "dsa", "--ds_average"))

        # (c) a classifier no label selects keeps no optimizer state
        from rrtmil_tpu_torch.models import zoo
        model = zoo.build_model("clam_sb", input_dim=1024, device=dev)
        eng = Engine(model, _zoo_engine_cfg("clam_sb"), device=dev)
        rng = np.random.default_rng(3)
        eng.train_epoch(ArrayDataset(
            [rng.standard_normal((n, 1024), dtype=np.float32)
             for n in (937, 2213)], [1, 1]), 0, order=[0, 1])
        p0, p1 = model.instance_classifier_0.weight, \
            model.instance_classifier_1.weight
        if p0 in eng.optimizer.state or p0.grad is not None or \
                int(eng.optimizer.state[p1]["step"]) != 2:
            raise AssertionError("an unselected instance classifier took "
                                 "an optimizer step")
        report["unselected_classifier_state"] = None

        # (d) --dsmil_init
        gen = torch.Generator().manual_seed(4)
        q = {"b_classifier.q.weight": torch.randn((128, 512), generator=gen),
             "b_classifier.q.bias": torch.randn((128,), generator=gen),
             "b_classifier.v.1.weight": torch.randn((4, 4), generator=gen)}
        init_path = os.path.join(tmp, "dsmil_init.pth")
        torch.save(q, init_path)
        dargs = argv("dsmil", "init", "--dsmil_init", init_path)
        dargs[dargs.index("--num_epoch") + 1] = "1"
        d_rep, _, _, first = run("dsmil --dsmil_init", dargs)
        ref = classification.build_model_from_args(
            cli.postprocess_args(cli.build_parser().parse_args(dargs)),
            device="cpu")[0].state_dict()
        changed = sorted({k for f in first for k, v in first[f].items()
                          if not torch.equal(v, ref[k])})
        loaded = all(torch.equal(first[f][k], q[k]) for f in first
                     for k in ("b_classifier.q.weight",
                               "b_classifier.q.bias"))
        log(f"[11] --dsmil_init: weights that differ from the seeded model "
            f"{changed}, q from the file {loaded}")
        if changed != ["b_classifier.q.bias", "b_classifier.q.weight"] or \
                not loaded or len(first) != 2:
            raise AssertionError("--dsmil_init changed other weights")
        report["dsmil_init"] = {"changed": changed, **{
            k: d_rep[k] for k in ("seconds", "launches")}}

        # the CLI as its own process
        out, secs = cli_process("rrtmil_tpu_torch.main",
                                argv("clam_sb", "process"),
                                "the CLI process")
        tail = out.strip().splitlines()[-3:]
        log(f"[11] `python -m rrtmil_tpu_torch.main --model clam_sb "
            f"--only_rrt_enc ...` as its own process: exit code 0, "
            f"{secs:.1f} s; last lines {tail}")
        if "Cross validation auc mean" not in out:
            raise AssertionError(f"the CLI process printed {out[-2000:]}")
        report["process"] = {"returncode": 0, "seconds": secs, "tail": tail}

        # (e) the survival CLI's zoo backbones on phase 10's set
        csv_file, spatches = write_survival_data(os.path.join(tmp, "surv"))
        surv = report["survival_cli"] = {}
        for name in ZOO_SURVIVAL:
            records = []
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meter = run_survival_cli(
                ["--num_epoch", "1", "--seed", "1", "--model", name,
                 "--input_dim", "1024", "--excel_file", csv_file,
                 "--results_dir", os.path.join(tmp, f"s_{name}"),
                 "--device", str(dev)], records)
            secs = time.perf_counter() - t0
            launches = launches_now()
            tr = survival_epoch_summary(records, 0, "train")
            va = survival_epoch_summary(records, 0, "val")
            log(f"[11] survival {name}: {secs:.1f} s, c-index by fold "
                f"{meter.cindex[1:6]}, train {tr['bags_per_s']:.2f} bags/s, "
                f"validation {va['bags_per_s']:.2f} bags/s (first epoch: "
                f"bags read and transferred), launches "
                f"{sum(launches.values())}")
            if any(launches.values()) or len(records) != 5 or not all(
                    np.isfinite(v) for v in meter.cindex[1:]):
                raise AssertionError(f"survival {name}: launches {launches},"
                                     f" c-index {meter.cindex}")
            surv[name] = {"seconds": secs, "launches": launches,
                          "cindex": meter.cindex[1:], "train": tr, "val": va}
    for tag, r in report["cli"].items():
        for e, what in ((0, "first"), (1, "cached")):
            tr, ev = r["epochs"][e]["train"], r["epochs"][e]["eval"]
            log(f"[11] {tag} --only_rrt_enc {what} epoch: train "
                f"{tr['seconds']:.3f} s ({tr['slides_per_s']:.2f} slides/s), "
                f"eval {ev['seconds']:.3f} s ({ev['slides_per_s']:.2f} "
                f"slides/s)")
    report["seconds"] = time.perf_counter() - t_phase
    return report


def phase_zoo(dev):
    """Phase 11: the attention-MIL zoo with the R2T encoder injected."""
    t0 = time.perf_counter()
    report = {"models": phase_zoo_models(dev)}
    report.update(phase_zoo_cli(dev))
    report["seconds"] = time.perf_counter() - t0
    log(f"[11] phase 11: {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# slice 12: TransMIL, IBMIL and the encoder's variants
# ---------------------------------------------------------------------------

TRANSMIL_BAGS = (937, 2213, 9000, 30000)
TRANSMIL_TIMED = (9000, 50000)   # forward / train step, survival step
# TransMIL card vs CPU, float32 with TF32 off: six Newton iterations of the
# pseudo-inverse in each Nystrom layer amplify the two sides' rounding, yet
# on an H100 the two dropout-off steps' losses differed by 4.8e-7 and the
# first step's gradients by 4.9e-7 (scaled), so f32's 1e-4 holds
TRANSMIL_TOL = 1e-4
NO_KERNEL = []
# Nystrom in the R-MSA layers (`--region_attn ntrans`, `--attn ntrans`):
# torch ops there, so only the CR-MSA layer's kernels run
NTRANS_EVAL = [K[2], K[4], K[7]]          # K3, K5, K8
NTRANS_TRAIN = K[2:9]                     # K3-K9
# phase 12 (c): c16_r50 with each encoder variant: (tag, encoder fields,
# evaluate kernels, train kernels); a `pos` is (kind, pos_pos)
ENC_VARIANTS = (
    ("pos_ppeg", {"pos": ("ppeg", -1)}, C16_EVAL, C16_TRAIN),
    ("pos_peg", {"pos": ("peg", -1)}, C16_EVAL, C16_TRAIN),
    ("pos_sincos", {"pos": ("sincos", -1)}, C16_EVAL, C16_TRAIN),
    ("pos_ape", {"pos": ("ape", -1)}, C16_EVAL, C16_TRAIN),
    ("pos_ppeg_3_layers", {"pos": ("ppeg", 0), "n_layers": 3}, C16_EVAL,
     C16_TRAIN),
    ("region_ntrans", {"region_attn": "ntrans"}, NTRANS_EVAL, NTRANS_TRAIN),
    ("attn_ntrans", {"attn_mode": "ntrans"}, NTRANS_EVAL, NTRANS_TRAIN),
)
VARIANT_BAGS = (937, 9000)
VARIANT_TRAIN_BAGS = (937, 2213, 9000, 9000)
# phase 12 (f): a survival set on which most folds save weights (four
# validation cases a fold), 20 cases of 937-9000 patches
RESUME_LENGTHS = tuple(int(v) for v in np.linspace(937, 9000, 20))
CONFOUNDER_K = 4


def transmil_model(dev, dropout=True, seed=0):
    """TransMIL at full width (input 1024), seeded; `dropout=False` turns
    off fc1's dropout and the Nystrom layers' fixed 0.1."""
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.nystrom import NystromAttention
    model = zoo.build_model("transmil", input_dim=1024,
                            dropout=0.25 if dropout else 0.0, device=dev,
                            seed=seed)
    if not dropout:
        for m in model.modules():
            if isinstance(m, NystromAttention):
                m.p = 0.0
    return model


def phase_transmil(dev):
    """Phase 12 (a): TransMIL at full width through the engine's exact mode
    (batch 1, each bag at its true length): Engine.evaluate on bags of
    TRANSMIL_BAGS patches and a dropout-on train_epoch, launching no kernel
    (every counter stays 0); the probabilities against the CPU; two
    dropout-off steps against the CPU (float32, TF32 off, TRANSMIL_TOL); a
    second forward of the same bits; forward and train ms at L = 9000 and a
    survival step (TransMIL under SurvivalHead, the bucket's repr_length as
    the JAX package passes it) at L = 50000, B = 1."""
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.harness.survival import build_survival_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
    from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                    SurvivalEngineConfig)
    rng = np.random.default_rng(12)
    bags = [rng.standard_normal((n, 1024), dtype=np.float32)
            for n in TRANSMIL_BAGS]
    ds = ArrayDataset(bags, [i % 2 for i in range(len(bags))])
    ecfg = EngineConfig(exact=True)
    rep = {}
    model = transmil_model(dev)

    def tokens(eng, x, *a):
        return {"tokens": int(x.shape[1])}
    engine = counting(Engine, tokens)(model, ecfg, device=dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, labs, loss = engine.evaluate(ds)
    rep["eval_seconds"] = time.perf_counter() - t0
    rep["eval_launches"] = launches_now()
    check_launches(engine.records["eval"], NO_KERNEL, "transmil evaluate",
                   len(ds))
    if [r["tokens"] for r in engine.records["eval"]] != list(TRANSMIL_BAGS):
        raise AssertionError("transmil evaluate: bags not at their length")
    cpu = transmil_model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    probs_c, labs_c, loss_c = Engine(cpu, ecfg, device="cpu").evaluate(ds)
    cpu_secs = time.perf_counter() - t0
    diff = float(np.abs(probs - probs_c).max())
    log(f"[12] transmil Engine.evaluate (exact mode) on {TRANSMIL_BAGS}: "
        f"{rep['eval_seconds']:.2f} s (CPU {cpu_secs:.1f} s), launches "
        f"{sum(rep['eval_launches'].values())}, max |probs card - cpu| "
        f"{diff:.3e}, mean loss {loss:.6f} vs {loss_c:.6f}")
    if not (np.isfinite(probs).all() and probs.shape == (len(ds),)) or \
            diff > PROB_TOL or abs(loss - loss_c) > PROB_TOL or \
            not np.array_equal(labs, labs_c):
        raise AssertionError("transmil: card and CPU evaluate disagree")
    rep.update(max_prob_diff=diff, loss=loss, loss_cpu=loss_c)

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_loss = engine.train_epoch(ds, 0, order=list(range(len(ds))))
    torch.cuda.synchronize()
    rep["train_seconds"] = time.perf_counter() - t0
    rep["launches"] = launches_now()
    check_launches(engine.records["train"], NO_KERNEL, "transmil train",
                   len(ds))
    if not np.isfinite(train_loss) or not all(
            torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("transmil: the train epoch is not finite")
    rep["train_loss"] = train_loss
    model.eval()
    x = torch.from_numpy(bags[2][None]).to(dev)
    with torch.no_grad():
        a, b = model(x), model(x)
    if not torch.equal(a, b):
        raise AssertionError("transmil: a second forward gave other bits")
    log(f"[12] transmil train epoch (dropout on): loss {train_loss:.6f} in "
        f"{rep['train_seconds']:.2f} s, launches "
        f"{sum(rep['launches'].values())}; a second forward the same bits")
    del engine, cpu
    rep["vs_cpu"] = train_steps_vs_cpu(
        lambda d, mm: (transmil_model(d, dropout=False), None), ecfg,
        ArrayDataset(bags[:2], [1, 0]), dev, "transmil", "12", NO_KERNEL,
        tols=(("float32", TRANSMIL_TOL),))

    # times: forward and train step at L = 9000, a survival step at 50000
    n, n_surv = TRANSMIL_TIMED
    x = torch.from_numpy(rng.standard_normal((1, n, 1024),
                                             dtype=np.float32)).to(dev)
    mask = torch.ones((1, n), dtype=torch.bool, device=dev)
    labels = torch.tensor([1], device=dev)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(x, length=n), iters=10, warmup=2)
    eng = Engine(model, EngineConfig(exact=True), device=dev)
    eng.model.train()

    def step():
        eng._train_step(x, mask, labels, n)
        eng._apply_grads(eng.cfg.lr)
    train_ms = time_ms(step, iters=5, warmup=2)
    del eng, model
    torch.cuda.empty_cache()
    head, enc16 = build_survival_model("TransMIL", 1024, device=dev)
    surv = SurvivalEngine(head, SurvivalEngineConfig(), enc16, device=dev)
    surv.model.train()
    bag = _randn((n_surv, 1024), _gen(n_surv)).numpy()
    sx, smask, spec = surv._prep(bag)
    label, cens = torch.tensor([1], device=dev), torch.tensor([0.0],
                                                              device=dev)
    torch.cuda.reset_peak_memory_stats()
    surv_ms = time_ms(lambda: surv._train_step(sx, smask, label, cens,
                                               spec.repr_length),
                      iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rep["times"] = {"length": n, "forward_ms": fwd_ms, "train_ms": train_ms,
                    "survival_length": n_surv, "survival_step_ms": surv_ms,
                    "survival_tokens": spec.repr_length,
                    "survival_peak_mem_gib": peak}
    log(f"[12] transmil L={n} B=1: forward {fwd_ms:.3f} ms "
        f"({1e3 / fwd_ms:.2f} slides/s), train step {train_ms:.3f} ms; "
        f"survival train step at L={n_surv} ({spec.repr_length} rows: the "
        f"bucket's repr_length) {surv_ms:.3f} ms, peak {peak:.2f} GiB "
        f"({nvidia_smi_line()})")
    del surv
    torch.cuda.empty_cache()
    return rep


def phase_transmil_ibmil_cli(dev, tmp):
    """Phase 12 (d) and (b): on phase 9's 12 synthetic bags in `tmp`, 2
    folds x 2 epochs: `rrtmil_tpu_torch.main --model transmil` launches no
    kernel and never touches the device cache; `python -m
    rrtmil_tpu_torch.build_confounders` (in this process, AB-MIL: no
    kernel) writes each fold's prototypes on the card; (b) IBMIL with
    c16_r50's encoder and fold 0's prototypes through zoo_model_checks;
    `--model ibmil --only_rrt_enc --confounder_path` launches K1-K9 and no
    other kernel, the second epoch all from the device cache."""
    from rrtmil_tpu_torch import build_confounders
    from rrtmil_tpu_torch.harness import classification
    report = {}
    root = os.path.join(tmp, "c16")
    patches = write_cli_data(root, False, 1024, 0)
    log(f"[12] wrote {CLI_BAGS} bags ({patches} patches)")

    def run(tag, args, expect, cached):
        stats = []
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_cli(args + CLI_RUN + CLI_C16 + [
            "--dataset_root", root, "--model_path", os.path.join(tmp, "out"),
            "--title", tag], stats)
        secs = time.perf_counter() - t0
        launches = launches_now()
        ran = [n for n, v in launches.items() if v]
        summary = {e: epoch_summary(stats, e) for e in (0, 1)}
        log(f"[12] {tag}: {secs:.1f} s, test AUC {metrics['auc']}, "
            f"launches {launches}")
        if ran != expect:
            raise AssertionError(f"{tag} ran {ran}, not {expect}")
        for e, summ in summary.items():
            for k, r in summ.items():
                hits = r["cache_hits"] + r["cache_misses"]
                if (cached and e == 1 and (r["cache_misses"] or
                                           r["cache_hits"] != r["bags"])) \
                        or (not cached and hits):
                    raise AssertionError(f"{tag}: epoch {e} {k} cache "
                                         f"{r}")
        if not all(np.isfinite(metrics[k]).all() for k in metrics):
            raise AssertionError(f"{tag}: metrics {metrics}")
        for e, what in ((0, "first"), (1, "cached" if cached else "second")):
            tr, ev = summary[e]["train"], summary[e]["eval"]
            log(f"[12] {tag} {what} epoch: train {tr['seconds']:.3f} s "
                f"({tr['slides_per_s']:.2f} slides/s), eval "
                f"{ev['seconds']:.3f} s ({ev['slides_per_s']:.2f} slides/s)"
                f", cache {tr['cache_hits'] + ev['cache_hits']} hits")
        return {"seconds": secs, "launches": launches, "metrics": metrics,
                "epochs": summary}

    report["transmil"] = run("transmil", ["--model", "transmil"], NO_KERNEL,
                             False)
    conf_dir = os.path.join(tmp, "conf")
    reset_counters()
    t0 = time.perf_counter()
    paths = build_confounders.main(CLI_RUN + CLI_C16 + [
        "--dataset_root", root, "--model_path", os.path.join(tmp, "out"),
        "--title", "confounders", "--confounder_out", conf_dir,
        "--confounder_epochs", "2", "--confounder_k", str(CONFOUNDER_K)])
    secs = time.perf_counter() - t0
    protos = [np.load(p) for p in paths]
    args = types.SimpleNamespace(confounder_path=conf_dir,
                                 confounder_k=CONFOUNDER_K)
    log(f"[12] python -m rrtmil_tpu_torch.build_confounders: {secs:.1f} s, "
        f"wrote {paths}, launches {sum(launches_now().values())}")
    if any(launches_now().values()) or paths != [
            classification.confounder_file(args, f) for f in range(2)] or \
            not all(p.shape == (CONFOUNDER_K, 512) and np.isfinite(p).all()
                    for p in protos):
        raise AssertionError("build_confounders failed")
    report["build_confounders"] = {"seconds": secs, "paths": paths}

    ds, cpu_ds = zoo_datasets()
    report["ibmil_models"] = zoo_model_checks("ibmil", dev, ds, cpu_ds,
                                              protos[0], ph="12")
    report["ibmil"] = run("ibmil", [
        "--model", "ibmil", "--only_rrt_enc", "--confounder_path", conf_dir,
        "--confounder_k", str(CONFOUNDER_K)], C16_TRAIN, True)
    return report


def phase_variants(dev):
    """Phase 12 (c): c16_r50 with each encoder variant of ENC_VARIANTS, the
    three checks of phase 3: Engine.evaluate on VARIANT_BAGS against the
    CPU, a dropout-on train_epoch on VARIANT_TRAIN_BAGS, two dropout-off
    steps against the CPU (f32 and bf16 products; Nystrom inside the
    regions in f32 alone, its CPU side taking ~12 s a step), each batch and
    step through its kernels and no other."""
    import dataclasses
    from rrtmil_tpu_torch.config import PosEmbedConfig, c16_r50
    out = {}
    base = c16_r50()
    for tag, fields, ev, tr in ENC_VARIANTS:
        t0 = time.perf_counter()
        fields = dict(fields)
        if "pos" in fields:
            kind, pos_pos = fields["pos"]
            fields["pos"] = PosEmbedConfig(kind=kind, pos_pos=pos_pos)
        cfg = dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, **fields))
        out[tag] = {
            "evaluate": phase_main_path(dev, cfg, VARIANT_BAGS, tag, "12",
                                        ev),
            "train": phase_train(dev, cfg, VARIANT_TRAIN_BAGS, tag, "12", tr),
            "train_vs_cpu": phase_train_vs_cpu(
                dev, cfg, tag, "12", tr,
                ("float32",) if tag == "region_ntrans"
                else ("float32", "bfloat16"))}
        out[tag]["seconds"] = time.perf_counter() - t0
        log(f"[12] {tag}: {out[tag]['seconds']:.1f} s")
    return out


def survival_cli_run(dev, tmp, tag, flags, csv, epochs, ph,
                     engine="SurvivalEngine"):
    """`rrtmil_tpu_torch.survival_main` in this process on `csv`, 5 folds x
    `epochs`, seed 1, input 1024, results under `tmp`, the harness's
    `engine` class measured by survival_cli_engine and every counter set to
    0 just before: (its report, its results directory)."""
    records = []
    out = os.path.join(tmp, "s_" + tag)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meter = run_survival_cli(
        ["--num_epoch", str(epochs), "--seed", "1", "--input_dim", "1024",
         "--excel_file", csv, "--results_dir", out, "--device", str(dev)]
        + flags, records, engine)
    secs = time.perf_counter() - t0
    launches = launches_now()
    if len(records) != 5 or not all(np.isfinite(v)
                                    for v in meter.cindex[1:]):
        raise AssertionError(f"survival {tag}: c-index {meter.cindex}")
    log(f"[{ph}] survival {tag}: {secs:.1f} s")
    return {"seconds": secs, "launches": launches,
            "cindex": meter.cindex[1:], "records": records}, out


def check_evaluate_resume(dev, tmp, name, csv, ph, engine="SurvivalEngine"):
    """`--model name`, 5 folds x 2 epochs on `csv`, then --evaluate --resume
    over its results: every fold that saved weights (at least two)
    reproduces its best c-index and validation loss exactly."""
    rep, out = survival_cli_run(dev, tmp, name + "_resume", ["--model", name],
                                csv, 2, ph, engine)
    ev, _ = survival_cli_run(dev, tmp, name + "_evaluate", [
        "--model", name, "--evaluate", "--resume", out], csv, 1, ph, engine)
    saved = [bool(os.listdir(os.path.join(out, f"fold_{k}")))
             for k in range(5)]
    best = [f["best"] for f in rep["records"]]
    best_loss = [[r["loss"] for r in f["epochs"] if r["kind"] == "val"
                  and r["epoch"] == f["best"][1]][0]
                 for f in rep["records"]]
    got = [(f["val_ci"][0], f["epochs"][0]["loss"]) for f in ev["records"]]
    log(f"[{ph}] {name} --evaluate --resume: (c-index, loss) by fold "
        f"{got} against the run's best {[b[0] for b in best]} and "
        f"losses {best_loss}; weights saved for folds "
        f"{[k for k in range(5) if saved[k]]}")
    if sum(saved) < 2 or any(
            s and g != (b[0], bl)
            for s, g, b, bl in zip(saved, got, best, best_loss)):
        raise AssertionError(f"{name}: --evaluate --resume does not "
                             f"reproduce every saved fold")
    return {"saved": saved, "best": best, "best_loss": best_loss,
            "evaluate": got, "train_launches": rep["launches"],
            "launches": ev["launches"]}


def phase_survival_transmil_ibmil(dev, tmp):
    """Phase 12 (e) and (f): (e) the survival CLI's TransMIL and IBMIL on
    phase 10's set (up to 50000 patches), 5 folds x 1 epoch, launching no
    kernel; (f) RRTMIL and TransMIL, 5 folds x 2 epochs, on RESUME_LENGTHS'
    20 cases, then --evaluate --resume: every fold that saved weights (at
    least two) reproduces its best c-index and validation loss exactly."""
    report = {}
    t0 = time.perf_counter()
    csv_file, patches = write_survival_data(os.path.join(tmp, "surv"))
    log(f"[12] wrote phase 10's survival set ({patches} patches) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("TransMIL", "IBMIL"):
        rep, _ = survival_cli_run(dev, tmp, name, ["--model", name],
                                  csv_file, 1, "12")
        tr = survival_epoch_summary(rep["records"], 0, "train")
        va = survival_epoch_summary(rep["records"], 0, "val")
        log(f"[12] survival {name}: {rep['seconds']:.1f} s, c-index by fold "
            f"{rep['cindex'][:5]}, train {tr['bags_per_s']:.2f} bags/s, "
            f"validation {va['bags_per_s']:.2f} bags/s (first epoch), "
            f"launches {sum(rep['launches'].values())}")
        if any(rep["launches"].values()):
            raise AssertionError(f"survival {name} launched "
                                 f"{rep['launches']}")
        report[name] = {"seconds": rep["seconds"], "cindex": rep["cindex"],
                        "train": tr, "val": va, "launches": rep["launches"]}

    t0 = time.perf_counter()
    csv20, patches = write_survival_data(os.path.join(tmp, "surv20"),
                                         lengths=RESUME_LENGTHS, seed=5)
    log(f"[12] wrote {len(RESUME_LENGTHS)} survival cases ({patches} "
        f"patches) in {time.perf_counter() - t0:.1f} s")
    for name in ("RRTMIL", "TransMIL"):
        report[name + "_evaluate_resume"] = check_evaluate_resume(
            dev, tmp, name, csv20, "12")
    return report


def phase_slice12(dev):
    """Phase 12: TransMIL, IBMIL and the encoder's variants."""
    import tempfile
    t0 = time.perf_counter()
    report = {"transmil": phase_transmil(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        report["cli"] = phase_transmil_ibmil_cli(dev, tmp)
    report["variants"] = phase_variants(dev)
    with tempfile.TemporaryDirectory() as tmp:
        report["survival"] = phase_survival_transmil_ibmil(dev, tmp)
    report["seconds"] = time.perf_counter() - t0
    log(f"[12] phase 12: {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# slice 13: DTFD and MHIM-MIL
# ---------------------------------------------------------------------------

DTFD_CLS_BAGS = (937, 9000, 30000)
DTFD_SURV_BAGS = (937, 9000, 50000)
MHIM_BAGS = (937, 9000, 50000)
# 'selfattn': 95 x 95 tokens (PPEG runs) and 937 (it does not)
SELFATTN_TOKENS = (9025, 937)
SLICE13_TIMED = (9000, 50000)
# card vs CPU, f32 with TF32 off: losses, probabilities, risks, features
SLICE13_TOL = 1e-4
# gradients that are zero in exact arithmetic, so rounding noise on both
# sides (a whole softmax row's shift: DTFD's scorers' last bias), held to
# Adam's drift bound alone
SLICE13_NOISE = ("attention_weights.bias",)
# `--model` names of both CLIs and the harness engine class each uses
CLI13_SURVIVAL = (("DTFD", "DTFDSurvivalEngine"),
                  ("MHIM-MIL", "MHIMSurvivalEngine"))


def _bags13(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 1024), dtype=np.float32)
            for n in lengths]


def _cpu_copy(model, cpu):
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def _no_launch(what):
    """Every counter still 0 since the last reset_counters()."""
    launches = launches_now()
    if any(launches.values()):
        raise AssertionError(f"{what} launched {launches}")
    return launches


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _recording(engine_cls):
    """`engine_cls` keeping each train step's loss (`step_losses`) and each
    epoch's or validation's (summed loss, risks) (`synced`)."""
    class Recording(engine_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_losses, self.synced = [], []

        def _train_step(self, *a, **k):
            out = super()._train_step(*a, **k)
            self.step_losses.append(float(out[0]))
            return out

        def _sync_meters(self, losses, risks):
            out = super()._sync_meters(losses, risks)
            self.synced.append(out)
            return out
    return Recording


def _steps13(dev, tag, make_engine, ds, run, lr, extra=None):
    """Two dropout-off steps on the card and on the CPU from the same
    weights (`make_engine(device, state)`, state None on the card, the
    card's initial weights on the CPU; `run(engine)` trains them):
    no kernel on the card, the step losses within SLICE13_TOL, every
    parameter (and `extra(engine)`'s, the EMA teacher's) within Adam's
    drift bound."""
    runs, state = {}, None
    for key, d in (("card", dev), ("cpu", "cpu")):
        eng = make_engine(d, state)
        if state is None:
            state = {k: v.detach().cpu().clone()
                     for k, v in eng.model.state_dict().items()}
        reset_counters()
        run(eng)
        if key == "card":
            _no_launch(f"{tag} dropout-off steps")
        named = {n: p.detach().float().cpu()
                 for n, p in eng.model.named_parameters()}
        if extra is not None:
            named.update({"teacher." + n: p.detach().float().cpu()
                          for n, p in extra(eng).named_parameters()})
        runs[key] = (eng.step_losses, named)
    (cl, cp), (ul, up) = runs["card"], runs["cpu"]
    dloss = max(abs(a - b) for a, b in zip(cl, ul))
    ok_p, dparam, frac = _zoo_params_close(cp, up, lr, 2, 1e-3,
                                           SLICE13_NOISE)
    shares = {n: ((cp[n] - up[n]).abs() > 1e-5 + 1e-4 * up[n].abs())
              .float().mean().item() for n in cp
              if not n.endswith(SLICE13_NOISE)}
    most = max(shares, key=shares.get)
    ok = len(cl) == len(ul) == 2 and ok_p and \
        dloss <= SLICE13_TOL * max(1.0, max(map(abs, ul)))
    log(f"[13] {tag} two dropout-off steps, card vs CPU: losses "
        f"{np.round(cl, 6).tolist()} vs {np.round(ul, 6).tolist()} (max "
        f"diff {dloss:.3e}); parameters after both max diff {dparam:.3e}, "
        f"share past 1e-5 {frac:.2e} (most in {most}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: card and CPU steps disagree")
    return {"card_losses": cl, "cpu_losses": ul, "loss_diff": dloss,
            "param_max_diff": dparam, "param_share_past": frac}


def dtfd_model(dev, surv, distill="MaxMinS", dropout=True):
    """DTFD at full width (input 1024, inner 512), seed 0: classification
    (numGroup 4, 2 classes, one instance a pseudo-bag each way) or survival
    (group 8, 4 classes); `dropout=False` sets its fixed rate to 0."""
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.dtfd import DTFD
    kw = dict(n_classes=4, group=8) if surv else dict(n_classes=2, group=4)
    model = zoo.seeded(DTFD(input_dim=1024, survival=surv, distill=distill,
                            **kw), dev, 0)
    if not dropout:
        model.p = 0.0
    return model


def phase_dtfd_cls(dev):
    """Phase 13 (a): DTFDClassificationEngine (AFS and MaxMinS) on bags of
    DTFD_CLS_BAGS patches: `evaluate` twice (the same bits) and against
    the CPU with the same permutations (SLICE13_TOL), a dropout-on
    `train_epoch`, a train forward and backward twice of the same bits,
    two dropout-off steps against the CPU; no kernel on any path."""
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.harness.dtfd_cls import DTFDClassificationEngine
    from rrtmil_tpu_torch.train.engine import EngineConfig
    bags = _bags13(DTFD_CLS_BAGS, 13)
    ds = ArrayDataset(bags, [i % 2 for i in range(len(bags))])
    out = {}
    for distill in ("AFS", "MaxMinS"):
        rep = out[distill] = {}
        model = dtfd_model(dev, False, distill)
        eng = DTFDClassificationEngine(model, EngineConfig(), device=dev)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, labs, loss = eng.evaluate(ds)
        rep["eval_seconds"] = time.perf_counter() - t0
        rep["eval_launches"] = _no_launch(f"dtfd {distill} evaluate")
        again = eng.evaluate(ds)
        if not (np.array_equal(probs, again[0]) and loss == again[2]):
            raise AssertionError(f"dtfd {distill}: a second evaluate gave "
                                 f"other bits")
        cpu = _cpu_copy(model, dtfd_model("cpu", False, distill))
        probs_c, labs_c, loss_c = DTFDClassificationEngine(
            cpu, EngineConfig(), device="cpu").evaluate(ds)
        diff = float(np.abs(probs - probs_c).max())
        log(f"[13] dtfd {distill} evaluate on {DTFD_CLS_BAGS}: "
            f"{rep['eval_seconds']:.2f} s, max |probs card - cpu| "
            f"{diff:.3e}, mean loss {loss:.6f} vs {loss_c:.6f}")
        if not (np.isfinite(probs).all() and probs.shape == (len(ds),)) or \
                diff > SLICE13_TOL or abs(loss - loss_c) > SLICE13_TOL or \
                not np.array_equal(labs, labs_c):
            raise AssertionError(f"dtfd {distill}: card and CPU evaluate "
                                 f"disagree")
        rep.update(max_prob_diff=diff, loss=loss, loss_cpu=loss_c)

        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_loss = eng.train_epoch(ds, 0, order=list(range(len(ds))))
        torch.cuda.synchronize()
        rep["train_seconds"] = time.perf_counter() - t0
        rep["launches"] = _no_launch(f"dtfd {distill} train epoch")
        if not np.isfinite(train_loss) or not all(
                torch.isfinite(p).all() for p in model.parameters()):
            raise AssertionError(f"dtfd {distill}: the train epoch is not "
                                 f"finite")
        rep["train_loss"] = train_loss

        quiet = dtfd_model(dev, False, distill, dropout=False)
        x, mask, labels, spec = eng._make_batch(ds, [1])
        ce = torch.nn.functional.cross_entropy

        def loss_fn():
            pl, bl = quiet(x, mask=mask, length=spec.repr_length, train=True)
            return ce(pl, labels.expand(pl.shape[0])) + ce(bl, labels)
        rep["bits_checked_tensors"] = _grad_bits(quiet, loss_fn,
                                                 f"dtfd {distill}")

        def make(d, state):
            m = dtfd_model(d, False, distill, dropout=False)
            if state is not None:
                m.load_state_dict(state)
            return _recording(DTFDClassificationEngine)(
                m, EngineConfig(), device=d)
        rep["vs_cpu"] = _steps13(
            dev, f"dtfd {distill}", make, ds,
            lambda e: e.train_epoch(ds, 0, order=[0, 1]), EngineConfig().lr)
        log(f"[13] dtfd {distill}: train epoch (dropout on) loss "
            f"{train_loss:.6f} in {rep['train_seconds']:.2f} s, a second "
            f"forward and backward the same bits "
            f"({rep['bits_checked_tensors']} gradients)")
    return out


def _surv_ds13(lengths, seed):
    from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
    n = len(lengths)
    return ArraySurvivalDataset(_bags13(lengths, seed),
                                np.linspace(200.0, 1800.0, n),
                                [1 - (i % 2) for i in range(n)])


def _survival_vs_cpu(tag, eng, cpu_eng, ds):
    """`validate` over every bag of `ds` on the card (twice: the same bits)
    and on the CPU: the summed loss and every risk within SLICE13_TOL, the
    same c-index; no kernel on the card."""
    idx = list(range(len(ds)))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, ci = eng.validate(ds, idx)
    secs = time.perf_counter() - t0
    launches = _no_launch(f"{tag} validate")
    eng.validate(ds, idx)
    (s1, r1), (s2, r2) = eng.synced[-2:]
    if s1 != s2 or not np.array_equal(r1, r2):
        raise AssertionError(f"{tag}: a second validate gave other bits")
    loss_c, ci_c = cpu_eng.validate(ds, idx)
    (sc, rc) = cpu_eng.synced[-1]
    dr = _scaled(r1, rc)
    log(f"[13] {tag} validate on {[b.shape[0] for b in ds._bags]}: "
        f"{secs:.2f} s, loss {loss:.6f} vs CPU {loss_c:.6f}, risks scaled "
        f"{dr:.3e}, c-index {ci} vs {ci_c}")
    if abs(loss - loss_c) > SLICE13_TOL * max(1.0, abs(loss_c)) or \
            dr > SLICE13_TOL or ci != ci_c or not np.isfinite(loss):
        raise AssertionError(f"{tag}: card and CPU validate disagree")
    return {"seconds": secs, "launches": launches, "loss": loss,
            "loss_cpu": loss_c, "risk_scaled_err": dr, "cindex": ci}


def phase_dtfd_survival(dev):
    """Phase 13 (b): DTFDSurvivalEngine (group 8, MaxMinS, 4 classes) on
    bags of DTFD_SURV_BAGS patches: `validate` (each bag's permutation)
    twice and against the CPU, a dropout-on `train_epoch`, a train forward
    and backward twice of the same bits, two dropout-off surrogate steps
    against the CPU; no kernel on any path."""
    from rrtmil_tpu_torch.harness.survival import (DTFDSurvivalEngine,
                                                   build_survival_model)
    from rrtmil_tpu_torch.train.losses import nll_surv_loss
    from rrtmil_tpu_torch.train.surv_engine import SurvivalEngineConfig
    ds = _surv_ds13(DTFD_SURV_BAGS, 13)
    model, enc = build_survival_model("DTFD", 1024, device=dev)
    cls = _recording(DTFDSurvivalEngine)
    eng = cls(model, SurvivalEngineConfig(), enc, device=dev)
    cpu = _cpu_copy(model, build_survival_model("DTFD", 1024,
                                                device="cpu")[0])
    rep = {"validate": _survival_vs_cpu(
        "dtfd survival", eng, cls(cpu, SurvivalEngineConfig(), enc,
                                  device="cpu"), ds)}
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = eng.train_epoch(ds, list(range(len(ds))), 0)
    torch.cuda.synchronize()
    rep["train_seconds"] = time.perf_counter() - t0
    rep["launches"] = _no_launch("dtfd survival train epoch")
    if not np.isfinite(loss):
        raise AssertionError("dtfd survival: the train epoch is not finite")
    rep["train_loss"] = loss

    quiet = dtfd_model(dev, True, dropout=False)
    x, mask, spec = eng._prep(ds._bags[1])
    lab = torch.tensor([1], device=dev)
    cen = torch.tensor([0.0], device=dev)

    def loss_fn():
        ph, ps_, hz, s = quiet(x, mask=mask, length=spec.repr_length,
                               train=True)
        return nll_surv_loss(ph, ps_, lab.expand(8), cen.expand(8)) + \
            nll_surv_loss(hz, s, lab, cen)
    rep["bits_checked_tensors"] = _grad_bits(quiet, loss_fn, "dtfd survival")

    def make(d, state):
        m, e = build_survival_model("DTFD", 1024, device=d)
        m.p = 0.0
        if state is not None:
            m.load_state_dict(state)
        return cls(m, SurvivalEngineConfig(), e, device=d)
    two = _surv_ds13(DTFD_SURV_BAGS[:2], 14)
    rep["vs_cpu"] = _steps13(dev, "dtfd survival", make, two,
                             lambda e: e.train_epoch(two, [0, 1], 0),
                             SurvivalEngineConfig().lr)
    log(f"[13] dtfd survival train epoch (dropout on) loss {loss:.6f} in "
        f"{rep['train_seconds']:.2f} s; a second forward and backward the "
        f"same bits ({rep['bits_checked_tensors']} gradients)")
    return rep


def phase_mhim(dev):
    """Phase 13 (c): MHIMSurvivalEngine ('attn') on bags of MHIM_BAGS
    patches: the teacher's bag feature and raw attention on each bag
    against the CPU (SLICE13_TOL), `validate` twice and against the CPU, a
    dropout-on `train_epoch` (the teacher moves), and two dropout-off
    student steps against the CPU with the keep-masks the card built handed
    to the CPU: losses within SLICE13_TOL, the student and the EMA teacher
    within Adam's drift bound; no kernel on any path."""
    from rrtmil_tpu_torch.harness.survival import (MHIMSurvivalEngine,
                                                   build_survival_model)
    from rrtmil_tpu_torch.models import mhim
    from rrtmil_tpu_torch.train.surv_engine import SurvivalEngineConfig
    ds = _surv_ds13(MHIM_BAGS, 15)
    cls = _recording(MHIMSurvivalEngine)
    model, enc = build_survival_model("MHIM-MIL", 1024, device=dev)
    cfg = SurvivalEngineConfig()
    eng = cls(model, cfg, enc, device=dev, niter_per_ep=len(ds))
    cpu_model = _cpu_copy(model, build_survival_model(
        "MHIM-MIL", 1024, device="cpu")[0])
    cpu_eng = cls(cpu_model, cfg, enc, device="cpu", niter_per_ep=len(ds))
    rep = {"teacher": []}
    reset_counters()
    for bag in ds._bags:
        got = []
        for e in (eng, cpu_eng):
            x, mask, spec = e._prep(bag)
            with torch.no_grad():
                _, feat, attn = e.teacher(x, mask=mask,
                                          length=spec.repr_length,
                                          return_attn=True, return_feat=True)
            got.append((feat.cpu().numpy(), attn.cpu().numpy()))
        d = {"length": bag.shape[0], "feature": _scaled(got[0][0],
                                                        got[1][0]),
             "attention": _scaled(got[0][1], got[1][1])}
        rep["teacher"].append(d)
        if max(d["feature"], d["attention"]) > SLICE13_TOL:
            raise AssertionError(f"mhim teacher: card and CPU disagree {d}")
    rep["teacher_launches"] = _no_launch("mhim teacher")
    log(f"[13] mhim teacher card vs CPU (scaled): {rep['teacher']}")
    rep["validate"] = _survival_vs_cpu("mhim", eng, cpu_eng, ds)

    before = [p.detach().clone() for p in eng.teacher.parameters()]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = eng.train_epoch(ds, list(range(len(ds))), 0)
    torch.cuda.synchronize()
    rep["train_seconds"] = time.perf_counter() - t0
    rep["launches"] = _no_launch("mhim train epoch")
    moved = max((p - q).abs().max().item()
                for p, q in zip(eng.teacher.parameters(), before))
    if not np.isfinite(loss) or not moved > 0 or eng._iter != len(ds):
        raise AssertionError(f"mhim train epoch: loss {loss}, teacher "
                             f"moved {moved}, step {eng._iter}")
    rep.update(train_loss=loss, teacher_moved=moved)
    log(f"[13] mhim train epoch (dropout on) on {MHIM_BAGS}: loss "
        f"{loss:.6f} in {rep['train_seconds']:.2f} s, the teacher moved by "
        f"up to {moved:.3e}")

    masks = []
    build = mhim.build_keep_mask

    def record(*a, **k):
        keep = build(*a, **k)
        masks.append(keep.cpu())
        return keep

    def replay(*a, **k):
        keep = masks[replay.n]
        replay.n += 1
        return keep
    replay.n = 0

    def make(d, state):
        m, e = build_survival_model("MHIM-MIL", 1024, device=d)
        m.p = 0.0
        if state is not None:
            m.load_state_dict(state)
        mhim.build_keep_mask = record if state is None else replay
        return cls(m, cfg, e, device=d, niter_per_ep=2)
    two = _surv_ds13(MHIM_BAGS[:2], 16)
    try:
        rep["vs_cpu"] = _steps13(
            dev, "mhim", make, two, lambda e: e.train_epoch(two, [0, 1], 0),
            cfg.lr, extra=lambda e: e.teacher)
    finally:
        mhim.build_keep_mask = build
    if replay.n != 2:
        raise AssertionError("mhim: the CPU steps did not take the card's "
                             "keep-masks")
    rep["kept"] = [int(m.sum()) for m in masks]
    return rep


def phase_selfattn(dev):
    """Phase 13 (d): MHIM 'selfattn' (input 1024, dropout off) evaluated at
    SELFATTN_TOKENS tokens on the card, twice (the same bits), and on the
    CPU: logits and bag feature within SLICE13_TOL; no kernel."""
    from rrtmil_tpu_torch.models import mhim, zoo
    model = zoo.seeded(mhim.MHIM(input_dim=1024, dropout=0.0,
                                 baseline="selfattn"), dev, 0)
    cpu = _cpu_copy(model, mhim.MHIM(input_dim=1024, dropout=0.0,
                                     baseline="selfattn").eval())
    rep = {}
    reset_counters()
    for n, bag in zip(SELFATTN_TOKENS, _bags13(SELFATTN_TOKENS, 17)):
        x = torch.from_numpy(bag[None])
        with torch.no_grad():
            a = model(x.to(dev), return_feat=True)
            b = model(x.to(dev), return_feat=True)
            c = cpu(x, return_feat=True)
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"selfattn at {n}: a second call gave "
                                 f"other bits")
        errs = [_scaled(u.cpu().numpy(), v.numpy()) for u, v in zip(a, c)]
        rep[n] = {"logits": errs[0], "feature": errs[1]}
        if max(errs) > SLICE13_TOL:
            raise AssertionError(f"selfattn at {n}: card and CPU disagree "
                                 f"{errs}")
    rep["launches"] = _no_launch("mhim selfattn")
    log(f"[13] mhim selfattn card vs CPU (scaled) by token count: {rep}")
    return rep


def phase_times13(dev):
    """Phase 13 (g): DTFD's (classification, MaxMinS) eval forward and
    train step at L = 9000, MHIM's train step (teacher, keep-mask, student,
    Adam, EMA) at L = 9000 and 50000, CUDA events."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.config import RRTEncoderConfig
    from rrtmil_tpu_torch.harness.dtfd_cls import (DTFDClassificationEngine,
                                                   eval_permutation)
    from rrtmil_tpu_torch.harness.survival import (MHIMSurvivalEngine,
                                                   build_survival_model)
    from rrtmil_tpu_torch.train.engine import EngineConfig
    from rrtmil_tpu_torch.train.surv_engine import SurvivalEngineConfig
    n, n_long = SLICE13_TIMED
    spec = bucket_for(n, RRTEncoderConfig())
    x = torch.zeros((1, spec.data_length, 1024), device=dev)
    x[0, :n] = _randn((n, 1024), _gen(n)).to(dev)
    mask = torch.arange(spec.data_length, device=dev)[None] < n
    perm = eval_permutation(np.random.default_rng(0), n, spec.repr_length)
    model = dtfd_model(dev, False)
    eng = DTFDClassificationEngine(model, EngineConfig(), device=dev)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(x, mask=mask, length=spec.repr_length,
                                       eval_perm=perm), iters=10, warmup=2)
    labels = torch.tensor([1], device=dev)
    model.train()

    def step():
        eng._train_step(x, mask, labels, spec.repr_length)
        eng._apply_grads(eng.cfg.lr)
    train_ms = time_ms(step, iters=10, warmup=2)
    rep = {"dtfd": {"length": n, "tokens": spec.repr_length,
                    "forward_ms": fwd_ms, "train_ms": train_ms}}
    del eng, model
    head, enc16 = build_survival_model("MHIM-MIL", 1024, device=dev)
    surv = MHIMSurvivalEngine(head, SurvivalEngineConfig(), enc16,
                              device=dev)
    surv.model.train()
    label, cens = torch.tensor([1], device=dev), torch.tensor([0.0],
                                                              device=dev)
    rep["mhim"] = {}
    for length in (n, n_long):
        sx, smask, sspec = surv._prep(_randn((length, 1024),
                                             _gen(length)).numpy())
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: surv._train_step(sx, smask, label, cens,
                                              sspec.repr_length),
                     iters=5, warmup=2)
        rep["mhim"][length] = {
            "tokens": sspec.repr_length, "step_ms": ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[13] dtfd L={n} ({spec.repr_length} rows) B=1: eval forward "
        f"{fwd_ms:.3f} ms, train step {train_ms:.3f} ms; mhim train step "
        + ", ".join(f"L={k} ({v['tokens']} rows) {v['step_ms']:.3f} ms, peak "
                    f"{v['peak_mem_gib']:.2f} GiB"
                    for k, v in rep["mhim"].items())
        + f" ({nvidia_smi_line()})")
    del surv
    torch.cuda.empty_cache()
    return rep


def phase_cli13(dev):
    """Phase 13 (f): `rrtmil_tpu_torch.main --model dtfd` on phase 9's 12
    bags (2 folds x 2 epochs) in this process (each epoch measured to its
    last sync: first against cached train and eval slides/s, the second
    epoch all from the device cache, no kernel) and as a process of its
    own, and `survival_main --model DTFD` and
    `--model MHIM-MIL` on phase 10's set (5 folds x 1 epoch), each a process
    of its own that exits 0, their train (and validation) rates read from
    their logs; then, in this process on phase 12 (f)'s 20 cases, DTFD and
    MHIM-MIL 5 folds x 2 epochs and --evaluate --resume: every fold that
    saved weights reproduces its best c-index and validation loss exactly,
    launching no kernel."""
    import re
    import tempfile
    from rrtmil_tpu_torch import main as cli
    from rrtmil_tpu_torch.harness import classification
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "c16")
        write_cli_data(root, False, 1024, 0)
        argv = ["--model", "dtfd"] + CLI_RUN + [
            "--input_dim", "1024", "--dataset_root", root, "--model_path",
            os.path.join(tmp, "out"), "--title", "dtfd"]
        stats = []
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_cli(argv, stats, name="DTFDClassificationEngine")
        secs = time.perf_counter() - t0
        summary = {e: epoch_summary(stats, e) for e in (0, 1)}
        rep["dtfd_in_process"] = {
            "seconds": secs, "launches": _no_launch("main --model dtfd"),
            "metrics": metrics, "epochs": summary}
        later = summary[1]
        if any(later[k]["cache_misses"] or later[k]["cache_hits"]
               != later[k]["bags"] for k in later) or not all(
                np.isfinite(metrics[k]).all() for k in metrics):
            raise AssertionError(f"main --model dtfd: epoch 1 {later}, "
                                 f"metrics {metrics}")
        for e, what in ((0, "first"), (1, "cached")):
            tr, ev = summary[e]["train"], summary[e]["eval"]
            log(f"[13] main --model dtfd (in this process) {what} epoch: "
                f"train {tr['seconds']:.3f} s ({tr['slides_per_s']:.2f} "
                f"slides/s), eval {ev['seconds']:.3f} s "
                f"({ev['slides_per_s']:.2f} slides/s)")
        splits = classification.make_splits(cli.postprocess_args(
            cli.build_parser().parse_args(argv)))
        out, secs = cli_process("rrtmil_tpu_torch.main", argv,
                                "main --model dtfd")
        times = [float(t) for t in re.findall(r"time: ([0-9.]+)s", out)]
        n_train = [len(s[0]) for s in splits]
        rates = [n_train[i // 2] / t for i, t in enumerate(times)]
        if len(times) != 4 or "Cross validation auc mean" not in out:
            raise AssertionError(f"main --model dtfd printed {out[-2000:]}")
        rep["dtfd"] = {"seconds": secs, "train_seconds": times,
                       "train_slides_per_s": rates}
        log(f"[13] `python -m rrtmil_tpu_torch.main --model dtfd` (2 folds "
            f"x 2 epochs, 12 bags) as its own process: {secs:.1f} s, train "
            f"slides/s by fold and epoch {np.round(rates, 2).tolist()}")

        csv_file, _ = write_survival_data(os.path.join(tmp, "surv"))
        for name, _ in CLI13_SURVIVAL:
            out, secs = cli_process("rrtmil_tpu_torch.survival_main", [
                "--model", name, "--num_epoch", "1", "--seed", "1",
                "--input_dim", "1024", "--excel_file", csv_file,
                "--results_dir", os.path.join(tmp, "p_" + name)],
                f"survival_main --model {name}")
            rates = [tuple(map(float, r)) for r in re.findall(
                r"\(([0-9.]+) bags/s\) \| val .*\(([0-9.]+) bags/s\)", out)]
            if len(rates) != 5 or "finished!" not in out:
                raise AssertionError(f"survival_main --model {name} printed "
                                     f"{out[-2000:]}")
            rep[name] = {"seconds": secs, "train_bags_per_s":
                         [r[0] for r in rates],
                         "val_bags_per_s": [r[1] for r in rates]}
            log(f"[13] `python -m rrtmil_tpu_torch.survival_main --model "
                f"{name}` (5 folds x 1 epoch, phase 10's set) as its own "
                f"process: {secs:.1f} s, train bags/s by fold "
                f"{[r[0] for r in rates]}, validation {[r[1] for r in rates]}"
                f" (bags read and transferred)")

        csv20, _ = write_survival_data(os.path.join(tmp, "surv20"),
                                       lengths=RESUME_LENGTHS, seed=5)
        for name, engine in CLI13_SURVIVAL:
            res = rep[name + "_evaluate_resume"] = check_evaluate_resume(
                dev, tmp, name, csv20, "13", engine)
            if any(res["train_launches"].values()) or \
                    any(res["launches"].values()):
                raise AssertionError(f"{name} --evaluate --resume launched "
                                     f"a kernel")
    return rep


def phase_slice13(dev):
    """Phase 13: DTFD and MHIM-MIL through both CLIs."""
    t0 = time.perf_counter()
    report = {"dtfd_cls": phase_dtfd_cls(dev),
              "dtfd_survival": phase_dtfd_survival(dev),
              "mhim": phase_mhim(dev), "selfattn": phase_selfattn(dev),
              "times": phase_times13(dev), "cli": phase_cli13(dev)}
    report["seconds"] = time.perf_counter() - t0
    log(f"[13] phase 13: {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# slice 14: the EPEG ablations, the native loader tier, the JAX weights
# ---------------------------------------------------------------------------

# phase 14 (a): c16_r50 with each EPEG ablation of the CLI (encoder
# fields): the R-MSA layer takes the XLA formulation as torch ops (no K1 /
# K2), the CR-MSA layer keeps K3 -> K5 -> K8 (its EPEG is always off)
EPEG_VARIANTS = (("value_bf", {"epeg_type": "value_bf"}),
                 ("value_af", {"epeg_type": "value_af"}),
                 ("attn_2d", {"epeg_2d": True}),
                 ("value_af_2d", {"epeg_type": "value_af", "epeg_2d": True}))
EPEG_EVAL = NTRANS_EVAL           # K3, K5, K8: once a forward
EPEG_TRAIN = NTRANS_TRAIN         # K3-K9: once a train step
# phase 14 (b): the CLI's EPEG flags, each run as its own process
CLI_EPEG = (("value_af", ["--epeg_type", "value_af"]),
            ("epeg_2d", ["--epeg_2d"]))
# phase 14 (c): the over-budget run's cache holds this share of the set
OVER_BUDGET_SHARE = 0.25
OVER_BUDGET_EPOCHS = 3
# phase 14 (d): the JAX package's weights, written by
# tests/fixtures/make_jax_weights.py, and its CPU outputs
FIXTURE = os.path.join("tests", "fixtures", "jax_weights")
FIXTURE_TOL = 1e-4


def epeg_cfg(fields, dropout=True):
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    base = c16_r50()
    enc = dataclasses.replace(base.encoder, **fields)
    if not dropout:
        enc = dataclasses.replace(enc, dropout=0.0)
    return dataclasses.replace(base, encoder=enc,
                               dropout=base.dropout if dropout else 0.0)


def _exactly_once(launches, expect, runs, what):
    """`launches` (totals over `runs` forwards or steps): each kernel of
    `expect` `runs` times, none other."""
    want = {n: (runs if n in expect else 0) for n in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{want}")


def _batch9000(dev, b, cfg):
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    spec = bucket_for(9000, cfg.encoder)
    x = torch.zeros((b, spec.data_length, cfg.input_dim))
    x[:, :9000] = _randn((b, 9000, cfg.input_dim), _gen(b))
    mask = (torch.arange(spec.data_length) < 9000)[None].expand(b, -1)
    return x.to(dev), mask.contiguous().to(dev), spec.repr_length


def epeg_bits_and_times(dev, tag, fields):
    """One dropout-off forward and backward of a 9000-patch bag twice (the
    same bits; K3-K9 once a run, K1 / K2 never), then the forward and the
    train step (dropout on, Adam) at L = 9000, B = 1 and 8, CUDA events."""
    from rrtmil_tpu_torch.models.rrt import build_model
    cfg = epeg_cfg(fields, dropout=False)
    model = build_model(cfg, device=dev, seed=0)
    x, mask, length = _batch9000(dev, 1, cfg)
    lab = torch.tensor([1], device=dev)
    reset_counters()
    n = _grad_bits(model, lambda: torch.nn.functional.cross_entropy(
        model(x, mask=mask, length=length), lab), tag)
    bits_launches = launches_now()
    _exactly_once(bits_launches, EPEG_TRAIN, 2, f"{tag} forward + backward")
    del model
    times = {}
    for b in (1, 8):
        eng, step, cfg = train_setup(dev, b, epeg_cfg(fields))
        x, mask, length = _batch9000(dev, b, cfg)
        eng.model.eval()
        with torch.no_grad():
            fwd = time_ms(lambda: eng.model(x, mask=mask, length=length),
                          iters=5, warmup=2)
        eng.model.train()
        torch.cuda.reset_peak_memory_stats()
        tr = time_ms(step, iters=5, warmup=2)
        times[str(b)] = {"forward_ms": fwd, "train_ms": tr,
                         "peak_mem_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30}
        log(f"[14] {tag} L=9000 B={b}: forward {fwd:.3f} ms, train step "
            f"{tr:.3f} ms, peak {times[str(b)]['peak_mem_gib']:.2f} GiB")
        del eng, step, x, mask
        torch.cuda.empty_cache()
    return {"gradients_same_bits": n, "launches": bits_launches,
            "times": times}


def phase_epeg(dev):
    """Phase 14 (a): c16_r50 with each EPEG ablation at full width:
    Engine.evaluate on {937, 2213, 9000} against the CPU (K3, K5, K8 once a
    batch, K1 / K2 never), two dropout-off train steps against the CPU in
    f32 (TF32 off; K3-K9 once a step), the same bits twice, and the forward
    and train-step times."""
    out = {}
    for tag, fields in EPEG_VARIANTS:
        t0 = time.perf_counter()
        cfg = epeg_cfg(fields)
        ev = phase_main_path(dev, cfg, CANON_BAGS, f"epeg {tag}", "14",
                             EPEG_EVAL)
        _exactly_once(ev["launches"], EPEG_EVAL, ev["batches"],
                      f"{tag} evaluate")
        reset_counters()
        tr = phase_train_vs_cpu(dev, cfg, f"epeg {tag}", "14", EPEG_TRAIN,
                                ("float32",))
        steps = sum(len(r["card_losses"]) for r in tr.values())
        tr_launches = launches_now()
        _exactly_once(tr_launches, EPEG_TRAIN, steps, f"{tag} train steps")
        rec = {"evaluate": ev, "train_vs_cpu": tr,
               "train": {"launches": tr_launches, "steps": steps}}
        rec.update(epeg_bits_and_times(dev, tag, fields))
        rec["seconds"] = time.perf_counter() - t0
        log(f"[14] epeg {tag}: {rec['seconds']:.1f} s")
        out[tag] = rec
    return out


def phase_epeg_cli(dev, root):
    """Phase 14 (b): `python -m rrtmil_tpu_torch.main` with c16_r50's flags
    and each EPEG flag, as its own process on phase 9's 12 bags."""
    out = {}
    for tag, flags in CLI_EPEG:
        argv = (CLI_RUN + CLI_C16 + flags
                + ["--dataset_root", root, "--model_path",
                   os.path.join(os.path.dirname(root), "epeg_" + tag),
                   "--title", tag])
        stdout, secs = cli_process("rrtmil_tpu_torch.main", argv,
                                   f"main {' '.join(flags)}")
        out[tag] = {"seconds": secs, "tail": stdout[-600:]}
        log(f"[14] main {' '.join(flags)}: exit 0 in {secs:.1f} s")
    return out


def _tier_run(tag, root, flags, epochs=2, python=False):
    """The CLI in process on `root` (c16_r50's flags and `flags`): per
    epoch (summed over folds) train and eval slides/s, device cache hits
    and misses and the batches each host tier served; every miss of a
    native run served natively."""
    from rrtmil_tpu_torch.train.engine import Engine
    stats = []
    argv = (["--cv_fold", "2", "--num_epoch", str(epochs), "--seed", "2021"]
            + CLI_C16 + flags + ["--dataset_root", root, "--model_path",
                                 os.path.join(os.path.dirname(root),
                                              "tiers"), "--title", tag])
    orig = Engine.native_ok
    if python:
        Engine.native_ok = lambda *a: False
    try:
        t0 = time.perf_counter()
        run_cli(argv, stats)
        secs = time.perf_counter() - t0
    finally:
        Engine.native_ok = orig
    epochs_out = {}
    for e in range(epochs):
        rows = [r for r in stats if r["epoch"] == e]
        rec = epoch_summary(stats, e)
        rec["tiers"] = {k: sum(r["tiers"][k] for r in rows)
                        for k in ("cache", "native", "python")}
        epochs_out[e] = rec
        tr, ev = rec["train"], rec["eval"]
        log(f"[14] {tag} epoch {e}: train {tr['slides_per_s']:.2f} slides/s "
            f"({tr['cache_hits']} hits / {tr['cache_misses']} misses), eval "
            f"{ev['slides_per_s']:.2f} slides/s ({ev['cache_hits']} hits / "
            f"{ev['cache_misses']} misses); batches by tier {rec['tiers']}")
    for r in stats:
        t = r["tiers"]
        host = t["native"] + t["python"]
        if host != r["cache_misses"] or (t["python"] if not python
                                         else t["native"]):
            raise AssertionError(f"{tag}: a miss went through another tier "
                                 f"than expected: {r}")
    return {"seconds": secs, "epochs": epochs_out, "stats": stats}


def native_batches(dev, ds):
    """Phase 14 (c): each bag of `ds` (and the batch-2 batches the engine
    forms) through the native tier and the Python tier, fp32 and bf16: the
    host batches and the device batches the same bits; then host ms a bag
    of each tier at batch 1, the assembly alone and with its transfer to
    the card (cache off, files in the page cache: a warm read)."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
    enc = c16_r50().encoder
    out = {}
    for dtype in ("float32", "bfloat16"):
        eng = Engine(torch.nn.Linear(4, 2), EngineConfig(
            device_cache="off", transfer_dtype=dtype, batch_size=2), enc,
            device=dev)
        tdt = getattr(torch, dtype)
        batches = [[i] for i in range(len(ds))] + eng._batched_order(
            ds, range(len(ds)))
        for b in batches:
            if not eng.native_ok(ds, b, False):
                raise AssertionError(f"batch {b} is not native-eligible")
            xn, mn, ln, sn = (t.clone() if torch.is_tensor(t) else t
                              for t in eng._assemble_native(ds, b))
            xh, mh, lh, sh = eng._assemble_host(ds, b, False)
            xp = torch.from_numpy(xh).to(tdt)
            dev_n = eng._make_batch(ds, b)
            dev_p = eng._transfer(xp, torch.from_numpy(mh),
                                  torch.from_numpy(lh), sh)
            torch.cuda.synchronize()
            same = (sn == sh and torch.equal(xn.view(torch.int16) if
                                             dtype == "bfloat16" else xn,
                                             xp.view(torch.int16) if
                                             dtype == "bfloat16" else xp)
                    and torch.equal(mn, torch.from_numpy(mh))
                    and ln.tolist() == lh.tolist()
                    and all(torch.equal(a, c) for a, c in
                            zip(dev_n[:3], dev_p[:3])))
            if not same:
                raise AssertionError(f"native and Python batches of {b} "
                                     f"differ ({dtype})")
        torch.cuda.synchronize()
        single = [[i] for i in range(len(ds))]

        def assemble(native):
            for b in single:
                if native:
                    eng._assemble_native(ds, b)
                else:
                    x, *_ = eng._assemble_host(ds, b, False)
                    torch.from_numpy(x).to(tdt)

        def python_host(b):
            x, m, lab, spec = eng._assemble_host(ds, b, False)
            return (torch.from_numpy(x).to(tdt), torch.from_numpy(m),
                    torch.from_numpy(lab), spec)

        def make(native):
            for b in single:
                if native:
                    eng._make_batch(ds, b)
                else:
                    eng._transfer(*python_host(b))
            torch.cuda.synchronize()
        rec = {"bags": len(single), "batches_checked": len(batches)}
        for what, fn in (("assembly", assemble), ("with_transfer", make)):
            for rnd in range(2):                  # the second round is kept
                for tier, native in (("python", False), ("native", True)):
                    t0 = time.perf_counter()
                    fn(native)
                    rec[f"{tier}_{what}_ms_per_bag"] = \
                        (time.perf_counter() - t0) * 1e3 / len(single)
        out[dtype] = rec
        log(f"[14] native vs Python tier ({dtype}): {len(batches)} batches "
            f"the same bits on the host and the card; host ms a bag, "
            f"assembly: native {rec['native_assembly_ms_per_bag']:.2f}, "
            f"python {rec['python_assembly_ms_per_bag']:.2f}; with the "
            f"transfer: native {rec['native_with_transfer_ms_per_bag']:.2f}, "
            f"python {rec['python_with_transfer_ms_per_bag']:.2f} (warm "
            f"page cache)")
    return out


def phase_native_tier(dev, root):
    """Phase 14 (c) on phase 9's 12 bags (c16_r50, input 1024): the tiers'
    batches and host ms a bag; the CLI with c16_r50's flags through the
    native tier in fp32 and --amp and, for comparison in this call, through
    the Python tier in fp32 (first and cached epoch slides/s, batches by
    tier); then a run whose device cache holds OVER_BUDGET_SHARE of the
    set's bytes, so most bags stream every epoch (hits, misses, slides/s by
    epoch).  The two tiers' fp32 runs alternate, python, native, python,
    native; the second of each is the reading."""
    from rrtmil_tpu_torch.data.datasets import C16Dataset
    names = sorted(f[:-4] for f in os.listdir(os.path.join(root, "pt")))
    ds = C16Dataset(names, [i % 2 for i in range(len(names))], root)
    out = {"batches": native_batches(dev, ds)}
    set_bytes = sum(os.path.getsize(p) for p in ds.slide_path)
    budget_gb = OVER_BUDGET_SHARE * set_bytes / 2 ** 30
    # the two tiers alternate, each run twice (the first pays warm-ups)
    for tag, flags, kw in (
            ("python_1", [], {"python": True}), ("native_1", [], {}),
            ("python", [], {"python": True}), ("native", [], {}),
            ("native_amp", ["--amp"], {}),
            ("over_budget", ["--device_cache_gb", f"{budget_gb:.6f}"],
             {"epochs": OVER_BUDGET_EPOCHS})):
        reset_counters()
        rec = _tier_run(tag, root, flags, **kw)
        rec["launches"] = launches_now()
        _exactly_once({n: min(v, 1) for n, v in rec["launches"].items()},
                      C16_TRAIN, 1, f"CLI {tag}")
        out[tag] = rec
    over = out["over_budget"]["epochs"]
    later = [{k: sum(over[e][kind][k] for kind in ("train", "eval"))
              for k in ("cache_hits", "cache_misses")}
             for e in range(1, OVER_BUDGET_EPOCHS)]
    if not all(t["cache_misses"] > t["cache_hits"] > 0 for t in later):
        raise AssertionError(f"the over-budget run's later epochs did not "
                             f"stream most bags from a cache in use: "
                             f"{later}")
    out["over_budget"]["budget_gb"] = budget_gb
    out["over_budget"]["set_gb"] = set_bytes / 2 ** 30
    log(f"[14] over-budget run: cache {budget_gb:.4f} GB for a set of "
        f"{set_bytes / 2 ** 30:.4f} GB")
    return out


def phase_jax_weights(dev, tmp):
    """Phase 14 (d): the JAX package's `.msgpack` weights (the committed
    fixture) on the card: attmil's logits and the survival MeanMIL's hazards
    and survival on the stored bags within FIXTURE_TOL of the JAX package's
    CPU outputs; then `survival_main --evaluate --resume` over a JAX results
    directory (each fold's `model_best_*.msgpack`) as a process: exit 0,
    every fold loading its `.msgpack`."""
    import shutil
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.mean_max import MeanMIL
    from rrtmil_tpu_torch.models.survival import SurvivalHead
    from rrtmil_tpu_torch.train.checkpoint import load_params
    root = os.path.dirname(os.path.abspath(__file__))
    fix = os.path.join(root, FIXTURE)
    attmil = zoo.build_model("attmil", input_dim=64, device=dev)
    attmil.load_state_dict(load_params(os.path.join(fix, "attmil.msgpack")))
    surv = SurvivalHead(MeanMIL(64, 4)).to(dev).eval()
    surv.load_state_dict(load_params(os.path.join(
        fix, "survival_meanmil.msgpack")))
    reset_counters()
    err = 0.0
    with np.load(os.path.join(fix, "outputs.npz")) as f:
        for i in range(3):
            n = f[f"x_{i}"].shape[0]
            x = torch.zeros((1, int(f[f"rows_{i}"]), 64))
            x[0, :n] = torch.from_numpy(f[f"x_{i}"])
            x = x.to(dev)
            mask = torch.arange(x.shape[1], device=dev)[None] < n
            with torch.no_grad():
                got = (attmil(x, mask=mask, length=n),
                       *surv(x, mask=mask, length=n))
            for g, key in zip(got, ("logits", "hazards", "survival")):
                err = max(err, float(np.abs(g.cpu().numpy()
                                            - f[f"{key}_{i}"]).max()))
    launches = launches_now()
    log(f"[14] JAX weights on the card: max |port - JAX| {err:.3e} (tol "
        f"{FIXTURE_TOL}) over attmil's logits and MeanMIL's hazards and "
        f"survival on 3 bags")
    if err > FIXTURE_TOL:
        raise AssertionError("the JAX weights give other outputs on the card")
    csv, _ = write_survival_data(os.path.join(tmp, "surv64"), dim=64)
    res = os.path.join(tmp, "jax_results")
    for k in range(5):
        os.makedirs(os.path.join(res, f"fold_{k}"))
        shutil.copy(os.path.join(fix, "survival_meanmil.msgpack"),
                    os.path.join(res, f"fold_{k}",
                                 f"model_best_0.5000_{k}.msgpack"))
    stdout, secs = cli_process("rrtmil_tpu_torch.survival_main", [
        "--excel_file", csv, "--model", "MeanMIL", "--input_dim", "64",
        "--evaluate", "--resume", res, "--results_dir",
        os.path.join(tmp, "jax_eval")], "survival_main --evaluate --resume")
    loaded = [ln for ln in stdout.splitlines()
              if ln.startswith("=> loading checkpoint")
              and ln.rstrip("'").endswith(".msgpack")]
    folds = [ln for ln in stdout.splitlines() if "evaluate: loss" in ln]
    log(f"[14] survival_main --evaluate --resume over JAX weights: exit 0 "
        f"in {secs:.1f} s; {len(loaded)} folds loaded a .msgpack; {folds}")
    if len(loaded) != 5 or len(folds) != 5:
        raise AssertionError("a fold did not evaluate the JAX weights")
    return {"max_abs_err": err, "launches": launches, "cli_seconds": secs,
            "folds": folds}


def phase_slice14(dev):
    """Phase 14: the EPEG ablations, the native loader tier and the JAX
    package's weights."""
    import tempfile
    t0 = time.perf_counter()
    report = {"epeg": phase_epeg(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "c16")
        write_cli_data(root, False, 1024, 0)
        report["epeg_cli"] = phase_epeg_cli(dev, root)
        report["native"] = phase_native_tier(dev, root)
    with tempfile.TemporaryDirectory() as tmp:
        report["jax_weights"] = phase_jax_weights(dev, tmp)
    report["seconds"] = time.perf_counter() - t0
    log(f"[14] phase 14: {report['seconds']:.1f} s")
    return report


def k5_library_call(args, mmd):
    """One PyTorch call computing K5 at kk = 0: multi-head self-attention
    with in- and out-projection, on x and weights cast to the mm dtype
    beforehand.  wq/bq arrive with the q scale folded in; the library applies
    it itself, so it gets them unscaled.  Timed only: the port never calls
    it."""
    import torch.nn.functional as F
    x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp = args
    if pw is not None:
        raise ValueError("no library call computes K5 with EPEG")
    h, c, hd = wq.shape
    scale = hd ** -0.5
    lin = lambda w: w.permute(0, 2, 1).reshape(h * hd, c)
    in_w = torch.cat([lin(wq) / scale, lin(wk), lin(wv)]).to(mmd)
    in_b = torch.cat([bq.reshape(-1) / scale, bk.reshape(-1),
                      bv.reshape(-1)]).to(mmd)
    out_w = wp.reshape(h * hd, c).t().contiguous().to(mmd)
    out_b = bp.to(mmd)
    q = x.to(mmd).transpose(0, 1)          # (P, R, C): sequence first

    def call():
        return F.multi_head_attention_forward(
            q, q, q, c, h, in_w, in_b, None, None, False, 0.0, out_w, out_b,
            training=False, need_weights=False)[0]
    return call


def attention_library_calls(args, mmd):
    """K6 and K7 at kk = 0 as one PyTorch call: scaled_dot_product_attention
    at scale 1 on q, k, v cast to the mm dtype beforehand, and its backward
    through autograd (the K7 library time is the forward-plus-backward call
    minus the forward).  Timed only: the port never calls it."""
    import torch.nn.functional as F
    q, k, v, w, b, g, scale = args
    if w is not None:
        raise ValueError("no library call computes the core with EPEG")
    qm, km, vm = (t.to(mmd).detach().requires_grad_(True) for t in (q, k, v))
    gm = g.to(mmd)

    def fwd():
        return F.scaled_dot_product_attention(qm, km, vm, scale=scale)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qm, km, vm), gm)
    return fwd, fwd_bwd


def _library_check(name, got, want):
    rel = max((a.float() - b.float()).abs().max().item()
              / max(1.0, b.float().abs().max().item())
              for a, b in zip(got, want))
    log(f"[4] {name} library call vs plain: scaled {rel:.3e} "
        f"(tol {LIBRARY_TOL})")
    if rel > LIBRARY_TOL:
        raise AssertionError(f"the library call does not compute {name}'s "
                             f"function: {rel:.3e}")


def phase_times(dev):
    rows = {}
    for b in (1, 8):
        cases = kernel_cases(b, dev, torch.float32)
        for name, (fn, plain, args) in cases.items():
            # K5, K6, K7: phase_times_pairs, interleaved with their library
            if "(" in name or name.startswith(("K5", "K6", "K7")):
                continue
            mmd = torch.bfloat16
            ms = time_ms(lambda: fn(*args, mm_dtype=mmd))
            plain_ms = time_ms(lambda: plain(*args, mm_dtype=mmd), iters=5,
                               warmup=1)
            lib_ms = None
            flops, byts = work_of(name, b, torch.float32, mmd)
            bms, by = bound_ms(flops, byts, mmd)
            rec = rows.setdefault(name, {})[str(b)] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": lib_ms, "flops": flops,
                "bytes": byts}
            log(f"[4] {name:32s} B={b}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"bound {bms:.4f} by {by}, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f}'})")
            if name.startswith(("K1", "K2", "K3", "K4", "K8", "K9")):
                split = device_split(lambda: fn(*args, mm_dtype=mmd), iters=5)
                rec["device_ms"] = sum(split.values())
                rec["device_split"] = {k[:80]: v for k, v in split.items()}
                log(f"[4]   device {rec['device_ms']:.4f} ms: " + "; ".join(
                    f"{v:.4f} {k[:60]}" for k, v in sorted(
                        split.items(), key=lambda kv: -kv[1])[:6]))
            if name.startswith(("K8", "K9")):
                rec["host_ms"] = host_ms(lambda: fn(*args, mm_dtype=mmd))
                log(f"[4]   host {rec['host_ms']:.4f} ms per call")
        torch.cuda.empty_cache()
    return rows


K2_PRODUCTS = ("dWp = o^T gm", "d(o) = gm Wp^T", "dWqkv = z^T round(dqkv)",
               "dz = round(dqkv) Wqkv^T")


def phase_times_products(dev, rows):
    """K2's four products at a 9000-patch bag's token counts (B = 8: m =
    73,728; B = 1: 9,216) on bf16 operands, each interleaved with
    torch.matmul on the same operands (PAIR_ROUNDS alternating rounds,
    median; a yardstick: the port never calls it), beside each side's
    device time from the profiler and the bound (operations at the bf16
    peak, operands read once, the output written once)."""
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    mmd = torch.bfloat16
    for b in (1, 8):
        m = b * 96 * 96
        g = torch.Generator(device=dev).manual_seed(800 + b)
        r = lambda *s: torch.randn(s, generator=g, device=dev).to(mmd)
        for name, (a, w, at, odt) in zip(K2_PRODUCTS, (
                (r(m, 512), r(m, 512), True, torch.float32),
                (r(m, 512), r(512, 512), False, mmd),
                (r(m, 512), r(m, 1536), True, torch.float32),
                (r(m, 1536), r(512, 1536), False, torch.float32))):
            kernel = lambda: rl.k2_product(a, w, at, odt, mmd)
            at_ = a.t() if at else a
            w_ = w if at else w.t()
            lib = lambda: torch.matmul(at_, w_)
            _library_check(f"K2 product {name} B={b}", (lib(),),
                           (rl.k2_product_plain(a, w, at, odt, mmd),))
            med, rounds = interleaved_ms({"kernel": kernel, "library": lib})
            mm_, nn_ = at_.shape[0], w_.shape[1]
            flops = 2 * mm_ * nn_ * at_.shape[1]
            byts = (a.numel() + w.numel()) * 2 + mm_ * nn_ * (
                4 if odt == torch.float32 else 2)
            bms, by = bound_ms(flops, byts, mmd)
            split = device_split(kernel)
            rec = rows.setdefault(f"K2 product {name}", {})[str(b)] = {
                "ms": med["kernel"], "library_ms": med["library"],
                "device_ms": sum(split.values()),
                "device_split": {k[:80]: v for k, v in split.items()},
                "library_device_ms": device_ms(lib), "bound_ms": bms,
                "bound_by": by, "flops": flops, "bytes": byts,
                "tflops": flops / (med["kernel"] * 1e9),
                "interleaved_rounds": rounds}
            log(f"[4] K2 product {name:26s} B={b} (m={m}): kernel "
                f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}, "
                f"{rec['tflops']:.1f} TFLOP/s) vs torch.matmul "
                f"{rec['library_ms']:.4f} ms (device "
                f"{rec['library_device_ms']:.4f}); bound {bms:.4f} by {by}")
            del a, w, at_, w_
        torch.cuda.empty_cache()
    return rows


def phase_throughput(dev):
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.utils.flops import rrtmil_flops

    cfg = c16_r50()
    model = build_model(cfg, device=dev, seed=0)
    spec = bucket_for(9000, cfg.encoder)
    flops = 2 * rrtmil_flops(9000, cfg)["total"]
    out = {}
    for b in (1, 4, 8):
        g = _gen(b)
        x = torch.zeros((b, spec.data_length, cfg.input_dim))
        x[:, :9000] = _randn((b, 9000, cfg.input_dim), g)
        x = x.to(dev)
        mask = (torch.arange(spec.data_length) < 9000)[None].expand(b, -1) \
            .contiguous().to(dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = time_ms(lambda: model(x, mask=mask, length=spec.repr_length),
                         iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rate = b / (ms / 1e3)
        out[str(b)] = {"ms_per_batch": ms, "slides_per_s": rate,
                       "peak_mem_gib": peak,
                       "achieved_tflops": rate * flops / 1e12}
        log(f"[4] forward L=9000 B={b}: {ms:.3f} ms/batch, {rate:.2f} "
            f"slides/s, {rate * flops / 1e12:.2f} TFLOP/s, peak {peak:.2f} GiB")
        del x, mask
    return out


def train_setup(dev, b, cfg=None, x_dtype=torch.float32):
    """A seeded train engine of `cfg` (c16_r50 by default) on the card
    (dropout on) and one batch of b 9000-patch bags, device-resident in
    `x_dtype`; returns (engine, step, cfg)."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    cfg = cfg or c16_r50()
    spec = bucket_for(9000, cfg.encoder)
    eng = Engine(build_model(cfg, device=dev, seed=0),
                 EngineConfig(batch_size=b), cfg.encoder, device=dev)
    eng.model.train()
    g = _gen(b)
    x = torch.zeros((b, spec.data_length, cfg.input_dim))
    x[:, :9000] = _randn((b, 9000, cfg.input_dim), g)
    x = x.to(x_dtype).to(dev)
    mask = (torch.arange(spec.data_length) < 9000)[None].expand(b, -1) \
        .contiguous().to(dev)
    labels = (torch.arange(b) % 2).to(dev)

    def step():
        eng._train_step(x, mask, labels, spec.repr_length)
        eng._apply_grads(eng.cfg.lr)
    return eng, step, cfg


def phase_train_throughput(dev):
    """Train slides/s at L = 9000 (forward, backward and the Adam update,
    dropout on) for B in {1, 8}, with peak memory and useful TFLOP/s from
    utils.flops.train_flops."""
    from rrtmil_tpu_torch.utils.flops import train_flops
    out = {}
    for b in (1, 8):
        eng, step, cfg = train_setup(dev, b)
        flops = train_flops(9000, cfg)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rate = b / (ms / 1e3)
        out[str(b)] = {"ms_per_step": ms, "slides_per_s": rate,
                       "peak_mem_gib": peak,
                       "achieved_tflops": rate * flops / 1e12}
        log(f"[4] train L=9000 B={b}: {ms:.3f} ms/step, {rate:.2f} slides/s, "
            f"{rate * flops / 1e12:.2f} TFLOP/s, peak {peak:.2f} GiB")
        del eng, step
        torch.cuda.empty_cache()
    return out


def phase_amp_throughput(dev):
    """--amp's steady state: c16_r50 with compute_dtype bfloat16 on bags
    that arrive in bfloat16 (the CLI's transfer dtype), L = 9000: forward
    slides/s for B in {1, 8} and train slides/s for B in {1, 8}, beside
    this run's float32-stream readings of the same shapes."""
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model
    base = c16_r50()
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, compute_dtype="bfloat16"))
    spec = bucket_for(9000, cfg.encoder)
    model = build_model(cfg, device=dev, seed=0)
    out = {"forward": {}, "train": {}}
    for b in (1, 8):
        x = torch.zeros((b, spec.data_length, cfg.input_dim))
        x[:, :9000] = _randn((b, 9000, cfg.input_dim), _gen(b))
        x = x.to(torch.bfloat16).to(dev)
        mask = (torch.arange(spec.data_length) < 9000)[None].expand(b, -1) \
            .contiguous().to(dev)
        with torch.no_grad():
            ms = time_ms(lambda: model(x, mask=mask, length=spec.repr_length),
                         iters=10, warmup=2)
        out["forward"][str(b)] = {"ms_per_batch": ms,
                                  "slides_per_s": b / (ms / 1e3)}
        eng, step, _ = train_setup(dev, b, cfg, torch.bfloat16)
        tms = time_ms(step, iters=5, warmup=2)
        out["train"][str(b)] = {"ms_per_step": tms,
                                "slides_per_s": b / (tms / 1e3)}
        log(f"[4] --amp L=9000 B={b}: forward {ms:.3f} ms/batch "
            f"({b / (ms / 1e3):.2f} slides/s), train {tms:.3f} ms/step "
            f"({b / (tms / 1e3):.2f} slides/s)")
        del eng, step, x, mask
        torch.cuda.empty_cache()
    return out


def phase_profile(dev, b=8, iters=3, train=False, fn=None, what=None):
    """torch.profiler over `iters` forwards (or train steps) at L = 9000,
    batch b, or over `iters` calls of `fn` (a train step called `what`):
    device time by kernel name and the device's busy share of the
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model

    if fn is not None:
        grad = torch.enable_grad
    elif train:
        _, fn, _ = train_setup(dev, b)
        grad = torch.enable_grad
    else:
        cfg = c16_r50()
        model = build_model(cfg, device=dev, seed=0)
        spec = bucket_for(9000, cfg.encoder)
        x = torch.zeros((b, spec.data_length, cfg.input_dim), device=dev)
        x[:, :9000] = torch.randn((b, 9000, cfg.input_dim), device=dev)
        mask = (torch.arange(spec.data_length, device=dev) < 9000)[None] \
            .expand(b, -1).contiguous()

        def fn():
            model(x, mask=mask, length=spec.repr_length)
        grad = torch.no_grad
    what = what or ("train step" if train else "forward")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with grad():
        with profile(activities=acts):          # starts the tracer up
            fn()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(iters):
                fn()
            e1.record()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        events_ms = e0.elapsed_time(e1)
    # kernels only: the ops that launch them carry the same device time
    rows = [(ev.key, ev.self_device_time_total / 1e3 / iters)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) * iters
    # the profiler's own losses: kernel launches recorded on the host
    # against kernels recorded on the device
    launched = sum(1 for ev in prof.events()
                   if ev.device_type == DeviceType.CPU
                   and "LaunchKernel" in ev.name)
    recorded = sum(1 for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and not ev.name.startswith(("Memcpy", "Memset")))
    # K2's products: each wgmma call in launch order (the two weight
    # gradients share a kernel name); the SIMT product's total
    wgmma = [(ev.name, ev.self_device_time_total / 1e3)
             for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and "gemm_wgmma" in ev.name]
    simt_ms = sum(ms for n, ms in rows if "rrt::gemm_kernel<" in n) * iters
    if wgmma:
        named = len(wgmma) == 4 * iters
        for i, (n, ms) in enumerate(wgmma):
            log(f"[5]   wgmma call {i}: {ms:.4f} ms "
                f"{K2_PRODUCTS[i % 4] if named else ''} ({n[:60]})")
    top = 12 if what == "forward" else 16
    for name, ms in rows[:top]:
        log(f"[5] {ms:9.4f} ms/{what}  {name[:90]}")
    # the CR-MSA layer's stream kernels by name, their instantiations
    # summed: the compression's (K3 / K12 and K4; pass 1 runs in K3 and in
    # K4) and the redistribution's (K8, K9 / K11, K10 / K13)
    compress, redistribute = {}, {}
    for n, ms in rows:
        for key, into in (("compress_", compress),
                          ("redistribute_", redistribute)):
            if key in n:
                base = n.split("<")[0].split("::")[-1].split()[-1]
                into[base] = into.get(base, 0.0) + ms
    for n, ms in sorted({**compress, **redistribute}.items()):
        log(f"[5]   {n}: {ms:.4f} ms/{what}")
    log(f"[5] B={b}: kernels {busy / iters:.3f} ms per {what}; the "
        f"profiled window {wall_ms / iters:.3f} ms per {what} (busy share "
        f"{busy / wall_ms:.3f}, profiler overhead included)"
        if rows else "[5] the profiler recorded no device time")
    log(f"[5] B={b}: {events_ms / iters:.3f} ms per {what} by CUDA events "
        f"inside the window; {recorded} kernels recorded of {launched} "
        f"launches")
    return {"batch": b, "what": what, "wall_ms_per_iter": wall_ms / iters,
            "events_ms_per_iter": events_ms / iters,
            "kernel_ms_per_iter": busy / iters,
            "launches_recorded": launched, "kernels_recorded": recorded,
            "busy_share": busy / wall_ms if rows else None,
            "top": [{"kernel": n, "ms_per_iter": ms} for n, ms in rows[:top]],
            "wgmma_calls": [{"kernel": n, "ms": ms} for n, ms in wgmma],
            "simt_product_ms": simt_ms, "compress_kernels": compress,
            "redistribute_kernels": redistribute}


# ---------------------------------------------------------------------------
# slice 3: survival (K12, K13), the FFN / drop-path TransLayer (K10, K11)
# ---------------------------------------------------------------------------

def _surv_dataset(lengths, seed):
    from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
    rng = np.random.default_rng(seed)
    bags = [rng.standard_normal((n, 1024), dtype=np.float32) for n in lengths]
    events = rng.uniform(100.0, 3000.0, len(bags))
    status = [1, 0, 1, 1, 0, 1][:len(bags)]
    return ArraySurvivalDataset(bags, events, status)


def _surv_model(cfg, dev, seed=0):
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.models.survival import SurvivalHead
    return SurvivalHead(build_model(cfg, device=dev, seed=seed))


def counting_survival_engine():
    """A counting SurvivalEngine whose records also hold each bag's bucket
    grids (R-MSA, CR-MSA) and token count, and its loss and risk."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.train.surv_engine import SurvivalEngine

    def describe(eng, x, mask, label, cens, length):
        return {"grids": bucket_for(length, eng.encoder_cfg).key,
                "tokens": int(x.shape[1])}
    return counting(SurvivalEngine, describe)


def _loss_risk(rec):
    return float(rec["out"][0]), float(rec["out"][1][0])


def _surv_expected(rec):
    g = rec["grids"]
    return SURV_MISMATCHED if g[0] != g[1] else SURV_MATCHED


def phase_survival(dev):
    """SurvivalEngine.train_epoch (dropout on) and validate at full width,
    survival_default() with seeded random weights, on bags of SURV_BAGS
    patches: every kernel's counter set to 0 just before each and read just
    after; each bag must launch K12 and K13 when its R-MSA and CR-MSA grids
    differ, K1-K9 when they match."""
    from rrtmil_tpu_torch.config import survival_default
    from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                    SurvivalEngineConfig)
    cfg = survival_default()
    ds = _surv_dataset(SURV_BAGS, 3)
    eng = counting_survival_engine()(_surv_model(cfg, dev),
                                     SurvivalEngineConfig(), cfg.encoder,
                                     device=dev)
    idx = list(range(len(ds)))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, ci = eng.train_epoch(ds, idx, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launches_now()
    per_step = eng.records["train"]
    log(f"[6] SurvivalEngine.train_epoch on bags {SURV_BAGS} (dropout on): "
        f"{secs:.2f} s, mean loss {loss:.6f}, c-index {ci:.4f}")
    for rec in per_step:
        log(f"[6]   bag of {rec['tokens']} tokens, grids {rec['grids']}: "
            f"loss {_loss_risk(rec)[0]:.6f}, launches "
            f"{ {n.split()[0]: v for n, v in rec['launches'].items() if v} }")
    log(f"[6] survival train launches {launches}")
    check_launches(per_step, _surv_expected, "survival train", len(idx))
    if not (np.isfinite(loss) and all(torch.isfinite(p).all()
                                      for p in eng.model.parameters())):
        raise AssertionError("survival training gave a non-finite loss or "
                             "parameter")
    reset_counters()
    t0 = time.perf_counter()
    vloss, vci = eng.validate(ds, idx)
    vsecs = time.perf_counter() - t0
    val_launches = launches_now()
    per_val = eng.records["eval"]
    log(f"[6] SurvivalEngine.validate: {vsecs:.2f} s, mean loss {vloss:.6f}, "
        f"c-index {vci:.4f}, launches {val_launches}")
    fwd = lambda rec: [n for n in _surv_expected(rec)
                       if n in (K[0], K[2], K[4], K[7], K[11], K[12])]
    check_launches(per_val, fwd, "survival validate", len(idx))
    risks = [_loss_risk(r)[1] for r in per_val]
    if not np.isfinite(vloss) or not np.isfinite(risks).all():
        raise AssertionError(f"validate gave non-finite values: {risks}")
    return {"seconds": secs, "launches": launches, "loss": loss,
            "c_index": ci, "val_seconds": vsecs, "val_loss": vloss,
            "val_c_index": vci, "val_launches": val_launches,
            "per_step": [{k: v for k, v in r.items() if k in
                          ("grids", "tokens", "launches")} for r in per_step]}


def phase_survival_vs_cpu(dev):
    """The same weights on the card and the CPU on bags of SURV_CPU_BAGS
    patches (both mismatched buckets: K12 / K13): validate's loss and
    risks (default bf16 products) within PROB_TOL; two dropout-off train
    steps (f32 products, TF32 off) with losses within 1e-4."""
    import dataclasses
    from rrtmil_tpu_torch.config import survival_default
    from rrtmil_tpu_torch.train.surv_engine import SurvivalEngineConfig
    base = survival_default()
    ds = _surv_dataset(SURV_CPU_BAGS, 4)
    engine_cls = counting_survival_engine()
    out = {}
    runs = {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        eng = engine_cls(_surv_model(base, d), SurvivalEngineConfig(),
                         base.encoder, device=d)
        t0 = time.perf_counter()
        loss, _ = eng.validate(ds, [0, 1])
        runs[key] = (loss, [_loss_risk(r)[1] for r in eng.records["eval"]],
                     time.perf_counter() - t0)
    dl = abs(runs["card"][0] - runs["cpu"][0])
    dr = max(abs(a - b) for a, b in zip(runs["card"][1], runs["cpu"][1]))
    ok = dl <= PROB_TOL and dr <= PROB_TOL
    log(f"[6] survival validate card vs CPU (bf16 products): loss "
        f"{runs['card'][0]:.6f} vs {runs['cpu'][0]:.6f}, risks "
        f"{np.round(runs['card'][1], 6).tolist()} vs "
        f"{np.round(runs['cpu'][1], 6).tolist()}: max diff {dl:.3e} / "
        f"{dr:.3e} (tol {PROB_TOL}); CPU {runs['cpu'][2]:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("survival validate: card and CPU disagree")
    out["validate"] = {"loss_diff": dl, "risk_diff": dr}
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))
    steps = {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        eng = engine_cls(_surv_model(cfg, d), SurvivalEngineConfig(),
                         cfg.encoder, device=d)
        eng.train_epoch(ds, [0, 1], 0)
        steps[key] = [_loss_risk(r)[0] for r in eng.records["train"]]
    dstep = max(abs(a - b) for a, b in zip(steps["card"], steps["cpu"]))
    tol = 1e-4 * max(1.0, max(map(abs, steps["cpu"])))
    log(f"[6] survival train card vs CPU, dropout off, f32 products: step "
        f"losses {np.round(steps['card'], 7).tolist()} vs "
        f"{np.round(steps['cpu'], 7).tolist()} (max diff {dstep:.3e}, tol "
        f"{tol:.1e}) {'ok' if dstep <= tol else 'FAIL'}")
    if dstep > tol:
        raise AssertionError("survival train steps: card and CPU disagree")
    out["train"] = {"loss_diff": dstep, "card": steps["card"],
                    "cpu": steps["cpu"]}
    return out


def ffn_config():
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    base = c16_r50()
    return dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, ffn=True, drop_path=0.1))


def phase_ffn(dev):
    """c16_r50 with ffn=True, drop_path=0.1 at full width: Engine.evaluate
    (every batch through K10, never K8) against the CPU run of the same
    weights, and Engine.train_epoch with dropout and stochastic depth on
    (every step through K10 and K11), batch size 2; counters set to 0 just
    before each path and read just after."""
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
    cfg = ffn_config()
    rng = np.random.default_rng(5)
    bags = [rng.standard_normal((n, cfg.input_dim), dtype=np.float32)
            for n in FFN_BAGS]
    ds = ArrayDataset(bags, [i % 2 for i in range(len(bags))])
    ecfg = EngineConfig(batch_size=2)
    model = build_model(cfg, device=dev, seed=0)
    eng = counting(Engine)(model, ecfg, cfg.encoder, device=dev)
    order = list(range(len(ds)))
    n_batches = len(eng._batched_order(ds, order))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, labs, loss = eng.evaluate(ds)
    secs = time.perf_counter() - t0
    eval_launches = launches_now()
    check_launches(eng.records["eval"], FFN_EVAL, "FFN evaluate", n_batches)
    cpu = build_model(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    probs_c, _, loss_c = Engine(cpu, ecfg, cfg.encoder,
                                device="cpu").evaluate(ds)
    diff = float(np.abs(probs - probs_c).max())
    ok = diff <= PROB_TOL and abs(loss - loss_c) <= PROB_TOL
    log(f"[7] FFN Engine.evaluate on bags {FFN_BAGS}: {secs:.2f} s, mean "
        f"loss {loss:.6f} (CPU {loss_c:.6f}), max |probs card - cpu| "
        f"{diff:.3e} (tol {PROB_TOL}), launches {eval_launches} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("FFN evaluate: card and CPU disagree")
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.train_epoch(ds, 0, order=order)
    torch.cuda.synchronize()
    tsecs = time.perf_counter() - t0
    train_launches = launches_now()
    per_step = eng.records["train"]
    step_losses = [float(r["out"][0]) for r in per_step]
    log(f"[7] FFN Engine.train_epoch (dropout and drop_path on): "
        f"{tsecs:.2f} s, step losses {np.round(step_losses, 6).tolist()}, "
        f"launches {train_launches}")
    check_launches(per_step, FFN_TRAIN, "FFN train", n_batches)
    if not (np.isfinite(step_losses).all() and all(
            torch.isfinite(p).all() for p in model.parameters())):
        raise AssertionError("FFN training gave a non-finite value")
    return {"eval_seconds": secs, "eval_launches": eval_launches,
            "max_prob_diff": diff, "loss": loss, "loss_cpu": loss_c,
            "train_seconds": tsecs, "launches": train_launches,
            "step_losses": step_losses}


def phase_unmasked(dev):
    """c16_r50 called without a mask on a 9000-patch bag (the unfused
    structure: K5 with EPEG per R-MSA region, then K12 -> K5 -> K13), card
    vs CPU on the same weights: probabilities within PROB_TOL."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.models.rrt import build_model
    cfg = c16_r50()
    x = _randn((1, 9000, cfg.input_dim), _gen(9))
    model = build_model(cfg, device=dev, seed=0)
    reset_counters()
    with torch.no_grad():
        logits = model(x.to(dev)).float().cpu()
    launches = launches_now()
    cpu = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        logits_c = cpu(x)
    dp = (torch.softmax(logits, -1) - torch.softmax(logits_c, -1)).abs().max()
    want = [K[4], K[11], K[12]]
    ok = dp.item() <= PROB_TOL and all(launches[n] >= 1 for n in want) \
        and launches[K[0]] == 0
    log(f"[7] unmasked c16_r50 forward, L=9000: logits "
        f"{logits.numpy().round(5).tolist()} vs CPU "
        f"{logits_c.numpy().round(5).tolist()}, max prob diff {dp.item():.3e} "
        f"(tol {PROB_TOL}), launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the unmasked forward disagrees with the CPU or "
                             "missed a kernel")
    return {"max_prob_diff": dp.item(), "launches": launches}


def k13_library_call(args, mmd):
    """K13 as one PyTorch call: torch.bmm(w^T, reps) on w and reps cast to
    the mm dtype beforehand.  Timed only: the port never calls it."""
    w, reps = args
    wt, rm = w.transpose(1, 2).to(mmd), reps.to(mmd)
    return lambda: torch.bmm(wt, rm)


def phase_times_slice3(dev, rows):
    """K10 and K11 at the c16_r50 + FFN shape of a 9000-patch bag for B in
    {1, 8}, K12 and K13 at a 45000-patch survival bag (B = 1): f32 stream,
    bf16 products, CUDA events, beside the bound from these inputs, the
    plain version and (K13) torch.bmm."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    mmd = torch.bfloat16
    cases = {}
    for b in (1, 8):
        x, mask, w, reps, gout = grid_redistribute_inputs(
            b, 96, 12, 1, dev, torch.float32, 500 + b)
        cases[("K10 crmsa_redistribute_grid", b)] = (
            ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
            (x, mask, w, reps, 96, 12, True))
        cases[("K11 crmsa_redistribute_grid_bwd", b)] = (
            ck.crmsa_redistribute_grid_bwd, ck.redistribute_grid_bwd_plain,
            (mask, w, reps, gout, 96, 12))
    regions, phi, w, reps = surv_region_inputs(45000, 216, 27, dev,
                                               torch.float32, 600)
    cases[("K12 crmsa_compress", 1)] = (ck.crmsa_compress, ck.compress_plain,
                                        (regions, phi))
    cases[("K13 crmsa_redistribute", 1)] = (
        ck.crmsa_redistribute, ck.redistribute_plain, (w, reps))
    for (name, b), (fn, plain, args) in cases.items():
        ms = time_ms(lambda: fn(*args, mm_dtype=mmd))
        plain_ms = time_ms(lambda: plain(*args, mm_dtype=mmd), iters=5,
                           warmup=1)
        lib_ms = None
        if name.startswith("K13"):
            lib = k13_library_call(args, mmd)
            _library_check(name, (lib(),), (plain(*args, mm_dtype=mmd),))
            lib_ms = time_ms(lib)
        flops, byts = work_from_args(name, args)
        bms, by = bound_ms(flops, byts, mmd)
        rec = rows.setdefault(name, {})[str(b)] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "flops": flops, "bytes": byts}
        log(f"[4] {name:32s} B={b}: {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"bound {bms:.4f} by {by}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'})")
        if name.startswith(("K11", "K12")):
            split = device_split(lambda: fn(*args, mm_dtype=mmd), iters=5)
            rec["device_ms"] = sum(split.values())
            rec["device_split"] = {k[:80]: v for k, v in split.items()}
            log(f"[4]   device {rec['device_ms']:.4f} ms: " + "; ".join(
                f"{v:.4f} {k[:60]}" for k, v in sorted(
                    split.items(), key=lambda kv: -kv[1])))
        if name.startswith("K11"):
            rec["host_ms"] = host_ms(lambda: fn(*args, mm_dtype=mmd))
            log(f"[4]   host {rec['host_ms']:.4f} ms per call")
    del cases
    torch.cuda.empty_cache()
    return rows


def device_split(fn, iters=10, tries=3):
    """{kernel name: device ms per call of `fn`} from torch.profiler over
    `iters` calls (self device time).  A window in which the profiler
    recorded no device time at all is taken again, up to `tries` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {ev.key: ev.self_device_time_total / 1e3 / iters
                 for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA
                 and ev.self_device_time_total > 0}
        if split:
            return split
    return {}


def device_ms(fn, iters=10):
    """Device time per call of `fn`: its kernels' profiled device time."""
    return sum(device_split(fn, iters).values())


def host_ms(fn, iters=50):
    """Host time per call of `fn`: the wall clock of `iters` calls that only
    enqueue their launches (no wait for the card inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / iters


def interleaved_ms(fns, rounds=PAIR_ROUNDS, iters=20):
    """{name: median ms} of the callables in `fns`, timed with CUDA events
    in `rounds` rounds that alternate their order (a, b, ..., then ..., b,
    a), and every round's readings."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    names = list(fns)
    got = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            got[n].append(time_ms(fns[n], iters=iters, warmup=1))
    return {n: float(np.median(v)) for n, v in got.items()}, got


def phase_times_pairs(dev, rows):
    """K5, K6 and K7 against their library calls at c16_r50's shapes (B in
    {1, 8}) and with brca_r50's 512-wide head (R = 3B, P = 64), and K13
    against torch.bmm at the 45000-patch survival bag, each pair timed in
    one interleaved run (median of PAIR_ROUNDS rounds; K7's library time is
    SDPA forward + backward minus the forward, both in the same run); each
    beside its device time per call (profiler) and host time per call.  f32
    stream, bf16 products; K6 and K7 get q, k, v (and g) in bf16, as K5's
    backward hands them over on the main path (the library call gets the
    same bf16 tensors), and again in f32 (keys "<B> f32", the operands
    the earlier timing used).  The medians replace phase 4's single readings of these
    kernels."""
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    mmd = torch.bfloat16
    k5, k6, k7, k13 = K[4], K[5], K[6], K[12]
    cases = {}
    for b in (1, 8):
        kc = kernel_cases(b, dev, torch.float32)
        cases[(k5, str(b))] = kc[k5]
        for name in (k6, k7):
            fn, plain, args = kc[name]
            cases[(name, str(b))] = (fn, plain, tuple(
                a.to(mmd) if isinstance(a, torch.Tensor) else a
                for a in args))
            cases[(name, f"{b} f32")] = kc[name]
        g = _gen(700 + b)
        x = _randn((3 * b, 64, 512), g).to(dev)
        cases[(k5, f"{b} hd=512")] = (
            rb.region_block_fused, rb.region_block_plain,
            (x, *layer_weights(512, 1, 512, 0, g, dev)))
        q, k, v, ga = (_randn((3 * b, 1, 64, 512), g).to(dev).to(mmd)
                       for _ in range(4))
        cases[(k6, f"{b} hd=512")] = (
            ra.region_attention_fused, ra.region_attention_plain,
            (q, k, v, None, None, 1.0))
        cases[(k7, f"{b} hd=512")] = (
            rab.region_attention_bwd, rab.region_attention_bwd_plain,
            (q, k, v, None, None, ga, 1.0))
    regions, phi, w, reps = surv_region_inputs(45000, 216, 27, dev,
                                               torch.float32, 600)
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    cases[(k13, "1")] = (ck.crmsa_redistribute, ck.redistribute_plain,
                         (w, reps))
    for (name, key), (fn, plain, args) in cases.items():
        kernel = lambda: fn(*args, mm_dtype=mmd)
        want = _as_tuple(plain(*args, mm_dtype=mmd))
        if name == k5:
            lib = k5_library_call(args, mmd)
            _library_check(f"{name} ({key})", (lib().transpose(0, 1),), want)
            fns = {"kernel": kernel, "library": lib}
        elif name == k13:
            lib = k13_library_call(args, mmd)
            _library_check(f"{name} ({key})", (lib(),), want)
            fns = {"kernel": kernel, "library": lib}
        else:
            q, k, v = args[:3]
            g = args[5] if name == k7 else cases[(k7, key)][2][5]
            fwd, fwd_bwd = attention_library_calls(
                (q, k, v, None, None, g, args[-1]), mmd)
            if name == k6:
                _library_check(f"{name} ({key})", (fwd(),), want)
                fns = {"kernel": kernel, "library": fwd}
            else:
                _library_check(f"{name} ({key})", fwd_bwd(), want[:3])
                fns = {"kernel": kernel, "library_fwd_bwd": fwd_bwd,
                       "library_fwd": fwd}
        med, rounds = interleaved_ms(fns)
        if name == k7:
            lib_ms = max(0.0, med["library_fwd_bwd"] - med["library_fwd"])
            lib_dev = max(0.0, device_ms(fns["library_fwd_bwd"])
                          - device_ms(fns["library_fwd"]))
            lib_host = max(0.0, host_ms(fns["library_fwd_bwd"])
                           - host_ms(fns["library_fwd"]))
        else:
            lib_ms, lib_dev = med["library"], device_ms(fns["library"])
            lib_host = host_ms(fns["library"])
        rec = rows.setdefault(name, {}).setdefault(key, {})
        if "plain_ms" not in rec:
            rec["plain_ms"] = time_ms(lambda: plain(*args, mm_dtype=mmd),
                                      iters=5, warmup=1)
        if "bound_ms" not in rec:
            flops, byts = work_from_args(name, args)
            rec["bound_ms"], rec["bound_by"] = bound_ms(flops, byts, mmd)
            rec.update(flops=flops, bytes=byts)
        split = device_split(kernel)
        rec.update({"ms": med["kernel"], "library_ms": lib_ms,
                    "device_ms": sum(split.values()),
                    "device_split": {k[:60]: v for k, v in split.items()},
                    "library_device_ms": lib_dev,
                    "host_ms": host_ms(kernel), "library_host_ms": lib_host,
                    "interleaved_rounds": rounds})
        if name == k7 and "hd=512" in key:
            # the query side's design choice: one or two 64-wide dq chunks a
            # block (device time, alternating 2, 1, 1, 2)
            chosen, by = rab.DQ_CHUNKS, {}
            for n in (2, 1, 1, 2):
                rab.DQ_CHUNKS = n
                by.setdefault(str(n), []).append(device_ms(kernel))
            rab.DQ_CHUNKS = chosen
            rec["device_ms_by_dq_chunks"] = {n: float(np.mean(v))
                                             for n, v in by.items()}
            log(f"[4]   K7 device ms by dq chunks a block: "
                f"{rec['device_ms_by_dq_chunks']}")
        log(f"[4] {name:28s} B={key:9s} interleaved x{PAIR_ROUNDS}: kernel "
            f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}, host "
            f"{rec['host_ms']:.4f}) vs library {lib_ms:.4f} ms (device "
            f"{lib_dev:.4f}, host {lib_host:.4f}); plain "
            f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f} by "
            f"{rec['bound_by']}")
        log(f"[4]   device split: " + "; ".join(
            f"{v:.4f} {k[:50]}" for k, v in sorted(split.items(),
                                                   key=lambda kv: -kv[1])))
    del cases
    torch.cuda.empty_cache()
    return rows


def surv_train_setup(dev, length):
    """A survival_default engine on the card (dropout on) and one bag of
    `length` patches, device-resident; returns a train-step closure."""
    from rrtmil_tpu_torch.config import survival_default
    from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                    SurvivalEngineConfig)
    cfg = survival_default()
    eng = SurvivalEngine(_surv_model(cfg, dev), SurvivalEngineConfig(),
                         cfg.encoder, device=dev)
    eng.model.train()
    bag = _randn((length, cfg.input_dim), _gen(length)).numpy()
    x, mask, spec = eng._prep(bag)
    label = torch.tensor([1], device=dev)
    cens = torch.tensor([0.0], device=dev)

    def step():
        eng._train_step(x, mask, label, cens, spec.repr_length)
    return step


def phase_survival_throughput(dev):
    """Survival train bags/s (forward, backward and the Adam update, dropout
    on, B = 1) at L = 45000 (grids 224 / 216: K12 / K13) and L = 50000
    (224 / 224: K3 / K8), with peak memory."""
    out = {}
    for length in (45000, 50000):
        step = surv_train_setup(dev, length)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[str(length)] = {"ms_per_step": ms, "bags_per_s": 1e3 / ms,
                            "peak_mem_gib": peak}
        log(f"[4] survival train L={length} B=1: {ms:.3f} ms/step, "
            f"{1e3 / ms:.3f} bags/s, peak {peak:.2f} GiB")
        del step
        torch.cuda.empty_cache()
    return out


def phase_ffn_throughput(dev):
    """The FFN / drop-path config at L = 9000, B = 8: forward slides/s (eval)
    and train slides/s (dropout and drop_path on), with peak memory."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    cfg = ffn_config()
    eng, step, _ = train_setup(dev, 8, cfg)
    spec = bucket_for(9000, cfg.encoder)
    x = torch.zeros((8, spec.data_length, cfg.input_dim))
    x[:, :9000] = _randn((8, 9000, cfg.input_dim), _gen(8))
    x = x.to(dev)
    mask = (torch.arange(spec.data_length) < 9000)[None].expand(8, -1) \
        .contiguous().to(dev)
    out = {}
    eng.model.eval()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = time_ms(lambda: eng.model(x, mask=mask, length=spec.repr_length),
                     iters=10, warmup=2)
    out["forward"] = {"ms_per_batch": ms, "slides_per_s": 8e3 / ms,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    eng.model.train()
    torch.cuda.reset_peak_memory_stats()
    ms_t = time_ms(step, iters=5, warmup=2)
    out["train"] = {"ms_per_step": ms_t, "slides_per_s": 8e3 / ms_t,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[4] FFN + drop_path L=9000 B=8: forward {ms:.3f} ms/batch "
        f"({8e3 / ms:.2f} slides/s), train {ms_t:.3f} ms/step "
        f"({8e3 / ms_t:.2f} slides/s)")
    del eng, step, x
    torch.cuda.empty_cache()
    return out


def profile_naming(key, want, take, tries=3):
    """The profile `take()` returns, checked to name every kernel of
    `want`.  A window in which the profiler recorded fewer kernels on the
    device than launches on the host lost device records: when it misses a
    kernel of `want` it is kept in the profile's "dropped_windows" and
    taken again, up to `tries` windows in all.  A window with every kernel
    recorded that misses one raises."""
    dropped = []
    for _ in range(tries):
        prof = take()
        seen = set(prof["compress_kernels"]) | set(prof["redistribute_kernels"])
        missing = sorted(want - seen)
        if not missing:
            prof["dropped_windows"] = dropped
            return prof
        window = {k: prof[k] for k in (
            "wall_ms_per_iter", "events_ms_per_iter",
            "kernel_ms_per_iter", "launches_recorded", "kernels_recorded")}
        window["missing"] = missing
        log(f"[5] {key} names no {missing}: {json.dumps(window)}")
        if prof["kernels_recorded"] >= prof["launches_recorded"]:
            raise AssertionError(f"{key} names no {missing} in a window that "
                                 f"recorded every kernel it launched")
        dropped.append(window)
    raise AssertionError(f"{key}: the profiler dropped device records in "
                         f"{tries} windows")


# ---------------------------------------------------------------------------
# slice 15: fold-parallel cross-validation (--fold_parallel)
# ---------------------------------------------------------------------------

FOLDS = 5
FOLD_BAG = 9000                 # (b): a c16_r50 bag a fold, G = 96
FOLD_SURV_BAG = 45000           # (c): survival grids 224 / 216: K12 / K13
# the CPU checks' bags (its plain versions at 9000 and 45000 patches, five
# folds, two steps would take minutes): 2213 (G = 48) and 1500 (grids 48 /
# 40: K12 / K13 too)
FOLD_CPU_BAG, FOLD_SURV_CPU_BAG = 2213, 1500
FOLD_STEPS = 2
FOLD_TIME_ROUNDS = 3            # (par, seq, seq, par) rounds, 2 steps each
CLI_FOLD_RUN = ["--cv_fold", "5", "--num_epoch", "2", "--seed", "2021"]
SCLI_FOLD_RUN = ["--num_epoch", "2", "--seed", "1", "--model", "RRTMIL"]


def _fold_args(per_fold, kinds):
    """The fold form of FOLDS argument lists: each fold's rows in turn
    (`rows`), each fold's weights stacked (`weight`), the rest fold 0's."""
    out = []
    for i, kind in enumerate(kinds):
        vals = [a[i] for a in per_fold]
        if kind == "rows":
            out.append(torch.cat(vals))
        elif kind == "weight" and vals[0] is not None:
            out.append(torch.stack(vals))
        else:
            out.append(vals[0])
    return out


def _fold_part(t, kind, f):
    if t is None:
        return None
    if kind == "rows":
        n = t.shape[0] // FOLDS
        return t[f * n:(f + 1) * n]
    return t[f]


def fold_kernel_items(dev, sdt):
    """[(name, wrapper, plain version, FOLDS argument lists, argument kinds,
    output kinds)] of K1-K13 at the main path's shapes (one 9000-patch bag a
    fold for K1-K11, G = 96; K6 / K7 as K5's backward runs them and, with
    per-fold EPEG taps, at P = 144; K12 / K13 at a 45000-patch survival
    bag), every fold with a stream and weights of its own."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    R, W = "rows", "weight"
    per = [kernel_cases(1, dev, sdt, seed=500 + f) for f in range(FOLDS)]
    items = []
    layer = (R, R) + (W,) * 12
    kinds = {"K1 region_layer_fused": (layer + (None,) * 3, (R,)),
             "K2 region_layer_bwd": (layer + (R,) + (None,) * 3,
                                     (R,) + (W,) * 12),
             "K3 crmsa_compress_grid": ((R, R, W, W, W, None, None), (R, R)),
             "K4 crmsa_compress_grid_bwd": ((R, R, W, W, W, R, R, None, None),
                                            (R, W, W, W)),
             "K5 region_block_fused": ((R,) + (W,) * 10, (R,)),
             "K6 region_attention_fused": ((R, R, R, None, None, None), (R,)),
             "K7 region_attention_bwd": ((R, R, R, None, None, R, None),
                                         (R, R, R, W, W)),
             "K8 crmsa_redistribute_grid_ln": (
                 (R, R, R, R, W, W, R, None, None), (R,)),
             "K9 crmsa_redistribute_grid_ln_bwd": (
                 (R, R, R, R, W, W, R, R, None, None), (R, R, R, W, W, R))}
    for name, (ak, ok) in kinds.items():
        fn, plain, _ = per[0][name]
        items.append((name, fn, plain, [p[name][2] for p in per], ak, ok))
    grid = [grid_redistribute_inputs(1, 96, 12, 1, dev, sdt, 600 + f)
            for f in range(FOLDS)]
    items.append(("K10 crmsa_redistribute_grid", ck.crmsa_redistribute_grid,
                  ck.redistribute_grid_plain,
                  [(x, m, w, r, 96, 12, True) for x, m, w, r, _ in grid],
                  (R, R, R, R, None, None, None), (R,)))
    items.append(("K11 crmsa_redistribute_grid_bwd",
                  ck.crmsa_redistribute_grid_bwd,
                  ck.redistribute_grid_bwd_plain,
                  [(m, w, r, go, 96, 12) for _, m, w, r, go in grid],
                  (R, R, R, R, None, None), (R, R)))
    surv = [surv_region_inputs(FOLD_SURV_BAG, 216, 27, dev, sdt, 700 + f)
            for f in range(FOLDS)]
    items.append(("K12 crmsa_compress", ck.crmsa_compress, ck.compress_plain,
                  [(x, phi) for x, phi, _, _ in surv], (R, W), (R, R)))
    items.append(("K13 crmsa_redistribute", ck.crmsa_redistribute,
                  ck.redistribute_plain, [(w, r) for _, _, w, r in surv],
                  (R, R), (R,)))
    taps = []
    for f in range(FOLDS):
        g = _gen(800 + f)
        q, k, v, ga = (_randn((16, 8, 144, 64), g).to(dev).to(sdt)
                       for _ in range(4))
        taps.append((q, k, v, _randn((8, 15), g, 0.3).to(dev),
                     _randn((8,), g, 0.1).to(dev), ga))
    items.append(("K6 region_attention_fused (P=144, k=15)",
                  ra.region_attention_fused, ra.region_attention_plain,
                  [(q, k, v, pw, pb, 0.125) for q, k, v, pw, pb, _ in taps],
                  (R, R, R, W, W, None), (R,)))
    items.append(("K7 region_attention_bwd (P=144, k=15)",
                  rab.region_attention_bwd, rab.region_attention_bwd_plain,
                  [(q, k, v, pw, pb, ga, 0.125)
                   for q, k, v, pw, pb, ga in taps],
                  (R, R, R, W, W, R, None), (R, R, R, W, W)))
    return items


def _fold_bound(name, per_fold, sdt, mdt):
    """bound_ms of the FOLDS folds' work: each fold's inputs read once and
    outputs written once (its weights included), summed over the folds."""
    key = name.split(" (")[0]
    if key.startswith(("K5", "K6", "K7", "K10", "K11", "K12", "K13")):
        flops, byts = map(sum, zip(*[work_from_args(key, a)
                                     for a in per_fold]))
    else:
        flops, byts = (FOLDS * v for v in work_of(key, 1, sdt, mdt))
    return bound_ms(flops, byts, mdt)


def phase_fold_kernels(dev):
    """(a) K1-K13 fold-batched (FOLDS folds in one launch) against each
    fold's own launch and each fold's plain version, in the three dtype
    pairs: TOL of max(1, max|reference|), the same bits on a second call,
    the wrapper's counter up by exactly one; the fold form of one fold
    gives the call without a fold axis bit for bit.  In the main path's pair (f32
    stream, bf16 products) the fold launch's ms beside the FOLDS per-fold
    launches', the plain fold form's and the folds' bound."""
    fns = all_counters()
    report = {"errors": {}, "times": {}}
    for sdt, mdt in DTYPE_PAIRS:
        pair = f"{dname(sdt)}/{dname(mdt)}"
        for name, fn, plain, per_fold, kinds, out_kinds in \
                fold_kernel_items(dev, sdt):
            key = name.split(" (")[0]
            args = _fold_args(per_fold, kinds)
            reset_counters()
            got = _as_tuple(fn(*args, mm_dtype=mdt))
            launches = launches_now()
            if launches[key] != 1 or sum(launches.values()) != 1:
                raise AssertionError(f"[15] {name}: the fold call launched "
                                     f"{launches}, not {key} once")
            again = _as_tuple(fn(*args, mm_dtype=mdt))
            for a, b in zip(got, again):
                if a is not None and not torch.equal(a, b):
                    raise AssertionError(f"[15] {name}: two fold calls differ")
            one = _as_tuple(fn(*_fold_args(per_fold[:1], kinds), mm_dtype=mdt))
            base = _as_tuple(fn(*per_fold[0], mm_dtype=mdt))
            for a, b, kind in zip(one, base, out_kinds):
                a = a if a is None or kind == "rows" else a[0]
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"[15] {name}: one fold's fold form "
                                         f"differs from the plain call")
            worst = {"launch": 0.0, "plain": 0.0}
            for f in range(FOLDS):
                refs = {"launch": _as_tuple(fn(*per_fold[f], mm_dtype=mdt)),
                        "plain": _as_tuple(plain(*per_fold[f], mm_dtype=mdt))}
                for ref, want in refs.items():
                    for i, (a, b, kind) in enumerate(zip(got, want,
                                                         out_kinds)):
                        a = _fold_part(a, kind, f)
                        if a is None or b is None:
                            if (a is None) != (b is None):
                                raise AssertionError(f"[15] {name} output "
                                                     f"{i}: None on one side")
                            continue
                        if a.shape != b.shape or not torch.isfinite(
                                a.float()).all():
                            raise AssertionError(f"[15] {name} output {i}: "
                                                 f"{tuple(a.shape)} vs "
                                                 f"{tuple(b.shape)}")
                        e = (a.float() - b.float()).abs().max().item() / max(
                            1.0, b.float().abs().max().item())
                        worst[ref] = max(worst[ref], e)
            ok = max(worst.values()) <= TOL[mdt]
            log(f"[15] (a) {name:44s} {pair:17s} fold vs per-fold launches "
                f"{worst['launch']:.3e}, vs plain {worst['plain']:.3e} "
                f"(tol {TOL[mdt]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[15] {name} {pair}: {worst}")
            report["errors"].setdefault(key, {})[pair + name[len(key):]] = \
                worst
            if (sdt, mdt) == DTYPE_PAIRS[0]:
                ms = time_ms(lambda: fn(*args, mm_dtype=mdt), iters=10)
                per_ms = time_ms(lambda: [fn(*a, mm_dtype=mdt)
                                          for a in per_fold], iters=10)
                plain_ms = time_ms(lambda: [plain(*a, mm_dtype=mdt)
                                            for a in per_fold], iters=3,
                                   warmup=1)
                bms, by = _fold_bound(name, per_fold, sdt, mdt)
                report["times"][name] = {"ms": ms, "per_fold_launches_ms":
                                         per_ms, "plain_ms": plain_ms,
                                         "bound_ms": bms, "bound_by": by}
                log(f"[15] (a) {name:44s} {FOLDS} folds: {ms:.3f} ms in one "
                    f"launch, {per_ms:.3f} ms in {FOLDS}, plain {plain_ms:.3f}"
                    f", bound {bms:.4f} ({by})")
        torch.cuda.empty_cache()
    for f in fns.values():
        f.launches = 0
    return report


def _fold_bags(cfg, length, dev, seed, dtype=torch.float32):
    """FOLDS bags of `length` patches (each its own), padded to their bucket
    on the card: x (FOLDS, 1, N, D), mask (FOLDS, 1, N), spec."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    spec = bucket_for(length, cfg.encoder)
    g = _gen(seed)
    x = torch.zeros((FOLDS, 1, spec.data_length, cfg.input_dim))
    x[:, :, :length] = _randn((FOLDS, 1, length, cfg.input_dim), g)
    mask = (torch.arange(spec.data_length) < length)[None, None].expand(
        FOLDS, 1, -1).contiguous()
    return x.to(dtype).to(dev), mask.to(dev), spec


def _fold_engines(cfg, dev, surv=False, lrs=None, name=None):
    """FOLDS engines of `cfg` (seeds 0 ..), each fold its own weights and
    optimizer; survival ones with the per-fold lrs `lrs`; with `name`, the
    zoo model of that name with cfg's encoder (--only_rrt_enc) and cfg's
    dropout, its engine reading loss(logits) alone, as a fold step does."""
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
    from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                    SurvivalEngineConfig)
    engines = []
    for f in range(FOLDS):
        if name:
            eng = Engine(zoo.build_model(name, input_dim=cfg.input_dim,
                                         dropout=cfg.dropout,
                                         rrt_cfg=cfg.encoder, device=dev,
                                         seed=f),
                         EngineConfig(), cfg.encoder, device=dev)
        elif surv:
            eng = SurvivalEngine(_surv_model(cfg, dev, seed=f),
                                 SurvivalEngineConfig(), cfg.encoder,
                                 device=dev)
            for group in eng.optimizer.param_groups:
                group["lr"] = lrs[f]
        else:
            eng = Engine(build_model(cfg, device=dev, seed=f), EngineConfig(),
                         cfg.encoder, device=dev)
        eng.generator.manual_seed(f)
        eng.model.train()
        engines.append(eng)
    return engines


def _fold_runner(engines, x, mask, y, cens, spec, surv):
    """(parallel step, sequential steps): one fold-parallel step with each
    engine's update, and the FOLDS engines' own batch-1 steps."""
    from rrtmil_tpu_torch.harness.survival import _update
    from rrtmil_tpu_torch.parallel.folds import (make_fold_parallel_step,
                                                 make_fold_parallel_surv_step,
                                                 stack_states)
    models = [e.model for e in engines]
    stacked = stack_states(models)
    gens = [e.generator for e in engines]
    if surv:
        step = make_fold_parallel_surv_step(models, stacked, engines[0]._loss,
                                            spec.repr_length)
    else:
        step = make_fold_parallel_step(models, stacked, engines[0]._loss,
                                       spec.repr_length)

    def par():
        out = step(x, mask, y, cens, gens) if surv else \
            step(x, mask, y, gens)
        for e in engines:
            if surv:
                _update(e)
            else:
                e._apply_grads(e.cfg.lr)
        return out[0] if surv else out

    def seq():
        losses = []
        for f, e in enumerate(engines):
            if surv:
                loss, _ = e._train_step(x[f], mask[f], y[f], cens[f],
                                        spec.repr_length)
            else:
                loss = e._train_step(x[f], mask[f], y[f],
                                     spec.repr_length)[0]
                e._apply_grads(e.cfg.lr)
            losses.append(loss)
        return torch.stack(losses)
    return par, seq


def _fold_states(engines):
    return [{n: p.detach().cpu().clone()
             for n, p in e.model.named_parameters()} for e in engines]


def _fold_inputs(cfg, length, dev, surv, seed):
    x, mask, spec = _fold_bags(cfg, length, dev, seed)
    y = (torch.arange(FOLDS)[:, None] % (4 if surv else 2)).to(dev)
    cens = (torch.arange(FOLDS)[:, None] % 2).float().to(dev)
    return x, mask, y, cens, spec


def _fold_steps(cfg, dev, surv, lrs, inputs, kind, expect=None, name=None):
    """FOLD_STEPS steps of fresh engines (seeds 0 ..) on `inputs`: the
    fold-parallel step (`par`, each step required to launch each kernel of
    `expect` once and no other, when given) or the folds' own batch-1 steps
    (`seq`); returns (losses (FOLD_STEPS, FOLDS), the parameters, the
    launches of all the steps)."""
    engines = _fold_engines(cfg, dev, surv, lrs, name)
    par, seq = _fold_runner(engines, *inputs, surv)
    losses = []
    reset_counters()
    for _ in range(FOLD_STEPS):
        before = launches_now()
        losses.append((par if kind == "par" else seq)().cpu())
        if expect is not None:
            now = launches_now()
            _exactly_once({n: now[n] - before[n] for n in now}, expect, 1,
                          "a fold-parallel step")
    return torch.stack(losses), _fold_states(engines), launches_now()


def _fold_close(tag, got, want, lr_max, ref, ph="15", name=None):
    """Per-step losses within 1e-4 and each fold's parameters within Adam's
    drift bound; a zoo model's (`name`) through _zoo_params_close."""
    (lg, sg), (lw, sw) = got, want
    loss_err = ((lg - lw).abs() / lw.abs().clamp_min(1.0)).max().item()
    close = _zoo_params_close if name else _adam_params_close
    drift = [close(a, b, lr_max, FOLD_STEPS, 1e-3) for a, b in zip(sg, sw)]
    ok = loss_err <= 1e-4 and all(d[0] for d in drift)
    out = {"loss_err": loss_err, "param_err": max(d[1] for d in drift),
           "param_frac": max(d[2] for d in drift)}
    log(f"[{ph}] {tag}: fold-parallel on the card vs {ref}: losses "
        f"{loss_err:.2e}, parameters {out['param_err']:.2e} (bound "
        f"{2 * FOLD_STEPS * lr_max * ADAM_STEP:.2e}, frac "
        f"{out['param_frac']:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{ph}] {tag} vs {ref}: {out}")
    return out


def _fold_check(tag, dev, cfg, length, cpu_length, surv, expect, lrs=None,
                name=None, ph="15"):
    """(dropout off, f32 products, TF32 off) FOLD_STEPS fold-parallel steps
    on the card against the folds' own batch-1 steps on the card at
    `length`, and (unless `cpu_length` is None) against the same
    fold-parallel steps on the CPU at `cpu_length`: per-step losses within
    1e-4, parameters within Adam's drift bound; every parallel step on the
    card launches each kernel of `expect` once, none other.  `name`: the
    zoo model (_fold_engines)."""
    cfg = dataclasses.replace(cfg, dropout=0.0, encoder=dataclasses.replace(
        cfg.encoder, dropout=0.0, mm_dtype="float32"))
    lr_max = max(lrs) if lrs else 2e-4
    out = {}
    refs = (("sequential", length),) + (
        (("cpu", cpu_length),) if cpu_length else ())
    for ref, n in refs:
        inputs = _fold_inputs(cfg, n, "cpu", surv, 900 + n)
        card = tuple(t.to(dev) if torch.is_tensor(t) else t for t in inputs)
        got = _fold_steps(cfg, dev, surv, lrs, card, "par", expect, name)
        want = (_fold_steps(cfg, dev, surv, lrs, card, "seq", name=name)
                if ref == "sequential"
                else _fold_steps(cfg, torch.device("cpu"), surv, lrs, inputs,
                                 "par", name=name))
        out[ref] = _fold_close(f"{tag} L={n}", got[:2], want[:2], lr_max,
                               ref, ph, name)
        out[ref]["launches"] = got[2]
        torch.cuda.empty_cache()
    return out


def _fold_times(tag, dev, cfg, length, surv, expect, lrs=None, name=None,
                ph="15"):
    """A fold-parallel step (FOLDS bags, each engine's update) against the
    FOLDS folds' batch-1 steps in the default config (dropout on), host
    clock around synchronised steps, rounds (par, seq, seq, par); the
    parallel step's launches (each kernel of `expect` once) and peak
    memory."""
    inputs = _fold_inputs(cfg, length, dev, surv, 950 + length)
    par, _ = _fold_runner(_fold_engines(cfg, dev, surv, lrs, name), *inputs,
                          surv)
    _, seq = _fold_runner(_fold_engines(cfg, dev, surv, lrs, name), *inputs,
                          surv)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 2
    par(), seq()
    times = {"par": [], "seq": []}
    for _ in range(FOLD_TIME_ROUNDS):
        for kind in ("par", "seq", "seq", "par"):
            times[kind].append(clock(par if kind == "par" else seq))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    par()
    torch.cuda.synchronize()
    launches = launches_now()
    _exactly_once(launches, expect, 1, f"{tag} step")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pm, sm = float(np.median(times["par"])), float(np.median(times["seq"]))
    log(f"[{ph}] {tag}: fold-parallel step {pm:.3f} ms ({pm / FOLDS:.3f} ms a "
        f"bag) against {FOLDS} batch-1 steps {sm:.3f} ms ({sm / FOLDS:.3f} ms "
        f"a bag): {sm / pm:.2f}x; peak {peak:.2f} GiB; rounds par "
        f"{[round(t, 3) for t in times['par']]} seq "
        f"{[round(t, 3) for t in times['seq']]}")
    torch.cuda.empty_cache()
    return {"par_ms": pm, "seq_ms": sm, "speedup": sm / pm,
            "peak_mem_gib": peak, "rounds": times, "launches": launches}


def _rates(stdout, pattern, bags):
    """{epoch: train rate} from a CLI log: `pattern` finds each epoch line
    with groups (epoch, number), `bags[i]` is the i-th line's train bags
    and turns its number into seconds."""
    import re
    sums = {}
    for i, m in enumerate(re.finditer(pattern, stdout)):
        n, secs = bags[i](float(m.group(2)))
        b0, s0 = sums.get(int(m.group(1)), (0, 0.0))
        sums[int(m.group(1))] = (b0 + n, s0 + secs)
    return {e: b / s for e, (b, s) in sorted(sums.items()) if s}


def phase_fold_cli(dev):
    """(d) `python -m rrtmil_tpu_torch.main --fold_parallel` (c16_r50's
    flags, phase 9's 12 bags, 5 folds x 2 epochs) and `python -m
    rrtmil_tpu_torch.survival_main --model RRTMIL --fold_parallel` (phase
    10's 10 cases, 5 folds x 2 epochs), each a process of its own that must
    exit 0, each beside the same command without --fold_parallel: every
    epoch's train rate read from the logs."""
    import tempfile
    from rrtmil_tpu_torch import main as cli
    from rrtmil_tpu_torch.harness.classification import make_splits
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "c16")
        write_cli_data(root, False, 1024, 0)
        csv_file, _ = write_survival_data(os.path.join(tmp, "surv"))
        c16 = CLI_FOLD_RUN + CLI_C16 + ["--dataset_root", root,
                                        "--model_path",
                                        os.path.join(tmp, "out")]
        sizes = [len(s[0]) for s in make_splits(
            cli.build_parser().parse_args(c16))]
        epochs = int(CLI_FOLD_RUN[CLI_FOLD_RUN.index("--num_epoch") + 1])
        runs = {
            "cli": ("rrtmil_tpu_torch.main", c16,
                    r"Epoch \[(\d+)/\d+\].*?time: ([\d.]+)s",
                    # seconds on each line: fold-major fold-epochs, or an
                    # epoch of every fold
                    lambda par: [(lambda s, n=(sum(sizes) if par else
                                               sizes[i // epochs]): (n, s))
                                 for i in range(len(sizes) * epochs)]),
            "survival_cli": ("rrtmil_tpu_torch.survival_main",
                             SCLI_FOLD_RUN + ["--input_dim", "1024",
                                              "--excel_file", csv_file],
                             r"epoch (\d+): train loss \S+ (?:ci \S+ )?"
                             r"\(([\d.]+) bags/s\)",
                             # bags/s on each line: 8 train cases a fold
                             lambda par: [(lambda r, n=8 * (FOLDS if par
                                                            else 1):
                                           (n, n / r))
                                          for _ in range(FOLDS * epochs)])}
        for tag, (module, argv, pattern, bags) in runs.items():
            rec = {}
            for kind, flag in (("sequential", []),
                               ("fold_parallel", ["--fold_parallel"])):
                extra = (["--title", kind] if tag == "cli" else
                         ["--results_dir", os.path.join(tmp, kind)])
                stdout, secs = cli_process(module, argv + extra + flag,
                                           f"{module} {' '.join(flag)}")
                rates = _rates(stdout, pattern, bags(bool(flag)))
                if len(rates) != epochs:
                    raise AssertionError(f"[15] {tag} {kind}: epoch rates "
                                         f"{rates}: {stdout[-1500:]}")
                rec[kind] = {"seconds": secs, "train_rate_by_epoch": rates}
                log(f"[15] (d) {tag} {kind}: exit 0 in {secs:.1f} s, train "
                    f"{'slides' if tag == 'cli' else 'bags'}/s by epoch "
                    + ", ".join(f"{e}: {r:.2f}" for e, r in rates.items()))
            report[tag] = rec
    return report


def phase_slice15(dev):
    """Phase 15: fold-parallel cross-validation on the card: (a) the
    kernels' fold forms, (b) c16_r50 and (c) survival_default's RRTMIL
    fold-parallel steps (launches, the card's sequential steps and the CPU,
    times, peak memory), (d) both CLIs with --fold_parallel."""
    from rrtmil_tpu_torch.config import c16_r50, survival_default
    t0 = time.perf_counter()
    report = {"kernels": phase_fold_kernels(dev)}
    lrs = [1e-4 * (f + 1) for f in range(FOLDS)]
    for tag, cfg, length, cpu_length, surv, expect in (
            ("(b) c16_r50", c16_r50(), FOLD_BAG, FOLD_CPU_BAG, False,
             C16_TRAIN),
            ("(c) survival", survival_default(), FOLD_SURV_BAG,
             FOLD_SURV_CPU_BAG, True, SURV_MISMATCHED)):
        fl = lrs if surv else None
        report[tag[4:]] = {
            "check": _fold_check(tag, dev, cfg, length, cpu_length, surv,
                                 expect, fl),
            "times": _fold_times(f"{tag} L={length}", dev, cfg, length, surv,
                                 expect, fl)}
    report["cli"] = phase_fold_cli(dev)
    report["seconds"] = time.perf_counter() - t0
    log(f"[15] phase 15: {report['seconds']:.1f} s")
    return report

# ---------------------------------------------------------------------------
# phase 16: the head widths 32 and 128 and k up to 16 in the kernels, and
# the rest of the zoo under --fold_parallel
# ---------------------------------------------------------------------------

# (a) the new geometries at the main path's shape (a 9000-patch bag, G = 96,
# C = 512, B = 8): R-MSA head widths 32 (--n_heads 16) and 128 (--n_heads 4)
# with EPEG k = 15 and without it; K5-K7 at --crmsa_heads 16's 32; the CR-MSA
# kernels at k = 16 (timed) and 12 (checked)
GEOM_HEADS = ((16, 32), (4, 128))
GEOM_K = (16, 12)
# (b) the zoo models --fold_parallel admits, each with --only_rrt_enc
FOLD_ZOO = ("attmil", "gattmil", "clam_sb", "clam_mb", "dsmil", "transmil",
            "ibmil", "meanmil", "maxmil")
# the one of them also checked against its fold-parallel steps on the CPU
# (at FOLD_CPU_BAG patches a fold, as phase 15's c16_r50)
FOLD_ZOO_CPU = "clam_mb"
FOLD_ZOO_CLI = ("clam_mb", "dsmil", "transmil")      # (c) classification
FOLD_ZOO_SURV_CLI = ("CLAM_SB", "AttMIL")            # (c) survival
# DSMIL's bag stream reads the encoder's output only through the critical
# instances' argmax, so a fold step's loss (the bag logits alone) sends no
# gradient into the encoder: its forward kernels run, no backward
DSMIL_FOLD = (K[0], K[2], K[4], K[7])


def fold_zoo_kernels(name):
    """The kernels a fold step of zoo model `name` with --only_rrt_enc
    launches (TransMIL takes no encoder)."""
    return {"transmil": (), "dsmil": DSMIL_FOLD}.get(name, C16_TRAIN)


def geometry_cases(dev, sdt):
    """{label: (kernel, wrapper, plain version, args, (hd, kk, k))} at the
    main path's shape, B = 8 (G = 96: a 9000-patch bag)."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    from rrtmil_tpu_torch.ops.regions import region_partition
    b, G, RS, C = 8, 96, 12, 512
    nr, p = (G // RS) ** 2, RS * RS
    x, mask, g = stream_inputs(b, G, C, 9000, 1600, dev)
    x = x.to(sdt)
    ls, lb = ln_params(C, g, dev)
    gx = _randn((b, G * G, C), g, 0.1).to(dev).to(sdt)
    g32 = _randn((b, G * G, C), g, 0.1).to(dev)
    cases = {}
    for h, hd in GEOM_HEADS:
        for kk in (15, 0):
            w = layer_weights(C, h, hd, kk, g, dev)
            tag = f"hd={hd}" + (f" k={kk}" if kk else "")
            cases[f"K1 {tag}"] = ("K1", rl.region_layer_fused,
                                  rl.region_layer_plain,
                                  (x, mask, ls, lb, *w, G, RS, True),
                                  (hd, kk, 0))
            cases[f"K2 {tag}"] = ("K2", rl.region_layer_bwd,
                                  rl.region_layer_bwd_plain,
                                  (x, mask, ls, lb, *w, gx, G, RS, True),
                                  (hd, kk, 0))
    h, hd = 16, 32
    w5 = layer_weights(C, h, hd, 0, g, dev)
    x5 = _randn((b, nr, C), g).to(dev).to(sdt)
    q, k_, v, ga = (_randn((b, h, nr, hd), g).to(dev).to(sdt)
                    for _ in range(4))
    cases["K5 hd=32"] = ("K5", rb.region_block_fused, rb.region_block_plain,
                         (x5, *w5), (hd, 0, 0))
    cases["K6 hd=32"] = ("K6", ra.region_attention_fused,
                         ra.region_attention_plain,
                         (q, k_, v, None, None, 1.0), (hd, 0, 0))
    cases["K7 hd=32"] = ("K7", rab.region_attention_bwd,
                         rab.region_attention_bwd_plain,
                         (q, k_, v, None, None, ga, 1.0), (hd, 0, 0))
    regions = region_partition(x.reshape(b, G, G, C), RS).reshape(
        b * nr, p, C).contiguous()
    for k in GEOM_K:
        phi = (_randn((C, k), g, 0.05)).to(dev)
        reps = _randn((b, nr, k, C), g).to(dev)
        wgt = torch.rand((b, nr, k, p), generator=g).to(dev)
        dreps = _randn((b, nr, k, C), g, 0.1).to(dev)
        dwg = _randn((b, nr, k, p), g, 0.1).to(dev)
        sc = (_randn((b, G * G, C), g) * mask.cpu()[..., None]).to(dev) \
            .to(sdt)
        dims = (0, 0, k)
        for name, fn, plain, args in (
                ("K3", ck.crmsa_compress_grid, ck.compress_grid_plain,
                 (x, mask, ls, lb, phi, G, RS)),
                ("K4", ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain,
                 (x, mask, ls, lb, phi, dreps, dwg, G, RS)),
                ("K8", ck.crmsa_redistribute_grid_ln,
                 ck.redistribute_grid_ln_plain,
                 (x, mask, wgt, reps, ls, lb, sc, G, RS)),
                ("K9", ck.crmsa_redistribute_grid_ln_bwd,
                 ck.redistribute_grid_ln_bwd_plain,
                 (x, mask, wgt, reps, ls, lb, sc, g32, G, RS)),
                ("K10", ck.crmsa_redistribute_grid,
                 ck.redistribute_grid_plain,
                 (x, mask, wgt, reps, G, RS, True)),
                ("K11", ck.crmsa_redistribute_grid_bwd,
                 ck.redistribute_grid_bwd_plain,
                 (mask, wgt, reps, gx, G, RS)),
                ("K12", ck.crmsa_compress, ck.compress_plain,
                 (regions, phi)),
                ("K13", ck.crmsa_redistribute, ck.redistribute_plain,
                 (wgt.reshape(b * nr, k, p), reps.reshape(b * nr, k, C)))):
            cases[f"{name} k={k}"] = (name, fn, plain, args, dims)
    return cases


def phase_geometry_kernels(dev):
    """(a) Each kernel at the geometries this slice opened, against its
    plain version in two dtype pairs (f32 stream with bf16 and with f32
    products): TOL of max(1, max|plain|), the same bits on a second call,
    its counter up by one a call; in the main path's pair (f32 / bf16) the
    kernel's ms (CUDA events), its plain version's and the bound."""
    fns = all_counters()
    report = {}
    for mdt in (torch.bfloat16, torch.float32):
        cases = geometry_cases(dev, torch.float32)
        for label, (name, fn, plain, args, (hd, kk, k)) in cases.items():
            key = next(n for n in fns if n.startswith(name + " "))
            reset_counters()
            got = _as_tuple(fn(*args, mm_dtype=mdt))
            again = _as_tuple(fn(*args, mm_dtype=mdt))
            torch.cuda.synchronize()
            if fns[key].launches != 2:
                raise AssertionError(f"[16] {label}: {fns[key].launches} "
                                     f"launches for two calls")
            want = _as_tuple(plain(*args, mm_dtype=mdt))
            err = 0.0
            for i, (a, a2, w) in enumerate(zip(got, again, want)):
                if (a is None) != (w is None):
                    raise AssertionError(f"[16] {label} output {i}: None on "
                                         f"one side")
                if a is None:
                    continue
                if not torch.equal(a, a2):
                    raise AssertionError(f"[16] {label} output {i}: two "
                                         f"calls differ")
                if name == "K2" and i in (7, 10):   # zero in exact arithmetic
                    e = (a.float() - w.float()).abs().max().item()
                    if e > max(NOISE_ABS, TOL[mdt]):
                        raise AssertionError(f"[16] {label} noise gradient "
                                             f"{i}: {e:.3e}")
                    continue
                e = (a.float() - w.float()).abs().max().item() / max(
                    1.0, w.float().abs().max().item())
                err = max(err, e)
            ok = err <= TOL[mdt]
            rec = report.setdefault(label, {"kernel": key})
            rec[f"max_err_{dname(mdt)}"] = err
            line = (f"[16] (a) {label:14s} f32/{dname(mdt):9s} vs plain "
                    f"{err:.3e} (tol {TOL[mdt]:.0e}) "
                    f"{'ok' if ok else 'FAIL'}")
            if not ok:
                log(line)
                raise AssertionError(f"[16] {label} {dname(mdt)}: {err:.3e}")
            if mdt == torch.bfloat16 and not (k and k != GEOM_K[0]):
                ms = time_ms(lambda: fn(*args, mm_dtype=mdt), iters=10)
                plain_ms = time_ms(lambda: plain(*args, mm_dtype=mdt),
                                   iters=2, warmup=1)
                work = (work_of(name, 8, torch.float32, mdt, hd or 64, kk,
                                max(k, 1))
                        if name in ("K1", "K2", "K3", "K4", "K8", "K9")
                        else work_from_args(name, args))
                bms, by = bound_ms(*work, mdt)
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by)
                line += (f"; {ms:.3f} ms, plain {plain_ms:.3f}, bound "
                         f"{bms:.4f} ({by})")
            log(line)
            del got, again, want
        del cases
        torch.cuda.empty_cache()
    for f in fns.values():
        f.launches = 0
    return report


def _zoo_cli(module, argv, what, need, allowed):
    """`module`'s main(argv) in this process (the kernels already built):
    its result and seconds; every kernel of `need` launched, none past
    `allowed`."""
    import importlib
    reset_counters()
    t0 = time.perf_counter()
    out = importlib.import_module(module).main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {n: v for n, v in launches_now().items() if v}
    if not set(need) <= set(launched) <= set(allowed):
        raise AssertionError(f"[16] {what}: launched {launched}, expected "
                             f"{list(need)} and at most {list(allowed)}")
    return out, secs, launched


def phase_fold_zoo_cli(dev):
    """(c) python -m rrtmil_tpu_torch.main --fold_parallel for clam_mb and
    dsmil with --only_rrt_enc (K1-K9; DSMIL's fold steps its forward
    kernels, its ragged tails' aux loss the backward ones too) and
    transmil (no kernel), python -m rrtmil_tpu_torch.survival_main
    --fold_parallel for CLAM_SB and AttMIL (no kernel), on phases 9 / 10's
    bag sets, 5 folds; (d) c16_r50's flags with --fold_parallel --amp
    (K1-K9 in bf16)."""
    import tempfile
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "c16")
        write_cli_data(root, False, 1024, 0)
        csv_file, _ = write_survival_data(os.path.join(tmp, "surv"))
        base = CLI_FOLD_RUN + CLI_C16 + ["--dataset_root", root,
                                         "--model_path",
                                         os.path.join(tmp, "out"),
                                         "--fold_parallel"]
        runs = [(f"cli_{m}", "rrtmil_tpu_torch.main",
                 base + ["--model", m, "--title", m]
                 + ([] if m == "transmil" else ["--only_rrt_enc"]),
                 fold_zoo_kernels(m),
                 () if m == "transmil" else C16_TRAIN)
                for m in FOLD_ZOO_CLI]
        runs.append(("cli_c16_r50_amp", "rrtmil_tpu_torch.main",
                     base + ["--amp", "--title", "amp"], C16_TRAIN,
                     C16_TRAIN))
        runs += [(f"cli_survival_{m}", "rrtmil_tpu_torch.survival_main",
                  ["--num_epoch", "2", "--seed", "1", "--model", m,
                   "--input_dim", "1024", "--excel_file", csv_file,
                   "--fold_parallel", "--results_dir",
                   os.path.join(tmp, m)], (), ())
                 for m in FOLD_ZOO_SURV_CLI]
        for tag, module, argv, need, allowed in runs:
            out, secs, launched = _zoo_cli(module, argv, tag, need, allowed)
            if module.endswith(".main"):
                vals = np.array(out["auc"], dtype=float)
                what = f"test AUC by fold {np.round(vals, 3).tolist()}"
            else:
                vals = np.array(out.cindex[1:6], dtype=float)
                what = f"best c-index by fold {vals.tolist()}"
            if len(vals) != FOLDS or not np.isfinite(vals).all():
                raise AssertionError(f"[16] {tag}: {what}")
            report[tag] = {"seconds": secs, "launches": launched,
                           "metrics": vals.tolist()}
            log(f"[16] ({'d' if 'amp' in tag else 'c'}) {tag}: {secs:.1f} s, "
                f"{what}, launches {launched}")
            torch.cuda.empty_cache()
    return report

SEQ_SP = 2                          # phase 17: two ranks on the one card
SEQ_BAGS = (50000, 45000)           # (a): sharded grids 224 (rows 112 a rank)
SEQ_MAIN = (50000, "bfloat16")      # the kernels line's sharded step
SEQ_TIME_STEPS = 3
# with f32 products, the pool scorer's ReLU inputs that may change sign
# between the sharded and unsharded runs: at most this many units, each
# within this of zero (rounding of O(1) values); on an H100 80GB HBM3
# (700 W) one unit flipped at L = 45000, at 4e-8
RELU_FLIPS_MAX, RELU_FLIP_ABS = 4, 1e-5
SEQ_KERNELS = [K[4], K[5], K[6], K[11], K[12]]     # K5-K7, K12, K13
DP_BAG, DP_STEPS, DP_LR = 9000, 2, 2e-4            # (c)
# a rank waits this long in a collective before it raises (rank 0's
# one-process references run while the others wait)
SEQ_TIMEOUT = datetime.timedelta(seconds=180)


def _noise_leaf(name):
    """Parameters whose gradient is zero in exact arithmetic (a
    key-constant logit shift cancels in the softmax): rounding noise on
    both sides."""
    return "pe_bias" in name


def _grad_errors(got, want, skip_rows=None):
    """(max over parameters of |got - want| / max(1, max|want|), the
    parameter it is at, the max over the noise leaves and the key third of
    each qkv bias of |got - want|); `skip_rows` {name: rows} leaves those
    rows of a parameter out."""
    worst, worst_name, noise = 0.0, None, 0.0
    for name, b in want.items():
        a = got[name]
        rows = (skip_rows or {}).get(name)
        if rows:
            keep = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
            keep[rows] = False
            a, b = a[keep], b[keep]
        if _noise_leaf(name):
            noise = max(noise, (a - b).abs().max().item())
            continue
        if name.endswith("qkv.bias"):
            t = b.shape[0] // 3
            noise = max(noise, (a[t:2 * t] - b[t:2 * t]).abs().max().item())
            a, b = torch.cat([a[:t], a[2 * t:]]), torch.cat([b[:t], b[2 * t:]])
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        if err >= worst:
            worst, worst_name = err, name
    return worst, worst_name, noise


def _seq_value_and_grad(model, x, mask, length, world):
    """Loss and every gradient (the loss seeded at 1 / world, the
    gradients summed over the ranks when world > 1)."""
    from rrtmil_tpu_torch.parallel import collectives
    from rrtmil_tpu_torch.train.losses import nll_surv_loss
    model.train()
    model.zero_grad(set_to_none=True)
    h, s = model(x, mask=mask, length=length)
    label = torch.tensor([1], device=x.device)
    cens = torch.tensor([0.0], device=x.device)
    loss = nll_surv_loss(h, s, label, cens, alpha=0.0)
    collectives.scaled_loss(loss, world).backward()
    if world > 1:
        collectives.all_reduce_grads(model.parameters())
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def _capture(module):
    """(store, handle): store["out"] holds `module`'s last output."""
    store = {}
    handle = module.register_forward_hook(
        lambda m, i, o: store.__setitem__("out", o.detach()))
    return store, handle


def _relu_flips(pre_a, pre_b, mask):
    """The units whose ReLU input changed sign between two runs at a true
    token, and the largest |input| among those changes."""
    flips = ((pre_a > 0) != (pre_b > 0)) & mask[..., None]
    units = sorted(set(flips.nonzero()[:, -1].tolist()))
    size = torch.minimum(pre_a.abs(), pre_b.abs())[flips]
    return units, size.max().item() if size.numel() else 0.0


def _step_ms(fn, steps=SEQ_TIME_STEPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _seq_library(rank, mesh, dev):
    """(a) on this rank: for each products dtype and bag, the sharded
    forward hazards and value_and_grad (counters set to 0 just before and
    read just after), rank 0 against the unsharded port on the same card
    and weights; the sharded and unsharded steps' ms and peak memory."""
    import torch.distributed as dist
    from rrtmil_tpu_torch.config import survival_default
    from rrtmil_tpu_torch.models.rrt import RRTMIL, init_parameters
    from rrtmil_tpu_torch.models.survival import SurvivalHead
    from rrtmil_tpu_torch.parallel.collectives import all_gather
    from rrtmil_tpu_torch.parallel.seqshard import (sharded_bucket_for,
                                                    sharded_config)
    out = {}
    for mmd in ("float32", "bfloat16"):
        base = survival_default()
        cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
            base.encoder, dropout=0.0, mm_dtype=mmd))
        sharded = SurvivalHead(RRTMIL(sharded_config(cfg, mesh.sp),
                                      mesh.sp_group))
        init_parameters(sharded, torch.Generator().manual_seed(0))
        sharded = sharded.to(dev)
        for length in SEQ_BAGS:
            tag = f"L={length} {mmd} products"
            repr_len, n_pad = sharded_bucket_for(length, cfg.encoder,
                                                 mesh.sp)
            g = torch.Generator(device=dev).manual_seed(length)
            x = torch.zeros(1, n_pad, cfg.input_dim, device=dev)
            x[0, :length] = torch.randn(length, cfg.input_dim, generator=g,
                                        device=dev)
            mask = (torch.arange(n_pad, device=dev) < length)[None]
            n = n_pad // mesh.sp
            lo = mesh.sp_index * n
            xs, ms = x[:, lo:lo + n].contiguous(), mask[:, lo:lo + n]
            reset_counters()
            torch.cuda.synchronize()
            with torch.no_grad():
                sharded.eval()
                hz = sharded(xs, mask=ms, length=repr_len)[0]
            torch.cuda.reset_peak_memory_stats(dev)
            pre, hook = _capture(sharded.backbone.pool_fn.attention.fc1)
            loss, grads = _seq_value_and_grad(sharded, xs, ms, repr_len,
                                              mesh.world)
            hook.remove()
            torch.cuda.synchronize()
            rec = {"launches": launches_now(), "n_pad": n_pad,
                   "repr_length": repr_len, "slab": n,
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
            rec["step_ms"] = _step_ms(lambda: _seq_value_and_grad(
                sharded, xs, ms, repr_len, mesh.world)) if mmd == \
                SEQ_MAIN[1] else None
            pre_sh = all_gather(pre["out"], 1, mesh.sp_group)
            if rank == 0:
                ref = SurvivalHead(RRTMIL(cfg))
                init_parameters(ref, torch.Generator().manual_seed(0))
                ref = ref.to(dev)
                with torch.no_grad():
                    ref.eval()
                    hz_ref = ref(x, mask=mask, length=repr_len)[0]
                torch.cuda.reset_peak_memory_stats(dev)
                pre_ref, hook = _capture(ref.backbone.pool_fn.attention.fc1)
                loss_ref, grads_ref = _seq_value_and_grad(ref, x, mask,
                                                          repr_len, 1)
                hook.remove()
                torch.cuda.synchronize()
                rec["unsharded_peak_gb"] = \
                    torch.cuda.max_memory_allocated(dev) / 1e9
                rec["unsharded_step_ms"] = _step_ms(
                    lambda: _seq_value_and_grad(ref, x, mask, repr_len, 1)) \
                    if mmd == SEQ_MAIN[1] else None
                scale = max(1.0, hz_ref.abs().max().item())
                rec["hazards_err"] = (hz - hz_ref).abs().max().item() / scale
                rec["loss_err"] = abs(loss.item() - loss_ref.item()) / max(
                    1.0, abs(loss_ref.item()))
                # the pool scorer's ReLU on ~6 M pre-activations: with f32
                # products one within rounding of 0 can take the other side
                # in the other run, which moves its unit's row of fc1's
                # gradient by the token's whole share (a difference of the
                # two runs' rounding, not of the collectives); with bf16
                # products TOL covers the flips
                rec["relu_flips"], rec["relu_flip_abs"] = _relu_flips(
                    pre_sh, pre_ref["out"], mask)
                skip = {"backbone.pool_fn.attention.fc1.weight":
                        rec["relu_flips"]} if mmd == "float32" else None
                rec["grad_err"], rec["grad_worst"], rec["grad_noise"] = \
                    _grad_errors(grads, grads_ref, skip)
                del ref, grads_ref
            dist.barrier()
            out[tag] = rec
            del grads
            torch.cuda.empty_cache()
        del sharded
    return out


def _dp_batch(cfg, dev):
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    spec = bucket_for(DP_BAG, cfg.encoder)
    g = torch.Generator(device=dev).manual_seed(DP_BAG)
    x = torch.zeros(2, spec.data_length, cfg.input_dim, device=dev)
    x[:, :DP_BAG] = torch.randn(2, DP_BAG, cfg.input_dim, generator=g,
                                device=dev)
    mask = (torch.arange(spec.data_length, device=dev) < DP_BAG)[None] \
        .expand(2, -1).contiguous()
    return x, mask, torch.tensor([0, 1], device=dev), spec


def _dp_model(cfg, dev):
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.optim import make_optimizer
    model = build_model(cfg, device=dev, seed=0)
    return model, make_optimizer("adam", model.parameters(), DP_LR, 1e-5)


def _dp_step(rank, dev):
    """(c) on this rank: make_sharded_train_step at dp = 2, one bag a rank,
    counters set to 0 just before the steps and read just after; rank 0
    against one process at B = 2 on the same card."""
    import torch.distributed as dist
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.parallel.mesh import (global_array, local_mesh,
                                                make_mesh)
    from rrtmil_tpu_torch.parallel.train import make_sharded_train_step
    from rrtmil_tpu_torch.train.losses import cross_entropy
    mesh = make_mesh(dp=2, sp=1)
    base = c16_r50()
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))
    x, mask, y, spec = _dp_batch(cfg, dev)
    model, opt = _dp_model(cfg, dev)
    step = make_sharded_train_step(model, opt, cross_entropy, mesh,
                                   spec.repr_length)
    xs, ms, ys = (global_array(t, mesh, ("dp",)) for t in (x, mask, y))
    reset_counters()
    torch.cuda.synchronize()
    losses = torch.stack([step(xs, ms, ys) for _ in range(DP_STEPS)])
    torch.cuda.synchronize()
    rec = {"launches": launches_now(), "losses": losses.tolist()}
    got = {n: p.detach().clone() for n, p in model.named_parameters()}
    rec["step_ms"] = _step_ms(lambda: step(xs, ms, ys))
    if rank == 0:
        ref, ref_opt = _dp_model(cfg, dev)
        ref_step = make_sharded_train_step(ref, ref_opt, cross_entropy,
                                           local_mesh(dev),
                                           spec.repr_length)
        ref_losses = torch.stack([ref_step(x, mask, y)
                                  for _ in range(DP_STEPS)])
        rec["ref_losses"] = ref_losses.tolist()
        rec["loss_err"] = ((losses - ref_losses).abs() /
                           ref_losses.abs().clamp_min(1.0)).max().item()
        want = {n: p.detach().clone() for n, p in ref.named_parameters()}
        rec["_params"] = (got, want)
        rec["one_process_step_ms"] = _step_ms(lambda: ref_step(x, mask, y))
    dist.barrier()
    return rec


def _slice17_rank(rank, out_path):
    """Phase 17 (a) and (c) on rank `rank` of SEQ_SP ranks sharing the card;
    rank 0 writes every rank's results to `out_path`."""
    import torch.distributed as dist
    from rrtmil_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(dp=1, sp=SEQ_SP)
    dev = mesh.device
    rec = {"device": str(dev), "backend": dist.get_backend(),
           "library": _seq_library(rank, mesh, dev)}
    rec["dp"] = _dp_step(rank, dev)
    params = rec["dp"].pop("_params", None)
    if params is not None:
        ok, worst, frac = _adam_params_close(*params, DP_LR, DP_STEPS, 1e-3)
        rec["dp"].update(param_ok=ok, param_err=worst, param_frac=frac)
    recs = [None] * dist.get_world_size()
    dist.all_gather_object(recs, rec)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(recs, f)


def phase_slice16(dev):
    """Phase 16: (a) the kernels at --n_heads 16 / 4, --crmsa_heads 16 and
    --crmsa_k 16 / 12; (b) a 5-fold step of each zoo model
    with --only_rrt_enc (9000 patches a fold; K1-K9 once a step for every
    fold) against five batch-1 steps, FOLD_ZOO_CPU's also against the CPU:
    losses, parameters, ms, peak memory;
    (c) both CLIs with --fold_parallel for the new models; (d)
    --fold_parallel --amp."""
    from rrtmil_tpu_torch.config import c16_r50
    t0 = time.perf_counter()
    report = {"geometry": phase_geometry_kernels(dev), "zoo": {}}
    for name in FOLD_ZOO:
        tag = f"(b) {name}"
        expect = fold_zoo_kernels(name)
        cpu_length = FOLD_CPU_BAG if name == FOLD_ZOO_CPU else None
        report["zoo"][name] = {
            "check": _fold_check(tag, dev, c16_r50(), FOLD_BAG, cpu_length,
                                 False, expect, name=name, ph="16"),
            "times": _fold_times(f"{tag} L={FOLD_BAG}", dev, c16_r50(),
                                 FOLD_BAG, False, expect, name=name,
                                 ph="16")}
    report["cli"] = phase_fold_zoo_cli(dev)
    report["seconds"] = time.perf_counter() - t0
    log(f"[16] phase 16: {report['seconds']:.1f} s")
    return report


def _seq_checks(ranks):
    """(a)'s checks over every rank's records: the launches on each rank,
    and rank 0's comparison with the unsharded port."""
    for r, rec in enumerate(ranks):
        for tag, got in rec["library"].items():
            counts = got["launches"]
            missed = [n for n in SEQ_KERNELS if counts[n] < 1]
            extra = [n for n, v in counts.items()
                     if v and n not in SEQ_KERNELS]
            if missed or extra:
                raise AssertionError(f"[17] (a) rank {r} {tag}: the sharded "
                                     f"forward and value_and_grad missed "
                                     f"{missed} or ran {extra}")
    smi = nvidia_smi_line()
    failed = []
    for tag, got in ranks[0]["library"].items():
        mmd = getattr(torch, tag.split()[1])
        limit = TOL[mmd]
        noise_limit = NOISE_ABS if mmd == torch.float32 else TOL[mmd]
        f32 = mmd == torch.float32
        ok = max(got["hazards_err"], got["loss_err"], got["grad_err"]) \
            <= limit and got["grad_noise"] <= noise_limit and not (f32 and (
                len(got["relu_flips"]) > RELU_FLIPS_MAX
                or got["relu_flip_abs"] > RELU_FLIP_ABS))
        peaks = ", ".join(f"rank {r} {rec['library'][tag]['peak_gb']:.2f} GB"
                          for r, rec in enumerate(ranks))
        log(f"[17] (a) {tag}: bucket {got['n_pad']} tokens, "
            f"{got['slab']} a rank; sharded vs unsharded on the card: "
            f"hazards {got['hazards_err']:.2e}, loss {got['loss_err']:.2e}, "
            f"gradients {got['grad_err']:.2e} at {got['grad_worst']} "
            f"(scaled, tol {limit:.0e}), "
            f"noise leaves {got['grad_noise']:.2e} (abs, tol "
            f"{noise_limit:.0e}); the pool's ReLU flipped at "
            f"{len(got['relu_flips'])} units (|pre-activation| <= "
            f"{got['relu_flip_abs']:.1e}{'; their rows of fc1' + chr(39) + 's gradient left out' if f32 else ''}) "
            f"{'ok' if ok else 'FAIL'}; peak memory "
            f"of the value_and_grad: {peaks}, unsharded "
            f"{got['unsharded_peak_gb']:.2f} GB")
        if got["step_ms"] is not None:
            log(f"[17] (a) {tag}: value_and_grad {got['step_ms']:.2f} ms "
                f"sharded over {SEQ_SP} ranks sharing the card (rank 0), "
                f"{got['unsharded_step_ms']:.2f} ms unsharded; {smi}")
        if not ok:
            failed.append(f"{tag}: sharded and unsharded disagree: {got}")
    if failed:
        raise AssertionError(f"[17] (a) {failed}")


def _dp_checks(ranks):
    for r, rec in enumerate(ranks):
        counts = rec["dp"]["launches"]
        short = [n for n in C16_TRAIN if counts[n] < DP_STEPS]
        extra = [n for n, v in counts.items() if v and n not in C16_TRAIN]
        if short or extra:
            raise AssertionError(f"[17] (c) rank {r}: {DP_STEPS} dp steps "
                                 f"launched {short} fewer times or ran "
                                 f"{extra}: {counts}")
    got = ranks[0]["dp"]
    ok = got["loss_err"] <= 1e-4 and got["param_ok"]
    log(f"[17] (c) dp = 2 step (one {DP_BAG}-patch bag a rank, c16_r50, f32 "
        f"products) vs one process at B = 2: losses {got['losses']} vs "
        f"{got['ref_losses']} ({got['loss_err']:.2e}, tol 1e-4), parameters "
        f"{got['param_err']:.2e} (bound {2 * DP_STEPS * DP_LR * ADAM_STEP:.2e}"
        f", frac {got['param_frac']:.1e}) {'ok' if ok else 'FAIL'}; step "
        f"{got['step_ms']:.2f} ms on 2 ranks sharing the card, "
        f"{got['one_process_step_ms']:.2f} ms in one process; "
        f"{nvidia_smi_line()}")
    if not ok:
        raise AssertionError(f"[17] (c) the dp step disagrees: {got}")


def _seq_cli(tmp):
    """(b) the survival CLI with --sp_shards as a process of its own on
    phase 10's set, 5 folds x 1 epoch."""
    root = os.path.join(tmp, "surv")
    csv_file, patches = write_survival_data(root)
    out_dir = os.path.join(tmp, "out")
    stdout, secs = cli_process(
        "rrtmil_tpu_torch.survival_main",
        ["--excel_file", csv_file, "--model", "RRTMIL", "--input_dim",
         "1024", "--sp_shards", str(SEQ_SP), "--num_epoch", "1", "--seed",
         "1", "--results_dir", out_dir], f"survival_main --sp_shards {SEQ_SP}")
    csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    with open(os.path.join(out_dir, "results_RRTMIL.csv")) as f:
        rows = f.read().splitlines()
    cindex = [float(v) for v in rows[2].split(",")[1:6]]
    rules = [ln for ln in stdout.splitlines() if "] backend " in ln]
    log(f"[17] (b) survival_main --model RRTMIL --sp_shards {SEQ_SP} on "
        f"{patches} patches, 5 folds x 1 epoch: {secs:.1f} s, c-index by "
        f"fold {cindex}; {rules}")
    if csvs != ["results_RRTMIL.csv"] or not np.isfinite(cindex).all() \
            or len(rules) != SEQ_SP:
        raise AssertionError(f"[17] (b) the CLI wrote {csvs}, c-index "
                             f"{cindex}, rules {rules}")
    return {"seconds": secs, "cindex": cindex, "patches": patches,
            "backend_lines": rules}


def phase_slice17(dev):
    """Phase 17: sequence-sharded survival training and the dp step over
    SEQ_SP ranks on the one card (gloo: NCCL takes one rank a device):
    (a) survival_default at full width, f32 stream, dropout off, on bags of
    SEQ_BAGS patches in f32 and bf16 products: each rank's sharded forward
    and value_and_grad through K5-K7, K12 and K13 and no other kernel
    (counters set to 0 just before, read just after), against the unsharded
    port on the same card and weights (TOL), per-rank peak memory, both
    steps' ms; (b) `survival_main --sp_shards 2` as a process; (c)
    `make_sharded_train_step` at dp = 2 (c16_r50, one DP_BAG-patch bag a
    rank, f32 products) against one process at B = 2: losses 1e-4,
    parameters within Adam's drift bound, K1-K9 on each rank."""
    import tempfile
    from rrtmil_tpu_torch.parallel.mesh import choose_backend, launch
    t0 = time.perf_counter()
    backend, why = choose_backend(SEQ_SP, dev)
    log(f"[17] {SEQ_SP} ranks, {torch.cuda.device_count()} card(s): "
        f"backend {backend} ({why})")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.json")
        launch(_slice17_rank, SEQ_SP, device=dev.type, args=(out,),
               timeout=SEQ_TIMEOUT)
        with open(out) as f:
            ranks = json.load(f)
        t_lib = time.perf_counter() - t0
        report = {"backend": backend, "ranks": ranks}
        failed = []      # every part runs; the phase fails after them
        for part, check in (("(a)", lambda: _seq_checks(ranks)),
                            ("(c)", lambda: _dp_checks(ranks)),
                            ("(b)", lambda: report.update(cli=_seq_cli(tmp)))):
            try:
                check()
            except AssertionError as err:
                log(f"[17] {part} FAILED: {err}")
                failed.append(f"{part}: {err}")
        if failed:
            raise AssertionError("[17] " + " | ".join(failed))
    main_tag = f"L={SEQ_MAIN[0]} {SEQ_MAIN[1]} products"
    report["seq_step"] = {"launches": ranks[0]["library"][main_tag][
        "launches"]}
    report["dp_step"] = {"launches": ranks[0]["dp"]["launches"]}
    report["seconds"] = time.perf_counter() - t0
    log(f"[17] phase 17: {report['seconds']:.1f} s ((a) and (c) with the "
        f"ranks' start {t_lib:.1f} s)")
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="phases 0-2 only (build and kernel checks)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        sys.exit(2)
    from rrtmil_tpu_torch.ops.kernels import build  # noqa: F401  (repo check)

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = phase_device()
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "build_s": phase_build()}
    report["errors"] = phase_kernels(dev)
    if not args.quick:
        report["main_path"] = phase_main_path(dev)
        report["train"] = phase_train(dev)
        report["train_vs_cpu"] = phase_train_vs_cpu(dev)
        report["survival"] = phase_survival(dev)
        report["survival_vs_cpu"] = phase_survival_vs_cpu(dev)
        report["ffn"] = phase_ffn(dev)
        report["unmasked"] = phase_unmasked(dev)
        report["brca"] = phase_brca(dev)
        report["canonical"] = phase_canonical(dev)
        report["cli"] = phase_cli(dev)
        report["survival_cli"] = phase_survival_cli(dev)
        report["zoo"] = phase_zoo(dev)
        report["slice12"] = phase_slice12(dev)
        report["slice13"] = phase_slice13(dev)
        report["slice14"] = phase_slice14(dev)
        report["slice15"] = phase_slice15(dev)
        report["slice16"] = phase_slice16(dev)
        report["slice17"] = phase_slice17(dev)
        report["times"] = phase_times_products(dev, phase_times_pairs(
            dev, phase_times_slice3(dev, phase_times(dev))))
        report["throughput"] = phase_throughput(dev)
        report["train_throughput"] = phase_train_throughput(dev)
        report["amp_throughput"] = phase_amp_throughput(dev)
        report["survival_throughput"] = phase_survival_throughput(dev)
        report["ffn_throughput"] = phase_ffn_throughput(dev)
        rows_reps = {"compress_rows_kernel", "compress_reps_kernel"}
        k8, k9 = {"redistribute_ln_kernel"}, {"redistribute_bwd_kernel"}
        for key, want, take in (
                ("profile", rows_reps | k8, lambda: phase_profile(dev)),
                ("train_profile",
                 rows_reps | {"compress_bwd_kernel"} | k8 | k9,
                 lambda: phase_profile(dev, iters=1, train=True)),
                ("survival_profile", rows_reps, lambda: phase_profile(
                    dev, b=1, iters=1, fn=surv_train_setup(dev, 45000),
                    what="survival train step (L=45000)"))):
            report[key] = profile_naming(key, want, take)
        tp = report["train_profile"]
        if len(tp["wgmma_calls"]) != 4 or tp["simt_product_ms"] > 0:
            raise AssertionError(
                f"the bf16 train step ran {len(tp['wgmma_calls'])} wgmma "
                f"products (4 expected) and {tp['simt_product_ms']:.3f} ms of "
                f"the SIMT product (none expected)")
    report["seconds"] = time.perf_counter() - t_start

    # launches: each kernel's count on its own path's train run (K1-K9 the
    # c16_r50 train epoch, K10 / K11 the FFN + drop_path one, K12 / K13 the
    # survival one), each path's counters set to 0 just before it
    paths = {"train_epoch": report.get("train", {}),
             "evaluate": report.get("main_path", {}),
             "survival_train_epoch": report.get("survival", {}),
             "survival_validate": {"launches": report.get("survival", {})
                                   .get("val_launches", {})},
             "ffn_train_epoch": report.get("ffn", {}),
             "ffn_evaluate": {"launches": report.get("ffn", {})
                              .get("eval_launches", {})},
             "unmasked_forward": report.get("unmasked", {}),
             "brca_train_epoch": report.get("brca", {}).get("train", {}),
             "brca_evaluate": report.get("brca", {}).get("evaluate", {}),
             "nsclc_plip_evaluate": report.get("canonical", {}).get(
                 "nsclc_plip", {}).get("evaluate", {})}
    for run in ("c16_r50", "c16_r50_amp", "nsclc_plip"):
        paths[f"cli_{run}"] = report.get("cli", {}).get(run, {})
    for run in ("rrtmil", "rrtmil_amp", "radam", "lookahead", "evaluate",
                "meanmil"):
        paths[f"cli_survival_{run}"] = report.get("survival_cli", {}).get(
            run, {})
    zoo_rep = report.get("zoo", {})
    for name in ZOO_MODELS:
        rec = zoo_rep.get("models", {}).get(name, {})
        paths[f"zoo_{name}_train_epoch"] = rec
        paths[f"zoo_{name}_evaluate"] = {"launches": rec.get(
            "eval_launches", {})}
    for run in ZOO_MODELS + ("dsmil_ds_average",):
        paths[f"cli_zoo_{run}"] = zoo_rep.get("cli", {}).get(run, {})
    paths["cli_zoo_dsmil_init"] = zoo_rep.get("dsmil_init", {})
    for name in ZOO_SURVIVAL:
        paths[f"cli_survival_zoo_{name}"] = zoo_rep.get(
            "survival_cli", {}).get(name, {})
    s12 = report.get("slice12", {})
    tm = s12.get("transmil", {})
    paths["transmil_evaluate"] = {"launches": tm.get("eval_launches", {})}
    paths["transmil_train_epoch"] = tm
    ib = s12.get("cli", {}).get("ibmil_models", {})
    paths["ibmil_evaluate"] = {"launches": ib.get("eval_launches", {})}
    paths["ibmil_train_epoch"] = ib
    for run in ("transmil", "ibmil"):
        paths[f"cli_{run}"] = s12.get("cli", {}).get(run, {})
    for tag, *_ in ENC_VARIANTS:
        rec = s12.get("variants", {}).get(tag, {})
        paths[f"{tag}_evaluate"] = rec.get("evaluate", {})
        paths[f"{tag}_train_epoch"] = rec.get("train", {})
    for name in ("TransMIL", "IBMIL"):
        paths[f"cli_survival_{name}"] = s12.get("survival", {}).get(name, {})
    for name in ("RRTMIL", "TransMIL"):
        paths[f"cli_survival_{name}_evaluate_resume"] = s12.get(
            "survival", {}).get(f"{name}_evaluate_resume", {})
    s13 = report.get("slice13", {})
    for distill, rec in s13.get("dtfd_cls", {}).items():
        paths[f"dtfd_{distill}_evaluate"] = {"launches": rec.get(
            "eval_launches", {})}
        paths[f"dtfd_{distill}_train_epoch"] = rec
    ds13 = s13.get("dtfd_survival", {})
    paths["dtfd_survival_validate"] = ds13.get("validate", {})
    paths["dtfd_survival_train_epoch"] = ds13
    mh = s13.get("mhim", {})
    paths["mhim_teacher"] = {"launches": mh.get("teacher_launches", {})}
    paths["mhim_validate"] = mh.get("validate", {})
    paths["mhim_train_epoch"] = mh
    paths["mhim_selfattn_evaluate"] = s13.get("selfattn", {})
    for name, _ in CLI13_SURVIVAL:
        res = s13.get("cli", {}).get(name + "_evaluate_resume", {})
        paths[f"cli_survival_{name}_train"] = {"launches": res.get(
            "train_launches", {})}
        paths[f"cli_survival_{name}_evaluate_resume"] = res
    s14 = report.get("slice14", {})
    for tag, rec in s14.get("epeg", {}).items():
        paths[f"epeg_{tag}_evaluate"] = rec.get("evaluate", {})
        paths[f"epeg_{tag}_train_steps"] = rec.get("train", {})
        paths[f"epeg_{tag}_same_bits"] = rec
    for run in ("native", "native_amp", "python", "over_budget"):
        paths[f"cli_tier_{run}"] = s14.get("native", {}).get(run, {})
    paths["jax_weights"] = s14.get("jax_weights", {})
    s15 = report.get("slice15", {})
    for tag in ("c16_r50", "survival"):
        rec = s15.get(tag, {})
        paths[f"fold_parallel_{tag}_step"] = rec.get("times", {})
        for ref in ("sequential", "cpu"):
            paths[f"fold_parallel_{tag}_steps_vs_{ref}"] = rec.get(
                "check", {}).get(ref, {})
    s16 = report.get("slice16", {})
    for name, rec in s16.get("zoo", {}).items():
        paths[f"fold_parallel_zoo_{name}_step"] = rec.get("times", {})
        paths[f"fold_parallel_zoo_{name}_steps_vs_sequential"] = rec.get(
            "check", {}).get("sequential", {})
    for tag, rec in s16.get("cli", {}).items():
        paths[f"fold_parallel_{tag}"] = rec
    s17 = report.get("slice17", {})
    for r, rec in enumerate(s17.get("ranks", [])):
        for tag, lib in rec["library"].items():
            paths[f"seqshard_rank{r}_{tag}"] = lib
        paths[f"dp_step_rank{r}"] = rec["dp"]
    paths["seqshard_step"] = s17.get("seq_step", {})
    paths["dp_step"] = s17.get("dp_step", {})
    # this slice's main path: rank 0's sharded forward and value_and_grad
    # of survival_default at L = 50000 (K5-K7, K12, K13) and its dp = 2
    # train steps (K1-K4, K8, K9); K10 / K11 from the FFN train epoch
    own = {n: "dp_step" for n in C16_TRAIN}
    own.update({n: "seqshard_step" for n in SEQ_KERNELS})
    own.update({K[9]: "ffn_train_epoch", K[10]: "ffn_train_epoch"})
    fold_times = s15.get("kernels", {}).get("times", {})
    kernels = []
    for name, (replaces, jax_fn, source) in TPU_KERNELS.items():
        errs = report["errors"][name]
        by_path = {p: rec.get("launches", {}).get(name)
                   for p, rec in paths.items()}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "jax_function": jax_fn,
               "launches": by_path[own[name]] or 0,
               "launches_path": own[name], "launches_by_path": by_path,
               "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs}
        t = report.get("times", {}).get(name)
        if t:
            main_b = "8" if "8" in t else "1"
            row.update({k: t[main_b][k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by",
                                                  "library_ms")})
            row["timed_batch"] = int(main_b)
            row["by_batch"] = {b: {k: v for k, v in rec.items()
                                   if k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "device_ms", "library_device_ms",
                                            "host_ms", "library_host_ms")}
                               for b, rec in t.items()}
        if name in fold_times:
            row["fold_parallel"] = {"folds": FOLDS, **fold_times[name]}
        geom = {label: {k: v for k, v in rec.items() if k != "kernel"}
                for label, rec in s16.get("geometry", {}).items()
                if rec["kernel"] == name}
        if geom:   # this slice's head widths and k, B = 8
            row["geometry"] = geom
        kernels.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as f:
        json.dump({**report, "kernels": kernels}, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
