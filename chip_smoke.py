#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failure exits non-zero, with no result line):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from kernels/csrc/ with nvcc (sm_90a);
  3. hold the encoder, decode+deviation and decoder-mean kernels against
     their plain torch versions on the card (TF32 off; the encoder against
     the plain code evaluated in fp64) at the test stage's shapes (one of
     them takes the decode kernel's column groups with a ragged last row
     tile; 5 folds x 128 rows are what the test stages of phases 8 and 9
     hand the kernels, where the encoder's plan splits its first reduction
     over blocks; the encoder also with a forced K split at the flagship's
     width and with hidden layers wider than a column block), check that two
     calls give a bit-equal deviation, mu and logvar, and time both;
  3b. hold the decoder_nll kernel pair (forward and backward) against its
     plain version plus autograd, with ragged row masks, at training
     shapes; check that two backward calls are bit-equal; time both, the
     forward and the pair;
  4. score 5 folds of the flagship model (cVAE_multimodal, UCA-gPoE widths
     4x[90, 90, 90, 270], c 29, hidden [110, 110], latent 10, 1024 padded
     rows per fold, seeded random weights) through the test stage's scoring
     entry, count the kernel launches of that one call, compare it with the
     plain path on the same eps, and time both; then the reconstruction
     call (encoder and decoder-mean kernels) the same way;
  5. train the flagship model (5 folds of 512 seeded subjects, one fold's
     last batch ragged, batch 256, 10 epochs) through MultiFoldTrainer with
     the --fused_decoder loss, count the decoder_nll launches of that run,
     and hold it against the plain loss from the same init and eps; then a
     few steps at PPMI width (3 x 3485, one fold) the same way; ms per step
     of both;
  6a. hold the fused train step (K5) against its plain version (autograd
     over the packed model, TF32 off) with ragged row masks: the flagship
     (5 folds), every fusion and 1 and 3 hidden layers at small width, two
     shapes none of whose widths is a multiple of 4 (so every tensor of
     the padded layout is wider than its true shape), the ADHD cell's step
     (10 folds, [116, 116], -H 460 460 40: the wide-hidden route) and PPMI
     width with one fold; two calls bit-equal; the flat gradient buffer
     bit-equal to the gradients autograd takes through StepFunction; time
     both;
  6b. the batch-tiled step (K6) in fp32 with tile_b < B against K5 and the
     plain version, and in bf16 against the fp32 plain version (at the JAX
     test's shape) and against its own plain bf16 transcription (flagship,
     and a ragged-width shape whose batch is not a multiple of the tile);
     two calls bit-equal; time both;
  7. train the flagship (5 folds, 10 epochs) through FusedFoldTrainer (K5)
     and hold it against MultiFoldTrainer with the plain loss from the same
     init and eps, counting K5 launches; the same at PPMI width, and at the
     ADHD cell's shape (10 folds x 441, -H 460 460 40, 2 epochs), where
     every K5 step must take the wide-hidden route and a parameter may
     fall outside the bound only where the plain run's gradient was a
     rounded zero in some step; then a few bf16 steps through K6 against
     the fp32 run; ms per step of both paths;
  8. the chain on the card: a synthetic ADNI cohort of 600 subjects in a
     temporary directory, then train -> test -> analysis in this process
     through cli.pipeline (UCA-gPoE, 5 folds, --fused_train_step, epochs
     cut): K1, K2 and K5 must have been launched, the four report files
     must have the JAX package's layout with every AUC finite and in
     [0, 1], and the analysis stage run again on the same CSVs must write
     byte-equal files; wall time of each stage and of the whole;
  9. the model zoo on the card: the same cohort at -P SE-PoE, -H 110 110 10,
     5 folds, stage by stage through cli.pipeline with the plain trainer
     (epochs cut), for mmJSD (with --emit_latent: latent_deviation.csv per
     fold must hold 4 + 1 + latent_dim columns of finite values), mvtCAE,
     DMVAE, WeightedDMVAE and mmVAEPlus (their shared code empty at these
     widths) and DMVAE once more at -H 110 110 40. The launch counts are
     set to 0 before each test stage and read after it: the test stages of
     mmJSD and mvtCAE must have launched K1 and K2 once per modality, those
     of the DMVAE family (which has no kernel) not at all; every AUC must
     be finite. Before that, on seeded tensors at those widths, the scoring
     call of mmJSD and of mvtCAE through K1 and K2 is held against the plain
     path evaluated in fp64 on the same eps, at phase 4's bound: at 5 folds
     x 128 rows, the test stage's own shape (each chain's fold files are
     read back to show it), and at 1024 rows. Prints each model's ms per
     training step (the trainer's run, which ends in a fetch, as the train
     stage's run log gives it) and each stage's wall;
  10. the supervised variants' own CLIs on the same cohort with its FI
     column, 5 folds, -H 110 110 10, 20 epochs of the plain trainer each:
     nm-PM-cont (SE-MoE, -Layers 128 64 32), nm-MLP train, test and
     analyze (SE-MoE), the FI regression (UCA-gPoE). The launch counts are
     set to 0 before each chain's scoring stage and read after it: K1 in
     every chain, K2 in nm-MLP's, K3 in the regression's (its FI pass and
     its ROI pass over the whole cohort). The files each chain wrote are
     read back (results_endtoend.csv, the fold CSVs, the .npy pairs and the
     ROI CSVs; the scatter figures only where matplotlib is installed). Each scoring call is then held against its plain
     path evaluated in fp64 on the same eps, at phase 4's bound, on seeded
     tensors at the rows the stage gave it; K1 and K3 are held and timed
     at the regression's shapes (c 2, the test rows and the 600-row
     cohort). Prints ms per plain step and each stage's wall;
  11. the scoring surfaces on the ensemble phase 8 trained (UCA-gPoE, 5
     folds, its project kept until now): cli.score over the cohort's 600
     subjects in this process with --roi_output and --latent (K1 and K2
     four launches each for the scoring call, K1 four more for the
     subjects' latent and four for the train cohorts' statistics), its
     deviation, latent and ROI columns against the plain path evaluated in
     fp64 on the same eps, at phase 4's bound; then ScoringService and
     make_server on 127.0.0.1 in a thread: /healthz, and POST /score in ids
     mode with 1, 64 and 256 subjects, with roi, with latent, and in raw
     mode with 64, each answer against the plain path in fp64 on the
     service's noise, ids and raw answers equal; the launches of one
     request and of one latent request; p50 and p95 latency over 50
     requests of each size at the HTTP client and inside the service's
     _score, beside the device time of one request's launches; K1 and K2
     at the requests' shapes (64 rows, 5 and 10 folds, D = 90 and 270)
     against their plain versions in fp64, timed beside their bounds;
  12. resume and the grid engines. 12a: on phase 8's cohort (UCA-gPoE, 5
     folds) each training path of the train CLI (plain, --fused_decoder
     through K4, --fused_train_step through K5, and with --precision bf16
     through K6) run -E 10 straight twice, then -E 4 --checkpoint_every 2
     and -E 10 --checkpoint_every 2 --resume in a fresh main: the resumed
     run's fold checkpoints must equal the straight run's byte for byte when
     two straight runs do, else be no further apart than those two; the
     resumed call must launch the path's kernel for 6 of the 10 epochs'
     steps only; the train state's size, the ms of one save and the ms per
     step with --checkpoint_every 1 against none; nm-PM-cont (phase 10's
     flags) straight against killed after epoch 8 and resumed. 12b:
     cli.sweep_supervised on a synthetic ADHD cohort of 600 subjects (2 x
     116 ROIs), -K 10, SM-sMRI and SE-gPoE, hidden shapes 110 110 10, 110
     110 110 10 and 460 460 40, epochs 3 and 6, two lr pairs: 24 records,
     12 computed points; the counts set to 0 before each point's test stage
     and read after it (K1 and K2 once per modality); every AUC finite and
     in [0, 1]; the last point's checkpoints against train_supervised run
     alone at it; K1 and K2 at the test stages' shapes against fp64, timed.
     12c: cli.sweep_endtoend, 4 margins x 3 contrastive weights x 5 folds =
     60 stacked folds, 20 epochs, on phase 10's cohort: 12
     results_endtoend.csv blocks, the prediction's K1 launches at F = 60;
     margin 1, weight 0.1 against nmpmcont alone (metrics, and the grid's
     parameters from the library's SweepTrainer against nmpmcont's
     checkpoints at the JAX sweep test's bounds); K1 at F = 60 against
     fp64, timed; ms per grid step beside phase 10's nm-PM-cont step.
  13. bootstrap, in-memory fusion and the test stage by phase; 14. the
     classifier baseline, export and the report (.claude/skills/verify/
     SKILL.md describes both);
  15. --packed_xla on a 600-subject cohort (with FI), 10 epochs a run, each
     packed run held to the per-modality run of the same seed (both draw
     the same noise): 15a the train CLI at UCA-gPoE (the width-grouped
     layout) in fp32 (logs rtol 2e-4, parameters rtol 5e-3 / atol 5e-5) and
     --precision bf16 (logs rtol 2e-2 of fp32), then the test stage (K1 and
     K2 once per modality), the analysis, the packed-trained ensemble's
     scoring call against the plain path in fp64, and cli.score; 15b mmJSD
     and mvtCAE at SE-PoE (the padded layout) and DMVAE at -H 110 110 40
     (split-latent); 15c nm-PM-cont, nm-MLP and the shuffled regression
     (rtol 5e-3 / atol 5e-4) with their scoring launches (K1; K1, K2; K1,
     K3) and one commands_list11_adhd.sh point of cli.sweep_supervised;
     15d 15a's fp32 run killed after epoch 4 of 10 and resumed in a fresh
     main, byte-equal; 15e ms per step of the per-modality and the packed
     trainer in turns (the flagship, 5 folds x 512 subjects, and PPMI
     width, one fold of 2560; 20 steps a run ending in a fetch, median and
     spread of five runs) and kernels per step from torch.profiler.
  16. out-of-core streamed training and the rest of slice 14 (TF32 off):
     16a StreamingFoldTrainer against MultiFoldTrainer, logs and parameters
     torch.equal, at PPMI width (3 x 3485, one fold of 2560, batch 256, 3
     epochs) at S = 1, 3, 10 and 16 (clamped to 10) on the plain loss and
     at S = 3 with --fused_decoder (K4's launches counted: a pair per
     modality and step), and at the flagship (5 folds) at S = 2; 16b one
     epoch over 100 000 seeded subjects at PPMI width (4.18 GB of
     features), resident and at S = 8 with --fused_decoder, in turns
     (resident, streamed, streamed, resident): parameters torch.equal, the
     peak of allocated bytes over each run less the model's and
     optimizer's (the streamed one at most 2/8 of the features plus 256
     MiB), epoch walls, ms per step, the upload rate of one shard; 16c
     the train CLI on phase 8's cohort (UCA-gPoE, 5 folds, 10 epochs,
     --fused_decoder): --stream_shards 2 byte-equal to the resident
     run, killed at epoch 4 on one path and resumed on the other both ways
     byte-equal, the test stage of the streamed checkpoints launching K1 4
     and K2 4, --stream_shards -1's auto line and --profile_dir's trace;
     16d a streamed --fused_decoder run at PPMI width under
     utils.profiling.trace: K4's kernels named in the trace, the shards'
     host-to-device copies on a stream other than the kernels' and at
     least one overlapping a kernel; 16e --remat bit-equal to the plain
     run and bf16 within rtol 2e-2 of fp32 at PPMI width (10 epochs), ms
     per step of each, each trained model's scoring call launching K1 and
     K2; 16f the doctor --json, exit 0, every section OK; 16g the
     reference's training loop verbatim through compat.cVAE_multimodal (5
     epochs), torch.save / torch.load round trip.
  17. fold, data and tensor parallelism: two ranks of one `python -m
     torch.distributed.run --standalone --nproc_per_node 2` on cuda:0 (gloo:
     NCCL refuses two ranks on one card), each running this script's
     --mesh-child with a plan of jobs; against unmeshed runs in this
     process. 17a the train CLI with --fold_parallel --mesh 1,2 (data) and
     1,1,2 (tensor) on phase 8's cohort, checkpoints at rtol 2e-4 / atol
     2e-5 of the unmeshed run, and 2,1 (folds) on phase 12b's 10-fold ADHD
     cohort (-E 10, -H 110 110 10), bit-equal to the same folds trained
     unmeshed 5 a model (its distance from the 10-fold run, cuBLAS's
     batched products at F=5 against F=10, is printed); 17b the test
     stage with --mesh 1,2 (ADNI) and 2,1 (ADHD), every CSV at rtol 1e-5 / atol 1e-7, each rank launching K1 and K2
     once per modality, K1/K2 at each rank's shapes (5 folds x 64 rows)
     against fp64, timed beside their bounds; 17c the score CLI with
     --mesh 1,2 against the unmeshed scores; 17d the streamed trainer (2
     shards) with --mesh 1,2 bit-equal to the resident --mesh 1,2 run at
     PPMI width; the gloo all_reduce's ms on cuda:0 for one float and for
     the flagship's and the PPMI model's gradients.
  18. expert parallelism and the rest of the multi-device surface, in
     phase 17's torchrun: --ep_mesh training against the unmeshed packed
     runs, the EP test stage, the grids and the service on a mesh, the
     doctor's preflights (README.md's port section).
  19. the demo projects, the figures and the library facade: 19a
     demo.ensure_demo_project at its defaults (170 subjects, 3 folds, -H
     32 32 8, 60 epochs, SE-gPoE) on the card, its test stage launching K1
     and K2 three times each, the four reports in the JAX layout, and a
     second call that reruns no stage (every file's mtime unchanged); 19b
     ensure_procedure_projects (SM-av45, SE-gPoE, UCA-gPoE: K1/K2 1/1,
     3/3, 4/4) the same way; 19c load_fold_model and cohort_latents (K1
     three times at F = 1 over the 170 subjects) against plain
     latent_stats in fp64 at phase 4's bound, and K1/K2 at the demo test
     stages' shapes and K1 at cohort_latents' against fp64, timed; 19d
     viz's figures: a PNG each where matplotlib (and scikit-learn for the
     t-SNE) is installed, else ModuleNotFoundError naming the package; 19e
     train_single_fold and FoldTrainer.run_resumable on one fold of 512
     seeded subjects at the flagship's widths, 10 epochs, torch.equal to
     MultiFoldTrainer at F = 1, a killed and resumed run byte-equal,
     load_checkpoint of it; ms per step of each.
  20. MaskedAdam (K7, kernels/masked_adam.py) at both benchmark cells'
     padded layouts (the fused step's, F = 10: ADNI 3.93 M and PPMI
     24.75 M elements): five steps with one fold invalid through the
     kernel and through the plain expression, flat, m, v and count
     bit-equal, one launch a step; then the kernel and the plain chain
     timed, event ms and device ms, beside the kernel's bound (28 B an
     element).

Beside every kernel time stands the kernel's bound: the least time the
card could take for the same work (kernels/roofline.py: the larger of its
FLOP over the card's peak for the operand type and its bytes over the
memory rate), and the share of it that the time reaches. A kernel's time is
given twice: by CUDA events around calls of its wrapper, host work
included, and as the time the device needs for the same launches replayed
from a CUDA graph, the host out of the way (`device_ms`).

The last line is {"ok": true, "device": {"platform": "gpu", ...}}; the line
before it holds the kernels' launches, errors, times and bounds.
"""
import time

PROCESS_START = time.perf_counter()   # before numpy and torch are imported

import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent

DIMS = [90, 90, 90, 270]
C_DIM = 29
HIDDEN = [110, 110]
LATENT = 10
FOLDS = 5
ROWS = 1024
COMBINE = "gpoe"

# phases 8 and 9: the cohort (healthy controls, then the two disease groups)
# and the rows its test stage hands the kernels: the largest fold's test
# rows padded to the scoring call's 64-row bucket (both chains check this
# against the fold files they wrote)
CHAIN_COHORT = dict(n_hc=300, n_disease={0: 150, 1: 150})
COHORT_SUBJECTS = CHAIN_COHORT["n_hc"] + sum(CHAIN_COHORT["n_disease"].values())
STAGE_ROWS = -(-(-(-COHORT_SUBJECTS // FOLDS)) // 64) * 64

# (folds, rows, feature width, covariate width); at 3485 the decode kernel
# splits the mean head's columns over blocks, with 1000 rows over a ragged
# last tile; then the chains' test stages' shapes (few row tiles, so the
# encoder's plan splits its first reduction: partials and a ticket); the
# last two are the flagship scoring call's own shapes
SHAPES = [(1, 7, 90, 29), (1, 1000, 3485, 2), (1, 1024, 3485, 2),
          (FOLDS, STAGE_ROWS, 90, C_DIM), (FOLDS, STAGE_ROWS, 270, C_DIM),
          (FOLDS, ROWS, 90, C_DIM), (FOLDS, ROWS, 270, C_DIM)]
# the encoder also where its plan differs in kind: the first layer's
# reduction cut in two at the flagship's widest modality (partials and a
# ticket, where the plan takes one block a row tile), and hidden layers wider
# than one 128-column block; ((folds, rows, D, C), hidden, forced K splits)
ENCODER_EXTRA = [((FOLDS, ROWS, 270, C_DIM), HIDDEN, 2),
                 ((2, 100, 270, C_DIM), [130, 110], None)]
TOL = dict(rtol=1e-5, atol=1e-5)       # mu, logvar, recon
DEV_TOL = dict(rtol=1e-4, atol=1e-6)   # per-row deviation
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)  # whole scoring call

# decoder_nll (folds, rows, hidden, D), each with a ragged row mask; the
# bounds are tests/test_decoder_nll.py's: the value rtol 1e-5, gradients
# rtol 1e-4 / atol 1e-6 at flagship width, rtol 1e-3 / atol 1e-5 at 3485
NLL_SHAPES = [(1, 7, 110, 90), (5, 256, 110, 270), (1, 256, 110, 3485),
              (5, 256, 110, 3485)]
NLL_TIMED = (5, 256, 110, 270)  # the flagship step's widest modality
NLL_PPMI = (1, 256, 110, 3485)  # one PPMI modality of a one-fold step
NLL_VALUE_TOL = dict(rtol=1e-5, atol=0.0)
NLL_GRAD_TOL = {90: dict(rtol=1e-4, atol=1e-6), 270: dict(rtol=1e-4, atol=1e-6),
                3485: dict(rtol=1e-3, atol=1e-5)}

# training (bench.py:29-36): 512 subjects per fold, the last fold 500 so its
# second batch is ragged; and the PPMI width (bench.py:45-46)
TRAIN_ROWS = [512, 512, 512, 512, 500]
TRAIN_EPOCHS = 10
BATCH = 256
PPMI_DIMS = [3485, 3485, 3485]
RAGGED_DIMS = [37, 90, 271]
PPMI_ROWS = [2500]
# the ADHD grid's widest point (commands_list11_adhd.sh, -H 460 460 40) on
# the ADHD cell's folds: 441 training rows, 2 steps an epoch
ADHD_DIMS, ADHD_HIDDEN, ADHD_LATENT = [116, 116], [460, 460], 40
ADHD_ROWS = [441] * 10
LOG_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)

# fused train step (tests/test_train_step_kernel.py:68-83,
# tests/test_train_step_tiled.py:71, :91-105, :126-146): losses rtol 1e-5,
# gradients rtol 1e-3 / atol 1e-5 (rtol 2e-3 / atol 2e-5 at 3485), K6 fp32
# against K5 rtol 1e-4 / atol 1e-6; bf16 against fp32 a total within 2e-2
# and a normalized error per gradient leaf under 6e-2, and the bf16 kernel
# against its own plain bf16 transcription (same cast points) a normalized
# error under 5e-3: a value that lands near a bf16 rounding boundary may
# round the other way from another summation order (one bf16 ulp, 2^-8),
# so the two agree to well under bf16's own error but not to fp32's;
# trajectories (tests/test_fused_cli.py:57-62) logs rtol 2e-4, parameters
# rtol 5e-3 / atol 5e-5
STEP_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
STEP_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STEP_GRAD_TOL_WIDE = dict(rtol=2e-3, atol=2e-5)
TILED_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_TOTAL, BF16_LEAF, BF16_OWN = 2e-2, 6e-2, 5e-3
FUSED_LOG_TOL = dict(rtol=2e-4, atol=0.0)
FUSED_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
# the step's gradients are held to an atol of 1e-5, which fixes no sign of
# a gradient at or under it; Adam moves an entry by about lr a step
# whatever its gradient's size. At hidden 460 an entry may fall outside
# FUSED_PARAM_TOL only where the plain run's gradient was that small in
# some step (tests/test_torch_cuda.py's ROUNDED_GRAD).
ROUNDED_GRAD = 1e-5
# (name, dims, hidden, folds, rows, C, Z, fusion)
STEP_SHAPES = [
    ("flagship", DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT, COMBINE),
    ("poe", [40, 60, 30], [32, 32], 2, 100, C_DIM, LATENT, "poe"),
    ("moe", [40, 60, 30], [32, 32], 2, 100, C_DIM, LATENT, "moe"),
    ("mopoe", [40, 60, 30], [32, 32], 2, 100, C_DIM, LATENT, "mopoe"),
    ("1 hidden", [40, 60, 30], [48], 2, 100, C_DIM, LATENT, "gpoe"),
    ("3 hidden", [40, 60, 30], [64, 110, 32], 2, 100, C_DIM, LATENT, "gpoe"),
    ("1 modality", [90], HIDDEN, 2, 100, C_DIM, LATENT, "gpoe"),
    # no width a multiple of 4: d_max, hidden, latent and covariates all
    # padded, with ragged rows
    ("ragged widths", RAGGED_DIMS, HIDDEN, 2, 100, C_DIM, LATENT, "gpoe"),
    ("ragged widths, C 2", RAGGED_DIMS, [110, 57], 2, 75, 2, 7, "poe"),
    # the ADHD cell's step (-H 460 460 40): K5's wide-hidden route
    ("ADHD h460", ADHD_DIMS, ADHD_HIDDEN, 10, BATCH, C_DIM, ADHD_LATENT,
     "gpoe"),
    ("PPMI", PPMI_DIMS, HIDDEN, 1, BATCH, C_DIM, LATENT, COMBINE),
]
FLAT_CHECKED = ("flagship", "ragged widths", "ADHD h460", "PPMI")
# the shapes whose device time the kernels line reports
DEVICE_TIMED = ("flagship", "ADHD h460", "PPMI")
TILE = 64        # K6's tile in phase 6b: 4 row groups of the flagship batch
BF16_STEPS = 4   # phase 7's bf16 steps (2 epochs of the flagship cohort)

# phase 13a: the bootstrap chain on phase 8's cohort (no early-fusion CSV:
# -D 3modalities is fused in memory), 10 replicates, epochs cut from 200;
# its test stage scores every replicate's out-of-bag rows (404 to 419 on
# this cohort) padded to 448 in one call, at C 29 and, --unconditioned, 1
BOOT_REPS = 10
BOOT_ROWS = 448
BOOT_FLAGS = ["-R", "ADNI", "-D", "3modalities", "-B", str(BOOT_REPS),
              "-E", "20", "-H", "110", "110", "10"]
BOOT_SHAPES = [(BOOT_REPS, BOOT_ROWS, 270, C_DIM), (BOOT_REPS, BOOT_ROWS, 270, 1)]

# phase 14a: the classifier baseline on an ADHD cohort of phase 12b's size
# and width (600 subjects, fMRI.csv of 116 ROIs) with one patient group:
# phase 12b's has two (DIA 0 and 2 beside the controls' 1) and the
# reference classifier two classes. The CLI at the reference defaults, one
# point of
# classifier_baseline/tune_parameter.sh, and that script's four (lr,
# dropout) points at 116 64 32 as one grid against their own runs, at the
# JAX sweep test's bounds (tests/test_sweep.py:147-180)
CLASSIFIER_COHORT = dict(n_hc=300, n_disease={0: 300})
CLASSIFIER_EPOCHS = 1000
TUNE_POINT = ["--hidden_layers", "256", "128", "64", "--initial_lr", "0.0005",
              "--dropout", "0.3", "--min_lr", "0.000001"]
TUNE_GRID = [{"initial_lr": lr, "factor": 0.5, "patience": 10,
              "min_lr": 1e-6, "dropout": drop}
             for lr in (5e-4, 1e-4) for drop in (0.1, 0.3)]
CLASSIFIER_HIDDEN = [116, 64, 32]
CLASSIFIER_VAL_TOL = dict(rtol=2e-3, atol=0.0)
CLASSIFIER_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
# phase 14b: phase 8's ensemble exported (cpu and cuda programs); the cuda
# program against ScoringService on the card, the cpu program against it
EXPORT_TOL = dict(rtol=1e-6, atol=0.0)
EXPORT_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
EXPORT_LATENCY_CALLS = 50

# phase 8: the chain's flags, and the reports the analysis stage writes
CHAIN_FLAGS = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS),
               "-E", str(TRAIN_EPOCHS), "--fused_train_step"]
CHAIN_REPORTS = ["result_baseline/result_multimodal.txt",
                 "result_baseline/result_4.txt", "cvae_auc_and_std.csv"]


# phase 9: the zoo's chains, (model, -H, --emit_latent), on phase 8's cohort
# with separate encoders (three modalities of 90 features), plain trainer
ZOO_DIMS = [90, 90, 90]
ZOO_EPOCHS = 20
ZOO_FLAGS = ["-R", "ADNI", "-P", "SE-PoE", "-K", str(FOLDS),
             "-E", str(ZOO_EPOCHS)]
ZOO_CHAINS = [("mmJSD", HIDDEN + [LATENT], True),
              ("mvtCAE", HIDDEN + [LATENT], False),
              ("DMVAE", HIDDEN + [LATENT], False),
              ("WeightedDMVAE", HIDDEN + [LATENT], False),
              ("mmVAEPlus", HIDDEN + [LATENT], False),
              ("DMVAE", HIDDEN + [40], False)]
ZOO_KERNEL_MODELS = ("mmJSD", "mvtCAE")

# phase 10: the supervised variants' own CLIs on phase 8's cohort with the
# FI column; 20 epochs each, cut from the reference's 200 (nmpmcont, nmmlp)
# and 500 (regression) for the time limit
VARIANT_EPOCHS = 20
VARIANT_FLAGS = ["-R", "ADNI", "-K", str(FOLDS), "-E", str(VARIANT_EPOCHS),
                 "-H", "110", "110", "10"]
VARIANT_CHAINS = [
    ("nmpmcont", VARIANT_FLAGS + ["-P", "SE-MoE", "-Layers", "128", "64",
                                  "32"]),
    ("nmmlp", ["all"] + VARIANT_FLAGS + ["-P", "SE-MoE"]),
    ("regression", VARIANT_FLAGS + ["-P", "UCA-gPoE"]),
]
CLASSIFIER_LAYERS = [128, 64, 32]
# what each chain's scoring launches (SE-MoE: 3 modalities of 90; UCA-gPoE:
# 4, the fourth the 270-column early fusion, once for FI, once for the ROIs)
VARIANT_LAUNCHES = {
    "nmpmcont": {"fused_encoder": 3},
    "nmmlp": {"fused_encoder": 3, "fused_pred_deviation": 3},
    "regression": {"fused_encoder": 8, "fused_decoder_mean": 8},
}
REGRESSION_C = 2

# phase 11: the scoring surfaces on phase 8's trained project. Requests of
# 1, 64 and 256 subjects, each size LATENCY_REQUESTS times; a request of 1
# to 64 subjects runs K1 and K2 at B = 64, and the service's default -K 10
# makes F = 10: (folds, rows, D, C) where K1 and K2 are held and timed
SERVE_SIZES = (1, 64, 256)
LATENCY_REQUESTS = 50
SERVE_SHAPES = [(f, 64, d, C_DIM) for f in (FOLDS, 10) for d in (90, 270)]

# phase 12a: resume on phase 8's cohort, each training path run straight
# (twice), killed after RESUME_KILLED epochs and resumed in a fresh main
RESUME_FLAGS = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS)]
RESUME_PATHS = [("plain", []), ("K4", ["--fused_decoder"]),
                ("K5", ["--fused_train_step"]),
                ("K6", ["--fused_train_step", "--precision", "bf16"])]
RESUME_KERNELS = {"K4": "decoder_nll", "K5": "fused_train_step",
                  "K6": "tiled_fused_train_step"}
RESUME_EPOCHS, RESUME_KILLED, RESUME_EVERY = 10, 4, 2
# phase 12b: commands_list11_adhd.sh's procedures, shapes and lr pairs on a
# synthetic ADHD cohort (2 x 116 ROIs), epochs cut from 50 500 1000
ADHD_COHORT = dict(n_hc=300, n_disease={0: 150, 2: 150})
ADHD_FOLDS = 10
SWEEP_HZ = [[110, 110, 10], [110, 110, 110, 10], [460, 460, 40]]
SWEEP_ARGV = ["-R", "ADHD", "-K", str(ADHD_FOLDS), "--procedures", "SM-sMRI",
              "SE-gPoE", "--hz_grid",
              ";".join(" ".join(map(str, hz)) for hz in SWEEP_HZ),
              "--epochs_list", "3", "6", "--lr_grid", "1e-4:5e-3,1e-5:5e-3"]
SWEEP_LAUNCHES = {"SM-sMRI": 1, "SE-gPoE": 2}   # K1 and K2 each, a point
# phase 12c: the JAX end-to-end sweep CLI's own example grid (200 epochs
# cut to 20) on phase 10's cohort: 12 configs x 5 folds = 60 stacked folds
GRID_FLAGS = ["-R", "ADNI", "-P", "SE-MoE", "-K", str(FOLDS), "-H", "110",
              "110", "10", "-Layers", "128", "64", "32", "-E", "20"]
GRID_ARGV = GRID_FLAGS + ["-Margins", "0.25", "0.5", "1", "2",
                          "-Weightcontrastives", "0.1", "0.5", "1"]
GRID_PARAM_TOL = dict(rtol=5e-3, atol=5e-4)   # tests/test_sweep.py:46-83
GRID_METRIC_DIFF = 0.05

# phase 15: --packed_xla on every CLI that takes it, on phase 8's cohort
# (with FI) in a temporary directory; 10 epochs each, each run held to its
# per-modality run of the same seed (both layouts draw the same noise)
PACKED_EPOCHS = 10
PACKED_BASE = ["-R", "ADNI", "-K", str(FOLDS)]
PACKED_H = ["-H", "110", "110", "10"]
PACKED_E = ["-E", str(PACKED_EPOCHS)]
PACKED_MODEL_DIR = "outputs/kfold_analysis/supervised_cvae"
# the JAX tests' bounds: tests/test_packed_cli.py:33-50 and, for nm-PM-cont
# and the regression, tests/test_packed_{endtoend,regression}.py
PACKED_LOG_TOL = dict(rtol=2e-4, atol=0.0)
PACKED_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
PACKED_VARIANT_TOL = dict(rtol=5e-3, atol=5e-4)
PACKED_BF16_TOL = dict(rtol=2e-2, atol=0.0)
PACKED_ZOO = [("mmJSD", [110, 110, 10], "padded"),
              ("mvtCAE", [110, 110, 10], "padded"),
              ("DMVAE", [110, 110, 40], "split-latent grouped")]
PACKED_VARIANTS = [
    ("nmpmcont", PACKED_BASE + PACKED_H + PACKED_E
     + ["-P", "SE-MoE", "-Layers", "128", "64", "32"]),
    ("nmmlp", ["all"] + PACKED_BASE + PACKED_H + PACKED_E + ["-P", "SE-MoE"]),
    ("regression", PACKED_BASE + PACKED_H + PACKED_E + ["-P", "UCA-gPoE"]),
]
# one commands_list11_adhd.sh point (its 50 epochs cut to 10)
PACKED_SWEEP = ["-R", "ADHD", "-K", str(ADHD_FOLDS), "--procedures",
                "SE-gPoE", "--hz_grid", "110 110 10", "--epochs_list",
                str(PACKED_EPOCHS), "--lr_grid", "1e-4:5e-3"]
# 15e: (cell, widths, subjects per fold): bench.py:29-36 and :45-47
PACKED_TIMING = [("flagship", DIMS, [512] * FOLDS),
                 ("PPMI width", PPMI_DIMS, [2560])]
PACKED_TIMED_STEPS, PACKED_TIMED_RUNS = 20, 5


# the fused step's padded layouts at the benchmark cells' widths (F = 10):
# the flat buffers MaskedAdam updates there
ADAM_LAYOUTS = {"ADNI": [90, 90, 90, 270], "PPMI": [3485] * 3}
ADAM_FOLDS = 10


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=5):
    """Mean time in ms that the device needs for what one fn() launches,
    with the host out of the way: `iters` calls are captured into one CUDA
    graph, and CUDA events time replays of the graph. Between two kernels
    there is then the graph's own launch gap (a microsecond or two) and
    nothing of the wrapper's host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up where the capture will run
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def wall_ms(fn, iters=20, warmup=3):
    """Mean host wall time of fn() in ms, each call synchronized."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_text(work, ms):
    """'bound x ms by y, z% reached' for a roofline.Work and a time."""
    return (f"bound {work.bound_ms:.5f} ms by {work.bound_by} "
            f"({work.peak_name}), {100 * work.share(ms):.1f}% reached")


def step_work(dims, hidden, folds, rows, c_dim, z_dim, bf16=False):
    from multi_modal_normative_modeling_tpu_torch.kernels import roofline

    return roofline.fused_train_step(folds, rows, dims, c_dim, hidden, z_dim,
                                     bf16=bf16)


def check_close(what, got, want, tol):
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: non-finite values")
    err = (got - want).abs()
    rel = (err / want.abs().clamp_min(1e-30)).max().item()
    if not torch.allclose(got, want, **tol):
        raise RuntimeError(f"{what}: max abs err {err.max().item():.3e}, "
                           f"max rel err {rel:.3e} over {tol}")
    return err.max().item(), rel


def one_hot_covariates(rng, rows, c_dim=C_DIM):
    """One-hot age (c_dim - 2 bins, 27 at ADNI's 29) + gender (2 bins), as
    the CLIs feed; at c_dim 1 the constant zero column of bootstrap's
    --unconditioned."""
    c = np.zeros((rows, c_dim), np.float32)
    if c_dim == 1:
        return c
    idx = np.arange(rows)
    c[idx, rng.integers(0, c_dim - 2, rows)] = 1.0
    c[idx, c_dim - 2 + rng.integers(0, 2, rows)] = 1.0
    return c


def covariates(rng, folds, rows, c_dim=C_DIM):
    return torch.from_numpy(np.stack([one_hot_covariates(rng, rows, c_dim)
                                      for _ in range(folds)])).cuda()


def check_encoder(enc, x, c, splits=None, tol=TOL):
    """K1 against the plain code evaluated in fp64 (rounded to fp32) at
    ``tol``, two calls bit-equal; returns (max abs err, max rel err, its
    plan)."""
    from multi_modal_normative_modeling_tpu_torch.kernels import mlp

    layers = (enc.hidden_layers(), enc.mu.pair(), enc.logvar.pair())
    got = mlp.fused_encoder(*layers, x, c, enc.non_linear, splits=splits)
    again = mlp.fused_encoder(*layers, x, c, enc.non_linear, splits=splits)
    want = mlp.encoder_reference(
        [tuple(fp64(*layer)) for layer in layers[0]],
        *[tuple(fp64(*head)) for head in layers[1:]], *fp64(x, c),
        enc.non_linear)
    errs = []
    for name, g, a, w in zip(("mu", "logvar"), got, again, want):
        if not torch.equal(g, a):
            raise RuntimeError(f"fused_encoder {name}: two calls differ")
        errs.append(check_close(f"fused_encoder {name}", g, w.float(), tol))
    folds, rows, d = x.shape
    plan = mlp.plan(folds, rows, d + c.shape[2],
                    tuple(w.shape[1] for w, _ in layers[0]),
                    layers[1][0].shape[1], splits)
    return max(e for e, _ in errs), max(r for _, r in errs), plan


def check_nll(rng, folds, rows, hidden, d):
    """decoder_nll's kernels against the plain version plus autograd on
    one ragged shape; returns (max abs err, max rel err, times in ms)."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        decoder_nll,
        decoder_nll_reference,
    )

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()

    # g at a LeakyReLU activation's scale, w and b at the init's, and x
    # drawn from the decoder's own Gaussian N(g w^T + b, exp(lvo)): gradient
    # entries of order 1, where an absolute 1e-6 is a bound on the kernel's
    # arithmetic and not on fp32 rounding of large terms (with x ~ N(0, 1)
    # and lvo = -3 at n = 5 the dW terms reach ~50, and two summation orders
    # differ by 2.5 ulp of them, ~1e-5)
    g = normal(folds, rows, hidden, scale=0.5).requires_grad_()
    w = normal(folds, d, hidden, scale=0.05).requires_grad_()
    b = normal(folds, d, scale=0.1).requires_grad_()
    lvo = (normal(folds, 1, d, scale=0.1) - 1.0).requires_grad_()
    with torch.no_grad():
        x = (g @ w.mT + b[:, None] + torch.exp(0.5 * lvo)
             * normal(folds, rows, d))
    mask = torch.ones(folds, rows, device="cuda")
    for f in range(folds):
        mask[f, rows - 2 - f:] = 0.0  # ragged: n < B in every fold
    n = torch.clamp(mask.sum(-1), min=1.0)
    params = (g, w, b, lvo)

    def value_and_grads(fn):
        ll = fn(g, w, b, lvo, x, mask, n)
        return ll, torch.autograd.grad(ll.sum(), params)

    ll, grads = value_and_grads(decoder_nll)
    ll_p, grads_p = value_and_grads(decoder_nll_reference)
    errs = [check_close(f"decoder_nll value {folds}x{rows}x{d}", ll.detach(),
                        ll_p.detach(), NLL_VALUE_TOL)]
    for name, got, want in zip(("dg", "dw", "db", "dlvo"), grads, grads_p):
        errs.append(check_close(f"decoder_nll {name} {folds}x{rows}x{d}", got,
                                want, NLL_GRAD_TOL[d]))
    again = value_and_grads(decoder_nll)[1]
    for name, a, b2 in zip(("dg", "dw", "db", "dlvo"), grads, again):
        if not torch.equal(a, b2):
            raise RuntimeError(f"decoder_nll {name}: two backward calls "
                               "differ")
    times = {}
    with torch.no_grad():
        times["fwd"] = cuda_ms(lambda: decoder_nll(g, w, b, lvo, x, mask, n))
        times["plain_fwd"] = cuda_ms(
            lambda: decoder_nll_reference(g, w, b, lvo, x, mask, n))
    times["fwd_bwd"] = cuda_ms(lambda: value_and_grads(decoder_nll))
    times["plain_fwd_bwd"] = cuda_ms(
        lambda: value_and_grads(decoder_nll_reference))
    with torch.no_grad():
        times["fwd_device"] = device_ms(
            lambda: decoder_nll(g, w, b, lvo, x, mask, n))

    def fresh_pair(fn):
        # leaves made inside the capture: autograd ties a leaf to the
        # stream it was made on, and the outer ones belong to the default
        # stream, which a capture may not wait for
        leaves = [p.detach().requires_grad_() for p in params]
        return torch.autograd.grad(fn(*leaves, x, mask, n).sum(), leaves)

    times["fwd_bwd_device"] = device_ms(lambda: fresh_pair(decoder_nll))
    times["plain_fwd_bwd_device"] = device_ms(
        lambda: fresh_pair(decoder_nll_reference))
    return max(e for e, _ in errs), max(r for _, r in errs), times


def training_run(dims, rows_per_fold, epochs, seed, fused):
    """Fresh seeded model and cohort, trained by MultiFoldTrainer with the
    --fused_decoder loss or the plain loss on fixed eps; returns (logs,
    final state dict, ms per step, steps). The batches are uploaded before
    the clock starts."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        fused_decoder_loss_fn,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
    )

    rng = np.random.default_rng(seed)
    folds = len(rows_per_fold)
    data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
            for n in rows_per_fold]
    cov = [[one_hot_covariates(rng, n)] * len(dims) for n in rows_per_fold]
    batches = DeviceBatches(stack_fold_batches(data, cov, BATCH), "cuda")
    steps = epochs * batches.n_batches
    eps = torch.randn((steps, folds, BATCH, LATENT),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE)
    loss = fused_decoder_loss_fn(model, config) if fused else None
    trainer = MultiFoldTrainer(model, config, max(rows_per_fold), loss_fn=loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.run(batches, eps=eps)  # ends in a fetch: synchronized
    ms = (time.perf_counter() - t0) * 1e3 / steps
    for k, v in logs.items():
        if not np.isfinite(v).all() or v.shape != (folds, epochs):
            raise RuntimeError(f"training log {k}: shape {v.shape}, finite "
                               f"{np.isfinite(v).all()}")
    return logs, model.state_dict(), ms, steps


def compare_training(what, dims, rows_per_fold, epochs, seed):
    """plain, kernel, kernel, plain: holds the first kernel run against the
    first plain run and returns the kernel run's decoder_nll launches and
    the ms per step of each run."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    logs_p, state_p, plain1, steps = training_run(dims, rows_per_fold,
                                                  epochs, seed, fused=False)
    kernels.reset_launch_counts()
    logs_k, state_k, kern1, _ = training_run(dims, rows_per_fold, epochs,
                                             seed, fused=True)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    want = 2 * len(dims) * steps  # a forward and a backward per modality
    if launches["decoder_nll"] != want:
        raise RuntimeError(f"{what}: decoder_nll launched "
                           f"{launches['decoder_nll']} times, expected {want}")
    if launches["masked_adam"] != steps:
        raise RuntimeError(f"{what}: masked_adam launched "
                           f"{launches['masked_adam']} times, expected "
                           f"{steps}")
    for k in logs_p:
        check_close(f"{what} log {k}", torch.from_numpy(logs_k[k]),
                    torch.from_numpy(logs_p[k]), LOG_TOL)
    err = 0.0
    for k in state_p:
        err = max(err, check_close(f"{what} param {k}", state_k[k],
                                   state_p[k], PARAM_TOL)[0])
    kern2 = training_run(dims, rows_per_fold, epochs, seed, fused=True)[2]
    plain2 = training_run(dims, rows_per_fold, epochs, seed, fused=False)[2]
    print(f"phase 5: {what}: {len(rows_per_fold)} folds x {rows_per_fold} "
          f"subjects, widths {dims}, {steps} steps: launches {launches}; "
          f"final params max abs err {err:.3e}; ms/step kernel "
          f"{kern1:.4f}, {kern2:.4f}, plain {plain1:.4f}, {plain2:.4f}",
          flush=True)
    return launches


def step_problem(dims, hidden, folds, rows, c_dim, z_dim, seed):
    """A seeded packed model and one ragged batch on the card: (stacked,
    packed params, x [F, M, B, d_max], c [F, B, C], eps, row mask)."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )

    rng = np.random.default_rng(seed)
    model = build_model("cVAE_multimodal", dims, hidden, z_dim, c_dim,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    stacked = StackedMultimodalCVAE(dims, hidden, z_dim, c_dim, len(dims))
    packed = packed_from_model(model, stacked)
    x = stacked.pack_inputs([rng.standard_normal((folds, rows, d),
                                                 dtype=np.float32)
                             for d in dims]).cuda()
    if c_dim == C_DIM:
        c = covariates(rng, folds, rows)
    else:
        c = torch.from_numpy(rng.standard_normal(
            (folds, rows, c_dim), dtype=np.float32)).cuda()
    eps = torch.from_numpy(rng.standard_normal(
        (folds, rows, z_dim), dtype=np.float32)).cuda()
    mask = torch.ones(folds, rows, device="cuda")
    for f in range(folds):
        mask[f, rows - 2 - f:] = 0.0   # ragged: n < B in every fold
    return stacked, packed, x, c, eps, mask


def leaf_error(got, want):
    """Normalized error of one gradient leaf: |got - want| / |want|."""
    return ((got.double() - want.double()).norm()
            / (want.double().norm() + 1e-12)).item()


def check_bit_equal(what, a, b):
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise RuntimeError(f"{what} d{k}: two calls differ")


def fp64(*tensors):
    return [t.double() for t in tensors]


def plain64(reference, named, batch):
    """A plain version evaluated in fp64 on the same inputs (the plain code
    with double operands), rounded back to fp32: the reference the kernels
    are held to. The fp32 evaluation on the card (cuBLAS) strayed up to
    6.3e-3 from fp64 at the flagship in one call of this script, while the
    kernel stayed within 1.6e-6."""
    losses, grads = reference({k: v.double() for k, v in named.items()},
                              *fp64(*batch))
    return ({k: v.float() for k, v in losses.items()},
            {k: v.float() for k, v in grads.items()})


def check_step(name, dims, hidden, folds, rows, c_dim, z_dim, combine):
    """K5 against autograd over the packed model (in fp64) on one ragged
    batch; returns (max abs err, (kernel ms, fp32 plain ms))."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )

    stacked, packed, x, c, eps, mask = step_problem(
        dims, hidden, folds, rows, c_dim, z_dim, seed=len(name) + rows)
    step = FusedTrainStep(stacked, combine)
    named = step.pad_params(packed)
    xx, cc, rm, nv = step.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    losses, grads = step.loss_and_grads_padded(named, *batch)
    ref_losses, ref_grads = plain64(step.reference, named, batch)
    plain_err = max((g - ref_grads[k]).abs().max().item() for k, g in
                    step.reference(named, *batch)[1].items())
    for k in losses:
        check_close(f"K5 {name} {k}", losses[k], ref_losses[k],
                    STEP_LOSS_TOL)
    tol = STEP_GRAD_TOL_WIDE if max(dims) > 1000 else STEP_GRAD_TOL
    err = max(check_close(f"K5 {name} d{k}", grads[k], ref_grads[k], tol)[0]
              for k in grads)
    check_bit_equal(f"K5 {name}", grads,
                    step.loss_and_grads_padded(named, *batch)[1])
    flat_note = ""
    if name in FLAT_CHECKED:
        # the trainer's path (the flat buffer) against autograd's
        flat = step.loss_and_grads_flat(named, *batch)[1]
        leaves = [torch.nn.Parameter(named[k].clone())
                  for k in step._param_names]
        total, _ = step.loss_fn(leaves)(
            {"x": xx, "c": cc, "rm": rm, "nvalid": nv}, eps)
        auto = torch.autograd.grad(total.sum(), leaves)
        if not torch.equal(flat, torch.cat([g.reshape(-1) for g in auto])):
            raise RuntimeError(f"K5 {name}: the flat gradient buffer differs "
                               "from StepFunction's gradients")
        flat_note = ", flat buffer bit-equal to StepFunction's gradients"
    from multi_modal_normative_modeling_tpu_torch.kernels import train_step
    plan = train_step.plan(step, folds, rows)
    # timed through the entry the trainer calls
    ms = cuda_ms(lambda: step.loss_and_grads_flat(named, *batch))
    plain = cuda_ms(lambda: step.reference(named, *batch))
    work = step_work(dims, hidden, folds, rows, c_dim, z_dim)
    print(f"phase 6a: K5 {name}: {folds} folds x {rows} rows, widths {dims}, "
          f"hidden {hidden}, {combine}, route {plan}: max abs err {err:.3e} "
          f"(the fp32 plain's {plain_err:.3e}), bit-equal{flat_note}; "
          f"{ms:.4f} ms vs plain forward+autograd {plain:.4f} ms; "
          f"{bound_text(work, ms)}", flush=True)
    device = (device_ms(lambda: step.loss_and_grads_flat(named, *batch))
              if name in DEVICE_TIMED else None)
    if device is not None:
        print(f"phase 6a: K5 {name}: device {device:.4f} ms", flush=True)
    return err, (ms, plain, work, device, plan["route"])


def check_tiled():
    """K6 in fp32 (tile < B) against K5 and the plain version; in bf16
    against the fp32 plain version at the JAX test's shape and against its
    own plain bf16 transcription at the flagship. Returns (max abs err of
    the fp32 checks, (bf16 kernel ms, its plain ms)) at the flagship."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step_tiled import (  # noqa: E501
        TiledFusedTrainStep,
    )

    stacked, packed, x, c, eps, mask = step_problem(
        DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT, seed=11)
    k5 = FusedTrainStep(stacked, COMBINE)
    named = k5.pad_params(packed)
    xx, cc, rm, nv = k5.pack_batch(x, c, mask)
    batch = (xx, cc, eps, rm, nv)
    l5, g5 = k5.loss_and_grads_padded(named, *batch)
    ref_l, ref_g = plain64(k5.reference, named, batch)
    t32 = TiledFusedTrainStep(stacked, COMBINE, tile_b=TILE)
    lt, gt = t32.loss_and_grads_padded(named, *batch)
    check_close("K6 fp32 total vs K5", lt["total"], l5["total"],
                STEP_LOSS_TOL)
    err = 0.0
    for k in gt:
        check_close(f"K6 fp32 d{k} vs K5", gt[k], g5[k], TILED_TOL)
        err = max(err, check_close(f"K6 fp32 d{k} vs plain", gt[k],
                                   ref_g[k], STEP_GRAD_TOL)[0])
    check_bit_equal("K6 fp32", gt, t32.loss_and_grads_padded(named, *batch)[1])
    ms32 = cuda_ms(lambda: t32.loss_and_grads_flat(named, *batch))
    plain32 = cuda_ms(lambda: t32.reference(named, *batch))

    # bf16 against fp32 at the JAX test's shape (tests/test_train_step_
    # tiled.py:126-146: widths 24/40/16, hidden 12/12, latent 6, c 5, 20
    # rows, tile 16)
    s_st, s_packed, s_x, s_c, s_eps, s_mask = step_problem(
        [24, 40, 16], [12, 12], 1, 20, 5, 6, seed=4)
    small = TiledFusedTrainStep(s_st, "gpoe", tile_b=16,
                                compute_dtype=torch.bfloat16)
    s_named = small.pad_params(s_packed)
    sx, sc, srm, snv = small.pack_batch(s_x, s_c, s_mask)
    s_batch = (sx, sc, small.pad_eps(s_eps), srm, snv)
    lb, gb = small.loss_and_grads_padded(s_named, *s_batch)
    s32 = FusedTrainStep(s_st, "gpoe")     # fp32, in its own layout
    fx, fc, frm, fnv = s32.pack_batch(s_x, s_c, s_mask)
    lf, gf = plain64(s32.reference, s32.pad_params(s_packed),
                     (fx, fc, s_eps, frm, fnv))
    total_rel = ((lb["total"] - lf["total"]).abs()
                 / lf["total"].abs()).max().item()
    gb, gf = small.strip(gb), s32.strip(gf)
    leaf = max(leaf_error(gb[k], gf[k]) for k in gb)
    if not total_rel < BF16_TOTAL or not leaf < BF16_LEAF:
        raise RuntimeError(f"K6 bf16 vs fp32 plain: total rel {total_rel:.3e}"
                           f", worst leaf {leaf:.3e}")

    # bf16 at the flagship against its own plain bf16 transcription, in its
    # own layout (widths padded to 16, where fp32 pads to 4) and on the
    # batch stored in bf16, as the trainer keeps it
    t16 = TiledFusedTrainStep(stacked, COMBINE, tile_b=TILE,
                              compute_dtype=torch.bfloat16)
    named_w = t16.pad_params(packed)
    x16, c16, rm16, nv16 = t16.pack_batch(x, c, mask)
    stored = t16.cast_batch({"x": x16, "c": c16})
    b16 = (stored["x"], stored["c"], t16.pad_eps(eps), rm16, nv16)
    lb16, gb16 = t16.loss_and_grads_padded(named_w, *b16)
    named16 = t16.cast_exec(named_w)
    # the transcription with bf16 cast points, computed in fp64
    lp16, gp16 = plain64(t16.reference, named16, b16)
    own = max(leaf_error(gb16[k], gp16[k]) for k in gb16)
    own_total = ((lb16["total"] - lp16["total"]).abs()
                 / lp16["total"].abs()).max().item()
    true16, true_p16, true_ref = (t16.strip(gb16), t16.strip(gp16),
                                  k5.strip(ref_g))
    vs_fp32 = max(leaf_error(true16[k], true_ref[k]) for k in true16)
    plain_vs_fp32 = max(leaf_error(true_p16[k], true_ref[k])
                        for k in true_p16)
    if not own < BF16_OWN or not own_total < BF16_OWN:
        raise RuntimeError(f"K6 bf16 vs its plain bf16: worst leaf {own:.3e}"
                           f", total rel {own_total:.3e}")
    check_bit_equal("K6 bf16", gb16,
                    t16.loss_and_grads_padded(named_w, *b16)[1])
    ms16 = cuda_ms(lambda: t16.loss_and_grads_flat(named_w, *b16))
    plain16 = cuda_ms(lambda: t16.reference(named16, *b16))
    work16 = step_work(DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT, bf16=True)

    # ragged widths, 100 rows in tiles of 48 (padded to 144), both types
    ragged = {}
    r_st, r_packed, r_x, r_c, r_eps, r_mask = step_problem(
        RAGGED_DIMS, HIDDEN, 2, 100, C_DIM, LATENT, seed=13)
    for dtype in (torch.float32, torch.bfloat16):
        rt = TiledFusedTrainStep(r_st, COMBINE, tile_b=48,
                                 compute_dtype=dtype)
        r_named = rt.pad_params(r_packed)
        rx, rc, rrm, rnv = rt.pack_batch(r_x, r_c, r_mask)
        r_batch = (rx, rc, rt.pad_eps(r_eps), rrm, rnv)
        lr, gr = rt.loss_and_grads_padded(r_named, *r_batch)
        cast = (rt.cast_batch({"x": rx, "c": rc}))
        lp, gp = plain64(rt.reference, rt.cast_exec(r_named),
                         (cast["x"], cast["c"]) + r_batch[2:])
        ragged[dtype] = max(leaf_error(gr[k], gp[k]) for k in gr)
        rel = ((lr["total"] - lp["total"]).abs()
               / lp["total"].abs()).max().item()
        bound = BF16_OWN if dtype == torch.bfloat16 else 1e-4
        if not ragged[dtype] < bound or not rel < bound:
            raise RuntimeError(f"K6 {dtype} ragged widths: worst leaf "
                               f"{ragged[dtype]:.3e}, total rel {rel:.3e}")
        check_bit_equal(f"K6 {dtype} ragged", gr,
                        rt.loss_and_grads_padded(r_named, *r_batch)[1])
    print(f"phase 6b: K6 fp32 tile {TILE}: max abs err {err:.3e} vs plain, "
          f"within {TILED_TOL} of K5, bit-equal; {ms32:.4f} ms vs plain "
          f"{plain32:.4f} ms; "
          f"{bound_text(step_work(DIMS, HIDDEN, FOLDS, BATCH, C_DIM, LATENT), ms32)}"
          f". K6 bf16 at the JAX test's shape: total rel "
          f"{total_rel:.3e}, worst leaf {leaf:.3e} vs fp32 plain. K6 bf16 "
          f"flagship: worst leaf {own:.3e} vs its plain bf16 (whose own "
          f"worst leaf vs fp32 is {plain_vs_fp32:.3e}; the kernel's "
          f"{vs_fp32:.3e}), bit-equal; {ms16:.4f} ms vs plain {plain16:.4f} "
          f"ms; {bound_text(work16, ms16)}. K6 at ragged widths {RAGGED_DIMS}"
          f", 100 rows in tiles of 48: worst leaf vs its plain version "
          f"{ragged[torch.float32]:.3e} (fp32), "
          f"{ragged[torch.bfloat16]:.3e} (bf16), bit-equal", flush=True)
    device16 = device_ms(lambda: t16.loss_and_grads_flat(named_w, *b16))
    device32 = device_ms(lambda: t32.loss_and_grads_flat(named, *batch))
    print(f"phase 6b: K6 device ms: bf16 {device16:.4f}, fp32 {device32:.4f}",
          flush=True)
    fp32 = {"ms": ms32, "device_ms": device32, "plain_ms": plain32,
            "bound_ms": step_work(DIMS, HIDDEN, FOLDS, BATCH, C_DIM,
                                  LATENT).bound_ms}
    return err, (ms16, plain16, work16, device16, fp32)


def least_gradients(adams):
    """A MaskedAdam.step_flat that keeps on each optimizer the least
    |gradient| of each entry over its steps (``adam.least``), and appends
    each optimizer it steps to ``adams``."""
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
    )

    step_flat = MaskedAdam.step_flat

    def step(adam, g, valid):
        if not bool(valid.all()):
            raise RuntimeError("least_gradients: a fold skipped a step")
        if adam not in adams:
            adams.append(adam)
            adam.least = g.abs()
        else:
            torch.minimum(adam.least, g.abs(), out=adam.least)
        step_flat(adam, g, valid)
    return step


def fused_training_run(dims, rows_per_fold, epochs, seed, fused,
                       precision="fp32", hidden=HIDDEN, latent=LATENT,
                       least=None):
    """Fresh seeded model and cohort trained on fixed eps by
    MultiFoldTrainer with the plain loss or by FusedFoldTrainer (K5 in
    fp32, K6 in bf16); returns (logs, final packed params, ms per step,
    steps). The batches are uploaded before the clock starts. A plain run
    given a list ``least`` appends to it, as a packed tree, the least
    |gradient| of each parameter over the steps."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        packed_from_model,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.fused import (
        FusedFoldTrainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
    )

    rng = np.random.default_rng(seed)
    folds = len(rows_per_fold)
    data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
            for n in rows_per_fold]
    cov = [one_hot_covariates(rng, n) for n in rows_per_fold]
    model = build_model("cVAE_multimodal", dims, hidden, latent, C_DIM,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE,
                         precision=precision)
    stacked = StackedMultimodalCVAE(dims, hidden, latent, C_DIM, len(dims))
    if not fused:
        batches = DeviceBatches(stack_fold_batches(
            data, [[c] * len(dims) for c in cov], BATCH), "cuda")
        trainer = MultiFoldTrainer(model, config, max(rows_per_fold))
    else:
        trainer = FusedFoldTrainer(model, config, max(rows_per_fold))
        batches = trainer.batches(data, cov, "cuda")
        packed = packed_from_model(model, stacked)
    steps = epochs * batches.n_batches
    eps = torch.randn((steps, folds, BATCH, latent),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not fused and least is not None:
        from multi_modal_normative_modeling_tpu_torch.train.trainer import (
            MaskedAdam,
        )

        adams, step_flat = [], MaskedAdam.step_flat
        MaskedAdam.step_flat = least_gradients(adams)
        try:
            logs = trainer.run(batches, eps=eps)
        finally:
            MaskedAdam.step_flat = step_flat
        trained = packed_from_model(model, stacked)
        # the model trained in views of its Adam's buffer: that buffer,
        # overwritten, reads out in the packed layout
        (adam,) = adams
        with torch.no_grad():
            adam.flat.copy_(adam.least)
        least.append(packed_from_model(model, stacked))
    elif not fused:
        logs = trainer.run(batches, eps=eps)  # ends in a fetch
        trained = packed_from_model(model, stacked)
    else:
        trained, logs = trainer.run(packed, batches, eps=eps)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    for k, v in logs.items():
        if not np.isfinite(v).all() or v.shape != (folds, epochs):
            raise RuntimeError(f"training log {k}: shape {v.shape}, finite "
                               f"{np.isfinite(v).all()}")
    return logs, trained, ms, steps


def packed_leaves(tree):
    """The tensors of a packed tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in packed_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in packed_leaves(v)]
    return [tree]


def compare_fused_training(what, dims, rows_per_fold, epochs, seed,
                           hidden=HIDDEN, latent=LATENT, route=None,
                           rounded=False):
    """plain, K5, K5, plain: holds the first K5 run against the first plain
    run (``rounded``: entries outside FUSED_PARAM_TOL only where the plain
    run's gradient was a rounded zero, ROUNDED_GRAD, in some step), checks
    that every K5 step took ``route`` where one is given, and returns the
    K5 run's launches with its steps by route under "routes" and the ms a
    step of the four runs under "ms"."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    shape = dict(hidden=hidden, latent=latent)
    least = [] if rounded else None
    logs_p, state_p, plain1, steps = fused_training_run(
        dims, rows_per_fold, epochs, seed, fused=False, least=least,
        **shape)
    kernels.reset_launch_counts()
    logs_k, state_k, kern1, _ = fused_training_run(
        dims, rows_per_fold, epochs, seed, fused=True, **shape)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    routes = dict(kernels.fused_train_step.route_launches)
    for name in ("fused_train_step", "masked_adam"):
        if launches[name] != steps:
            raise RuntimeError(f"{what}: {name} launched {launches[name]} "
                               f"times, expected {steps}")
    if route and routes != {**dict.fromkeys(routes, 0), route: steps}:
        raise RuntimeError(f"{what}: K5's steps by route {routes}, "
                           f"expected {steps} on {route}")
    for k in logs_p:
        check_close(f"{what} fused log {k}", torch.from_numpy(logs_k[k]),
                    torch.from_numpy(logs_p[k]), FUSED_LOG_TOL)
    err, rounded_note = 0.0, ""
    if rounded:
        apart = least_grad = 0
        for a, b, g in zip(packed_leaves(state_k), packed_leaves(state_p),
                           packed_leaves(least[0])):
            out = ((a - b).abs() > FUSED_PARAM_TOL["atol"]
                   + FUSED_PARAM_TOL["rtol"] * b.abs())
            bad = out & (g > ROUNDED_GRAD)
            if bad.any():
                raise RuntimeError(
                    f"{what}: {int(bad.sum())} params outside "
                    f"{FUSED_PARAM_TOL} where the plain run's least "
                    f"|gradient| is {g[bad].min().item():.3e} or more")
            keep = ~out
            if keep.any():
                err = max(err, (a - b)[keep].abs().max().item())
            apart += int(out.sum())
            if out.any():
                least_grad = max(least_grad, g[out].max().item())
        rounded_note = (f" ({apart} outside, each with a rounded-zero "
                        f"gradient, the largest least |gradient| "
                        f"{least_grad:.3e})")
    else:
        for a, b in zip(packed_leaves(state_k), packed_leaves(state_p)):
            err = max(err, check_close(f"{what} fused param", a, b,
                                       FUSED_PARAM_TOL)[0])
    kern2 = fused_training_run(dims, rows_per_fold, epochs, seed,
                               fused=True, **shape)[2]
    plain2 = fused_training_run(dims, rows_per_fold, epochs, seed,
                                fused=False, **shape)[2]
    print(f"phase 7: {what}: {len(rows_per_fold)} folds x {rows_per_fold} "
          f"subjects, widths {dims}, hidden {hidden}, latent {latent}, "
          f"{steps} steps: launches {launches}, K5 steps by route {routes}; "
          f"final params max abs err {err:.3e}{rounded_note}; ms/step K5 "
          f"{kern1:.4f}, {kern2:.4f}, plain {plain1:.4f}, {plain2:.4f}",
          flush=True)
    return {**launches, "routes": routes,
            "ms": {"K5": [kern1, kern2], "plain": [plain1, plain2]}}


def bf16_training(seed):
    """A few flagship steps through K6 in bf16 against the same steps in
    fp32 (K5) from the same init and eps; returns the K6 run's launches."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    epochs = BF16_STEPS // 2
    logs_f, state_f, ms_f, steps = fused_training_run(
        DIMS, TRAIN_ROWS, epochs, seed, fused=True)
    kernels.reset_launch_counts()
    logs_b, state_b, ms_b, _ = fused_training_run(
        DIMS, TRAIN_ROWS, epochs, seed, fused=True, precision="bf16")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    for name in ("tiled_fused_train_step", "masked_adam"):
        if launches[name] != steps:
            raise RuntimeError(f"bf16: {name} launched {launches[name]} "
                               f"times, expected {steps}")
    total_rel = np.max(np.abs(logs_b["total"] - logs_f["total"])
                       / np.abs(logs_f["total"]))
    leaf = max(leaf_error(a, b) for a, b in zip(packed_leaves(state_b),
                                                packed_leaves(state_f)))
    if not total_rel < BF16_TOTAL or not leaf < BF16_LEAF:
        raise RuntimeError(f"bf16 training: total rel {total_rel:.3e}, worst "
                           f"param leaf {leaf:.3e}")
    print(f"phase 7: bf16: {steps} flagship steps through K6: launches "
          f"{launches}; logs total within {total_rel:.3e} of fp32, worst "
          f"param leaf {leaf:.3e}; ms/step K6 bf16 {ms_b:.4f}, K5 fp32 "
          f"{ms_f:.4f}", flush=True)
    return launches


def check_reports(root, stats, folds=FOLDS, hidden=HIDDEN + [LATENT],
                  phase="phase 8"):
    """The analysis stage's files, in the JAX package's layout: three
    comparisons of ADNI, one block each in result_multimodal.txt, one block
    in result_4.txt, the last comparison's per-fold AUCs and their std in
    cvae_auc_and_std.csv, and an auc_rocs.csv per comparison, for a run of
    ``folds`` folds at -H ``hidden``. Returns the files' bytes by relative
    path."""
    number = r"-?(?:[0-9]+\.[0-9]+|inf|nan)"
    block = (r"Experiment settings: CVAE\. [^\n]*\n"
             r"(?: args\.Model [^\n]*\n)?"
             + "".join(rf"{name}: \$ {number} \\pm {number} \$ \n"
                       for name in ("ROC-AUC", "Accuracy", "Sensitivity",
                                    "Specificity", "Significance ratio"))
             + re.escape(f"hz_para_list: {list(hidden)}") + r"\n\n\n\n")
    files = [Path(rel) for rel in CHAIN_REPORTS] + sorted(
        p.relative_to(root) for p in root.rglob("auc_rocs.csv"))
    texts = {rel: (root / rel).read_bytes() for rel in files}
    for rel, blocks in zip(files[:2], (3, 1)):
        if not re.fullmatch(f"(?:{block}){{{blocks}}}", texts[rel].decode()):
            raise RuntimeError(f"{phase}: {rel} is not {blocks} report "
                               f"blocks:\n{texts[rel].decode()}")
    aucs = list(stats["auc"])
    table = np.loadtxt(root / files[2], delimiter=",")
    if table.shape != (folds + 1,):
        raise RuntimeError(f"{phase}: {files[2]} holds {table.shape} values")
    aucs += list(table[:-1])
    if len(files) != 6:
        raise RuntimeError(f"{phase}: report files {files}")
    for rel in files[3:]:
        lines = texts[rel].decode().split("\n")
        if lines[0] != "ROC-AUC" or len(lines) != folds + 2 or lines[-1]:
            raise RuntimeError(f"{phase}: {rel}: {lines}")
        aucs += [float(v) for v in lines[1:-1]]
    if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
        raise RuntimeError(f"{phase}: AUCs {aucs}")
    return texts


def stage_rows(root, folds):
    """(the rows a chain's test stage gave the kernels, the largest fold's
    test rows they pad, the row tile), from the fold files it wrote."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch.cli import common

    kfold_dir = root / "outputs" / "kfold_analysis"
    most = max(len(pd.read_csv(common.fold_paths(kfold_dir, fold)[1]))
               for fold in range(folds))
    tile = common.infer_row_tile()
    return -(-most // tile) * tile, most, tile


def check_stage_rows(root, phase):
    """The rows a chain's test stage gave the kernels must be the
    STAGE_ROWS at which phase 3 held the kernels against their plain
    versions."""
    rows, most, tile = stage_rows(root, FOLDS)
    if rows != STAGE_ROWS:
        raise RuntimeError(f"{phase}: the test stage scored {FOLDS} folds x "
                           f"{rows} rows ({most} padded to {tile}s); the "
                           f"kernels were checked at {STAGE_ROWS}")


def train_run(model_dir):
    """(ms per step, steps) of a train stage, from the train_end event of its
    run log: the trainer's run alone, from the batches' upload to the logs'
    fetch."""
    events = [json.loads(line) for line in
              (model_dir / "run_log.jsonl").read_text().splitlines()]
    end = [e for e in events if e["event"] == "train_end"][-1]
    return end["run_s"] * 1e3 / end["steps"], end["steps"]


def with_adam(want, steps):
    """``want`` with MaskedAdam's (K7) one launch a step of ``steps``
    training steps on the card."""
    return dict(want, masked_adam=steps) if steps else dict(want)


def run_chain(root):
    """Phase 8: train, score and analyse a synthetic cohort in this process
    through cli.pipeline, in ``root`` (phase 11 scores its trained
    ensemble); returns the chain's kernel launches."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import pipeline
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    t0 = time.perf_counter()
    make_synthetic_resource(root, "ADNI", with_early_fusion=True,
                            **CHAIN_COHORT)
    made = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = pipeline.run(CHAIN_FLAGS, project_root=root)
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    for name in ("fused_encoder", "fused_pred_deviation",
                 "fused_train_step"):
        if launches[name] == 0:
            raise RuntimeError(f"phase 8: {name} was not launched by the "
                               f"chain: {launches}")
    texts = check_reports(root, stats)
    # the analysis stage again, on the same CSVs: the same bytes
    for rel in texts:
        (root / rel).unlink()
    pipeline.run(CHAIN_FLAGS + ["--stages", "analyze"], project_root=root)
    for rel, text in texts.items():
        if (root / rel).read_bytes() != text:
            raise RuntimeError(f"phase 8: {rel} differs when the "
                               "analysis runs again")
    check_stage_rows(root, "phase 8")
    print(f"phase 8: ADNI cohort of {COHORT_SUBJECTS} "
          f"subjects made in {made:.3f} s; chain "
          f"{' '.join(CHAIN_FLAGS)} in one process: {whole:.3f} s in all "
          f"(the stages' own times above); launches {launches}; AUC per "
          f"comparison {[round(float(a), 4) for a in stats['auc']]}; "
          f"{len(texts)} report files in the JAX package's layout, "
          f"byte-equal when the analysis runs again", flush=True)
    return launches


def check_zoo_scoring(name, seed, rows):
    """The scoring call of one skeleton variant through K1 and K2 on seeded
    tensors (5 folds x `rows` rows at phase 9's widths) against the plain
    path evaluated in fp64 on the same eps, at phase 4's bound. Returns (max
    abs err, the call's launches, K1's K splits at this shape)."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.kernels import mlp
    from multi_modal_normative_modeling_tpu_torch.models import build_model

    rng = np.random.default_rng(seed)
    model = build_model(name, ZOO_DIMS, HIDDEN, LATENT, C_DIM, len(ZOO_DIMS),
                        folds=FOLDS,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    xes = [torch.from_numpy(rng.standard_normal(
        (FOLDS, rows, d), dtype=np.float32)).cuda() for d in ZOO_DIMS]
    cs = [covariates(rng, FOLDS, rows)] * len(ZOO_DIMS)
    eps = torch.randn((FOLDS, rows, LATENT),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(xes, cs, "poe", eps=eps)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS
                if k.launches}
    if launches != {"fused_encoder": len(ZOO_DIMS),
                    "fused_pred_deviation": len(ZOO_DIMS)}:
        raise RuntimeError(f"phase 9: {name}: the scoring call launched "
                           f"{launches}")
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ref = model64.pred_recon(fp64(*xes), fp64(*cs), "poe",
                                 eps=eps.double())
    err = 0.0
    for m in range(len(ZOO_DIMS)):
        dev64 = model64.reconstruction_deviation(xes[m].double(), ref[m])
        err = max(err,
                  check_close(f"{name} modality {m} recon", recons[m],
                              ref[m].float(), MODEL_TOL)[0],
                  check_close(f"{name} modality {m} deviation", devs[m],
                              dev64.float(), MODEL_TOL)[0])
    splits = {mlp.plan(FOLDS, rows, d + C_DIM, tuple(HIDDEN), LATENT).splits
              for d in ZOO_DIMS}
    return err, launches, splits


def check_latent_files(root, model_dir):
    """--emit_latent: one latent_deviation.csv per fold, the four clinical
    columns, the scalar and one column per latent dimension, all finite."""
    import pandas as pd

    want = (["participant_id", "DIA", "AGE", "PTGENDER", "Latent deviation"]
            + [f"latent {i}" for i in range(LATENT)])
    rows = 0
    for fold in range(FOLDS):
        frame = pd.read_csv(model_dir / f"{fold:03d}" / "latent_deviation.csv")
        if list(frame.columns) != want or not len(frame):
            raise RuntimeError(f"phase 9: latent_deviation.csv of fold {fold} "
                               f"holds {list(frame.columns)}, {len(frame)} "
                               "rows")
        if not np.isfinite(frame[want[4:]].to_numpy()).all():
            raise RuntimeError(f"phase 9: latent_deviation.csv of fold {fold} "
                               "holds non-finite values")
        rows += len(frame)
    return rows


def run_zoo():
    """Phase 9: each zoo model's chain on the card, stage by stage through
    cli.pipeline. Returns {model: launches of its test stage} for the
    models that score through K1 and K2."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import pipeline
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    # the test stage's own rows (K1 splits its first reduction there) and
    # the flagship scoring call's
    for seed, name in enumerate(ZOO_KERNEL_MODELS, start=9):
        for rows in (STAGE_ROWS, ROWS):
            err, launches, splits = check_zoo_scoring(name, seed, rows)
            print(f"phase 9: {name} scoring call, {FOLDS} folds x {rows} "
                  f"rows, widths {ZOO_DIMS}, through K1 ({sorted(splits)} K "
                  f"splits) and K2 against the plain path in fp64: max abs "
                  f"err {err:.3e}; launches {launches}", flush=True)

    test_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "cohort"
        make_synthetic_resource(base, "ADNI", **CHAIN_COHORT)
        for i, (name, hz, emit_latent) in enumerate(ZOO_CHAINS):
            root = Path(tmp) / f"{i}_{name}"
            shutil.copytree(base / "data", root / "data")
            flags = (ZOO_FLAGS + ["-Model", name, "-H"]
                     + [str(h) for h in hz]
                     + (["--emit_latent"] if emit_latent else []))
            walls = {}
            for stage in ("train", "test", "analyze"):
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                stats = pipeline.run(flags + ["--stages", stage],
                                     project_root=root)
                torch.cuda.synchronize()
                walls[stage] = time.perf_counter() - t0
                if stage == "test":
                    launches = {k.__name__: k.launches
                                for k in kernels.KERNELS if k.launches}
            want = ({"fused_encoder": len(ZOO_DIMS),
                     "fused_pred_deviation": len(ZOO_DIMS)}
                    if name in ZOO_KERNEL_MODELS else {})
            if launches != want:
                raise RuntimeError(f"phase 9: the test stage of {name} "
                                   f"launched {launches}, expected {want}")
            if name in ZOO_KERNEL_MODELS:
                test_launches[name] = launches
            aucs = [float(a) for a in stats["auc"]]
            if len(aucs) != 3 or not all(
                    np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
                raise RuntimeError(f"phase 9: {name}: AUCs {aucs}")
            model_dir = (root / "outputs" / "kfold_analysis"
                         / "supervised_cvae")
            latent = list(root.rglob("latent_deviation.csv"))
            note = ""
            if emit_latent:
                rows = check_latent_files(root, model_dir)
                note = (f"; latent_deviation.csv in {FOLDS} folds, "
                        f"{4 + 1 + LATENT} columns, {rows} rows, finite")
            elif latent:
                raise RuntimeError(f"phase 9: {name} wrote {latent}")
            check_stage_rows(root, f"phase 9: {name}")
            ms, steps = train_run(model_dir)
            if steps <= 0 or steps % ZOO_EPOCHS:
                raise RuntimeError(f"phase 9: {name}: {steps} steps in "
                                   f"{ZOO_EPOCHS} epochs")
            print(f"phase 9: {name} -H {' '.join(map(str, hz))}: "
                  f"{steps} plain steps at {ms:.4f} ms/step; train "
                  f"{walls['train']:.3f} s, test {walls['test']:.3f} s, "
                  f"analysis {walls['analyze']:.3f} s; test-stage "
                  f"launches {launches}; AUC per comparison "
                  f"{[round(a, 4) for a in aucs]}{note}", flush=True)
    return test_launches


def raw_covariates(rng, folds, rows):
    """[AGE, PTGENDER] as the regression feeds them (c_dim 2), one block
    for every fold."""
    c = np.stack([rng.uniform(55, 90, rows),
                  rng.integers(1, 3, rows)], axis=1).astype(np.float32)
    return torch.from_numpy(np.broadcast_to(c, (folds, rows, 2)).copy()).cuda()


def check_variant_scoring(name, rows, roi_rows=None, seed=20):
    """The scoring call of one variant CLI through the kernels on seeded
    tensors at the rows its stage gave them, against the plain path in fp64
    on the same eps, at phase 4's bound. Returns (max abs err, launches of
    the call)."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.models import (
        EndToEndCVAE,
        MultimodalCVAE,
        RegressionCVAE,
    )

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    dims = DIMS if name == "regression" else ZOO_DIMS
    if name == "nmpmcont":
        model = EndToEndCVAE(dims, HIDDEN, LATENT, C_DIM, len(dims),
                             classifier_layers=CLASSIFIER_LAYERS,
                             folds=FOLDS, generator=gen, device="cuda")
    elif name == "nmmlp":
        model = MultimodalCVAE(dims, HIDDEN, LATENT, C_DIM, len(dims),
                               variant="nmmlp", folds=FOLDS, generator=gen,
                               device="cuda")
    else:
        model = RegressionCVAE(dims, HIDDEN, LATENT, REGRESSION_C, len(dims),
                               folds=FOLDS, generator=gen, device="cuda")
    if name == "nmpmcont":
        # running statistics a trained model would hold, not the init's
        for stats in model.classifier.state:
            stats.mean.copy_(torch.randn(stats.mean.shape, generator=gen))
            stats.var.copy_(torch.rand(stats.var.shape, generator=gen) + 0.5)
    model64 = copy.deepcopy(model).double()
    xes = [torch.from_numpy(rng.standard_normal(
        (FOLDS, rows, d), dtype=np.float32)).cuda() for d in dims]
    cs = ([raw_covariates(rng, FOLDS, rows)] if name == "regression"
          else [covariates(rng, FOLDS, rows)]) * len(dims)
    eps = torch.randn((FOLDS, rows, LATENT), generator=gen).cuda()
    kernels.reset_launch_counts()
    err = 0.0
    if name == "nmpmcont":
        got = model.predict(xes, cs)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels.KERNELS
                    if k.launches}
        want = model64.predict_reference(fp64(*xes), fp64(*cs))
        err = check_close("nmpmcont logits", got, want.float(), MODEL_TOL)[0]
    elif name == "nmmlp":
        recons, devs = model.pred_recon_fused(xes, cs, "moe", eps=eps)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels.KERNELS
                    if k.launches}
        with torch.no_grad():
            ref = model64.pred_recon(fp64(*xes), fp64(*cs), "moe",
                                     eps=eps.double())
        for m in range(len(dims)):
            dev64 = model64.reconstruction_deviation(xes[m].double(), ref[m])
            err = max(err, check_close(f"nmmlp modality {m} recon",
                                       recons[m], ref[m].float(),
                                       MODEL_TOL)[0],
                      check_close(f"nmmlp modality {m} deviation", devs[m],
                                  dev64.float(), MODEL_TOL)[0])
    else:
        fi = model.pred_fi(xes, cs, "gpoe", eps=eps)
        x_roi = [torch.from_numpy(rng.standard_normal(
            (FOLDS, roi_rows, d), dtype=np.float32)).cuda() for d in dims]
        c_roi = raw_covariates(rng, FOLDS, roi_rows)
        eps_roi = torch.randn((FOLDS, roi_rows, LATENT), generator=gen).cuda()
        devs = [model.roiwise_deviation(x_roi[m], c_roi, m, eps=eps_roi)
                for m in range(len(dims))]
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels.KERNELS
                    if k.launches}
        want = model64.pred_fi_reference(fp64(*xes), fp64(*cs), "gpoe",
                                         eps=eps.double())
        err = check_close("regression FI", fi, want.float(), MODEL_TOL)[0]
        for m in range(len(dims)):
            ref = model64.roiwise_deviation_reference(
                x_roi[m].double(), c_roi.double(), m, eps=eps_roi.double())
            err = max(err, check_close(f"regression ROI modality {m}",
                                       devs[m], ref.float(), MODEL_TOL)[0])
    if launches != VARIANT_LAUNCHES[name]:
        raise RuntimeError(f"phase 10: {name}: the scoring call launched "
                           f"{launches}, expected {VARIANT_LAUNCHES[name]}")
    return err, launches


def time_regression_shapes(rows, roi_rows, stats):
    """K1 and K3 at the regression's new shapes (c 2; the FI pass's test
    rows and the ROI pass's whole cohort, D = 90 and 270): each against
    its plain version in fp64 (K1 through check_encoder), event and device
    ms beside the bound. Fills stats[kernel]["regression"]."""
    from multi_modal_normative_modeling_tpu_torch.kernels import (
        deviation,
        roofline,
    )
    from multi_modal_normative_modeling_tpu_torch.models import (
        Decoder,
        Encoder,
    )

    rng = np.random.default_rng(21)
    gen = torch.Generator().manual_seed(21)
    for n in (rows, roi_rows):
        for d in (90, 270):
            x = torch.from_numpy(rng.standard_normal(
                (FOLDS, n, d), dtype=np.float32)).cuda()
            c = raw_covariates(rng, FOLDS, n)
            z = torch.from_numpy(rng.standard_normal(
                (FOLDS, n, LATENT), dtype=np.float32)).cuda()
            enc = Encoder(d, HIDDEN, LATENT, REGRESSION_C, folds=FOLDS,
                          generator=gen, device="cuda")
            dec = Decoder(d, HIDDEN, LATENT, REGRESSION_C, folds=FOLDS,
                          generator=gen, device="cuda")
            e1, _, enc_plan = check_encoder(enc, x, c)
            mean = dec.fused_mean(z, c)
            want = deviation.decode_mean_reference(
                [tuple(fp64(*layer)) for layer in dec.hidden_layers()],
                tuple(fp64(*dec.mean.pair())), *fp64(z, c), True)
            e3 = check_close("fused_decoder_mean", mean, want.float(),
                             TOL)[0]
            dec_plan = deviation.plan(FOLDS, n, LATENT + REGRESSION_C,
                                      tuple(HIDDEN[::-1]), d)
            shape = (FOLDS, n, d, REGRESSION_C, HIDDEN, LATENT)
            key = f"F={FOLDS} B={n} D={d} C={REGRESSION_C}"
            with torch.no_grad():
                for kname, err, fn, plain, work, plan_text in (
                        ("fused_encoder", e1, lambda: enc.fused(x, c),
                         lambda: enc(x, c), roofline.fused_encoder(*shape),
                         f"{enc_plan.tiles} tiles x {enc_plan.splits} "
                         "K splits"),
                        ("fused_decoder_mean", e3,
                         lambda: dec.fused_mean(z, c),
                         lambda: dec(z, c)[0],
                         roofline.fused_decoder_mean(*shape),
                         f"{dec_plan.tiles} tiles x {dec_plan.groups} "
                         "column groups")):
                    ms, dev = cuda_ms(fn), device_ms(fn)
                    plain_ms, plain_dev = cuda_ms(plain), device_ms(plain)
                    print(f"phase 10: {kname} at {key} ({plan_text}): max "
                          f"abs err {err:.3e} vs fp64; {ms:.4f} ms (device "
                          f"{dev:.4f}) vs plain {plain_ms:.4f} ms (device "
                          f"{plain_dev:.4f}), {bound_text(work, ms)}",
                          flush=True)
                    s = stats[kname]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    s.setdefault("regression", {})[key] = {
                        "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                        "plain_device_ms": plain_dev,
                        "bound_ms": work.bound_ms}


def check_variant_files(name, root, timings, stats):
    """The files a variant chain wrote, read back: their counts, shapes and
    finite values. Returns a short summary for the phase line."""
    import pandas as pd

    model_dir = root / "outputs" / "kfold_analysis" / "supervised_cvae"
    for fold in range(FOLDS):
        if name != "regression" and not (
                model_dir / f"{fold:03d}" / "cVAE_model.ckpt").exists():
            raise RuntimeError(f"phase 10: {name}: no checkpoint of fold "
                               f"{fold}")
    if name == "nmpmcont":
        lines = (root / "results_endtoend.csv").read_text().split("\n")
        values = {}
        for line in lines[1:6]:
            metric, mean, std = re.fullmatch(
                r"(\w+) \$(-?[0-9.]+|nan) \\pm (-?[0-9.]+|nan)\$",
                line).groups()
            values[metric] = float(mean)
        if (sorted(values) != ["accuracy", "auroc", "f1_score",
                               "sensitivity", "specificity"]
                or not all(0.0 <= v <= 1.0 for v in values.values())):
            raise RuntimeError(f"phase 10: results_endtoend.csv {lines}")
        ids = root / "outputs" / "kfold_analysis_endtoend"
        check_rows(name, max(len(pd.read_csv(ids / f"test_ids_{f:03d}.csv"))
                             for f in range(FOLDS)), timings["score_rows"])
        return f"results_endtoend.csv means {values}"
    if name == "nmmlp":
        rows = 0
        for fold in range(FOLDS):
            fold_dir = model_dir / f"{fold:03d}"
            diag = pd.read_csv(fold_dir / "diagnosis_results.csv")
            files = sorted(fold_dir.glob("*/*.csv"))
            if len(files) != 3 * len(ZOO_DIMS) or not np.isfinite(
                    diag["Diagnosis"]).all():
                raise RuntimeError(f"phase 10: nmmlp fold {fold}: {files}")
            for path in files:
                frame = pd.read_csv(path)
                if len(frame) != len(diag) or not np.isfinite(
                        frame.select_dtypes("number").to_numpy()).all():
                    raise RuntimeError(f"phase 10: nmmlp {path.name}")
            rows = max(rows, len(diag))
        text = (root / "outputs" / "analysis_results"
                / "performance_metrics.txt").read_text()
        if "Mean ROC AUC" not in text or not 0.0 <= stats["auc"] <= 1.0:
            raise RuntimeError(f"phase 10: nmmlp analysis {stats} {text}")
        check_rows(name, rows, timings["score_rows"])
        return (f"{FOLDS} x ({3 * len(ZOO_DIMS)} + 1) fold CSVs of up to "
                f"{rows} rows, AUC {stats['auc']:.4f}")
    out = root / "regression_outputs"
    rows = 0
    for fold in range(FOLDS):
        pred = np.load(out / f"fold_{fold}_pred.npy")
        true = np.load(out / f"fold_{fold}_true.npy")
        if pred.shape != true.shape or pred.shape[1] != 1 or not (
                np.isfinite(pred).all()):
            raise RuntimeError(f"phase 10: regression fold {fold} .npy "
                               f"{pred.shape} {true.shape}")
        rows = max(rows, len(pred))
    check_rows(name, rows, timings["score_rows"])
    roi = sorted(out.glob("deviation_fold_*_roiwise.csv"))
    if len(roi) != FOLDS * len(DIMS):
        raise RuntimeError(f"phase 10: regression ROI files {roi}")
    for path in roi:
        frame = pd.read_csv(path)
        if (len(frame) != COHORT_SUBJECTS or frame.columns[0] != "IID"
                or not np.isfinite(frame.iloc[:, 1:].to_numpy()).all()):
            raise RuntimeError(f"phase 10: {path.name} {frame.shape}")
    # fold_<k>_scatter.png only where matplotlib is installed
    figures = FOLDS if importlib.util.find_spec("matplotlib") else 0
    if (timings["roi_rows"] != COHORT_SUBJECTS
            or len(list(out.glob("fold_*_scatter.png"))) != figures):
        raise RuntimeError(f"phase 10: regression ROI rows "
                           f"{timings['roi_rows']}, files {list(out.iterdir())}")
    return (f"{FOLDS} .npy pairs of up to {rows} rows, {len(roi)} ROI CSVs "
            f"of {COHORT_SUBJECTS} rows, {figures} scatter figures; RMSE "
            f"per fold {[round(float(s['RMSE']), 4) for s in stats]}")


def check_rows(name, most, rows):
    """The scoring call's rows are the largest fold's test rows padded to
    the 64-row bucket, the rows phase 3 (K1, K2) or this phase held the
    kernels at."""
    if rows != -(-most // 64) * 64 or rows != STAGE_ROWS:
        raise RuntimeError(f"phase 10: {name} scored {rows} rows for "
                           f"{most} test rows; checked at {STAGE_ROWS}")


def run_variants(stats):
    """Phase 10: the three variant chains on the card, each scoring call
    held against its plain path, and the regression's new kernel shapes
    timed. Returns {chain: launches of its scoring}."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        nmmlp,
        nmpmcont,
        regression,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    modules = {"nmpmcont": nmpmcont, "nmmlp": nmmlp,
               "regression": regression}
    chain_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "cohort"
        make_synthetic_resource(base, "ADNI", with_early_fusion=True,
                                with_fi=True, **CHAIN_COHORT)
        for name, flags in VARIANT_CHAINS:
            root = Path(tmp) / name
            shutil.copytree(base / "data", root / "data")
            module = modules[name]
            args = module.build_parser().parse_args(flags)
            timings = {}
            if name == "nmmlp":
                args.action = "train"
                nmmlp.main(args, root, timings=timings)
                args.action = "test"
            elif name == "nmpmcont":
                from multi_modal_normative_modeling_tpu_torch.cli import (
                    common,
                )
                common.apply_post_parse_defaults(args, "SE-MoE")
            # the counts from 0 just before the chain's scoring stage (the
            # plain trainer before it launches K7 alone, once a step), read
            # just after
            kernels.reset_launch_counts()
            if name == "nmpmcont":
                result = nmpmcont.main(args, root, timings=timings)
            elif name == "nmmlp":
                nmmlp.main(args, root, timings=timings)
            else:
                result = regression.train_and_test(args, root,
                                                   timings=timings)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in kernels.KERNELS
                        if k.launches}
            want = (VARIANT_LAUNCHES[name] if name == "nmmlp" else
                    with_adam(VARIANT_LAUNCHES[name], timings["train_steps"]))
            if name == "nmmlp":
                args.action = "analyze"
                result = nmmlp.main(args, root, timings=timings)
            if launches != want:
                raise RuntimeError(f"phase 10: the scoring of {name} launched "
                                   f"{launches}, expected {want}")
            chain_launches[name] = launches
            summary = check_variant_files(name, root, timings, result)
            ms = timings["train_run_s"] * 1e3 / timings["train_steps"]
            stats.setdefault("variant_ms_per_step", {})[name] = ms
            walls = ", ".join(f"{k} {v:.3f} s"
                              for k, v in timings["walls"].items())
            print(f"phase 10: {name} {' '.join(flags)}: "
                  f"{timings['train_steps']} plain steps at {ms:.4f} "
                  f"ms/step; walls {walls}; scoring launches {launches}; "
                  f"{summary}", flush=True)
            roi_rows = timings.get("roi_rows")
            err, call = check_variant_scoring(name, timings["score_rows"],
                                              roi_rows)
            print(f"phase 10: {name} scoring call, {FOLDS} folds x "
                  f"{timings['score_rows']} rows"
                  + (f" (ROI {roi_rows} rows)" if roi_rows else "")
                  + f", through the kernels against the plain path in fp64: "
                  f"max abs err {err:.3e}; launches {call}", flush=True)
            if name == "regression":
                time_regression_shapes(timings["score_rows"], roi_rows, stats)
    return chain_launches


def check_serving_shapes(stats):
    """K1 and K2 where a scoring request puts them (SERVE_SHAPES: 64 rows,
    5 and 10 folds). Fills stats[kernel]["serve"]."""
    hold_kernel_shapes("phase 11", [shape + (HIDDEN, LATENT)
                                    for shape in SERVE_SHAPES], stats,
                       "serve")


def hold_kernel_shapes(phase, shapes, stats, slot, k2=True, tol=None,
                       seed=11):
    """K1 and (with ``k2``) K2 at each of ``shapes`` (folds, rows, D, C,
    hidden, latent) on seeded tensors: each against its plain version
    evaluated in fp64 (at ``tol``; by default the kernel checks' TOL and
    DEV_TOL), event and device ms beside the bound. Fills
    stats[kernel][slot]."""
    from multi_modal_normative_modeling_tpu_torch.kernels import (
        deviation,
        roofline,
    )
    from multi_modal_normative_modeling_tpu_torch.models import (
        Decoder,
        Encoder,
    )

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    for folds, rows, d, c_dim, hidden, latent in shapes:
        x = torch.from_numpy(rng.standard_normal(
            (folds, rows, d), dtype=np.float32)).cuda()
        c = covariates(rng, folds, rows, c_dim)
        z = torch.from_numpy(rng.standard_normal(
            (folds, rows, latent), dtype=np.float32)).cuda()
        enc = Encoder(d, hidden, latent, c_dim, folds=folds, generator=gen,
                      device="cuda")
        dec = Decoder(d, hidden, latent, c_dim, folds=folds, generator=gen,
                      device="cuda")
        e1, _, enc_plan = check_encoder(enc, x, c, tol=tol or TOL)
        shape = (folds, rows, d, c_dim, list(hidden), latent)
        key = f"F={folds} B={rows} D={d} C={c_dim}"
        if list(hidden) != HIDDEN or latent != LATENT:
            key += f" hidden {list(hidden)} latent {latent}"
        timed = [("fused_encoder", e1, lambda: enc.fused(x, c),
                  lambda: enc(x, c), roofline.fused_encoder(*shape),
                  f"{enc_plan.tiles} tiles x {enc_plan.splits} K splits")]
        if k2:
            recon, dev = dec.fused_pred_deviation(z, c, x)
            want_recon, want_dev = deviation.pred_deviation_reference(
                [tuple(fp64(*layer)) for layer in dec.hidden_layers()],
                tuple(fp64(*dec.mean.pair())), *fp64(z, c, x), True)
            e2 = max(check_close("fused_pred_deviation recon", recon,
                                 want_recon.float(), tol or TOL)[0],
                     check_close("fused_pred_deviation dev", dev,
                                 want_dev.float(), tol or DEV_TOL)[0])
            dec_plan = deviation.plan(folds, rows, latent + c_dim,
                                      tuple(hidden[::-1]), d)
            timed.append((
                "fused_pred_deviation", e2,
                lambda: dec.fused_pred_deviation(z, c, x),
                lambda: deviation.reconstruction_deviation(x, dec(z, c)[0]),
                roofline.fused_pred_deviation(*shape),
                f"{dec_plan.tiles} tiles x {dec_plan.groups} column groups"))
        with torch.no_grad():
            for kname, err, fn, plain, work, plan_text in timed:
                ms, dev_ms = cuda_ms(fn), device_ms(fn)
                plain_ms, plain_dev = cuda_ms(plain), device_ms(plain)
                print(f"{phase}: {kname} at {key} ({plan_text}): max abs "
                      f"err {err:.3e} vs fp64; {ms:.4f} ms (device "
                      f"{dev_ms:.4f}) vs plain {plain_ms:.4f} ms (device "
                      f"{plain_dev:.4f}), {bound_text(work, ms)}",
                      flush=True)
                s = stats[kname]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s.setdefault(slot, {})[key] = {
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "plain_device_ms": plain_dev, "bound_ms": work.bound_ms}


def launch_counts():
    from multi_modal_normative_modeling_tpu_torch import kernels

    return {k.__name__: k.launches for k in kernels.KERNELS if k.launches}


def stack64(arrays, rows):
    """[len(arrays), rows, width] float64 on the card: each array's rows
    first, zero rows after (the fp64 counterpart of common.stack_padded)."""
    out = torch.zeros((len(arrays), rows, arrays[0].shape[1]),
                      dtype=torch.float64, device="cuda")
    for i, a in enumerate(arrays):
        out[i, :len(a)] = torch.from_numpy(np.asarray(a, np.float64))
    return out


def plain_scores64(model, xs, covs, combine, eps):
    """The plain path evaluated in fp64 on the same eps: (the model in
    double, recons per modality [K, n, F_m], devs [K, M, n]) of a copy of
    the fold-stacked model, from fp64 inputs."""
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        recons = model64.pred_recon(xs, [covs] * len(xs), combine,
                                    eps=eps.double())
    devs = torch.stack([model64.reconstruction_deviation(x, r)
                        for x, r in zip(xs, recons)], dim=1)
    return model64, recons, devs


def latent_z64(model64, combine, xs, covs, n, fold_data, fold_cov):
    """The subjects' latent z-scores [K, n, Z] in fp64: the fused latent of
    the first ``n`` rows against each fold's train cohort (the mean and
    variance, ddof 0, of its unpadded rows)."""
    sizes = [len(c) for c in fold_cov]
    train_x = [stack64([d[m] for d in fold_data], max(sizes))
               for m in range(len(xs))]
    train_c = stack64(fold_cov, max(sizes))
    with torch.no_grad():
        mu_train, _ = model64.latent_stats(train_x, [train_c] * len(xs),
                                           combine)
        mu, var = model64.latent_stats(xs, [covs] * len(xs), combine)
    mean = torch.stack([mu_train[k, :s].mean(dim=0)
                        for k, s in enumerate(sizes)])
    var_train = torch.stack([mu_train[k, :s].var(dim=0, unbiased=False)
                             for k, s in enumerate(sizes)])
    return ((mu[:, :n] - mean[:, None])
            / torch.sqrt(var_train[:, None] + var[:, :n]))


def check_score_cli(root):
    """cli.score over the whole cohort in this process, with --roi_output
    and --latent: K1 and K2 one launch per modality for the scoring call,
    K1 one more per modality for the subjects' latent and one for the train
    cohorts'; the deviation, latent and ROI columns against the plain path
    evaluated in fp64 on the same eps. Returns (launches, wall s, max abs
    err)."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch import kernels, registry
    from multi_modal_normative_modeling_tpu_torch.cli import common, score
    from multi_modal_normative_modeling_tpu_torch.data.preprocess import (
        train_binned_covariates,
    )

    ids = root / "serve_ids.csv"
    pd.read_csv(root / "data" / "ADNI" / "y.csv")[["IID"]].to_csv(
        ids, index=False)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = score.run(["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS),
                     "--ids", str(ids), "--output", str(root / "scores.csv"),
                     "--roi_output", str(root / "scores_roi.csv"),
                     "--latent"], project_root=root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = {"fused_encoder": 3 * len(DIMS), "fused_pred_deviation": len(DIMS)}
    if launches != want:
        raise RuntimeError(f"phase 11: the score CLI launched {launches}, "
                           f"expected {want}")

    # the plain path in fp64, from the same prep, covariates and eps
    kfold_dir = root / "outputs" / "kfold_analysis"
    names = registry.get_datasets_name("ADNI", "UCA-gPoE")
    participants = root / "data" / "ADNI" / "y.csv"
    preps = [[common.prepare_modality(root, "ADNI", name, participants,
                                      common.fold_paths(kfold_dir, f)[0], ids)
              for name in names] for f in range(FOLDS)]
    n = len(out)
    padded = common.padded_rows(n)
    xs = [stack64([p[m]["test_data"] for p in preps], padded)
          for m in range(len(names))]
    covs = stack64([train_binned_covariates(
        p[-1]["train_df"][["AGE", "PTGENDER"]],
        p[-1]["test_df"][["AGE", "PTGENDER"]]) for p in preps], padded)
    eps = torch.from_numpy(np.stack([common.seeded_eps(42 + f, padded, LATENT)
                                     for f in range(FOLDS)])).cuda()
    model, _, config = common.load_model_and_params(
        [kfold_dir / "supervised_cvae" / f"{f:03d}" for f in range(FOLDS)],
        "cuda")
    model64, recons, devs = plain_scores64(model, xs, covs, config["combine"],
                                           eps)
    z = latent_z64(model64, config["combine"], xs, covs, n,
                   [[q["train_data"] for q in p] for p in preps],
                   [p[-1]["train_cov"] for p in preps])
    roi = pd.read_csv(root / "scores_roi.csv")
    if roi.shape != (COHORT_SUBJECTS, 1 + sum(DIMS)) or n != COHORT_SUBJECTS:
        raise RuntimeError(f"phase 11: score wrote {out.shape}, ROI "
                           f"{roi.shape}")
    err = max(check_close(f"score {what}", torch.from_numpy(
        np.asarray(got, np.float64)), want.cpu(), MODEL_TOL)[0]
        for what, got, want in (
            ("deviation", out["deviation"],
             devs[:, :, :n].mean(dim=1).mean(dim=0)),
            ("latent_deviation", out["latent_deviation"],
             (z.abs().sum(dim=2) / LATENT).mean(dim=0)),
            ("ROI plane", roi.iloc[:, 1:], torch.cat(
                [(x - r)[:, :n] ** 2 for x, r in zip(xs, recons)],
                dim=2).mean(dim=0))))
    return launches, wall, err


def serve_reference64(service, features, cov_frame, train):
    """What the service answers for these subjects, on the plain path
    evaluated in fp64 with the service's own noise: {key: tensor}.
    ``train`` holds each fold's train cohort (data per modality, one-hot
    covariates)."""
    from multi_modal_normative_modeling_tpu_torch.data.preprocess import (
        train_binned_covariates,
    )
    from multi_modal_normative_modeling_tpu_torch.infer import ensemble

    state = service.state
    n = features[0].shape[0]
    padded = -(-n // service.pad_to) * service.pad_to
    xs = [(stack64([f] * state.n_splits, padded) - c.double()[:, None])
          / s.double()[:, None]
          for f, c, s in zip(features, state.centers, state.scales)]
    covs = stack64([train_binned_covariates(tc, cov_frame)
                    for tc in state.train_covs], padded)
    eps = ensemble.fold_eps(state.seeds, padded, LATENT, "cuda")
    model64, recons, devs = plain_scores64(state.model, xs, covs,
                                           state.combine, eps)
    per_mod = devs[:, :, :n].mean(dim=0)
    z = latent_z64(model64, state.combine, xs, covs, n, *train)
    out = {"deviation": per_mod.mean(dim=0), "per_modality": per_mod,
           "roi": torch.cat([(x - r)[:, :n] ** 2
                             for x, r in zip(xs, recons)], dim=2).mean(0),
           "latent_deviation": (z.abs().sum(dim=2) / z.shape[2]).mean(dim=0),
           "latent_per_dim": z.mean(dim=0)}
    return {k: v.cpu() for k, v in out.items()}


def http_call(address, method, path, payload=None):
    """(status, JSON body, client ms) of one request on a new connection."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*address, timeout=120)
    body = None if payload is None else json.dumps(payload).encode()
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out, (time.perf_counter() - t0) * 1e3


def check_service_answers(service, address, train):
    """Requests over HTTP against the plain path in fp64 on the service's
    noise: ids of 1, 64 and 256 subjects, 64 with roi and with latent, raw
    features of the same 64 with roi (which must give the ids answer).
    Returns the max abs err."""
    frames, names = service._frames, service.dataset_names
    all_ids = list(frames[0].index)
    err, answers = 0.0, {}
    for mode, size, flags in (("ids", 1, {}), ("ids", 64, {}),
                              ("ids", 256, {}), ("ids", 64, {"roi": True}),
                              ("ids", 64, {"latent": True}),
                              ("raw", 64, {"roi": True})):
        rows = [f.loc[all_ids[:size]] for f in frames]
        feats = [r[cols].to_numpy(np.float32)
                 for r, cols in zip(rows, service.columns)]
        cov = rows[-1][["AGE", "PTGENDER"]]
        payload = ({"ids": all_ids[:size]} if mode == "ids" else {
            "features": {name: f.tolist() for name, f in zip(names, feats)},
            "covariates": {"AGE": cov["AGE"].tolist(),
                           "PTGENDER": cov["PTGENDER"].tolist()}})
        status, body, _ = http_call(address, "POST", "/score",
                                    dict(payload, **flags))
        if status != 200:
            raise RuntimeError(f"phase 11: {mode} {size} {flags}: {status} "
                               f"{body}")
        want = serve_reference64(service, feats, cov, train)
        body["per_modality"] = [body["per_modality"][name] for name in names]
        for key in ("deviation", "per_modality", "roi", "latent_deviation",
                    "latent_per_dim"):
            if key in body:
                err = max(err, check_close(
                    f"serve {mode} {size} {flags} {key}",
                    torch.tensor(body[key], dtype=torch.float64), want[key],
                    MODEL_TOL)[0])
        answers[mode, size, tuple(flags)] = body["deviation"]
    if not np.allclose(answers["ids", 64, ("roi",)],
                       answers["raw", 64, ("roi",)], rtol=1e-6, atol=0.0):
        raise RuntimeError("phase 11: raw and ids requests disagree")
    return err


def run_serving(root, stats):
    """Phase 11: the scoring surfaces on phase 8's trained project: the
    score CLI, then the resident service over HTTP, each held against the
    plain path in fp64; the service's launches and latency by request
    size; K1/K2 at the requests' shapes. Returns the launches by surface:
    {"score_cli" | "request" | "latent_request": {kernel: launches}}."""
    import threading

    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import serve
    from multi_modal_normative_modeling_tpu_torch.data.preprocess import (
        train_binned_covariates,
    )
    from multi_modal_normative_modeling_tpu_torch.infer import ensemble

    launches, wall, err = check_score_cli(root)
    print(f"phase 11: cli.score -R ADNI -P UCA-gPoE -K {FOLDS} over "
          f"{COHORT_SUBJECTS} subjects with --roi_output and --latent: "
          f"{wall:.3f} s in this process; launches {launches}; deviation, "
          f"latent and ROI plane max abs err {err:.3e} vs the plain path in "
          f"fp64", flush=True)
    serve_launches = {"score_cli": launches}

    t0 = time.perf_counter()
    service = serve.ScoringService("ADNI", "UCA-gPoE", n_splits=FOLDS,
                                   project_root=root, device="cuda")
    startup = time.perf_counter() - t0
    state = service.state
    # time spent inside _score (binning, the device work under the lock,
    # the copies back), around the service's own method
    score_ms, score_body = [], service._score

    def timed_score(*args, **kwargs):
        start = time.perf_counter()
        try:
            return score_body(*args, **kwargs)
        finally:
            score_ms.append((time.perf_counter() - start) * 1e3)

    service._score = timed_score
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    address = server.server_address[:2]
    sent = 0
    try:
        status, health, _ = http_call(address, "GET", "/healthz")
        if (status != 200 or health["backend"] != "cuda"
                or health["device"] != torch.cuda.get_device_name(0)):
            raise RuntimeError(f"phase 11: /healthz {status} {health}")
        train = ensemble.train_preps(root, "ADNI", state.dataset_names,
                                      FOLDS)
        err = check_service_answers(service, address, (
            [[p["train_data"] for p in preps] for preps in train],
            [preps[-1]["train_cov"] for preps in train]))
        sent += 6
        print(f"phase 11: ScoringService on {health['device']} "
              f"({startup:.3f} s to start), 6 requests over HTTP (ids 1, "
              f"64, 256; ids 64 with roi, with latent; raw 64 with roi) "
              f"against the plain path in fp64 on the service's noise: max "
              f"abs err {err:.3e}; raw and ids agree", flush=True)

        ids = list(service._frames[0].index)
        for name, flags in (("request", {}),
                            ("latent_request", {"latent": True})):
            kernels.reset_launch_counts()
            http_call(address, "POST", "/score", dict({"ids": ids[:64]},
                                                      **flags))
            sent += 1
            serve_launches[name] = launch_counts()
            want = {"fused_encoder": len(DIMS) * (1 + bool(flags)),
                    "fused_pred_deviation": len(DIMS)}
            if serve_launches[name] != want:
                raise RuntimeError(f"phase 11: a {name} launched "
                                   f"{serve_launches[name]}, expected {want}")

        for size in SERVE_SIZES:
            payload = {"ids": ids[:size]}
            for _ in range(3):
                http_call(address, "POST", "/score", payload)
            del score_ms[:]
            client = [http_call(address, "POST", "/score", payload)[2]
                      for _ in range(LATENCY_REQUESTS)]
            sent += 3 + LATENCY_REQUESTS
            inside = list(score_ms)
            # the device time of one request's launches: its scoring call
            # replayed from a CUDA graph on the same tensors
            padded = -(-size // service.pad_to) * service.pad_to
            rows = [f.loc[ids[:size]] for f in service._frames]
            xes = [torch.from_numpy(np.pad(
                r[cols].to_numpy(np.float32), ((0, padded - size), (0, 0))))
                .cuda() for r, cols in zip(rows, service.columns)]
            covs = torch.from_numpy(np.pad(np.stack([
                train_binned_covariates(tc, rows[-1][["AGE", "PTGENDER"]])
                .astype(np.float32) for tc in state.train_covs]),
                ((0, 0), (0, padded - size), (0, 0)))).cuda()
            eps = ensemble.fold_eps(state.seeds, padded, LATENT, "cuda")
            dev = device_ms(lambda: ensemble.fold_infer(state, covs, eps,
                                                        xes))
            # two parts of _score's time: the covariate binning by the
            # folds' train cohorts, and the scoring call with its copies
            # back (host clock, synchronized)
            cov = rows[-1][["AGE", "PTGENDER"]]
            binning = wall_ms(lambda: [train_binned_covariates(tc, cov)
                                       for tc in state.train_covs])
            call = wall_ms(lambda: [t.cpu() for t in ensemble.fold_infer(
                state, covs, eps, xes)])
            p50, p95 = np.percentile(client, [50, 95])
            q50, q95 = np.percentile(inside, [50, 95])
            print(f"phase 11: serve {size} subject(s) ({padded} padded rows, "
                  f"{FOLDS} folds), {LATENCY_REQUESTS} requests: client p50 "
                  f"{p50:.3f} ms, p95 {p95:.3f} ms; inside _score p50 "
                  f"{q50:.3f} ms, p95 {q95:.3f} ms (of it the binning "
                  f"{binning:.3f} ms, the scoring call and its copies back "
                  f"{call:.3f} ms); launches per request "
                  f"{serve_launches['request']}; device {dev:.4f} ms for "
                  f"one request's launches", flush=True)
            for kname in ("fused_encoder", "fused_pred_deviation"):
                stats[kname].setdefault("serve_latency", {})[
                    f"{size} subjects"] = {
                    "client_p50_ms": p50, "client_p95_ms": p95,
                    "score_p50_ms": q50, "score_p95_ms": q95,
                    "binning_ms": binning, "call_ms": call,
                    "request_device_ms": dev}
        if service.requests_served != sent:
            raise RuntimeError(f"phase 11: {service.requests_served} "
                               f"requests served of {sent} sent")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check_serving_shapes(stats)
    return serve_launches


def tree_leaves(tree, path=""):
    """(path, leaf) of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


def fold_checkpoints(root):
    return sorted((root / "outputs" / "kfold_analysis" / "supervised_cvae")
                  .glob("*/cVAE_model.ckpt"))


def checkpoint_distance(a, b):
    """0.0 when two projects wrote byte-equal fold checkpoints, else the
    largest absolute difference between their parameters."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        read_flax_checkpoint,
    )

    ca, cb = fold_checkpoints(a), fold_checkpoints(b)
    if [p.relative_to(a) for p in ca] != [p.relative_to(b) for p in cb] \
            or not ca:
        raise RuntimeError(f"checkpoints differ in number: {ca} {cb}")
    if all(x.read_bytes() == y.read_bytes() for x, y in zip(ca, cb)):
        return 0.0
    dist = 0.0
    for x, y in zip(ca, cb):
        lx = dict(tree_leaves(read_flax_checkpoint(x.parent)[0]))
        ly = dict(tree_leaves(read_flax_checkpoint(y.parent)[0]))
        dist = max(dist, max(float(np.abs(lx[k] - ly[k]).max()) for k in lx))
    return dist


def hold_resumed(what, straight, again, resumed):
    """A resumed run against the straight one, on the terms two straight
    runs show: byte-equal checkpoints when they are, else no further apart
    than they are. Returns (straight-to-straight, straight-to-resumed)."""
    bound = checkpoint_distance(straight, again)
    dist = checkpoint_distance(straight, resumed)
    if dist > bound:
        raise RuntimeError(f"phase 12a: {what}: the resumed run is {dist:.3e} "
                           f"from the straight one, two straight runs "
                           f"{bound:.3e}")
    return bound, dist


def run_resume(stats):
    """Phase 12a: --checkpoint_every / --resume on every training path of
    the train CLI and on nm-PM-cont, on phase 8's cohort. Returns {path:
    launches of the resumed call} and the plain path's straight-run
    distance (phase 12b holds its sweep at it)."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        nmpmcont,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )
    from multi_modal_normative_modeling_tpu_torch.train.checkpoints import (
        load_train_state,
        peek_train_meta,
        save_train_state,
    )

    launches, plain_bound = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_resource(tmp / "cohort", "ADNI",
                                with_early_fusion=True, with_fi=True,
                                **CHAIN_COHORT)

        def project(name):
            root = tmp / name
            shutil.copytree(tmp / "cohort" / "data", root / "data")
            return root

        for path, flags in RESUME_PATHS:
            t0 = time.perf_counter()
            roots = {k: project(f"{path}-{k}")
                     for k in ("straight", "again", "resumed", "every1")}
            argv = RESUME_FLAGS + flags + ["-E", str(RESUME_EPOCHS)]
            for k in ("straight", "again"):
                train_supervised.run(argv, project_root=roots[k])
            train_supervised.run(
                RESUME_FLAGS + flags + ["-E", str(RESUME_KILLED),
                                        "--checkpoint_every",
                                        str(RESUME_EVERY)],
                project_root=roots["resumed"])
            # the counts from 0 just before the resumed call, read after
            kernels.reset_launch_counts()
            train_supervised.run(argv + ["--checkpoint_every",
                                         str(RESUME_EVERY), "--resume"],
                                 project_root=roots["resumed"])
            torch.cuda.synchronize()
            launches[path] = launch_counts()
            bound, dist = hold_resumed(path, roots["straight"],
                                       roots["again"], roots["resumed"])
            if path == "plain":
                plain_bound = bound
            model_dir = (roots["resumed"] / "outputs" / "kfold_analysis"
                         / "supervised_cvae")
            _, steps = train_run(model_dir)
            resumed_epochs = RESUME_EPOCHS - RESUME_KILLED
            per_step = {"K4": 2 * len(DIMS)}.get(path, 1)
            want = with_adam({RESUME_KERNELS[path]: per_step * steps}
                             if path in RESUME_KERNELS else {}, steps)
            if steps % resumed_epochs or launches[path] != want:
                raise RuntimeError(f"phase 12a: {path}: the resumed call "
                                   f"ran {steps} steps and launched "
                                   f"{launches[path]}, expected {want}")
            train_supervised.run(argv + ["--checkpoint_every", "1"],
                                 project_root=roots["every1"])
            none_ms, n_steps = train_run(roots["straight"] / "outputs"
                                         / "kfold_analysis"
                                         / "supervised_cvae")
            every_ms, _ = train_run(roots["every1"] / "outputs"
                                    / "kfold_analysis" / "supervised_cvae")
            state_dir = model_dir / "fused-state" if path in ("K5", "K6") \
                else model_dir
            size = (state_dir / "train_state.ckpt").stat().st_size
            tensors, epoch, logs = load_train_state(state_dir)
            meta = peek_train_meta(state_dir)
            on_card = {k: torch.from_numpy(v).cuda()
                       for k, v in tensors["adam"].items()}
            saves = []
            for i in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                host = {k: v.cpu().numpy() for k, v in on_card.items()}
                save_train_state(tmp / "save", {**tensors, "adam": host},
                                 epoch, logs, meta=meta)
                saves.append((time.perf_counter() - t1) * 1e3)
            extra_ms = (every_ms - none_ms) * n_steps / RESUME_EPOCHS
            print(f"phase 12a: {path} -E {RESUME_EPOCHS} "
                  f"{' '.join(flags)}: resumed from "
                  f"epoch {RESUME_KILLED} in a fresh main, {steps} steps "
                  f"({steps // resumed_epochs} a epoch x {resumed_epochs}), "
                  f"launches {launches[path]}; fold checkpoints "
                  + ("byte-equal to the straight run's (two straight runs "
                     "byte-equal)" if bound == 0.0 else
                     f"{dist:.3e} from the straight run's (two straight runs "
                     f"{bound:.3e} apart)")
                  + f"; train state {size} bytes, meta {meta}, one save "
                  f"{min(saves):.2f} ms (median {sorted(saves)[2]:.2f}, "
                  f"copy from the card included); ms per step "
                  f"{none_ms:.4f} without checkpoints, {every_ms:.4f} with "
                  f"--checkpoint_every 1 ({extra_ms:.2f} ms an epoch more); "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if path in RESUME_KERNELS:
                stats[RESUME_KERNELS[path]]["resume"] = {
                    "state_bytes": size, "save_ms": min(saves),
                    "ms_per_step": none_ms,
                    "ms_per_step_checkpoint_every_1": every_ms}

        # nm-PM-cont: BatchNorm state, dropout masks and labels come back
        t0 = time.perf_counter()
        flags = VARIANT_CHAINS[0][1]
        roots = {k: project(f"nmpmcont-{k}")
                 for k in ("straight", "again", "resumed")}
        for k in ("straight", "again"):
            nmpmcont.run(flags, project_root=roots[k])
        killed = 8
        nmpmcont.run(flags + ["-E", str(killed), "--checkpoint_every", "4"],
                     project_root=roots["resumed"])
        nmpmcont.run(flags + ["--checkpoint_every", "4", "--resume"],
                     project_root=roots["resumed"])
        bound, dist = hold_resumed("nmpmcont", roots["straight"],
                                   roots["again"], roots["resumed"])
        print(f"phase 12a: nmpmcont {' '.join(flags)}: killed after epoch "
              f"{killed}, resumed in a fresh main: fold checkpoints "
              + ("byte-equal to the straight run's (two straight runs "
                 "byte-equal)" if bound == 0.0 else
                 f"{dist:.3e} from the straight run's (two straight runs "
                 f"{bound:.3e} apart)")
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, plain_bound


def run_sweep(stats, plain_bound):
    """Phase 12b: cli.sweep_supervised on a synthetic ADHD cohort, the
    launch counts set to 0 before each point's test stage and read after
    it; the last point against train_supervised run alone; K1 and K2 at the
    test stages' shapes. Returns {point: launches}."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        sweep_supervised,
        test_supervised,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    points = {}
    stage = test_supervised.main

    def counted(point, **kwargs):
        kernels.reset_launch_counts()
        out = stage(point, **kwargs)
        torch.cuda.synchronize()
        label = (f"{point.procedure} -H "
                 f"{' '.join(map(str, point.hz_para_list))} -E {point.epochs}")
        points[label] = launch_counts()
        want = SWEEP_LAUNCHES[point.procedure]
        if points[label] != {"fused_encoder": want,
                             "fused_pred_deviation": want}:
            raise RuntimeError(f"phase 12b: the test stage of {label} "
                               f"launched {points[label]}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "adhd"
        t0 = time.perf_counter()
        make_synthetic_resource(root, "ADHD", **ADHD_COHORT)
        made = time.perf_counter() - t0
        timings = {}
        test_supervised.main = counted
        try:
            records = sweep_supervised.main(
                sweep_supervised.build_parser().parse_args(SWEEP_ARGV),
                project_root=root, timings=timings)
        finally:
            test_supervised.main = stage
        whole = time.perf_counter() - t0 - made
        computed = [r for r in records if "deduped_from" not in r]
        aucs = [a for r in records for a in r["stats"]["auc"]]
        if (len(records) != 24 or len(computed) != 12 or len(points) != 12
                or not all(np.isfinite(a) and 0.0 <= a <= 1.0
                           for a in aucs)):
            raise RuntimeError(f"phase 12b: {len(records)} records, "
                               f"{len(computed)} computed, {len(points)} test "
                               f"stages, AUCs {aucs}")
        last = computed[-1]
        alone = Path(tmp) / "alone"
        shutil.copytree(root / "data", alone / "data")
        train_supervised.run(
            ["-R", "ADHD", "-P", last["procedure"], "-K", str(ADHD_FOLDS),
             "-H", *map(str, last["hz_para_list"]), "-E",
             str(last["epochs"])], project_root=alone)
        dist = checkpoint_distance(alone, root)
        if dist > plain_bound:
            raise RuntimeError(f"phase 12b: the last point is {dist:.3e} from "
                               f"train_supervised alone (two straight plain "
                               f"runs {plain_bound:.3e})")
        config = json.loads((fold_checkpoints(root)[0].parent
                             / "cVAE_model.json").read_text())
        kfold = root / "outputs" / "kfold_analysis"
        rows = common.padded_rows(max(
            len(pd.read_csv(kfold / f"test_ids_{f:03d}.csv"))
            for f in range(ADHD_FOLDS)))
        walls = ", ".join(f"{k} {v:.3f} s" for k, v in
                          timings["walls"].items())
        print(f"phase 12b: sweep_supervised {' '.join(SWEEP_ARGV)}: ADHD "
              f"cohort of {sum(ADHD_COHORT['n_disease'].values()) + ADHD_COHORT['n_hc']} "
              f"subjects made in {made:.3f} s; {len(records)} records, "
              f"{len(computed)} computed points, 6 training runs in "
              f"{whole:.1f} s; walls {walls}; AUCs in [{min(aucs):.4f}, "
              f"{max(aucs):.4f}]; the last point "
              + ("byte-equal to" if dist == 0.0 else f"{dist:.3e} from")
              + f" train_supervised alone; test stages at {ADHD_FOLDS} x "
              f"{rows} rows, widths {config['input_dim_list']}, C "
              f"{config['c_dim']}; launches per point {points}", flush=True)
    hold_kernel_shapes(
        "phase 12b", [(ADHD_FOLDS, rows, d, config["c_dim"], hz[:-1],
                       hz[-1])
                      for hz in SWEEP_HZ
                      for d in sorted(set(config["input_dim_list"]))],
        stats, "adhd", tol=MODEL_TOL, seed=12)
    return points


def run_grid(stats, nmpmcont_ms):
    """Phase 12c: cli.sweep_endtoend's 12 x 5 grid in one run of 60
    stacked folds, its prediction through K1 at F = 60; one config against
    nmpmcont alone. Returns the grid's launches."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        nmpmcont,
        sweep_endtoend,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )
    from multi_modal_normative_modeling_tpu_torch.interop import (
        read_flax_checkpoint,
    )
    from multi_modal_normative_modeling_tpu_torch.models.endtoend import (
        EndToEndCVAE,
        endtoend_loss_fn,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel.sweep import (
        SweepTrainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_resource(tmp / "cohort", "ADNI",
                                with_early_fusion=True, with_fi=True,
                                **CHAIN_COHORT)
        roots = {}
        for name in ("grid", "alone"):
            roots[name] = tmp / name
            shutil.copytree(tmp / "cohort" / "data", roots[name] / "data")
        args = sweep_endtoend.build_parser().parse_args(GRID_ARGV)
        common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
        timings = {}
        kernels.reset_launch_counts()
        results = sweep_endtoend.main(args, roots["grid"], timings=timings)
        torch.cuda.synchronize()
        launches = launch_counts()
        configs = len(args.margins) * len(args.weightcontrastives)
        text = (roots["grid"] / "results_endtoend.csv").read_text()
        if (launches != with_adam({"fused_encoder": 3},
                                  timings["train_steps"])
                or len(results) != configs
                or text.count("Namespace(") != configs):
            raise RuntimeError(f"phase 12c: launches {launches}, "
                               f"{len(results)} results, "
                               f"{text.count('Namespace(')} blocks")
        alone = nmpmcont.run(GRID_FLAGS + ["-Margin", "1",
                                           "-Weightcontrastive", "0.1"],
                             project_root=roots["alone"])
        # the per-fold metrics of argmax predictions: equal, or a few
        # predictions apart (a fold's test rows are 120)
        metric_diff = float(np.abs(results[(1.0, 0.1)].to_numpy()
                                   - alone.to_numpy()).max())
        if not metric_diff <= GRID_METRIC_DIFF:
            raise RuntimeError(f"phase 12c: margin 1 weight 0.1: the grid's "
                               f"metrics are {metric_diff} from nmpmcont "
                               "alone")
        # the grid's training again through the library, its (1, 0.1)
        # folds held against nmpmcont's checkpoints at the bounds of the
        # JAX package's sweep test; the classifier's pre-BatchNorm biases
        # and running means (Adam's sign noise, tests/test_torch_endtoend.py)
        # are left out
        fold_data, dims, c_dim = nmpmcont.prepare_cohort(
            args, roots["grid"], common.StageWalls())
        model = EndToEndCVAE(dims, HIDDEN, LATENT, c_dim, len(dims),
                             classifier_layers=CLASSIFIER_LAYERS,
                             dropout_rate=0.5, folds=configs * FOLDS)
        nmpmcont.default_init(model)
        model.cuda()
        hypers = [{"margin": m, "wcon": w} for m in args.margins
                  for w in args.weightcontrastives]
        params, _ = SweepTrainer(
            model, TrainConfig(epochs=args.epochs, batch_size=256,
                               combine="poe"),
            fold_data[0]["train_data"][0].shape[0],
            lambda h: endtoend_loss_fn(model, h["margin"], h["wcon"]),
            state_update=model.update_state).run(
                nmpmcont.fold_batches(fold_data, 256), hypers)
        s = hypers.index({"margin": 1.0, "wcon": 0.1})
        err, skipped = 0.0, 0
        for f, ckpt in enumerate(fold_checkpoints(roots["alone"])):
            want = dict(tree_leaves(read_flax_checkpoint(ckpt.parent)[0]))
            for path, leaf in tree_leaves(params[s][f]):
                if (("'blocks'" in path and path.endswith("['linear']['b']"))
                        or (path.startswith("['bn_state']")
                            and path.endswith("['mean']"))):
                    skipped += 1
                    continue
                if not np.allclose(leaf, want[path], **GRID_PARAM_TOL):
                    raise RuntimeError(f"phase 12c: fold {f} {path}: "
                                       f"{np.abs(leaf - want[path]).max():.3e}"
                                       " from nmpmcont alone")
                err = max(err, float(np.abs(leaf - want[path]).max()))
        ms = timings["train_run_s"] * 1e3 / timings["train_steps"]
        walls = ", ".join(f"{k} {v:.3f} s"
                          for k, v in timings["walls"].items())
        print(f"phase 12c: sweep_endtoend {' '.join(GRID_ARGV)}: {configs} "
              f"configs x {FOLDS} folds = {configs * FOLDS} stacked folds, "
              f"{timings['train_steps']} grid steps at {ms:.4f} ms/step "
              f"(phase 10's nm-PM-cont step, 5 folds: {nmpmcont_ms:.4f} "
              f"ms); walls {walls}; {configs} results_endtoend.csv blocks; "
              f"prediction launches {launches} at {configs * FOLDS} x "
              f"{timings['score_rows']} rows; margin 1 weight 0.1 against "
              f"nmpmcont alone: per-fold metrics "
              + ("equal" if metric_diff == 0.0 else
                 f"at most {metric_diff:.4f} apart")
              + f", parameters within {err:.3e} ({skipped} sign-noise "
              f"leaves left out)", flush=True)
        stats["fused_encoder"]["grid_ms_per_step"] = ms
        rows = timings["score_rows"]
    hold_kernel_shapes("phase 12c", [(configs * FOLDS, rows, 90, C_DIM,
                                      HIDDEN, LATENT)], stats, "grid",
                       k2=False, tol=MODEL_TOL, seed=13)
    return launches


def native_data_plane():
    """The native CSV reader and writer must be there on the card: phase 13
    asserts they build (g++ into native/_build/) and load."""
    from multi_modal_normative_modeling_tpu_torch.native import (
        fastcsv,
        fastwrite,
    )

    if not (fastcsv.fastcsv_available() and fastwrite.fastwrite_available()):
        raise RuntimeError("phase 13: the native CSV reader or writer did "
                           "not build")


def check_wide_tables_native(paths, phase):
    """No table of ``paths`` (the >= 256-column ones a stage read) may have
    gone to pandas: ``fast_path_reasons`` holds none of them."""
    from multi_modal_normative_modeling_tpu_torch.cli import common

    off = {p: common.fast_path_reasons[str(p)] for p in paths
           if str(p) in common.fast_path_reasons}
    if off:
        raise RuntimeError(f"{phase}: the native reader disengaged: {off}")


class PandasOnly:
    """Within it the native reader and writer report themselves missing,
    so every CSV goes through pandas (the data plane before this port of
    native/); on leaving, they come back and the disengage memo is
    cleared."""

    def __enter__(self):
        from multi_modal_normative_modeling_tpu_torch.native import (
            fastcsv,
            fastwrite,
        )

        self.saved = [(m, m._LIB, m._LIB_FAILED) for m in (fastcsv,
                                                             fastwrite)]
        for m, _, _ in self.saved:
            m._LIB, m._LIB_FAILED = None, True

    def __exit__(self, *exc):
        from multi_modal_normative_modeling_tpu_torch.cli import common

        for m, lib, failed in self.saved:
            m._LIB, m._LIB_FAILED = lib, failed
        common.fast_path_reasons.clear()


def run_bootstrap(stats):
    """Phase 13a: cli.bootstrap all on phase 8's cohort without its
    early-fusion CSV, conditioned and --unconditioned; the counts set to 0
    before each test stage and read after it; the deviation CSVs against
    the plain scoring call in fp64; K1 and K2 at the call's shapes.
    Returns ({variant: launches}, {variant: walls})."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import bootstrap
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    import pandas as pd

    launches, walls = {}, {}
    stage = bootstrap.test

    def counted(args, **kwargs):
        kernels.reset_launch_counts()
        out = stage(args, **kwargs)
        torch.cuda.synchronize()
        launches[variant] = launch_counts()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "adni"
        make_synthetic_resource(root, "ADNI", **CHAIN_COHORT)
        fused = root / "data" / "ADNI" / "early_fusion_modalities_ADNI.csv"
        if fused.exists():
            raise RuntimeError("phase 13a: the cohort holds the early-fusion "
                               "CSV")
        for variant, extra in (("CVAE", []), ("VAE", ["--unconditioned"])):
            args = bootstrap.build_parser().parse_args(
                ["all"] + BOOT_FLAGS + extra)
            timings = {}
            bootstrap.test = counted
            try:
                results = bootstrap.main(args, project_root=root,
                                         timings=timings)
            finally:
                bootstrap.test = stage
            c_dim = 1 if extra else C_DIM
            if launches[variant] != {"fused_encoder": 1,
                                     "fused_pred_deviation": 1}:
                raise RuntimeError(f"phase 13a: the {variant} test stage "
                                   f"launched {launches[variant]}")
            if timings["score_shape"] != (BOOT_REPS, BOOT_ROWS, 270, c_dim):
                raise RuntimeError(f"phase 13a: the scoring call's shape "
                                   f"{timings['score_shape']}")
            aucs = [r[k] for r in results.values()
                    for k in ("mean", "ci_low", "ci_high")]
            if (sorted(results) != ["2vs0", "2vs1"]
                    or any(r["n_replicates"] != BOOT_REPS
                           for r in results.values())
                    or not all(np.isfinite(a) and 0 <= a <= 1
                               for a in aucs)):
                raise RuntimeError(f"phase 13a: {variant} results {results}")
            # the CSVs against the plain call evaluated in fp64
            args.action = "test"
            jobs, model, xes, cs, eps = bootstrap.score_inputs(
                args, root, "cuda")
            _, _, devs64 = plain_scores64(model, [xes.double()],
                                          cs.double(), "gpoe", eps)
            err = 0.0
            for i, job in enumerate(jobs):
                csv = pd.read_csv(job["dir"] / "deviation_3modalities.csv")
                got = torch.tensor(csv["Reconstruction deviation"].to_numpy(),
                                   dtype=torch.float32, device="cuda")
                err = max(err, check_close(
                    f"phase 13a {variant} replicate {job['b']} deviation",
                    got, devs64[i, 0, :len(csv)].float(), MODEL_TOL)[0])
            for name in ("fused_encoder", "fused_pred_deviation"):
                stats[name]["max_abs_err"] = max(
                    stats[name]["max_abs_err"], err)
            walls[variant] = timings["walls"]
            print(f"phase 13a: bootstrap {' '.join(BOOT_FLAGS + extra)} "
                  f"(-D 3modalities fused in memory, no CSV): test stage "
                  f"launches {launches[variant]} over {BOOT_REPS} replicates "
                  f"x {BOOT_ROWS} rows, C {c_dim}; deviation CSVs max abs "
                  f"err {err:.3e} vs the plain call in fp64; walls "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in
                              timings["walls"].items())
                  + "; AUC " + "; ".join(
                      f"{p} {r['mean']:.4f} (95% CI [{r['ci_low']:.4f}, "
                      f"{r['ci_high']:.4f}], std {r['std']:.4f})"
                      for p, r in results.items()), flush=True)
        # the test stage with the pandas data plane, then native again
        args = bootstrap.build_parser().parse_args(["test"] + BOOT_FLAGS)
        for mode in ("pandas", "native"):
            timings = {}
            if mode == "pandas":
                with PandasOnly():
                    bootstrap.test(args, project_root=root, timings=timings)
            else:
                bootstrap.test(args, project_root=root, timings=timings)
            walls[f"CVAE test, {mode}"] = timings["walls"]
            print(f"phase 13a: bootstrap test stage again, {mode} CSV "
                  "plane: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                        timings["walls"].items()),
                  flush=True)
    hold_kernel_shapes("phase 13a", [shape + (HIDDEN, LATENT)
                                     for shape in BOOT_SHAPES],
                       stats, "bootstrap", tol=MODEL_TOL, seed=13)
    return launches, walls


def run_fusion(chain_root):
    """Phase 13b: phase 8's chain again with --in_memory_fusion, without
    the early-fusion CSV and with it, each held to phase 8's file-based
    run (tests/test_uca_pipeline.py:77-79: rtol 1e-5, atol 1e-8). Returns
    {run: launches}."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import pipeline

    fused = "early_fusion_modalities_ADNI"
    rel = (Path("deviation/supervised_cvae/ADNI/UCA-gPoE/path_model")
           / fused / f"reconstruction_error_{fused}.csv")
    names = ["av45", "vbm", "fdg", fused]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run, with_csv in (("no CSV", False), ("CSV present", True)):
            root = Path(tmp) / run.replace(" ", "_")
            shutil.copytree(chain_root / "data", root / "data")
            if not with_csv:
                (root / "data" / "ADNI" / f"{fused}.csv").unlink()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            pipeline.run(CHAIN_FLAGS + ["--in_memory_fusion"],
                         project_root=root)
            torch.cuda.synchronize()
            whole = time.perf_counter() - t0
            launches[run] = launch_counts()
            steps = launches[run].get("fused_train_step", 0)
            if (steps != TRAIN_EPOCHS * 2
                    or launches[run].get("fused_encoder") != len(names)
                    or launches[run].get("fused_pred_deviation")
                    != len(names)):
                raise RuntimeError(f"phase 13b: {run}: launches "
                                   f"{launches[run]}")
            err = 0.0
            for name in names:
                path = Path(str(rel).replace(fused, name))
                got = pd.read_csv(root / path)["Reconstruction error"]
                want = pd.read_csv(chain_root / path)["Reconstruction error"]
                if not np.allclose(got, want, rtol=1e-5, atol=1e-8):
                    raise RuntimeError(f"phase 13b: {run}: {name} differs "
                                       f"from the file-based run by "
                                       f"{np.abs(got - want).max():.3e}")
                err = max(err, float(np.abs(got - want).max()))
            print(f"phase 13b: the chain {' '.join(CHAIN_FLAGS)} "
                  f"--in_memory_fusion, {run}: {whole:.3f} s; launches "
                  f"{launches[run]} (K5 under the fused modality, {steps} "
                  f"steps); the four modalities' reconstruction errors "
                  f"within {err:.3e} of phase 8's file-based run (bound "
                  f"rtol 1e-5, atol 1e-8)", flush=True)
    return launches


def time_test_stage(what, args, root, wide_tables, walls):
    """One test stage's walls by phase, with the native CSV plane and with
    pandas, in turns (native, pandas, pandas, native)."""
    from multi_modal_normative_modeling_tpu_torch.cli import test_supervised

    for mode in ("native", "pandas", "pandas", "native"):
        timings = {}
        t0 = time.perf_counter()
        if mode == "pandas":
            with PandasOnly():
                test_supervised.main(args, project_root=root,
                                     timings=timings)
        else:
            test_supervised.main(args, project_root=root, timings=timings)
            check_wide_tables_native(wide_tables, "phase 13c")
        whole = time.perf_counter() - t0
        walls.setdefault(what, []).append(
            {"mode": mode, "whole": whole, **timings["walls"]})
        print(f"phase 13c: {what} test stage, {mode} CSV plane: "
              f"{whole:.3f} s; " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in timings["walls"].items()),
              flush=True)


def run_test_stage_phases(chain_root):
    """Phase 13c: phase 8's test stage and one ADHD sweep point's (SE-gPoE,
    -H 110 110 10, -K 10, 3 epochs) by phase, native against pandas.
    Returns {stage: [walls]}."""
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        test_supervised,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    walls = {}
    parser = test_supervised.build_parser()
    fused = chain_root / "data" / "ADNI" / "early_fusion_modalities_ADNI.csv"
    time_test_stage(
        "phase 8 (UCA-gPoE, 5 folds)",
        common.apply_post_parse_defaults(parser.parse_args(
            ["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS)])),
        chain_root, [fused], walls)
    point = ["-R", "ADHD", "-P", "SE-gPoE", "-K", str(ADHD_FOLDS), "-H",
             "110", "110", "10"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "adhd"
        make_synthetic_resource(root, "ADHD", **ADHD_COHORT)
        train_supervised.run(point + ["-E", "3"], project_root=root)
        time_test_stage(
            "an ADHD sweep point (SE-gPoE, 10 folds)",
            common.apply_post_parse_defaults(parser.parse_args(point)),
            root, [], walls)
    return walls


def run_classifier(stats):
    """Phase 14a: the classifier baseline on a 600-subject ADHD cohort: the
    CLI at the reference defaults and at one tune_parameter.sh point, then
    that script's four (lr, dropout) points at 116 64 32 as one grid, each
    against its own train_classifier run. Every epoch loop runs under
    torch.cuda.set_sync_debug_mode("error"): a host sync inside it fails
    the phase. Returns the walls and ms per epoch."""
    import os

    from multi_modal_normative_modeling_tpu_torch.cli import (
        classifier_baseline,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )
    from multi_modal_normative_modeling_tpu_torch.interop import (
        classifier_to_jax,
    )
    from multi_modal_normative_modeling_tpu_torch.models import classifier

    loops = []
    loop = classifier.run_epochs

    def guarded(step, epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop(step, epochs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        loops.append((time.perf_counter() - t0) * 1e3 / epochs)

    out = {}
    cwd = os.getcwd()
    classifier.run_epochs = guarded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            make_synthetic_resource(root / "adhd", "ADHD",
                                    **CLASSIFIER_COHORT)
            data = root / "adhd" / "data" / "ADHD"
            paths = ["--fmri_path", str(data / "fMRI.csv"),
                     "--labels_path", str(data / "y.csv")]
            os.chdir(root)
            for name, flags in (("defaults", []), ("tune point", TUNE_POINT)):
                ckpt = root / f"{name.replace(' ', '_')}.pth"
                t0 = time.perf_counter()
                metrics = classifier_baseline.run(
                    paths + flags + ["--checkpoint_path", str(ckpt)])
                wall = time.perf_counter() - t0
                written = [ckpt.with_suffix(".ckpt"), ckpt.with_suffix(".json"),
                           root / f"{ckpt.stem}_metrics.txt",
                           root / "experiment_results.json",
                           root / "logs" / "experiment.log"]
                missing = [p.name for p in written if not p.exists()]
                if missing or not all(np.isfinite(v) for v in metrics.values()):
                    raise RuntimeError(f"phase 14a: the CLI ({name}) wrote "
                                       f"no {missing}; metrics {metrics}")
                out[name] = {"wall_s": wall, "ms_per_epoch": loops[-1],
                             "metrics": metrics}
                print(f"phase 14a: classifier_baseline ({name}: "
                      f"{' '.join(flags) or '116 64 32, lr 1e-4, dropout 0'},"
                      f" {CLASSIFIER_EPOCHS} epochs) on an ADHD cohort "
                      f"{CLASSIFIER_COHORT}: {wall:.3f} s, {loops[-1]:.4f} ms/epoch "
                      f"with no host sync in the loop; "
                      + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()),
                      flush=True)
            x, y = classifier_baseline.load_data(str(data / "fMRI.csv"),
                                                 str(data / "y.csv"))
            x_tr, x_va, _, y_tr, y_va, _ = classifier_baseline.prepare_splits(
                x, y)
            # the defaults' loop again without the sync check, timed alone
            classifier.run_epochs = loop
            one = classifier_baseline.init_model(
                x_tr.shape[1], CLASSIFIER_HIDDEN, 0.0, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            classifier.train_classifier(one, x_tr, y_tr, x_va, y_va,
                                        CLASSIFIER_EPOCHS, 1e-4, 0.5, 10,
                                        1e-9)
            unchecked = (time.perf_counter() - t0) * 1e3 / CLASSIFIER_EPOCHS
            out["defaults"]["ms_per_epoch_unchecked"] = unchecked
            print(f"phase 14a: the defaults' train_classifier again without "
                  f"the sync check: {unchecked:.4f} ms/epoch (set-up and "
                  f"the history's fetch included)", flush=True)
            classifier.run_epochs = guarded
            model = classifier_baseline.init_model(
                x_tr.shape[1], CLASSIFIER_HIDDEN, 0.0, "cuda")
            t0 = time.perf_counter()
            best, hists = classifier.sweep_classifiers(
                model, x_tr, y_tr, x_va, y_va, CLASSIFIER_EPOCHS, TUNE_GRID)
            grid_wall = time.perf_counter() - t0
            grid_ms = loops[-1]
            val_err, param_err, one_ms = 0.0, 0.0, []
            for s_, cfg in enumerate(TUNE_GRID):
                one = classifier_baseline.init_model(
                    x_tr.shape[1], CLASSIFIER_HIDDEN, cfg["dropout"], "cuda")
                ref_best, ref_hist = classifier.train_classifier(
                    one, x_tr, y_tr, x_va, y_va, CLASSIFIER_EPOCHS,
                    cfg["initial_lr"], cfg["factor"], cfg["patience"],
                    cfg["min_lr"])
                one_ms.append(loops[-1])
                check_close(f"phase 14a: grid point {s_} val loss",
                            torch.from_numpy(hists[s_]["val_loss"]),
                            torch.from_numpy(ref_hist["val_loss"]),
                            CLASSIFIER_VAL_TOL)
                if not np.array_equal(hists[s_]["lr"], ref_hist["lr"]):
                    raise RuntimeError(f"phase 14a: grid point {s_}: the "
                                       "learning rates differ")
                val_err = max(val_err, float(np.max(np.abs(
                    hists[s_]["val_loss"] - ref_hist["val_loss"]))))
                for g, w in zip(classifier_to_jax(best, s_),
                                classifier_to_jax(ref_best, 0)):
                    for k in ("w", "b"):
                        check_close(f"phase 14a: grid point {s_} best {k}",
                                    torch.from_numpy(g[k]),
                                    torch.from_numpy(w[k]),
                                    CLASSIFIER_PARAM_TOL)
                        param_err = max(param_err,
                                        float(np.max(np.abs(g[k] - w[k]))))
            out["grid"] = {"wall_s": grid_wall, "ms_per_epoch": grid_ms,
                           "one_run_ms_per_epoch": one_ms,
                           "val_loss_max_abs_err": val_err,
                           "best_param_max_abs_err": param_err}
            print(f"phase 14a: sweep_classifiers over tune_parameter.sh's "
                  f"{len(TUNE_GRID)} (lr, dropout) points at "
                  f"{' '.join(map(str, CLASSIFIER_HIDDEN))}, "
                  f"{CLASSIFIER_EPOCHS} epochs: {grid_wall:.3f} s, "
                  f"{grid_ms:.4f} ms/epoch for the grid against "
                  + ", ".join(f"{m:.4f}" for m in one_ms)
                  + f" ms/epoch for each point alone; val loss max abs err "
                  f"{val_err:.3e}, best parameters max abs err "
                  f"{param_err:.3e} against each point's own run (bounds "
                  f"rtol 2e-3; rtol 5e-3 / atol 5e-5); no host sync in any "
                  f"epoch loop", flush=True)
    finally:
        classifier.run_epochs = loop
        os.chdir(cwd)
    return out


_FRESH_SCORER = """
import importlib.abc, importlib.machinery, io, json, sys, zipfile
PORT = 'multi_modal_normative_modeling_tpu_torch'
def blocked(name):
    parts = name.split('.')
    return parts[0] in ('jax', 'sklearn', 'multi_modal_normative_modeling_tpu'
                        ) or (parts[0] == PORT and len(parts) > 1 and
                              parts[1] in ('models', 'data', 'cli', 'infer'))
class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError('blocked: ' + spec.name)
    def exec_module(self, module):
        pass
class Block:
    def find_spec(self, name, path=None, target=None):
        return (importlib.machinery.ModuleSpec(name, Refuse())
                if blocked(name) else None)
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import multi_modal_normative_modeling_tpu_torch.kernels as kernels
with zipfile.ZipFile(sys.argv[2]) as z:
    meta = json.loads(z.read('meta.json'))
    program = torch.export.load(io.BytesIO(
        z.read(meta['programs']['cuda']['scoring']))).module()
inputs = [torch.from_numpy(np.load(p)).cuda() for p in sys.argv[3:]]
rows = inputs[0].shape[0]
eps = torch.stack([torch.randn((rows, meta['latent_dim']),
                               generator=torch.Generator().manual_seed(s))
                   for s in meta['seeds']]).cuda()
with torch.no_grad():
    devs = program(*inputs, eps)[0]
assert kernels.fused_encoder.launches > 0
assert not [m for m in sys.modules if blocked(m)]
print(json.dumps(devs.mean(dim=(0, 1)).tolist()))
"""


def run_export(root, stats):
    """Phase 14b: cli.export on phase 8's trained ensemble (cpu and cuda
    programs); the cuda program's mmnm nodes; requests of 1, 64 and 256
    subjects through ExportedScorer on the card against ScoringService on
    the same payload, K1 and K2 counted per call; the cpu program against
    it; a fresh process that imports torch and the port's kernels alone;
    p50 of the exported call against the service's, the device ms of one
    call's launches, and what the custom operator costs a call. Returns the
    launches by call."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import export, serve
    from multi_modal_normative_modeling_tpu_torch.kernels import mlp
    from multi_modal_normative_modeling_tpu_torch.models import Encoder

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.mmnm"
        t0 = time.perf_counter()
        meta = export.run(["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS),
                           "-o", str(path)], project_root=root)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = export.load_scorer(path)
        load_s = time.perf_counter() - t0
        cpu = export.load_scorer(path, device="cpu")
        graph = {}
        for kind, program in card.programs.items():
            nodes = [str(n.target) for n in program.graph.nodes]
            graph[kind] = {k: nodes.count(f"mmnm.{k}.default")
                           for k in ("fused_encoder", "fused_pred_deviation")}
        if graph != {"scoring": {"fused_encoder": len(DIMS),
                                 "fused_pred_deviation": len(DIMS)},
                     "latent": {"fused_encoder": len(DIMS),
                                "fused_pred_deviation": 0}}:
            raise RuntimeError(f"phase 14b: the cuda programs' mmnm nodes "
                               f"{graph}")
        print(f"phase 14b: cli.export -R ADNI -P UCA-gPoE -K {FOLDS} "
              f"(platforms {meta['platforms']}): {export_s:.3f} s, "
              f"{path.stat().st_size / 1e6:.2f} MB; cuda programs loaded in "
              f"{load_s:.3f} s, their graphs hold {graph}", flush=True)
        service = serve.ScoringService("ADNI", "UCA-gPoE", n_splits=FOLDS,
                                       project_root=root, device="cuda")
        ids = list(service._frames[0].index)
        launches, errs = {}, {}
        for size in SERVE_SIZES:
            rows = [f.loc[ids[:size]] for f in service._frames]
            features = {name: r[cols].to_numpy(np.float32) for name, r, cols
                        in zip(service.dataset_names, rows, service.columns)}
            payload = {"AGE": rows[-1]["AGE"].tolist(),
                       "PTGENDER": rows[-1]["PTGENDER"].tolist()}
            want = service.score_raw(features, payload, roi=True,
                                     latent=True)
            for name, flags in (("call", {}), ("latent_call",
                                               {"latent": True})):
                kernels.reset_launch_counts()
                got = card.score(features, payload, roi=True, **flags)
                torch.cuda.synchronize()
                launches[name] = launch_counts()
                expect = {"fused_encoder": len(DIMS) * (1 + bool(flags)),
                          "fused_pred_deviation": len(DIMS)}
                if launches[name] != expect:
                    raise RuntimeError(f"phase 14b: an exported {name} "
                                       f"launched {launches[name]}, expected "
                                       f"{expect}")
            on_cpu = cpu.score(features, payload, roi=True, latent=True)
            rel = 0.0
            for key in ("deviation", "roi", "latent_deviation",
                        "latent_per_dim"):
                g, w = np.asarray(got[key]), np.asarray(want[key])
                check_close(f"phase 14b: {size} subjects {key}",
                            torch.from_numpy(g), torch.from_numpy(w),
                            EXPORT_TOL)
                check_close(f"phase 14b: {size} subjects {key} (cpu program)",
                            torch.from_numpy(np.asarray(on_cpu[key])),
                            torch.from_numpy(w), EXPORT_CPU_TOL)
                rel = max(rel, float(np.max(np.abs(g - w) / np.maximum(
                    np.abs(w), 1e-30))))
            errs[size] = rel
            # latency: the exported call against the service's, 50 each
            for _ in range(3):
                card.score(features, payload)
                service.score_raw(features, payload)
            times = {}
            for name, fn in (("exported", card.score),
                             ("service", service.score_raw)):
                ms = []
                for _ in range(EXPORT_LATENCY_CALLS):
                    t0 = time.perf_counter()
                    fn(features, payload)
                    ms.append((time.perf_counter() - t0) * 1e3)
                times[name] = float(np.percentile(ms, 50))
            n = len(rows[-1])
            padded = -(-n // 64) * 64
            inputs = [torch.from_numpy(np.ascontiguousarray(np.pad(
                a, ((0, padded - n),) + ((0, 0),) * (a.ndim - 1)))).cuda()
                for a in (*features.values(),
                          np.asarray(payload["AGE"], np.float32),
                          np.asarray(payload["PTGENDER"], np.float32))]
            eps = torch.zeros(FOLDS, padded, LATENT, device="cuda")
            dev = device_ms(lambda: card._modules["scoring"](*inputs, eps))
            out[f"{size} subjects"] = {
                "exported_p50_ms": times["exported"],
                "service_p50_ms": times["service"],
                "call_device_ms": dev, "max_rel_err": rel}
            print(f"phase 14b: {size} subject(s) ({padded} padded rows): "
                  f"ExportedScorer on the card against ScoringService.score_"
                  f"raw on the same payload: max rel diff {rel:.3e} (bound "
                  f"rtol 1e-6), the cpu program within rtol 1e-4 / atol "
                  f"1e-5; launches a call {launches['call']}, a latent call "
                  f"{launches['latent_call']}; p50 over "
                  f"{EXPORT_LATENCY_CALLS} calls {times['exported']:.3f} ms "
                  f"exported, {times['service']:.3f} ms score_raw; device "
                  f"{dev:.4f} ms for one exported call's launches",
                  flush=True)
            if size == 64:
                paths = []
                for i, t in enumerate(inputs):
                    paths.append(str(Path(tmp) / f"in{i}.npy"))
                    np.save(paths[-1], t.cpu().numpy())
                t0 = time.perf_counter()
                fresh = subprocess.run(
                    [sys.executable, "-c", _FRESH_SCORER, str(ROOT),
                     str(path), *paths], capture_output=True, text=True,
                    timeout=300)
                fresh_s = time.perf_counter() - t0
                if fresh.returncode != 0:
                    raise RuntimeError(f"phase 14b: the fresh process failed:"
                                       f" {fresh.stderr[-3000:]}")
                standalone = json.loads(fresh.stdout.strip().splitlines()[-1])
                check_close("phase 14b: the fresh process's deviations",
                            torch.tensor(standalone[:n]),
                            torch.tensor(card.score(features,
                                                    payload)["deviation"]),
                            EXPORT_TOL)
                print(f"phase 14b: a fresh process importing torch and the "
                      f"port's kernels alone (models, data, cli, infer, jax "
                      f"refused) loaded the cuda program and scored 64 "
                      f"subjects in {fresh_s:.3f} s, equal to the scorer's",
                      flush=True)
        # what the custom operator costs a call: K1 through the dispatcher
        # against its launch code called directly, at a request's shape
        gen = torch.Generator().manual_seed(14)
        for d in (90, 270):
            enc = Encoder(d, HIDDEN, LATENT, C_DIM, folds=FOLDS,
                          generator=gen, device="cuda")
            x = torch.randn(FOLDS, 64, d, generator=gen).cuda()
            c = covariates(np.random.default_rng(14), FOLDS, 64)
            pairs = [*enc.hidden_layers(), enc.mu.pair(), enc.logvar.pair()]
            with torch.no_grad():
                via_op = cuda_ms(lambda: enc.fused(x, c), iters=200)
                direct = cuda_ms(lambda: mlp.launch(x, c, pairs, len(HIDDEN),
                                                    True), iters=200)
                via_op2 = cuda_ms(lambda: enc.fused(x, c), iters=200)
            out[f"K1 F={FOLDS} B=64 D={d}"] = {
                "op_ms": [via_op, via_op2], "launch_ms": direct}
            print(f"phase 14b: K1 at F={FOLDS} B=64 D={d}: {via_op:.4f} / "
                  f"{via_op2:.4f} ms a call through mmnm::fused_encoder, "
                  f"{direct:.4f} ms through its launch code directly (CUDA "
                  f"events over 200 calls)", flush=True)
        out["export_s"], out["fresh_process_s"] = export_s, fresh_s
    stats["export"] = out
    return launches


def run_report(root):
    """Phase 14c: cli.report on phase 8's project. Returns its sections and
    line count."""
    from multi_modal_normative_modeling_tpu_torch.cli import report

    out = root / "experiment_report.md"
    t0 = time.perf_counter()
    report.run(["-R", "ADNI", "-P", "UCA-gPoE", "--out", str(out)],
               project_root=root)
    wall = time.perf_counter() - t0
    lines = out.read_text().splitlines()
    sections = [line for line in lines if line.startswith("#")]
    for want in ("mean ROC-AUC", "Top deviating ROIs",
                 "result_multimodal.txt"):
        if not any(want in line for line in lines):
            raise RuntimeError(f"phase 14c: the report has no {want!r}: "
                               f"{sections}")
    if sum(line.startswith("### ") for line in lines) != len(DIMS):
        raise RuntimeError(f"phase 14c: ROI tables {sections}")
    print(f"phase 14c: cli.report on phase 8's project: {len(lines)} lines "
          f"in {wall:.3f} s; sections {sections}", flush=True)
    return {"lines": len(lines), "sections": sections, "wall_s": wall}


# ---- phase 15: the packed layouts (--packed_xla) ----------------------------

def captured_logs(run):
    """run() with common.emit_fold_artifacts recording the per-fold logs it
    is handed (the CLIs' losses, [epochs] per key per fold); returns them."""
    from multi_modal_normative_modeling_tpu_torch.cli import common

    seen = []
    real = common.emit_fold_artifacts

    def emit(model_dir, per_fold_logs, *args, **kwargs):
        seen.append([{k: np.asarray(v) for k, v in logs.items()}
                     for logs in per_fold_logs])
        return real(model_dir, per_fold_logs, *args, **kwargs)

    common.emit_fold_artifacts = emit
    try:
        run()
    finally:
        common.emit_fold_artifacts = real
    return seen[-1]


def hold_logs(what, got, want, tol):
    """Every fold's logged terms against another run's; returns the largest
    relative difference."""
    worst = 0.0
    for f, (a, b) in enumerate(zip(got, want)):
        if set(a) != set(b):
            raise RuntimeError(f"phase 15: {what}: log keys {sorted(a)} "
                               f"against {sorted(b)}")
        for k in b:
            if not np.isfinite(a[k]).all() or not np.allclose(
                    a[k], b[k], **tol):
                raise RuntimeError(f"phase 15: {what}: fold {f} log {k} "
                                   f"{a[k]} against {b[k]} over {tol}")
            worst = max(worst, float(np.max(np.abs(a[k] - b[k])
                                            / np.maximum(np.abs(b[k]),
                                                         1e-30))))
    return worst


def sign_noise_leaf(path):
    """The end-to-end classifier's leaves whose gradient is a rounded zero
    (a block's linear bias right before BatchNorm, and the running mean
    that carries it): Adam turns the rounding into steps of about lr in a
    direction the rounding picks, so two float orders part there
    (tests/test_torch_endtoend.py)."""
    return (("'blocks'" in path and path.endswith("['linear']['b']"))
            or (path.startswith("['bn_state']") and path.endswith("['mean']")))


def hold_checkpoints(what, got_root, want_root, tol, skip=None,
                     phase="phase 15"):
    """Two projects' fold checkpoints, leaf by leaf at ``tol`` (the leaves
    ``skip(path)`` picks aside); returns the largest absolute
    difference."""
    from multi_modal_normative_modeling_tpu_torch.interop import (
        read_flax_checkpoint,
    )

    got, want = fold_checkpoints(got_root), fold_checkpoints(want_root)
    if not got or [p.relative_to(got_root) for p in got] != [
            p.relative_to(want_root) for p in want]:
        raise RuntimeError(f"{phase}: {what}: checkpoints {got} {want}")
    worst = 0.0
    for x, y in zip(got, want):
        lx = dict(tree_leaves(read_flax_checkpoint(x.parent)[0]))
        ly = dict(tree_leaves(read_flax_checkpoint(y.parent)[0]))
        for k in ly:
            if skip is not None and skip(k):
                continue
            if not np.isfinite(lx[k]).all() or not np.allclose(
                    lx[k], ly[k], **tol):
                raise RuntimeError(
                    f"{phase}: {what}: {x.parent.name} {k}: max abs diff "
                    f"{np.abs(lx[k] - ly[k]).max():.3e} over {tol}")
            worst = max(worst, float(np.abs(lx[k] - ly[k]).max()))
    return worst


def hold_trained_scoring(root, rows, seed):
    """The test stage's scoring call (K1, then K2, once per modality for
    every fold) on the ensemble ``root`` trained, at the stage's rows,
    against the plain path evaluated in fp64 on the same eps, at phase 4's
    bound. Returns (max abs err, launches)."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import common

    model, _, config = common.load_model_and_params(
        [p.parent for p in fold_checkpoints(root)], device="cuda")
    dims, combine = config["input_dim_list"], config["combine"]
    rng = np.random.default_rng(seed)
    xes = [torch.from_numpy(rng.standard_normal(
        (FOLDS, rows, d), dtype=np.float32)).cuda() for d in dims]
    cs = [covariates(rng, FOLDS, rows)] * len(dims)
    eps = torch.randn((FOLDS, rows, model.latent_dim),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(xes, cs, combine, eps=eps)
    torch.cuda.synchronize()
    launches = launch_counts()
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ref = model64.pred_recon(fp64(*xes), fp64(*cs), combine,
                                 eps=eps.double())
    err = 0.0
    for m in range(len(dims)):
        dev64 = model64.reconstruction_deviation(xes[m].double(), ref[m])
        err = max(err, check_close(f"phase 15 modality {m} recon", recons[m],
                                   ref[m].float(), MODEL_TOL)[0],
                  check_close(f"phase 15 modality {m} deviation", devs[m],
                              dev64.float(), MODEL_TOL)[0])
    return err, launches


def expect_launches(what, got, want):
    if got != want:
        raise RuntimeError(f"phase 15: {what} launched {got}, expected "
                           f"{want}")


def run_packed_flagship(project, stats):
    """15a: the flagship cohort (UCA-gPoE, mixed widths: the width-grouped
    layout) with --packed_xla in fp32 and bf16 against the per-modality
    run; the test stage, the analysis and the score CLI on the packed-
    trained ensemble. Returns {stage: launches}."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        pipeline,
        score,
        train_supervised,
    )

    argv = PACKED_BASE + PACKED_H + PACKED_E + ["-P", "UCA-gPoE"]
    runs, logs, walls = {}, {}, {}
    for name, extra in (("per-modality", []), ("fp32", ["--packed_xla"]),
                        ("bf16", ["--packed_xla", "--precision", "bf16"])):
        runs[name] = project(f"flagship-{name}")
        t0 = time.perf_counter()
        logs[name] = captured_logs(lambda: train_supervised.run(
            argv + extra, project_root=runs[name]))
        walls[name] = time.perf_counter() - t0
    if not (runs["fp32"] / PACKED_MODEL_DIR / "000").exists():
        raise RuntimeError("phase 15a: no checkpoint of the packed run")
    log_err = hold_logs("15a fp32 against per-modality", logs["fp32"],
                        logs["per-modality"], PACKED_LOG_TOL)
    param_err = hold_checkpoints("15a fp32 against per-modality",
                                 runs["fp32"], runs["per-modality"],
                                 PACKED_PARAM_TOL)
    bf16_err = hold_logs("15a bf16 against fp32", logs["bf16"],
                         logs["fp32"], PACKED_BF16_TOL)
    launches = {}
    kernels.reset_launch_counts()
    stats_fp32 = pipeline.run(argv + ["--stages", "test"],
                              project_root=runs["fp32"])
    torch.cuda.synchronize()
    launches["test stage"] = launch_counts()
    expect_launches("15a: the test stage", launches["test stage"],
                    {"fused_encoder": len(DIMS),
                     "fused_pred_deviation": len(DIMS)})
    check_stage_rows(runs["fp32"], "phase 15a")
    stats_fp32 = pipeline.run(argv + ["--stages", "analyze"],
                              project_root=runs["fp32"])
    aucs = [float(a) for a in stats_fp32["auc"]]
    if len(aucs) != 3 or not all(np.isfinite(a) and 0.0 <= a <= 1.0
                                 for a in aucs):
        raise RuntimeError(f"phase 15a: AUCs {aucs}")
    err, launches["held"] = hold_trained_scoring(runs["fp32"], STAGE_ROWS,
                                                 seed=15)
    stats["packed_scoring_err"] = err
    ids = runs["fp32"] / "score_ids.csv"
    pd.read_csv(runs["fp32"] / "data" / "ADNI" / "y.csv")[["IID"]].to_csv(
        ids, index=False)
    kernels.reset_launch_counts()
    out = score.run(["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS),
                     "--ids", str(ids), "--output",
                     str(runs["fp32"] / "scores.csv")],
                    project_root=runs["fp32"])
    torch.cuda.synchronize()
    launches["score CLI"] = launch_counts()
    expect_launches("15a: the score CLI", launches["score CLI"],
                    {"fused_encoder": len(DIMS),
                     "fused_pred_deviation": len(DIMS)})
    values = out.select_dtypes("number").to_numpy()
    if len(out) != COHORT_SUBJECTS or not np.isfinite(values).all():
        raise RuntimeError(f"phase 15a: the score CLI wrote {out.shape}")
    print(f"phase 15a: {' '.join(argv)}: per-modality "
          f"{walls['per-modality']:.3f} s, --packed_xla (width-grouped) "
          f"{walls['fp32']:.3f} s, bf16 {walls['bf16']:.3f} s; fp32 logs "
          f"max rel diff {log_err:.3e} "
          f"(bound {PACKED_LOG_TOL}), params max abs diff {param_err:.3e} "
          f"(bound {PACKED_PARAM_TOL}); bf16 logs max rel diff from fp32 "
          f"{bf16_err:.3e} (bound {PACKED_BF16_TOL}); test stage launches "
          f"{launches['test stage']}, AUC {[round(a, 4) for a in aucs]}; "
          f"the scoring call on the packed-trained ensemble against fp64: "
          f"max abs err {err:.3e}, launches {launches['held']}; score CLI "
          f"launches {launches['score CLI']}, {len(out)} rows", flush=True)
    return runs["fp32"], launches


def run_packed_zoo(project):
    """15b: mmJSD and mvtCAE at SE-PoE (uniform widths: the padded layout)
    and DMVAE with a shared code (the split-latent layout), each against
    its per-modality run."""
    from multi_modal_normative_modeling_tpu_torch.cli import train_supervised

    for name, hz, layout in PACKED_ZOO:
        argv = (PACKED_BASE + ["-H"] + [str(h) for h in hz] + PACKED_E
                + ["-P", "SE-PoE", "-Model", name])
        roots, logs = {}, {}
        for run, extra in (("per-modality", []), ("packed", ["--packed_xla"])):
            roots[run] = project(f"zoo-{name}-{hz[-1]}-{run}")
            logs[run] = captured_logs(lambda: train_supervised.run(
                argv + extra, project_root=roots[run]))
        log_err = hold_logs(f"15b {name}", logs["packed"],
                            logs["per-modality"], PACKED_LOG_TOL)
        param_err = hold_checkpoints(f"15b {name}", roots["packed"],
                                     roots["per-modality"], PACKED_PARAM_TOL)
        print(f"phase 15b: {name} -H {' '.join(map(str, hz))} ({layout} "
              f"layout), {PACKED_EPOCHS} epochs: logs max rel diff "
              f"{log_err:.3e}, params max abs diff {param_err:.3e} from the "
              f"per-modality run", flush=True)


def run_packed_variants(tmp, project):
    """15c: nm-PM-cont, nm-MLP and the shuffled regression with
    --packed_xla against their per-modality runs, their scoring launches;
    one commands_list11_adhd.sh point of the supervised sweep."""
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        nmmlp,
        nmpmcont,
        regression,
        sweep_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    modules = {"nmpmcont": nmpmcont, "nmmlp": nmmlp,
               "regression": regression}
    launches = {}
    for name, flags in PACKED_VARIANTS:
        roots = {}
        for run, extra in (("per-modality", []), ("packed", ["--packed_xla"])):
            roots[run] = project(f"{name}-{run}")
            args = modules[name].build_parser().parse_args(flags + extra)
            if name == "nmpmcont":
                common.apply_post_parse_defaults(args, "SE-MoE")
            kernels.reset_launch_counts()
            timings = {}
            if name == "regression":
                regression.train_and_test(args, roots[run], timings=timings)
            else:
                modules[name].main(args, roots[run], timings=timings)
            torch.cuda.synchronize()
            counts = launch_counts()
        launches[name] = counts
        expect_launches(f"15c: {name} --packed_xla", counts,
                        with_adam(VARIANT_LAUNCHES[name],
                                  timings["train_steps"]))
        # nm-MLP at the skeleton's bound, nm-PM-cont and the regression at
        # their JAX tests'
        tol = PACKED_PARAM_TOL if name == "nmmlp" else PACKED_VARIANT_TOL
        if name == "regression":
            out = [r / "regression_outputs" for r in
                   (roots["packed"], roots["per-modality"])]
            diff = 0.0
            for f in range(FOLDS):
                a, b = (np.load(o / f"fold_{f}_pred.npy") for o in out)
                if not np.allclose(a, b, **tol):
                    raise RuntimeError(f"phase 15c: regression fold {f} FI "
                                       f"max abs diff {np.abs(a - b).max()}")
                diff = max(diff, float(np.abs(a - b).max()))
        else:
            diff = hold_checkpoints(
                f"15c {name}", roots["packed"], roots["per-modality"], tol,
                skip=sign_noise_leaf if name == "nmpmcont" else None)
        print(f"phase 15c: {name} {' '.join(flags)} --packed_xla: "
              f"{'FI' if name == 'regression' else 'params'} max abs diff "
              f"{diff:.3e} from the per-modality run (bound {tol}); "
              f"scoring launches {counts}", flush=True)

    make_synthetic_resource(tmp / "adhd", "ADHD", **ADHD_COHORT)
    records, roots, adam = {}, {}, {}
    for run, extra in (("per-modality", []), ("packed", ["--packed_xla"])):
        root = roots[run] = tmp / f"sweep-{run}"
        shutil.copytree(tmp / "adhd" / "data", root / "data")
        kernels.reset_launch_counts()
        records[run] = sweep_supervised.run(PACKED_SWEEP + extra,
                                            project_root=root)
        torch.cuda.synchronize()
        counts = launch_counts()
        adam[run] = counts.get("masked_adam", 0)
    launches["sweep"] = counts
    # the point's one training run: K7 once a step, the same steps in both
    # layouts, whole epochs of them
    if (adam["packed"] != adam["per-modality"] or not adam["packed"]
            or adam["packed"] % PACKED_EPOCHS):
        raise RuntimeError(f"phase 15: the sweep point launched masked_adam "
                           f"{adam}, expected the same whole epochs in both")
    expect_launches("15c: the sweep point", counts,
                    with_adam({"fused_encoder": 2, "fused_pred_deviation": 2},
                              adam["packed"]))
    diff = hold_checkpoints("15c sweep point", roots["packed"],
                            roots["per-modality"], PACKED_PARAM_TOL)
    a, b = records["packed"][0]["stats"], records["per-modality"][0]["stats"]
    print(f"phase 15c: sweep_supervised {' '.join(PACKED_SWEEP)} "
          f"--packed_xla: params max abs diff {diff:.3e} from the "
          f"per-modality grid, AUC {a['auc']} (per-modality {b['auc']}); "
          f"test stage launches {counts}", flush=True)
    return launches


def run_packed_resume(project, straight):
    """15d: 15a's fp32 packed run killed after epoch 4 of 10 and resumed in
    a fresh main: its checkpoints byte-equal to the straight run's."""
    from multi_modal_normative_modeling_tpu_torch.cli import train_supervised

    argv = PACKED_BASE + PACKED_H + ["-P", "UCA-gPoE", "--packed_xla",
                                     "--checkpoint_every", "1"]
    root = project("flagship-resumed")
    train_supervised.run(argv + ["-E", "4"], project_root=root)
    train_supervised.run(argv + ["-E", str(PACKED_EPOCHS), "--resume"],
                         project_root=root)
    state = root / PACKED_MODEL_DIR / "grouped-state" / "train_state.json"
    if json.loads(state.read_text()) != {"epoch": PACKED_EPOCHS}:
        raise RuntimeError(f"phase 15d: {state.read_text()}")
    dist = checkpoint_distance(straight, root)
    if dist != 0.0:
        raise RuntimeError(f"phase 15d: the resumed run's checkpoints are "
                           f"{dist:.3e} from the straight run's")
    print(f"phase 15d: --packed_xla --checkpoint_every 1, killed after "
          f"epoch 4 of {PACKED_EPOCHS} and resumed in a fresh main: fold "
          f"checkpoints byte-equal to the straight run's", flush=True)


def profile_kernels(run, steps):
    """(device kernels, their device ms) per step of run() under
    torch.profiler; (None, None) when the trace holds no device rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        return None, None
    busy_ms = sum(e.time_range.elapsed_us() for e in rows) / 1e3
    return len(rows) / steps, busy_ms / steps


def time_packed(stats):
    """15e: ms per step of the per-modality and the packed trainer, in
    turns in this process, at the flagship (bench.py:29-36: 5 folds x 512
    seeded subjects, batch 256) and at PPMI width (bench.py:45-47: 3 x
    3485, one fold of 2560); each run 20 steps ending in the logs' fetch;
    kernels per step from torch.profiler."""
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.grouped import (
        select_packed_trainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
    )

    out = {}
    for cell, dims, rows_per_fold in PACKED_TIMING:
        rng = np.random.default_rng(15)
        data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
                for n in rows_per_fold]
        cov = [[one_hot_covariates(rng, n)] * len(dims)
               for n in rows_per_fold]
        host = stack_fold_batches(data, cov, BATCH)
        nb = host["mask"].shape[1]
        epochs = PACKED_TIMED_STEPS // nb
        config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE)
        model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                            len(dims), folds=len(rows_per_fold),
                            generator=torch.Generator().manual_seed(15),
                            device="cuda")
        packed_cls, layout, _ = select_packed_trainer(model)
        plain = MultiFoldTrainer(model, config, max(rows_per_fold))
        trainers = {"per-modality": (plain, DeviceBatches(host, "cuda"))}
        packed = packed_cls(model, config, max(rows_per_fold))
        trainers["packed"] = (packed, packed.prepare_batches(host))
        times = {k: [] for k in trainers}
        for i in range(PACKED_TIMED_RUNS + 1):
            for k, (trainer, batches) in trainers.items():
                # a session packs (and its end unpacks) outside the clock
                session = trainer.session(batches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                session.advance(epochs)   # ends in the logs' fetch
                if i:   # the first turn warms up
                    times[k].append((time.perf_counter() - t0) * 1e3
                                    / (epochs * nb))
        per_step, busy = {}, {}
        for k, (trainer, batches) in trainers.items():
            session = trainer.session(batches)
            per_step[k], busy[k] = profile_kernels(
                lambda: session.advance(epochs), epochs * nb)
        out[cell] = {k: {"median_ms": float(np.median(v)),
                         "min_ms": float(np.min(v)),
                         "max_ms": float(np.max(v)), "runs": len(v),
                         "kernels_per_step": per_step[k],
                         "device_busy_ms_per_step": busy[k]}
                     for k, v in times.items()}
        out[cell]["layout"] = layout
        print(f"phase 15e: {cell}: {len(rows_per_fold)} folds x "
              f"{rows_per_fold} subjects, widths {dims}, batch {BATCH}, "
              f"{epochs * nb} steps a run, {PACKED_TIMED_RUNS} runs each in "
              f"turns: per-modality median "
              f"{out[cell]['per-modality']['median_ms']:.4f} ms/step "
              f"[{out[cell]['per-modality']['min_ms']:.4f}, "
              f"{out[cell]['per-modality']['max_ms']:.4f}], "
              f"{per_step['per-modality']} kernels/step, device busy "
              f"{busy['per-modality']} ms/step; {layout} median "
              f"{out[cell]['packed']['median_ms']:.4f} ms/step "
              f"[{out[cell]['packed']['min_ms']:.4f}, "
              f"{out[cell]['packed']['max_ms']:.4f}], "
              f"{per_step['packed']} kernels/step, device busy "
              f"{busy['packed']} ms/step", flush=True)
    stats["packed_timing"] = out
    return out


def run_packed(stats):
    """Phase 15: --packed_xla on every CLI that takes it, on the card."""
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_resource(tmp / "cohort", "ADNI",
                                with_early_fusion=True, with_fi=True,
                                **CHAIN_COHORT)

        def project(name):
            root = tmp / name
            shutil.copytree(tmp / "cohort" / "data", root / "data")
            return root

        t0 = time.perf_counter()
        straight, launches["flagship"] = run_packed_flagship(project, stats)
        t1 = time.perf_counter()
        run_packed_zoo(project)
        t2 = time.perf_counter()
        variant_launches = run_packed_variants(tmp, project)
        t3 = time.perf_counter()
        run_packed_resume(project, straight)
        t4 = time.perf_counter()
    timing = time_packed(stats)
    print(f"phase 15: 15a {t1 - t0:.1f} s, 15b {t2 - t1:.1f} s, 15c "
          f"{t3 - t2:.1f} s, 15d {t4 - t3:.1f} s, 15e "
          f"{time.perf_counter() - t4:.1f} s", flush=True)
    print(json.dumps({"packed_timing": timing}), flush=True)
    return {**{f"flagship {k}": v for k, v in launches["flagship"].items()},
            **variant_launches}


# ---- phase 16: streamed training, remat and bf16, profiling, doctor, facade

# 16a: PPMI width (bench.py:45-47: 3 x 3485, one fold of 2560, batch 256,
# NB 10) and the flagship (bench.py:29-36) against the resident trainer
STREAM_EPOCHS = 3
STREAM_SHARDS = (1, 3, 10, 16)
STREAM_FUSED_SHARDS = 3
STREAM_FLAGSHIP_SHARDS = 2
PPMI_N = 2560
# 16b: a cohort whose features are gigabytes, one fold, one epoch
BIG_SUBJECTS = 100_000
BIG_SHARDS = 8
BIG_SLACK = 256 * 2**20
# 16c: the train CLI on phase 8's cohort
STREAM_CLI = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS)]
STREAM_CLI_EPOCHS, STREAM_CLI_KILLED, STREAM_CLI_EVERY = 10, 4, 2
# 16d: the profiled run
PROFILE_EPOCHS, PROFILE_SHARDS = 2, 3
# 16e: --remat and bf16 at PPMI width
PRECISION_EPOCHS = 10
# 16g: the facade's reference loop
FACADE_EPOCHS, FACADE_ROWS = 5, 512


def stream_cohort(dims, rows_per_fold, seed):
    """Seeded stacked batches (numpy) of ``rows_per_fold`` subjects a fold
    at ``dims``, one-hot covariates."""
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        stack_fold_batches,
    )

    rng = np.random.default_rng(seed)
    data = [[rng.standard_normal((n, d), dtype=np.float32) for d in dims]
            for n in rows_per_fold]
    cov = [[one_hot_covariates(rng, n)] * len(dims) for n in rows_per_fold]
    return stack_fold_batches(data, cov, BATCH)


def stream_trainer(dims, folds, max_n, seed, epochs, shards=None,
                   fused=False, mesh=None, **config):
    """A seeded model on the card and its trainer: resident
    (MultiFoldTrainer) without ``shards``, else StreamingFoldTrainer; the
    --fused_decoder loss (K4) with ``fused``; on ``mesh``'s ranks with a
    mesh. Both draw FoldNoise's seeded generators, so runs of one seed see
    the same noise."""
    from multi_modal_normative_modeling_tpu_torch.kernels.decoder_nll import (
        fused_decoder_loss_fn,
    )
    from multi_modal_normative_modeling_tpu_torch.models import build_model
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.streaming import (
        StreamingFoldTrainer,
    )

    model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    cfg = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE,
                      **config)
    loss = fused_decoder_loss_fn(model, cfg) if fused else None
    if shards is None:
        return model, MultiFoldTrainer(model, cfg, max_n, loss_fn=loss,
                                       mesh=mesh)
    return model, StreamingFoldTrainer(model, cfg, max_n, shards=shards,
                                       loss_fn=loss, mesh=mesh)


def timed_run(trainer, batches):
    """(logs, ms per step) of trainer.run(batches), which ends in a fetch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = trainer.run(batches)
    steps = trainer.config.epochs * (batches.n_batches if hasattr(
        batches, "n_batches") else batches["mask"].shape[1])
    return logs, (time.perf_counter() - t0) * 1e3 / steps


def hold_equal_runs(what, got, want):
    """Two (model, logs) runs bit for bit: every log and parameter
    torch.equal."""
    (m_got, l_got), (m_want, l_want) = got, want
    for k in l_want:
        if not np.array_equal(l_got[k], l_want[k]):
            raise RuntimeError(f"phase 16: {what}: log {k} differs, max "
                               f"{np.abs(l_got[k] - l_want[k]).max():.3e}")
    for (k, a), b in zip(m_got.state_dict().items(),
                         m_want.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"phase 16: {what}: parameter {k} differs, "
                               f"max {(a - b).abs().max().item():.3e}")


def run_stream_equality(launches):
    """16a: the streamed trainer against the resident one, bit for bit."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    ppmi = stream_cohort(PPMI_DIMS, [PPMI_N], seed=160)
    nb = ppmi["mask"].shape[1]
    model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 161, STREAM_EPOCHS)
    want = (model, trainer.run(ppmi))
    for shards in STREAM_SHARDS:
        model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 161,
                                        STREAM_EPOCHS, shards=shards)
        hold_equal_runs(f"PPMI S={shards}", (model, trainer.run(ppmi)), want)
    model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 161, STREAM_EPOCHS,
                                    fused=True)
    want_k4 = (model, trainer.run(ppmi))
    model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 161, STREAM_EPOCHS,
                                    shards=STREAM_FUSED_SHARDS, fused=True)
    kernels.reset_launch_counts()
    got = (model, trainer.run(ppmi))
    torch.cuda.synchronize()
    launches["16a streamed K4"] = counts = launch_counts()
    pairs = len(PPMI_DIMS) * STREAM_EPOCHS * nb
    want = with_adam({"decoder_nll": 2 * pairs}, STREAM_EPOCHS * nb)
    if counts != want:
        raise RuntimeError(f"phase 16a: the streamed --fused_decoder run "
                           f"launched {counts}, expected {want}")
    hold_equal_runs(f"PPMI S={STREAM_FUSED_SHARDS} --fused_decoder", got,
                    want_k4)
    flagship = stream_cohort(DIMS, TRAIN_ROWS, seed=162)
    model, trainer = stream_trainer(DIMS, FOLDS, max(TRAIN_ROWS), 163,
                                    STREAM_EPOCHS)
    want = (model, trainer.run(flagship))
    model, trainer = stream_trainer(DIMS, FOLDS, max(TRAIN_ROWS), 163,
                                    STREAM_EPOCHS,
                                    shards=STREAM_FLAGSHIP_SHARDS)
    hold_equal_runs("flagship", (model, trainer.run(flagship)), want)
    print(f"phase 16a: PPMI width {PPMI_DIMS}, 1 fold x {PPMI_N}, batch "
          f"{BATCH} ({nb} batches), {STREAM_EPOCHS} epochs: the streamed "
          f"trainer at S = {', '.join(map(str, STREAM_SHARDS))} (16 clamped "
          f"to {nb}) bit-equal to the resident one (logs and parameters "
          f"torch.equal); --fused_decoder at S = {STREAM_FUSED_SHARDS} "
          f"bit-equal, launches {counts} ({pairs} pairs); flagship "
          f"{DIMS}, {FOLDS} folds x {TRAIN_ROWS} at S = "
          f"{STREAM_FLAGSHIP_SHARDS} bit-equal", flush=True)


def upload_rate(streamed):
    """GB/s of one shard's pinned-to-device copies on a side stream, timed
    by CUDA events."""
    host = streamed._host[0]
    dst = {k: torch.empty(v.shape, device="cuda") for k, v in host.items()}
    side = torch.cuda.Stream()
    rates = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record()
            for k, v in host.items():
                dst[k].copy_(v, non_blocking=True)
            end.record()
        end.synchronize()
        nbytes = sum(v.numel() * 4 for v in host.values())
        rates.append(nbytes / (start.elapsed_time(end) * 1e6))
    return max(rates), nbytes


def run_out_of_core(stats):
    """16b: one epoch over a cohort of gigabytes, resident and streamed."""
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train.streaming import (
        StreamedBatches,
    )
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        DeviceBatches,
    )

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(164)
    data = [torch.randn((BIG_SUBJECTS, d), generator=gen,
                        device="cuda").cpu().numpy() for d in PPMI_DIMS]
    cov = one_hot_covariates(np.random.default_rng(165), BIG_SUBJECTS)
    batches = stack_fold_batches([data], [[cov] * len(PPMI_DIMS)], BATCH)
    del data
    feature_bytes = BIG_SUBJECTS * sum(PPMI_DIMS) * 4
    made = time.perf_counter() - t0
    # resident, streamed, streamed, resident: the epoch walls in turns
    runs = {"resident": [], "streamed": []}
    first = {}
    for name in ("resident", "streamed", "streamed", "resident"):
        shards = BIG_SHARDS if name == "streamed" else None
        model, trainer = stream_trainer(PPMI_DIMS, 1, BIG_SUBJECTS, 166, 1,
                                        shards=shards, fused=True)
        param_bytes = sum(p.numel() * 4 for p in model.parameters())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        if shards is None:
            prepared = DeviceBatches(batches, "cuda")
        else:
            prepared = StreamedBatches(batches, shards, "cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t1
        logs, ms = timed_run(trainer, prepared)
        # the model's parameters and MaskedAdam's flat buffer and moments
        peak = torch.cuda.max_memory_allocated() - base - 2 * param_bytes
        if not all(np.isfinite(v).all() for v in logs.values()):
            raise RuntimeError(f"phase 16b: {name}: non-finite logs")
        runs[name].append(dict(ms=ms, setup_s=setup_s, peak=peak,
                               epoch_s=ms * prepared.n_batches / 1e3))
        if name not in first:
            first[name] = (model, logs, prepared if shards else None)
        del prepared
    hold_equal_runs("16b streamed", first["streamed"][:2],
                    first["resident"][:2])
    streamed = first["streamed"][2]
    peaks = {name: max(r["peak"] for r in rs) for name, rs in runs.items()}
    limit = 2 * feature_bytes / BIG_SHARDS + BIG_SLACK
    if peaks["streamed"] > limit:
        raise RuntimeError(f"phase 16b: the streamed run's peak batch bytes "
                           f"{peaks['streamed']} exceed {limit:.0f}")
    gbs, shard_bytes = upload_rate(streamed)
    epochs = {name: [r["epoch_s"] for r in rs] for name, rs in runs.items()}
    ratio = sum(epochs["streamed"]) / sum(epochs["resident"])
    out = {name: {"peak_batch_bytes": peaks[name], "epoch_s": epochs[name],
                  "ms_per_step": [r["ms"] for r in rs],
                  "setup_s": [r["setup_s"] for r in rs]}
           for name, rs in runs.items()}
    out.update(feature_bytes=feature_bytes, shards=BIG_SHARDS,
               uploads=streamed.uploads, upload_bytes=streamed.upload_bytes,
               upload_gb_s=gbs, shard_bytes=shard_bytes,
               epoch_ratio=ratio, cohort_s=made)
    stats["decoder_nll"]["out_of_core"] = out

    def walls(name):
        return ", ".join(f"{r['epoch_s']:.3f} s ({r['ms']:.4f} ms/step)"
                         for r in runs[name])

    print(f"phase 16b: {BIG_SUBJECTS} subjects x {PPMI_DIMS} fp32 "
          f"({feature_bytes / 1e9:.3f} GB of features), 1 fold, C "
          f"{C_DIM}, one epoch of {streamed.n_batches} steps, "
          f"--fused_decoder: streamed S={BIG_SHARDS} parameters torch.equal "
          f"to the resident run's; peak batch bytes resident "
          f"{peaks['resident'] / 1e9:.4f} GB, streamed "
          f"{peaks['streamed'] / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB); "
          f"in turns resident, streamed, streamed, resident: epochs resident "
          f"{walls('resident')} (upload "
          f"{max(r['setup_s'] for r in runs['resident']):.2f} s before "
          f"each at most), streamed {walls('streamed')} (pinning "
          f"{max(r['setup_s'] for r in runs['streamed']):.2f} s before each "
          f"at most), ratio of the sums {ratio:.4f}; {streamed.uploads} "
          f"shard uploads, {streamed.upload_bytes / 1e9:.3f} GB; one shard "
          f"({shard_bytes / 1e9:.4f} GB) uploads at {gbs:.2f} GB/s; cohort "
          f"made in {made:.1f} s", flush=True)
    return out


def run_stream_cli(launches):
    """16c: --stream_shards through the train CLI on phase 8's cohort:
    byte-equal to the resident run, resumed across the two paths, the test
    stage's launches, the auto shard count."""
    import contextlib
    import io

    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        test_supervised,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_resource(tmp / "cohort", "ADNI",
                                with_early_fusion=True, **CHAIN_COHORT)

        def project(name):
            root = tmp / name
            shutil.copytree(tmp / "cohort" / "data", root / "data")
            return root

        k4 = STREAM_CLI + ["--fused_decoder"]
        every = ["--checkpoint_every", str(STREAM_CLI_EVERY)]
        full = ["-E", str(STREAM_CLI_EPOCHS)]
        killed = ["-E", str(STREAM_CLI_KILLED)]
        stream = ["--stream_shards", "2"]
        roots = {k: project(k) for k in ("resident", "streamed",
                                         "resident_then_streamed",
                                         "streamed_then_resident", "auto")}
        train_supervised.run(k4 + full, project_root=roots["resident"])
        train_supervised.run(k4 + full + stream,
                             project_root=roots["streamed"])
        train_supervised.run(k4 + killed + every,
                             project_root=roots["resident_then_streamed"])
        train_supervised.run(k4 + full + every + stream + ["--resume"],
                             project_root=roots["resident_then_streamed"])
        train_supervised.run(k4 + killed + every + stream,
                             project_root=roots["streamed_then_resident"])
        train_supervised.run(k4 + full + every + ["--resume"],
                             project_root=roots["streamed_then_resident"])
        for name in ("streamed", "resident_then_streamed",
                     "streamed_then_resident"):
            dist = checkpoint_distance(roots["resident"], roots[name])
            if dist != 0.0:
                raise RuntimeError(f"phase 16c: {name}: fold checkpoints "
                                   f"{dist:.3e} from the resident run's")
        kernels.reset_launch_counts()
        test_supervised.run(STREAM_CLI, project_root=roots["streamed"])
        torch.cuda.synchronize()
        launches["16c test stage"] = counts = launch_counts()
        want = {"fused_encoder": 4, "fused_pred_deviation": 4}
        if counts != want:
            raise RuntimeError(f"phase 16c: the test stage launched "
                               f"{counts}, expected {want}")
        trace_dir = tmp / "trace"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_supervised.run(STREAM_CLI + ["-E", "2", "--stream_shards",
                                               "-1", "--profile_dir",
                                               str(trace_dir)],
                                 project_root=roots["auto"])
        auto = [line for line in out.getvalue().splitlines()
                if line.startswith("--stream_shards auto:")]
        traces = list(trace_dir.glob("*.json"))
        if len(auto) != 1 or len(traces) != 1:
            raise RuntimeError(f"phase 16c: --stream_shards -1 printed "
                               f"{auto}, --profile_dir wrote {traces}")
        kinds = trace_kinds(traces[0])
        if not kinds.get("kernel"):
            raise RuntimeError(f"phase 16c: the CLI's trace holds no device "
                               f"kernels: {kinds}")
    print(f"phase 16c: the train CLI on phase 8's cohort ({' '.join(k4)}, "
          f"-E {STREAM_CLI_EPOCHS}): --stream_shards 2 fold checkpoints "
          f"byte-equal to the resident run's; killed at epoch "
          f"{STREAM_CLI_KILLED} (--checkpoint_every {STREAM_CLI_EVERY}) on "
          f"one path and resumed on the other, both ways byte-equal; the "
          f"test stage of the streamed checkpoints launched {counts}; "
          f"{auto[0]}; --profile_dir wrote {traces[0].name} "
          f"({kinds})", flush=True)


def trace_kinds(path):
    """{event category: count} of a Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kinds = {}
    for e in events:
        kinds[e.get("cat", "")] = kinds.get(e.get("cat", ""), 0) + 1
    return {k: v for k, v in kinds.items() if k in ("kernel", "gpu_memcpy")}


def run_stream_profile(stats):
    """16d: a streamed --fused_decoder run under utils.profiling.trace (what
    --profile_dir wraps a run in): K4's kernels in the trace, the shards'
    host-to-device copies on another stream than the kernels', and at
    least one of them overlapping a kernel."""
    from multi_modal_normative_modeling_tpu_torch.utils.profiling import trace

    ppmi = stream_cohort(PPMI_DIMS, [PPMI_N], seed=167)
    model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 168,
                                    PROFILE_EPOCHS, shards=PROFILE_SHARDS,
                                    fused=True)
    streamed = trainer.streamed(ppmi)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, cuda=True):
            trainer.run(streamed)
        events = json.loads(Path(trace.last).read_text())["traceEvents"]
        size = Path(trace.last).stat().st_size
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    copies = [e for e in spans if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    totals = {}
    for e in kernels:
        totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"]
    named = {k: sum(v for n, v in totals.items() if k in n)
             for k in ("nll_fwd_kernel", "nll_bwd_kernel")}
    if not all(named.values()):
        raise RuntimeError(f"phase 16d: the trace names no {named} "
                           f"({len(kernels)} kernels, {len(events)} events)")
    k4_streams = {e["args"].get("stream") for e in kernels
                  if "nll_" in e["name"]}
    side = [e for e in copies if e["args"].get("stream") not in k4_streams]
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels
                  if e["args"].get("stream") in k4_streams)
    overlap_us, overlapping = 0.0, 0
    for c in side:
        lo, hi = c["ts"], c["ts"] + c["dur"]
        covered = sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in busy
                      if a < hi and b > lo)
        if covered > 0:
            overlapping += 1
            overlap_us += covered
    if not side or not overlapping:
        raise RuntimeError(f"phase 16d: {len(copies)} host-to-device copies, "
                           f"{len(side)} on a stream other than the "
                           f"kernels' {k4_streams}, {overlapping} overlapping "
                           "a kernel: the uploads do not overlap the compute")
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:6]
    kernel_ms = sum(totals.values()) / 1e3
    stats["decoder_nll"]["profile"] = {
        "kernel_ms": kernel_ms, "copies": len(copies),
        "side_copies": len(side), "overlapping": overlapping,
        "overlap_ms": overlap_us / 1e3,
        "copy_ms": sum(c["dur"] for c in side) / 1e3}
    print(f"phase 16d: utils.profiling.trace of {PROFILE_EPOCHS} epochs at "
          f"PPMI width, S={PROFILE_SHARDS}, --fused_decoder ({size} bytes): "
          f"{len(kernels)} kernels, {kernel_ms:.3f} ms of them; "
          f"nll_fwd_kernel {named['nll_fwd_kernel'] / 1e3:.3f} ms, "
          f"nll_bwd_kernel {named['nll_bwd_kernel'] / 1e3:.3f} ms; top "
          + ", ".join(f"{n[:40]} {v / 1e3:.3f} ms" for n, v in top)
          + f"; {len(copies)} host-to-device copies, {len(side)} on a side "
          f"stream ({sum(c['dur'] for c in side) / 1e3:.3f} ms), "
          f"{overlapping} of them overlapping the kernels' stream for "
          f"{overlap_us / 1e3:.3f} ms", flush=True)


def run_remat_bf16(launches):
    """16e: --remat bit-equal to the plain run, bf16 within rtol 2e-2 of
    fp32, at PPMI width; each trained model's scoring call through K1 and
    K2."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    ppmi = stream_cohort(PPMI_DIMS, [PPMI_N], seed=169)
    rng = np.random.default_rng(170)
    xes = [torch.from_numpy(rng.standard_normal((1, BATCH, d),
                                                dtype=np.float32)).cuda()
           for d in PPMI_DIMS]
    cs = [covariates(rng, 1, BATCH)] * len(PPMI_DIMS)
    eps = torch.randn((1, BATCH, LATENT),
                      generator=torch.Generator().manual_seed(171)).cuda()
    runs = {}
    for name, config in (("fp32", {}), ("remat", {"remat": True}),
                         ("bf16", {"precision": "bf16"})):
        model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 172,
                                        PRECISION_EPOCHS, **config)
        logs, ms = timed_run(trainer, ppmi)
        kernels.reset_launch_counts()
        recons, devs = model.pred_recon_fused(xes, cs, COMBINE, eps=eps)
        torch.cuda.synchronize()
        launches[f"16e {name} scoring"] = counts = launch_counts()
        want = {"fused_encoder": 3, "fused_pred_deviation": 3}
        if counts != want:
            raise RuntimeError(f"phase 16e: {name}: the scoring call "
                               f"launched {counts}, expected {want}")
        with torch.no_grad():
            ref = model.pred_recon(xes, cs, COMBINE, eps=eps)
        for m in range(len(PPMI_DIMS)):
            check_close(f"16e {name} recon {m}", recons[m], ref[m],
                        MODEL_TOL)
        runs[name] = (model, logs, ms)
    hold_equal_runs("--remat", runs["remat"][:2], runs["fp32"][:2])
    for k in runs["fp32"][1]:
        check_close(f"16e bf16 log {k}", torch.from_numpy(runs["bf16"][1][k]),
                    torch.from_numpy(runs["fp32"][1][k]), PACKED_BF16_TOL)
    worst = max(float(np.max(np.abs(runs["bf16"][1][k] - runs["fp32"][1][k])
                             / np.abs(runs["fp32"][1][k])))
                for k in runs["fp32"][1])
    timing = {name: r[2] for name, r in runs.items()}
    stats_line = {"ms_per_step": timing, "bf16_max_rel": worst}
    print(f"phase 16e: PPMI width, 1 fold x {PPMI_N}, {PRECISION_EPOCHS} "
          f"epochs, plain loss: --remat bit-equal to the plain run; bf16 "
          f"logs within {worst:.3e} (rel) of fp32 (bound "
          f"{PACKED_BF16_TOL['rtol']}); ms per step fp32 "
          f"{timing['fp32']:.4f}, remat {timing['remat']:.4f} "
          f"({timing['remat'] / timing['fp32']:.3f}x), bf16 "
          f"{timing['bf16']:.4f} ({timing['bf16'] / timing['fp32']:.3f}x); "
          f"each trained model's scoring call launched K1 3 and K2 3",
          flush=True)
    return stats_line


def run_doctor():
    """16f: the doctor on the card: exit 0, every section OK, kernel-build
    naming sm_90a and nvcc's release."""
    import contextlib
    import io

    from multi_modal_normative_modeling_tpu_torch.cli import doctor

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = doctor.run(["--json"])
    results = json.loads(out.getvalue())
    bad = [r for r in results if r["status"] != "OK"]
    build = [r["detail"] for r in results if r["section"] == "kernel-build"]
    if rc != 0 or bad or len(build) != 1 or "sm_90a" not in build[0] \
            or "release" not in build[0]:
        raise RuntimeError(f"phase 16f: doctor exit {rc}: {results}")
    print(f"phase 16f: doctor --json exit 0, sections "
          f"{[r['section'] for r in results]} all OK; kernel-build: "
          f"{build[0]}", flush=True)


def run_facade():
    """16g: the reference's hot loop verbatim on the card through the
    imperative facade, then torch.save / torch.load."""
    import io

    from torch.utils.data import DataLoader, TensorDataset

    from multi_modal_normative_modeling_tpu_torch import compat

    rng = np.random.default_rng(173)
    xes = [rng.standard_normal((FACADE_ROWS, d), dtype=np.float32)
           for d in DIMS]
    cov = one_hot_covariates(rng, FACADE_ROWS)
    loaders = [DataLoader(TensorDataset(torch.from_numpy(x),
                                        torch.from_numpy(cov)),
                          batch_size=BATCH, shuffle=False) for x in xes]
    model = compat.cVAE_multimodal(
        input_dim_list=DIMS, hidden_dim=HIDDEN, latent_dim=LATENT,
        c_dim=C_DIM, learning_rate=0.0001, modalities=len(DIMS),
        non_linear=True).to(compat.DEVICE)
    t0 = time.perf_counter()
    losses = []
    for epoch in range(FACADE_EPOCHS):
        for batch_idx, batch in enumerate(zip(*loaders)):
            x_list = [b[0].to(compat.DEVICE) for b in batch]
            c_list = [b[1].to(compat.DEVICE) for b in batch]
            fwd = model.forward_multimodal(x_list, c_list, "gPoE")
            loss = model.loss_function_multimodal(x_list, fwd)
            model.optimizer1.lr = 0.5   # the reference's dead write (Q1)
            model.optimizer1.zero_grad()
            loss["total"].backward()
            model.optimizer1.step()
            losses.append(loss["total"].item())
    wall = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise RuntimeError(f"phase 16g: losses {losses}")
    buf = io.BytesIO()
    torch.save(model, buf)
    buf.seek(0)
    restored = torch.load(buf, weights_only=False)
    frames = [x[:BATCH] for x in xes]
    again = restored.pred_recon(frames, cov[:BATCH], compat.DEVICE, "gPoE")
    first = model.pred_recon(frames, cov[:BATCH], compat.DEVICE, "gPoE")
    if not all(np.array_equal(a, b) for a, b in zip(first, again)):
        raise RuntimeError("phase 16g: the restored facade's pred_recon "
                           "differs under the same generator state")
    print(f"phase 16g: compat.cVAE_multimodal at {DIMS}, hidden {HIDDEN}, "
          f"latent {LATENT}, batch {BATCH}: the reference loop, "
          f"{FACADE_EPOCHS} epochs x {len(losses) // FACADE_EPOCHS} steps "
          f"in {wall:.2f} s, losses finite (first {losses[0]:.3f}, last "
          f"{losses[-1]:.3f}); torch.save / torch.load round trip, "
          f"pred_recon equal under the same generator state", flush=True)


def run_streaming(stats):
    """Phase 16: streamed training, --remat and bf16, the profiler, the
    doctor and the imperative facade on the card. Returns {run: launches}
    of the phase's counted runs."""
    launches = {}
    t = [time.perf_counter()]
    run_stream_equality(launches)
    t.append(time.perf_counter())
    run_out_of_core(stats)
    t.append(time.perf_counter())
    run_stream_cli(launches)
    t.append(time.perf_counter())
    run_stream_profile(stats)
    t.append(time.perf_counter())
    precision = run_remat_bf16(launches)
    t.append(time.perf_counter())
    run_doctor()
    t.append(time.perf_counter())
    run_facade()
    t.append(time.perf_counter())
    walls = {f"16{p}": round(b - a, 1)
             for p, a, b in zip("abcdefg", t[:-1], t[1:])}
    print(f"phase 16: {walls}", flush=True)
    print(json.dumps({"streaming": {
        "out_of_core": stats["decoder_nll"].get("out_of_core"),
        "profile": stats["decoder_nll"].get("profile"),
        "remat_bf16": precision, "walls_s": walls}}), flush=True)
    return launches


# ---- phase 17: fold, data and tensor parallelism on torch.distributed ----

# 17a-17c on phase 8's cohort (UCA-gPoE, 5 folds) and phase 12b's ADHD cohort
# (SE-gPoE, 10 folds: the fold axis takes 5 a rank); 17d at phase 16a's
# PPMI width. Every meshed run is two ranks of one torchrun on cuda:0
# (gloo), against the unmeshed run in this process at the JAX tests' bounds
# (tests/test_fold_parallel_cli.py:96-97, :130-131)
MESH_RANKS = 2
MESH_EPOCHS = 10
MESH_ADNI = ["-R", "ADNI", "-P", "UCA-gPoE", "-K", str(FOLDS)]
MESH_ADHD = ["-R", "ADHD", "-P", "SE-gPoE", "-K", str(ADHD_FOLDS)]
MESH_TRAIN = ["-H", "110", "110", "10", "-E", str(MESH_EPOCHS)]
MESH_TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)
MESH_CSV_TOL = dict(rtol=1e-5, atol=1e-7)
MESH_TIMEOUT = 600
# 17d: phase 16a's PPMI cohort, resident --mesh 1,2 and streamed in 2 shards
MESH_STREAM_EPOCHS, MESH_STREAM_SHARDS = 3, 2
# the all_reduce timed on cuda:0 through gloo: one float, then the flat
# gradient of the flagship (5 folds) and of the PPMI model (one fold)
MESH_COLLECTIVE_ITERS = 20


def param_count(dims, folds):
    from multi_modal_normative_modeling_tpu_torch.models import build_model

    model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                        len(dims), folds=folds)
    return sum(p.numel() for p in model.parameters())


def mesh_stream_job():
    """17d on one rank: the streamed --mesh 1,2 run against the resident
    --mesh 1,2 run at PPMI width, bit for bit (every rank holds both whole
    models after the runs' gathers)."""
    from multi_modal_normative_modeling_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, MESH_RANKS, device="cuda")
    ppmi = stream_cohort(PPMI_DIMS, [PPMI_N], seed=170)
    model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 171,
                                    MESH_STREAM_EPOCHS, mesh=mesh)
    want_logs, resident_ms = timed_run(trainer, ppmi)
    got_model, trainer = stream_trainer(PPMI_DIMS, 1, PPMI_N, 171,
                                        MESH_STREAM_EPOCHS,
                                        shards=MESH_STREAM_SHARDS, mesh=mesh)
    got_logs, streamed_ms = timed_run(trainer, ppmi)
    hold_equal_runs("17d streamed --mesh 1,2", (got_model, got_logs),
                    (model, want_logs))
    return {"resident_ms_per_step": resident_ms,
            "streamed_ms_per_step": streamed_ms}


def mesh_collective_job():
    """The all_reduce of the 'data' axis on this machine: gloo on two
    ranks of cuda:0, staged through the host (Mesh.all_reduce_), ms per
    call for one float and for each model's flat gradient."""
    from multi_modal_normative_modeling_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, MESH_RANKS, device="cuda")
    out = {}
    for name, numel in (("1 float", 1),
                        ("flagship gradient", param_count(DIMS, FOLDS)),
                        ("PPMI gradient", param_count(PPMI_DIMS, 1))):
        t = torch.ones(numel, device="cuda")
        for _ in range(3):
            mesh.all_reduce_(t, "data")
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(MESH_COLLECTIVE_ITERS):
            mesh.all_reduce_(t, "data")
        torch.cuda.synchronize()
        out[name] = {"numel": numel, "bytes": 4 * numel,
                     "ms": (time.perf_counter() - t0) * 1e3
                     / MESH_COLLECTIVE_ITERS}
    return out


def mesh_child(plan_path, out_dir):
    """One rank of phase 17's torchrun: the plan's jobs in order, each
    with the launch counts set to 0 before it and read after it; the
    rank's record goes to out_dir/rank<r>.json."""
    import os

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        score,
        test_supervised,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import distributed

    clis = {"train": train_supervised, "test": test_supervised,
            "score": score}
    record = {}
    for job in json.loads(Path(plan_path).read_text()):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = {}
        if job["kind"] in clis:
            cli = clis[job["kind"]]
            args = cli.build_parser().parse_args(job["argv"])
            if job["kind"] == "score":
                cli.score(args, project_root=job["root"])
            else:
                common.apply_post_parse_defaults(args)
                timings = {}
                kwargs = {"timings": timings} if job["kind"] == "test" else {}
                cli.main(args, project_root=job["root"], **kwargs)
                extra = timings
        elif job["kind"] == "stream":
            extra = mesh_stream_job()
        elif job["kind"] in ("sweep", "e2e", "serve"):
            extra = ep_child_job(job)
        else:
            extra = mesh_collective_job()
        torch.cuda.synchronize()
        record[job["name"]] = {"wall_s": time.perf_counter() - t0,
                               "launches": launch_counts(), **extra}
    record["backend"] = torch.distributed.get_backend()
    record["device"] = str(torch.cuda.current_device())
    rank = int(os.environ["RANK"])
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(record))
    distributed.shutdown()
    return 0


def run_ranks(plan, tmp):
    """The plan's jobs on MESH_RANKS ranks of one torchrun (every rank on
    cuda:0); returns each rank's record. A non-zero exit raises, with the
    end of the ranks' output; the ranks are killed at MESH_TIMEOUT."""
    import os
    import signal

    plan_path, out_dir, log_path = tmp / "plan.json", tmp / "ranks", \
        tmp / "ranks.log"
    out_dir.mkdir()
    plan_path.write_text(json.dumps(plan))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MESH_RANKS), str(ROOT / "chip_smoke.py"),
           "--mesh-child", str(plan_path), str(out_dir)]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=MESH_TIMEOUT)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if rc != 0:
        tail = log_path.read_text()[-6000:]
        raise RuntimeError(f"phase 17: torchrun exited {rc}:\n{tail}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(MESH_RANKS)]


def hold_csvs(what, got_root, want_root):
    """Every CSV the test stage wrote under want_root (outputs/, deviation/)
    against got_root's, numeric columns at MESH_CSV_TOL, the same columns;
    returns (files, largest absolute difference)."""
    import pandas as pd

    files, worst = 0, 0.0
    for path in sorted(want_root.rglob("*.csv")):
        rel = path.relative_to(want_root)
        if rel.parts[0] not in ("outputs", "deviation"):
            continue
        want, got = pd.read_csv(path), pd.read_csv(got_root / rel)
        if list(got.columns) != list(want.columns):
            raise RuntimeError(f"phase 17: {what}: {rel}: columns differ")
        num = want.select_dtypes("number").columns
        a, b = got[num].to_numpy(np.float64), want[num].to_numpy(np.float64)
        if a.shape != b.shape or not np.allclose(a, b, **MESH_CSV_TOL):
            raise RuntimeError(f"phase 17: {what}: {rel}: max abs diff "
                               f"{np.abs(a - b).max():.3e} over "
                               f"{MESH_CSV_TOL}")
        files += 1
        worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
    if not files:
        raise RuntimeError(f"phase 17: {what}: no CSV to compare")
    return files, worst


def hold_fold_halves(project, meshed):
    """17a's fold axis: the project's folds trained unmeshed by the train
    CLI's own steps (its prep, init and TrainConfig), MESH_RANKS models of
    ADHD_FOLDS / MESH_RANKS folds each, against the --mesh 2,1 run's
    checkpoints, every leaf np.array_equal. Returns 0.0."""
    from multi_modal_normative_modeling_tpu_torch import registry
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.interop import (
        params_to_jax,
        read_flax_checkpoint,
    )
    from multi_modal_normative_modeling_tpu_torch.parallel import (
        MultiFoldTrainer,
        stack_fold_batches,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig

    args = train_supervised.build_parser().parse_args(MESH_ADHD + MESH_TRAIN)
    common.apply_post_parse_defaults(args)
    kfold_dir = project / "outputs" / "kfold_analysis"
    names = registry.get_datasets_name(args.dataset_resourse, args.procedure)
    folds, dims, c_dim = common.prepare_folds(
        args, project, kfold_dir, kfold_dir / "supervised_cvae", names,
        project / "data" / args.dataset_resourse / "y.csv")
    config_dict = common.model_config_dict(args, dims, c_dim, len(names))
    config = TrainConfig(epochs=args.epochs, batch_size=256,
                         learning_rate=0.0001, combine=args.combine,
                         lr_schedule=args.lr_schedule,
                         base_lr=args.base_learning_rate,
                         max_lr=args.max_learning_rate, seed=42)
    max_n = max(f[0][0].shape[0] for f in folds)
    per = len(folds) // MESH_RANKS
    for start in range(0, len(folds), per):
        part = folds[start:start + per]
        model = common.build_model_from_config(config_dict, folds=per)
        train_supervised.default_init(model, config_dict["model"])
        model.to("cuda")
        MultiFoldTrainer(model, config, max_n).run(stack_fold_batches(
            [f[0] for f in part], [f[1] for f in part], config.batch_size))
        for f in range(per):
            want = dict(tree_leaves(params_to_jax(model, fold=f)))
            got = dict(tree_leaves(read_flax_checkpoint(
                meshed / PACKED_MODEL_DIR / f"{start + f:03d}")[0]))
            for k in want:
                if not np.array_equal(got[k], want[k]):
                    raise RuntimeError(
                        f"phase 17a: --mesh 2,1 fold {start + f} {k}: max "
                        f"abs diff {np.abs(got[k] - want[k]).max():.3e} "
                        "from the same folds trained unmeshed")
    return 0.0


def run_mesh(stats):
    """Phase 17: the train CLI on ('fold', 'data'[, 'model']) meshes, the
    meshed test stage and score CLI (K1 and K2 on each rank's shard), the
    streamed meshed trainer, each against the unmeshed run; the gloo
    all_reduce's cost. Returns {run: launches of each rank}."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.cli import (
        score,
        test_supervised,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    t = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_resource(tmp / "adni_cohort", "ADNI",
                                with_early_fusion=True, **CHAIN_COHORT)
        make_synthetic_resource(tmp / "adhd_cohort", "ADHD", **ADHD_COHORT)

        def project(name, cohort):
            shutil.copytree(tmp / cohort / "data", tmp / name / "data")
            return tmp / name

        roots = {name: project(name, cohort) for name, cohort in (
            ("adni", "adni_cohort"), ("adni_1,2", "adni_cohort"),
            ("adni_1,1,2", "adni_cohort"), ("adhd", "adhd_cohort"),
            ("adhd_2,1", "adhd_cohort"))}
        # the unmeshed runs, in this process
        walls = {}
        t0 = time.perf_counter()
        train_supervised.run(MESH_ADNI + MESH_TRAIN,
                             project_root=roots["adni"])
        train_supervised.run(MESH_ADHD + MESH_TRAIN,
                             project_root=roots["adhd"])
        walls["unmeshed train"] = time.perf_counter() - t0
        for name in ("adni", "adhd"):
            shutil.copytree(roots[name], tmp / f"{name}_test")
        t0 = time.perf_counter()
        test_supervised.run(MESH_ADNI, project_root=roots["adni"])
        test_supervised.run(MESH_ADHD, project_root=roots["adhd"])
        walls["unmeshed test"] = time.perf_counter() - t0
        ids = roots["adni"] / "ids.csv"
        pd.read_csv(roots["adni"] / "data" / "ADNI" / "y.csv")[["IID"]] \
            .to_csv(ids, index=False)
        score_flags = MESH_ADNI + ["--ids", str(ids)]
        t0 = time.perf_counter()
        score.run(score_flags + ["--output", str(tmp / "scores.csv"),
                                 "--roi_output", str(tmp / "roi.csv")],
                  project_root=roots["adni"])
        walls["unmeshed score"] = time.perf_counter() - t0
        t.append(time.perf_counter())

        mesh_flags = ["--fold_parallel", "--mesh"]
        plan = [
            {"name": "17a train 1,2", "kind": "train",
             "root": str(roots["adni_1,2"]),
             "argv": MESH_ADNI + MESH_TRAIN + mesh_flags + ["1,2"]},
            {"name": "17a train 1,1,2", "kind": "train",
             "root": str(roots["adni_1,1,2"]),
             "argv": MESH_ADNI + MESH_TRAIN + mesh_flags + ["1,1,2"]},
            {"name": "17a train 2,1", "kind": "train",
             "root": str(roots["adhd_2,1"]),
             "argv": MESH_ADHD + MESH_TRAIN + mesh_flags + ["2,1"]},
            {"name": "17b test 1,2", "kind": "test",
             "root": str(tmp / "adni_test"),
             "argv": MESH_ADNI + ["--mesh", "1,2"]},
            {"name": "17b test 2,1", "kind": "test",
             "root": str(tmp / "adhd_test"),
             "argv": MESH_ADHD + ["--mesh", "2,1"]},
            {"name": "17c score 1,2", "kind": "score",
             "root": str(roots["adni"]),
             "argv": score_flags + ["--output", str(tmp / "mesh_scores.csv"),
                                    "--roi_output", str(tmp / "mesh_roi.csv"),
                                    "--mesh", "1,2"]},
            {"name": "17d stream 1,2", "kind": "stream"},
            {"name": "gloo all_reduce", "kind": "collective"},
        ]
        # phase 18's jobs ride the same torchrun: no second rank start
        ep_plan, ep_ref = ep_prepare(tmp, roots)
        t.append(time.perf_counter())
        ranks = run_ranks(plan + ep_plan, tmp)
        t.append(time.perf_counter())

        # 17a: every axis's checkpoints against the unmeshed run's at the
        # JAX bound, and the fold axis's bit for bit against the same folds
        # trained unmeshed, 5 a model (a fold's products no longer depend
        # on how many folds are stacked: ops/linear.fold_expand)
        diffs = {}
        for name, ref in (("adni_1,2", "adni"), ("adni_1,1,2", "adni"),
                          ("adhd_2,1", "adhd")):
            diffs[name] = hold_checkpoints(f"17a {name}", roots[name],
                                           roots[ref], MESH_TRAIN_TOL,
                                           phase="phase 17a")
        diffs["adhd_2,1 from 2 x 5 unmeshed folds"] = hold_fold_halves(
            roots["adhd"], roots["adhd_2,1"])
        # 17b: the meshed test stages' CSVs, and each rank's launches: K1
        # and K2 once per modality on its shard
        csvs = {"adni_1,2": hold_csvs("17b test 1,2", tmp / "adni_test",
                                      roots["adni"]),
                "adhd_2,1": hold_csvs("17b test 2,1", tmp / "adhd_test",
                                      roots["adhd"])}
        modalities = {"17b test 1,2": 4, "17b test 2,1": 2,
                      "17c score 1,2": 4}
        launches = {}
        for job, m in modalities.items():
            want = {"fused_encoder": m, "fused_pred_deviation": m}
            for r, record in enumerate(ranks):
                got = record[job]["launches"]
                if got != want:
                    raise RuntimeError(f"phase 17: rank {r} of {job} "
                                       f"launched {got}, expected {want}")
                launches[f"{job} rank {r}"] = got
        # the train jobs launch K7 alone, once a step on every rank
        job_roots = {job["name"]: job.get("root") for job in plan}
        for job in ("17a train 1,2", "17a train 1,1,2", "17a train 2,1"):
            want = with_adam({}, train_run(Path(job_roots[job])
                                           / PACKED_MODEL_DIR)[1])
            if any(record[job]["launches"] != want for record in ranks):
                raise RuntimeError(f"phase 17: {job} launched "
                                   f"{[r[job]['launches'] for r in ranks]}, "
                                   f"expected {want} on every rank")
            launches[f"{job} rank 0"] = want
        # 17c: the meshed score CLI against the unmeshed one
        for a, b in (("scores.csv", "mesh_scores.csv"),
                     ("roi.csv", "mesh_roi.csv")):
            want, got = pd.read_csv(tmp / a), pd.read_csv(tmp / b)
            num = want.select_dtypes("number").columns
            if (list(got.columns) != list(want.columns)
                    or not (got["participant_id"]
                            == want["participant_id"]).all()
                    or not np.allclose(got[num].to_numpy(np.float64),
                                       want[num].to_numpy(np.float64),
                                       **MESH_CSV_TOL)):
                raise RuntimeError(f"phase 17c: {b} differs from {a}")
        adhd = json.loads((roots["adhd"] / PACKED_MODEL_DIR / "000"
                           / "cVAE_model.json").read_text())
        t.append(time.perf_counter())
        launches.update(ep_check(ranks, ep_ref, stats))
    t.append(time.perf_counter())
    # K1 and K2 at each rank's shapes: 5 folds x 64 rows of ADNI's widths
    # (1,2: half of the 128 padded rows) and of ADHD's (2,1: 5 of 10 folds)
    rank_shapes = [(FOLDS, STAGE_ROWS // MESH_RANKS, d, C_DIM, HIDDEN,
                    LATENT) for d in (90, 270)]
    rank_shapes += [(ADHD_FOLDS // MESH_RANKS, 64, adhd["input_dim_list"][0],
                     adhd["c_dim"], HIDDEN, LATENT)]
    hold_kernel_shapes("phase 17b", rank_shapes, stats, "mesh")
    t.append(time.perf_counter())
    backend = ranks[0]["backend"]
    jobs = {job: [round(r[job]["wall_s"], 3) for r in ranks]
            for job in ranks[0] if isinstance(ranks[0][job], dict)
            and "wall_s" in ranks[0][job] and job.startswith("17")}
    print(f"phase 17: {MESH_RANKS} ranks of one torchrun on cuda:"
          f"{ranks[0]['device']}, backend {backend}; rank walls (s) {jobs}; "
          f"unmeshed walls in this process {walls}", flush=True)
    print(f"phase 17a: -E {MESH_EPOCHS} -H 110 110 10: max abs diff from "
          f"the unmeshed checkpoints {diffs} (every axis held at "
          f"{MESH_TRAIN_TOL}, the fold axis also bit for bit to the same "
          f"folds trained unmeshed)", flush=True)
    print(f"phase 17b/17c: test stage CSVs (files, max abs diff) {csvs}; "
          f"score CLI --mesh 1,2 equal to the unmeshed scores at "
          f"{MESH_CSV_TOL}; K1/K2 launches per rank {launches}; test "
          f"stage walls by phase per rank "
          f"{[r['17b test 1,2'].get('walls') for r in ranks]}", flush=True)
    steps = [{k: round(v, 3) for k, v in r["17d stream 1,2"].items()
              if k.endswith("step")} for r in ranks]
    print(f"phase 17d: streamed ({MESH_STREAM_SHARDS} shards) --mesh 1,2 "
          f"bit-equal to the resident --mesh 1,2 run at PPMI width "
          f"({MESH_STREAM_EPOCHS} epochs); ms per step {steps}", flush=True)
    collective = {k: v for k, v in ranks[0]["gloo all_reduce"].items()
                  if isinstance(v, dict) and "ms" in v}
    print(f"phase 17: gloo all_reduce on cuda:0 (staged through the host), "
          f"rank 0: {collective}", flush=True)
    stats["mesh"] = {"backend": backend, "rank_walls_s": jobs,
                     "unmeshed_walls_s": walls, "checkpoint_diffs": diffs,
                     "csvs": csvs, "all_reduce": collective,
                     "stream": ranks[0]["17d stream 1,2"],
                     "phase_walls_s": {
                         "unmeshed runs": t[1] - t[0],
                         "phase 18 references": t[2] - t[1],
                         "torchrun (phases 17 and 18)": t[3] - t[2],
                         "checks": t[4] - t[3],
                         "phase 18 checks": t[5] - t[4],
                         "kernel shapes": t[6] - t[5]}}
    print(json.dumps({"mesh": stats["mesh"]}), flush=True)
    return launches


# ---- phase 18: expert parallelism, the grids, serving and the doctor on a
# mesh; its rank jobs ride phase 17's one torchrun (run_mesh) ------------

# 18a/18b on phase 17's ADHD (2 x 116, one modality a rank) and ADNI
# (UCA-gPoE, 3 x 90 + 270: the width groups stay whole on a 2-way modality
# axis) cohorts, against the unmeshed --packed_xla runs (the layout
# --ep_mesh trains) at MESH_TRAIN_TOL and their test stages at MESH_CSV_TOL
EP_TRAIN = {"adhd_ep21": ("adhd", "2,1"), "adhd_ep121": ("adhd", "1,2,1"),
            "adni_ep121": ("adni", "1,2,1")}
# 18c: two epoch milestones of one ADHD grid point, and two margins of the
# end-to-end grid (its 'config' axis over the ranks)
EP_SWEEP = ["-R", "ADHD", "-K", str(ADHD_FOLDS), "--procedures", "SE-gPoE",
            "--hz_grid", "110 110 10", "--epochs_list", "5",
            str(MESH_EPOCHS), "--device", "cuda"]
EP_E2E = ["-R", "ADNI", "-P", "SE-MoE", "-K", str(FOLDS), "-H", "110", "110",
          "10", "-Layers", "128", "64", "32", "-Margins", "0.5", "1",
          "-Weightcontrastives", "0.1", "-E", str(MESH_EPOCHS)]
# 18d: requests of 1 and 64 subjects to the service on phase 17's ADNI
# project, unmeshed in this process and on the ranks
EP_REQUESTS, EP_SIZES = 20, (1, 64)
EP_SERVE = {"18d serve mesh 1,2": ("mesh", "1,2"),
            "18d serve ep 1,2,1": ("ep_mesh", "1,2,1")}


def ep_prepare(tmp, roots):
    """Phase 18's projects and the unmeshed references, in this process:
    the packed-trained ADHD and ADNI projects and their test stages, the
    two grids, and the unmeshed service's answers and client p50s. Returns
    (the rank jobs, the references)."""
    import shutil

    from multi_modal_normative_modeling_tpu_torch.cli import (
        sweep_endtoend,
        sweep_supervised,
        test_supervised,
        train_supervised,
    )
    from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
        make_synthetic_resource,
    )

    flags = {"adhd": MESH_ADHD, "adni": MESH_ADNI}
    cohorts = {"adhd": "adhd_cohort", "adni": "adni_cohort"}
    t0 = time.perf_counter()
    ref = {"roots": {}}

    def project(name, cohort):
        shutil.copytree(tmp / cohort / "data", tmp / name / "data")
        ref["roots"][name] = str(tmp / name)
        return tmp / name

    for name in ("adhd", "adni"):
        packed = project(f"{name}_packed", cohorts[name])
        train_supervised.run(flags[name] + MESH_TRAIN + ["--packed_xla"],
                             project_root=packed)
        shutil.copytree(packed, tmp / f"{name}_ep_test")
        ref["roots"][f"{name}_ep_test"] = str(tmp / f"{name}_ep_test")
        test_supervised.run(flags[name], project_root=packed)
    for name, (cohort, _) in EP_TRAIN.items():
        project(name, cohorts[cohort])
    for name in ("adhd_ep_straight", "adhd_ep_resumed"):
        project(name, "adhd_cohort")
    for name in ("sweep_plain", "sweep_mesh"):
        project(name, "adhd_cohort")
    make_synthetic_resource(tmp / "fi_cohort", "ADNI", with_fi=True,
                            **CHAIN_COHORT)
    for name in ("e2e_plain", "e2e_mesh"):
        project(name, "fi_cohort")
    t1 = time.perf_counter()
    sweep_supervised.run(EP_SWEEP, project_root=tmp / "sweep_plain")
    sweep_endtoend.run(EP_E2E, project_root=tmp / "e2e_plain")
    t2 = time.perf_counter()
    # the service writes its ids file into the project: a copy of phase
    # 17's, whose files 17b compares
    served = tmp / "adni_served"
    shutil.copytree(roots["adni"], served)
    ref["roots"]["adni_served"] = str(served)
    ref["serve"] = ep_serve_requests(served, None)
    ref["walls_s"] = {"packed runs and test stages": t1 - t0,
                      "grids": t2 - t1,
                      "service": time.perf_counter() - t2}
    half = str(MESH_EPOCHS // 2)
    plan = [{"name": f"18a train ep {spec} {name}", "kind": "train",
             "root": str(tmp / name),
             "argv": flags[cohort] + MESH_TRAIN + ["--ep_mesh", spec]}
            for name, (cohort, spec) in EP_TRAIN.items()]
    plan += [
        {"name": "18a train ep 2,1 straight", "kind": "train",
         "root": str(tmp / "adhd_ep_straight"),
         "argv": MESH_ADHD + MESH_TRAIN + ["--ep_mesh", "2,1",
                                           "--checkpoint_every", half]},
        {"name": "18a train ep 2,1 killed", "kind": "train",
         "root": str(tmp / "adhd_ep_resumed"),
         "argv": MESH_ADHD + MESH_TRAIN[:-1] + [half, "--ep_mesh", "2,1",
                                                "--checkpoint_every", half]},
        {"name": "18a train ep 2,1 resumed", "kind": "train",
         "root": str(tmp / "adhd_ep_resumed"),
         "argv": MESH_ADHD + MESH_TRAIN + ["--ep_mesh", "2,1",
                                           "--checkpoint_every", half,
                                           "--resume"]}]
    plan += [{"name": f"18b test ep 1,2,1 {name}", "kind": "test",
              "root": str(tmp / f"{name}_ep_test"),
              "argv": flags[name] + ["--ep_mesh", "1,2,1"]}
             for name in ("adhd", "adni")]
    plan += [{"name": "18c sweep mesh 2,1", "kind": "sweep",
              "root": str(tmp / "sweep_mesh"),
              "argv": EP_SWEEP + ["--mesh", "2,1"]},
             {"name": "18c sweep_endtoend mesh 2,1", "kind": "e2e",
              "root": str(tmp / "e2e_mesh"),
              "argv": EP_E2E + ["--mesh", "2,1"]}]
    plan += [{"name": name, "kind": "serve", "root": str(served),
              "mesh": kind, "spec": spec}
             for name, (kind, spec) in EP_SERVE.items()]
    return plan, ref


def ep_serve_requests(root, mesh_kind, spec=None):
    """The service on the trained ADNI project at ``root`` (unmeshed, or
    --mesh / --ep_mesh ``spec`` on the ranks, rank 0 answering HTTP on
    127.0.0.1:0 in a thread): EP_REQUESTS requests of each of EP_SIZES ids
    and one with ROI, their answers, the client ms of each size and
    /healthz. The other ranks loop in serve_worker until rank 0 sends
    shutdown; they return None."""
    import threading

    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch.cli import common, serve

    kwargs = {}
    if mesh_kind == "mesh":
        kwargs["mesh"] = common.parse_infer_mesh(spec, "cuda")
    elif mesh_kind == "ep_mesh":
        kwargs["ep_mesh"] = common.parse_ep_mesh(spec, (3,), "F,M,D",
                                                 "cuda")[0]
    service = serve.ScoringService("ADNI", "UCA-gPoE", n_splits=FOLDS,
                                   project_root=root, device="cuda",
                                   **kwargs)
    run_mesh = kwargs.get("mesh") or kwargs.get("ep_mesh")
    if run_mesh is not None and not run_mesh.primary:
        service.serve_worker()
        return None
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    address = server.server_address[:2]
    ids = pd.read_csv(Path(root) / "data" / "ADNI" / "y.csv")["IID"]
    ids = ids.tolist()
    out = {"ms": {}, "answers": {}}
    try:
        for size in EP_SIZES:
            payload = {"ids": ids[:size]}
            http_call(address, "POST", "/score", payload)   # warm
            ms = []
            for _ in range(EP_REQUESTS):
                status, body, t = http_call(address, "POST", "/score",
                                            payload)
                if status != 200:
                    raise RuntimeError(f"phase 18d: {status} {body}")
                ms.append(t)
            out["ms"][size] = ms
            out["answers"][size] = body
        status, body, _ = http_call(address, "POST", "/score",
                                    {"ids": ids[:64], "roi": True})
        out["answers"]["roi"] = body
        out["health"] = http_call(address, "GET", "/healthz")[1]
    finally:
        server.shutdown()
        server.server_close()
        service.shutdown_workers()
    return out


def ep_child_job(job):
    """A phase 18 job that is not a train or test CLI run, on one rank."""
    from multi_modal_normative_modeling_tpu_torch.cli import (
        common,
        sweep_endtoend,
        sweep_supervised,
    )

    if job["kind"] == "serve":
        return {"serve": ep_serve_requests(job["root"], job["mesh"],
                                           job["spec"])}
    if job["kind"] == "sweep":
        args = sweep_supervised.build_parser().parse_args(job["argv"])
        sweep_supervised.main(args, project_root=job["root"])
    else:
        args = sweep_endtoend.build_parser().parse_args(job["argv"])
        common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
        sweep_endtoend.main(args, project_root=job["root"])
    return {}


def train_ms_per_step(root):
    """The train CLI's ms per step in ``root``: its run log's train_end
    (the trainer's run, batches to the device to the logs' fetch)."""
    events = [json.loads(line) for line in (
        Path(root) / PACKED_MODEL_DIR / "run_log.jsonl").read_text()
        .splitlines()]
    end = [e for e in events if e["event"] == "train_end"][-1]
    return 1e3 * end["run_s"] / end["steps"]


def ep_check(ranks, ref, stats):
    """Phase 18's checks on the ranks' records and files, the doctor's
    preflights, and K1/K2 at a rank's shapes against fp64. Returns {run:
    launches} of each rank's EP scoring."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch.cli import doctor

    roots = {k: Path(v) for k, v in ref["roots"].items()}
    t0 = time.perf_counter()
    diffs = {}
    for name, (cohort, spec) in EP_TRAIN.items():
        diffs[name] = hold_checkpoints(f"18a --ep_mesh {spec} {name}",
                                       roots[name], roots[f"{cohort}_packed"],
                                       MESH_TRAIN_TOL, phase="phase 18a")
    resumed = checkpoint_distance(roots["adhd_ep_resumed"],
                                  roots["adhd_ep_straight"])
    if resumed != 0.0:
        raise RuntimeError(f"phase 18a: the resumed --ep_mesh 2,1 run is "
                           f"{resumed:.3e} from the straight run")
    diffs["2,1 straight from 2,1"] = checkpoint_distance(
        roots["adhd_ep_straight"], roots["adhd_ep21"])
    # ms per step of each run (the train CLI's run log: the trainer's run
    # over its steps), rank 0's for the meshed ones
    step_ms = {name: train_ms_per_step(roots[name])
               for name in ("adhd_packed", "adhd_ep21", "adhd_ep121",
                            "adni_packed", "adni_ep121")}
    csvs = {name: hold_csvs(f"18b test --ep_mesh 1,2,1 {name}",
                            roots[f"{name}_ep_test"], roots[f"{name}_packed"])
            for name in ("adhd", "adni")}
    # each rank scores the modalities it owns: ADHD one of 2, ADNI two of
    # 4 (its block of the width-grouped order)
    launches = {}
    owned = {"adhd": 1, "adni": 2}
    for name, m in owned.items():
        job = f"18b test ep 1,2,1 {name}"
        want = {"fused_encoder": m, "fused_pred_deviation": m}
        for r, record in enumerate(ranks):
            if record[job]["launches"] != want:
                raise RuntimeError(f"phase 18b: rank {r} of {job} launched "
                                   f"{record[job]['launches']}, expected "
                                   f"{want}")
            launches[f"{job} rank {r}"] = record[job]["launches"]
    for name in EP_TRAIN:
        job = f"18a train ep {EP_TRAIN[name][1]} {name}"
        want = with_adam({}, train_run(Path(roots[name])
                                       / PACKED_MODEL_DIR)[1])
        if any(record[job]["launches"] != want for record in ranks):
            raise RuntimeError(f"phase 18a: {job} launched "
                               f"{[r[job]['launches'] for r in ranks]}, "
                               f"expected {want} on every rank")
        launches[f"{job} rank 0"] = want
    # 18c: the grids against the unmeshed ones
    got = json.loads((Path(roots["sweep_mesh"]) / "outputs"
                      / "sweep_supervised_results.json").read_text())
    want = json.loads((Path(roots["sweep_plain"]) / "outputs"
                       / "sweep_supervised_results.json").read_text())
    if [r["epochs"] for r in got] != [r["epochs"] for r in want] or not all(
            np.allclose(g["stats"]["auc"], w["stats"]["auc"],
                        **MESH_CSV_TOL) for g, w in zip(got, want)):
        raise RuntimeError(f"phase 18c: the meshed grid {got} differs from "
                           f"{want}")
    diffs["18c sweep mesh 2,1"] = hold_checkpoints(
        "18c sweep --mesh 2,1", roots["sweep_mesh"], roots["sweep_plain"],
        MESH_TRAIN_TOL, phase="phase 18c")
    e2e = [(roots[name] / "results_endtoend.csv").read_text()
           .replace("mesh='2,1'", "mesh=None")
           for name in ("e2e_mesh", "e2e_plain")]
    if e2e[0] != e2e[1]:
        raise RuntimeError("phase 18c: sweep_endtoend --mesh 2,1 wrote "
                           "other results than the unmeshed grid")
    # 18d: the services' answers against the unmeshed one's
    served = {}
    for name, (kind, spec) in EP_SERVE.items():
        got = ranks[0][name]["serve"]
        worst = 0.0
        for key, body in ref["serve"]["answers"].items():
            mine = got["answers"][str(key)] if str(key) in got[
                "answers"] else got["answers"][key]
            for field in ("deviation", "roi"):
                if field in body:
                    a, b = np.asarray(mine[field]), np.asarray(body[field])
                    if not np.allclose(a, b, **MESH_CSV_TOL):
                        raise RuntimeError(f"phase 18d: {name} {key} "
                                           f"{field} differs")
                    worst = max(worst, float(np.abs(a - b).max()))
        sizes = [int(s) for s in spec.split(",")]
        axes = (["fold", "data"] if kind == "mesh"
                else ["fold", "modality", "data"])
        if got["health"]["mesh"] != dict(zip(axes, sizes)):
            raise RuntimeError(f"phase 18d: /healthz mesh "
                               f"{got['health']['mesh']}")
        served[name] = {
            "max_abs_diff": worst, "mesh": got["health"]["mesh"],
            "ep_layout": got["health"]["ep_layout"],
            "client_p50_ms": {size: float(np.percentile(ms, 50))
                              for size, ms in got["ms"].items()}}
        if kind == "ep_mesh":
            # one K1 and one K2 per owned modality and request
            n = 2 * (EP_REQUESTS + 1) + 1
            for r, record in enumerate(ranks):
                want = {"fused_encoder": 2 * n, "fused_pred_deviation": 2 * n}
                if record[name]["launches"] != want:
                    raise RuntimeError(f"phase 18d: rank {r} of {name} "
                                       f"launched {record[name]['launches']}"
                                       f", expected {want}")
                launches[f"{name} rank {r}"] = record[name]["launches"]
    served["unmeshed"] = {"client_p50_ms": {
        size: float(np.percentile(ms, 50))
        for size, ms in ref["serve"]["ms"].items()}}
    # 18e: the doctor's preflights, each a child torchrun of CPU ranks
    t1 = time.perf_counter()
    results = []
    doctor.check_mesh(results, "1,2", 300.0, FOLDS, 256)
    doctor.check_ep_mesh(results, "2,1", 300.0, FOLDS, 256, 4)
    if [r["status"] for r in results] != ["OK", "OK"]:
        raise RuntimeError(f"phase 18e: the doctor's preflights {results}")
    t2 = time.perf_counter()
    # K1/K2 at a rank's shapes: ADHD's 10 folds x 64 rows at D 116, ADNI's
    # 5 folds x STAGE_ROWS at D 90 and 270
    adhd = json.loads((roots["adhd_packed"] / PACKED_MODEL_DIR / "000"
                       / "cVAE_model.json").read_text())
    hold_kernel_shapes("phase 18b", [
        (ADHD_FOLDS, 64, adhd["input_dim_list"][0], adhd["c_dim"], HIDDEN,
         LATENT)] + [(FOLDS, STAGE_ROWS, d, C_DIM, HIDDEN, LATENT)
                     for d in (90, 270)], stats, "ep")
    jobs = {job: [round(r[job]["wall_s"], 3) for r in ranks]
            for job in ranks[0] if job.startswith("18")}
    print(f"phase 18a: --ep_mesh training, max abs diff from the unmeshed "
          f"packed checkpoints {diffs} (held at {MESH_TRAIN_TOL}); resumed "
          f"2,1 byte-equal to the straight run; ms per step {step_ms}",
          flush=True)
    print(f"phase 18b: --ep_mesh 1,2,1 test stage CSVs (files, max abs "
          f"diff) {csvs} at {MESH_CSV_TOL}; K1/K2 launches per rank "
          f"{launches}", flush=True)
    print(f"phase 18d: services {served}", flush=True)
    print(f"phase 18e: doctor {[r['detail'] for r in results]} "
          f"({t2 - t1:.1f} s)", flush=True)
    print(f"phase 18: rank walls (s) {jobs}; unmeshed references "
          f"{ref['walls_s']}; checks {t1 - t0:.1f} s", flush=True)
    stats["ep"] = {"checkpoint_diffs": diffs, "csvs": csvs,
                   "train_ms_per_step": step_ms,
                   "services": served, "rank_walls_s": jobs,
                   "unmeshed_walls_s": ref["walls_s"]}
    return launches


# phase 19: the demo projects (demo.py at its defaults: 170 subjects, 3
# folds, -H 32 32 8, 60 epochs), the figures and the library facade
DEMO_FOLDS = 3
DEMO_HIDDEN = [32, 32]
DEMO_LATENT = 8
DEMO_SUBJECTS = 170
# K1 and K2 launches of each procedure project's test stage: one a modality
DEMO_PROCEDURES = {"SM-av45": 1, "SE-gPoE": 3, "UCA-gPoE": 4}
LIB_ROWS = 512
LIB_EPOCHS = 10


def file_stamps(root):
    return {p: p.stat().st_mtime_ns for p in Path(root).rglob("*")
            if p.is_file()}


def run_demo_projects(base, stats):
    """19a and 19b: demo.ensure_demo_project at its defaults on the card,
    the launches of its test stage, the reports, and a second call that
    reruns nothing; then one project per procedure the same way. Returns
    (the SE-gPoE project, the UCA-gPoE project, launches by run)."""
    from multi_modal_normative_modeling_tpu_torch import demo, kernels

    launches = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    root = demo.ensure_demo_project(base / "notebook_demo")
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches["19a"] = launch_counts()
    want = with_adam({"fused_encoder": 3, "fused_pred_deviation": 3},
                     train_run(root / PACKED_MODEL_DIR)[1])
    if launches["19a"] != want:
        raise RuntimeError(f"phase 19a: the demo launched {launches['19a']}, "
                           f"expected {want}")
    check_reports(root, {"auc": []}, DEMO_FOLDS, DEMO_HIDDEN + [DEMO_LATENT],
                  "phase 19a")
    stamps = file_stamps(root)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    demo.ensure_demo_project(base / "notebook_demo")
    again = time.perf_counter() - t0
    if file_stamps(root) != stamps or launch_counts():
        raise RuntimeError(f"phase 19a: the second call ran a stage "
                           f"(launches {launch_counts()})")
    print(f"phase 19a: demo.ensure_demo_project at its defaults on the "
          f"card: {first:.2f} s, test stage launches {launches['19a']}, "
          f"the four reports in the JAX package's layout; a second call "
          f"{again:.3f} s, no stage rerun ({len(stamps)} files' mtimes "
          f"unchanged)", flush=True)

    procs = base / "procedures"
    walls = {}
    for proc, n in DEMO_PROCEDURES.items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        roots = demo.ensure_procedure_projects(procs, procedures=(proc,))
        torch.cuda.synchronize()
        walls[proc] = round(time.perf_counter() - t0, 3)
        got = launch_counts()
        launches[f"19b {proc}"] = got
        want = with_adam({"fused_encoder": n, "fused_pred_deviation": n},
                         train_run(roots[proc] / PACKED_MODEL_DIR)[1])
        if got != want:
            raise RuntimeError(f"phase 19b: {proc} launched {got}, expected "
                               f"{want}")
        check_reports(roots[proc], {"auc": []}, DEMO_FOLDS,
                      DEMO_HIDDEN + [DEMO_LATENT], f"phase 19b {proc}")
    stamps = file_stamps(procs)
    kernels.reset_launch_counts()
    roots = demo.ensure_procedure_projects(procs)
    if (list(roots) != list(DEMO_PROCEDURES) or file_stamps(procs) != stamps
            or launch_counts()):
        raise RuntimeError(f"phase 19b: the second call ran a stage "
                           f"({list(roots)}, launches {launch_counts()})")
    print(f"phase 19b: demo.ensure_procedure_projects {list(roots)}: walls "
          f"{walls} s, test stage launches "
          f"{ {p: launches[f'19b {p}'] for p in DEMO_PROCEDURES} }, reports "
          f"in the JAX layout; all three again, no stage rerun", flush=True)
    return root, roots["UCA-gPoE"], launches


def run_cohort_latents(root, uca_root, stats):
    """19c: demo.load_fold_model and demo.cohort_latents on the card (K1
    once a modality at F = 1 over the cohort) against plain latent_stats
    evaluated in fp64 at phase 4's bound; K1 and K2 at the demo test
    stages' shapes and K1 at cohort_latents' against fp64, timed. Returns
    (latents, labels, launches)."""
    from multi_modal_normative_modeling_tpu_torch import demo, kernels

    model, params, config = demo.load_fold_model(root)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    latents, labels = demo.cohort_latents(root, model, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if launches != {"fused_encoder": 3}:
        raise RuntimeError(f"phase 19c: cohort_latents launched {launches}")
    xes, cs, _ = demo.cohort_inputs(root)
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        want, _ = model64.latent_stats(
            [torch.from_numpy(x).double().cuda()[None] for x in xes],
            [torch.from_numpy(c).double().cuda()[None] for c in cs], "gpoe")
    got = torch.from_numpy(latents).cuda()
    if (got.shape != (DEMO_SUBJECTS, DEMO_LATENT)
            or len(labels) != DEMO_SUBJECTS):
        raise RuntimeError(f"phase 19c: latents {tuple(got.shape)}, labels "
                           f"{len(labels)}")
    err, rel = check_close("phase 19c cohort_latents", got, want[0].float(),
                           MODEL_TOL)
    print(f"phase 19c: demo.cohort_latents over {DEMO_SUBJECTS} subjects "
          f"(config {config['input_dim_list']}, hidden "
          f"{config['hidden_dim']}, latent {config['latent_dim']}): "
          f"{wall * 1e3:.2f} ms, launches {launches}, max abs err "
          f"{err:.3e} (rel {rel:.3e}) vs plain latent_stats in fp64",
          flush=True)
    rows = stage_rows(root, DEMO_FOLDS)[0]
    uca_rows = stage_rows(uca_root, DEMO_FOLDS)[0]
    hold_kernel_shapes("phase 19c", [
        (DEMO_FOLDS, rows, 90, C_DIM, DEMO_HIDDEN, DEMO_LATENT),
        (DEMO_FOLDS, uca_rows, 270, C_DIM, DEMO_HIDDEN, DEMO_LATENT)],
        stats, "demo")
    hold_kernel_shapes("phase 19c", [
        (1, DEMO_SUBJECTS, 90, C_DIM, DEMO_HIDDEN, DEMO_LATENT)], stats,
        "demo_latents", k2=False)
    return latents, labels, launches


def run_figures(root, latents, labels, out_dir):
    """19d: each figure of viz.py writes its PNG where matplotlib (and, for
    the t-SNE, scikit-learn) is installed, and raises ModuleNotFoundError
    naming the package where it is not."""
    from multi_modal_normative_modeling_tpu_torch import registry, viz

    roi_csv = (root / "deviation" / "supervised_cvae" / "ADNI" / "SE-gPoE"
               / "path_model" / "av45" / "reconstruction_error_roi_av45.csv")
    hc = registry.get_hc_label("ADNI")
    table = viz.roi_deviation_table(roi_csv, hc, top_k=None)
    values = dict(zip(table["roi"], table["cohens_d"]))
    outcomes = {}
    for name, draw, needs in (
            ("tsne_latents", lambda path: viz.tsne_latents(
                latents, labels, path), ("matplotlib", "sklearn")),
            ("roi_deviation_map", lambda path: viz.roi_deviation_map(
                roi_csv, hc, path), ("matplotlib",)),
            ("glass_brain_scatter", lambda path: viz.glass_brain_scatter(
                values, path), ("matplotlib",))):
        missing = [m for m in needs if importlib.util.find_spec(m) is None]
        path = out_dir / f"{name}.png"
        try:
            draw(path)
        except ModuleNotFoundError as e:
            if not missing or e.name != missing[0]:
                raise
            outcomes[name] = f"ModuleNotFoundError naming {e.name}"
            continue
        if missing or not path.exists():
            raise RuntimeError(f"phase 19d: {name} drew with {missing} "
                               "absent, or wrote no file")
        outcomes[name] = f"wrote {path.name}"
    print(f"phase 19d: viz figures on this machine: {outcomes}", flush=True)


def run_library(base):
    """19e: train_single_fold and FoldTrainer.run_resumable on one fold at
    the flagship's widths, torch.equal to MultiFoldTrainer at F = 1 from
    the same init and noise; a killed and resumed run byte-equal to the
    straight one; load_checkpoint on the checkpoint the port wrote."""
    import dataclasses

    from multi_modal_normative_modeling_tpu_torch import (
        FoldTrainer,
        MultiFoldTrainer,
        TrainConfig,
        build_model,
        load_checkpoint,
        params_from_jax,
        params_to_jax,
        save_checkpoint,
        stack_fold_batches,
        train_single_fold,
    )

    rng = np.random.default_rng(19)
    data = [rng.standard_normal((LIB_ROWS, d), dtype=np.float32)
            for d in DIMS]
    covs = [one_hot_covariates(rng, LIB_ROWS)] * len(DIMS)
    gen = torch.Generator().manual_seed(19)
    tree = params_to_jax(build_model(
        "cVAE_multimodal", DIMS, HIDDEN, LATENT, C_DIM, len(DIMS),
        generator=gen), fold=0)
    config = TrainConfig(epochs=LIB_EPOCHS, batch_size=BATCH)
    steps = LIB_EPOCHS * -(-LIB_ROWS // BATCH)

    def fresh(params=tree):
        model = build_model("cVAE_multimodal", DIMS, HIDDEN, LATENT, C_DIM,
                            len(DIMS), device="cuda")
        if params is not None:
            params_from_jax(params, model)
        return model

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / steps

    ref_model = fresh()
    ref_logs, ref_ms = timed(lambda: MultiFoldTrainer(
        ref_model, config, LIB_ROWS).run(
            stack_fold_batches([data], [covs], BATCH)))
    single_model = fresh(None)
    (params, logs), single_ms = timed(lambda: train_single_fold(
        single_model, tree, data, covs, config))
    chunk_model = fresh(None)
    (chunked, chunk_logs), chunk_ms = timed(
        lambda: FoldTrainer(chunk_model, config, LIB_ROWS).run_resumable(
            tree, data, covs, None, base / "chunked", checkpoint_every=3))
    for what, model, got_logs in (("train_single_fold", single_model, logs),
                                  ("run_resumable", chunk_model,
                                   chunk_logs)):
        if not all(torch.equal(a, b) for a, b in
                   zip(model.parameters(), ref_model.parameters())):
            raise RuntimeError(f"phase 19e: {what} is not MultiFoldTrainer "
                               "at F = 1 bit for bit")
        if any(not np.array_equal(got_logs[k], ref_logs[k][0])
               for k in ref_logs):
            raise RuntimeError(f"phase 19e: {what}'s logs differ")
    # killed after 4 epochs, resumed in a fresh model and trainer
    FoldTrainer(fresh(None), dataclasses.replace(config, epochs=4),
                LIB_ROWS).run_resumable(tree, data, covs, None,
                                        base / "killed", checkpoint_every=2)
    resumer = FoldTrainer(fresh(None), config, LIB_ROWS)
    resumed, _ = resumer.run_resumable(None, data, covs, None,
                                       base / "killed", checkpoint_every=2)
    meta = {"model": "cVAE_multimodal", "input_dim_list": DIMS}
    blobs = {}
    for name, tree_out in (("straight", params), ("chunked", chunked),
                           ("resumed", resumed)):
        save_checkpoint(base / name / "ckpt", tree_out, meta)
        blobs[name] = (base / name / "ckpt" / "cVAE_model.ckpt").read_bytes()
    if len(set(blobs.values())) != 1 or resumer.engine.resumed_from != 4:
        raise RuntimeError(f"phase 19e: straight, chunked and resumed "
                           f"checkpoints differ (resumed from "
                           f"{resumer.engine.resumed_from})")
    loaded, loaded_meta = load_checkpoint(base / "resumed" / "ckpt",
                                          template_params=tree)
    flat_a, flat_b = list(tree_leaves(loaded)), list(tree_leaves(params))
    if loaded_meta != meta or len(flat_a) != len(flat_b) or not all(
            pa == pb and np.array_equal(a, b)
            for (pa, a), (pb, b) in zip(flat_a, flat_b)):
        raise RuntimeError("phase 19e: load_checkpoint differs from the "
                           "trained parameters")
    print(f"phase 19e: one fold of {LIB_ROWS} subjects at {DIMS}, hidden "
          f"{HIDDEN}, latent {LATENT}, batch {BATCH}, {LIB_EPOCHS} epochs "
          f"({steps} steps): train_single_fold {single_ms:.3f} ms a step "
          f"and FoldTrainer.run_resumable (every 3 epochs) {chunk_ms:.3f} "
          f"against MultiFoldTrainer {ref_ms:.3f}, parameters and logs "
          f"torch.equal; killed at epoch 4 and resumed byte-equal to the "
          f"straight run; load_checkpoint of it equal leaf for leaf",
          flush=True)
    return {"train_single_fold": single_ms, "run_resumable": chunk_ms,
            "MultiFoldTrainer": ref_ms}


def run_demo(stats):
    """Phase 19: the demo projects, cohort latents, the figures and the
    library facade, in a temporary directory; returns K1/K2 launches by
    run."""
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        t0 = time.perf_counter()
        root, uca_root, launches = run_demo_projects(base, stats)
        t1 = time.perf_counter()
        latents, labels, launches["19c cohort_latents"] = run_cohort_latents(
            root, uca_root, stats)
        t2 = time.perf_counter()
        run_figures(root, latents, labels, base)
        t3 = time.perf_counter()
        stats["library_ms_per_step"] = run_library(base)
        print(f"phase 19: 19a+19b {t1 - t0:.1f} s, 19c {t2 - t1:.1f} s, "
              f"19d {t3 - t2:.1f} s, 19e {time.perf_counter() - t3:.1f} s",
              flush=True)
    return launches


def masked_adam_sizes(dims, folds=ADAM_FOLDS):
    """The parameter sizes of the fused step's padded layout (UCA-gPoE
    widths: hidden [110, 110], latent 10, c 29) at ``dims``."""
    from multi_modal_normative_modeling_tpu_torch.kernels.train_step import (
        FusedTrainStep,
    )
    from multi_modal_normative_modeling_tpu_torch.models.stacked import (
        StackedMultimodalCVAE,
    )

    step = FusedTrainStep(StackedMultimodalCVAE(dims, HIDDEN, LATENT, C_DIM,
                                                len(dims)), COMBINE)
    return [folds * step._sizes[k] for k in step._param_names]


def run_masked_adam(stats):
    """Phase 20: K7 against the plain expression at both cells' layouts,
    bit for bit, then both timed."""
    from multi_modal_normative_modeling_tpu_torch.kernels import (
        masked_adam,
        roofline,
    )
    from multi_modal_normative_modeling_tpu_torch.train import TrainConfig
    from multi_modal_normative_modeling_tpu_torch.train.trainer import (
        MaskedAdam,
        build_lr_fn,
    )

    lr_fn = build_lr_fn(TrainConfig(), 512)
    out = {}
    for name, dims in ADAM_LAYOUTS.items():
        sizes = masked_adam_sizes(dims)
        gen = torch.Generator(device="cuda").manual_seed(20)
        params = [torch.randn(ADAM_FOLDS, n // ADAM_FOLDS, generator=gen,
                              device="cuda") for n in sizes]
        fast = MaskedAdam([p.clone() for p in params], lr_fn)
        plain = MaskedAdam([p.clone() for p in params], lr_fn)
        g = torch.randn(sum(sizes), generator=gen, device="cuda")
        valid = torch.ones(ADAM_FOLDS, device="cuda")
        valid[3] = 0.0
        before = masked_adam.launches
        for _ in range(5):
            fast.step_flat(g, valid)
            plain.step_flat_plain(g, valid)
        torch.cuda.synchronize()
        if masked_adam.launches - before != 5:
            raise RuntimeError(f"masked_adam: {masked_adam.launches - before}"
                               " launches for 5 steps")
        for k in ("flat", "m", "v", "count"):
            if not torch.equal(getattr(fast, k), getattr(plain, k)):
                raise RuntimeError(f"masked_adam {name}: {k} differs from "
                                   "the plain expression")
        valid = torch.ones(ADAM_FOLDS, device="cuda")
        ms = cuda_ms(lambda: fast.step_flat(g, valid))
        dev = device_ms(lambda: fast.step_flat(g, valid))
        plain_ms = cuda_ms(lambda: plain.step_flat_plain(g, valid))
        plain_dev = device_ms(lambda: plain.step_flat_plain(g, valid))
        work = roofline.masked_adam(sum(sizes))
        out[name] = {"elements": sum(sizes), "ms": ms, "device_ms": dev,
                     "plain_ms": plain_ms, "plain_device_ms": plain_dev,
                     "bound_ms": work.bound_ms,
                     "device_share": work.share(dev)}
        print(f"phase 20: MaskedAdam at {name}'s layout, {sum(sizes)} "
              f"elements, {len(sizes)} parameters x {ADAM_FOLDS} folds: "
              f"bit-equal to the plain expression over 5 steps, {ms:.4f} ms "
              f"(device {dev:.4f}) vs plain {plain_ms:.4f} ms (device "
              f"{plain_dev:.4f}), {bound_text(work, ms)}, "
              f"{100 * work.share(dev):.1f}% of it by device ms", flush=True)
    stats["masked_adam"] = out
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from multi_modal_normative_modeling_tpu_torch import kernels
    from multi_modal_normative_modeling_tpu_torch.kernels import (
        _build,
        roofline,
    )
    from multi_modal_normative_modeling_tpu_torch.models import (
        Decoder,
        Encoder,
        build_model,
    )

    # ---- phase 1: the card ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    before_cuda = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 1: {before_cuda - PROCESS_START:.3f} s from the script's "
          f"first line to the first CUDA call (imports and nvidia-smi), "
          f"{time.perf_counter() - before_cuda:.3f} s in that call",
          flush=True)

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    print(f"phase 2: built {lib_path.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # ---- phase 3: each kernel against its plain version -------------------
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    stats = {k.__name__: {"max_abs_err": 0.0} for k in kernels.KERNELS}
    print(f"matplotlib installed: "
          f"{importlib.util.find_spec('matplotlib') is not None}", flush=True)
    with torch.no_grad():
        for folds, rows, d, c_dim in SHAPES:
            x = torch.from_numpy(rng.standard_normal(
                (folds, rows, d), dtype=np.float32)).cuda()
            c = torch.from_numpy(rng.standard_normal(
                (folds, rows, c_dim), dtype=np.float32)).cuda()
            z = torch.from_numpy(rng.standard_normal(
                (folds, rows, LATENT), dtype=np.float32)).cuda()
            enc = Encoder(d, HIDDEN, LATENT, c_dim, folds=folds,
                          generator=gen, device="cuda")
            dec = Decoder(d, HIDDEN, LATENT, c_dim, folds=folds,
                          generator=gen, device="cuda")

            e1, r1, enc_plan = check_encoder(enc, x, c)
            mean = dec.fused_mean(z, c)
            e5, r5 = check_close("fused_decoder_mean", mean, dec(z, c)[0],
                                 TOL)
            recon, dev = dec.fused_pred_deviation(z, c, x)
            if not torch.equal(dev, dec.fused_pred_deviation(z, c, x)[1]):
                raise RuntimeError("fused_pred_deviation dev: two calls "
                                   "differ")
            recon_p = dec(z, c)[0]
            dev_p = kernels.reconstruction_deviation(x, recon_p)
            e3, r3 = check_close("fused_pred_deviation recon", recon,
                                 recon_p, TOL)
            e4, r4 = check_close("fused_pred_deviation dev", dev, dev_p,
                                 DEV_TOL)
            enc_ms = cuda_ms(lambda: enc.fused(x, c))
            enc_plain_ms = cuda_ms(lambda: enc(x, c))
            dec_ms = cuda_ms(lambda: dec.fused_pred_deviation(z, c, x))
            dec_plain_ms = cuda_ms(lambda: kernels.reconstruction_deviation(
                x, dec(z, c)[0]))
            mean_ms = cuda_ms(lambda: dec.fused_mean(z, c))
            mean_plain_ms = cuda_ms(lambda: dec(z, c)[0])
            enc_dev = device_ms(lambda: enc.fused(x, c))
            enc_plain_dev = device_ms(lambda: enc(x, c))
            dec_dev = device_ms(lambda: dec.fused_pred_deviation(z, c, x))
            dec_plain_dev = device_ms(
                lambda: kernels.reconstruction_deviation(x, dec(z, c)[0]))
            mean_dev = device_ms(lambda: dec.fused_mean(z, c))
            shape = (folds, rows, d, c_dim, HIDDEN, LATENT)
            enc_w = roofline.fused_encoder(*shape)
            dec_w = roofline.fused_pred_deviation(*shape)
            mean_w = roofline.fused_decoder_mean(*shape)
            print(f"phase 3: F={folds} B={rows} D={d} C={c_dim}: "
                  f"encoder max abs err {e1:.3e} (rel {r1:.3e}) vs fp64, "
                  f"bit-equal, {enc_plan.tiles} tiles x {enc_plan.splits} "
                  f"splits of {enc_plan.k_per}, scratch {enc_plan.scratch}, "
                  f"{enc_ms:.4f} ms (device {enc_dev:.4f}) vs plain "
                  f"{enc_plain_ms:.4f} ms (device {enc_plain_dev:.4f}), "
                  f"{bound_text(enc_w, enc_ms)}; "
                  f"pred_deviation recon err "
                  f"{e3:.3e} (rel {r3:.3e}), dev err {e4:.3e} (rel "
                  f"{r4:.3e}), dev bit-equal, {dec_ms:.4f} ms (device "
                  f"{dec_dev:.4f}) vs plain {dec_plain_ms:.4f} "
                  f"ms (device {dec_plain_dev:.4f}), "
                  f"{bound_text(dec_w, dec_ms)}; decoder_mean err "
                  f"{e5:.3e} (rel {r5:.3e}), "
                  f"{mean_ms:.4f} ms (device {mean_dev:.4f}) vs plain "
                  f"{mean_plain_ms:.4f} ms, "
                  f"{bound_text(mean_w, mean_ms)}", flush=True)
            for name, err, ms, dev_ms, plain, work in (
                    ("fused_encoder", e1, enc_ms, enc_dev, enc_plain_ms,
                     enc_w),
                    ("fused_pred_deviation", max(e3, e4), dec_ms, dec_dev,
                     dec_plain_ms, dec_w),
                    ("fused_decoder_mean", e5, mean_ms, mean_dev,
                     mean_plain_ms, mean_w)):
                s = stats[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                # the flagship scoring call's widest modality
                s["ms"], s["plain_ms"], s["work"] = ms, plain, work
                s["device_ms"] = dev_ms
                if (folds, rows) == (FOLDS, STAGE_ROWS):
                    # a chain's test stage: D = 90 in phases 8 and 9, D =
                    # 270 the fourth modality of phase 8
                    s.setdefault("test_stage", {})[f"D={d}"] = {
                        "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                        "bound_ms": work.bound_ms}
                    if name == "fused_encoder":
                        s["test_stage"][f"D={d}"].update(
                            k_splits=enc_plan.splits,
                            plain_device_ms=enc_plain_dev)
            if (folds, rows, d) == (1, 1024, 3485):   # one PPMI modality
                stats["fused_encoder"]["ppmi"] = {
                    "ms": enc_ms, "device_ms": enc_dev,
                    "plain_ms": enc_plain_ms,
                    "plain_device_ms": enc_plain_dev,
                    "bound_ms": enc_w.bound_ms}
        stats["fused_encoder"]["plain_device_ms"] = enc_plain_dev

        for (folds, rows, d, c_dim), hidden, splits in ENCODER_EXTRA:
            x = torch.from_numpy(rng.standard_normal(
                (folds, rows, d), dtype=np.float32)).cuda()
            c = covariates(rng, folds, rows)
            enc = Encoder(d, hidden, LATENT, c_dim, folds=folds,
                          generator=gen, device="cuda")
            err, rel, plan = check_encoder(enc, x, c, splits)
            layers = (enc.hidden_layers(), enc.mu.pair(), enc.logvar.pair())
            ms = device_ms(lambda: kernels.fused_encoder(
                *layers, x, c, True, splits=splits))
            print(f"phase 3: F={folds} B={rows} D={d} C={c_dim} hidden "
                  f"{hidden}, K splits forced to {splits}: encoder max abs "
                  f"err {err:.3e} (rel {rel:.3e}) vs fp64, bit-equal, "
                  f"{plan.tiles} tiles x {plan.splits} splits of "
                  f"{plan.k_per}, scratch {plan.scratch}, device {ms:.4f} ms",
                  flush=True)
            s = stats["fused_encoder"]
            s["max_abs_err"] = max(s["max_abs_err"], err)

    # ---- phase 3b: decoder_nll forward and backward -----------------------
    for folds, rows, hidden, d in NLL_SHAPES:
        err, rel, t = check_nll(rng, folds, rows, hidden, d)
        fwd_w = roofline.decoder_nll(folds, rows, hidden, d, backward=False)
        nll_w = roofline.decoder_nll(folds, rows, hidden, d)
        print(f"phase 3b: F={folds} B={rows} H={hidden} D={d}: decoder_nll "
              f"max abs err {err:.3e} (rel {rel:.3e}), backward bit-equal; "
              f"forward {t['fwd']:.4f} ms (device {t['fwd_device']:.4f}) vs "
              f"plain {t['plain_fwd']:.4f} ms, "
              f"{bound_text(fwd_w, t['fwd'])}; "
              f"forward+backward {t['fwd_bwd']:.4f} ms (device "
              f"{t['fwd_bwd_device']:.4f}) vs plain "
              f"{t['plain_fwd_bwd']:.4f} ms (device "
              f"{t['plain_fwd_bwd_device']:.4f}), "
              f"{bound_text(nll_w, t['fwd_bwd'])}", flush=True)
        s = stats["decoder_nll"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if (folds, rows, hidden, d) == NLL_TIMED:
            s["ms"], s["plain_ms"] = t["fwd_bwd"], t["plain_fwd_bwd"]
            s["work"], s["device_ms"] = nll_w, t["fwd_bwd_device"]
        if (folds, rows, hidden, d) == NLL_PPMI:
            s["ppmi"] = {"ms": t["fwd_bwd"],
                         "device_ms": t["fwd_bwd_device"],
                         "plain_ms": t["plain_fwd_bwd"],
                         "bound_ms": nll_w.bound_ms}

    # ---- phase 4: the flagship scoring call through the kernels -----------
    model = build_model("cVAE_multimodal", DIMS, HIDDEN, LATENT, C_DIM,
                        len(DIMS), folds=FOLDS, generator=gen, device="cuda")
    xes = [torch.from_numpy(rng.standard_normal(
        (FOLDS, ROWS, d), dtype=np.float32)).cuda() for d in DIMS]
    cs = [covariates(rng, FOLDS, ROWS)] * len(DIMS)
    eps = torch.randn((FOLDS, ROWS, LATENT),
                      generator=torch.Generator().manual_seed(1000)).cuda()

    kernels.reset_launch_counts()
    recons, devs = model.pred_recon_fused(xes, cs, COMBINE, eps=eps)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    for name in ("fused_encoder", "fused_pred_deviation"):
        if launches[name] == 0:
            raise RuntimeError(f"phase 4: {name} was not launched by the "
                               "scoring call")
    with torch.no_grad():
        ref = model.pred_recon(xes, cs, COMBINE, eps=eps)
    for m, d in enumerate(DIMS):
        check_close(f"modality {m} recon", recons[m], ref[m], MODEL_TOL)
        check_close(f"modality {m} deviation", devs[m],
                    model.reconstruction_deviation(xes[m], ref[m]),
                    MODEL_TOL)
        if recons[m].shape != (FOLDS, ROWS, d):
            raise RuntimeError(f"modality {m}: recon shape "
                               f"{tuple(recons[m].shape)}")

    def plain_call():
        with torch.no_grad():
            out = model.pred_recon(xes, cs, COMBINE, eps=eps)
            return [model.reconstruction_deviation(x, r)
                    for x, r in zip(xes, out)]

    kernel_wall = wall_ms(lambda: model.pred_recon_fused(xes, cs, COMBINE,
                                                         eps=eps))
    plain_wall = wall_ms(plain_call)
    kernel_dev = cuda_ms(lambda: model.pred_recon_fused(xes, cs, COMBINE,
                                                        eps=eps))
    plain_dev = cuda_ms(plain_call)
    # what the device needs for the call's launches, the host out of the way
    kernel_graph = device_ms(lambda: model.pred_recon_fused(xes, cs, COMBINE,
                                                            eps=eps))
    plain_graph = device_ms(plain_call)
    print(f"phase 4: {FOLDS} folds x {ROWS} rows, widths {DIMS}: launches "
          f"{launches}; scoring call wall {kernel_wall:.4f} ms (plain "
          f"{plain_wall:.4f} ms), CUDA-event {kernel_dev:.4f} ms (plain "
          f"{plain_dev:.4f} ms), device {kernel_graph:.4f} ms (plain "
          f"{plain_graph:.4f} ms)", flush=True)

    # the reconstruction call: encoder + decoder-mean kernels
    kernels.reset_launch_counts()
    means = model.pred_recon_means_fused(xes, cs, COMBINE, eps=eps)
    torch.cuda.synchronize()
    recon_launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if recon_launches["fused_decoder_mean"] != len(DIMS):
        raise RuntimeError(f"phase 4: the reconstruction call launched "
                           f"{recon_launches}")
    for m in range(len(DIMS)):
        check_close(f"modality {m} recon mean", means[m], ref[m], MODEL_TOL)
    launches["fused_decoder_mean"] = recon_launches["fused_decoder_mean"]
    print(f"phase 4: reconstruction call launches {recon_launches}",
          flush=True)

    # ---- phase 5: training through decoder_nll -----------------------------
    train_launches = compare_training("flagship", DIMS, TRAIN_ROWS,
                                      TRAIN_EPOCHS, seed=1)
    compare_training("PPMI width", PPMI_DIMS, PPMI_ROWS, 1, seed=2)
    launches["decoder_nll"] = train_launches["decoder_nll"]

    # ---- phase 6a/6b: the fused train step against its plain version ------
    for shape in STEP_SHAPES:
        err, times = check_step(*shape)
        s5 = stats["fused_train_step"]
        s5["max_abs_err"] = max(s5["max_abs_err"], err)
        if shape[0] == "flagship":
            s5["ms"], s5["plain_ms"], s5["work"], s5["device_ms"] = times[:4]
        # at PPMI width and at the ADHD cell's step (the wide-hidden route)
        for name, key in (("PPMI", "ppmi"), ("ADHD h460", "adhd")):
            if shape[0] == name:
                s5[key] = {"ms": times[0], "device_ms": times[3],
                           "plain_ms": times[1],
                           "bound_ms": times[2].bound_ms, "route": times[4]}
    err, times = check_tiled()
    stats["tiled_fused_train_step"].update(max_abs_err=err, ms=times[0],
                                           plain_ms=times[1], work=times[2],
                                           device_ms=times[3],
                                           fp32=times[4])

    # ---- phase 7: training through the fused train step --------------------
    fused = compare_fused_training("flagship", DIMS, TRAIN_ROWS,
                                   TRAIN_EPOCHS, seed=3, route="fused")
    compare_fused_training("PPMI width", PPMI_DIMS, PPMI_ROWS, 1, seed=4)
    # the ADHD cell's shape: every step on the wide-hidden route
    adhd = compare_fused_training("ADHD h460", ADHD_DIMS, ADHD_ROWS, 2,
                                  seed=6, hidden=ADHD_HIDDEN,
                                  latent=ADHD_LATENT, route="wide_hidden",
                                  rounded=True)
    stats["fused_train_step"]["adhd"]["train"] = {
        "routes": adhd["routes"], "masked_adam": adhd["masked_adam"],
        "ms_per_step": adhd["ms"]}
    tiled = bf16_training(seed=5)
    launches["fused_train_step"] = fused["fused_train_step"]
    launches["tiled_fused_train_step"] = tiled["tiled_fused_train_step"]
    # K7 in the fused trainer the benchmark times, once a step
    launches["masked_adam"] = fused["masked_adam"]
    adam_launches = {"plain + K4 (phase 5)": train_launches["masked_adam"],
                     "K5 (phase 7)": fused["masked_adam"],
                     "K6 (phase 7)": tiled["masked_adam"]}

    # ---- phase 8: the chain on the card ------------------------------------
    # its project stays for phase 11, which scores the ensemble it trained
    chain_dir = tempfile.TemporaryDirectory()
    chain_root = Path(chain_dir.name)
    chain_launches = run_chain(chain_root)

    sources = {"fused_encoder": ("encoder.cu", "mlp.py:121"),
               "fused_pred_deviation": ("pred_deviation.cu",
                                        "deviation.py:76"),
               "fused_decoder_mean": ("pred_deviation.cu", "mlp.py:182"),
               "decoder_nll": ("decoder_nll.cu", "decoder_nll.py:130"),
               "fused_train_step": ("train_step.cu", "train_step.py:543"),
               "tiled_fused_train_step": ("train_step_bf16.cu",
                                          "train_step_tiled.py:447")}
    print(f"phase 8: launches of the chain {chain_launches}", flush=True)

    # ---- phase 9: the model zoo on the card --------------------------------
    zoo_launches = run_zoo()
    for name in ("fused_encoder", "fused_pred_deviation"):
        missing = [m for m in ZOO_KERNEL_MODELS
                   if not zoo_launches.get(m, {}).get(name)]
        if missing:
            raise RuntimeError(f"phase 9: {name} was not launched by the "
                               f"test stage of {missing}")

    # ---- phase 10: the supervised variants' own CLIs -----------------------
    variant_launches = run_variants(stats)

    # ---- phase 11: the scoring surfaces on phase 8's ensemble --------------
    serve_launches = run_serving(chain_root, stats)

    # ---- phase 12: resume, and the two grid CLIs ---------------------------
    t12 = time.perf_counter()
    resume_launches, plain_bound = run_resume(stats)
    t12a = time.perf_counter()
    sweep_launches = run_sweep(stats, plain_bound)
    t12b = time.perf_counter()
    grid_launches = run_grid(
        stats, stats["variant_ms_per_step"]["nmpmcont"])
    print(f"phase 12: 12a {t12a - t12:.1f} s, 12b {t12b - t12a:.1f} s, "
          f"12c {time.perf_counter() - t12b:.1f} s", flush=True)

    # ---- phase 13: bootstrap, in-memory fusion, the test stage by phase ----
    t13 = time.perf_counter()
    native_data_plane()
    boot_launches, boot_walls = run_bootstrap(stats)
    t13a = time.perf_counter()
    fusion_launches = run_fusion(chain_root)
    t13b = time.perf_counter()
    stage_walls = run_test_stage_phases(chain_root)
    print(f"phase 13: 13a {t13a - t13:.1f} s, 13b {t13b - t13a:.1f} s, "
          f"13c {time.perf_counter() - t13b:.1f} s", flush=True)

    # ---- phase 14: the classifier baseline, export, the report -------------
    t14 = time.perf_counter()
    classifier_runs = run_classifier(stats)
    t14a = time.perf_counter()
    export_launches = run_export(chain_root, stats)
    t14b = time.perf_counter()
    report_summary = run_report(chain_root)
    chain_dir.cleanup()
    print(f"phase 14: 14a {t14a - t14:.1f} s, 14b {t14b - t14a:.1f} s, "
          f"14c {time.perf_counter() - t14b:.1f} s", flush=True)

    # ---- phase 15: the packed layouts (--packed_xla) ------------------------
    packed_launches = run_packed(stats)

    # ---- phase 16: streamed training, remat/bf16, profiler, doctor, facade
    t16 = time.perf_counter()
    stream_launches = run_streaming(stats)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)

    # ---- phase 17: fold, data and tensor parallelism (torch.distributed) -
    t17 = time.perf_counter()
    mesh_launches = run_mesh(stats)
    print(f"phase 17 and 18: {time.perf_counter() - t17:.1f} s", flush=True)
    print(json.dumps({"ep": stats["ep"]}), flush=True)

    # ---- phase 19: the demo projects, the figures, the library facade -----
    t19 = time.perf_counter()
    demo_launches = run_demo(stats)
    print(f"phase 19: {time.perf_counter() - t19:.1f} s", flush=True)

    # ---- phase 20: MaskedAdam (K7) at the cells' layouts -------------------
    run_masked_adam(stats)
    missing = [name for name in list(sources) + ["masked_adam"]
               if not launches.get(name)]
    if missing:
        raise RuntimeError(f"no launch on the main path: {missing}")
    report = []
    for name, (src, tpu) in sources.items():
        report.append({
            "name": name, "route": "cuda",
            "source": f"multi_modal_normative_modeling_tpu_torch/kernels/"
                      f"csrc/{src}",
            "replaces": f"multi_modal_normative_modeling_tpu/kernels/{tpu}",
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
            # the least time the card could take at the shape `ms` was
            # taken at; no single PyTorch call computes any of the six
            "bound_ms": stats[name]["work"].bound_ms,
            "bound_by": stats[name]["work"].bound_by,
            "library_ms": None,
            # the device's time for one call's launches, replayed from a
            # CUDA graph: `ms` less this is the wrapper's host work
            "device_ms": stats[name]["device_ms"],
        })
        # the same at PPMI width (K1, K4, K5) and at the chains' test
        # stages' rows (K1 to K3), K6 with fp32 operands, and the device's
        # time for K1's plain version
        for extra in ("ppmi", "adhd", "test_stage", "fp32",
                      "plain_device_ms"):
            if extra in stats[name]:
                report[-1][extra] = stats[name][extra]
        # K1 and K2 in the zoo's test stages (phase 9), per model
        if any(name in counts for counts in zoo_launches.values()):
            report[-1]["zoo_launches"] = {
                model: counts[name] for model, counts in zoo_launches.items()}
        # K1, K2, K3 in the variant CLIs' scoring (phase 10), per chain,
        # and K1/K3 at the regression's shapes
        if any(name in counts for counts in variant_launches.values()):
            report[-1]["variant_launches"] = {
                chain: counts[name]
                for chain, counts in variant_launches.items()
                if name in counts}
        if "regression" in stats[name]:
            report[-1]["regression"] = stats[name]["regression"]
        # phase 11: the launches of the score CLI's run, of one request and
        # of one latent request; K1/K2 at the requests' shapes and the
        # service's latency by request size
        report[-1]["serve_launches"] = {
            surface: counts.get(name, 0)
            for surface, counts in serve_launches.items()}
        for extra in ("serve", "serve_latency"):
            if extra in stats[name]:
                report[-1][extra] = stats[name][extra]
        # phase 12: the launches of each path's resumed call (6 of 10
        # epochs) with its state's size and save ms; each sweep point's test
        # stage and the grid's prediction; K1/K2 at the ADHD test stages'
        # shapes and K1 at the grid's 60 stacked folds
        report[-1]["resume_launches"] = {
            path: counts.get(name, 0)
            for path, counts in resume_launches.items()}
        report[-1]["sweep_launches"] = {
            **{point: counts.get(name, 0)
               for point, counts in sweep_launches.items()},
            "sweep_endtoend": grid_launches.get(name, 0)}
        for extra in ("resume", "adhd", "grid", "grid_ms_per_step"):
            if extra in stats[name]:
                report[-1][extra] = stats[name][extra]
        # phase 13: the bootstrap test stages' launches (all 10 replicates
        # in one call) and K1/K2 at that call's shapes; the in-memory
        # fusion chains' launches (K5 under the fused modality)
        report[-1]["bootstrap_launches"] = {
            variant: counts.get(name, 0)
            for variant, counts in boot_launches.items()}
        report[-1]["in_memory_fusion_launches"] = {
            run: counts.get(name, 0)
            for run, counts in fusion_launches.items()}
        if "bootstrap" in stats[name]:
            report[-1]["bootstrap"] = stats[name]["bootstrap"]
        # phase 14b: the launches of one exported scoring call and of one
        # latent call (the cuda program's mmnm nodes)
        report[-1]["export_launches"] = {
            call: counts.get(name, 0)
            for call, counts in export_launches.items()}
        # phase 15: the launches of the packed-trained ensembles' scoring:
        # 15a's test stage, its call held against fp64 and its score CLI
        # run; the variant CLIs' and the sweep point's scoring after
        # --packed_xla training
        report[-1]["packed_launches"] = {
            run: counts.get(name, 0)
            for run, counts in packed_launches.items()}
        # phase 16: K4 in 16a's streamed --fused_decoder run (a forward and
        # a backward per modality and step), K1/K2 in 16c's test stage of
        # the streamed checkpoints and in 16e's scoring calls
        report[-1]["stream_launches"] = {
            run: counts.get(name, 0)
            for run, counts in stream_launches.items()}
        for extra in ("out_of_core", "profile"):
            if extra in stats[name]:
                report[-1][extra] = stats[name][extra]
        # phase 17: K1 and K2 on each rank of the meshed test stages (1,2
        # and 2,1) and score CLI (1,2), and at each rank's shapes
        report[-1]["mesh_launches"] = {
            run: counts.get(name, 0) for run, counts in mesh_launches.items()}
        # phase 19: K1 and K2 in the demo projects' test stages (19a, 19b)
        # and K1 in cohort_latents (19c)
        report[-1]["demo_launches"] = {
            run: counts.get(name, 0) for run, counts in demo_launches.items()}
        # phase 18: K1 and K2 at an expert-parallel rank's shapes (its
        # launches per owned modality are in mesh_launches, "18b"/"18d");
        # phase 19c: at the demo test stages' shapes and cohort_latents'
        for slot in ("mesh", "ep", "demo", "demo_latents"):
            if slot in stats[name]:
                report[-1][slot] = stats[name][slot]
    # K7 replaces no TPU kernel (the JAX package's Adam is optax.adam)
    report.append({
        "name": "masked_adam", "route": "cuda",
        "source": "multi_modal_normative_modeling_tpu_torch/kernels/csrc/"
                  "masked_adam.cu",
        "replaces": None, "bound_by": "bytes", "library_ms": None,
        "launches": launches["masked_adam"], "train_launches": adam_launches,
        "resume_launches": {path: counts.get("masked_adam", 0)
                            for path, counts in resume_launches.items()},
        **stats["masked_adam"]})
    print(json.dumps({"classifier": classifier_runs,
                      "export": stats["export"], "report": report_summary}))
    print(json.dumps({"test_stage_walls": stage_walls,
                      "bootstrap_walls": boot_walls}))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        # one rank of phase 17's torchrun (run_ranks)
        sys.exit(mesh_child(*sys.argv[2:4]))
    sys.exit(main())
