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
     the padded layout is wider than its true shape), and PPMI width with
     one fold; two calls bit-equal; the flat gradient buffer bit-equal to
     the gradients autograd takes through StepFunction; time both;
  6b. the batch-tiled step (K6) in fp32 with tile_b < B against K5 and the
     plain version, and in bf16 against the fp32 plain version (at the JAX
     test's shape) and against its own plain bf16 transcription (flagship,
     and a ragged-width shape whose batch is not a multiple of the tile);
     two calls bit-equal; time both;
  7. train the flagship (5 folds, 10 epochs) through FusedFoldTrainer (K5)
     and hold it against MultiFoldTrainer with the plain loss from the same
     init and eps, counting K5 launches; the same at PPMI width; then a few
     bf16 steps through K6 against the fp32 run; ms per step of both paths;
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
     ROI CSVs, no figure). Each scoring call is then held against its plain
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
    ("PPMI", PPMI_DIMS, HIDDEN, 1, BATCH, C_DIM, LATENT, COMBINE),
]
FLAT_CHECKED = ("flagship", "ragged widths", "PPMI")
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
              if name in ("flagship", "PPMI") else None)   # the report's shapes
    if device is not None:
        print(f"phase 6a: K5 {name}: device {device:.4f} ms", flush=True)
    return err, (ms, plain, work, device)


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


def fused_training_run(dims, rows_per_fold, epochs, seed, fused,
                       precision="fp32"):
    """Fresh seeded model and cohort trained on fixed eps by
    MultiFoldTrainer with the plain loss or by FusedFoldTrainer (K5 in
    fp32, K6 in bf16); returns (logs, final packed params, ms per step,
    steps). The batches are uploaded before the clock starts."""
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
    model = build_model("cVAE_multimodal", dims, HIDDEN, LATENT, C_DIM,
                        len(dims), folds=folds,
                        generator=torch.Generator().manual_seed(seed),
                        device="cuda")
    config = TrainConfig(epochs=epochs, batch_size=BATCH, combine=COMBINE,
                         precision=precision)
    stacked = StackedMultimodalCVAE(dims, HIDDEN, LATENT, C_DIM, len(dims))
    if not fused:
        batches = DeviceBatches(stack_fold_batches(
            data, [[c] * len(dims) for c in cov], BATCH), "cuda")
        trainer = MultiFoldTrainer(model, config, max(rows_per_fold))
    else:
        trainer = FusedFoldTrainer(model, config, max(rows_per_fold))
        batches = trainer.batches(data, cov, "cuda")
        packed = packed_from_model(model, stacked)
    steps = epochs * batches.n_batches
    eps = torch.randn((steps, folds, BATCH, LATENT),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not fused:
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


def compare_fused_training(what, dims, rows_per_fold, epochs, seed):
    """plain, K5, K5, plain: holds the first K5 run against the first plain
    run and returns the K5 run's launches."""
    from multi_modal_normative_modeling_tpu_torch import kernels

    logs_p, state_p, plain1, steps = fused_training_run(
        dims, rows_per_fold, epochs, seed, fused=False)
    kernels.reset_launch_counts()
    logs_k, state_k, kern1, _ = fused_training_run(
        dims, rows_per_fold, epochs, seed, fused=True)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if launches["fused_train_step"] != steps:
        raise RuntimeError(f"{what}: fused_train_step launched "
                           f"{launches['fused_train_step']} times, expected "
                           f"{steps}")
    for k in logs_p:
        check_close(f"{what} fused log {k}", torch.from_numpy(logs_k[k]),
                    torch.from_numpy(logs_p[k]), FUSED_LOG_TOL)
    err = 0.0
    for a, b in zip(packed_leaves(state_k), packed_leaves(state_p)):
        err = max(err, check_close(f"{what} fused param", a, b,
                                   FUSED_PARAM_TOL)[0])
    kern2 = fused_training_run(dims, rows_per_fold, epochs, seed,
                               fused=True)[2]
    plain2 = fused_training_run(dims, rows_per_fold, epochs, seed,
                                fused=False)[2]
    print(f"phase 7: {what}: {len(rows_per_fold)} folds x {rows_per_fold} "
          f"subjects, widths {dims}, {steps} steps: launches {launches}; "
          f"final params max abs err {err:.3e}; ms/step K5 {kern1:.4f}, "
          f"{kern2:.4f}, plain {plain1:.4f}, {plain2:.4f}", flush=True)
    return launches


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
    if launches["tiled_fused_train_step"] != steps:
        raise RuntimeError(f"bf16: tiled_fused_train_step launched "
                           f"{launches['tiled_fused_train_step']} times, "
                           f"expected {steps}")
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


def check_reports(root, stats):
    """The analysis stage's files, in the JAX package's layout: three
    comparisons of ADNI, one block each in result_multimodal.txt, one block
    in result_4.txt, the last comparison's per-fold AUCs and their std in
    cvae_auc_and_std.csv, and an auc_rocs.csv per comparison. Returns the
    files' bytes by relative path."""
    number = r"-?(?:[0-9]+\.[0-9]+|inf|nan)"
    block = (r"Experiment settings: CVAE\. [^\n]*\n"
             r"(?: args\.Model [^\n]*\n)?"
             + "".join(rf"{name}: \$ {number} \\pm {number} \$ \n"
                       for name in ("ROC-AUC", "Accuracy", "Sensitivity",
                                    "Specificity", "Significance ratio"))
             + r"hz_para_list: \[110, 110, 10\]\n\n\n\n")
    files = [Path(rel) for rel in CHAIN_REPORTS] + sorted(
        p.relative_to(root) for p in root.rglob("auc_rocs.csv"))
    texts = {rel: (root / rel).read_bytes() for rel in files}
    for rel, blocks in zip(files[:2], (3, 1)):
        if not re.fullmatch(f"(?:{block}){{{blocks}}}", texts[rel].decode()):
            raise RuntimeError(f"phase 8: {rel} is not {blocks} report "
                               f"blocks:\n{texts[rel].decode()}")
    aucs = list(stats["auc"])
    table = np.loadtxt(root / files[2], delimiter=",")
    if table.shape != (FOLDS + 1,):
        raise RuntimeError(f"phase 8: {files[2]} holds {table.shape} values")
    aucs += list(table[:-1])
    if len(files) != 6:
        raise RuntimeError(f"phase 8: report files {files}")
    for rel in files[3:]:
        lines = texts[rel].decode().split("\n")
        if lines[0] != "ROC-AUC" or len(lines) != FOLDS + 2 or lines[-1]:
            raise RuntimeError(f"phase 8: {rel}: {lines}")
        aucs += [float(v) for v in lines[1:-1]]
    if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
        raise RuntimeError(f"phase 8: AUCs {aucs}")
    return texts


def check_stage_rows(root, phase):
    """The rows a chain's test stage gave the kernels, from the fold files it
    wrote: they must be the STAGE_ROWS at which phase 3 held the kernels
    against their plain versions."""
    import pandas as pd

    from multi_modal_normative_modeling_tpu_torch.cli import common

    kfold_dir = root / "outputs" / "kfold_analysis"
    most = max(len(pd.read_csv(common.fold_paths(kfold_dir, fold)[1]))
               for fold in range(FOLDS))
    tile = common.infer_row_tile()
    rows = -(-most // tile) * tile
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
    if timings["roi_rows"] != COHORT_SUBJECTS or list(out.glob("*.png")):
        raise RuntimeError(f"phase 10: regression ROI rows "
                           f"{timings['roi_rows']}, files {list(out.iterdir())}")
    return (f"{FOLDS} .npy pairs of up to {rows} rows, {len(roi)} ROI CSVs "
            f"of {COHORT_SUBJECTS} rows, no figure; RMSE per fold "
            f"{[round(float(s['RMSE']), 4) for s in stats]}")


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
            # plain trainer launches no kernel), read just after
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
            if name == "nmmlp":
                args.action = "analyze"
                result = nmmlp.main(args, root, timings=timings)
            if launches != VARIANT_LAUNCHES[name]:
                raise RuntimeError(f"phase 10: the scoring of {name} launched "
                                   f"{launches}, expected "
                                   f"{VARIANT_LAUNCHES[name]}")
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
            want = ({RESUME_KERNELS[path]: per_step * steps}
                    if path in RESUME_KERNELS else {})
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
        if (launches != {"fused_encoder": 3} or len(results) != configs
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
            s5["ms"], s5["plain_ms"], s5["work"], s5["device_ms"] = times
        if shape[0] == "PPMI":
            s5["ppmi"] = {"ms": times[0], "device_ms": times[3],
                          "plain_ms": times[1],
                          "bound_ms": times[2].bound_ms}
    err, times = check_tiled()
    stats["tiled_fused_train_step"].update(max_abs_err=err, ms=times[0],
                                           plain_ms=times[1], work=times[2],
                                           device_ms=times[3],
                                           fp32=times[4])

    # ---- phase 7: training through the fused train step --------------------
    fused = compare_fused_training("flagship", DIMS, TRAIN_ROWS,
                                   TRAIN_EPOCHS, seed=3)
    compare_fused_training("PPMI width", PPMI_DIMS, PPMI_ROWS, 1, seed=4)
    tiled = bf16_training(seed=5)
    launches["fused_train_step"] = fused["fused_train_step"]
    launches["tiled_fused_train_step"] = tiled["tiled_fused_train_step"]

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
    missing = [name for name in sources if not launches.get(name)]
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
        for extra in ("ppmi", "test_stage", "fp32", "plain_device_ms"):
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
    sys.exit(main())
