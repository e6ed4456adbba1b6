#!/usr/bin/env python3
"""Drive the PyTorch port (``sddm_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. the card: name, nvidia-smi name and power limit, versions;
  2. build the CUDA GroupNorm+SiLU kernels (NCHW and NHWC, one source), the
     NCHW backward (``csrc/gn_silu_bwd.cu``) and the NHWC backward
     (``csrc/gn_silu_nhwc_bwd.cu``) with nvcc, one process a source, all at
     once (build time and the ``-Xptxas -v`` summary); the NCHW kernel's
     plan at the largest plain site (cluster size, CTAs, threads, packs a
     thread) and ``cudaOccupancyMaxActiveClusters`` for it; the NHWC kernel's
     grid and dynamic shared memory at the largest packed site, and the
     count of bulk copies (``UBLKCP``) in the library's SASS (0: the kernel
     stages x with 16-byte loads and shared stores, not ``cp.async.bulk``);
  3. hold the NCHW kernel against its plain PyTorch version at every
     GroupNorm site of the plain flagship network, batch 16, in float32 and
     bfloat16, plus an odd shape (unaligned path), a near-constant group
     (variance clamp), B = 1, B = 200 (several runs a CTA), runs over four
     times what one cluster holds (the reread), runs that are not a multiple
     of the cluster size in packs, and the one-element path on a cluster;
     every call repeated bit for bit, and each call's plan printed;
  4. load the committed flagship checkpoint through ``load_enhancer`` with
     ``packed=False``, the plain NCHW network, at ancestral-12 (the serving
     recipe, bfloat16 compute);
  5. serve four seeded noisy requests as one ``enhance_batch``: shapes,
     trims, finiteness, the clip bound, and ``gn_silu.launches`` equal to
     33 sites x 12 steps x batches;
  6. serve them again through the plain GroupNorm+SiLU with the same weights
     and noise stream, in bfloat16 and in float32, and hold the kernel path
     against it; one float32 forward on the card against the CPU;
  7. time the kernel, its plain version and the two-call
     ``F.silu(F.group_norm(...))`` at the largest site with CUDA events,
     beside the bound of the bytes it must move, and the kernel and plain
     version at every site; every site's device time of the kernel alone
     from the profiler (CUDA events over back-to-back calls time the host's
     cost at the small sites), and their sum over a forward beside the
     bound;
  8. profile one served batch: device busy time by kernel, and the idle
     share against the unprofiled serve time of phase 5 (the profiler's own
     host cost inflates its wall time; both are printed); the NCHW kernel
     must show time and one launch per ``gn_silu`` call under its names.
Then the packed (space-to-depth) engine, ``load_enhancer``'s default:
  9. load the flagship through ``load_enhancer(steps=12)`` with its defaults:
     the network must be ``PackedUNetModified2`` and its canary must pass;
     hold the NHWC GroupNorm+SiLU(+offset mask) kernel ``gn_silu_nhwc``
     against its plain version at all 33 GroupNorm sites of that engine's
     forward (14 offset sites), batch 16, float32 and bfloat16, plus the JAX
     package's three exactness cases, two odd shapes, a near-constant group,
     B = 1, B = 200 (blocks loop over several items), the largest site at
     B = 32 in float32 (the largest share reread past the staging area) and
     an offset site whose ranges start mid-row; each call's grid plan is
     printed beside it;
 10. serve the four requests: shapes, trims, finiteness, ``gn_silu_nhwc``
     launches equal to 33 sites x 12 steps x batches, no NCHW launch;
 11. serve them again through the plain NHWC version (bf16 and f32) and hold
     the kernel path against it; hold the packed engine against the plain
     engine of phases 4-8 in float32 (TF32 off), where the two are one
     function; one float32 packed forward on the card against the CPU;
 12. time the kernel, its plain version and ``F.silu(F.group_norm())`` on
     the channels-last tensor at the largest site and the largest offset
     site, beside the byte bound; every site of a forward, by CUDA events
     (back-to-back calls: the host's cost per call included) and by the
     profiler's device time of the kernel alone; the packed serve
     against the plain-engine serve in turns (plain, packed, packed, plain);
     peak memory;
 13. profile one packed served batch: device busy by kernel, the idle share,
     and the count of cuDNN's NCHW<->NHWC transposes; the NHWC kernel must
     show time and one launch per ``gn_silu_nhwc`` call under its name.
Then the DiffWave vocoder (SDDM_spectrogram + FusedDiffWave, the committed
``artifacts/round5/diffwave`` checkpoint, bf16, DDIM-6):
 14. the build of the CUDA residual-stack kernel, started in phase 2 beside
     the GroupNorm+SiLU build (build time, the ``-Xptxas -v`` summary, the
     Hopper kernel's dynamic shared memory), and the counts of ``HGMMA``
     (wgmma) and ``UTMALDG`` (TMA load) instructions in the built library's
     SASS (``cuobjdump``), each of which must be above 0;
 15. hold ``diffwave_stack`` against its plain version at the served shape
     [8, 16384, 64], L=30, cycle 10, on the checkpoint's stacked weights, in
     bfloat16 and float32, at an odd shape, at L < cycle, at B = 1 (fewer
     tiles than blocks, a ragged last tile, dilations on both sides of the
     one-window / three-box switch), at d >= T, and at C = 32 on seeded
     weights; two calls on the same inputs must give the same bits;
 16. load the checkpoint through ``load_specmodel`` with ``"packed": true``
     and serve 8 seeded 16384-sample clips as one batch of raw audio: shape,
     finiteness, 6 stack calls and 180 layer launches;
 17. serve the same batch through the plain ``diffwave_stack_reference``
     with the same weights and noise, in bfloat16 and float32, and hold the
     kernel path against it; one float32 forward on the card against the
     CPU;
 18. time the kernel, its plain version and the same layers through cuDNN
     ``conv1d`` with CUDA events, beside the bound and the per-layer floor
     (the bytes any one-launch-per-layer design moves: us per layer, GB/s);
     time one served batch at DDIM-6 and at ancestral T=200; peak memory;
 19. profile one DDIM-6 served batch: device busy time by kernel, the stack
     kernels' share (failing if the stack launched but the profile shows no
     time under its kernels' names), and the idle share against the
     unprofiled serve of phase 18.

Then the flagship's file-to-score path, through the port's entry points in a
temporary directory outside the checkout:
 20. ``python -m sddm_tpu_torch.make_synthetic_corpus`` writes the v1 test
     split (200 utterances; --seed 2026, so the test split's seed is 2027);
     its noisy side, padded to whole rows and written as ``infer`` writes it,
     is scored by ``evaluate``; its means must lie within ``NOISY_LIMITS`` of
     the committed ``noisy_*.npy`` of ``artifacts/flagship_synth/
     eval_fewstep/anc12`` (the largest one-file differences are printed);
 21. ``python -m sddm_tpu_torch.infer`` (run in this process, so that the
     kernels' counts can be read) on the flagship's config and checkpoint with
     the dataset on that corpus and ``--steps 12``: ancestral-12, the packed
     engine, bf16, the config's loader (2 files a batch, 2 workers, each
     batch served at its own row count); ``gn_silu_nhwc`` launches equal to
     33 x 12 x sampler calls, every row of the corpus served once, every
     sampler output finite, and the output means of its ``evaluate`` within
     ``OUTPUT_LIMITS`` of the committed ``output_*.npy``; then again with the
     sampler's generator seeded 1, and once in float32, whose means are
     printed beside them; the serve and scoring seconds; then the NHWC
     kernel held against its plain version at every packed site at each row
     count the CLI's sampler calls had, float32 and bfloat16, every call
     repeated bit for bit;
 22. the same CLI with ``"packed": false`` over the same 200 files: the plain
     engine, ``gn_silu`` launches equal to 33 x 12 x sampler calls, finite
     outputs, its means held to the same limits, and the paired mean SI-SNR
     difference from [21]; the NCHW kernel held against its plain version at
     every plain site at each row count it was served; then ``python -m
     sddm_tpu_torch.evaluate_results <[21]'s samples> --load``, whose summary
     must equal [21]'s ``evaluate`` result.

Then the flagship's training path, new with the training slice:
 23. hold the NCHW GroupNorm+SiLU backward kernel (``csrc/gn_silu_bwd.cu``,
     one launch a call) against its plain backward at every site of the
     plain network, batch 16, float32 and bfloat16, plus B = 1, a constant
     group, cg 3 with an odd H*W and a 5.2M-element run (over what a
     cluster keeps: the reread), every call repeated bit for bit and its
     plan (``nchw_backward_plan``) printed; its time at the largest site
     (CUDA events and the profiler's device time) and each site's device
     time with its plan, summed over a step's 33 sites, beside the bound of
     the bytes it must move and torch autograd of ``F.silu(F.group_norm())``;
 24. one flagship train step (bf16, batch 16, 16448 samples, the plain
     network, the config's AMSGrad, seeded weights, batch and draws): the
     kernel path against the same step with both GroupNorm directions on
     their plain versions (loss, gradients, parameters after the step), then
     the same in float32; 33 ``gn_silu`` and 33 backward calls a step; the
     median step time, peak memory and one profiled step (device busy, idle
     share, the backward kernels' share, and the ``gn_silu_bwd*`` kernels
     the device ran, which must be 33 x ``BWD_LAUNCHES_PER_CALL``);
 25. ``python -m sddm_tpu_torch.train`` (run in this process): the flagship
     config from init on the first 400 files of the v1 train split for 3
     epochs with validation (ancestral-12) at epoch 3 on [20]'s test split
     (finite, falling epoch losses; current, last and best checkpoints; the
     validation WAVs; the launches of both directions), then resumed from
     the committed epoch-250 checkpoint for 2 epochs (each epoch's mean loss
     within ``RESUME_LOSS``), whose checkpoint is read back (the optimizer
     count) and served by ``load_enhancer`` (packed engine, canary) on the
     four requests of phase 5.

Then the vocoder family's entry points, new with their slice, on the v2
corpus the committed DiffWave run was trained and tested on:
 26. ``python -m sddm_tpu_torch.make_synthetic_corpus --version 2`` writes the
     test split (200 utterances at seed 2027) and the first 200 files of the
     train split; ``python -m sddm_tpu_torch.prepare_spectrogram`` writes
     their ``.spec.npy`` and ``.mel.npy`` on the card; one file's arrays are
     held against the same computation on the CPU;
 27. ``python -m sddm_tpu_torch.test -r artifacts/round5/diffwave/model_best.ckpt
     --ddim --steps 6`` (run in this process) over the 200 test crops, with
     the sampler seeded 0 and 1: the plain float32 DiffWave, as the root
     ``test.py`` serves (no ``diffwave_stack`` launch); every file served
     once, every sampler output finite; the 200-file STOI and
     pesq_wb_approx means (``evaluate``) and the test L1 loss within
     ``DDIM6_LIMITS`` of the committed DDIM-6 table, SI-SNR printed;
 28. the same 25 batches, the same crops in the same order, through
     ``load_specmodel(steps=6, ddim=True)`` with ``"packed": true``
     (``FusedDiffWave``, bf16): 30 x 6 x 25 = 4500 ``diffwave_stack`` layer
     launches, its means held to the same table and limits, its serve
     seconds beside [27]'s; the kernel held against its plain version at
     the shape this path gives it, [8, 15872, 64];
 29. ``python -m sddm_tpu_torch.train_specmodel`` (in this process): (a) the
     DiffWave recipe on the 200 train files (25 steps an epoch, batch 8)
     resumed from the committed epoch-20 checkpoint for 2 epochs, each
     epoch's mean loss within ``RESUME_DW_LOSS``, the optimizer count
     carried on; (b) the WaveGrad recipe (on-device mel features) from init
     for 2 epochs on the same files, finite and falling epoch losses, a
     DDIM-6 validation at epoch 2, and its checkpoint through the test CLI
     for one batch.

Then packed (space-to-depth) training, new with its slice (``SDDM_PACKED_TRAIN=1``,
``PackedTrainUNetModified2``, whose GroupNorm sites run ``gn_silu_nhwc`` forward
and ``gn_silu_nhwc_backward`` backward):
 30. hold the NHWC GroupNorm+SiLU(+mask) backward (``csrc/gn_silu_nhwc_bwd.cu``,
     one cooperative launch a call) against its plain backward, with the statistics the
     forward kernel wrote, at all 33 sites of the packed engine, batch 16,
     float32 and bfloat16, plus B = 1, B = 200 (identity and offset sites),
     a near-constant group, two odd shapes, the identity site and the largest
     offset site, every call repeated bit for bit and its plan
     (``nhwc_backward_plan``) printed; its time at the largest site (CUDA
     events and the profiler's device time) beside the bound, the plain
     version and torch autograd of ``gn_silu_nhwc_reference``, at the identity
     site beside torch autograd of ``F.silu(F.group_norm())`` on the
     channels-last view, and each site's device time (and CUDA events time,
     with its plan's waves) summed over a step's 33;
 31. one packed train step (bf16, batch 16, 16448 samples, [24]'s seeded
     weights, batch and draws, the config's AMSGrad): the kernel path against
     the same step with both NHWC directions on their plain versions (loss,
     gradients, parameters after the step), in bf16 and float32; in float32
     (TF32 off) the twin against the plain network's step; 33
     ``gn_silu_nhwc`` and 33 backward calls a step, no NCHW launch, and the
     profiler's count of the kernels (33 and 33); the median step, peak
     memory and one profiled step (device busy, idle share) beside [24]'s;
 32. ``SDDM_PACKED_TRAIN=1 python -m sddm_tpu_torch.train`` (in this process),
     resumed from the committed epoch-250 checkpoint on [25]'s 400 files for
     2 epochs (each epoch's mean loss within ``RESUME_LOSS``), the launches
     of both NHWC directions; its checkpoint read back (the committed
     checkpoint's parameter names and shapes, the optimizer count) and
     served by ``load_enhancer`` (packed engine, canary) on phase 5's four
     requests.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN = ROOT / "artifacts" / "flagship_synth"
VOCODER = ROOT / "artifacts" / "round5" / "diffwave"
SEED = 0
BATCH_ROWS = 16
STEPS = 12
SITES_PER_FORWARD = 33
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# kernel vs plain version, elementwise: |got - want| <= atol + rtol * |want|.
# float32: the statistics are summed in another order (last-bit differences).
# bfloat16: one bf16 ulp (2**-7 relative), as either side may round the same
# f32 value the other way, plus 1e-5 where the output is near zero.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0**-7)}
# served waveforms, kernel path vs plain path with the same weights and noise
# stream, as (max |d|, relative L2).  Both paths are deterministic, so the
# difference is the kernel's rounding carried through 12 steps.  On H100
# 80GB HBM3 cards at 700 W three runs read bf16 max |d| 1.9e-3 and rel L2
# 4.2e-3, f32 max |d| 4.2e-7 and rel L2 6.3e-7; each limit is its reading
# times 2.5 to 5.
E2E_TOL = {"bfloat16": (5e-3, 2e-2), "float32": (2e-6, 3e-6)}
# one float32 forward on the card (TF32 off) vs the CPU: the CPU port
# matches JAX to 1e-3 (tests/test_torch_checkpoint.py); the same bound here.
CARD_VS_CPU_TOL = 1e-3
# the packed engine (phases 9-13): served waveforms, NHWC kernel path vs its
# plain path, same weights and noise stream, as (max |d|, relative L2).  On an
# H100 80GB HBM3 at 700 W the first run read bf16 2.6e-3 and 4.4e-3, f32
# 2.0e-6 and 2.3e-6 (the NHWC statistics are summed in three stages, so f32
# sits further from the plain version than the NCHW kernel's 4.2e-7); each
# limit is its reading times 4 to 5.  (The first limits, set before any
# reading, were phase 6's: f32 2e-6 and 3e-6, which that run exceeded by 1%.)
PACKED_E2E_TOL = {"bfloat16": (1e-2, 2e-2), "float32": (1e-5, 1e-5)}
# packed engine vs plain engine in float32, TF32 off, same weights and noise
# (the convolutions sum in other orders): read 1.5e-6 and 2.2e-6, limits x5-7
# (first limits, before the reading: 1e-4).
ENGINES_F32_TOL = (1e-5, 1e-5)
PACKED_SITES, OFFSET_SITES = 33, 14
# the NHWC kernel of csrc/gn_silu.cu, as the profiler names it
NHWC_KERNEL = "nhwc_gn_silu"

# the DiffWave vocoder: 8 clips of 16384 samples, DDIM-6 (the quality-preferred
# few-step recipe of the JAX package's round-5 table), bf16
DW_CLIPS, DW_SAMPLES, DW_STEPS, DW_ANCESTRAL = 8, 16384, 6, 200
DW_LAYERS, DW_CYCLE = 30, 10
# the device kernels of csrc/diffwave_stack.cu, as the profiler names them
STACK_KERNELS = ("layer_wgmma", "layer_bf16", "layer_f32")
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
# Limits of the vocoder phases, each its reading on an NVIDIA H100 80GB HBM3 at
# 700 W times 2.5 to 5 (the first limits, set before any reading, were
# max |d| 1e-4 in float32 and 0.047 in bfloat16 per call and served, rel L2
# 1e-4 for the float32 served output, 1e-4 card vs CPU).
# diffwave_stack vs its plain version, per call, on the skip sum of the
# three cases of phase 15 (C = 64): float32 (max |d|, rel L2), read 1.9e-5 and
# 1.5e-7 at most.  bfloat16 (max |d| in bf16 ulps of the largest output, rel
# L2): both sides round at the same points, so they differ where an f32 sum
# in another order rounds to the neighbouring bf16 value and later layers
# carry the flip; read 3 ulps (0.75 on a skip sum of 46.75) and 3.3e-3.  The
# JAX package's 0.047 compares network outputs, not this pre-head sum.
DW_TOL = {"float32": (1e-4, 5e-7), "bfloat16": (8, 1e-2)}
# served waveforms, kernel path vs plain path, same weights and noise, as
# (max |d|, relative L2): float32 read 2.1e-7 and 1.5e-6; bfloat16 5.5e-3 and
# 3.9e-2 (six DDIM steps, each dividing the noise estimate's rounding by
# sqrt(alpha_bar), 0.36 at t=200, carry the per-call differences).
DW_E2E_TOL = {"float32": (1e-6, 6e-6), "bfloat16": (2e-2, 0.15)}
# one float32 DiffWave forward on the card (kernel, TF32 off) vs the CPU port
# (plain DiffWave): read 1.2e-6.
DW_CARD_VS_CPU_TOL = 5e-6

# the file-to-score path (phases 20-22): the committed ancestral-12 quality
# table of the flagship (packed engine, bf16, TPU v5e outputs) over the v1
# test split of the synthetic corpus, which make_synthetic_corpus writes at
# --seed + 1
ANC12 = RUN / "eval_fewstep" / "anc12"
CORPUS_FILES, CORPUS_SEED, CORPUS_VERSION = 200, 2026, 1
GATED_METRICS = ("sisnr", "stoi", "pesq_wb_approx")
# Limits on the difference of 200-file means from the committed means, stated
# before the first run.  Noisy side, the regenerated corpus against the
# committed noisy_*.npy: with numpy 2.0.2 and scipy 1.17.0 the JAX package's
# own generator and scorers read -0.013 dB, +0.0064 and -0.0093 (single files
# up to 0.056 dB, 0.72 STOI), while on an H100 machine the port regenerated
# the committed vectors to 1e-7; phase 20 prints the libraries' versions.
NOISY_LIMITS = {"sisnr": 0.05, "stoi": 0.015, "pesq_wb_approx": 0.03}
# Served outputs against the committed output_*.npy (17.705 dB, 0.503, 4.324):
# the JAX records put the sampler's seed spread at +-0.04 dB, +-0.0003 STOI and
# +-0.0025 pesq; 0.5 dB is about ten times that and still catches a fault the
# size of the known reduced-precision one (0.75 dB); STOI is wider because the
# v1 corpus degenerates under it.
# The plain engine (phase 22) serves the same recipe and is held to the same
# limits; the float32 run of phase 21 is a witness, printed and not gated.
OUTPUT_LIMITS = {"sisnr": 0.5, "stoi": 0.02, "pesq_wb_approx": 0.05}

# the backward kernel (phase 23): dx, dweight and dbias against the plain
# backward, |d| <= REL * scale + rtol * |want| with scale the largest
# |want| of that output; rtol is one bf16 ulp for a bf16 dx, else 1e-5.  On
# an H100 80GB HBM3 at 700 W this phase reads at most 1.9e-6 of the scale
# (dbias of the 5.2M-element run; the flagship sites 1.2e-7 to 5.3e-7) and a
# bf16 dx within one ulp; REL is the worst reading times 2.6.
BWD_REL = 5e-6
BWD_RTOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
# the kernel of csrc/gn_silu_bwd.cu, as the profiler names it; one launch a
# call (its last CTA sums dweight and dbias)
BWD_KERNEL = "gn_silu_bwd"
BWD_LAUNCHES_PER_CALL = 1
# one flagship train step (phase 24), the kernel path against the same step
# with both GroupNorm directions on their plain versions, the same weights,
# batch and draws: (loss relative difference, gradient relative L2 over all
# parameters, the worst parameter's gradient relative L2, the share of
# parameter elements whose update differs by more than lr / 2 -- the first
# AMSGrad step moves an element by lr times the sign of its gradient).  A
# parameter's relative L2 takes as its denominator no less than the norm it
# would have at the whole gradient's RMS: some biases (those feeding a
# GroupNorm of one channel a group, which removes any per-channel constant)
# have a zero gradient in exact arithmetic, and rounding noise in both paths.
# Limits: on an H100 80GB HBM3 at 700 W the step reads bf16 (2.3e-5,
# 5.9e-3, 2.2e-2, 2.3e-2) and f32 (0, 6.2e-5, 2.0e-4, 1.1e-4), the same
# values in every run (the kernel path run twice repeats its bits in bf16);
# each limit is its reading times 2.5 to 5 (f32 loss: 1e-6).  A plain
# relative L2 per parameter read 1.6-1.9 on the biases above.
TRAIN_TOL = {"bfloat16": (1e-4, 2e-2, 0.1, 6e-2), "float32": (1e-6, 2.5e-4, 1e-3, 4e-4)}
TRAIN_TIMED_STEPS = 20
# the training CLI (phase 25): the first 400 files of the committed run's
# 2000-file v1 train split (make_synthetic_corpus seeds each file by (seed,
# index)), 25 steps an epoch at batch 16.  Resumed from the committed epoch-250
# checkpoint, each epoch's mean train loss must lie in RESUME_LOSS: the JAX
# package's epochs 231-270 read 0.04105-0.05686 (mean 0.04989, sd 0.00348)
# over 125-step epochs (artifacts/flagship_synth/info.log); a 25-step epoch's
# mean spreads sqrt(5) times as far, so the band is that range widened about
# its mean by sqrt(5), and no further.
TRAIN_FILES = 400
RESUME_LOSS = (0.0300, 0.0655)
RESUME_EPOCHS = 2

# the NHWC backward (phases 30-32): the kernel of csrc/gn_silu_nhwc_bwd.cu, one
# launch a call (nhwc_bwd_fused), as the profiler names it.  [30] holds it
# against its plain backward at [23]'s limits (BWD_REL of each output's scale,
# one bf16 ulp for a bf16 dx), stated before the first run; the statistics the
# forward kernel writes for it at the same limits.
NHWC_BWD_KERNEL = "nhwc_bwd_"
NHWC_BWD_LAUNCHES_PER_CALL = 1
# [31]: one packed train step, the kernel path against both NHWC directions on
# their plain versions, at [24]'s TRAIN_TOL; and in float32 (TF32 off) the twin
# against the plain network's step from the same weights, batch and draws:
# (loss rel, gradient rel L2, worst parameter's rel L2, share of elements
# updated more than lr / 2 apart), first limits stated before any reading.
TWIN_VS_PLAIN_F32_TOL = (1e-5, 1e-3, 1e-2, 1e-3)

# the vocoder family's entry points (phases 26-29) on the v2 corpus the
# committed DiffWave run was trained and tested on: make_synthetic_corpus
# --version 2 --seed 2026 writes the test split at seed 2027, and the first
# VOC_FILES files of the train split (each file seeded by (seed, index))
VOC_FILES, VOC_SEED, VOC_VERSION = 200, 2026, 2
# prepare_spectrogram on the card against the same computation on the CPU,
# on log-compressed values in [0, 1]: 5e-5, the CPU test's bound between
# pocketfft and XLA (tests/test_torch_specmodel_cli.py)
SPEC_CARD_VS_CPU = 5e-5
# The committed DDIM-6 table of the JAX package's test.py (TPU v5e, float32,
# the plain DiffWave) over the 200 test crops: the means of
# artifacts/round5/diffwave_tests/ddim6/output_{stoi,pesq_wb_approx,sisnr}.npy
# and the test L1 loss of PERFORMANCE.md:266-270.  The card's copy of the
# checkout leaves that folder out, so the means are written here.
DDIM6_TABLE = {"stoi": 0.3371651549525915, "pesq_wb_approx": 2.0758591972652387,
               "loss": 0.0415}
DDIM6_SISNR = -47.91153561225778  # logged, not gated: phase-blind for a vocoder
# Limits on |port mean - committed mean| over the 200 crops, stated in PERF.md
# before the first run.  The committed run's sampler drew its x_T from JAX's
# PRNG, the port's from torch's; DDIM at eta 0 draws nothing else.  If two
# seeds gave each file an independent output, a file's metric would move by
# up to sqrt(2) times the per-file sd of the committed vectors (0.0727 STOI,
# 0.1971 pesq_wb_approx), and a 200-file mean by 0.0073 and 0.0197: each
# limit is three times that.  The L1 loss's limit is a tenth of its value,
# under the 0.0061 between the table's DDIM-6 and full-T losses (0.0415,
# 0.0354).  Phase 27 serves two seeds and prints the spread they read.
DDIM6_LIMITS = {"stoi": 0.022, "pesq_wb_approx": 0.059, "loss": 0.004}
# [28]: the packed engine's layer launches over the 25 batches, 30 x 6 x 25
VOC_BATCHES = VOC_FILES // 8
# [29] (a): resumed from the committed epoch-20 checkpoint (optimizer count
# 5000), each 25-step epoch's mean train loss must lie in RESUME_DW_LOSS: the
# JAX package's per-step losses after step 5500 read a mean of 0.0805 and an
# sd of 0.0348 (artifacts/round5/diffwave/scalars.jsonl, 251 logged steps),
# so a 25-step mean spreads 0.0348 / 5 = 0.00696; the band is that mean
# +- 4.5 of those, which also holds the 250-step windows from step 4500 on
# (0.076-0.091) and the 0.01-99.99% range of 25-step means resampled from
# those steps (0.0588-0.1119).
RESUME_DW_LOSS = (0.0492, 0.1118)
VOC_EPOCHS = 2


def log(msg: str = "") -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


UNSEEN_WINDOWS = []  # the device events of each window that saw no launch it looked for


def device_time_us(fn, match, calls: int = 5):
    """The profiler's device time of one launch of the kernels whose names
    ``match`` accepts, over ``calls`` calls of ``fn`` after three warm-up
    calls: (us a launch, launches seen).  A window in which the profiler saw
    none of the launches is profiled again, with the margins of
    ``utils/profiling.RETRY_WINDOWS`` in turn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.utils.profiling import RETRY_WINDOWS, profiled

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for margin, with_cpu in RETRY_WINDOWS:
        activities = (ProfilerActivity.CPU,) * with_cpu + (ProfilerActivity.CUDA,)
        with profiled(*activities, margin_s=margin) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        events = [e for e in device if match(e.key)]
        seen = sum(e.count for e in events)  # the profiler may miss a launch at its start
        if seen:
            return sum(e.self_device_time_total for e in events) / seen, seen
        UNSEEN_WINDOWS.append(sorted((e.key[:60], e.count) for e in device))
    return 0.0, 0


def close_enough(got, want, atol: float, rtol: float):
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    return ok, float(err.max())


@contextlib.contextmanager
def routed(module, name: str, replacement):
    """Point ``module.name`` at ``replacement`` for the duration of the
    block: a kernel's wrapper at its plain version, which the kernel path is
    held against."""
    kept = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, kept)


def plain_gn_silu():
    """Every GroupNormSiLU module of the plain network on ``gn_silu_reference``."""
    from sddm_tpu_torch.models import blocks
    from sddm_tpu_torch.ops.gn_silu import gn_silu_reference

    return routed(blocks, "gn_silu", gn_silu_reference)


def plain_gn_silu_nhwc():
    """Every GroupNorm site of the packed engine on ``gn_silu_nhwc_reference``
    (which takes no group-major ``order``: it sums by the one-hot map)."""
    from sddm_tpu_torch.models import unet_packed
    from sddm_tpu_torch.ops.gn_silu import gn_silu_nhwc_reference

    def plain(*args, order=None, **kwargs):
        return gn_silu_nhwc_reference(*args, **kwargs)

    return routed(unet_packed, "gn_silu_nhwc", plain)


def plain_diffwave_stack():
    """FusedDiffWave's residual stack on ``diffwave_stack_reference``."""
    from sddm_tpu_torch.models import diffwave_fused
    from sddm_tpu_torch.ops.diffwave_stack import diffwave_stack_reference

    return routed(diffwave_fused, "diffwave_stack", diffwave_stack_reference)


def bf16_ulp(v: float) -> float:
    """The spacing of bfloat16 values at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def is_nchw_kernel(name: str) -> bool:
    """Whether the profiler's kernel ``name`` is the NCHW kernel of
    csrc/gn_silu.cu: every instantiation has ``gn_silu`` in its name (and
    the backward's kernels ``gn_silu_bwd``)."""
    return "gn_silu" in name and NHWC_KERNEL not in name and BWD_KERNEL not in name


def nchw_plan_text(p) -> str:
    """One NCHW plan (ops/gn_silu.py::nchw_plan or nchw_backward_plan) as
    phases 2, 3, 7 and 23 print it."""
    return (f"q={p.q} CTAs={p.grid} threads={p.threads} packs={p.packs} runs/CTA={p.runs} "
            f"smem={p.smem} reread={p.reread}/{p.slice}")


def differences(got, want):
    """(max |d|, relative L2) of ``got`` against ``want``."""
    d = got.float() - want.float()
    return float(d.abs().max()), float(d.norm() / want.float().norm())


def clips(n: int, length: int):
    """Seeded voiced clips ``[n, 1, length]`` at 16 kHz: harmonic tones with
    a drifting pitch under a syllable-rate envelope, plus a little noise."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    t = np.arange(length) / 16000.0
    out = np.zeros((n, 1, length), np.float32)
    for i in range(n):
        f0 = rng.uniform(90, 260) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
        phase = 2 * np.pi * np.cumsum(f0) / 16000.0
        voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)))
        out[i, 0] = 0.15 * env * voiced + 0.003 * rng.standard_normal(length)
    return out


def stack_inputs(fused, spec, x_t, t_step: float, dtype):
    """The six inputs of ``diffwave_stack`` in the served engine at ``dtype``:
    the checkpoint's stacked weights, the stem of ``x_t``, the conditioner
    stack of the spectrogram ``spec`` and the embedding of step ``t_step``."""
    import torch

    net = fused.net
    served = net.dtype
    net.dtype = dtype
    try:
        with torch.no_grad():
            prep = fused.prepare()
            cond_l = fused.prepare_condition(prep, spec, x_t.shape[-1])["cond_l"]
            x0 = net.stem(x_t).transpose(1, 2).contiguous()
            t = torch.full((x_t.shape[0],), t_step, device=x_t.device)
            emb512 = net.diffusion_embedding(t.to(dtype))
            emb_d = torch.einsum("be,lec->lbc", emb512, prep["wemb"]) + prep["bemb"][:, None, :]
    finally:
        net.dtype = served
    return [x0, cond_l, emb_d.contiguous(), prep["wconv"], prep["wrs"], prep["brs"]]


def stack_bound(args):
    """(bound ms, "bytes" or "operations", bytes, operations) of one stack
    call: each input read once and the skip sum written once at 3.35 TB/s,
    against 2 B T L (3 C 2C + C 2C) operations at the peak of their type."""
    import torch

    x0, wconv = args[0], args[3]
    B, T, C = x0.shape
    L = wconv.shape[0]
    n_bytes = sum(a.numel() * a.element_size() for a in args) + x0.numel() * x0.element_size()
    ops = 2 * B * T * L * (3 * C * 2 * C + C * 2 * C)
    peak = BF16_OPS_PER_S if x0.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops


def stack_floor(args):
    """(floor ms, bytes) of one stack call in any design that launches once
    per layer: every layer reads cond_l and x and writes the skip sum, every
    layer but the first reads the skip sum and every layer but the last
    writes x, each at 3.35 TB/s."""
    x0, cond = args[0], args[1]
    L = cond.shape[0]
    row = x0.numel() * x0.element_size()  # one [B, T, C] array
    n_bytes = L * (cond[0].numel() * cond.element_size() + 2 * row) + (L - 1) * 2 * row
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes


def sass_counts(library) -> dict:
    """Counts of the wgmma, TMA load, TMA store and bulk copy instructions in
    the SASS of a built library (``cuobjdump`` beside ``nvcc``)."""
    from sddm_tpu_torch.ops.cuda_build import nvcc

    tool = Path(nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-sass", str(library)], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump failed on {library}: {out.stderr.strip()[:500]}")
    return {op: out.stdout.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP")}


def cudnn_stack(x0, cond, emb_d, wconv, wrs, brs, cycle: int):
    """The same layers as unfused PyTorch calls in DiffWave's NCL layout: the
    dilated and 1x1 convolutions through cuDNN ``conv1d``, the gate and the
    updates as elementwise kernels (``cond`` as ``[L, B, 2C, T]``, weights as
    ``conv1d`` takes them).  The timing yardstick of phase 18."""
    import torch
    import torch.nn.functional as F

    C = x0.shape[1]
    x, skip = x0, None
    for l in range(wconv.shape[0]):
        d = 1 << (l % cycle)
        y = F.conv1d(x + emb_d[l][:, :, None], wconv[l], padding=d, dilation=d) + cond[l]
        g = torch.sigmoid(y[:, :C]) * torch.tanh(y[:, C:])
        rs = F.conv1d(g, wrs[l], brs[l])
        x = (x + rs[:, :C]) * (1.0 / math.sqrt(2.0))
        skip = rs[:, C:] if skip is None else skip + rs[:, C:]
    return skip


def vocoder_phases(device, dw_built) -> tuple:
    """Phases 14-19 (the DiffWave vocoder); returns its kernel record and its
    serve record.  A reading over its limit is marked OVER where it is
    printed and fails the run once phase 19 has printed its readings."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch import load_specmodel
    from sddm_tpu_torch.cli import build_arch, build_diffusion
    from sddm_tpu_torch.models import DiffWave, FusedDiffWave
    from sddm_tpu_torch.ops import diffwave_stack as dw_ops
    from sddm_tpu_torch.ops.gn_silu import gn_silu
    from sddm_tpu_torch.utils.profiling import profiled

    stack, reference = dw_ops.diffwave_stack, dw_ops.diffwave_stack_reference

    # -- 14. the build, started in phase 2 ------------------------------------
    log(f"[14] build: {dw_built['path'].name} in {dw_built['seconds']:.2f} s, in parallel "
        f"with gn_silu{' (cached)' if dw_built['cached'] else ''}")
    for line in dw_built["log"].splitlines():
        if any(k in line for k in ("Compiling entry", "Used", "spill", "stack frame", "setmaxnreg",
                                   "wgmma", "GMMA")):
            log(f"    ptxas: {line.strip()}")
    sass = sass_counts(dw_built["path"])
    log(f"    SASS of {dw_built['path'].name}: HGMMA {sass['HGMMA']}, UTMALDG {sass['UTMALDG']}, "
        f"UTMASTG {sass['UTMASTG']}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        fail(f"the stack library issues no wgmma or no TMA load: {sass}")

    # -- 15. kernel vs plain, per call -----------------------------------------
    config = json.loads((VOCODER / "config.json").read_text())
    config["packed"] = True  # the JAX package's switch for the fused engine
    t0 = time.perf_counter()
    model = load_specmodel(VOCODER / "model_best.ckpt", config, steps=DW_STEPS, ddim=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fused = model.network
    if not (isinstance(fused, FusedDiffWave) and fused.net.dtype == torch.bfloat16
            and model.num_timesteps == DW_STEPS and model.p_transition == "ddim"):
        fail("the served vocoder is not the bf16 fused DDIM-6 recipe")
    audio = torch.from_numpy(clips(DW_CLIPS, DW_SAMPLES)).to(device)
    spec = model.feature_fn(audio)  # [8, 513, 64]
    gen = torch.Generator(device=device).manual_seed(SEED)
    x_t = torch.randn((DW_CLIPS, 1, DW_SAMPLES), device=device, generator=gen)
    log(f"[15] diffwave_stack vs diffwave_stack_reference on the checkpoint's stacked "
        f"weights (stem of N(0,1) x_t, features of {DW_CLIPS} seeded clips, step 100)")
    per_call = {}
    over = []  # readings over their limits
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        full = stack_inputs(fused, spec, x_t, 100.0, dtype)
        cases = [("served", full, DW_CYCLE)]
        cases.append(("odd B=3 T=1000 L=7 cycle 3",
                      [a.contiguous() for a in (full[0][:3, :1000], full[1][:7, :3, :1000],
                                                full[2][:7, :3], full[3][:7], full[4][:7],
                                                full[5][:7])], 3))
        cases.append(("L<cycle B=2 T=200 L=9 cycle 10",
                      [a.contiguous() for a in (full[0][:2, :200], full[1][:9, :2, :200],
                                                full[2][:9, :2], full[3][:9], full[4][:9],
                                                full[5][:9])], 10))
        # 16 tiles for 132 blocks, T % 64 = 40, and d = 1..512 on both sides of
        # the switch from one tap window (2d <= 64) to three tap boxes
        cases.append(("B=1 T=1000 L=10 cycle 10",
                      [a.contiguous() for a in (full[0][:1, :1000], full[1][:10, :1, :1000],
                                                full[2][:10, :1], full[3][:10], full[4][:10],
                                                full[5][:10])], 10))
        cases.append(("d>=T B=2 T=100 L=10 cycle 10",
                      [a.contiguous() for a in (full[0][:2, :100], full[1][:10, :2, :100],
                                                full[2][:10, :2], full[3][:10], full[4][:10],
                                                full[5][:10])], 10))
        # T < 64: the 64-row tap box is longer than the row, all taps pad
        cases.append(("T<M B=2 T=40 L=10 cycle 10",
                      [a.contiguous() for a in (full[0][:2, :40], full[1][:10, :2, :40],
                                                full[2][:10, :2], full[3][:10], full[4][:10],
                                                full[5][:10])], 10))
        for label, args, cycle in cases:
            got = stack(*args, cycle=cycle)
            torch.cuda.synchronize()
            want = reference(*args, cycle=cycle)
            if label == "served" and not torch.equal(stack(*args, cycle=cycle), got):
                fail(f"two diffwave_stack calls on the same {name} inputs gave different bits")
            if got.dtype != dtype or got.shape != args[0].shape or not torch.isfinite(got).all():
                fail(f"diffwave_stack output at {label} {name}: {got.dtype} {tuple(got.shape)}")
            err, rel = differences(got, want)
            per_call[(name, label)] = (err, rel)
            scale = float(want.float().abs().max())
            tol_abs, tol_rel = DW_TOL[name]
            if dtype == torch.bfloat16:
                tol_abs *= bf16_ulp(scale)
            ok = err <= tol_abs and rel <= tol_rel
            log(f"    {label:32s} {name:8s} max|d|={err:.3e} rel_l2={rel:.3e} "
                f"(tol {tol_abs:.3g}, {tol_rel}) scale {scale:.3f} {'ok' if ok else 'OVER'}")
            if not ok:
                over.append(f"[15] {label} {name}: max|d| {err}, rel_l2 {rel}")

    # C = 32, the kernel's other build, on seeded weights (no checkpoint has it)
    g32 = torch.Generator(device=device).manual_seed(SEED + 2)
    B32, T32, L32, C32 = 2, 1000, 7, 32
    rand = lambda *shape: torch.randn(shape, device=device, generator=g32)  # noqa: E731
    c32 = [rand(B32, T32, C32).relu() * 0.5, 0.5 * rand(L32, B32, T32, 2 * C32),
           0.2 * rand(L32, B32, C32), rand(L32, 3, C32, 2 * C32) / math.sqrt(3 * C32),
           rand(L32, C32, 2 * C32) / math.sqrt(C32), 0.1 * rand(L32, 1, 2 * C32)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        label = f"C=32 B={B32} T={T32} L={L32} cycle 3"
        args = [a.to(dtype).contiguous() for a in c32]
        got = stack(*args, cycle=3)
        torch.cuda.synchronize()
        want = reference(*args, cycle=3)
        if got.dtype != dtype or got.shape != args[0].shape or not torch.isfinite(got).all():
            fail(f"diffwave_stack output at {label} {name}: {got.dtype} {tuple(got.shape)}")
        err, rel = differences(got, want)
        per_call[(name, label)] = (err, rel)
        scale = float(want.float().abs().max())
        tol_abs, tol_rel = DW_TOL[name]
        if dtype == torch.bfloat16:
            tol_abs *= bf16_ulp(scale)
        ok = err <= tol_abs and rel <= tol_rel
        log(f"    {label:32s} {name:8s} max|d|={err:.3e} rel_l2={rel:.3e} "
            f"(tol {tol_abs:.3g}, {tol_rel}) scale {scale:.3f} {'ok' if ok else 'OVER'}")
        if not ok:
            over.append(f"[15] {label} {name}: max|d| {err}, rel_l2 {rel}")

    log("    served shape, bfloat16 and float32: two calls on the same inputs gave the same bits")
    del full, cases, args, got, want, c32  # phase 18 makes its inputs again

    # -- 16. serve -------------------------------------------------------------
    def serve(m, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = m.infer(audio, g)
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    _, warm_s = serve(model, SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    gn_silu.launches = 0
    stack.launches = stack.layer_launches = 0
    out, serve_s = serve(model, SEED)
    calls, layers, gn_calls = stack.launches, stack.layer_launches, gn_silu.launches
    peak = torch.cuda.max_memory_allocated()
    audio_s = DW_CLIPS * DW_SAMPLES / config["sample_rate"]
    log(f"[16] load_specmodel(steps={DW_STEPS}, ddim=True, packed) {load_s:.2f} s; served "
        f"{DW_CLIPS} x {DW_SAMPLES} samples ({audio_s:.2f} s of audio) from a "
        f"{list(spec.shape)} condition: warm-up {warm_s:.3f} s, timed "
        f"{serve_s:.4f} s (RTF {serve_s / audio_s:.5f}); diffwave_stack calls {calls}, layer "
        f"launches {layers}, gn_silu launches {gn_calls}; peak {peak / 2**20:.1f} MiB")
    if tuple(out.shape) != (DW_CLIPS, 1, DW_SAMPLES) or not torch.isfinite(out).all():
        fail(f"served vocoder output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    if calls != DW_STEPS or layers != DW_STEPS * DW_LAYERS:
        fail(f"diffwave_stack ran {calls} calls and {layers} layer launches, expected "
             f"{DW_STEPS} and {DW_STEPS * DW_LAYERS}")

    # -- 17. the same batch through the plain stack ------------------------------
    net = fused.net
    e2e = {}
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        net.dtype = dtype
        kernel_out, kernel_s = out, serve_s
        if dtype != torch.bfloat16:
            serve(model, SEED + 1)
            kernel_out, kernel_s = serve(model, SEED)
        with plain_diffwave_stack():
            plain_out, plain_s = serve(model, SEED)
        outs[name] = kernel_out, plain_out
        err, rel = differences(kernel_out, plain_out)
        e2e[name] = {"max_abs": err, "rel_l2": rel, "kernel_s": kernel_s, "plain_s": plain_s}
        tol_abs, tol_rel = DW_E2E_TOL[name]
        ok = err <= tol_abs and rel <= tol_rel
        log(f"[17] {name}: kernel path vs plain path, same weights and noise: max|d|={err:.3e} "
            f"rel_l2={rel:.3e} (tol {tol_abs}, {tol_rel}) {'ok' if ok else 'OVER'}; serve "
            f"{kernel_s:.4f} s vs {plain_s:.4f} s")
        if not ok:
            over.append(f"[17] served {name}: max|d| {err}, rel_l2 {rel}")
    net.dtype = torch.bfloat16
    bf16_vs_f32 = {"kernel": differences(outs["bfloat16"][0], outs["float32"][1]),
                   "plain": differences(outs["bfloat16"][1], outs["float32"][1])}
    log(f"     bf16 vs the f32 plain path (max|d|, rel_l2): kernel path "
        f"{bf16_vs_f32['kernel'][0]:.3e}, {bf16_vs_f32['kernel'][1]:.3e}; plain path "
        f"{bf16_vs_f32['plain'][0]:.3e}, {bf16_vs_f32['plain'][1]:.3e}")
    del outs
    n_short = 4096
    spec_short = model.feature_fn(audio[:1, :, :n_short])
    xs = x_t[:1, :, :n_short]
    level = torch.full((1, 1, 1), 57.0, device=device)
    net.dtype = torch.float32
    with torch.no_grad():
        on_card = fused(spec_short, xs, level)
        cpu_net = DiffWave(freq_bins=spec.shape[1], **config["network"]["args"]).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        on_cpu = cpu_net(spec_short.cpu(), xs.cpu(), level.cpu())
    net.dtype = torch.bfloat16
    card_cpu_err = float((on_card.cpu() - on_cpu).abs().max())
    log(f"     float32 forward [1, 1, {n_short}], card (kernel) vs CPU (plain DiffWave): "
        f"max|d|={card_cpu_err:.3e} (tol {DW_CARD_VS_CPU_TOL})")
    if not card_cpu_err <= DW_CARD_VS_CPU_TOL:
        over.append(f"[17] card vs CPU float32 forward: max|d| {card_cpu_err}")

    # -- 18. times ----------------------------------------------------------------
    args = stack_inputs(fused, spec, x_t, 100.0, torch.bfloat16)
    bound_ms, bound_by, n_bytes, n_ops = stack_bound(args)
    floor_ms, floor_bytes = stack_floor(args)
    x0, cond, emb_d, wconv, wrs, brs = args
    cudnn_args = (x0.transpose(1, 2).contiguous(), cond.transpose(2, 3).contiguous(),
                  emb_d, wconv.permute(0, 3, 2, 1).contiguous(),
                  wrs.transpose(1, 2)[..., None].contiguous(), brs[:, 0].contiguous())
    with torch.no_grad():
        cudnn_err, cudnn_rel = differences(cudnn_stack(*cudnn_args, DW_CYCLE).transpose(1, 2),
                                           reference(*args, cycle=DW_CYCLE))
    kernel_ms = cuda_time_ms(lambda: stack(*args, cycle=DW_CYCLE), iters=20, warmup=3)
    plain_ms = cuda_time_ms(lambda: reference(*args, cycle=DW_CYCLE), iters=5, warmup=2)
    cudnn_ms = cuda_time_ms(lambda: cudnn_stack(*cudnn_args, DW_CYCLE), iters=10, warmup=3)
    kernel_ms2 = cuda_time_ms(lambda: stack(*args, cycle=DW_CYCLE), iters=20, warmup=3)
    del cudnn_args
    args32 = stack_inputs(fused, spec, x_t, 100.0, torch.float32)
    bound32_ms, bound32_by, _, _ = stack_bound(args32)
    f32_ms = cuda_time_ms(lambda: stack(*args32, cycle=DW_CYCLE), iters=5, warmup=2)
    log(f"[18] diffwave_stack [{DW_CLIPS},{DW_SAMPLES},64] L={DW_LAYERS} bf16: kernel "
        f"{kernel_ms:.3f} / {kernel_ms2:.3f} ms, plain {plain_ms:.3f} ms, cuDNN conv1d stack "
        f"{cudnn_ms:.3f} ms (vs plain max|d| {cudnn_err:.3e}, rel_l2 {cudnn_rel:.3e}); bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes} B at 3.35 TB/s, {n_ops:.4g} ops at 989 "
        f"TFLOP/s); {n_bytes / kernel_ms / 1e6:.0f} GB/s, {n_ops / kernel_ms / 1e9:.1f} TFLOP/s; "
        f"f32 kernel {f32_ms:.3f} ms (bound {bound32_ms:.3f} ms, {bound32_by})")
    log(f"     per-layer floor {floor_ms:.4f} ms ({floor_bytes} B: cond, x and the skip sum "
        f"through memory once a layer) beside the {bound_ms:.4f} ms bound; kernel "
        f"{kernel_ms / DW_LAYERS * 1e3:.1f} us a layer, {floor_bytes / kernel_ms / 1e6:.0f} GB/s "
        f"on the floor's bytes ({floor_ms / kernel_ms:.3f} of the floor, "
        f"{bound_ms / kernel_ms:.3f} of the bound)")
    ancestral = build_arch(config, build_diffusion(config), fused, hop_samples=model.hop_samples,
                           feature_fn=model.feature_fn)
    stack.launches = stack.layer_launches = 0
    _, anc_s = serve(ancestral, SEED)
    anc_layers = stack.layer_launches
    log(f"     served batch: DDIM-{DW_STEPS} {serve_s:.4f} s (RTF {serve_s / audio_s:.5f}), "
        f"ancestral T={ancestral.num_timesteps} {anc_s:.3f} s (RTF {anc_s / audio_s:.5f}, "
        f"{anc_layers} layer launches); peak {peak / 2**20:.1f} MiB (DDIM-{DW_STEPS})")
    if anc_layers != DW_ANCESTRAL * DW_LAYERS:
        fail(f"the ancestral serve ran {anc_layers} layer launches")

    # -- 19. profile one DDIM-6 served batch --------------------------------------
    torch.cuda.synchronize()
    stack.layer_launches = 0
    with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        start = time.perf_counter()
        model.infer(audio, torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - start) * 1e3
    profiled_layers = stack.layer_launches
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in device_events}
    busy_ms = sum(busy.values())
    stack_ms = sum(v for k, v in busy.items() if any(n in k for n in STACK_KERNELS))
    idle_share = 1 - busy_ms / (serve_s * 1e3)
    if busy_ms > 0:
        log(f"[19] profiled DDIM-{DW_STEPS} serve: device busy {busy_ms:.2f} ms, idle share "
            f"{idle_share:.3f} of the unprofiled serve ({serve_s * 1e3:.2f} ms, phase 16); "
            f"{1 - busy_ms / prof_wall_ms:.3f} of the profiled wall ({prof_wall_ms:.2f} ms); "
            f"diffwave_stack layers {stack_ms:.2f} ms ({stack_ms / busy_ms:.3f} of busy)")
        for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
            n_calls = next(e.count for e in device_events if e.key == key)
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{n_calls:<5d} {key[:90]}")
    else:
        log("[19] the profiler saw no device time: breakdown not measured")
    if profiled_layers > 0 and stack_ms == 0:
        fail(f"the profiled serve ran {profiled_layers} stack layer launches, but no device time "
             f"under the stack's kernel names {STACK_KERNELS}")
    if over:
        fail(f"readings over their limits: {over}")

    kernel_record = {
        "name": "diffwave_stack",
        "route": "cuda",
        "source": "sddm_tpu_torch/csrc/diffwave_stack.cu",
        "replaces": "sddm_tpu/ops/pallas/diffwave_stack.py:183",
        "launches": layers,
        "stack_calls": calls,
        "max_abs_err": per_call[("bfloat16", "served")][0],
        "rel_l2": per_call[("bfloat16", "served")][1],
        "max_abs_err_f32": per_call[("float32", "served")][0],
        "per_call": {f"{k[0]} {k[1]}": v for k, v in per_call.items()},
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "cudnn_conv1d_stack_ms": cudnn_ms,
        "f32_ms": f32_ms,
        "f32_bound_ms": bound32_ms,
        "shape": list(x0.shape) + [DW_LAYERS],
        "dtype": "bfloat16",
        "sass": sass,
    }
    serve_record = {
        "clips": DW_CLIPS, "samples": DW_SAMPLES, "steps": DW_STEPS, "seconds": serve_s,
        "audio_seconds": audio_s, "rtf": serve_s / audio_s, "ancestral_seconds": anc_s,
        "ancestral_steps": DW_ANCESTRAL, "peak_bytes": peak, "e2e": e2e,
        "bf16_vs_f32_plain": bf16_vs_f32, "card_vs_cpu_f32": card_cpu_err, "load_seconds": load_s,
        "profile": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                    "idle_share": idle_share, "diffwave_stack_ms": stack_ms},
    }
    return kernel_record, serve_record


def serve_requests(enh, audios, seed: int, device):
    """One ``enhance_batch`` of ``audios`` with the sampler's generator seeded
    ``seed``: (outputs, wall seconds, ending in a device synchronise)."""
    import torch

    enh.generator = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = enh.enhance_batch(audios)
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def served_differences(got, want):
    """(max |d|, relative L2) over lists of served waveforms."""
    import numpy as np

    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    rel = math.sqrt(sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
                    / sum(float(np.sum(w**2)) for w in want))
    return err, rel


def gn_bound(x, param_bytes: int):
    """(bound ms, "bytes" or "operations", bytes) of one GroupNorm+SiLU call on
    ``x``: x read once and y written once at 3.35 TB/s, plus ``param_bytes``
    (the f32 affine; the int32 group map in NHWC), against about ten f32
    operations per element (sums, affine, SiLU)."""
    n_bytes = 2 * x.numel() * x.element_size() + param_bytes
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 10 * x.numel() / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes


def packed_sites(engine, num_samples: int, device):
    """[(the _GN module, (H, W, C4))] of one packed forward, in call order."""
    import torch

    from sddm_tpu_torch.models.unet_packed import _GN

    sites = []
    hooks = [m.register_forward_pre_hook(lambda m, a: sites.append((m, tuple(a[0].shape[1:]))))
             for m in engine.modules() if isinstance(m, _GN)]
    with torch.no_grad(), plain_gn_silu_nhwc():
        z = torch.zeros(1, 1, num_samples, device=device)
        engine(z, z, torch.ones(1, 1, 1, device=device))
    for h in hooks:
        h.remove()
    return sites


def net_sites(network, num_samples: int, device):
    """[((C, H, W), G)] of one forward of the plain network, in call order."""
    import torch

    from sddm_tpu_torch.models.blocks import GroupNormSiLU

    sites = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: sites.append((tuple(a[0].shape[1:]), m.num_groups)))
        for m in network.modules() if isinstance(m, GroupNormSiLU)]
    with torch.no_grad(), plain_gn_silu():
        z = torch.zeros(1, 1, num_samples, device=device)
        network(z, z, torch.ones(1, 1, 1, device=device))
    for h in hooks:
        h.remove()
    return sites


def check_nchw(shape, g: int, spread: float, gen, sms: int):
    """``gn_silu`` at one NCHW shape on seeded x, scale and bias (spread < 1:
    near-constant groups at 1000, where finite is the check), in float32 and
    bfloat16: the output's dtype, shape and finiteness, each call repeated
    bit for bit, and the output held against ``gn_silu_reference`` at
    ``TOL``.  Returns [(dtype name, ok, max |d|, the call's plan as text)]."""
    import torch

    from sddm_tpu_torch.ops.gn_silu import gn_silu, gn_silu_reference, nchw_plan

    device, c = gen.device, shape[1]
    w = (1 + 0.5 * torch.randn(c, device=device, generator=gen)).contiguous()
    b = (0.2 * torch.randn(c, device=device, generator=gen)).contiguous()
    x32 = torch.randn(shape, device=device, generator=gen) * 2 * spread
    x32 += (1000.0 if spread < 1 else 0.3) + 0.5 * torch.randn(
        (1, c, 1, 1), device=device, generator=gen)
    readings = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = x32.to(dtype).contiguous()
        got = gn_silu(x, w, b, g)
        want = gn_silu_reference(x, w, b, g)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != x.shape or not torch.isfinite(got).all():
            fail(f"kernel output at {shape} {dtype_name}: dtype {got.dtype}, "
                 f"finite {bool(torch.isfinite(got).all())}")
        if not torch.equal(gn_silu(x, w, b, g), got):
            fail(f"gn_silu is not deterministic at {shape} {dtype_name}")
        if spread < 1:  # the clamp case: finite is the check
            continue
        ok, err = close_enough(got, want, *TOL[dtype_name])
        hw, elem = shape[2] * shape[3], x.element_size()
        plan = nchw_plan(shape[0], c, hw, g, elem, hw % (16 // elem) == 0, sms)
        readings.append((dtype_name, ok, err, nchw_plan_text(plan)))
    return readings


def check_nhwc(shape, groups: int, group_of, count: int, offset: bool, spread: float, gen,
               sms: int):
    """``gn_silu_nhwc`` at one packed shape, as ``check_nchw`` checks
    ``gn_silu``: seeded x (zeroed outside the offset grid at offset sites, as
    the engine zeroes it), float32 and bfloat16, each call repeated bit for
    bit, held against ``gn_silu_nhwc_reference`` at ``TOL``.  Returns
    [(dtype name, ok, max |d|, the call's ``nhwc_plan``)]."""
    import torch

    from sddm_tpu_torch.ops.gn_silu import gn_silu_nhwc, gn_silu_nhwc_reference, nhwc_plan
    from sddm_tpu_torch.ops.packed import offset_mask

    device, c4 = gen.device, shape[-1]
    sc = (1 + 0.5 * torch.randn(c4, device=device, generator=gen)).contiguous()
    bi = (0.2 * torch.randn(c4, device=device, generator=gen)).contiguous()
    x32 = torch.randn(shape, device=device, generator=gen) * 2 * spread
    x32 += (1000.0 if spread < 1 else 0.3) + 0.5 * torch.randn(c4, device=device, generator=gen)
    if offset:  # the engine zeroes the out-of-range rows/cols before the GN
        x32 *= torch.from_numpy(offset_mask(shape[1], shape[2], c4 // 4)).to(device)
    readings = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = x32.to(dtype).contiguous()
        got = gn_silu_nhwc(x, sc, bi, group_of, groups, count, offset)
        torch.cuda.synchronize()
        want = gn_silu_nhwc_reference(x, sc, bi, group_of, groups, count, offset)
        if got.dtype != dtype or got.shape != x.shape or not torch.isfinite(got).all():
            fail(f"gn_silu_nhwc output at {shape} {dtype_name}: dtype {got.dtype}, "
                 f"finite {bool(torch.isfinite(got).all())}")
        if not torch.equal(gn_silu_nhwc(x, sc, bi, group_of, groups, count, offset), got):
            fail(f"gn_silu_nhwc is not deterministic at {shape} {dtype_name}")
        if spread < 1:  # the clamp case: finite is the check
            continue
        ok, err = close_enough(got, want, *TOL[dtype_name])
        plan = nhwc_plan(*shape, groups, x.element_size(),
                         c4 % (16 // x.element_size()) == 0, sms)
        readings.append((dtype_name, ok, err, plan))
    return readings


def hold_served_rows(phase: str, name: str, row_counts, checks) -> dict:
    """A kernel held against its plain version at the shapes a CLI run gave
    it: ``checks(rows)`` yields (shape, ``check_nchw``/``check_nhwc``
    readings) for every site at ``rows`` batch rows, and is called for each
    row count of the run's sampler calls.  One line a row count; fails on a
    reading over ``TOL``.  Returns {dtype name: max |d|}."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for rows in sorted(set(row_counts)):
        seen, n_sites = {"float32": 0.0, "bfloat16": 0.0}, 0
        for shape, readings in checks(rows):
            n_sites += 1
            for dtype_name, ok, err, _plan in readings:
                seen[dtype_name] = max(seen[dtype_name], err)
                if not ok:
                    fail(f"[{phase}] {name} disagrees with its plain version at the served "
                         f"shape {shape} {dtype_name}: max|d| {err} (atol, rtol "
                         f"{TOL[dtype_name]})")
        log(f"    {name} vs its plain version at the {n_sites} sites with {rows} rows: max|d| "
            f"f32 {seen['float32']:.3e}, bf16 {seen['bfloat16']:.3e} (atol, rtol {TOL}) ok; "
            "every call repeated bit for bit")
        worst = {k: max(worst[k], seen[k]) for k in worst}
    return worst


def packed_phases(device, config, net_args, audios, plain_enh, gen) -> tuple:
    """Phases 9-13 (the packed engine, ``load_enhancer``'s default); returns
    its kernel record and its serve record.  A reading over its limit is
    marked OVER where it is printed and fails the run once phase 13 has
    printed its readings."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch import PackedUNetModified2, load_enhancer
    from sddm_tpu_torch.models import UNetModified2
    from sddm_tpu_torch.models.unet_packed import _packed_gn_plan
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_nhwc,
        gn_silu_nhwc_reference,
        nhwc_plan,
    )
    from sddm_tpu_torch.ops.packed import offset_mask
    from sddm_tpu_torch.utils.profiling import profiled

    def mask(h, w, c4, dtype=torch.float32):
        return torch.from_numpy(offset_mask(h, w, c4 // 4)).to(device, dtype)

    n = config["num_samples"]
    # -- 9. load_enhancer's default, the packed engine; its kernel at every site --
    t0 = time.perf_counter()
    enh = load_enhancer(RUN / "model_best.ckpt", config, batch_rows=BATCH_ROWS, steps=STEPS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = enh.model.network
    if not isinstance(eng, PackedUNetModified2):
        fail(f"load_enhancer served {type(eng).__name__}, not PackedUNetModified2 "
             f"(fallback: {enh.engine_fallback})")
    if enh.model.num_timesteps != STEPS or eng.net.dtype != torch.bfloat16:
        fail("the packed model is not the bf16 ancestral-12 recipe")
    valid = enh.validate()
    if not valid:
        fail("Enhancer.validate() of the packed engine returned False")
    sites = packed_sites(eng, n, device)
    n_offset = sum(m.offset for m, _ in sites)
    if (len(sites), n_offset) != (PACKED_SITES, OFFSET_SITES):
        fail(f"expected {PACKED_SITES} packed GroupNorm sites ({OFFSET_SITES} offset), found "
             f"{len(sites)} ({n_offset})")
    log(f"[9] load_enhancer(steps={STEPS}) -> {type(eng).__name__} in {load_s:.2f} s "
        f"(packing and the canary included), validate() {valid}; {len(sites)} packed "
        f"GroupNorm+SiLU sites per forward ({n_offset} offset); gn_silu_nhwc vs "
        f"gn_silu_nhwc_reference at batch {BATCH_ROWS}")

    def plan(c4, groups, sections):
        if sections is None:  # identity: the unpacked sites
            return torch.arange(c4) // (c4 // groups), c4 // groups
        _, group_of, count = _packed_gn_plan(groups, sections)
        return torch.as_tensor(group_of), count

    cases = [((BATCH_ROWS,) + hwc, m.groups, m.group_of, m.count, m.offset, 1.0, "site")
             for m, hwc in sites]
    for shape, groups, sections, offset, label in (
            ((2, 9, 5, 32), 4, (8,), True, "TestGnSilu"),
            ((2, 17, 9, 64), 8, (16,), False, "TestGnSilu"),
            ((2, 13, 7, 32), 4, (8,), True, "TestGnSilu"),
            ((3, 11, 7, 36), 3, (9,), True, "odd: C4 % 8, H*W = 77"),
            ((3, 5, 7, 30), 5, None, False, "odd: C4 % 4, identity"),
            ((2, 16, 8, 64), 4, (16,), False, "near-constant"),
            ((1, 128, 64, 256), 32, (64,), False, "B = 1"),
            ((200, 8, 4, 160), 32, None, False, "B = 200: items loop"),
            ((200, 9, 5, 128), 32, (32,), True, "B = 200: items loop"),
            ((32, 128, 64, 256), 32, (64,), False, "largest site, B = 32"),
            ((2, 129, 65, 128), 32, (32,), True, "ranges start mid-row")):
        group_of, count = plan(shape[-1], groups, sections)
        cases.append((shape, groups, group_of.to(torch.int32).to(device), count, offset,
                      1e-3 if label == "near-constant" else 1.0, label))
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for shape, groups, group_of, count, offset, spread, label in cases:
        if label == "ranges start mid-row":
            p = nhwc_plan(*shape, groups, 2, True, sms)
            if all(i * p.rows % shape[2] == 0 for i in range(1, p.k)):
                fail(f"no range of the plan {p} starts mid-row at {shape}")
        for dtype_name, ok, err, p in check_nhwc(shape, groups, group_of, count, offset,
                                                 spread, gen, sms):
            max_err[dtype_name] = max(max_err[dtype_name], err)
            log(f"    {label:22s} {str(shape):20s} G={groups:<3d} count={count:<3d} "
                f"{'offset' if offset else 'plain ':6s} {dtype_name:8s} max|d|={err:.3e} "
                f"{'ok' if ok else 'OVER'}  K={p.k} grid={p.grid}x{p.per_block} staged "
                f"{p.staged}/{p.rows}")
            if not ok:
                fail(f"gn_silu_nhwc disagrees with its plain version at {shape} {dtype_name}")
    log(f"    near-constant groups finite; every call repeated bit for bit; max|d| f32 "
        f"{max_err['float32']:.3e}, bf16 {max_err['bfloat16']:.3e} (atol, rtol {TOL})")

    # -- 10. serve through the packed engine ------------------------------------
    n_rows = sum(math.ceil(a.size / n) for a in audios)
    n_batches = math.ceil(n_rows / BATCH_ROWS)
    audio_s = sum(a.size for a in audios) / config["sample_rate"]
    _, warm_s = serve_requests(enh, audios, SEED + 1, device)
    torch.cuda.reset_peak_memory_stats()
    gn_silu.launches = gn_silu_nhwc.launches = 0
    served, serve_s = serve_requests(enh, audios, SEED, device)
    launches, nchw_launches = gn_silu_nhwc.launches, gn_silu.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[10] {type(eng).__name__} served {len(audios)} requests: warm-up {warm_s:.3f} s, timed {serve_s:.3f} s (RTF {serve_s / audio_s:.4f}), "
        f"gn_silu_nhwc.launches {launches}, gn_silu.launches {nchw_launches}, peak "
        f"{peak / 2**20:.1f} MiB")
    for a, y in zip(audios, served):
        if y.shape != a.shape or not np.isfinite(y).all() or np.abs(y).max() > 1.0:
            fail(f"packed served output shape {y.shape} for input {a.shape}, "
                 f"finite {np.isfinite(y).all()}")
    expected = PACKED_SITES * STEPS * n_batches
    if launches != expected or nchw_launches != 0:
        fail(f"gn_silu_nhwc.launches = {launches}, expected {expected} ({PACKED_SITES} sites x "
             f"{STEPS} steps x {n_batches} batches); gn_silu.launches = {nchw_launches}, "
             "expected 0")

    # -- 11. the same requests through the plain NHWC version; the two engines ---
    over = []
    e2e = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        eng.net.dtype = dtype
        kernel_out, kernel_s = served, serve_s
        if dtype != torch.bfloat16:
            serve_requests(enh, audios, SEED + 1, device)  # cuDNN picks its f32 algorithms
            kernel_out, kernel_s = serve_requests(enh, audios, SEED, device)
        with plain_gn_silu_nhwc():
            plain_out, plain_s = serve_requests(enh, audios, SEED, device)
        err, rel = served_differences(kernel_out, plain_out)
        e2e[name] = {"max_abs": err, "rel_l2": rel, "kernel_s": kernel_s, "plain_s": plain_s}
        tol_abs, tol_rel = PACKED_E2E_TOL[name]
        ok = err <= tol_abs and rel <= tol_rel
        log(f"[11] {name}: packed engine, kernel path vs plain path, same weights and noise: "
            f"max|d|={err:.3e} (tol {tol_abs}) rel_l2={rel:.3e} (tol {tol_rel}) "
            f"{'ok' if ok else 'OVER'}; serve {kernel_s:.3f} s vs {plain_s:.3f} s")
        if not ok:
            over.append(f"[11] served {name}: max|d| {err}, rel_l2 {rel}")
    packed_f32 = kernel_out  # the float32 kernel path of the loop's last turn
    plain_net = plain_enh.model.network
    plain_net.dtype = torch.float32
    serve_requests(plain_enh, audios, SEED + 1, device)
    plain_f32, _ = serve_requests(plain_enh, audios, SEED, device)
    plain_net.dtype = eng.net.dtype = torch.bfloat16
    engines = served_differences(packed_f32, plain_f32)
    ok = engines[0] <= ENGINES_F32_TOL[0] and engines[1] <= ENGINES_F32_TOL[1]
    log(f"     float32, TF32 off: packed engine vs plain engine (NCHW, gn_silu), same weights "
        f"and noise: max|d|={engines[0]:.3e} rel_l2={engines[1]:.3e} (tol {ENGINES_F32_TOL}) "
        f"{'ok' if ok else 'OVER'}")
    if not ok:
        over.append(f"[11] packed vs plain engine f32: {engines}")
    rng = np.random.default_rng(SEED)
    cond = (0.1 * rng.standard_normal((1, 1, n))).astype(np.float32)
    x_t = (0.8 * cond + 0.3 * rng.standard_normal((1, 1, n))).astype(np.float32)
    level = np.full((1, 1, 1), 0.95, np.float32)
    eng.net.dtype = torch.float32
    with torch.no_grad():
        on_card = eng(*(torch.from_numpy(a).to(device) for a in (cond, x_t, level)))
        cpu_net = UNetModified2(num_samples=n, **net_args).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in eng.net.state_dict().items()})
        on_cpu = cpu_net(*(torch.from_numpy(a) for a in (cond, x_t, level)))
    eng.net.dtype = torch.bfloat16
    card_cpu_err = float((on_card.cpu() - on_cpu).abs().max())
    log(f"     float32 forward, packed engine on the card vs plain network on the CPU: "
        f"max|d|={card_cpu_err:.3e} (tol {CARD_VS_CPU_TOL})")
    if not card_cpu_err <= CARD_VS_CPU_TOL:
        over.append(f"[11] packed card vs CPU float32 forward: {card_cpu_err}")

    # -- 12. times ------------------------------------------------------------------
    plain_sites = [(m, hwc) for m, hwc in sites if not m.offset]
    offset_sites = [(m, hwc) for m, hwc in sites if m.offset]
    timed = {}
    for label, (m, hwc) in (("largest", max(plain_sites, key=lambda s: math.prod(s[1]))),
                            ("largest offset", max(offset_sites, key=lambda s: math.prod(s[1])))):
        shape = (BATCH_ROWS,) + hwc
        x = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
        if m.offset:
            x *= mask(*hwc, dtype=x.dtype)
        sc = (torch.rand(hwc[-1], device=device, generator=gen) + 0.5).contiguous()
        bi = (torch.randn(hwc[-1], device=device, generator=gen) * 0.1).contiguous()
        args = (x, sc, bi, m.group_of, m.groups, m.count, m.offset)
        x_cl = x.permute(0, 3, 1, 2)  # the channels-last NCHW view
        k_ms = cuda_time_ms(lambda: gn_silu_nhwc(*args, order=m.order))
        p_ms = cuda_time_ms(lambda: gn_silu_nhwc_reference(*args), iters=20)
        lib_ms = cuda_time_ms(lambda: F.silu(F.group_norm(x_cl, m.groups, sc.to(x.dtype),
                                                          bi.to(x.dtype), 1e-5)))
        k_ms2 = cuda_time_ms(lambda: gn_silu_nhwc(*args, order=m.order))
        b_ms, b_by, n_bytes = gn_bound(x, 3 * hwc[-1] * 4)
        timed[label] = {"shape": list(shape), "count": m.count, "offset": m.offset,
                        "ms": k_ms, "ms_again": k_ms2, "plain_ms": p_ms, "two_call_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by}
        log(f"[12] {label} site {list(shape)} bf16 G={m.groups} count={m.count}"
            f"{' offset' if m.offset else ''}: kernel {k_ms:.4f} / {k_ms2:.4f} ms, plain "
            f"{p_ms:.4f} ms, F.silu(F.group_norm()) on the channels-last view {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}: {n_bytes} B at 3.35 TB/s); "
            f"{n_bytes / k_ms / 1e6:.0f} GB/s")
    site_ms = []
    for m, hwc in sites:
        x = torch.randn((BATCH_ROWS,) + hwc, device=device, generator=gen).to(torch.bfloat16)
        args = (x, m.scale, m.bias, m.group_of, m.groups, m.count, m.offset)
        site_ms.append((cuda_time_ms(lambda: gn_silu_nhwc(*args, order=m.order), 20),
                        cuda_time_ms(lambda: gn_silu_nhwc_reference(*args), 10, 2),
                        gn_bound(x, 3 * hwc[-1] * 4)[0]))
    per_forward = [sum(t[i] for t in site_ms) for i in (0, 1, 2)]
    device_us = []  # the kernel alone: the profiler's device time a launch, 5 calls a site
    for m, hwc in sites:
        x = torch.randn((BATCH_ROWS,) + hwc, device=device, generator=gen).to(torch.bfloat16)
        args = (x, m.scale, m.bias, m.group_of, m.groups, m.count, m.offset)
        t_us, seen = device_time_us(lambda: gn_silu_nhwc(*args, order=m.order),
                                    lambda key: NHWC_KERNEL in key)
        if not 1 <= seen <= 5:
            fail(f"the profiler saw {seen} launches of {NHWC_KERNEL} for 5 calls at {hwc}")
        plan = nhwc_plan(BATCH_ROWS, *hwc, m.groups, 2, True, sms)
        device_us.append((t_us, hwc, plan, gn_bound(x, 3 * hwc[-1] * 4)[0] * 1e3))
    device_ms = sum(t[0] for t in device_us) / 1e3
    for t_us, hwc, plan, b_us in device_us:
        log(f"       {str(list(hwc)):16s} K={plan.k:<3d} staged {plan.staged:>4d}/{plan.rows:<4d} "
            f"device {t_us:6.1f} us, bound {b_us:6.2f} us")
    reread = [t[0] for t in device_us if t[2].staged < t[2].rows]
    log(f"     all {len(sites)} sites of one batch-{BATCH_ROWS} forward, one at a time: kernel "
        f"{per_forward[0]:.3f} ms, plain {per_forward[1]:.3f} ms, bound {per_forward[2]:.4f} ms "
        f"(largest single site "
        f"{max(t[0] for t in site_ms):.4f} ms, smallest {min(t[0] for t in site_ms):.4f} ms); "
        "library_ms null: F.group_norm computes the function only at identity-plan sites, so "
        "its time is a yardstick of the work, not of the same function")
    log(f"     the same {len(sites)} sites, device time of {NHWC_KERNEL} alone (profiler, 5 "
        f"calls a site): {device_ms:.4f} ms a forward ({device_ms / len(sites) * 1e3:.1f} us a site); "
        f"the {len(reread)} sites that reread what shared memory cannot keep "
        f"{sum(reread) / 1e3:.4f} ms of it")
    ab = {"plain": [], "packed": []}
    for which in ("plain", "packed", "packed", "plain"):
        ab[which].append(serve_requests(plain_enh if which == "plain" else enh, audios, SEED,
                                        device)[1])
    log(f"     served batch at ancestral-{STEPS}, in turns: plain engine "
        f"{ab['plain'][0]:.3f} / {ab['plain'][1]:.3f} s, packed engine {ab['packed'][0]:.3f} / "
        f"{ab['packed'][1]:.3f} s; packed peak {peak / 2**20:.1f} MiB")

    # -- 13. one packed served batch under the profiler -----------------------------
    enh.generator = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        start = time.perf_counter()
        enh.enhance_batch(audios)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - start) * 1e3
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in device_events}
    calls = {e.key: e.count for e in device_events}
    busy_ms = sum(busy.values())
    gn_ms = sum(v for k, v in busy.items() if NHWC_KERNEL in k)
    gn_calls = sum(c for k, c in calls.items() if NHWC_KERNEL in k)
    transposes = sum(c for k, c in calls.items() if "nchwToNhwc" in k or "nhwcToNchw" in k)
    idle_share = 1 - busy_ms / (serve_s * 1e3)
    if busy_ms > 0:
        log(f"[13] profiled packed serve: device busy {busy_ms:.1f} ms, idle share "
            f"{idle_share:.3f} of the unprofiled serve ({serve_s * 1e3:.1f} ms, phase 10); "
            f"{1 - busy_ms / prof_wall_ms:.3f} of the profiled wall ({prof_wall_ms:.1f} ms); "
            f"{NHWC_KERNEL} {gn_ms:.2f} ms ({gn_ms / busy_ms:.3f} of busy, x{gn_calls}, "
            f"{gn_ms / max(gn_calls, 1) * 1e3:.1f} us a call); cuDNN NCHW<->NHWC transpose "
            f"launches {transposes}")
        for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:14]:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{calls[key]:<5d} {key[:90]}")
        if not (gn_ms > 0 and gn_calls == launches):
            fail(f"gn_silu_nhwc launched {launches} times in the served batch, but the profile "
                 f"shows {gn_calls} launches and {gn_ms} ms under {NHWC_KERNEL}")
    else:
        log("[13] the profiler saw no device time: breakdown not measured")
    if over:
        fail(f"readings over their limits: {over}")

    big = timed["largest"]
    kernel_record = {
        "name": "gn_silu_nhwc",
        "route": "cuda",
        "source": "sddm_tpu_torch/csrc/gn_silu.cu",
        "replaces": "sddm_tpu/experimental/pallas_gn_silu.py:142",
        "launches": launches,
        "max_abs_err": max_err["bfloat16"],
        "max_abs_err_f32": max_err["float32"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "two_call_ms": big["two_call_ms"],
        "shape": big["shape"],
        "dtype": "bfloat16",
        "largest_offset_site": timed["largest offset"],
        "sites_per_forward_ms": per_forward[0],
        "sites_per_forward_device_ms": device_ms,
        "plain_sites_per_forward_ms": per_forward[1],
        "bound_sites_per_forward_ms": per_forward[2],
    }
    serve_record = {
        "engine": type(eng).__name__, "requests": len(audios), "rows": n_rows, "steps": STEPS,
        "seconds": serve_s, "audio_seconds": audio_s, "peak_bytes": peak, "load_seconds": load_s,
        "e2e": e2e, "packed_vs_plain_engine_f32": engines, "card_vs_cpu_f32": card_cpu_err,
        "in_turns_seconds": ab,
        "profile": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                    "idle_share": idle_share, "gn_silu_nhwc_ms": gn_ms,
                    "gn_silu_nhwc_profiled_launches": gn_calls,
                    "transpose_launches": transposes},
    }
    return kernel_record, serve_record


def mean_scores(samples) -> dict:
    """{metric: (noisy mean, output mean)} of the per-file vectors that
    ``evaluate`` saved in ``samples``, over ``GATED_METRICS``."""
    import numpy as np

    return {m: (float(np.load(samples / f"noisy_{m}.npy").mean()),
                float(np.load(samples / f"output_{m}.npy").mean())) for m in GATED_METRICS}


def run_infer(argv, seed: int = 0) -> dict:
    """``python -m sddm_tpu_torch.infer`` with ``argv``, run in this process
    so that the kernels' counts can be read, with the sampler's generator
    seeded ``seed``.  Returns evaluate's ``result``, the ``samples`` dir, the
    batch ``rows`` of every sampler call, ``serve_s`` and ``score_s``, and
    the ``network`` the CLI served.  Every sampler output must be finite
    (the WAVs are PCM16, where a NaN no longer shows).  Serve seconds are the
    CLI's wall time without ``evaluate``: the dataset, the checkpoint's load
    and packing, and the sampler over every batch."""
    import torch

    from sddm_tpu_torch import infer as infer_cli
    from sddm_tpu_torch.models.sddm import SDDM

    config, parsed = infer_cli.parse_args(argv)
    rows, scoring, built = [], [], []
    sampler, score, build = SDDM.infer, infer_cli.evaluate, infer_cli.build_model

    def counted_infer(self, condition, *args, **kwargs):
        out = sampler(self, condition, *args, **kwargs)
        if not bool(torch.isfinite(out).all()):
            fail(f"{argv}: sampler call {len(rows)} gave a non-finite output")
        if out.shape != condition.shape:
            fail(f"{argv}: sampler call {len(rows)} gave {tuple(out.shape)} for "
                 f"{tuple(condition.shape)}")
        rows.append(out.shape[0])
        return out

    def timed_evaluate(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = score(*args, **kwargs)
        scoring.append(time.perf_counter() - start)
        return out

    def kept_model(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    start = time.perf_counter()
    with routed(SDDM, "infer", counted_infer), routed(infer_cli, "evaluate", timed_evaluate), \
            routed(infer_cli, "build_model", kept_model):
        result = infer_cli.main(config, continuous=parsed.continuous, num_steps=parsed.steps,
                                ddim_eta=parsed.ddim, seed=seed)
    total = time.perf_counter() - start
    return {"result": result, "samples": config.save_dir / "samples", "rows": rows,
            "serve_s": total - scoring[0], "score_s": scoring[0],
            "network": built[0].network}


def cli_config(work: Path, name: str, data_root: Path, packed: bool,
               dtype: str = "bfloat16") -> Path:
    """The flagship's config for one CLI run, written under ``work``: its
    ``infer_dataset`` on ``data_root``, its run dir under ``work``, and
    ``"packed"`` and ``"dtype"`` set as asked.  (``-c`` overlays the checkpoint's run-dir
    config key by key, so a key left out would keep the run dir's value.)"""
    config = json.loads((RUN / "config.json").read_text())
    config["name"] = name
    config["infer_dataset"]["args"]["data_root"] = str(data_root)
    config["trainer"]["save_dir"] = str(work / "saved")
    config["packed"] = packed
    config["dtype"] = dtype
    path = work / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def file_to_score_phases(work: Path, smi: str, device) -> dict:
    """Phases 20-22: the v1 test split through the port's corpus generator,
    ``infer`` and ``evaluate`` on the card, held against the committed
    ancestral-12 quality table, and each GroupNorm kernel held against its
    plain version at the shapes the CLI gave it.  Returns the kernels'
    launch counts and the record of the phases."""
    import collections
    import os

    import numpy as np
    import torch

    from sddm_tpu_torch import evaluate_results, make_synthetic_corpus
    from sddm_tpu_torch.data import InferDataset
    from sddm_tpu_torch.data.wav_io import save_wav
    from sddm_tpu_torch.evaluate import evaluate
    from sddm_tpu_torch.ops.gn_silu import gn_silu, gn_silu_nhwc

    committed = {m: (np.load(ANC12 / f"noisy_{m}.npy"), np.load(ANC12 / f"output_{m}.npy"))
                 for m in GATED_METRICS}
    checkpoint = RUN / "model_best.ckpt"
    config = json.loads((RUN / "config.json").read_text())
    sr, ns = config["sample_rate"], config["num_samples"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    # -- 20. the corpus, and its noisy side as infer writes it ----------------
    start = time.perf_counter()
    make_synthetic_corpus.main(["--root", str(work / "synth"), "--n-train", "0",
                                "--n-test", str(CORPUS_FILES), "--seed", str(CORPUS_SEED),
                                "--version", str(CORPUS_VERSION)])
    gen_s = time.perf_counter() - start
    test_root = work / "synth" / "test"
    noisy_side = work / "noisy_side"
    dataset = InferDataset(test_root, ".wav", sr, ns)
    (noisy_side / "output").mkdir(parents=True)
    n_rows = 0
    for i in range(len(dataset)):  # padded to whole rows and written as infer writes them
        clean, noisy, _ = dataset[i]
        n_rows += clean.size // ns
        name = f"{dataset.get_name(i)}.wav"
        save_wav(noisy_side / "target" / name, clean.reshape(1, -1), sr)
        save_wav(noisy_side / "condition" / name, noisy.reshape(1, -1), sr)
        os.symlink(noisy_side / "condition" / name, noisy_side / "output" / name)
    start = time.perf_counter()
    scored = evaluate(noisy_side, ".wav", sr, {"pesq_wb", "sisnr", "stoi"})
    noisy_score_s = time.perf_counter() - start
    if not all(m in scored for m in GATED_METRICS):
        fail(f"evaluate reported {sorted(scored)}, not {GATED_METRICS}: the committed table "
             "holds pesq_wb_approx, which evaluate reports only without the C pesq library")
    import scipy

    log(f"[20] corpus: v{CORPUS_VERSION} test split, {len(dataset)} utterances ({n_rows} rows "
        f"of {ns}) at seed {CORPUS_SEED + 1} (make_synthetic_corpus --seed {CORPUS_SEED}) in "
        f"{gen_s:.1f} s (numpy {np.__version__}, scipy {scipy.__version__}); the noisy side "
        f"scored in {noisy_score_s:.1f} s")
    noisy_over, noisy_diffs = [], {}
    for m in GATED_METRICS:
        vec = np.load(noisy_side / f"noisy_{m}.npy")
        want = committed[m][0]
        d = float(vec.mean() - want.mean())
        worst = int(np.abs(vec - want).argmax())
        ok = abs(d) <= NOISY_LIMITS[m]
        noisy_diffs[m] = {"mean": d, "largest_one_file": float(vec[worst] - want[worst])}
        log(f"    noisy {m:15s} mean {vec.mean():.4f}, committed {want.mean():.4f}: "
            f"{d:+.3e} (limit {NOISY_LIMITS[m]}) {'ok' if ok else 'OVER'}; largest one-file "
            f"difference {vec[worst] - want[worst]:+.3e} at u{worst:04d}")
        if not ok:
            noisy_over.append(f"noisy {m} {d:+.4f}")
    if noisy_over:
        fail(f"the regenerated corpus misses the committed noisy means: {noisy_over}")

    def serve_corpus(tag, name, packed, dtype, seed, kernel, other, sites_per_forward):
        """One CLI run over the corpus; its kernel's launches read around it."""
        argv = ["-c", str(cli_config(work, name, test_root, packed, dtype)),
                "-r", str(checkpoint), "--steps", str(STEPS)]
        gn_silu.launches = gn_silu_nhwc.launches = 0
        run = run_infer(argv, seed=seed)
        run["launches"], stray = kernel.launches, other.launches
        rows = run["rows"]
        expected = sites_per_forward * STEPS * len(rows)
        run["means"] = mean_scores(run["samples"])
        engine = "packed" if packed else "plain"
        log(f"{tag} python -m sddm_tpu_torch.infer {' '.join(argv[2:])} ({engine} engine, "
            f"{dtype}, generator seed {seed}): {len(rows)} sampler calls of "
            f"{min(rows)}-{max(rows)} rows ({sum(rows)} rows), {run['launches']} launches "
            f"(expected {sites_per_forward} x {STEPS} x {len(rows)} = {expected}), "
            f"{stray} of the other GroupNorm kernel; serve {run['serve_s']:.1f} s, scoring "
            f"{run['score_s']:.1f} s on {smi}")
        per_call = config["infer_data_loader"]["args"]["batch_size"]
        if len(rows) != math.ceil(CORPUS_FILES / per_call):
            fail(f"the CLI made {len(rows)} sampler calls")
        if sum(rows) != n_rows:
            fail(f"the CLI served {sum(rows)} rows, the corpus has {n_rows}")
        if run["launches"] != expected or stray != 0:
            fail(f"the CLI's kernel launched {run['launches']} times (expected {expected}), "
                 f"the other GroupNorm kernel {stray} (expected 0)")
        return run

    def gate(run, label):
        """The run's output means against the committed table, seed 1 and the
        float32 witness beside them; fails past ``OUTPUT_LIMITS``."""
        over = []
        for m in GATED_METRICS:
            got = run["means"][m][1]
            d = got - float(committed[m][1].mean())
            ok = abs(d) <= OUTPUT_LIMITS[m]
            beside = ", ".join(f"{k}: {r['means'][m][1]:.4f}" for k, r in runs.items()
                               if r is not run)
            log(f"    {label} output {m:15s} mean {got:.4f} ({beside}), committed "
                f"{committed[m][1].mean():.4f} (TPU v5e): {d:+.4f} (limit {OUTPUT_LIMITS[m]}) "
                f"{'ok' if ok else 'OVER'}")
            if not ok:
                over.append(f"{label} output {m} {d:+.4f}")
        if over:
            fail(f"the port's ancestral-12 output means miss the committed table: {over}")

    # -- 21. the flagship through the CLI: ancestral-12, packed engine, bf16 ----
    runs = {}
    for label, seed, dtype in (("seed 0", 0, "bfloat16"), ("seed 1", 1, "bfloat16"),
                               ("float32", 0, "float32")):
        runs[label] = serve_corpus("[21]", f"anc12_{label.replace(' ', '')}", True, dtype,
                                   seed, gn_silu_nhwc, gn_silu, PACKED_SITES)
    if not all(np.array_equal(np.load(runs["seed 0"]["samples"] / f"noisy_{m}.npy"),
                              np.load(noisy_side / f"noisy_{m}.npy")) for m in GATED_METRICS):
        fail("the CLI's noisy vectors differ from phase 20's: target/condition were not "
             "written as phase 20 wrote them")
    gate(runs["seed 0"], "packed")
    gen = torch.Generator(device=device).manual_seed(SEED)
    engine = runs["seed 0"]["network"]
    sites = packed_sites(engine, ns, device)
    nhwc_served = hold_served_rows("21", NHWC_KERNEL, runs["seed 0"]["rows"], lambda rows: (
        ((rows,) + hwc, check_nhwc((rows,) + hwc, m.groups, m.group_of, m.count, m.offset, 1.0,
                                   gen, sms)) for m, hwc in sites))
    for run in runs.values():
        del run["network"]
    del engine, sites

    # -- 22. the plain engine over the same files; evaluate_results --load ------
    plain = serve_corpus("[22]", "anc12_plain", False, "bfloat16", 0, gn_silu, gn_silu_nhwc,
                         SITES_PER_FORWARD)
    paired = float(np.mean(np.load(plain["samples"] / "output_sisnr.npy")
                           - np.load(runs["seed 0"]["samples"] / "output_sisnr.npy")))
    log(f"    plain vs packed engine, the same files and generator seed: paired mean output "
        f"SI-SNR difference {paired:+.4f} dB")
    gate(plain, "plain ")
    distinct = sorted(set(net_sites(plain.pop("network"), ns, device)),
                      key=lambda s: -math.prod(s[0]))
    nchw_served = hold_served_rows("22", "gn_silu_nchw", plain["rows"], lambda rows: (
        ((rows,) + chw, check_nchw((rows,) + chw, g, 1.0, gen, sms)) for chw, g in distinct))
    summary = evaluate_results.main([str(runs["seed 0"]["samples"]), "--load", "--metrics",
                                     *GATED_METRICS])
    for m in GATED_METRICS:
        want = runs["seed 0"]["result"][m]
        if (summary[m]["output_mean"], summary[m]["noisy_mean"]) != (want["output"],
                                                                     want["noisy"]):
            fail(f"evaluate_results --load gave {summary[m]} for {m}, [21]'s evaluate {want}")
    log(f"    python -m sddm_tpu_torch.evaluate_results <[21] samples> --load: the summary "
        f"equals [21]'s evaluate for {', '.join(GATED_METRICS)}")

    def kept(run):
        return {"calls": len(run["rows"]), "rows": sum(run["rows"]),
                "rows_per_call": dict(sorted(collections.Counter(run["rows"]).items())),
                "launches": run["launches"], "serve_s": run["serve_s"],
                "score_s": run["score_s"], "means": run["means"]}

    committed_means = {m: [float(committed[m][0].mean()), float(committed[m][1].mean())]
                       for m in GATED_METRICS}
    record = {
        "corpus": {"files": len(dataset), "rows": n_rows, "seed": CORPUS_SEED + 1,
                   "version": CORPUS_VERSION, "generate_seconds": gen_s,
                   "noisy_score_seconds": noisy_score_s, "numpy": np.__version__,
                   "scipy": scipy.__version__},
        "committed_noisy_output_means": committed_means,
        "noisy_differences": noisy_diffs,
        "anc12": {label: kept(run) for label, run in runs.items()},
        "anc12_plain_engine": {**kept(plain), "paired_sisnr_difference_db": paired},
        "served_shapes_max_abs_err": {NHWC_KERNEL: nhwc_served, "gn_silu_nchw": nchw_served},
        "nvidia_smi": smi,
    }
    return {"nhwc_launches": runs["seed 0"]["launches"], "nchw_launches": plain["launches"],
            "record": record}


def check_backward(shape, g: int, gen, constant: bool = False):
    """``gn_silu_backward`` at one NCHW shape on seeded x, dy, weight and bias
    (``constant``: every element of group 1 is 1000, an exact sum), in
    float32 and bfloat16: the outputs' dtypes, shapes and finiteness, each
    call repeated bit for bit, and dx, dweight, dbias held against
    ``gn_silu_backward_reference`` at ``BWD_REL`` / ``BWD_RTOL``.  Returns
    [(dtype name, ok, {output: max |d| / scale}, max |d| over the outputs, the
    plan the call launched)]."""
    import torch

    from sddm_tpu_torch.ops.gn_silu import (
        backward_plan,
        gn_silu_backward,
        gn_silu_backward_reference,
    )

    device, c = gen.device, shape[1]
    w = (1 + 0.5 * torch.randn(c, device=device, generator=gen)).contiguous()
    b = (0.2 * torch.randn(c, device=device, generator=gen)).contiguous()
    x32 = torch.randn(shape, device=device, generator=gen) * 2 + 0.3 + 0.5 * torch.randn(
        (1, c, 1, 1), device=device, generator=gen)
    if constant:
        cg = c // g
        x32[:, cg:2 * cg] = 1000.0
    dy32 = torch.randn(shape, device=device, generator=gen)
    readings = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x, dy = x32.to(dtype).contiguous(), dy32.to(dtype).contiguous()
        got = gn_silu_backward(x, dy, w, b, g)
        again = gn_silu_backward(x, dy, w, b, g)
        want = gn_silu_backward_reference(x, dy, w, b, g)
        torch.cuda.synchronize()
        kinds = [(t.dtype, tuple(t.shape)) for t in got]
        if kinds != [(dtype, tuple(shape)), (torch.float32, (c,)), (torch.float32, (c,))] or \
                not all(bool(torch.isfinite(t).all()) for t in got):
            fail(f"gn_silu_backward at {shape} {dtype_name}: outputs {kinds}, finite "
                 f"{[bool(torch.isfinite(t).all()) for t in got]}")
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            fail(f"gn_silu_backward is not deterministic at {shape} {dtype_name}")
        ok, errs, max_abs = True, {}, 0.0
        for name, p, q in zip(("dx", "dweight", "dbias"), got, want):
            p, q = p.float(), q.float()
            scale = float(q.abs().max())
            rtol = BWD_RTOL[dtype_name] if name == "dx" else BWD_RTOL["float32"]
            d = (p - q).abs()
            ok &= bool(torch.all(d <= BWD_REL * scale + rtol * q.abs()))
            errs[name] = float(d.max()) / max(scale, 1e-30)
            max_abs = max(max_abs, float(d.max()))
        readings.append((dtype_name, ok, errs, max_abs, backward_plan(x, dy, g)))
    return readings


def is_annotation(event) -> bool:
    """Whether a profiler event is a range a caller marked (the optimizer's
    ``Optimizer.step#...``), which the profiler also lists on the device
    with the span of the kernels inside it, rather than a kernel."""
    return bool(getattr(event, "is_user_annotation", False)) or \
        event.key.startswith(("Optimizer.", "ProfilerStep"))


def gn_bwd_bound(x):
    """(bound ms, "bytes" or "operations", bytes) of one backward call on
    ``x``: x and dy read once and dx written once at 3.35 TB/s (the [C]
    affine and its gradients besides), against about thirty f32 operations
    per element (statistics, y, sigmoid, dz, the sums and dx)."""
    c = x.shape[1]
    n_bytes = 3 * x.numel() * x.element_size() + 4 * c * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 30 * x.numel() / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes


def backward_phase(sites, distinct, gen) -> dict:
    """Phase 23: the backward kernel against its plain backward at every
    GroupNorm site of the flagship's plain network at batch 16 and at the
    edge cases, then its times at the largest site and over a forward's
    sites beside the bound and the two-call yardstick.  Returns the kernel's
    record (without the launches of phase 24)."""
    import torch
    import torch.nn.functional as F

    from sddm_tpu_torch.ops.gn_silu import (
        backward_plan,
        gn_silu_backward,
        gn_silu_backward_reference,
    )

    device = gen.device
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_abs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [((BATCH_ROWS,) + chw, g, False) for chw, g in distinct]
    cases += [((1, 64, 256, 128), 32, False),    # B = 1
              ((2, 16, 8, 8), 4, True),          # a constant group (cg 4)
              ((3, 12, 7, 5), 4, False),         # cg 3, H*W = 35 odd
              ((2, 4, 1024, 2560), 2, False)]    # a 5.2M-element run: over any CTA's shared memory
    log(f"[23] gn_silu_backward (csrc/gn_silu_bwd.cu, {BWD_LAUNCHES_PER_CALL} launch a call) vs "
        f"its plain backward at the {len(distinct)} distinct sites, batch {BATCH_ROWS}, and 4 edge "
        f"cases; |d| <= {BWD_REL} x scale + rtol x |want|, rtol {BWD_RTOL}")
    for shape, g, constant in cases:
        for dtype_name, ok, errs, max_abs, plan in check_backward(shape, g, gen, constant):
            worst[dtype_name] = max(worst[dtype_name], *errs.values())
            worst_abs[dtype_name] = max(worst_abs[dtype_name], max_abs)
            log(f"    {str(shape):22s} G={g:<3d} {dtype_name:8s} max|d|/scale dx {errs['dx']:.2e} "
                f"dweight {errs['dweight']:.2e} dbias {errs['dbias']:.2e} "
                f"{'ok' if ok else 'OVER'}{' constant group' if constant else ''}  "
                f"{nchw_plan_text(plan)}")
            if not ok:
                fail(f"gn_silu_backward disagrees with its plain backward at {shape} {dtype_name}")
    log("    every call repeated bit for bit")

    (c, h, w_), g = distinct[0]
    shape = (BATCH_ROWS, c, h, w_)
    wt = torch.rand(c, device=device, generator=gen) + 0.5
    bt = torch.randn(c, device=device, generator=gen) * 0.1
    timing = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = torch.randn(shape, device=device, generator=gen).to(dtype)
        dy = torch.randn(shape, device=device, generator=gen).to(dtype)
        xr, wr, br = (x.clone().requires_grad_(), wt.to(dtype).requires_grad_(),
                      bt.to(dtype).requires_grad_())
        y = F.silu(F.group_norm(xr, g, wr, br, 1e-5))
        kernel_ms = cuda_time_ms(lambda: gn_silu_backward(x, dy, wt, bt, g), 20)
        plain_ms = cuda_time_ms(lambda: gn_silu_backward_reference(x, dy, wt, bt, g), 10)
        two_call_ms = cuda_time_ms(
            lambda: torch.autograd.grad(y, (xr, wr, br), dy, retain_graph=True), 20)
        kernel_ms2 = cuda_time_ms(lambda: gn_silu_backward(x, dy, wt, bt, g), 20)
        t_us, seen = device_time_us(lambda: gn_silu_backward(x, dy, wt, bt, g),
                                    lambda k: BWD_KERNEL in k)
        if not 1 <= seen <= 5 * BWD_LAUNCHES_PER_CALL:
            fail(f"the profiler saw {seen} launches of the backward kernels for 5 calls")
        bound_ms, bound_by, n_bytes = gn_bwd_bound(x)
        timing[dtype_name] = {"ms": kernel_ms, "ms_again": kernel_ms2, "plain_ms": plain_ms,
                              "two_call_ms": two_call_ms,
                              "device_us": t_us * BWD_LAUNCHES_PER_CALL,
                              "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"    {list(shape)} {dtype_name} G={g}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms "
            f"(device {t_us * BWD_LAUNCHES_PER_CALL:.1f} us a call), plain {plain_ms:.4f} ms, "
            f"autograd of F.silu(F.group_norm) {two_call_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {n_bytes} B at 3.35 TB/s); {n_bytes / kernel_ms / 1e6:.0f} GB/s; "
            f"{nchw_plan_text(backward_plan(x, dy, g))}")
        del y, xr
    site_us, bound_sum = {}, 0.0
    for (cs, hs, ws), gs in distinct:
        xs = torch.randn((BATCH_ROWS, cs, hs, ws), device=device, generator=gen).to(torch.bfloat16)
        dys = torch.randn_like(xs)
        ones, zeros = torch.ones(cs, device=device), torch.zeros(cs, device=device)
        t_us, seen = device_time_us(lambda: gn_silu_backward(xs, dys, ones, zeros, gs),
                                    lambda k: BWD_KERNEL in k)
        if not seen:
            fail(f"the profiler saw no backward kernel at {(cs, hs, ws)}")
        site_us[(cs, hs, ws, gs)] = t_us * BWD_LAUNCHES_PER_CALL
        bound_us, call_us = gn_bwd_bound(xs)[0] * 1e3, t_us * BWD_LAUNCHES_PER_CALL
        log(f"    site [{BATCH_ROWS},{cs},{hs},{ws}] G={gs} bf16: device {call_us:7.1f} us a call, "
            f"bound {bound_us:6.2f} us ({bound_us / call_us:.2f} of it), "
            f"{sites.count(((cs, hs, ws), gs))} a step; {nchw_plan_text(backward_plan(xs, dys, gs))}")
    per_forward_ms = sum(site_us[chw + (gs,)] for chw, gs in sites) / 1e3
    bound_sum = sum(gn_bwd_bound(torch.empty((BATCH_ROWS,) + chw, dtype=torch.bfloat16,
                                             device="meta"))[0] for chw, _ in sites)
    log(f"    the {len(sites)} sites of one batch-{BATCH_ROWS} step, bf16, device time of the "
        f"backward kernels alone (profiler, 5 calls a site): {per_forward_ms:.4f} ms "
        f"({per_forward_ms / len(sites) * 1e3:.1f} us a site), bound {bound_sum:.4f} ms; no single "
        "PyTorch call computes this gradient (library_ms null; the autograd yardstick is "
        "two_call_ms)")
    big = timing["bfloat16"]
    return {"name": "gn_silu_backward", "route": "cuda",
            "source": "sddm_tpu_torch/csrc/gn_silu_bwd.cu",
            "design": "redesigned for Hopper: each slice of a run's x and dy staged once in shared "
                      "memory, runs over 32 KB of x split across thread-block clusters whose "
                      "partials meet over DSMEM in rank order, 16-byte loads and stores, one "
                      "launch in which the last run of each group (an integer ticket) sums its "
                      "dweight/dbias; plan ops/gn_silu.py::nchw_backward_plan",
            "replaces": "sddm_tpu/experimental/pallas_groupnorm_swish.py:98",
            "replaces_note": "no Pallas counterpart: JAX differentiates flax GroupNorm -> swish "
                             "through XLA; the backward of the kernel of that line",
            "max_abs_err": worst_abs["bfloat16"], "max_abs_err_f32": worst_abs["float32"],
            "max_err_to_scale": worst["bfloat16"], "max_err_to_scale_f32": worst["float32"],
            "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None, "two_call_ms": big["two_call_ms"],
            "device_us": big["device_us"], "f32": timing["float32"],
            "shape": list(shape), "dtype": "bfloat16",
            "sites_per_step_device_ms": per_forward_ms, "bound_sites_per_step_ms": bound_sum}


def train_batch(config, device):
    """The seeded train batch of phases 24 and 31: (target, condition, the
    schedule, q draws for one step, a generator for the timed steps)."""
    import numpy as np
    import torch

    from sddm_tpu_torch.cli import build_diffusion

    ns = config["num_samples"]
    rng = np.random.default_rng(SEED + 3)
    clean = clips(BATCH_ROWS, ns)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    target, condition = (torch.from_numpy(a).to(device) for a in (clean, noisy))
    diffusion = build_diffusion(config)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    draws = (torch.randint(1, diffusion.num_timesteps + 1, (BATCH_ROWS,), generator=gen,
                           device=device),
             torch.rand((BATCH_ROWS,), generator=gen, device=device),
             torch.randn(target.shape, generator=gen, device=device))
    return target, condition, diffusion, draws, gen


def compare_steps(net_a, net_b, lr: float):
    """Two networks after one train step from the same weights: (gradient rel
    L2 over all, the worst parameter's (rel L2, name) with a denominator no
    smaller than the parameter's norm at the whole gradient's RMS, share of
    elements updated more than lr / 2 apart, max |d| of the parameters after
    the step)."""
    import torch

    gb_all = torch.cat([p.grad.flatten() for p in net_b.parameters()])
    ga_all = torch.cat([p.grad.flatten() for p in net_a.parameters()])
    grad_rel = float((ga_all - gb_all).norm() / gb_all.norm())
    rms = float(gb_all.norm()) / math.sqrt(gb_all.numel())
    worst, apart, n, dmax = (0.0, ""), 0, 0, 0.0
    for (name, pa), pb in zip(net_a.named_parameters(), net_b.parameters()):
        denom = max(float(pb.grad.norm()), rms * math.sqrt(pb.numel()))
        worst = max(worst, (float((pa.grad - pb.grad).norm()) / denom, name))
        d = (pa.detach() - pb.detach()).abs()
        dmax = max(dmax, float(d.max()))
        apart += int((d > lr / 2).sum())
        n += d.numel()
    return grad_rel, worst, apart / n, dmax


def train_step_phase(config, net_args, device) -> dict:
    """Phase 24: one train step of the flagship on the card (batch 16, the
    config's AMSGrad), the kernel path against the same step with both
    GroupNorm directions routed to their plain versions, in bf16 and then in
    float32 (TF32 off); its launches; the median of ``TRAIN_TIMED_STEPS``
    steps and peak memory; one profiled step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.cli import build_arch, build_optimizer
    from sddm_tpu_torch.models import UNetModified2, blocks
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_backward_reference,
        gn_silu_reference,
    )
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step
    from sddm_tpu_torch.utils.profiling import profiled

    ns = config["num_samples"]
    target, condition, diffusion, draws, gen = train_batch(config, device)
    nets = [UNetModified2(num_samples=ns, **net_args).to(device) for _ in range(2)]
    init_parameters(nets[0], torch.Generator().manual_seed(SEED))
    initial = {k: v.clone() for k, v in nets[0].state_dict().items()}
    lr = config["optimizer"]["args"]["lr"]
    record = {}

    def fresh(dtype, which=None):
        """(network, optimizer, step) for each of ``which`` (default: both
        networks), each reset to the initial weights in ``dtype``."""
        out = []
        for net in which or nets:
            net.load_state_dict(initial)
            net.dtype = dtype
            model = build_arch(config, diffusion, net)
            optimizer = build_optimizer(config, net)
            out.append((net, optimizer, make_train_step(model, l1_loss, optimizer)))
        return out

    def compare(net_a, net_b):
        return compare_steps(net_a, net_b, lr)

    failures = []
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        (net_k, opt_k, step_k), (net_p, opt_p, step_p) = fresh(dtype)
        gn_silu.launches = gn_silu_backward.launches = 0
        loss_k = step_k(target, condition, draws=draws)
        torch.cuda.synchronize()
        launches = (gn_silu.launches, gn_silu_backward.launches)
        if launches != (SITES_PER_FORWARD, SITES_PER_FORWARD):
            fail(f"one {dtype_name} train step launched gn_silu / gn_silu_backward {launches} "
                 f"times, expected {SITES_PER_FORWARD} each")
        with routed(blocks, "gn_silu", gn_silu_reference), \
                routed(blocks, "gn_silu_backward", gn_silu_backward_reference):
            loss_p = step_p(target, condition, draws=draws)
        torch.cuda.synchronize()
        if gn_silu.launches != SITES_PER_FORWARD or gn_silu_backward.launches != SITES_PER_FORWARD:
            fail("the routed step launched a GroupNorm kernel")
        for p in net_k.parameters():
            if p.grad is None or p.grad.dtype != torch.float32 or p.dtype != torch.float32:
                fail(f"a {dtype_name} step left a parameter {p.dtype} with gradient "
                     f"{None if p.grad is None else p.grad.dtype}")
            for key, state in opt_k.state[p].items():
                if state.dtype != torch.float32:
                    fail(f"optimizer state {key} is {state.dtype}")
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        grad_rel, (worst_rel, worst_name), apart, dmax = compare(net_k, net_p)
        # the kernel path again: its own repeat is the floor beside the readings
        ((repeat_net, _, repeat_step),) = fresh(dtype, [net_p])
        loss_r = repeat_step(target, condition, draws=draws)
        torch.cuda.synchronize()
        floor = compare(net_k, repeat_net)
        tol = TRAIN_TOL[dtype_name]
        readings = (loss_rel, grad_rel, worst_rel, apart)
        ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
        record[dtype_name] = {
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst_rel,
            "worst_param": worst_name, "updates_apart_share": apart, "param_max_abs_diff": dmax,
            "tol": list(tol),
            "kernel_repeat": {"loss": float(loss_r), "grad_rel_l2": floor[0],
                              "worst_param_grad_rel_l2": floor[1][0],
                              "updates_apart_share": floor[2]}}
        log(f"[24] one {dtype_name} train step, batch {BATCH_ROWS}: kernel path vs both GroupNorm "
            f"directions plain, same weights, batch and draws: loss {float(loss_k):.6f} vs "
            f"{float(loss_p):.6f} (rel {loss_rel:.2e}, tol {tol[0]}); gradients rel L2 "
            f"{grad_rel:.2e} (tol {tol[1]}), worst parameter {worst_name} {worst_rel:.2e} (tol "
            f"{tol[2]}); parameters after the step: max|d| {dmax:.2e} (<= 2 lr), share apart by "
            f"> lr/2 {apart:.2e} (tol {tol[3]}) {'ok' if ok else 'OVER'}; launches "
            f"{launches[0]} gn_silu_nchw + {launches[1]} backward calls")
        log(f"    the kernel path run twice: loss {float(loss_r):.6f}, gradients rel L2 "
            f"{floor[0]:.2e}, worst parameter {floor[1][0]:.2e}, share apart {floor[2]:.2e}")
        if not ok:
            failures.append(f"{dtype_name}: {readings}")
    if failures:  # both types read first, so that one run gives every reading
        fail(f"the kernel-path train step differs from the plain path: {failures}")
    del nets[1]

    ((net, _, step),) = fresh(torch.bfloat16)
    for _ in range(3):
        step(target, condition, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        start = time.perf_counter()
        step(target, condition, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    step_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated()
    # one profiled step: the backward kernels the device ran in it, counted by
    # the profiler, against the calls the wrapper counted; a window in which
    # the profiler saw no backward kernel is profiled again, up to 3 times
    for _ in range(3):
        gn_silu_backward.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - start) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events}
        bwd_kernels = sum(v[1] for k, v in busy.items() if BWD_KERNEL in k)
        if bwd_kernels:
            break
    bwd_calls = gn_silu_backward.launches
    record["launches"] = {"gn_silu_nchw": SITES_PER_FORWARD, "gn_silu_backward": bwd_calls,
                          "backward_kernels": bwd_kernels}
    log(f"    profiled step: {bwd_kernels} {BWD_KERNEL}* kernels run on the device for "
        f"{bwd_calls} gn_silu_backward calls ({bwd_kernels / max(bwd_calls, 1):g} a call)")
    if bwd_calls != SITES_PER_FORWARD or \
            bwd_kernels != SITES_PER_FORWARD * BWD_LAUNCHES_PER_CALL:
        fail(f"the profiled step ran {bwd_kernels} backward kernels for {bwd_calls} calls, "
             f"expected {SITES_PER_FORWARD * BWD_LAUNCHES_PER_CALL} for {SITES_PER_FORWARD}")
    busy_ms = sum(v[0] for v in busy.values())
    bwd_ms = sum(v[0] for k, v in busy.items() if BWD_KERNEL in k)
    fwd_ms = sum(v[0] for k, v in busy.items() if is_nchw_kernel(k))
    record.update({"step_ms_median": step_ms, "step_ms_min": min(times) * 1e3,
                   "step_ms_max": max(times) * 1e3, "peak_bytes": peak,
                   "profile": {"wall_ms": prof_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1 - busy_ms / step_ms if busy_ms else None,
                               "backward_kernel_ms": bwd_ms, "forward_kernel_ms": fwd_ms}})
    log(f"    bf16 train step: median {step_ms:.2f} ms over {TRAIN_TIMED_STEPS} (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), peak {peak / 2**20:.1f} MiB")
    if busy_ms > 0:
        log(f"    profiled step: device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / step_ms:.3f} "
            f"of the median step ({1 - busy_ms / prof_ms:.3f} of the profiled wall, {prof_ms:.1f} "
            f"ms); backward kernels {bwd_ms:.3f} ms ({bwd_ms / busy_ms:.3f} of busy), forward "
            f"gn_silu_nchw {fwd_ms:.3f} ms ({fwd_ms / busy_ms:.3f})")
        for name, (ms, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{count:<5d} {name[:90]}")
        if bwd_ms <= 0:
            fail("the profiled train step shows no time under the backward kernels' names")
    else:
        log("    the profiler saw no device time: breakdown not measured")
    return record


def train_config(work: Path, name: str, train_root: Path, val_root: Path, **trainer) -> Path:
    """The flagship's config for one training CLI run, written under
    ``work``: its datasets on the given roots, its run dir under ``work``,
    its trainer block updated with ``trainer``."""
    config = json.loads((RUN / "config.json").read_text())
    config["name"] = name
    config["tr_dataset"]["args"]["data_root"] = str(train_root)
    config["val_dataset"]["args"]["data_root"] = str(val_root)
    config["infer_dataset"]["args"]["data_root"] = str(val_root)
    config["trainer"].update(save_dir=str(work / "saved"), **trainer)
    path = work / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def run_train(argv) -> dict:
    """``python -m sddm_tpu_torch.train`` with ``argv``, run in this process
    so that the kernels' counts can be read: every epoch's log, the launches
    of both GroupNorm directions (NCHW, and NHWC for the packed twin), the
    network's class, the wall seconds and the run dir."""
    import importlib

    import torch

    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_nhwc,
        gn_silu_nhwc_backward,
    )
    from sddm_tpu_torch.train.trainer import Trainer

    train_cli = importlib.import_module("sddm_tpu_torch.train.__main__")
    logs, epoch_fn = [], Trainer._train_epoch

    def logged(self, epoch):
        logs.append((epoch, epoch_fn(self, epoch)))
        return logs[-1][1]

    gn_silu.launches = gn_silu_backward.launches = 0
    gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = 0
    start = time.perf_counter()
    with routed(Trainer, "_train_epoch", logged):
        trainer = train_cli.main(train_cli.parse_args(argv))
    torch.cuda.synchronize()
    return {"logs": logs, "seconds": time.perf_counter() - start, "run": trainer.config.save_dir,
            "launches": (gn_silu.launches, gn_silu_backward.launches),
            "nhwc_launches": (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches),
            "network": type(trainer.model.network).__name__, "len_epoch": trainer.len_epoch}


def training_cli_phases(work: Path, val_root: Path, audios, device) -> dict:
    """Phase 25: ``python -m sddm_tpu_torch.train`` on the card: the
    flagship from init for 3 epochs (validation at epoch 3), then resumed
    from the committed epoch-250 checkpoint for ``RESUME_EPOCHS``; the
    checkpoint it wrote read back and served."""
    import numpy as np
    import torch

    from sddm_tpu_torch import load_enhancer, make_synthetic_corpus
    from sddm_tpu_torch.models.unet_packed import PackedUNetModified2
    from sddm_tpu_torch.train.checkpoints import CKPT_BEST, CKPT_CURRENT, CKPT_LAST, load_checkpoint

    start = time.perf_counter()
    make_synthetic_corpus.main(["--root", str(work / "train_split"), "--n-train",
                                str(TRAIN_FILES), "--n-test", "0", "--version",
                                str(CORPUS_VERSION), "--seed", str(CORPUS_SEED)])
    corpus_s = time.perf_counter() - start
    train_root = work / "train_split" / "train"
    log(f"[25] corpus: the first {TRAIN_FILES} files of the v1 train split (seed {CORPUS_SEED}) "
        f"in {corpus_s:.1f} s; validation on [20]'s test split")
    steps = math.ceil(TRAIN_FILES / BATCH_ROWS)

    # (a) from init
    path = train_config(work, "train_from_init", train_root, val_root, epochs=3, valid_period=3,
                        valid_steps=STEPS, n_valid_data_batch=1, save_period=1)
    a = run_train(["-c", str(path)])
    losses = [log_["loss"] for _, log_ in a["logs"]]
    val = a["logs"][-1][1]
    want_fwd = 3 * steps * SITES_PER_FORWARD + STEPS * SITES_PER_FORWARD
    log(f"    (a) python -m sddm_tpu_torch.train -c <flagship, 3 epochs, valid_steps {STEPS}>: epoch "
        f"losses {', '.join(f'{x:.5f}' for x in losses)}; val_loss {val.get('val_loss', math.nan):.5f} "
        f"val_sisnr {val.get('val_sisnr', math.nan):.3f}; {a['len_epoch']} steps an epoch; "
        f"launches gn_silu {a['launches'][0]} (expected {want_fwd}: {SITES_PER_FORWARD} x {steps} "
        f"x 3 + {SITES_PER_FORWARD} x {STEPS} validation), backward {a['launches'][1]} (expected {3 * steps * SITES_PER_FORWARD}); "
        f"wall {a['seconds']:.1f} s")
    if a["len_epoch"] != steps or not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"training from init: {a['len_epoch']} steps an epoch, epoch losses {losses}")
    if a["launches"] != (want_fwd, 3 * steps * SITES_PER_FORWARD):
        fail(f"training from init launched {a['launches']}")
    missing = [n for n in (CKPT_CURRENT, CKPT_LAST, CKPT_BEST) if not (a["run"] / n).is_file()]
    wavs = sorted(p.name for p in (a["run"] / "samples" / "output").glob("*.wav"))
    if missing or len(wavs) != BATCH_ROWS or "val_loss" not in val:
        fail(f"training from init: missing checkpoints {missing}, {len(wavs)} validation WAVs")

    # (b) resumed from the committed epoch-250 checkpoint
    committed = load_checkpoint(RUN / "model_best.ckpt", with_opt_state=True)
    start_epoch = committed["epoch"] + 1
    path = train_config(work, "train_resumed", train_root, val_root,
                        epochs=start_epoch + RESUME_EPOCHS - 1, valid_period=25, save_period=1)
    b = run_train(["-c", str(path), "-r", str(RUN / "model_best.ckpt")])
    resumed = [(e, log_["loss"]) for e, log_ in b["logs"]]
    inside = all(RESUME_LOSS[0] <= x <= RESUME_LOSS[1] for _, x in resumed)
    log(f"    (b) -r artifacts/flagship_synth/model_best.ckpt (epoch {start_epoch - 1}): epochs "
        f"{', '.join(f'{e}: {x:.5f}' for e, x in resumed)} (limit {RESUME_LOSS}: the JAX "
        f"package's epochs 231-270 read 0.04105-0.05686) {'ok' if inside else 'OVER'}; wall "
        f"{b['seconds']:.1f} s")
    if [e for e, _ in resumed] != list(range(start_epoch, start_epoch + RESUME_EPOCHS)) or \
            not inside:
        fail(f"the resumed training's epoch losses {resumed} miss {RESUME_LOSS}")

    # (c) the checkpoint it wrote, read back and served
    ckpt = load_checkpoint(b["run"] / CKPT_CURRENT, with_opt_state=True)
    count = int(ckpt["opt_state"]["0"]["count"])
    want_count = int(committed["opt_state"]["0"]["count"]) + RESUME_EPOCHS * steps
    start = time.perf_counter()
    config = json.loads(path.read_text())
    enh = load_enhancer(b["run"] / CKPT_CURRENT, config, batch_rows=BATCH_ROWS, steps=STEPS)
    out = enh.enhance_batch(audios)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - start
    served_ok = all(y.shape == x.shape and np.isfinite(y).all() for x, y in zip(audios, out))
    log(f"    (c) {CKPT_CURRENT} of (b): epoch {ckpt['epoch']}, optimizer count {count} (expected "
        f"{want_count}); load_enhancer serves {type(enh.model.network).__name__} (canary "
        f"{'passed' if enh.engine_fallback is None else enh.engine_fallback}), {len(audios)} "
        f"requests finite: {served_ok}; load and serve {serve_s:.2f} s")
    if count != want_count or ckpt["epoch"] != start_epoch + RESUME_EPOCHS - 1 or not served_ok \
            or not isinstance(enh.model.network, PackedUNetModified2):
        fail(f"the resumed checkpoint: count {count}, epoch {ckpt['epoch']}, served finite "
             f"{served_ok}, engine {type(enh.model.network).__name__}")
    return {"corpus_seconds": corpus_s, "steps_per_epoch": steps,
            "from_init": {"epoch_losses": losses, "val_loss": val["val_loss"],
                          "val_sisnr": val.get("val_sisnr"), "launches": list(a["launches"]),
                          "seconds": a["seconds"]},
            "resumed": {"epoch_losses": dict(resumed), "limit": list(RESUME_LOSS),
                        "launches": list(b["launches"]), "seconds": b["seconds"],
                        "count": count},
            "served": {"engine": type(enh.model.network).__name__, "seconds": serve_s}}


class Recorded:
    """A data loader that keeps the batches of every pass over it."""

    def __init__(self, loader):
        self.loader, self.passes = loader, []

    def __iter__(self):
        batches = []
        self.passes.append(batches)
        for batch in self.loader:
            batches.append(batch)
            yield batch

    def __len__(self):
        return len(self.loader)


def score_vocoder(samples: Path) -> dict:
    """``evaluate`` over the output and target WAVs of ``samples`` (the test
    CLI writes no condition: the noisy side is scored on the targets and not
    read); the 200-file means of STOI, pesq_wb_approx and SI-SNR, and the
    seconds it took."""
    import os

    import numpy as np

    from sddm_tpu_torch.evaluate import evaluate

    os.symlink(samples / "target", samples / "condition")
    start = time.perf_counter()
    evaluate(samples, ".wav", 16000, {"pesq_wb", "stoi", "sisnr"})
    out = {m: float(np.load(samples / f"output_{m}.npy").mean()) for m in GATED_METRICS}
    out["files"] = len(np.load(samples / "output_stoi.npy"))
    out["seconds"] = time.perf_counter() - start
    return out


def run_test_cli(argv, seed: int = 0) -> dict:
    """``python -m sddm_tpu_torch.test`` with ``argv``, run in this process
    with the sampler's generator seeded ``seed``: its logged means, the
    batches its loop served (after the one it draws first), the sampler
    calls (every output must be finite), the wall seconds and the samples
    dir."""
    import torch

    from sddm_tpu_torch import test as test_cli
    from sddm_tpu_torch.models.sddm import SDDM

    config, parsed = test_cli.parse_args(argv)
    loaders, calls, sampler = [], [], SDDM.infer
    build = test_cli.build_data_loader

    def recorded(*args, **kwargs):
        loaders.append(Recorded(build(*args, **kwargs)))
        return loaders[-1]

    def counted_infer(self, condition, *args, **kwargs):
        out = sampler(self, condition, *args, **kwargs)
        if not bool(torch.isfinite(out).all()):
            fail(f"{argv}: sampler call {len(calls)} gave a non-finite output")
        calls.append(tuple(out.shape))
        return out

    start = time.perf_counter()
    with routed(test_cli, "build_data_loader", recorded), routed(SDDM, "infer", counted_infer):
        result = test_cli.main(config, num_steps=parsed.steps, ddim_eta=parsed.ddim, seed=seed)
    torch.cuda.synchronize()
    first, loop = loaders[0].passes
    return {"log": result, "batches": loop, "first": first, "calls": calls,
            "seconds": time.perf_counter() - start, "samples": config.save_dir / "samples"}


def run_train_specmodel(argv) -> dict:
    """``python -m sddm_tpu_torch.train_specmodel`` with ``argv``, run in
    this process: every epoch's log, the residual-stack launches (training
    runs the plain network: none), the wall seconds and the trainer."""
    import torch

    from sddm_tpu_torch import train_specmodel
    from sddm_tpu_torch.ops.diffwave_stack import diffwave_stack
    from sddm_tpu_torch.train.trainer import Trainer

    logs, epoch_fn = [], Trainer._train_epoch

    def logged(self, epoch):
        logs.append((epoch, epoch_fn(self, epoch)))
        return logs[-1][1]

    diffwave_stack.layer_launches = 0
    start = time.perf_counter()
    with routed(Trainer, "_train_epoch", logged):
        trainer = train_specmodel.main(train_specmodel.parse_args(argv))
    torch.cuda.synchronize()
    return {"logs": logs, "seconds": time.perf_counter() - start, "trainer": trainer,
            "stack_layers": diffwave_stack.layer_launches}


def vocoder_cli_phases(work: Path, smi: str, device) -> dict:
    """Phases 26-29: the vocoder family's entry points on the card, on the v2
    corpus: spectrograms, the test CLI and the packed engine over the 200
    test crops against the committed DDIM-6 table, and vocoder training.
    Returns the record of the phases and the residual-stack launches of
    phase 28."""
    import numpy as np
    import torch

    from sddm_tpu_torch import load_specmodel, make_synthetic_corpus, prepare_spectrogram
    from sddm_tpu_torch.data.wav_io import load_wav, save_wav
    from sddm_tpu_torch.models import FusedDiffWave
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.ops import diffwave_stack as dw_ops
    from sddm_tpu_torch.train.checkpoints import CKPT_BEST, CKPT_CURRENT, load_checkpoint

    stack = dw_ops.diffwave_stack
    dw_config = json.loads((VOCODER / "config.json").read_text())
    hop = dw_config["test_data_loader"]["args"]["hop_samples"]
    crop = dw_config["test_data_loader"]["args"]["crop_mel_frames"]
    batch = dw_config["test_data_loader"]["args"]["batch_size"]

    # -- 26. the corpus and its spectrograms ------------------------------------
    start = time.perf_counter()
    make_synthetic_corpus.main(["--root", str(work / "voc"), "--n-train", str(VOC_FILES),
                                "--n-test", str(VOC_FILES), "--seed", str(VOC_SEED),
                                "--version", str(VOC_VERSION)])
    gen_s = time.perf_counter() - start
    test_root, train_root = work / "voc" / "test", work / "voc" / "train"
    start = time.perf_counter()
    written = [prepare_spectrogram.main(root, dw_config) for root in (test_root, train_root)]
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - start
    wav = test_root / "noisy" / "u0000.wav"
    want_spec, want_mel = prepare_spectrogram.spectrograms(load_wav(wav)[0], dw_config,
                                                           torch.device("cpu"))
    spec_err = max(float(np.abs(np.load(f"{wav}{kind}") - want).max())
                   for kind, want in ((".spec.npy", want_spec), (".mel.npy", want_mel)))
    log(f"[26] corpus: v{VOC_VERSION} test split ({VOC_FILES} utterances, seed {VOC_SEED + 1}) "
        f"and the first {VOC_FILES} of the train split (seed {VOC_SEED}) in {gen_s:.1f} s; "
        f"python -m sddm_tpu_torch.prepare_spectrogram wrote {written[0]} + {written[1]} WAVs' "
        f".spec.npy and .mel.npy on the card in {prep_s:.1f} s; u0000 (noisy) "
        f"{list(want_spec.shape)} and {list(want_mel.shape)}, card vs CPU max|d| "
        f"{spec_err:.3e} (limit {SPEC_CARD_VS_CPU})")
    if written != [2 * VOC_FILES, 2 * VOC_FILES] or not spec_err <= SPEC_CARD_VS_CPU:
        fail(f"prepare_spectrogram wrote {written}, card vs CPU {spec_err}")

    # -- 27. the test CLI over the 200 crops, two seeds --------------------------
    def voc_config(name, base, **datasets):
        config = json.loads(base.read_text())
        config["name"] = name
        for key, root in datasets.items():
            config[key]["args"]["data_root"] = str(root)
        config["trainer"]["save_dir"] = str(work / "saved")
        path = work / f"{name}.json"
        path.write_text(json.dumps(config))
        return path

    ckpt = VOCODER / "model_best.ckpt"
    test_cfg = voc_config("dw_test", VOCODER / "config.json", test_dataset=test_root)
    argv = ["-c", str(test_cfg), "-r", str(ckpt), "--ddim", "--steps", str(DW_STEPS)]
    runs = {}
    for seed in (0, 1):
        stack.layer_launches = 0
        run = run_test_cli(argv, seed=seed)
        run["stack_layers"] = stack.layer_launches
        run["scores"] = score_vocoder(run["samples"])
        runs[seed] = run
        crops = {b[0].shape[-1] for b in run["batches"]}
        log(f"[27] python -m sddm_tpu_torch.test -r artifacts/round5/diffwave/model_best.ckpt "
            f"--ddim --steps {DW_STEPS} (seed {seed}): {len(run['batches'])} batches of "
            f"{sorted(crops)} samples after the one drawn first, {len(run['calls'])} sampler "
            f"calls, {run['stack_layers']} diffwave_stack launches (the plain float32 DiffWave, "
            f"as the root test.py serves); loss {run['log']['loss']:.5f}, sisnr "
            f"{run['log']['sisnr']:.3f}; {run['seconds']:.1f} s, scoring "
            f"{run['scores']['seconds']:.1f} s on {smi}")
        if len(run["batches"]) != VOC_BATCHES or crops != {crop * hop} or \
                run["scores"]["files"] != VOC_FILES or run["stack_layers"] != 0:
            fail(f"the test CLI served {len(run['batches'])} batches of {crops} samples, "
                 f"{run['scores']['files']} files, {run['stack_layers']} stack launches")
    served = [np.concatenate([b[2] for b in run["batches"]]) for run in runs.values()]
    same_crops = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                     for a, b in zip(runs[0]["batches"], runs[1]["batches"]))
    log(f"    both seeds served every file once: {sorted(served[0]) == list(range(VOC_FILES))}, "
        f"the same crops in the same order: {same_crops}")
    if sorted(served[0]) != list(range(VOC_FILES)) or sorted(served[1]) != list(range(VOC_FILES)):
        fail("the test CLI did not serve every test file once")

    def gate(label, means):
        over = []
        for m in ("stoi", "pesq_wb_approx", "loss"):
            d = means[m] - DDIM6_TABLE[m]
            ok = abs(d) <= DDIM6_LIMITS[m]
            log(f"    {label} {m:15s} {means[m]:.4f} against the committed {DDIM6_TABLE[m]:.4f}: "
                f"{d:+.4f} (limit {DDIM6_LIMITS[m]}) {'ok' if ok else 'OVER'}")
            if not ok:
                over.append(f"{label} {m} {d:+.4f}")
        log(f"    {label} sisnr           {means['sisnr']:.3f} dB (committed {DDIM6_SISNR:.3f}; "
            "phase-blind for a vocoder, not gated)")
        return over

    over = []
    for seed, run in runs.items():
        over += gate(f"test seed {seed}", {**run["scores"], "loss": run["log"]["loss"]})
    spread = {m: runs[0]["scores"][m] - runs[1]["scores"][m] for m in GATED_METRICS}
    spread["loss"] = runs[0]["log"]["loss"] - runs[1]["log"]["loss"]
    log("    seed 0 - seed 1: " + ", ".join(f"{m} {v:+.4f}" for m, v in spread.items()))

    # -- 28. the same crops through load_specmodel's packed engine ---------------
    packed = dict(dw_config, packed=True)
    model = load_specmodel(ckpt, packed, steps=DW_STEPS, ddim=True)
    fused = model.network
    if not (isinstance(fused, FusedDiffWave) and fused.net.dtype == torch.bfloat16):
        fail("load_specmodel did not serve the bf16 fused engine")
    samples = work / "packed_samples"
    generator = torch.Generator(device=device).manual_seed(SEED)
    names = runs[0]["batches"]
    dataset_names = sorted(p.name for p in (test_root / "clean").glob("*.wav"))
    total_loss, n_total = 0.0, 0
    torch.cuda.synchronize()
    stack.launches = stack.layer_launches = 0
    start = time.perf_counter()
    for target, cond, index in names:
        out = model.infer(torch.from_numpy(cond).to(device), generator)
        if not bool(torch.isfinite(out).all()) or out.shape != target.shape:
            fail(f"the packed engine gave {tuple(out.shape)} for {target.shape}, or non-finite")
        out_np = out.float().cpu().numpy()
        for b in range(target.shape[0]):
            name = dataset_names[int(index[b])]
            save_wav(samples / "output" / name, out_np[b].reshape(-1), 16000)
            save_wav(samples / "target" / name, target[b].reshape(-1), 16000)
        total_loss += float(l1_loss(torch.from_numpy(out_np), torch.from_numpy(target))) * \
            target.shape[0]
        n_total += target.shape[0]
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - start
    calls, layers = stack.launches, stack.layer_launches
    packed_scores = score_vocoder(samples)
    want_layers = DW_LAYERS * DW_STEPS * VOC_BATCHES
    log(f"[28] load_specmodel(steps={DW_STEPS}, ddim=True) with \"packed\": true (FusedDiffWave, "
        f"bf16) over [27]'s {len(names)} batches in order: {calls} stack calls, {layers} layer "
        f"launches (expected {DW_LAYERS} x {DW_STEPS} x {VOC_BATCHES} = {want_layers}); serve "
        f"{packed_s:.1f} s against [27]'s {runs[0]['seconds']:.1f} s (CLI, float32 plain, "
        f"with its data and WAV writing), scoring {packed_scores['seconds']:.1f} s")
    if layers != want_layers or calls != DW_STEPS * VOC_BATCHES:
        fail(f"the packed engine launched {calls} stack calls and {layers} layers, expected "
             f"{DW_STEPS * VOC_BATCHES} and {want_layers}")
    over += gate("packed", {**packed_scores, "loss": total_loss / n_total})
    # the kernel at the shape this path gave it, against its plain version
    target, cond, _ = names[0]
    spec = torch.from_numpy(cond).to(device)
    x_t = torch.randn(target.shape, device=device, generator=generator)
    args = stack_inputs(fused, spec, x_t, 100.0, torch.bfloat16)
    got = stack(*args, cycle=DW_CYCLE)
    want = dw_ops.diffwave_stack_reference(*args, cycle=DW_CYCLE)
    err, rel = differences(got, want)
    tol_abs = DW_TOL["bfloat16"][0] * bf16_ulp(float(want.float().abs().max()))
    log(f"    diffwave_stack at the served shape {list(args[0].shape)} L={DW_LAYERS} bf16 vs "
        f"diffwave_stack_reference: max|d|={err:.3e} rel_l2={rel:.3e} (tol {tol_abs:.3g}, "
        f"{DW_TOL['bfloat16'][1]})")
    if not (err <= tol_abs and rel <= DW_TOL["bfloat16"][1]):
        over.append(f"[28] diffwave_stack at {list(args[0].shape)}: {err}, {rel}")
    del model, fused, args, got, want
    if over:
        fail(f"the vocoder's 200-file means miss the committed DDIM-6 table: {over}")

    # -- 29. train_specmodel: DiffWave resumed, WaveGrad from init ---------------
    committed = load_checkpoint(ckpt, with_opt_state=True)
    start_epoch = committed["epoch"] + 1
    path = voc_config("dw_train", VOCODER / "config.json", tr_dataset=train_root,
                      val_dataset=test_root)
    config = json.loads(path.read_text())
    config["trainer"].update(epochs=start_epoch + VOC_EPOCHS - 1, save_period=1)
    path.write_text(json.dumps(config))
    a = run_train_specmodel(["-c", str(path), "-r", str(ckpt)])
    resumed = [(e, lg["loss"]) for e, lg in a["logs"]]
    inside = all(RESUME_DW_LOSS[0] <= x <= RESUME_DW_LOSS[1] for _, x in resumed)
    run = a["trainer"].config.save_dir
    count = int(load_checkpoint(run / CKPT_CURRENT, with_opt_state=True)["opt_state"]["0"]["count"])
    want_count = int(committed["opt_state"]["0"]["count"]) + VOC_EPOCHS * a["trainer"].len_epoch
    log(f"[29] (a) python -m sddm_tpu_torch.train_specmodel -c <config_diffwave_synth, the first "
        f"{VOC_FILES} train files> -r artifacts/round5/diffwave/model_best.ckpt (epoch "
        f"{start_epoch - 1}): {a['trainer'].len_epoch} steps an epoch; epochs "
        f"{', '.join(f'{e}: {x:.5f}' for e, x in resumed)} (limit {RESUME_DW_LOSS}) "
        f"{'ok' if inside else 'OVER'}; optimizer count {count} (expected {want_count}); "
        f"{a['stack_layers']} stack launches; wall {a['seconds']:.1f} s")
    if [e for e, _ in resumed] != list(range(start_epoch, start_epoch + VOC_EPOCHS)) or \
            not inside or count != want_count or a["trainer"].len_epoch != VOC_BATCHES:
        fail(f"the resumed DiffWave training: epochs {resumed}, count {count}")

    test8 = work / "wg_test8"
    for side in ("clean", "noisy"):
        (test8 / side).mkdir(parents=True)
        for name in dataset_names[:batch]:
            (test8 / side / name).symlink_to(test_root / side / name)
    wg_path = voc_config("wg_train", ROOT / "configs" / "config_wavegrad_synth.json",
                         tr_dataset=train_root, val_dataset=test_root, test_dataset=test8)
    config = json.loads(wg_path.read_text())
    config["trainer"].update(epochs=VOC_EPOCHS, save_period=1, valid_period=VOC_EPOCHS,
                             valid_steps=DW_STEPS, valid_ddim=True)
    wg_path.write_text(json.dumps(config))
    b = run_train_specmodel(["-c", str(wg_path)])
    losses = [lg["loss"] for _, lg in b["logs"]]
    val = b["logs"][-1][1]
    run = b["trainer"].config.save_dir
    wavs = len(list((run / "samples" / "output").glob("*.wav")))
    log(f"    (b) python -m sddm_tpu_torch.train_specmodel -c <config_wavegrad_synth, the same "
        f"train files> from init: {b['trainer'].len_epoch} steps an epoch; epoch losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; val_loss {val.get('val_loss', math.nan):.5f} "
        f"(DDIM-{DW_STEPS}, {wavs} WAVs); wall {b['seconds']:.1f} s")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]) or \
            not (run / CKPT_CURRENT).is_file() or not (run / CKPT_BEST).is_file() or wavs != batch:
        fail(f"WaveGrad from init: epoch losses {losses}, {wavs} validation WAVs")
    c = run_test_cli(["-c", str(wg_path), "-r", str(run / CKPT_CURRENT), "--ddim", "--steps",
                      str(DW_STEPS)])
    outs = sorted((c["samples"] / "output").glob("*.wav"))
    log(f"    (b) its {CKPT_CURRENT} through python -m sddm_tpu_torch.test --ddim --steps "
        f"{DW_STEPS} on {batch} test files: {len(c['batches'])} batch, loss "
        f"{c['log']['loss']:.5f}, {len(outs)} output WAVs; {c['seconds']:.1f} s")
    if len(c["batches"]) != 1 or len(outs) != batch or not math.isfinite(c["log"]["loss"]):
        fail(f"the test CLI on the WaveGrad checkpoint: {len(c['batches'])} batches, "
             f"{len(outs)} WAVs, loss {c['log']['loss']}")

    def kept(run):
        return {"loss": run["log"]["loss"], "sisnr_cli": run["log"]["sisnr"],
                "scores": run["scores"], "seconds": run["seconds"],
                "sampler_calls": len(run["calls"])}

    record = {
        "corpus": {"files": VOC_FILES, "seed": VOC_SEED, "version": VOC_VERSION,
                   "generate_seconds": gen_s, "prepare_seconds": prep_s,
                   "spec_card_vs_cpu": spec_err},
        "ddim6_table": DDIM6_TABLE, "ddim6_limits": DDIM6_LIMITS,
        "test_cli": {seed: kept(run) for seed, run in runs.items()},
        "seed_spread": spread, "same_crops": same_crops,
        "packed": {"scores": packed_scores, "loss": total_loss / n_total, "seconds": packed_s,
                   "stack_calls": calls, "layer_launches": layers,
                   "served_shape_max_abs_err": err, "served_shape_rel_l2": rel},
        "train_diffwave_resumed": {"epoch_losses": dict(resumed), "limit": list(RESUME_DW_LOSS),
                                   "count": count, "seconds": a["seconds"]},
        "train_wavegrad": {"epoch_losses": losses, "val_loss": val.get("val_loss"),
                           "seconds": b["seconds"], "test_loss": c["log"]["loss"]},
        "nvidia_smi": smi,
    }
    return {"record": record, "layer_launches": layers, "max_abs_err": err}


def nhwc_bwd_bound(x, groups: int):
    """(bound ms, "bytes" or "operations", bytes) of one NHWC backward call on
    ``x``: x and dy read once and dx written once at 3.35 TB/s, plus the
    [C4] scale, bias, group map, dscale and dbias and the [B, G, 2]
    statistics, against about thirty f32 operations per element."""
    b, c4 = x.shape[0], x.shape[-1]
    n_bytes = 3 * x.numel() * x.element_size() + 5 * c4 * 4 + b * groups * 2 * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 30 * x.numel() / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes


def check_nhwc_backward(shape, groups: int, group_of, count: int, offset: bool, spread: float,
                        gen):
    """``gn_silu_nhwc_backward`` at one NHWC shape on seeded x (zeroed outside
    the offset grid at offset sites), dy, scale and bias (spread < 1:
    near-constant groups at 1000, where finite and repeated are the checks),
    in float32 and bfloat16, with the statistics the forward kernel wrote:
    the outputs' dtypes, shapes and finiteness, each call repeated bit for
    bit, and dx, dscale, dbias and the statistics held against the plain
    versions at ``BWD_REL`` / ``BWD_RTOL``.  Returns [(dtype name, ok,
    {output: max |d| / scale} or None, max |d|, the call's plan)]."""
    import torch

    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu_nhwc,
        gn_silu_nhwc_backward,
        gn_silu_nhwc_backward_reference,
        gn_silu_nhwc_reference,
        group_order,
        nhwc_backward_plan_of,
    )
    from sddm_tpu_torch.ops.packed import offset_mask

    device, c4 = gen.device, shape[-1]
    sc = (1 + 0.5 * torch.randn(c4, device=device, generator=gen)).contiguous()
    bi = (0.2 * torch.randn(c4, device=device, generator=gen)).contiguous()
    x32 = torch.randn(shape, device=device, generator=gen) * 2 * spread
    x32 += (1000.0 if spread < 1 else 0.3) + 0.5 * torch.randn(c4, device=device, generator=gen)
    if offset:  # the engine zeroes the out-of-range rows/cols before the GN
        x32 *= torch.from_numpy(offset_mask(shape[1], shape[2], c4 // 4)).to(device)
    dy32 = torch.randn(shape, device=device, generator=gen)
    order = group_order(group_of, groups)
    args = (sc, bi, group_of, groups, count, offset)
    readings = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x, dy = x32.to(dtype).contiguous(), dy32.to(dtype).contiguous()
        stats = torch.empty((shape[0], groups, 2), dtype=torch.float32, device=device)
        gn_silu_nhwc(x, *args, order=order, stats=stats)
        got = gn_silu_nhwc_backward(x, dy, *args, order=order, stats=stats)
        again = gn_silu_nhwc_backward(x, dy, *args, order=order, stats=stats)
        torch.cuda.synchronize()
        kinds = [(t.dtype, tuple(t.shape)) for t in got]
        if kinds != [(dtype, tuple(shape)), (torch.float32, (c4,)), (torch.float32, (c4,))] or \
                not all(bool(torch.isfinite(t).all()) for t in got):
            fail(f"gn_silu_nhwc_backward at {shape} {dtype_name}: outputs {kinds}, finite "
                 f"{[bool(torch.isfinite(t).all()) for t in got]}")
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            fail(f"gn_silu_nhwc_backward is not deterministic at {shape} {dtype_name}")
        plan = nhwc_backward_plan_of(x, groups)
        if spread < 1:  # ill-conditioned: finite and repeated are the checks
            readings.append((dtype_name, True, None, 0.0, plan))
            continue
        want = gn_silu_nhwc_backward_reference(x, dy, *args)
        want_stats = torch.empty_like(stats)
        gn_silu_nhwc_reference(x, *args, stats=want_stats)
        ok, errs, max_abs = True, {}, 0.0
        for name, p, q in zip(("dx", "dscale", "dbias", "stats"), got + (stats,),
                              want + (want_stats,)):
            p, q = p.float(), q.float()
            scale = float(q.abs().max())
            rtol = BWD_RTOL[dtype_name] if name == "dx" else BWD_RTOL["float32"]
            d = (p - q).abs()
            ok &= bool(torch.all(d <= BWD_REL * scale + rtol * q.abs()))
            errs[name] = float(d.max()) / max(scale, 1e-30)
            if name != "stats":
                max_abs = max(max_abs, float(d.max()))
        readings.append((dtype_name, ok, errs, max_abs, plan))
    return readings


def nhwc_bwd_plan_text(p) -> str:
    """One NHWC backward plan (ops/gn_silu.py::nhwc_backward_plan) as [30] prints it."""
    return (f"K={p.k} rows={p.rows} staged={p.staged} buffers={p.buffers} items={p.items} "
            f"grid={p.grid} waves={p.waves} smem={p.smem}")


def nhwc_backward_phase(config, net_args, device, gen) -> dict:
    """Phase 30: the NHWC backward kernels against their plain backward at all
    33 GroupNorm sites of the packed engine, batch 16, and at edge cases;
    their times at the largest site, the identity site and over the 33
    sites, beside the bound, the plain version and torch autograd.  Returns
    the kernel's record (without the launches of phases 31-32)."""
    import torch
    import torch.nn.functional as F

    from sddm_tpu_torch.models import PackedUNetModified2, UNetModified2
    from sddm_tpu_torch.models.unet_packed import _packed_gn_plan
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu_nhwc,
        gn_silu_nhwc_backward,
        gn_silu_nhwc_backward_reference,
        gn_silu_nhwc_reference,
        group_order,
        nhwc_backward_plan_of,
    )
    from sddm_tpu_torch.ops.packed import offset_mask

    n = config["num_samples"]
    engine = PackedUNetModified2(UNetModified2(num_samples=n, **net_args).to(device))
    sites = packed_sites(engine, n, device)
    n_offset = sum(m.offset for m, _ in sites)
    if (len(sites), n_offset) != (PACKED_SITES, OFFSET_SITES):
        fail(f"[30] expected {PACKED_SITES} packed GroupNorm sites ({OFFSET_SITES} offset), "
             f"found {len(sites)} ({n_offset})")

    def plan(c4, groups, sections):
        if sections is None:  # identity: the unpacked sites
            return torch.arange(c4) // (c4 // groups), c4 // groups
        _, group_of, count = _packed_gn_plan(groups, sections)
        return torch.as_tensor(group_of), count

    cases = [((BATCH_ROWS,) + hwc, m.groups, m.group_of, m.count, m.offset, 1.0, "site")
             for m, hwc in sites]
    for shape, groups, sections, offset, label in (
            ((1, 128, 64, 256), 32, (64,), False, "B = 1"),
            ((200, 8, 4, 160), 32, None, False, "B = 200, identity"),
            ((200, 9, 5, 128), 32, (32,), True, "B = 200, offset"),
            ((2, 16, 8, 64), 4, (16,), False, "near-constant"),
            ((3, 11, 7, 36), 3, (9,), True, "odd: C4 % 8, H*W = 77"),
            ((3, 5, 7, 30), 5, None, False, "odd: C4 % 4, identity"),
            ((BATCH_ROWS, 8, 4, 160), 32, None, False, "the identity site"),
            ((BATCH_ROWS, 129, 65, 128), 32, (32,), True, "largest offset site"),
            ((1, 512, 128, 256), 32, (64,), False, "reread: K = the grid"),
            ((2, 4, 4, 4096), 1024, None, False, "C4 4096, G 1024")):
        group_of, count = plan(shape[-1], groups, sections)
        cases.append((shape, groups, group_of.to(torch.int32).to(device), count, offset,
                      1e-3 if label == "near-constant" else 1.0, label))
    log(f"[30] gn_silu_nhwc_backward (csrc/gn_silu_nhwc_bwd.cu, {NHWC_BWD_LAUNCHES_PER_CALL} "
        f"kernel a call) vs its plain backward at the {len(sites)} sites of the packed engine, "
        f"batch {BATCH_ROWS}, and {len(cases) - len(sites)} edge cases, with the statistics the "
        f"forward kernel wrote; |d| <= {BWD_REL} x scale + rtol x |want|, rtol {BWD_RTOL}")
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_abs = {"float32": 0.0, "bfloat16": 0.0}
    for shape, groups, group_of, count, offset, spread, label in cases:
        for dtype_name, ok, errs, max_abs, p in check_nhwc_backward(shape, groups, group_of,
                                                                     count, offset, spread, gen):
            if errs is None:
                log(f"    {label:22s} {str(shape):20s} G={groups:<3d} {dtype_name:8s} finite, "
                    f"repeated bit for bit (ill-conditioned: not held)  {nhwc_bwd_plan_text(p)}")
                continue
            worst[dtype_name] = max(worst[dtype_name], *errs.values())
            worst_abs[dtype_name] = max(worst_abs[dtype_name], max_abs)
            log(f"    {label:22s} {str(shape):20s} G={groups:<3d} count={count:<3d} "
                f"{'offset' if offset else 'plain ':6s} {dtype_name:8s} max|d|/scale dx "
                f"{errs['dx']:.2e} dscale {errs['dscale']:.2e} dbias {errs['dbias']:.2e} stats "
                f"{errs['stats']:.2e} {'ok' if ok else 'OVER'}  {nhwc_bwd_plan_text(p)}")
            if not ok:
                fail(f"gn_silu_nhwc_backward disagrees with its plain backward at {shape} "
                     f"{dtype_name}")
    log("    every call repeated bit for bit")

    def inputs(shape, dtype, group_of, groups, count, offset):
        x = torch.randn(shape, device=device, generator=gen).to(dtype)
        if offset:
            x *= torch.from_numpy(offset_mask(shape[1], shape[2], shape[3] // 4)).to(device,
                                                                                     dtype)
        dy = torch.randn(shape, device=device, generator=gen).to(dtype)
        sc = (torch.rand(shape[-1], device=device, generator=gen) + 0.5).contiguous()
        bi = (torch.randn(shape[-1], device=device, generator=gen) * 0.1).contiguous()
        stats = torch.empty((shape[0], groups, 2), device=device)
        order = group_order(group_of, groups)
        gn_silu_nhwc(x, sc, bi, group_of, groups, count, offset, order=order, stats=stats)
        return x, dy, (sc, bi, group_of, groups, count, offset), order, stats

    def is_bwd(key):
        return NHWC_BWD_KERNEL in key

    big = max((s for s in sites if not s[0].offset), key=lambda s: math.prod(s[1]))
    m, hwc = big
    shape = (BATCH_ROWS,) + hwc
    timing = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x, dy, args, order, stats = inputs(shape, dtype, m.group_of, m.groups, m.count, m.offset)
        xr, sr, br = x.clone().requires_grad_(), args[0].clone().requires_grad_(), \
            args[1].clone().requires_grad_()
        y = gn_silu_nhwc_reference(xr, sr, br, *args[2:])

        def kernel():
            return gn_silu_nhwc_backward(x, dy, *args, order=order, stats=stats)

        kernel_ms = cuda_time_ms(kernel, 20)
        plain_ms = cuda_time_ms(lambda: gn_silu_nhwc_backward_reference(x, dy, *args), 10)
        autograd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(y, (xr, sr, br), dy, retain_graph=True), 10)
        kernel_ms2 = cuda_time_ms(kernel, 20)
        t_us, seen = device_time_us(kernel, is_bwd)
        if not 1 <= seen <= 5 * NHWC_BWD_LAUNCHES_PER_CALL:
            fail(f"the profiler saw {seen} launches of the NHWC backward kernels for 5 calls")
        bound_ms, bound_by, n_bytes = nhwc_bwd_bound(x, m.groups)
        call_us = t_us * NHWC_BWD_LAUNCHES_PER_CALL
        timing[dtype_name] = {"ms": kernel_ms, "ms_again": kernel_ms2, "plain_ms": plain_ms,
                              "autograd_ms": autograd_ms, "device_us": call_us,
                              "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"    {list(shape)} {dtype_name} G={m.groups} (the largest site): kernel "
            f"{kernel_ms:.4f} / {kernel_ms2:.4f} ms (device {call_us:.1f} us a call, "
            f"{bound_ms * 1e3 / call_us:.2f} of the bound), plain {plain_ms:.4f} ms, torch "
            f"autograd of gn_silu_nhwc_reference {autograd_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {n_bytes} B at 3.35 TB/s); {n_bytes / kernel_ms / 1e6:.0f} GB/s; "
            f"{nhwc_bwd_plan_text(nhwc_backward_plan_of(x, m.groups))}")
        del y, xr
    # the identity site: F.silu(F.group_norm()) on the channels-last view computes
    # the same function there; its autograd is the yardstick (no single call)
    ident = next((mm, h) for mm, h in sites if mm.count == h[-1] // mm.groups
                 and torch.equal(mm.group_of.cpu(), torch.arange(h[-1], dtype=torch.int32)
                                 // mm.count))
    im, ihwc = ident
    x, dy, args, order, stats = inputs((BATCH_ROWS,) + ihwc, torch.bfloat16, im.group_of,
                                       im.groups, im.count, False)
    x_cl = x.permute(0, 3, 1, 2).detach().requires_grad_()
    w_l = args[0].to(x.dtype).requires_grad_()
    b_l = args[1].to(x.dtype).requires_grad_()
    y_l = F.silu(F.group_norm(x_cl, im.groups, w_l, b_l, 1e-5))
    dy_cl = dy.permute(0, 3, 1, 2)
    ident_ms = cuda_time_ms(lambda: gn_silu_nhwc_backward(x, dy, *args, order=order,
                                                          stats=stats), 20)
    library_autograd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(y_l, (x_cl, w_l, b_l), dy_cl, retain_graph=True), 20)
    ident_us, _ = device_time_us(lambda: gn_silu_nhwc_backward(x, dy, *args, order=order,
                                                               stats=stats), is_bwd)
    log(f"    the identity site {[BATCH_ROWS] + list(ihwc)} bf16: kernel {ident_ms:.4f} ms by "
        f"events (the wrapper's host work and the launch), "
        f"{ident_us * NHWC_BWD_LAUNCHES_PER_CALL:.1f} us of device time, "
        f"torch autograd of F.silu(F.group_norm()) on the channels-last view "
        f"{library_autograd_ms:.4f} ms, bound {nhwc_bwd_bound(x, im.groups)[0]:.4f} ms")
    del y_l
    site_us, per_site = [], []
    for mm, h in sites:
        x, dy, args, order, stats = inputs((BATCH_ROWS,) + h, torch.bfloat16, mm.group_of,
                                           mm.groups, mm.count, mm.offset)

        def call():
            return gn_silu_nhwc_backward(x, dy, *args, order=order, stats=stats)

        t_us, seen = device_time_us(call, is_bwd)
        if not seen:
            fail(f"the profiler saw no NHWC backward kernel at {h}; its windows' device events: "
                 f"{UNSEEN_WINDOWS[-3:]}")
        call_us = t_us * NHWC_BWD_LAUNCHES_PER_CALL
        events_us = cuda_time_ms(call, 20) * 1e3
        b_us = nhwc_bwd_bound(x, mm.groups)[0] * 1e3
        p = nhwc_backward_plan_of(x, mm.groups)
        site_us.append((call_us, b_us))
        per_site.append({"site": [BATCH_ROWS] + list(h), "offset": bool(mm.offset),
                         "device_us": call_us, "events_us": events_us, "bound_us": b_us,
                         "waves": p.waves})
        log(f"       {str(list(h)):16s} {'offset' if mm.offset else 'plain ':6s} device "
            f"{call_us:7.1f} us a call, events {events_us:7.1f} us, bound {b_us:6.2f} us "
            f"({b_us / call_us:.2f} of it); {nhwc_bwd_plan_text(p)}")
    per_step_ms = sum(t for t, _ in site_us) / 1e3
    bound_sum = sum(b for _, b in site_us) / 1e3
    log(f"    the {len(sites)} sites of one batch-{BATCH_ROWS} packed step, bf16, device time of "
        f"the backward kernels alone (profiler, 5 calls a site): {per_step_ms:.4f} ms "
        f"({per_step_ms / len(sites) * 1e3:.1f} us a site), bound {bound_sum:.4f} ms "
        f"({bound_sum / per_step_ms:.2f} of it); no single PyTorch call computes this gradient "
        "(library_ms null; the yardsticks are torch autograd of the plain version and, at the "
        "identity site, of F.silu(F.group_norm()))")
    bf = timing["bfloat16"]
    return {"name": "gn_silu_nhwc_backward", "route": "cuda",
            "source": "sddm_tpu_torch/csrc/gn_silu_nhwc_bwd.cu",
            "design": "redesigned for Hopper: one cooperative launch of one 512-thread block "
                      "an SM; each (row, range) item's x, dy and row statistics copied once into "
                      "shared memory by TMA bulk copies, two items a block where they fit, the "
                      "next copied in four chunks as dx is written from its slot; per item the "
                      "sums of dz and dz xhat and a release add on the row's integer ticket, "
                      "then, once the row's K items have taken theirs, the row's group sums in "
                      "rank order and dx from shared memory (float32 keeps dz in dy's place); "
                      "the rows' channel sums and dscale/dbias after grid barriers; the forward "
                      "kernel writes the [B, G, 2] statistics; no float atomics; plan "
                      "ops/gn_silu.py::nhwc_backward_plan",
            "replaces": "sddm_tpu/experimental/pallas_gn_silu.py:142",
            "replaces_note": "no Pallas counterpart: JAX differentiates the packed engine's jnp "
                             "_GN -> silu -> mask through XLA; the backward of the kernel of "
                             "that line",
            "max_abs_err": worst_abs["bfloat16"], "max_abs_err_f32": worst_abs["float32"],
            "max_err_to_scale": worst["bfloat16"], "max_err_to_scale_f32": worst["float32"],
            "ms": bf["ms"], "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": None, "autograd_ms": bf["autograd_ms"],
            "device_us": bf["device_us"], "f32": timing["float32"], "shape": list(shape),
            "dtype": "bfloat16",
            "identity_site": {"shape": [BATCH_ROWS] + list(ihwc), "ms": ident_ms,
                              "device_us": ident_us * NHWC_BWD_LAUNCHES_PER_CALL,
                              "library_autograd_ms": library_autograd_ms},
            "sites": per_site,
            "sites_per_step_device_ms": per_step_ms, "bound_sites_per_step_ms": bound_sum}


def plain_nhwc_directions():
    """Both directions of the packed twin's GroupNorm sites on their plain
    versions (the plain backward takes no ``order`` and recomputes the
    statistics)."""
    from sddm_tpu_torch.models import unet_packed
    from sddm_tpu_torch.ops.gn_silu import gn_silu_nhwc_backward_reference

    def backward(*args, order=None, stats=None, **kwargs):
        return gn_silu_nhwc_backward_reference(*args, **kwargs)

    stack = contextlib.ExitStack()
    stack.enter_context(plain_gn_silu_nhwc())
    stack.enter_context(routed(unet_packed, "gn_silu_nhwc_backward", backward))
    return stack


def packed_train_step_phase(config, net_args, device, plain_step: dict) -> dict:
    """Phase 31: one packed train step of the flagship (``SDDM_PACKED_TRAIN=1``'s
    network, batch 16, the config's AMSGrad), [24]'s weights, batch and draws:
    the kernel path against both NHWC directions on their plain versions in
    bf16 and f32, the twin against the plain network in f32, its launches,
    the median step, peak memory and one profiled step beside [24]'s."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.cli import build_arch, build_optimizer
    from sddm_tpu_torch.models import PackedTrainUNetModified2, UNetModified2
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.models.unet_packed import plain_network
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_nhwc,
        gn_silu_nhwc_backward,
    )
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step
    from sddm_tpu_torch.utils.profiling import profiled

    ns = config["num_samples"]
    target, condition, diffusion, draws, gen = train_batch(config, device)
    twins = [PackedTrainUNetModified2(UNetModified2(num_samples=ns, **net_args).to(device))
             for _ in range(2)]
    init_parameters(twins[0], torch.Generator().manual_seed(SEED))  # [24]'s weights
    initial = {k: v.clone() for k, v in twins[0].net.state_dict().items()}
    lr = config["optimizer"]["args"]["lr"]
    record = {}

    def fresh(dtype, network):
        """The train step of ``network`` (a twin or the plain network) from the
        initial weights in ``dtype``."""
        plain_network(network).load_state_dict(initial)
        plain_network(network).dtype = dtype
        optimizer = build_optimizer(config, network)
        return make_train_step(build_arch(config, diffusion, network), l1_loss, optimizer)

    def counts():
        return (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches, gn_silu.launches,
                gn_silu_backward.launches)

    failures, kernel_f32 = [], None
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        step_k, step_p = fresh(dtype, twins[0]), fresh(dtype, twins[1])
        gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = 0
        gn_silu.launches = gn_silu_backward.launches = 0
        loss_k = step_k(target, condition, draws=draws)
        torch.cuda.synchronize()
        launches = counts()
        if launches != (PACKED_SITES, PACKED_SITES, 0, 0):
            fail(f"one {dtype_name} packed train step launched gn_silu_nhwc / its backward / "
                 f"gn_silu / its backward {launches} times, expected ({PACKED_SITES}, "
                 f"{PACKED_SITES}, 0, 0)")
        with plain_nhwc_directions():
            loss_p = step_p(target, condition, draws=draws)
        torch.cuda.synchronize()
        if counts() != launches:
            fail("the routed packed step launched a GroupNorm kernel")
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(twins[0], twins[1], lr)
        tol = TRAIN_TOL[dtype_name]
        readings = (loss_rel, grad_rel, worst_rel, apart)
        ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
        record[dtype_name] = {
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst_rel,
            "worst_param": worst_name, "updates_apart_share": apart, "param_max_abs_diff": dmax,
            "tol": list(tol), "launches": list(launches[:2])}
        log(f"[31] one {dtype_name} packed train step (PackedTrainUNetModified2), batch "
            f"{BATCH_ROWS}: kernel path vs both NHWC directions plain, [24]'s weights, batch and "
            f"draws: loss {float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_rel:.2e}, tol "
            f"{tol[0]}); gradients rel L2 {grad_rel:.2e} (tol {tol[1]}), worst parameter "
            f"{worst_name} {worst_rel:.2e} (tol {tol[2]}); parameters after the step: max|d| "
            f"{dmax:.2e} (<= 2 lr), share apart by > lr/2 {apart:.2e} (tol {tol[3]}) "
            f"{'ok' if ok else 'OVER'}; launches {launches[0]} gn_silu_nhwc + {launches[1]} "
            f"gn_silu_nhwc_backward calls, none of the NCHW kernels")
        if not ok:
            failures.append(f"{dtype_name}: {readings}")
        if dtype == torch.float32:
            kernel_f32 = float(loss_k)
    # float32, TF32 off: the twin (kernel path, its state from the loop's last
    # turn) against the plain network's step from the same weights and draws
    plain = UNetModified2(num_samples=ns, **net_args).to(device)
    step_plain = fresh(torch.float32, plain)
    loss_plain = step_plain(target, condition, draws=draws)
    torch.cuda.synchronize()
    loss_rel = abs(kernel_f32 - float(loss_plain)) / abs(float(loss_plain))
    grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(twins[0].net, plain, lr)
    readings = (loss_rel, grad_rel, worst_rel, apart)
    ok = all(r <= t for r, t in zip(readings, TWIN_VS_PLAIN_F32_TOL))
    record["twin_vs_plain_f32"] = {"loss_twin": kernel_f32, "loss_plain": float(loss_plain),
                                   "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                                   "worst_param_grad_rel_l2": worst_rel, "worst_param": worst_name,
                                   "updates_apart_share": apart,
                                   "tol": list(TWIN_VS_PLAIN_F32_TOL)}
    log(f"    float32, TF32 off: the packed twin vs the plain network ([24]'s step: NCHW "
        f"kernels), same weights, batch and draws: loss rel {loss_rel:.2e}, gradients rel L2 "
        f"{grad_rel:.2e}, worst parameter {worst_name} {worst_rel:.2e}, share apart {apart:.2e} "
        f"(tol {TWIN_VS_PLAIN_F32_TOL}) {'ok' if ok else 'OVER'}")
    if not ok:
        failures.append(f"twin vs plain f32: {readings}")
    if failures:
        fail(f"the packed train step differs: {failures}")
    del plain, twins[1]

    twin = twins[0]
    step = fresh(torch.bfloat16, twin)
    for _ in range(3):
        step(target, condition, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        start = time.perf_counter()
        step(target, condition, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    step_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated()
    for _ in range(3):  # a window in which the profiler saw no kernel of ours is taken again
        gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - start) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events}
        fwd_kernels = sum(v[1] for k, v in busy.items() if NHWC_KERNEL in k)
        bwd_kernels = sum(v[1] for k, v in busy.items() if NHWC_BWD_KERNEL in k)
        if fwd_kernels and bwd_kernels:
            break
    calls = (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches)
    log(f"    profiled step: {fwd_kernels} {NHWC_KERNEL} and {bwd_kernels} {NHWC_BWD_KERNEL}* "
        f"kernels run on the device for {calls[0]} gn_silu_nhwc and {calls[1]} "
        f"gn_silu_nhwc_backward calls")
    if calls != (PACKED_SITES, PACKED_SITES) or fwd_kernels != PACKED_SITES or \
            bwd_kernels != PACKED_SITES * NHWC_BWD_LAUNCHES_PER_CALL:
        fail(f"the profiled packed step ran {fwd_kernels} forward and {bwd_kernels} backward "
             f"kernels for {calls} calls, expected {PACKED_SITES} and "
             f"{PACKED_SITES * NHWC_BWD_LAUNCHES_PER_CALL}")
    busy_ms = sum(v[0] for v in busy.values())
    bwd_ms = sum(v[0] for k, v in busy.items() if NHWC_BWD_KERNEL in k)
    fwd_ms = sum(v[0] for k, v in busy.items() if NHWC_KERNEL in k)
    record["launches"] = {"gn_silu_nhwc": calls[0], "gn_silu_nhwc_backward": calls[1],
                          "forward_kernels": fwd_kernels, "backward_kernels": bwd_kernels}
    record.update({"step_ms_median": step_ms, "step_ms_min": min(times) * 1e3,
                   "step_ms_max": max(times) * 1e3, "peak_bytes": peak,
                   "profile": {"wall_ms": prof_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1 - busy_ms / step_ms if busy_ms else None,
                               "backward_kernel_ms": bwd_ms, "forward_kernel_ms": fwd_ms}})
    p24 = plain_step.get("profile", {})
    log(f"    bf16 packed train step: median {step_ms:.2f} ms over {TRAIN_TIMED_STEPS} (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), peak {peak / 2**20:.1f} MiB; "
        f"[24]'s plain step: median {plain_step['step_ms_median']:.2f} ms, peak "
        f"{plain_step['peak_bytes'] / 2**20:.1f} MiB, device busy "
        f"{p24.get('device_busy_ms') or 0:.2f} ms, idle share {p24.get('idle_share') or 0:.3f}")
    if busy_ms > 0:
        log(f"    profiled packed step: device busy {busy_ms:.2f} ms, idle share "
            f"{1 - busy_ms / step_ms:.3f} of the median step ({1 - busy_ms / prof_ms:.3f} of the "
            f"profiled wall, {prof_ms:.1f} ms); NHWC backward kernels {bwd_ms:.3f} ms "
            f"({bwd_ms / busy_ms:.3f} of busy), forward {NHWC_KERNEL} {fwd_ms:.3f} ms "
            f"({fwd_ms / busy_ms:.3f}); {sum(v[1] for v in busy.values())} kernels in all")
        for name, (ms, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:14]:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{count:<5d} {name[:90]}")
        if bwd_ms <= 0:
            fail("the profiled packed step shows no time under the NHWC backward kernels' names")
    else:
        log("    the profiler saw no device time: breakdown not measured")
    return record


def tree_paths(tree, path=()):
    """The sorted (path, shape) leaves of a nested dict of arrays."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += tree_paths(v, path + (k,))
        else:
            out.append((path + (k,), tuple(getattr(v, "shape", ()))))
    return sorted(out)


def packed_training_cli_phase(work: Path, val_root: Path, audios, device) -> dict:
    """Phase 32: ``SDDM_PACKED_TRAIN=1 python -m sddm_tpu_torch.train`` (in this
    process), resumed from the committed epoch-250 checkpoint on [25]'s 400
    files for ``RESUME_EPOCHS``: each epoch's mean loss within
    ``RESUME_LOSS``; its checkpoint read back (the plain tree's names and
    shapes, the optimizer count) and served by ``load_enhancer``."""
    import os

    import numpy as np
    import torch

    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.models.unet_packed import PackedUNetModified2
    from sddm_tpu_torch.train.checkpoints import CKPT_CURRENT, load_checkpoint

    train_root = work / "train_split" / "train"  # [25]'s files
    steps = math.ceil(TRAIN_FILES / BATCH_ROWS)
    committed = load_checkpoint(RUN / "model_best.ckpt", with_opt_state=True)
    start_epoch = committed["epoch"] + 1
    path = train_config(work, "train_packed_resumed", train_root, val_root,
                        epochs=start_epoch + RESUME_EPOCHS - 1, valid_period=25, save_period=1)
    kept = os.environ.get("SDDM_PACKED_TRAIN")
    os.environ["SDDM_PACKED_TRAIN"] = "1"
    try:
        b = run_train(["-c", str(path), "-r", str(RUN / "model_best.ckpt")])
    finally:
        if kept is None:
            os.environ.pop("SDDM_PACKED_TRAIN")
        else:
            os.environ["SDDM_PACKED_TRAIN"] = kept
    resumed = [(e, log_["loss"]) for e, log_ in b["logs"]]
    inside = all(RESUME_LOSS[0] <= x <= RESUME_LOSS[1] for _, x in resumed)
    want = RESUME_EPOCHS * steps * PACKED_SITES
    log(f"[32] SDDM_PACKED_TRAIN=1 python -m sddm_tpu_torch.train -r "
        f"artifacts/flagship_synth/model_best.ckpt (epoch {start_epoch - 1}): network "
        f"{b['network']}; epochs {', '.join(f'{e}: {x:.5f}' for e, x in resumed)} (limit "
        f"{RESUME_LOSS}) {'ok' if inside else 'OVER'}; launches gn_silu_nhwc "
        f"{b['nhwc_launches'][0]}, gn_silu_nhwc_backward {b['nhwc_launches'][1]} (expected "
        f"{want} each: {PACKED_SITES} x {steps} x {RESUME_EPOCHS}), NCHW {b['launches']}; wall "
        f"{b['seconds']:.1f} s")
    if b["network"] != "PackedTrainUNetModified2" or \
            [e for e, _ in resumed] != list(range(start_epoch, start_epoch + RESUME_EPOCHS)) or \
            not inside:
        fail(f"packed training: network {b['network']}, epoch losses {resumed} (limit "
             f"{RESUME_LOSS})")
    if tuple(b["nhwc_launches"]) != (want, want) or tuple(b["launches"]) != (0, 0):
        fail(f"packed training launched NHWC {b['nhwc_launches']}, NCHW {b['launches']}")

    ckpt = load_checkpoint(b["run"] / CKPT_CURRENT, with_opt_state=True)
    count = int(ckpt["opt_state"]["0"]["count"])
    want_count = int(committed["opt_state"]["0"]["count"]) + RESUME_EPOCHS * steps
    same_tree = tree_paths(ckpt["params"]) == tree_paths(committed["params"])
    start = time.perf_counter()
    enh = load_enhancer(b["run"] / CKPT_CURRENT, json.loads(path.read_text()),
                        batch_rows=BATCH_ROWS, steps=STEPS)
    out = enh.enhance_batch(audios)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - start
    served_ok = all(y.shape == x.shape and np.isfinite(y).all() for x, y in zip(audios, out))
    log(f"    {CKPT_CURRENT}: epoch {ckpt['epoch']}, optimizer count {count} (expected "
        f"{want_count}), the committed checkpoint's parameter names and shapes: {same_tree}; "
        f"load_enhancer serves {type(enh.model.network).__name__} (canary "
        f"{'passed' if enh.engine_fallback is None else enh.engine_fallback}), {len(audios)} "
        f"requests finite: {served_ok}; load and serve {serve_s:.2f} s")
    if count != want_count or ckpt["epoch"] != start_epoch + RESUME_EPOCHS - 1 or \
            not same_tree or not served_ok or \
            not isinstance(enh.model.network, PackedUNetModified2):
        fail(f"the packed-trained checkpoint: count {count}, epoch {ckpt['epoch']}, plain tree "
             f"{same_tree}, served finite {served_ok}, engine "
             f"{type(enh.model.network).__name__}")
    return {"epoch_losses": dict(resumed), "limit": list(RESUME_LOSS),
            "launches": list(b["nhwc_launches"]), "seconds": b["seconds"], "count": count,
            "served": {"engine": type(enh.model.network).__name__, "seconds": serve_s}}


def requests(n: int = 4):
    """Seeded noisy requests of 1-3 s at 16 kHz: harmonic tones under a
    syllable-rate envelope plus white noise at 5 dB SNR."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    out = []
    for length in (17011, 30977, 46301, 23456)[:n]:
        t = np.arange(length) / 16000.0
        f0 = rng.uniform(100, 250)
        clean = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k
                    for k in range(1, 6))
        clean *= 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t)) * 0.1
        noise = rng.standard_normal(length)
        noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** 0.5)
        out.append((clean + noise).astype(np.float32))
    return out


def main() -> int:
    import numpy as np
    import torch

    # -- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "sddm_tpu_torch").is_dir() or not all(
            (d / "model_best.ckpt").is_file() for d in (RUN, VOCODER)):
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import sddm_tpu_torch
    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.models import UNetModified2
    from sddm_tpu_torch.ops import diffwave_stack as dw_ops
    from sddm_tpu_torch.ops.gn_silu import (
        build,
        build_backward,
        build_nhwc_backward,
        gn_silu,
        gn_silu_reference,
        nchw_max_clusters,
        nchw_plan,
        nhwc_backward_blocks_per_sm,
        nhwc_backward_plan,
        nhwc_plan,
    )

    if Path(sddm_tpu_torch.__file__).resolve().parent != ROOT / "sddm_tpu_torch":
        fail(f"imported sddm_tpu_torch from {sddm_tpu_torch.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1] device: {kind} | nvidia-smi: {smi} | count {torch.cuda.device_count()}")
    log(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # -- 2. build: one nvcc per kernel source, started together -------------
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(fn) for fn in (build, dw_ops.build, build_backward,
                                             build_nhwc_backward)]
        built, dw_built, bwd_built, nhwc_bwd_built = (f.result() for f in builds)
    for b in (built, bwd_built, nhwc_bwd_built):
        log(f"[2] build: {b['path'].name} in {b['seconds']:.2f} s"
            f"{' (cached)' if b['cached'] else ''}")
        for line in b["log"].splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill", "stack frame")):
                log(f"    ptxas: {line.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = nhwc_plan(BATCH_ROWS, 128, 64, 256, 32, 2, True, sms)
    log(f"    {NHWC_KERNEL} at the largest packed site [{BATCH_ROWS}, 128, 64, 256] bf16 on "
        f"{sms} SMs: {big.grid} blocks of 512 threads, {big.smem} bytes of dynamic shared "
        f"memory each, {big.staged} of {big.rows} positions a block staged")
    bwd_per_sm = {e: nhwc_backward_blocks_per_sm(device, e, True) for e in (2, 4)}
    big_b = nhwc_backward_plan(BATCH_ROWS, 128, 64, 256, 32, 2, True, sms, bwd_per_sm[2])
    log(f"    nhwc_bwd_fused: cudaOccupancyMaxActiveBlocksPerMultiprocessor at its largest "
        f"shared memory {bwd_per_sm[2]} (bf16), {bwd_per_sm[4]} (f32); at the largest packed "
        f"site bf16 {nhwc_bwd_plan_text(big_b)}")
    big_c = nchw_plan(BATCH_ROWS, 64, 256 * 128, 32, 2, True, sms)
    held = nchw_max_clusters(big_c, 2, True) if big_c.q > 1 else "n/a (no cluster)"
    log(f"    gn_silu_nchw at the largest plain site [{BATCH_ROWS}, 64, 256, 128] bf16: "
        f"{nchw_plan_text(big_c)} ({big_c.slice * 16} bytes a CTA, {big_c.packs} 16-byte packs "
        f"a thread); cudaOccupancyMaxActiveClusters {held}")
    sass = sass_counts(built["path"])
    log(f"    SASS of {built['path'].name}: UBLKCP (bulk copy) {sass['UBLKCP']}")

    # -- 3. kernel vs plain at every flagship site ----------------------------
    config = json.loads((RUN / "config.json").read_text())
    net_args = {k: v for k, v in config["network"]["args"].items() if k != "dropout"}
    probe = UNetModified2(num_samples=config["num_samples"], **net_args).to(device).eval()
    sites = net_sites(probe, config["num_samples"], device)
    del probe
    if len(sites) != SITES_PER_FORWARD:
        fail(f"expected {SITES_PER_FORWARD} GroupNorm sites per forward, found {len(sites)}")
    distinct = sorted(set(sites), key=lambda s: -math.prod(s[0]))
    log(f"[3] {len(sites)} GroupNorm+SiLU sites per forward, {len(distinct)} distinct "
        f"(C, H, W), G; checking each at batch {BATCH_ROWS}")
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    cases = [((BATCH_ROWS,) + chw, g, 1.0) for chw, g in distinct]
    cases += [((3, 12, 7, 5), 4, 1.0),        # cg 3, H*W = 35: the unaligned path
              ((2, 16, 8, 8), 16, 1e-3),      # near-constant groups at 1000
              ((1, 64, 256, 128), 32, 1.0),   # B = 1
              ((200, 160, 8, 4), 32, 1.0),    # B = 200: several runs a CTA
              ((2, 4, 1024, 2560), 2, 1.0),   # runs over 4x what a cluster holds: the reread
              ((16, 64, 257, 136), 32, 1.0),  # runs not a multiple of q packs (bf16 3 x 2185 + 2183)
              ((4, 8, 129, 129), 4, 1.0)]     # one element a load (H*W odd) on a cluster of 8
    for shape, g, spread in cases:
        for dtype_name, ok, err, plan in check_nchw(shape, g, spread, gen, sms):
            max_err[dtype_name] = max(max_err[dtype_name], err)
            log(f"    {str(shape):22s} G={g:<3d} {dtype_name:8s} max|d|={err:.3e} "
                f"{'ok' if ok else 'OVER'} (atol, rtol {TOL[dtype_name]})  {plan}")
            if not ok:
                fail(f"kernel disagrees with gn_silu_reference at {shape} {dtype_name}")

    # -- 4. load the flagship through the port, the plain engine ---------------
    t0 = time.perf_counter()
    enh = load_enhancer(RUN / "model_best.ckpt", config, batch_rows=BATCH_ROWS, steps=STEPS,
                        packed=False)
    torch.cuda.synchronize()
    net = enh.model.network
    if type(net) is not UNetModified2:
        fail(f"load_enhancer(packed=False) served {type(net).__name__}")
    log(f"[4] load_enhancer(steps={STEPS}, packed=False) on {enh.device}: "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in net.parameters())} params, compute {net.dtype}, "
        f"{enh.model.num_timesteps} steps")
    if enh.model.num_timesteps != STEPS or net.dtype != torch.bfloat16:
        fail("the served model is not the bf16 ancestral-12 recipe")

    # -- 5. serve ------------------------------------------------------------
    audios = requests()
    n_rows = sum(math.ceil(a.size / config["num_samples"]) for a in audios)
    n_batches = math.ceil(n_rows / BATCH_ROWS)

    def serve(seed):
        return serve_requests(enh, audios, seed, device)

    _, warm_s = serve(SEED + 1)  # cuDNN autotuning and allocator warm-up
    torch.cuda.reset_peak_memory_stats()
    gn_silu.launches = 0
    served, serve_s = serve(SEED)
    launches = gn_silu.launches
    peak = torch.cuda.max_memory_allocated()
    audio_s = sum(a.size for a in audios) / config["sample_rate"]
    log(f"[5] served {len(audios)} requests ({audio_s:.2f} s of audio, {n_rows} rows, "
        f"{n_batches} batches): warm-up {warm_s:.3f} s, timed {serve_s:.3f} s "
        f"(RTF {serve_s / audio_s:.4f}), gn_silu.launches {launches}, "
        f"peak {peak / 2**20:.1f} MiB")
    for a, y in zip(audios, served):
        if y.shape != a.shape or not np.isfinite(y).all() or np.abs(y).max() > 1.0:
            fail(f"served output shape {y.shape} for input {a.shape}, "
                 f"finite {np.isfinite(y).all()}")
    expected = SITES_PER_FORWARD * STEPS * n_batches
    if launches != expected:
        fail(f"gn_silu.launches = {launches}, expected {expected} "
             f"({SITES_PER_FORWARD} sites x {STEPS} steps x {n_batches} batches)")

    # -- 6. the same requests through the plain GroupNorm+SiLU ----------------
    e2e = {}
    for dtype in (torch.bfloat16, torch.float32):
        net.dtype = dtype
        kernel_out, kernel_s = served, serve_s
        if dtype != torch.bfloat16:
            serve(SEED + 1)  # cuDNN picks its float32 algorithms
            kernel_out, kernel_s = serve(SEED)
        with plain_gn_silu():
            plain_out, plain_s = serve(SEED)
        name = str(dtype).split(".")[-1]
        err, rel = served_differences(kernel_out, plain_out)
        e2e[name] = {"max_abs": err, "rel_l2": rel, "kernel_s": kernel_s, "plain_s": plain_s}
        tol_abs, tol_rel = E2E_TOL[name]
        log(f"[6] {name}: kernel path vs plain path, same weights and noise: "
            f"max|d|={err:.3e} (tol {tol_abs}) rel_l2={rel:.3e} (tol {tol_rel}); "
            f"serve {kernel_s:.3f} s vs {plain_s:.3f} s")
        if not (err <= tol_abs and rel <= tol_rel):
            fail(f"{name} served output differs from the plain path: max|d| {err}, "
                 f"rel_l2 {rel}")
    net.dtype = torch.float32
    rng = np.random.default_rng(SEED)
    n = config["num_samples"]
    cond = (0.1 * rng.standard_normal((1, 1, n))).astype(np.float32)
    x_t = (0.8 * cond + 0.3 * rng.standard_normal((1, 1, n))).astype(np.float32)
    level = np.full((1, 1, 1), 0.95, np.float32)
    with torch.no_grad():
        on_card = net(*(torch.from_numpy(a).to(device) for a in (cond, x_t, level)))
        cpu_net = UNetModified2(num_samples=n, **net_args).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        on_cpu = cpu_net(*(torch.from_numpy(a) for a in (cond, x_t, level)))
    card_cpu_err = float((on_card.cpu() - on_cpu).abs().max())
    log(f"    float32 forward, card (kernel) vs CPU (plain): max|d|={card_cpu_err:.3e} "
        f"(tol {CARD_VS_CPU_TOL})")
    if not card_cpu_err <= CARD_VS_CPU_TOL:
        fail(f"card forward differs from the CPU forward by {card_cpu_err}")
    net.dtype = torch.bfloat16

    # -- 7. timing at the largest site --------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.utils.profiling import profiled

    (c, h, w_), g = distinct[0]
    shape = (BATCH_ROWS, c, h, w_)
    x = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
    wt = torch.rand(c, device=device, generator=gen) + 0.5
    bt = torch.randn(c, device=device, generator=gen) * 0.1
    kernel_ms = cuda_time_ms(lambda: gn_silu(x, wt, bt, g))
    plain_ms = cuda_time_ms(lambda: gn_silu_reference(x, wt, bt, g))
    two_call_ms = cuda_time_ms(lambda: F.silu(F.group_norm(x, g, wt.to(x.dtype),
                                                           bt.to(x.dtype), 1e-5)))
    kernel_ms2 = cuda_time_ms(lambda: gn_silu(x, wt, bt, g))
    bound_ms, bound_by, bytes_moved = gn_bound(x, 2 * c * 4)
    site_ms = {}
    for (cs, hs, ws), gs in distinct:
        xs = torch.randn((BATCH_ROWS, cs, hs, ws), device=device,
                         generator=gen).to(torch.bfloat16)
        ones, zeros = torch.ones(cs, device=device), torch.zeros(cs, device=device)
        site_ms[(cs, hs, ws, gs)] = (cuda_time_ms(lambda: gn_silu(xs, ones, zeros, gs), 20),
                                     cuda_time_ms(lambda: gn_silu_reference(xs, ones, zeros, gs), 20),
                                     gn_bound(xs, 2 * cs * 4)[0])
    per_forward = [sum(site_ms[chw + (gs,)][i] for chw, gs in sites) for i in (0, 1, 2)]
    site_us = {}  # the kernel alone: the profiler's device time a launch, 5 calls a site
    for (cs, hs, ws), gs in distinct:
        xs = torch.randn((BATCH_ROWS, cs, hs, ws), device=device,
                         generator=gen).to(torch.bfloat16)
        ones, zeros = torch.ones(cs, device=device), torch.zeros(cs, device=device)
        t_us, seen = device_time_us(lambda: gn_silu(xs, ones, zeros, gs), is_nchw_kernel)
        if not 1 <= seen <= 5:
            fail(f"the profiler saw {seen} launches of the NCHW gn_silu kernel for 5 calls at "
                 f"{(cs, hs, ws)}")
        site_us[(cs, hs, ws, gs)] = t_us
    device_ms = sum(site_us[chw + (gs,)] for chw, gs in sites) / 1e3
    log(f"[7] {shape} bf16 G={g}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.silu(F.group_norm) {two_call_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved} B at 3.35 TB/s); "
        f"{bytes_moved / kernel_ms / 1e6:.0f} GB/s")
    for (cs, hs, ws, gs), (k_ms, p_ms, b_ms) in site_ms.items():
        log(f"    site [{BATCH_ROWS},{cs},{hs},{ws}] G={gs}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"device {site_us[(cs, hs, ws, gs)]:6.1f} us, bound {b_ms * 1e3:6.2f} us, "
            f"{sites.count(((cs, hs, ws), gs))} per forward; "
            f"{nchw_plan_text(nchw_plan(BATCH_ROWS, cs, hs * ws, gs, 2, True, sms))}")
    log(f"    all {len(sites)} sites of one batch-{BATCH_ROWS} forward: kernel {per_forward[0]:.3f} ms, "
        f"plain {per_forward[1]:.3f} ms, bound {per_forward[2]:.4f} ms; no single PyTorch call "
        f"computes GroupNorm+SiLU "
        f"(library_ms null; the two-call time is two_call_ms)")
    log(f"    the same {len(sites)} sites, device time of the NCHW kernel alone (profiler, 5 calls "
        f"a site): {device_ms:.4f} ms a forward ({device_ms / len(sites) * 1e3:.1f} us a site), "
        f"bound {per_forward[2]:.4f} ms")

    # -- 8. where the time goes: one served batch under the profiler ----------
    enh.generator = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    gn_silu.launches = 0
    with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        start = time.perf_counter()
        enh.enhance_batch(audios)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - start) * 1e3
    profiled_launches = gn_silu.launches
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in device_events}
    busy_ms = sum(busy.values())
    gn_ms = sum(v for k, v in busy.items() if is_nchw_kernel(k))
    gn_calls = sum(e.count for e in device_events if is_nchw_kernel(e.key))
    idle_share = 1 - busy_ms / (serve_s * 1e3)
    if busy_ms > 0:
        log(f"[8] profiled serve of the same batch: device busy {busy_ms:.1f} ms, idle share "
            f"{idle_share:.3f} of the unprofiled serve ({serve_s * 1e3:.1f} ms, phase 5); "
            f"{1 - busy_ms / prof_wall_ms:.3f} of the profiled wall ({prof_wall_ms:.1f} ms); "
            f"gn_silu kernel {gn_ms:.2f} ms ({gn_ms / busy_ms:.3f} of busy, x{gn_calls}, "
            f"{gn_ms / max(gn_calls, 1) * 1e3:.1f} us a call)")
        for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
            n_calls = next(e.count for e in device_events if e.key == name)
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{n_calls:<5d} {name[:90]}")
        if profiled_launches > 0 and not (gn_ms > 0 and gn_calls == profiled_launches):
            fail(f"gn_silu launched {profiled_launches} times in the profiled batch, but the "
                 f"profile shows {gn_calls} launches and {gn_ms} ms under the NCHW kernel's names")
    else:
        log("[8] the profiler saw no device time: breakdown not measured")

    nhwc_record, packed_serve = packed_phases(device, config, net_args, audios, enh, gen)
    dw_record, dw_serve = vocoder_phases(device, dw_built)
    del enh
    bwd_record = backward_phase(sites, distinct, gen)
    train_step = train_step_phase(config, net_args, device)
    bwd_record["launches"] = train_step["launches"]["gn_silu_backward"]
    # kernels the device ran per call in the profiled step (profiler count / wrapper count)
    bwd_record["kernels_per_call"] = (train_step["launches"]["backward_kernels"]
                                      / train_step["launches"]["gn_silu_backward"])
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        f2s = file_to_score_phases(work, smi, device)
        training = training_cli_phases(work, work / "synth" / "test", audios, device)
        vocoder_cli = vocoder_cli_phases(work, smi, device)
        nhwc_bwd_record = nhwc_backward_phase(config, net_args, device, gen)
        packed_step = packed_train_step_phase(config, net_args, device, train_step)
        packed_cli = packed_training_cli_phase(work, work / "synth" / "test", audios, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    nhwc_bwd_record["launches"] = packed_step["launches"]["gn_silu_nhwc_backward"]
    nhwc_bwd_record["kernels_per_call"] = (packed_step["launches"]["backward_kernels"]
                                           / packed_step["launches"]["gn_silu_nhwc_backward"])
    nhwc_bwd_record["launches_training_cli"] = packed_cli["launches"][1]
    nhwc_record["launches_packed_train_step"] = packed_step["launches"]["gn_silu_nhwc"]
    nhwc_record["launches_packed_training_cli"] = packed_cli["launches"][0]
    dw_record["launches_vocoder_end_check"] = vocoder_cli["layer_launches"]
    dw_record["max_abs_err_vocoder_end_check"] = vocoder_cli["max_abs_err"]
    nhwc_record["launches_file_to_score"] = f2s["nhwc_launches"]
    bwd_record["launches_training_cli"] = training["from_init"]["launches"][1]

    record_line = {"kernels": [{
        "name": "gn_silu",
        "route": "cuda",
        "source": "sddm_tpu_torch/csrc/gn_silu.cu",
        "replaces": "sddm_tpu/experimental/pallas_groupnorm_swish.py:98",
        "launches": launches,
        "max_abs_err": max_err["bfloat16"],
        "max_abs_err_f32": max_err["float32"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_file_to_score": f2s["nchw_launches"],
        "two_call_ms": two_call_ms,
        "shape": list(shape),
        "dtype": "bfloat16",
        "sites_per_forward_ms": per_forward[0],
        "sites_per_forward_device_ms": device_ms,
        "plain_sites_per_forward_ms": per_forward[1],
        "bound_sites_per_forward_ms": per_forward[2],
        "launches_train_step": train_step["launches"]["gn_silu_nchw"],
    }, nhwc_record, dw_record, bwd_record, nhwc_bwd_record], "serve": {"requests": len(audios), "rows": n_rows, "steps": STEPS,
                  "seconds": serve_s, "audio_seconds": audio_s, "peak_bytes": peak,
                  "e2e": e2e, "card_vs_cpu_f32": card_cpu_err,
                  "profile": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                              "idle_share": idle_share, "gn_silu_ms": gn_ms,
                              "gn_silu_profiled_launches": gn_calls}},
        "serve_packed": packed_serve,
        "serve_diffwave": dw_serve,
        "file_to_score": f2s["record"],
        "train_step": train_step,
        "training_cli": training,
        "vocoder_cli": vocoder_cli["record"],
        "packed_train_step": packed_step,
        "packed_training_cli": packed_cli,
        "build_seconds": {"gn_silu": built["seconds"], "diffwave_stack": dw_built["seconds"],
                          "gn_silu_backward": bwd_built["seconds"],
                          "gn_silu_nhwc_backward": nhwc_bwd_built["seconds"]},
        "nvidia_smi": smi}
    log(smi)
    print(json.dumps(record_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
