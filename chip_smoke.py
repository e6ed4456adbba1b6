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
 10. serve the four requests: shapes, trims, finiteness, every forward
     replayed from the engine's CUDA graph (captured by the canary; the
     ``gn_silu_nhwc`` wrapper called by no replay), no NCHW launch;
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
     show time and 33 sites x 12 steps x batches launches under its name
     (the graph's replays, counted on the device).
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
     batch served at its own row count); the ``gn_silu_nhwc`` wrapper called
     33 times by each eager forward and capture and by no replay, one replay of
     each graph the engine holds profiled (33 ``nhwc_gn_silu`` kernels on the
     device), every row of the corpus served once, every
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

Then the SNR-adaptive path, new with its slice (the committed estimator of
``artifacts/round5/snr_estimator``, ``configs/config_unet_snr_synth.json``;
every GroupNorm+SiLU site runs ``gn_silu`` forward and ``gn_silu_backward``
backward, the estimator's forward only):
 33. hold both NCHW kernels against their plain versions at the estimator's 7
     sites (down to [B, 640, 2, 1], the one-element path) at batch 8 and 16 and
     the variable network's distinct sites at batch 16, float32 and bfloat16,
     every call repeated bit for bit and its plan printed, at [3]'s and [23]'s
     limits;
 34. the committed estimator through the bridge on 16 crops of [26]'s v2 test
     split as its validation loader gives them (int16 PCM): SNR estimates, the
     kernel path against the plain path and the card against the CPU (float32,
     TF32 off), and its l2 loss against the ``segment_sisnr`` targets beside
     the committed val_loss;
 35. ``python -m sddm_tpu_torch.train_snr_estimator -r <that checkpoint>`` (in
     this process) on [26]'s 200 train files for 2 epochs of 25 steps (batch 8,
     float32), validation each epoch: each epoch's loss within
     ``SNR_RESUME_LOSS``, 7 forward and 7 backward NCHW calls a step, the
     optimizer count carried on;
 36. one joint train step (bf16, batch 16, 16448 samples, the committed
     estimator frozen, the network from seeded init): the SNR estimates kernel vs
     plain, then the kernel path against both GroupNorm directions plain under
     the same draws and the same tables (one float32 ulp of a noise level is
     another 1e7-scale encoding), bf16 and float32, at [24]'s ``TRAIN_TOL``; the
     estimator bit-identical and without gradients; 33 + 7 forward and 33
     backward calls a step and 33 backward kernels in the profiled step (its
     forward kernels printed by name); the encoding on the card against the
     CPU; the median of 20 steps, peak memory and one profiled step;
 37. ``python -m sddm_tpu_torch.train_with_snr_estimator -s <the estimator>
     --bs 8`` (in this process) from init on [35]'s files, 2 epochs of 25 steps,
     one full-T validation: finite losses, the second within ``JOINT_LOSS``,
     current, best and the validation WAVs, the launches, and the estimator in
     its checkpoint the committed one;
 38. ``python -m sddm_tpu_torch.infer_with_snr_estimator -r <[37]'s best>`` (in
     this process) on the first 50 files of the v2 test split at T = 100: every
     row once, finite outputs, (7 + 33 x 100) NCHW launches a sampler call; one
     batch again under one noise stream with the network's GroupNorm+SiLU
     plain and the same tables (rel L2 within ``SNR_E2E_TOL``), its SNR
     estimates kernel vs plain, and all of it plain (printed); the serve and scoring seconds, the
     loss and the metric means beside the committed JAX table (not gated).

Then the two-stage-transformer family, new with its slice (UNetTST, CAUNet and
TSTNN at their shipped configs' widths, UNetSP at the flagship's, float32 as the
configs set it, on seeded weights written by the port's checkpoint writer;
UNetTST's 31 and UNetSP's 33 GroupNorm+SiLU sites run ``gn_silu`` forward and
``gn_silu_backward`` backward, CAUNet and TSTNN reach no kernel):
 39. hold both NCHW kernels against their plain versions at every distinct
     GroupNorm+SiLU site of UNetTST and UNetSP at batch 16 (down to [16, 160, 8,
     4]; [16, 320, 8, 4] and [16, 640, 8, 4] carry 10 and 20 channels a group),
     float32 and bfloat16, every call repeated bit for bit and its plan printed,
     at [3]'s and [23]'s limits;
 40. each network through ``load_enhancer(steps=12)``: the four requests of
     phase 5 as one batch of 16 rows at ancestral-12 (T = 1000; UNetSP the
     flagship's T = 100): shapes, finiteness, ``gn_silu`` launches (31 x 12 and
     33 x 12 a batch, none for CAUNet and TSTNN), serve seconds and peak memory;
     UNetTST and UNetSP served again with the GroupNorm+SiLU plain
     (``ZOO_E2E_TOL``), and each step's network output held against its plain
     version on the same input; two rows, one float32 forward on the card against
     the CPU port (``CARD_VS_CPU_TOL``) and 12 sampler steps under one noise
     stream (``ZOO_CARD_VS_CPU_TOL``, gated for UNetTST and UNetSP; printed for
     CAUNet and TSTNN beside the sampler's change when x_T moves one ulp);
 41. (a) one UNetTST train step (float32, batch 16, the config's AMSGrad), the
     kernel path against both GroupNorm directions plain at [24]'s
     ``TRAIN_TOL["float32"]``, 31 + 31 calls and 31 backward kernels in a
     profiled step; (b) ``python -m sddm_tpu_torch.train`` (in this process) on
     the three shipped configs, cut to the first 32 files of [25]'s train split,
     2 epochs of 8 steps with a 12-step validation, then one epoch resumed
     (finite losses, the launches, the optimizer count); (c) ``python -m
     sddm_tpu_torch.infer -r`` on (b)'s UNetTST checkpoint over 8 files of [20]'s
     test split at ``--steps 12``.

Then the waveform networks of the zoo, new with their slice (Waveunet, Waveunet2,
Waveunet3 at ``configs/config_waveunet*.json``, DenoiseWaveGrad1 at a copy of
``configs/config.json`` with ``num_samples`` 32000 and without its datasets' ``T``,
DenoiseWaveGrad2 and 3 at that copy with the type swapped and 32768 and 32100
samples, UNetModified at ``configs/config_unet.json`` with the type swapped and its
class defaults for widths; float32 as the configs set it, seeded weights written by
the port's checkpoint writer; Waveunet3's 28 and UNetModified's 75 GroupNorm+SiLU
sites run ``gn_silu`` forward and ``gn_silu_backward`` backward, the others reach no
kernel; the Wave-U-Nets serve in eval mode, clipped to [-1, 1], and train unclipped):
 42. hold both NCHW kernels against their plain versions at every distinct
     GroupNorm+SiLU site of Waveunet3 (1-D, ``[B, C, 16384, 1]``; level 0's 2
     groups make runs of 1, 16 and 32 channels x 16384) at batch 4 and 16, and of
     UNetModified at batch 16, float32 and bfloat16, every call repeated bit for
     bit and its plan printed, at [3]'s and [23]'s limits; each site's float32
     time by CUDA events beside its byte bound, summed over a forward;
 43. each of the seven through ``load_enhancer(steps=12)`` as [40] serves its
     networks: the four requests at ancestral-12, shapes, finiteness, launches
     (28 x 12 and 75 x 12 a batch, none for the others), serve seconds, RTF,
     peak memory, Waveunet3 and UNetModified again with the GroupNorm+SiLU plain,
     one forward card against CPU for all seven, 12 sampler steps under one noise
     stream card against CPU for the Wave-U-Nets and UNetModified (DenoiseWaveGrad's
     T = 2000 schedule multiplies a last-bit difference by about 2e4: printed); each
     of the 12 steps' network output, kernel against plain on the same input, for
     Waveunet3 and UNetModified (as [40] now does for UNetTST and UNetSP); the served
     outputs' difference printed for Waveunet3 beside its one-ulp change;
 44. (a) one Waveunet3 (batch 4) and one UNetModified (batch 16) train step as
     [41] (a): the kernel path against both directions plain at
     ``TRAIN_TOL["float32"]``, the launches and the profiled step's backward
     kernels, device busy; (b) ``python -m sddm_tpu_torch.train`` on
     ``config_waveunet.json``, ``config_waveunet2.json``, ``config_waveunet3.json``
     and the config.json copy, cut as [41] (b); (c) ``infer -r`` on (b)'s Waveunet3
     checkpoint over 8 test files at ``--steps 12``.

Then the packed variable engines and the remaining diffusion transitions, new with
their slice (``configs/config_unet_snr_synth.json`` with ``"packed": true``; the
variable engines' 33 GroupNorm+SiLU sites run ``gn_silu_nhwc`` forward and
``gn_silu_nhwc_backward`` backward, the estimator's 7 ``gn_silu``):
 45. the packed variable engine's sites listed (33, 14 offset) and compared with the
     flagship packed engine's; both NHWC directions against their plain versions at
     each distinct site, batch 16 and 8, float32 and bfloat16, every call repeated bit
     for bit and its plans printed, at [3]'s and [30]'s limits;
 46. (a) one packed joint train step (``SDDM_PACKED_TRAIN=1``'s
     ``PackedTrainUNetVariable``, bf16, batch 16, the committed estimator frozen,
     [36]'s seeded init, batch and draws): the kernel path against both NHWC
     directions plain under the same tables, bf16 and float32, at ``TRAIN_TOL``; in
     float32 the twin against the plain variable network at ``TWIN_VS_PLAIN_F32_TOL``;
     33 + 33 NHWC and 7 NCHW calls a step and the profiler's kernel counts; the median
     of 20 steps, peak memory, device busy and idle beside [36]'s; (b)
     ``SDDM_PACKED_TRAIN=1 python -m sddm_tpu_torch.train_with_snr_estimator`` (in
     this process) on [35]'s files as [37]: the second epoch within ``JOINT_LOSS``,
     the launches, the checkpoint in [37]'s plain names and shapes;
 47. ``python -m sddm_tpu_torch.infer_with_snr_estimator`` on a ``"packed": true``
     config, [46]'s checkpoint, the first 16 v2 test files at T = 100: the packed
     engine, (7 + 33 x 100) launches a call, every row once; one batch again against
     the plain variable engine under one noise stream and the same tables
     (``SNR_E2E_TOL``); serve seconds;
 48. the flagship's epoch-250 checkpoint through ``load_enhancer(steps=12)`` (packed,
     bf16) under ``sr3``, ``supportive``, ``conditional`` and the conditional-q
     ``with_ddim()``: finite outputs, every forward a replay of the CUDA graph; in float32 each step's
     network output kernel vs plain and 12 steps on two rows under one noise stream,
     card against the CPU; one bf16 train step of the plain flagship under the
     conditional q process, the kernel path against both NCHW directions plain at
     ``TRAIN_TOL``;
 49. ``python -m sddm_tpu_torch.train`` and ``torchrun --standalone --nproc_per_node=1
     -m sddm_tpu_torch.train`` (NCCL, DDP at one rank) on [25]'s config and files, one
     epoch from init, cuDNN deterministic, each in its own process: the checkpoints
     equal bit for bit, 33 + 33 launches a step;
 50. one float32 step of the flagship over two gloo ranks sharing the card (DDP, 8 rows
     a rank, ``python -m sddm_tpu_torch.parallel.dryrun --step``) from [24]'s weights,
     batch and draws against the single-process batch-16 step at ``TRAIN_TOL``; both
     GroupNorm directions on each rank;
 51. ``trainer.model_parallel: 2`` on one card refused in the JAX package's words; the
     native WAV reader built and in use; one epoch of [25]'s files through the
     flagship's streaming loader by the native reader, scipy's memory map and whole
     decodes: the same batches, the seconds of each;
 52. dropout 0.1 in training, on a copy of ``configs/config_unet.json`` in bf16 (made in
     the run's directory): one flagship step at [24]'s batch and q draws, its masks drawn
     from a generator on the card, the kernel path against both NCHW directions plain
     under the same masks at ``TRAIN_TOL``, 33 + 33 launches, each of the 16 sites' kept
     share within 5 sigma of 0.9, the median step beside the same weights at dropout 0;
     the committed estimator's float32 step at dropout 0.1 the same way (7 + 7
     launches); the four requests served from the dropout config (eval mode) bit for
     bit as at dropout 0; ``python -m sddm_tpu_torch.train`` (in this process) one epoch
     of [25]'s files at dropout 0.1: 25 steps, finite losses, 825 + 825 launches, 16
     masks a step;
 53. serving over the data mesh: the flagship's epoch-250 checkpoint through
     ``load_enhancer`` (packed, ancestral-12) on the four requests (9 rows, one batch
     of 16), against the same serve in this process from the same seed: (a) two gloo
     ranks sharing the card, 8 rows each (``python -m sddm_tpu_torch.parallel.dryrun
     --serve``), float32 and bf16 at ``MESH_F32_REL`` / ``MESH_BF16_REL``, the
     ``gn_silu_nhwc`` wrapper's calls fitting the rank's CUDA graph captures and
     replays, and no fallback on each rank; (b) ``torchrun
     --standalone --nproc_per_node=1`` (NCCL) bit for bit; (c) ``warmup()``'s seconds,
     then ``load_enhancer(warmup=True, warmup_timeout_s=...)`` serving the same bits;
     (d) ``batch_rows`` 3, which two ranks do not divide, served whole on each.

Then the packed denoiser's CUDA graph (``PackedUNetModified2.forward`` replays
a graph of its body, captured once per input shape):
 54. the flagship's epoch-250 checkpoint through ``load_enhancer(steps=12)`` at
     64 and 256 rows a call (the serving cells' shapes, bf16), the canary's
     call capturing the graph: at each, three fresh forwards from the graph
     against ``_forward_eager`` bit for bit (``torch.equal``); ``SDDM.infer``
     under one ``noise_stream``, and from one seeded generator, through the
     graph against the eager loop bit for bit; the four requests served:
     12 replays a call and no wrapper call; one served call profiled, in a
     window opened by ``LEAD_LAUNCHES`` kernels of its own: the graph's
     ``nhwc_gn_silu`` kernels among the device events (33 x 12) and 12
     forwards by a forward hook; the same call, eager and from the graph, in
     windows of CUDA activity alone (printed: what such a window misses);
     served calls eager and from the graph in
     turns (eager, graph, graph, eager), and each side's mean ``sampler.step``
     host wall under ``profiling.recording()``; the memory the capture holds.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of JAX
or of the JAX package.  ``python3 chip_smoke.py --serve-mesh-cards N`` runs
phase 53 alone with its ranks over NCCL on a card each (needs N cards);
``python3 chip_smoke.py --denoiser-graph`` runs phase 54 alone.
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

# the SNR-adaptive path (phases 33-38): the committed estimator (epoch 80 of
# artifacts/round5/snr_estimator: float32, l2_loss, batch 8, trained on the RAM
# cache's int16 PCM) and the joint recipe of configs/config_unet_snr_synth.json
# (bf16, batch 16, T = 100), on [26]'s v2 corpus
SNR_RUN = ROOT / "artifacts" / "round5" / "snr_estimator"
SNR_CONFIG = ROOT / "configs" / "config_unet_snr_synth.json"
SNR_NUM_SAMPLES, EST_BATCH, EST_SITES = 16448, 8, 7
SNR_VAL_LOSS = 607.3997497558594  # the committed info.log, epoch 80
SNR_FILES, SNR_EPOCHS, SNR_SERVE_FILES = 200, 2, 50
# Limits of phases 33-38, stated in PERF.md before the first run.  [33] holds
# both kernels at [3]'s TOL and [23]'s BWD_REL / BWD_RTOL.  The estimator's SNR
# estimates (dB, values to about 100), kernel path vs plain path in float32,
# TF32 off, as (max |d|, rel L2): 7 GroupNorm sites whose outputs differ in the
# last bits of float32, carried through 12 convolutions.
SNR_EST_TOL = (2e-3, 2e-5)
# The same on the joint model's float-scale input ([36], [38]; the JAX package
# feeds it so): the estimator's first convolution gives about its bias there,
# so the first site's groups are near-constant (std as little as 1/300 of the
# mean) and the statistics' rounding comes out about 300 times larger.  The
# first limit, set before any reading, was SNR_EST_TOL; the first call read
# 3.56e-2 dB and rel L2 9.8e-5 on [36]'s batch; this limit is about 3 times that.
SNR_JOINT_EST_TOL = (0.1, 3e-4)
# one float32 estimator forward on the card against the CPU, max |d| in dB
SNR_CARD_VS_CPU = 1e-2
# [35] each resumed 25-step epoch's mean l2 loss: the committed run's per-step
# losses after epoch 69 read a mean of 737.9 and an sd of 199.0
# (artifacts/round5/snr_estimator/scalars.jsonl, 539 logged steps), so a
# 25-step mean spreads 39.8; the band is that mean +- 4.5 of those.
SNR_RESUME_LOSS = (559.0, 917.0)
# [37] the second epoch's mean l1 loss from init: the committed joint run's
# steps 5-100 (batch 16) read 0.662-0.802 (mean 0.747), and its loss never left
# 0.66-0.80 (artifacts/round5/snr_joint/scalars.jsonl); the band is that range
# widened by 0.01-0.02.
JOINT_LOSS = (0.65, 0.82)
# [38] one served batch (bf16, T = 100), the network's GroupNorm+SiLU kernel
# path against its plain version under the same noise stream and the same
# tables: rel L2.  Its max |d| is printed and not gated: a segment whose
# estimate clips its betas to 0.999 divides a step's difference by
# sqrt(1 - 0.999), 31.6-fold, and the clip to [-1, 1] bounds what follows.
# (The first limits, set before any reading, were max |d| 2e-2 and rel L2
# 5e-2; the first call read 1.29 and 1.34e-2.)
SNR_E2E_TOL = 5e-2
# the committed JAX run of the joint model (artifacts/round5/snr_joint/info.log:
# another checkpoint, 17 files, TPU v5e), printed beside [38]'s and not gated;
# the card's copy of the checkout leaves that folder out
SNR_JOINT_TABLE = {"stoi": (0.9141765432927311, 0.19507637101172032),
                   "pesq_wb_approx": (3.623237649767151, 1.5230354155914043),
                   "sisnr": (9.743569381742528, -20.35713494440742)}
SNR_JOINT_LOSS = 0.33183925019370186

# the two-stage-transformer family (phases 39-41): UNetTST, CAUNet and TSTNN at
# their shipped configs' widths, UNetSP at the flagship's (config_unet.json with
# the sub-pixel decoder), float32 as the configs set it, on seeded weights (the
# port's JAX-style init, written by the port's checkpoint writer); the
# GroupNorm+SiLU sites a forward of each
ZOO_CONFIGS = {"UNetTST": "config_unettst.json", "UNetSP": "config_unet.json",
               "CAUNet": "config_caunet.json", "TSTNN": "config_tstnn.json"}
ZOO_SITES = {"UNetTST": 31, "UNetSP": 33, "CAUNet": 0, "TSTNN": 0}
# Limits of phases 39-41, stated in PERF.md before the first run.  [39] holds
# both NCHW kernels at [3]'s TOL and [23]'s BWD_REL / BWD_RTOL.  [40] one sampler
# call of ZOO_CPU_ROWS rows at ancestral-12 under one noise stream, float32, TF32
# off, the card against the CPU port, as (max |d|, rel L2): cuDNN's and the
# CPU's convolutions and GRUs sum in other orders, 12 steps carry it.  Run for
# UNetTST and UNetSP; for all four one forward held card against CPU at
# CARD_VS_CPU_TOL and the card's sampler's change when x_T moves one float32
# ulp printed.  (The first limits, set before any reading, gated the sampler
# for all four, and CAUNet and TSTNN missed them by three orders: their served
# outputs clip to +-1, and a clipped, constant frame reaches the LayerNorm over
# F with a variance of 0, where eps 1e-5 lets 1/sqrt(1e-5) = 316 times a
# last-bit difference through.  One ulp of x_T moves their samplers' outputs
# by rel L2 0.27 and 0.10, the UNets' by 3e-6 and 4e-7.)
ZOO_CPU_ROWS = 2
ZOO_CARD_VS_CPU_TOL = (1e-3, 1e-4)
# [40] the served requests, float32, the GroupNorm+SiLU kernel path against its
# plain version, the same weights and noise (UNetTST and UNetSP): rel L2.  The
# first limits, set before any reading from the flagship's f32 reading ([6]:
# 4.2e-7 and 6.3e-7), were max |d| 1e-5 and rel L2 1e-5; UNetTST reads max |d|
# 3.9e-5 and rel L2 2.9e-6.  Over ancestral-12 of a T = 1000 schedule
# (alpha_bar_T = 0.0067) the steps' 1/sqrt(alpha) multiply to about 12 (the
# flagship's T = 100: 1.03), so a last-bit difference of one sample grows
# twelvefold; [40] gates the rel L2 alone, as [38] does, and prints the max |d|.
ZOO_E2E_TOL = 1e-5
# [41] UNetTST's train step (float32, the config's dtype) at [24]'s
# TRAIN_TOL["float32"]; the training CLI on the first ZOO_TRAIN_FILES files of
# [25]'s v1 train split at the configs' batch of 4, ZOO_EPOCHS epochs from init
# with a ZOO_VALID_STEPS-step validation at the last, then one epoch resumed;
# infer -r on the first ZOO_INFER_FILES files of [20]'s test split
ZOO_TRAIN_FILES, ZOO_EPOCHS, ZOO_VALID_STEPS, ZOO_INFER_FILES = 32, 2, 12, 8

# the waveform networks of the zoo (phases 42-44): each at its shipped config's widths, float32
# as the configs set it, on seeded weights written by the port's checkpoint writer (no trained
# checkpoint exists).  (config file, num_samples, network type): DenoiseWaveGrad1's
# configs/config.json has no top-level num_samples and its datasets set T, which both packages
# refuse (tests/test_torch_waveform_zoo_cli.py), so the run takes a copy, written in its
# temporary directory, with num_samples 32000 (divisible by 400) and without the datasets' T;
# DenoiseWaveGrad2 and 3 take that copy with the type swapped at a length each divides (256,
# 300); UNetModified takes configs/config_unet.json with the type swapped and its own class
# defaults for widths (inner 32, 32 groups, mults 1, 2, 4, 8, 8, attention at level 4, 3 res
# blocks, 128/64 framing, 16448 samples)
WAVE_CONFIGS = {"Waveunet": ("config_waveunet.json", 16384),
                "Waveunet2": ("config_waveunet2.json", 16384),
                "Waveunet3": ("config_waveunet3.json", 16384),
                "DenoiseWaveGrad1": ("config.json", 32000),
                "DenoiseWaveGrad2": ("config.json", 32768),
                "DenoiseWaveGrad3": ("config.json", 32100),
                "UNetModified": ("config_unet.json", 16448)}
# the GroupNorm+SiLU sites of one forward (ConvLayer's GroupNorm -> ReLU and the attention's
# GroupNorm reach no kernel)
WAVE_SITES = {"Waveunet": 0, "Waveunet2": 0, "Waveunet3": 28, "DenoiseWaveGrad1": 0,
              "DenoiseWaveGrad2": 0, "DenoiseWaveGrad3": 0, "UNetModified": 75}
# [42] Waveunet3's sites at the config's train batch (4) and the serving batch (16 rows),
# UNetModified's at 16; both kernels at [3]'s TOL and [23]'s BWD_REL / BWD_RTOL
WAVE_SITE_BATCHES = {"Waveunet3": (4, BATCH_ROWS), "UNetModified": (BATCH_ROWS,)}
# Limits of phases 42-44, stated in PERF.md before the first run.  [43] one float32 forward of
# every network on 2 rows, card against the CPU port, at CARD_VS_CPU_TOL; 12 sampler steps
# under one noise stream card against CPU at ZOO_CARD_VS_CPU_TOL for the networks whose
# schedule carries a last-bit difference modestly (T = 1000 from 1e-6 to 1e-2: alpha_bar_T =
# 0.0067, about 12x; UNetModified's T = 100: about 1.03x): the Wave-U-Nets and UNetModified.
# config.json's T = 2000 from 1e-4 to 0.02 gives alpha_bar_T = 2e-9, so the steps' 1/sqrt(alpha)
# multiply to about 2e4: DenoiseWaveGrad1-3's samplers are printed beside their change when x_T
# moves one float32 ulp, not gated.  The served kernel path against the plain GroupNorm+SiLU
# (Waveunet3 and UNetModified) at ZOO_E2E_TOL (rel L2).  (A development run read Waveunet3's
# served outputs 1.93e-5 apart, over that limit, where its own sampler moves 1.05e-5 when x_T
# moves one float32 ulp, and [42] held every site of it within TOL: at random init its
# Wave-U-Net carries a last-bit difference through 12 steps about tenfold.  So [40] and [43]
# now also hold each step's network output, kernel path against plain on the same input along
# the kernel path's trajectory, at ZOO_E2E_TOL, which no step's amplification reaches; the
# served outputs stay gated for UNetTST, UNetSP and UNetModified and are printed for Waveunet3
# beside its one-ulp change.  The limit is unchanged.)  [44] the train steps at
# TRAIN_TOL["float32"]; the training CLI as [41] (b) on the same ZOO_TRAIN_FILES files at the
# configs' batches, and infer -r on Waveunet3's checkpoint over ZOO_INFER_FILES test files.
WAVE_TRAINED = ("Waveunet", "Waveunet2", "Waveunet3", "DenoiseWaveGrad1")

# the packed variable engines (phases 45-47) on configs/config_unet_snr_synth.json with
# "packed": true, and the flagship under the remaining transitions (48).  Limits, stated in
# PERF.md before the first run, are the earlier phases': [45] both NHWC directions at [3]'s
# TOL and [30]'s BWD_REL / BWD_RTOL; [46] the packed joint step kernel vs plain at [24]'s
# TRAIN_TOL, the twin vs the plain variable network in f32 at [31]'s TWIN_VS_PLAIN_F32_TOL,
# the CLI's second epoch within [37]'s JOINT_LOSS; [47] one served batch, the packed engine
# against the plain engine under one noise stream and the same tables, at [38]'s SNR_E2E_TOL
# (rel L2; a clipped beta of 0.999 divides a step's difference by 31.6 there too); [48] in
# float32 each step's network output kernel vs plain at [40]'s ZOO_E2E_TOL and 12 sampler
# steps card vs CPU at ZOO_CARD_VS_CPU_TOL, the conditional-q train step at TRAIN_TOL.
VAR_SERVE_FILES = 16
# (A check changed after development call 1, no limit: [48]'s supportive sampler read each
# step's network output kernel vs plain at worst rel L2 4.31e-5, over ZOO_E2E_TOL, at its
# first step. Its x_T is the condition itself, so its first forward meets a GroupNorm group
# whose std is 1.1e-3 of its mean (first_step_conditioning; the other samplers' worst
# 0.06-0.08): there the one-pass variance s2 / n - mean^2 of the JAX package's
# GroupNorm, which the kernel and the plain version both compute, loses about 6e-8 / 1.1e-3^2,
# 5% of the variance, to rounding, and the two summation orders part by that much.  [48]
# prints that reading for supportive beside the worst std / |mean| of each sampler's first
# forward, and gates it for the other three; the card-vs-CPU sampler stays gated for all four.)
STEPWISE_PRINTED = ("supportive",)
# [48]: {name: (arch args, with_ddim)}
TRANSITIONS = {"sr3": ({"p_transition": "sr3", "q_transition": "original"}, False),
               "supportive": ({"p_transition": "supportive", "q_transition": "original"}, False),
               "conditional": ({"p_transition": "conditional", "q_transition": "conditional"},
                               False),
               "ddim_conditional": ({"p_transition": "conditional",
                                     "q_transition": "conditional"}, True)}

# Parallelism and the WAV reader (phases 49-51).  Limits, stated in PERF.md before the first
# run: [49] the checkpoints of `python -m sddm_tpu_torch.train` and of the same command under
# `torchrun --nproc_per_node=1` (NCCL, DDP at one rank) equal bit for bit, 33 + 33 launches a
# step; [50] one step over two gloo ranks on the one card, 8 rows each, against the
# single-process batch-16 step, float32 with TF32 off, at [24]'s TRAIN_TOL["float32"]; [51]
# model_parallel 2 refused in the JAX package's words, the native reader in use, the loader's
# batches the same by every reader.
TORCHRUN_EPOCHS = 1
TORCHRUN_TIMEOUT = 300
TRAIN_DEVICE_ARGS = []  # the training commands' device flag ([] on the card)
DDP_RANKS, DDP_TIMEOUT, DDP_DEVICE = 2, 300, "cuda"
MP_REFUSAL = "model_parallel=2 does not divide 1 devices"

# Dropout in training (phase 52).  Limits, stated in PERF.md before the first run: the bf16
# flagship step at dropout 0.1 (configs/config_unet.json's copy) kernel path vs both GroupNorm
# directions plain, under the same masks and q draws, at TRAIN_TOL["bfloat16"]; the committed
# estimator's step at dropout 0.1 (float32, TF32 off) at TRAIN_TOL["float32"]; 33 + 33 and 7 + 7
# launches; each site's kept share within DROPOUT_SIGMAS standard deviations of 1 - DROPOUT; the
# served outputs of the dropout config equal bit for bit to dropout 0's; the CLI's epoch of
# [25]'s files: 25 steps, finite losses, 825 + 825 launches, 16 x 25 masks.
DROPOUT = 0.1
DROPOUT_SITES, DROPOUT_EST_SITES = 16, 6
DROPOUT_SIGMAS = 5.0
DROPOUT_TIMED_STEPS = 10

# Serving over the data mesh (phase 53).  Limits, stated in PERF.md before the first run: (a)
# the flagship's four requests (9 rows, one batch of 16) served by MESH_RANKS gloo ranks sharing
# the card, 8 rows a rank, against one process from the same generator seed: every rank the same
# bits; float32 (TF32 off) at rel L2 MESH_F32_REL, bf16 at MESH_BF16_REL ([6]'s E2E_TOL rel,
# tighter than [47]'s 5e-2); 396 nhwc_gn_silu launches and no fallback on each rank; (b)
# `torchrun --standalone --nproc_per_node=1` (NCCL) serving bf16 bit for bit as one process, 396
# launches; (c) a serve built with warmup_timeout_s at MESH_WARMUP_FACTOR times warmup()'s
# seconds (at least MESH_WARMUP_FLOOR) returns the same bits; (d) batch_rows MESH_ODD_ROWS, which
# two ranks do not divide, served whole on each rank, float32 at MESH_F32_REL from one process.
MESH_RANKS, MESH_TIMEOUT, MESH_DEVICE, MESH_BACKEND = 2, 300, "cuda", "gloo"
MESH_F32_REL, MESH_BF16_REL = 1e-5, 2e-2
MESH_ODD_ROWS = 3
MESH_WARMUP_FACTOR, MESH_WARMUP_FLOOR = 10.0, 60.0
# Phase 54: the serving cells' rows a call, and the served calls a side of each turn.
GRAPH_ROWS = (64, 256)
GRAPH_TIMED_CALLS = 5


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
RETRIED = []  # (windows without the launch, seconds) of each measurement that took a window again
NOT_MEASURED = []  # what was not measured because the profiler saw no device event at all
PROFILER = {"lost": False}  # whether the last profiled measurement found the profiler blind


def profiler_windows():
    """The windows a profiled measurement opens, ``utils/profiling.
    retry_windows``: a minute of them where the profiler is blind for a
    while.  Once a measurement has found it blind for all of that, the next
    opens only the widest window until one sees the device again, so that a
    profiler lost for good costs the run a window a measurement, not a
    minute."""
    from sddm_tpu_torch.utils.profiling import RETRY_WINDOWS, retry_windows

    return RETRY_WINDOWS[-1:] if PROFILER["lost"] else retry_windows()


def profiler_saw(device_events, what: str) -> bool:
    """Whether a measurement's windows held any device event.  Where none
    did, the profiler was blind: ``what`` is recorded in ``NOT_MEASURED``
    and logged as not measured (the wrappers' own counts still gate the
    launches).  Windows that held device events, but not the kernels a
    phase looks for, are that phase's failure."""
    PROFILER["lost"] = not device_events
    if PROFILER["lost"]:
        NOT_MEASURED.append(what)
        log(f"    the profiler saw no device event in any window of {what}: not measured")
    return not PROFILER["lost"]


def device_time_us(fn, match, calls: int = 5):
    """The profiler's device time of one launch of the kernels whose names
    ``match`` accepts, over ``calls`` calls of ``fn`` after three warm-up
    calls: (us a launch, launches seen).  A window in which the profiler saw
    none of the launches is profiled again, in the windows of
    :func:`profiler_windows`; where none of them held any device event,
    (nan, None): the profiler was blind, and the time is not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.utils.profiling import profiled

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    any_device, misses, start = [], 0, time.monotonic()
    for margin, with_cpu in profiler_windows():
        activities = (ProfilerActivity.CPU,) * with_cpu + (ProfilerActivity.CUDA,)
        with profiled(*activities, margin_s=margin) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        any_device += device
        events = [e for e in device if match(e.key)]
        seen = sum(e.count for e in events)  # the profiler may miss a launch at its start
        if seen:
            PROFILER["lost"] = False
            if misses:
                RETRIED.append((misses, time.monotonic() - start))
            return sum(e.self_device_time_total for e in events) / seen, seen
        UNSEEN_WINDOWS.append(sorted((e.key[:60], e.count) for e in device))
        misses += 1
    RETRIED.append((misses, time.monotonic() - start))
    if not profiler_saw(any_device, "a kernel's device time"):
        return math.nan, None
    return 0.0, 0


def finite_or_none(obj):
    """``obj`` with every float that is not finite (a time not measured)
    written as None, so that the JSON lines stay JSON."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_or_none(v) for v in obj]
    return obj


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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block.  Its default float32
    backward algorithms add in an order that varies from run to run, so that
    the same step does not repeat its gradients, nor a training run its
    losses."""
    import torch

    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = kept


@contextlib.contextmanager
def env_set(name: str, value: str):
    """The environment variable ``name`` set to ``value`` for the block."""
    import os

    kept = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if kept is None:
            os.environ.pop(name)
        else:
            os.environ[name] = kept


def plain_gn_silu():
    """Every GroupNormSiLU module of the plain network on ``gn_silu_reference``."""
    from sddm_tpu_torch.models import blocks
    from sddm_tpu_torch.ops.gn_silu import gn_silu_reference

    return routed(blocks, "gn_silu", gn_silu_reference)


@contextlib.contextmanager
def plain_gn_silu_nhwc():
    """Every GroupNorm site of the packed engine on ``gn_silu_nhwc_reference``
    (which takes no group-major ``order``: it sums by the one-hot map), and
    the engine's forward eager: a replay of its CUDA graph would run the
    kernels it captured."""
    from sddm_tpu_torch.models import unet_packed
    from sddm_tpu_torch.ops.gn_silu import gn_silu_nhwc_reference

    def plain(*args, order=None, **kwargs):
        return gn_silu_nhwc_reference(*args, **kwargs)

    with routed(unet_packed, "gn_silu_nhwc", plain), \
            routed(unet_packed.PackedUNetModified2, "replays_graphs", False):
        yield


def graphed_launches_hold(launches: int, forwards: int, captures: int, replays: int,
                          sites: int | None = None) -> bool:
    """Whether ``gn_silu_nhwc``'s wrapper count fits a packed engine's
    forwards: an eager forward and a capture each pass through the wrapper
    at every site, a replay of the CUDA graph through none.  The kernels a
    replay launches are counted by the profiler ([13], [21], [54])."""
    sites = PACKED_SITES if sites is None else sites
    return launches == sites * (forwards - replays + captures)


LEAD_LAUNCHES = 256  # short kernels of its own that open a window counting a call's kernels
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def lead_launches(device) -> None:
    """``LEAD_LAUNCHES`` kernels of ``torch.cuda._sleep`` at the start of a
    profiler window, then a synchronise.  Late in a whole run the profiler
    dropped the first ~50 device events of each window (phase 54: eager
    calls 2 ``nhwc_gn_silu`` kernels short, replayed calls the first
    replay's first kernel short, alone in a fresh process none), so a window
    that counts a call's kernels opens with these and counts what it kept
    of them (``LEAD_KERNEL``)."""
    import torch

    for _ in range(LEAD_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda.synchronize(device)


def replayed_kernels(eng, device) -> dict:
    """The ``nhwc_gn_silu`` kernels that one replay of each CUDA graph the
    packed engine ``eng`` holds launches, by the profiler's device events
    (CPU and CUDA activity, :func:`lead_launches` first):
    ``{rows: (seen, the capture's wrapper calls)}``; ``seen`` is None where
    the profiler saw no device event in any window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.utils.profiling import profiled

    seen = {}
    for key, graph in list(eng._graphs.items()):
        any_device, count = [], 0
        for margin, _ in profiler_windows():
            with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, margin_s=margin) as prof:
                lead_launches(device)
                graph(*graph.inputs)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            any_device += events
            count = sum(e.count for e in events if NHWC_KERNEL in e.key)
            if count:
                break
            UNSEEN_WINDOWS.append(sorted((e.key[:60], e.count) for e in events))
        rows = key[0][0]
        seen[rows] = (count if profiler_saw(any_device, f"a replay at {rows} rows") else None,
                      graph.launches)
    return seen


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


def packed_sites(engine, num_samples: int, device, inputs=None):
    """[(the _GN module, (H, W, C4))] of one packed forward, in call order;
    ``inputs`` are the forward's arguments (by default the flagship's: zeros
    of ``num_samples`` samples and a level)."""
    import torch

    from sddm_tpu_torch.models.unet_packed import _GN

    sites = []
    hooks = [m.register_forward_pre_hook(lambda m, a: sites.append((m, tuple(a[0].shape[1:]))))
             for m in engine.modules() if isinstance(m, _GN)]
    if inputs is None:
        z = torch.zeros(1, 1, num_samples, device=device)
        inputs = (z, z, torch.ones(1, 1, 1, device=device))
    with torch.no_grad(), plain_gn_silu_nhwc():
        engine(*inputs)
    for h in hooks:
        h.remove()
    return sites


def net_sites(network, num_samples: int, device):
    """[((C, H, W), G)] of one forward of the plain network, in call order."""
    import torch

    z = torch.zeros(1, 1, num_samples, device=device)
    return gn_sites(network, z, z, torch.ones(1, 1, 1, device=device))


def gn_sites(network, *inputs):
    """[((C, H, W), G)] of one forward of ``network`` on ``inputs``, in call
    order (the plain GroupNorm+SiLU, so that no kernel is counted)."""
    import torch

    from sddm_tpu_torch.models.blocks import GroupNormSiLU

    sites = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: sites.append((tuple(a[0].shape[1:]), m.num_groups)))
        for m in network.modules() if isinstance(m, GroupNormSiLU)]
    with torch.no_grad(), plain_gn_silu():
        network(*inputs)
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
    gn_silu.launches = gn_silu_nhwc.launches = eng.captures = eng.replays = 0
    served, serve_s = serve_requests(enh, audios, SEED, device)
    launches, nchw_launches = gn_silu_nhwc.launches, gn_silu.launches
    captures, replays = eng.captures, eng.replays
    peak = torch.cuda.max_memory_allocated()
    forwards = STEPS * n_batches
    log(f"[10] {type(eng).__name__} served {len(audios)} requests: warm-up {warm_s:.3f} s, timed {serve_s:.3f} s (RTF {serve_s / audio_s:.4f}), "
        f"{forwards} forwards: {replays} replayed from the CUDA graph captured in set-up, "
        f"{captures} captures, gn_silu_nhwc wrapper calls {launches}, gn_silu.launches "
        f"{nchw_launches}, peak {peak / 2**20:.1f} MiB")
    for a, y in zip(audios, served):
        if y.shape != a.shape or not np.isfinite(y).all() or np.abs(y).max() > 1.0:
            fail(f"packed served output shape {y.shape} for input {a.shape}, "
                 f"finite {np.isfinite(y).all()}")
    graphed = replays == forwards and captures == 0 if device.type == "cuda" else replays == 0
    if not graphed_launches_hold(launches, forwards, captures, replays) or not graphed or \
            nchw_launches != 0:
        fail(f"gn_silu_nhwc wrapper calls {launches}, graph captures {captures} and replays "
             f"{replays} over {forwards} forwards ({STEPS} steps x {n_batches} batches; on a "
             f"card every forward a replay); gn_silu.launches = {nchw_launches}, expected 0")

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
        if seen is not None and not 1 <= seen <= 5:
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
        if not (gn_ms > 0 and gn_calls == PACKED_SITES * forwards):
            fail(f"the served batch's {forwards} forwards ({replays} from the graph in [10]) "
                 f"should launch {PACKED_SITES * forwards} {NHWC_KERNEL} kernels, but the "
                 f"profile shows {gn_calls} launches and {gn_ms} ms under {NHWC_KERNEL}")
    else:
        gn_calls = None
        log("[13] the profiler saw no device time: breakdown not measured")
    if over:
        fail(f"readings over their limits: {over}")

    big = timed["largest"]
    kernel_record = {
        "name": "gn_silu_nhwc",
        "route": "cuda",
        "source": "sddm_tpu_torch/csrc/gn_silu.cu",
        "replaces": "sddm_tpu/experimental/pallas_gn_silu.py:142",
        "launches": gn_calls,
        "wrapper_calls_served_batch": launches,
        "graph_replays_served_batch": replays,
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
        forwards = STEPS * len(rows)
        net = run["network"]
        run["graph"] = {"captures": getattr(net, "captures", 0),
                        "replays": getattr(net, "replays", 0)}
        run["means"] = mean_scores(run["samples"])
        engine = "packed" if packed else "plain"
        if packed:
            expected = (f"{sites_per_forward} x ({forwards} forwards - {run['graph']['replays']}"
                        f" replayed from a CUDA graph + {run['graph']['captures']} captures)")
            held = graphed_launches_hold(run["launches"], forwards, sites=sites_per_forward,
                                         **run["graph"])
            held = held and (run["graph"]["replays"] > 0) == (device.type == "cuda")
        else:
            expected = f"{sites_per_forward} x {STEPS} x {len(rows)}"
            held = run["launches"] == sites_per_forward * forwards
        log(f"{tag} python -m sddm_tpu_torch.infer {' '.join(argv[2:])} ({engine} engine, "
            f"{dtype}, generator seed {seed}): {len(rows)} sampler calls of "
            f"{min(rows)}-{max(rows)} rows ({sum(rows)} rows), {run['launches']} wrapper "
            f"calls (expected {expected}), {stray} of the other GroupNorm kernel; serve "
            f"{run['serve_s']:.1f} s, scoring {run['score_s']:.1f} s on {smi}")
        per_call = config["infer_data_loader"]["args"]["batch_size"]
        if len(rows) != math.ceil(CORPUS_FILES / per_call):
            fail(f"the CLI made {len(rows)} sampler calls")
        if sum(rows) != n_rows:
            fail(f"the CLI served {sum(rows)} rows, the corpus has {n_rows}")
        if not held or stray != 0:
            fail(f"the CLI's kernel wrapper was called {run['launches']} times (expected "
                 f"{expected}), the other GroupNorm kernel {stray} (expected 0)")
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
    replayed = replayed_kernels(engine, device) if device.type == "cuda" else {}
    log(f"    one replay of each CUDA graph the seed-0 CLI's engine holds, under the profiler: "
        f"{NHWC_KERNEL} kernels by rows (seen, the capture's wrapper calls) {replayed}")
    if any(seen is not None and seen != PACKED_SITES for seen, _ in replayed.values()) or \
            any(calls != PACKED_SITES for _, calls in replayed.values()):
        fail(f"[21] a replay of the CLI's graphs launched other than {PACKED_SITES} "
             f"{NHWC_KERNEL} kernels: {replayed}")
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
                "launches": run["launches"], "graph": run.get("graph"),
                "serve_s": run["serve_s"],
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
        "replayed_kernels": {str(k): v for k, v in replayed.items()},
        "nvidia_smi": smi,
    }
    return {"nhwc_launches": runs["seed 0"]["launches"], "nchw_launches": plain["launches"],
            "nhwc_graph": runs["seed 0"]["graph"], "replayed_kernels": record["replayed_kernels"],
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
        if seen is not None and not 1 <= seen <= 5 * BWD_LAUNCHES_PER_CALL:
            fail(f"the profiler saw {seen} launches of the backward kernels for 5 calls; its "
                 f"last windows' device events: {UNSEEN_WINDOWS[-3:]}")
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
        if seen == 0:
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


def train_batch(config, device, rows: int = BATCH_ROWS):
    """The seeded train batch of phases 24 and 31 (``rows`` rows): (target,
    condition, the schedule, q draws for one step, a generator for the timed
    steps)."""
    import numpy as np
    import torch

    from sddm_tpu_torch.cli import build_diffusion

    ns = config["num_samples"]
    rng = np.random.default_rng(SEED + 3)
    clean = clips(rows, ns)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    target, condition = (torch.from_numpy(a).to(device) for a in (clean, noisy))
    diffusion = build_diffusion(config)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    draws = (torch.randint(1, diffusion.num_timesteps + 1, (rows,), generator=gen,
                           device=device),
             torch.rand((rows,), generator=gen, device=device),
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
    # the profiler saw no backward kernel is profiled again (profiler_windows)
    device_seen = []
    for margin, _ in profiler_windows():
        gn_silu_backward.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, margin_s=margin) as prof:
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - start) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        device_seen += events
        busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events}
        bwd_kernels = sum(v[1] for k, v in busy.items() if BWD_KERNEL in k)
        if bwd_kernels:
            break
    blind = not profiler_saw(device_seen, "[24]'s profiled train step")
    bwd_calls = gn_silu_backward.launches
    record["launches"] = {"gn_silu_nchw": SITES_PER_FORWARD, "gn_silu_backward": bwd_calls,
                          "backward_kernels": bwd_kernels}
    log(f"    profiled step: {bwd_kernels} {BWD_KERNEL}* kernels run on the device for "
        f"{bwd_calls} gn_silu_backward calls ({bwd_kernels / max(bwd_calls, 1):g} a call)")
    if bwd_calls != SITES_PER_FORWARD or \
            (not blind and bwd_kernels != SITES_PER_FORWARD * BWD_LAUNCHES_PER_CALL):
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
        if seen is not None and not 1 <= seen <= 5 * NHWC_BWD_LAUNCHES_PER_CALL:
            fail(f"the profiler saw {seen} launches of the NHWC backward kernels for 5 calls; its "
                 f"last windows' device events: {UNSEEN_WINDOWS[-3:]}")
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
        if seen == 0:
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
    device_seen = []
    for margin, _ in profiler_windows():  # a window that saw no kernel of ours is taken again
        gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, margin_s=margin) as prof:
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - start) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        device_seen += events
        busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events}
        fwd_kernels = sum(v[1] for k, v in busy.items() if NHWC_KERNEL in k)
        bwd_kernels = sum(v[1] for k, v in busy.items() if NHWC_BWD_KERNEL in k)
        if fwd_kernels and bwd_kernels:
            break
    blind = not profiler_saw(device_seen, "[31]'s profiled packed train step")
    calls = (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches)
    log(f"    profiled step: {fwd_kernels} {NHWC_KERNEL} and {bwd_kernels} {NHWC_BWD_KERNEL}* "
        f"kernels run on the device for {calls[0]} gn_silu_nhwc and {calls[1]} "
        f"gn_silu_nhwc_backward calls")
    if calls != (PACKED_SITES, PACKED_SITES) or not blind and (
            fwd_kernels != PACKED_SITES or
            bwd_kernels != PACKED_SITES * NHWC_BWD_LAUNCHES_PER_CALL):
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
    with env_set("SDDM_PACKED_TRAIN", "1"):
        b = run_train(["-c", str(path), "-r", str(RUN / "model_best.ckpt")])
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


# ---- the SNR-adaptive path (phases 33-38) ---------------------------------------
def committed_estimator(device, config=None):
    """The committed epoch-80 estimator on ``device``, through the weight
    bridge: (estimator, its segmentor, its config).  ``config`` (the joint
    recipe's) builds it from its ``snr_estimator`` block instead of the
    estimator run's ``arch`` block."""
    from sddm_tpu_torch.cli import build_segmentor, build_snr_estimator
    from sddm_tpu_torch.compat import network_state_dict_from_jax
    from sddm_tpu_torch.train.checkpoints import load_checkpoint

    own = json.loads((SNR_RUN / "config.json").read_text())
    cfg = config or own
    seg = build_segmentor(cfg)
    est = build_snr_estimator(cfg, seg, block="snr_estimator" if config else "arch")
    params = load_checkpoint(SNR_RUN / "model_best.ckpt")["params"]
    est.load_state_dict(network_state_dict_from_jax(est, params))
    return est.to(device).eval(), seg, own


def snr_sites_phase(gen, sms) -> dict:
    """Phase 33: both NCHW kernels against their plain versions at the
    estimator's 7 sites (batch 8, its training batch, and 16, its batch inside
    the joint model) and the variable network's distinct sites (batch 16),
    float32 and bfloat16, every call repeated bit for bit, each plan printed;
    [3]'s and [23]'s limits."""
    import torch

    from sddm_tpu_torch.cli import build_network

    device = gen.device
    config = json.loads(SNR_CONFIG.read_text())
    est, seg, _ = committed_estimator(device)
    z = torch.zeros(1, 1, seg.n_frames, seg.frame_len, device=device)
    est_sites = gn_sites(est, z)
    net = build_network({**config, "dtype": "float32"}).to(device).eval()
    var_sites = gn_sites(net, z, z, torch.ones(1, 1, seg.n_frames, 1, device=device))
    del net
    if len(est_sites) != EST_SITES or len(var_sites) != SITES_PER_FORWARD:
        fail(f"the estimator has {len(est_sites)} GroupNorm sites (expected {EST_SITES}), the "
             f"variable network {len(var_sites)} (expected {SITES_PER_FORWARD})")
    distinct = sorted(set(var_sites), key=lambda s: -math.prod(s[0]))
    cases = [((b,) + chw, g) for b in (EST_BATCH, BATCH_ROWS) for chw, g in est_sites]
    cases += [((BATCH_ROWS,) + chw, g) for chw, g in distinct]
    log(f"[33] the SNR path's GroupNorm+SiLU sites: the estimator's {len(est_sites)} "
        f"({', '.join(str(list(s)) for s, _ in est_sites)}) at batch {EST_BATCH} and "
        f"{BATCH_ROWS}, the variable network's {len(var_sites)} ({len(distinct)} distinct) at "
        f"batch {BATCH_ROWS}; forward at TOL {TOL}, backward at {BWD_REL} x scale + rtol "
        f"{BWD_RTOL}")
    worst = {"forward": {"float32": 0.0, "bfloat16": 0.0},
             "backward": {"float32": 0.0, "bfloat16": 0.0}}
    for shape, g in cases:
        for dtype_name, ok, err, plan in check_nchw(shape, g, 1.0, gen, sms):
            worst["forward"][dtype_name] = max(worst["forward"][dtype_name], err)
            log(f"    fwd {str(shape):22s} G={g:<3d} {dtype_name:8s} max|d|={err:.3e} "
                f"{'ok' if ok else 'OVER'}  {plan}")
            if not ok:
                fail(f"gn_silu disagrees with its plain version at {shape} {dtype_name}")
        for dtype_name, ok, errs, max_abs, plan in check_backward(shape, g, gen):
            worst["backward"][dtype_name] = max(worst["backward"][dtype_name], *errs.values())
            log(f"    bwd {str(shape):22s} G={g:<3d} {dtype_name:8s} "
                f"{' '.join(f'{k} {v:.1e}' for k, v in errs.items())} of the scale "
                f"{'ok' if ok else 'OVER'}  {nchw_plan_text(plan)}")
            if not ok:
                fail(f"gn_silu_backward disagrees with its plain backward at {shape} "
                     f"{dtype_name}: {errs}")
    return {"cases": len(cases), "worst": worst,
            "estimator_sites": [list(s) for s, _ in est_sites]}


def estimator_crops(work: Path, batches: int):
    """The first ``batches`` batches of ``EST_BATCH`` crops of [26]'s v2 test
    split as the estimator's validation loader gives them (RAM cache: int16
    PCM, not dequantised), in file order."""
    from sddm_tpu_torch.data.loaders import DATA_LOADERS, DATASETS

    ds = DATASETS["AudioDataset"](data_root=str(work / "voc" / "test"), datatype=".wav",
                                  sample_rate=16000, T=SNR_NUM_SAMPLES, cache="ram")
    loader = DATA_LOADERS["AudioDataLoader"](ds, batch_size=EST_BATCH, shuffle=False,
                                             num_workers=0)
    out = []
    for target, condition, _ in loader:
        out.append((target, condition))
        if len(out) == batches:
            return out
    return out


def estimator_phase(work: Path, device) -> dict:
    """Phase 34: the committed estimator through the bridge on seeded v2 test
    crops: the kernel path against the plain path (float32, TF32 off), one
    forward on the card against the CPU, and its l2 loss against the
    ``segment_sisnr`` targets beside the committed val_loss."""
    import numpy as np
    import torch

    from sddm_tpu_torch.models.losses import l2_loss
    from sddm_tpu_torch.ops.gn_silu import gn_silu
    from sddm_tpu_torch.train.snr_trainer import snr_targets

    est, seg, config = committed_estimator(device)
    cpu_est, _, _ = committed_estimator(torch.device("cpu"))
    losses, worst, rel_worst, card_cpu = [], 0.0, 0.0, 0.0
    gn_silu.launches = 0
    with torch.no_grad():
        for target, condition in estimator_crops(work, 2):
            t, c = (torch.from_numpy(np.asarray(a)).to(device) for a in (target, condition))
            cs, true = snr_targets(seg, t, c)
            out = est(cs)
            with plain_gn_silu():
                plain = est(cs)
            err, rel = differences(out, plain)
            worst, rel_worst = max(worst, err), max(rel_worst, rel)
            card_cpu = max(card_cpu, float((out.cpu() - cpu_est(cs.cpu())).abs().max()))
            losses.append(float(l2_loss(torch.squeeze(out), true)))
    torch.cuda.synchronize()
    launches = gn_silu.launches
    ok = worst <= SNR_EST_TOL[0] and rel_worst <= SNR_EST_TOL[1] and card_cpu <= SNR_CARD_VS_CPU
    log(f"[34] the committed estimator (artifacts/round5/snr_estimator/model_best.ckpt, epoch "
        f"80, {sum(p.numel() for p in est.parameters())} parameters) on {2 * EST_BATCH} v2 test "
        f"crops at int16 scale, as its validation loader gives them: SNR estimates, kernel path "
        f"vs plain path max|d| {worst:.3e} dB, rel L2 {rel_worst:.3e} (limits {SNR_EST_TOL}); "
        f"card vs CPU max|d| {card_cpu:.3e} dB (limit {SNR_CARD_VS_CPU}) "
        f"{'ok' if ok else 'OVER'}; {launches} gn_silu launches ({EST_SITES} a forward)")
    log(f"    l2_loss against the segment_sisnr targets: "
        f"{', '.join(f'{x:.2f}' for x in losses)} (mean {np.mean(losses):.2f}) beside the "
        f"committed val_loss {SNR_VAL_LOSS} (epoch 80, other crops)")
    if not ok or launches != 2 * EST_SITES:
        fail(f"the committed estimator: kernel vs plain {worst}, {rel_worst}, card vs CPU "
             f"{card_cpu}, {launches} launches")
    return {"kernel_vs_plain_db": worst, "kernel_vs_plain_rel_l2": rel_worst,
            "card_vs_cpu_db": card_cpu, "l2_losses": losses, "committed_val_loss": SNR_VAL_LOSS,
            "tol": list(SNR_EST_TOL), "card_vs_cpu_tol": SNR_CARD_VS_CPU}


def run_snr_cli(module, argv) -> dict:
    """``python -m sddm_tpu_torch.<module>`` (a training entry point of the
    SNR path) with ``argv``, run in this process: every epoch's log, the
    launches of both directions (NCHW, and NHWC for the packed twin), the
    trainer, the wall seconds."""
    import torch

    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_nhwc,
        gn_silu_nhwc_backward,
    )
    from sddm_tpu_torch.train.snr_trainer import SNREstimatorTrainer
    from sddm_tpu_torch.train.trainer import Trainer

    logs = []
    kept = {cls: cls._train_epoch for cls in (Trainer, SNREstimatorTrainer)}

    def logger_of(cls):
        def logged(self, epoch):
            logs.append((epoch, kept[cls](self, epoch)))
            return logs[-1][1]
        return logged

    parsed = module.parse_args(argv)
    gn_silu.launches = gn_silu_backward.launches = 0
    gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = 0
    start = time.perf_counter()
    with routed(Trainer, "_train_epoch", logger_of(Trainer)), \
            routed(SNREstimatorTrainer, "_train_epoch", logger_of(SNREstimatorTrainer)):
        trainer = module.main(*parsed) if isinstance(parsed, tuple) else module.main(parsed)
    torch.cuda.synchronize()
    return {"logs": logs, "seconds": time.perf_counter() - start, "trainer": trainer,
            "run": trainer.config.save_dir,
            "launches": (gn_silu.launches, gn_silu_backward.launches),
            "nhwc_launches": (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches)}


def snr_config(work: Path, name: str, base: Path, top: dict | None = None,
               infer_files: int | None = None, **trainer) -> Path:
    """``base`` (a config of the SNR path) for one CLI run under ``work``: its
    datasets on [26]'s v2 splits (the infer dataset on the subset of the
    first ``infer_files`` test files, by default ``SNR_SERVE_FILES``),
    TensorBoard off, its top level updated with ``top`` and its trainer
    block with ``trainer``."""
    config = {**json.loads(base.read_text()), **(top or {})}
    infer_files = infer_files or SNR_SERVE_FILES
    config["name"] = name
    config["tr_dataset"]["args"]["data_root"] = str(work / "voc" / "train")
    config["val_dataset"]["args"]["data_root"] = str(work / "voc" / "test")
    if "infer_dataset" in config:
        config["infer_dataset"]["args"]["data_root"] = str(work / f"voc{infer_files}")
    config["trainer"].update(save_dir=str(work / "saved"), tensorboard=False, **trainer)
    path = work / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def estimator_cli_phase(work: Path) -> dict:
    """Phase 35: ``python -m sddm_tpu_torch.train_snr_estimator -r
    model_best.ckpt`` on [26]'s 200 v2 train files for ``SNR_EPOCHS`` epochs
    (25 steps at batch 8, float32), validation each epoch."""
    import numpy as np

    from sddm_tpu_torch import train_snr_estimator
    from sddm_tpu_torch.train.checkpoints import CKPT_CURRENT, load_checkpoint

    committed = load_checkpoint(SNR_RUN / "model_best.ckpt", with_opt_state=True)
    first = committed["epoch"] + 1
    path = snr_config(work, "snr_estimator_resumed", SNR_RUN / "config.json",
                      epochs=first + SNR_EPOCHS - 1, valid_period=1, save_period=1)
    r = run_snr_cli(train_snr_estimator, ["-c", str(path), "-r", str(SNR_RUN / "model_best.ckpt")])
    steps = r["trainer"].len_epoch
    epochs = [(e, lg["loss"], lg.get("val_loss", math.nan)) for e, lg in r["logs"]]
    inside = all(SNR_RESUME_LOSS[0] <= x <= SNR_RESUME_LOSS[1] for _, x, _ in epochs)
    n_val = min(r["trainer"].n_valid_data_batch, len(r["trainer"].valid_data_loader))
    want = (SNR_EPOCHS * (steps + n_val) * EST_SITES, SNR_EPOCHS * steps * EST_SITES)
    ckpt = load_checkpoint(r["run"] / CKPT_CURRENT, with_opt_state=True)
    count = int(np.asarray(ckpt["opt_state"]["0"]["count"]))
    want_count = int(np.asarray(committed["opt_state"]["0"]["count"])) + SNR_EPOCHS * steps
    log(f"[35] python -m sddm_tpu_torch.train_snr_estimator -r artifacts/round5/snr_estimator/"
        f"model_best.ckpt on {SNR_FILES} v2 train files ({steps} steps of {EST_BATCH}, float32): "
        f"epochs {', '.join(f'{e}: loss {x:.2f}, val_loss {v:.2f}' for e, x, v in epochs)} "
        f"(band {SNR_RESUME_LOSS}) {'ok' if inside else 'OVER'}; launches gn_silu "
        f"{r['launches'][0]}, backward {r['launches'][1]} (expected {want}: {EST_SITES} a "
        f"forward); optimizer count {count} (expected {want_count}); wall {r['seconds']:.1f} s")
    if [e for e, _, _ in epochs] != list(range(first, first + SNR_EPOCHS)) or not inside or \
            steps != SNR_FILES // EST_BATCH or r["launches"] != want or count != want_count or \
            not all(math.isfinite(v) for _, _, v in epochs):
        fail(f"the estimator CLI: epochs {epochs}, {steps} steps, launches {r['launches']}, "
             f"count {count}")
    return {"epochs": [{"epoch": e, "loss": x, "val_loss": v} for e, x, v in epochs],
            "band": list(SNR_RESUME_LOSS), "launches": list(r["launches"]),
            "seconds": r["seconds"], "count": count}


def joint_batch(config, device):
    """The seeded joint train batch of phase 36: (target, condition, the q
    draws (t, eps on the segments), a generator for the timed steps)."""
    import numpy as np
    import torch

    ns = config["num_samples"]
    rng = np.random.default_rng(SEED + 5)
    clean = clips(BATCH_ROWS, ns)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    target, condition = (torch.from_numpy(a).to(device) for a in (clean, noisy))
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    seg = config["segmentor"]["args"]
    n_seg = (ns - seg["F"]) // seg["stride"] + 1
    draws = (int(torch.randint(1, config["diffusion"]["args"]["n_timestep"] + 1, (),
                               generator=gen, device=device)),
             torch.randn((BATCH_ROWS, 1, n_seg, seg["F"]), generator=gen, device=device))
    return target, condition, draws, gen


def joint_train_step_phase(device) -> dict:
    """Phase 36: one joint train step (``configs/config_unet_snr_synth.json``:
    bf16, batch 16, 16448 samples, the committed estimator frozen, the network
    from seeded init): the estimator's SNR estimates kernel vs plain, then the
    step's kernel path against both GroupNorm directions plain under the same
    tables and draws (one ulp of a noise level is another 1e7-scale encoding),
    bf16 and float32; the estimator bit-identical after the steps; 40 + 33
    launches a step; the encoding on the card against the CPU; the median of
    ``TRAIN_TIMED_STEPS`` steps, peak memory and one profiled step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.cli import build_network, build_optimizer, build_snr_composite
    from sddm_tpu_torch.models import blocks
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.models.unet_variable import VariablePositionalEncoding
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_backward_reference,
        gn_silu_reference,
    )
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step
    from sddm_tpu_torch.utils.profiling import profiled

    config = json.loads(SNR_CONFIG.read_text())
    est, seg, _ = committed_estimator(device, config)
    frozen = {k: v.clone() for k, v in est.state_dict().items()}
    target, condition, draws, gen = joint_batch(config, device)
    nets = [build_network(config, device=device, role="train").to(device) for _ in range(2)]
    init_parameters(nets[0], torch.Generator().manual_seed(SEED))
    initial = {k: v.clone() for k, v in nets[0].state_dict().items()}
    lr = config["optimizer"]["args"]["lr"]
    record, failures = {}, []

    # the estimator alone: kernel path vs plain, and what that does to the tables
    cond_seg = seg(condition)
    with torch.no_grad():
        snr_k = est(cond_seg)
        with plain_gn_silu():
            snr_p = est(cond_seg)
    model = build_snr_composite(config, nets[0], est, seg)
    tables_k = model.tables(cond_seg)
    with plain_gn_silu():
        tables_p = model.tables(cond_seg)
    snr_err, snr_rel = differences(snr_k, snr_p)
    moved = float((tables_k.sqrt_alpha_bar != tables_p.sqrt_alpha_bar).float().mean())
    log(f"[36] joint train step (configs/config_unet_snr_synth.json, batch {BATCH_ROWS}, the "
        f"committed estimator frozen): SNR estimates kernel vs plain max|d| {snr_err:.3e} dB, "
        f"rel L2 {snr_rel:.3e} (limits {SNR_JOINT_EST_TOL}); noise levels that differ by any "
        f"bit: {moved:.4f} of them")
    if not (snr_err <= SNR_JOINT_EST_TOL[0] and snr_rel <= SNR_JOINT_EST_TOL[1]):
        fail(f"the estimator's kernel path differs from its plain path: {snr_err}, {snr_rel}")
    record["snr_estimates"] = {"max_abs_db": snr_err, "rel_l2": snr_rel,
                               "levels_moved_share": moved}

    # the encoding of the step's levels on the card against the CPU
    levels = tables_k.sqrt_alpha_bar[..., 1:].permute(0, 3, 2, 1).reshape(
        -1, 1, seg.n_frames, 1)
    enc = VariablePositionalEncoding(config["network"]["args"].get("noise_level_channel", 128))
    enc_err = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        on_card = enc(levels.to(dtype)).float().cpu()
        on_cpu = enc(levels.cpu().to(dtype)).float()
        enc_err[name] = float((on_card - on_cpu).abs().max())
    log(f"    1e7-scale encoding of the {levels.numel()} levels of T = 100 steps, card vs CPU: "
        f"max|d| float32 {enc_err['float32']:.3e}, bfloat16 {enc_err['bfloat16']:.3e}")
    record["encoding_card_vs_cpu"] = enc_err

    def fresh(dtype, net):
        net.load_state_dict(initial)
        net.dtype = dtype
        m = build_snr_composite(config, net, est, seg)
        optimizer = build_optimizer(config, net, est)
        return m, optimizer, make_train_step(m, l1_loss, optimizer)

    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        model_k, opt_k, step_k = fresh(dtype, nets[0])
        model_p, _, step_p = fresh(dtype, nets[1])
        captured = []
        tables = model_k.tables

        def capture(cs):
            captured.append(tables(cs))
            return captured[-1]

        gn_silu.launches = gn_silu_backward.launches = 0
        with routed(model_k, "tables", capture):
            loss_k = step_k(target, condition, draws=draws)
        torch.cuda.synchronize()
        launches = (gn_silu.launches, gn_silu_backward.launches)
        if launches != (SITES_PER_FORWARD + EST_SITES, SITES_PER_FORWARD):
            fail(f"one {dtype_name} joint step launched gn_silu / gn_silu_backward {launches} "
                 f"times, expected {SITES_PER_FORWARD + EST_SITES} and {SITES_PER_FORWARD}")
        with routed(model_p, "tables", lambda cs: captured[0]), \
                routed(blocks, "gn_silu", gn_silu_reference), \
                routed(blocks, "gn_silu_backward", gn_silu_backward_reference):
            loss_p = step_p(target, condition, draws=draws)
        torch.cuda.synchronize()
        if launches != (gn_silu.launches, gn_silu_backward.launches):
            fail("the routed joint step launched a GroupNorm kernel")
        if any(p.grad is not None for p in est.parameters()) or \
                any(not torch.equal(v, frozen[k]) for k, v in est.state_dict().items()):
            fail(f"the {dtype_name} steps changed the frozen estimator or gave it a gradient")
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(nets[0], nets[1], lr)
        tol = TRAIN_TOL[dtype_name]
        readings = (loss_rel, grad_rel, worst_rel, apart)
        ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
        record[dtype_name] = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
                              "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                              "worst_param_grad_rel_l2": worst_rel, "worst_param": worst_name,
                              "updates_apart_share": apart, "param_max_abs_diff": dmax,
                              "tol": list(tol)}
        log(f"    {dtype_name}: kernel path vs both directions plain, same weights, batch, draws "
            f"(t = {draws[0]}) and tables: loss {float(loss_k):.6f} vs {float(loss_p):.6f} (rel "
            f"{loss_rel:.2e}, tol {tol[0]}); gradients rel L2 {grad_rel:.2e} (tol {tol[1]}), "
            f"worst {worst_name} {worst_rel:.2e} (tol {tol[2]}); parameters max|d| {dmax:.2e}, "
            f"share apart {apart:.2e} (tol {tol[3]}) {'ok' if ok else 'OVER'}; launches "
            f"{launches[0]} gn_silu ({SITES_PER_FORWARD} + {EST_SITES}) + {launches[1]} backward; "
            f"the estimator unchanged")
        if not ok:
            failures.append(f"{dtype_name}: {readings}")
    if failures:
        fail(f"the joint kernel-path step differs from the plain path: {failures}")
    del nets[1]

    model, _, step = fresh(torch.bfloat16, nets[0])
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
    device_seen = []
    for margin, _ in profiler_windows():  # a window that saw no backward kernel is taken again
        gn_silu.launches = gn_silu_backward.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, margin_s=margin) as prof:
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - start) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        device_seen += events
        busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events}
        bwd_kernels = sum(v[1] for k, v in busy.items() if BWD_KERNEL in k)
        fwd_kernels = sum(v[1] for k, v in busy.items() if is_nchw_kernel(k))
        if bwd_kernels:
            break
    blind = not profiler_saw(device_seen, "[36]'s profiled joint train step")
    calls = (gn_silu.launches, gn_silu_backward.launches)
    busy_ms = sum(v[0] for v in busy.values())
    record.update({"launches": {"gn_silu_nchw": calls[0], "gn_silu_backward": calls[1],
                                "forward_kernels": fwd_kernels, "backward_kernels": bwd_kernels},
                   "step_ms_median": step_ms, "step_ms_min": min(times) * 1e3,
                   "step_ms_max": max(times) * 1e3, "peak_bytes": peak,
                   "profile": {"wall_ms": prof_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1 - busy_ms / step_ms if busy_ms else None}})
    log(f"    bf16 joint step: median {step_ms:.2f} ms over {TRAIN_TIMED_STEPS} (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), peak {peak / 2**20:.1f} MiB; "
        f"profiled step: {fwd_kernels} gn_silu_nchw and {bwd_kernels} {BWD_KERNEL}* kernels on "
        f"the device for {calls[0]} and {calls[1]} calls")
    for name, (ms, count) in sorted(busy.items()):
        if "gn_silu" in name:
            log(f"    x{count:<3d} {ms:8.3f} ms {name[:110]}")
    # gated as [24] gates: the wrappers' counts, and the backward kernels the
    # profiler saw (the forward count is printed: PERF.md section 7)
    if calls != (SITES_PER_FORWARD + EST_SITES, SITES_PER_FORWARD) or \
            (not blind and bwd_kernels != SITES_PER_FORWARD * BWD_LAUNCHES_PER_CALL):
        fail(f"the profiled joint step ran {bwd_kernels} backward kernels for {calls}")
    if busy_ms > 0:
        log(f"    profiled step: device busy {busy_ms:.2f} ms, idle share "
            f"{1 - busy_ms / step_ms:.3f} of the median step ({1 - busy_ms / prof_ms:.3f} of the "
            f"profiled wall, {prof_ms:.1f} ms)")
        for name, (ms, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{count:<5d} {name[:90]}")
    else:
        log("    the profiler saw no device time: breakdown not measured")
    return record


def joint_training_cli_phase(work: Path) -> dict:
    """Phase 37: ``python -m sddm_tpu_torch.train_with_snr_estimator -s
    model_best.ckpt`` from init on [35]'s 200 train files, ``SNR_EPOCHS``
    epochs of 25 steps (batch 8), a full-T validation at the last epoch."""
    import numpy as np

    from sddm_tpu_torch import train_with_snr_estimator
    from sddm_tpu_torch.train.checkpoints import CKPT_BEST, CKPT_CURRENT, load_checkpoint

    t_steps = json.loads(SNR_CONFIG.read_text())["diffusion"]["args"]["n_timestep"]
    path = snr_config(work, "snr_joint", SNR_CONFIG, epochs=SNR_EPOCHS, valid_period=SNR_EPOCHS,
                      save_period=1)
    with cudnn_deterministic():  # the run repeats its losses from call to call
        r = run_snr_cli(train_with_snr_estimator,
                        ["-c", str(path), "-s", str(SNR_RUN / "model_best.ckpt"),
                         "--bs", str(EST_BATCH)])
    steps = r["trainer"].len_epoch
    losses = [lg["loss"] for _, lg in r["logs"]]
    val = r["logs"][-1][1]
    want = (SNR_EPOCHS * steps * (SITES_PER_FORWARD + EST_SITES)
            + EST_SITES + SITES_PER_FORWARD * t_steps, SNR_EPOCHS * steps * SITES_PER_FORWARD)
    wavs = sorted((r["run"] / "samples" / "output").glob("*.wav"))
    written = [n for n in (CKPT_CURRENT, CKPT_BEST) if (r["run"] / n).is_file()]
    est_params = load_checkpoint(r["run"] / CKPT_BEST)["params"]["snr_estimator"]
    committed = load_checkpoint(SNR_RUN / "model_best.ckpt")["params"]

    def leaves(tree):
        return [tree] if not isinstance(tree, dict) else \
            [x for k in sorted(tree) for x in leaves(tree[k])]

    same_est = all(np.array_equal(a, b) for a, b in zip(leaves(est_params), leaves(committed)))
    inside = JOINT_LOSS[0] <= losses[-1] <= JOINT_LOSS[1]
    log(f"[37] python -m sddm_tpu_torch.train_with_snr_estimator -s artifacts/round5/"
        f"snr_estimator/model_best.ckpt --bs {EST_BATCH}, from init on {SNR_FILES} v2 train files "
        f"({steps} steps an epoch, bf16): epoch losses {', '.join(f'{x:.4f}' for x in losses)} "
        f"(epoch {SNR_EPOCHS} band {JOINT_LOSS}) {'ok' if inside else 'OVER'}; full-T ({t_steps}) "
        f"validation: val_loss {val.get('val_loss', math.nan):.4f}, val_sisnr "
        f"{val.get('val_sisnr', math.nan):.3f}; launches gn_silu {r['launches'][0]}, backward "
        f"{r['launches'][1]} (expected {want}); wrote {written}, {len(wavs)} validation WAVs; "
        f"the estimator in {CKPT_BEST} is the committed one: {same_est}; wall "
        f"{r['seconds']:.1f} s")
    if steps != SNR_FILES // EST_BATCH or not all(math.isfinite(x) for x in losses) or \
            not inside or "val_loss" not in val or r["launches"] != want or \
            written != [CKPT_CURRENT, CKPT_BEST] or len(wavs) != EST_BATCH or not same_est:
        fail(f"the joint training CLI: {steps} steps, losses {losses}, launches "
             f"{r['launches']}, wrote {written}, {len(wavs)} WAVs, estimator kept {same_est}")
    return {"epoch_losses": losses, "band": list(JOINT_LOSS), "val_loss": val["val_loss"],
            "val_sisnr": val.get("val_sisnr"), "launches": list(r["launches"]),
            "seconds": r["seconds"], "run": r["run"]}


def joint_infer_phase(work: Path, run: Path, smi: str, tag: str = "[38]",
                      files: int | None = None, packed: bool = False) -> dict:
    """Phases 38 and 47: ``python -m sddm_tpu_torch.infer_with_snr_estimator
    -r <run's best>`` on the first ``files`` files of the v2 test split at T =
    100 (with ``packed``: on a ``"packed": true`` config, the packed variable
    engine): every row once, finite, the launches; one batch again under the
    same noise and tables with the network's GroupNorm+SiLU plain (with
    ``packed``: through the plain variable engine), its SNR estimates kernel
    vs plain, and all of it plain; the means beside the committed JAX table
    of another checkpoint (not gated).  ``files`` defaults to
    ``SNR_SERVE_FILES``."""
    import numpy as np
    import torch

    from sddm_tpu_torch import infer_with_snr_estimator as cli
    from sddm_tpu_torch.data.wav_io import load_wav
    from sddm_tpu_torch.models import PackedUNetVariable, UNetModified2_VariableNoiseLevel
    from sddm_tpu_torch.models.sddm import SDDM_with_SNREstimator
    from sddm_tpu_torch.ops.gn_silu import gn_silu, gn_silu_nhwc
    from sddm_tpu_torch.train.checkpoints import CKPT_BEST

    files = files or SNR_SERVE_FILES
    subset = linked_subset(work / "voc" / "test", work / f"voc{files}", files)
    names = sorted(p.name for p in (subset / "noisy").glob("*.wav"))
    want_rows = sum(math.ceil(load_wav(subset / "noisy" / n)[0].shape[-1]
                              / SNR_NUM_SAMPLES) for n in names)
    path = snr_config(work, "snr_infer_packed" if packed else "snr_infer", SNR_CONFIG,
                      top={"packed": True} if packed else None, infer_files=files)
    t_steps = json.loads(SNR_CONFIG.read_text())["diffusion"]["args"]["n_timestep"]
    rows, first, built, scoring, losses = [], [], [], [], []
    sampler, score, build, loss_of = (SDDM_with_SNREstimator.infer, cli.evaluate,
                                      cli.build_model, cli.build_loss)

    def counted(self, condition, *args, **kwargs):
        out = sampler(self, condition, *args, **kwargs)
        if not bool(torch.isfinite(out).all()) or out.shape != condition.shape:
            fail(f"sampler call {len(rows)}: {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
        rows.append(out.shape[0])
        if not first:
            first.append(condition.clone())
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

    def kept_loss(config):
        fn = loss_of(config)

        def recorded(*args):
            losses.append(float(fn(*args)))
            return fn(*args)
        return recorded

    config = cli.parse_args(["-c", str(path), "-r", str(run / CKPT_BEST)])
    gn_silu.launches = gn_silu_nhwc.launches = 0
    start = time.perf_counter()
    with routed(SDDM_with_SNREstimator, "infer", counted), \
            routed(cli, "evaluate", timed_evaluate), routed(cli, "build_model", kept_model), \
            routed(cli, "build_loss", kept_loss):
        result = cli.main(config)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    engine = type(built[0].network)
    if packed:  # the estimator's sites on gn_silu, the network's on gn_silu_nhwc
        launches = (gn_silu.launches, gn_silu_nhwc.launches)
        want_launches = (EST_SITES * len(rows), SITES_PER_FORWARD * t_steps * len(rows))
        expected = (f"({EST_SITES} x {len(rows)}, {SITES_PER_FORWARD} x {t_steps} x {len(rows)}) "
                    f"= gn_silu, gn_silu_nhwc")
    else:
        launches = gn_silu.launches
        want_launches = (EST_SITES + SITES_PER_FORWARD * t_steps) * len(rows)
        expected = f"({EST_SITES} + {SITES_PER_FORWARD} x {t_steps}) x {len(rows)}"
    outputs = len(list((config.save_dir / "samples" / "output").glob("*.wav")))
    flag = 'on a "packed": true config ' if packed else ""
    log(f"{tag} python -m sddm_tpu_torch.infer_with_snr_estimator -r <{CKPT_BEST}> "
        f"{flag}on {files} v2 test files at T = "
        f"{t_steps}: network {engine.__name__}; {len(rows)} sampler calls, {sum(rows)} rows "
        f"(expected {want_rows}), {outputs} output WAVs; launches {launches} (expected "
        f"{want_launches} = {expected}); serve {total - scoring[0]:.1f} s, scoring "
        f"{scoring[0]:.1f} s on {smi}")
    want_engine = PackedUNetVariable if packed else UNetModified2_VariableNoiseLevel
    if sum(rows) != want_rows or outputs != files or launches != want_launches or \
            engine is not want_engine:
        fail(f"infer_with_snr_estimator served {sum(rows)} rows, {outputs} files, {launches} "
             f"launches, through {engine.__name__}")
    loss = float(np.mean(losses))
    for m, table in SNR_JOINT_TABLE.items():
        if m in result:
            log(f"    {m:15s} noisy {result[m]['noisy']:.4f} output {result[m]['output']:.4f} | "
                f"the committed JAX run (another checkpoint, 17 files): noisy {table[0]:.4f} "
                f"output {table[1]:.4f}")
    log(f"    loss {loss:.5f} | the committed JAX run {SNR_JOINT_LOSS}")

    # one batch again: its SNR estimates, the network plain under the same
    # tables and noise, and all of it plain
    model = built[0]
    cond = first[0]
    seg = model.segmentor(cond)
    gen = torch.Generator(device=cond.device).manual_seed(SEED + 7)
    stream = (torch.randn(seg.shape, generator=gen, device=cond.device),
              torch.randn((t_steps,) + tuple(seg.shape), generator=gen, device=cond.device))
    with torch.no_grad():
        snr_k = model.snr_estimator(seg)
        with plain_gn_silu():
            snr_p = model.snr_estimator(seg)
    tables = model.tables(seg)
    out_k = model.infer(cond, noise_stream=stream)
    # packed: the plain variable engine (NCHW kernels) with the same weights
    reference = routed(model, "network", model.network.net) if packed else plain_gn_silu()
    with reference, routed(model, "tables", lambda cs: tables):
        out_p = model.infer(cond, noise_stream=stream)
    with plain_gn_silu(), plain_gn_silu_nhwc():
        out_pp = model.infer(cond, noise_stream=stream)
    torch.cuda.synchronize()
    snr_err, snr_rel = differences(snr_k, snr_p)
    e2e = differences(out_k, out_p)
    all_plain = differences(out_k, out_pp)
    against = "the plain engine" if packed else "the network's GroupNorm+SiLU plain"
    ok = e2e[1] <= SNR_E2E_TOL and \
        snr_err <= SNR_JOINT_EST_TOL[0] and snr_rel <= SNR_JOINT_EST_TOL[1]
    log(f"    one batch of {cond.shape[0]} rows again under one noise stream: SNR estimates "
        f"kernel vs plain max|d| {snr_err:.3e} dB, rel L2 {snr_rel:.3e} (limits "
        f"{SNR_JOINT_EST_TOL}); {against}, the same tables: max|d| "
        f"{e2e[0]:.3e} (not gated), rel L2 {e2e[1]:.3e} (limit {SNR_E2E_TOL}) "
        f"{'ok' if ok else 'OVER'}; "
        f"all plain (its own tables): max|d| {all_plain[0]:.3e}, rel L2 {all_plain[1]:.3e} "
        f"(not gated)")
    if not ok:
        fail(f"the served batch differs from its plain path: SNR {snr_err}, {snr_rel}; "
             f"output {e2e}")
    return {"calls": len(rows), "rows": sum(rows), "launches": launches,
            "engine": engine.__name__, "serve_s": total - scoring[0], "score_s": scoring[0],
            "loss": loss,
            "means": {m: result[m] for m in result},
            "batch_vs_plain": {"snr_max_abs_db": snr_err, "snr_rel_l2": snr_rel,
                               "max_abs": e2e[0], "rel_l2": e2e[1], "tol_rel_l2": SNR_E2E_TOL,
                               "all_plain_max_abs": all_plain[0],
                               "all_plain_rel_l2": all_plain[1]}}


def snr_phases(work: Path, smi: str, device, gen, sms) -> tuple:
    """Phases 33-38, the SNR-adaptive path; [34]-[38] on [26]'s v2 corpus.
    Returns their record and [37]'s run dir."""
    sites = snr_sites_phase(gen, sms)
    estimator = estimator_phase(work, device)
    estimator_cli = estimator_cli_phase(work)
    step = joint_train_step_phase(device)
    joint_cli = joint_training_cli_phase(work)
    run = joint_cli.pop("run")
    served = joint_infer_phase(work, run, smi)
    return {"sites": sites, "estimator": estimator, "estimator_cli": estimator_cli,
            "joint_train_step": step, "joint_training_cli": joint_cli,
            "joint_infer": served}, run


def zoo_config(name: str) -> dict:
    """The shipped config of ``name`` (config_unet.json, the flagship's
    widths, for UNetSP) as a dict."""
    config = json.loads((ROOT / "configs" / ZOO_CONFIGS[name]).read_text())
    config["network"]["type"] = name
    return config


def zoo_sites_phase(gen, sms) -> dict:
    """Phase 39: both NCHW kernels against their plain versions at every
    distinct GroupNorm+SiLU site of UNetTST (config_unettst.json) and UNetSP
    (the flagship's widths), batch 16, float32 and bfloat16, every call
    repeated bit for bit and its plan printed; [3]'s and [23]'s limits."""
    import torch

    from sddm_tpu_torch.cli import build_network

    device = gen.device
    sites = {}
    for name in ("UNetTST", "UNetSP"):
        config = zoo_config(name)
        net = build_network(config, num_samples=config["num_samples"]).to(device).eval()
        sites[name] = net_sites(net, config["num_samples"], device)
        del net
        if len(sites[name]) != ZOO_SITES[name]:
            fail(f"{name} has {len(sites[name])} GroupNorm sites, expected {ZOO_SITES[name]}")
    distinct = sorted(set(sites["UNetTST"] + sites["UNetSP"]), key=lambda s: -math.prod(s[0]))
    log(f"[39] the zoo's GroupNorm+SiLU sites: UNetTST {len(sites['UNetTST'])}, UNetSP "
        f"{len(sites['UNetSP'])}, {len(distinct)} distinct (C, H, W), G, down to "
        f"{distinct[-1][0]}; each at batch {BATCH_ROWS}, forward at TOL {TOL}, backward at "
        f"{BWD_REL} x scale + rtol {BWD_RTOL}")
    worst = {"forward": {"float32": 0.0, "bfloat16": 0.0},
             "backward": {"float32": 0.0, "bfloat16": 0.0}}
    for chw, g in distinct:
        shape = (BATCH_ROWS,) + chw
        where = "+".join(n for n in sites if (chw, g) in sites[n])
        for dtype_name, ok, err, plan in check_nchw(shape, g, 1.0, gen, sms):
            worst["forward"][dtype_name] = max(worst["forward"][dtype_name], err)
            log(f"    fwd {str(shape):20s} G={g:<3d} {dtype_name:8s} max|d|={err:.3e} "
                f"{'ok' if ok else 'OVER'} ({where})  {plan}")
            if not ok:
                fail(f"gn_silu disagrees with its plain version at {shape} {dtype_name}")
        for dtype_name, ok, errs, max_abs, plan in check_backward(shape, g, gen):
            worst["backward"][dtype_name] = max(worst["backward"][dtype_name], *errs.values())
            log(f"    bwd {str(shape):20s} G={g:<3d} {dtype_name:8s} "
                f"{' '.join(f'{k} {v:.1e}' for k, v in errs.items())} of the scale "
                f"{'ok' if ok else 'OVER'}  {nchw_plan_text(plan)}")
            if not ok:
                fail(f"gn_silu_backward disagrees with its plain backward at {shape} "
                     f"{dtype_name}: {errs}")
    return {"distinct_sites": len(distinct), "worst": worst,
            "sites": {n: len(v) for n, v in sites.items()}}


def seeded_checkpoint(work: Path, name: str, config: dict) -> tuple:
    """``name`` at ``config`` on seeded weights (the port's JAX-style init,
    seed ``SEED``), written by the port's checkpoint writer with its config
    into a run dir under ``work``: (checkpoint path, the CPU network)."""
    import torch

    from sddm_tpu_torch.cli import build_network
    from sddm_tpu_torch.compat import network_jax_params
    from sddm_tpu_torch.train.checkpoints import save_checkpoint
    from sddm_tpu_torch.train.trainer import init_parameters

    net = build_network(config, num_samples=config["num_samples"]).eval()
    init_parameters(net, torch.Generator().manual_seed(SEED))
    run = work / "zoo_runs" / name
    run.mkdir(parents=True)
    (run / "config.json").write_text(json.dumps(config))
    ckpt = run / "model_best.ckpt"
    save_checkpoint(ckpt, arch="SDDM", epoch=0, params=network_jax_params(
        net, dict(net.named_parameters())), opt_state={}, monitor_best=0.0, config=config)
    return ckpt, net


def stepwise_kernel_vs_plain(enh, audios, device, plain=plain_gn_silu):
    """The served network's output at every step of one sampler call on the
    first batch of ``audios``, along the kernel path's own trajectory, the
    kernel path against the GroupNorm+SiLU plain (``plain()``: the NCHW
    sites, or ``plain_gn_silu_nhwc`` for a packed engine) on the same inputs
    (no step carries another's difference): (max |d|, the worst step's rel
    L2)."""
    import numpy as np
    import torch

    model, net, readings = enh.model, enh.model.network, []

    def both(*args, **kwargs):
        out = net(*args, **kwargs)
        with plain():
            readings.append(differences(out, net(*args, **kwargs)))
        return out

    rows = np.concatenate([enh._chunk(a) for a in audios])[:BATCH_ROWS]
    cond = torch.from_numpy(rows).to(device)
    with routed(model, "network", both):
        model.infer(cond, torch.Generator(device=device).manual_seed(SEED))
    return max(r[0] for r in readings), max(r[1] for r in readings)


def serving_phase(tag: str, work: Path, audios, device, configs: dict, sites: dict,
                  sampler_gated, e2e_gated) -> dict:
    """Phases 40 and 43: each network of ``configs`` (``{name: (label,
    config)}``) through ``load_enhancer(steps=12)`` on its seeded checkpoint,
    serving the four requests at ancestral-12, each batch of 16 rows: shapes,
    finiteness, the GroupNorm kernel's launches (``sites[name]`` a forward),
    serve seconds, RTF and peak memory; the networks with sites served again
    with the GroupNorm+SiLU plain, the served outputs held at ``ZOO_E2E_TOL``
    (rel L2) for the networks of ``e2e_gated`` and printed for the others,
    and every step's network output held at ``ZOO_E2E_TOL`` against its
    plain version on the same input (:func:`stepwise_kernel_vs_plain`); two
    rows, one float32 forward on the card against the CPU
    (``CARD_VS_CPU_TOL``) and one sampler call under one noise stream, held
    against the CPU's for the networks of ``sampler_gated``
    (``ZOO_CARD_VS_CPU_TOL``), the card's call repeated and again with x_T
    one ulp up."""
    import numpy as np
    import torch

    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.cli import NETWORKS, build_arch, build_diffusion
    from sddm_tpu_torch.ops.gn_silu import gn_silu

    record = {}
    for name, (label, config) in configs.items():
        ckpt, cpu_net = seeded_checkpoint(work, name, config)
        ns = config["num_samples"]
        start = time.perf_counter()
        enh = load_enhancer(ckpt, config, batch_rows=BATCH_ROWS, steps=STEPS)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        net = enh.model.network
        if type(net) is not NETWORKS[name] or enh.model.num_timesteps != STEPS or net.training:
            fail(f"load_enhancer served {type(net).__name__} at {enh.model.num_timesteps} steps, "
                 f"training mode {net.training}")
        n_rows = sum(math.ceil(a.size / ns) for a in audios)
        n_batches = math.ceil(n_rows / BATCH_ROWS)
        serve_requests(enh, audios, SEED + 1, device)  # cuDNN's autotuning, the allocator
        torch.cuda.reset_peak_memory_stats()
        gn_silu.launches = 0
        served, serve_s = serve_requests(enh, audios, SEED, device)
        launches = gn_silu.launches
        peak = torch.cuda.max_memory_allocated()
        audio_s = sum(a.size for a in audios) / config["sample_rate"]
        expected = sites[name] * STEPS * n_batches
        shapes_ok = all(y.shape == a.shape and np.isfinite(y).all() for a, y in zip(audios, served))
        rec = {"rows": n_rows, "load_s": load_s, "serve_s": serve_s, "rtf": serve_s / audio_s,
               "peak_bytes": peak, "launches": launches,
               "params": sum(p.numel() for p in net.parameters())}
        log(f"{tag} {name} ({label}, {rec['params']} parameters, seeded init): "
            f"load_enhancer {load_s:.2f} s; {len(audios)} requests ({audio_s:.2f} s of audio, "
            f"{n_rows} rows of {ns}, {n_batches} batch) at ancestral-{STEPS} of T = "
            f"{config['diffusion']['args']['n_timestep']}, float32: serve {serve_s:.3f} s (RTF "
            f"{serve_s / audio_s:.4f}), peak {peak / 2**20:.1f} MiB; gn_silu launches {launches} "
            f"(expected {expected}: {sites[name]} x {STEPS} x {n_batches}); outputs finite "
            f"and shaped {shapes_ok}, max |y| {max(float(np.abs(y).max()) for y in served):.3f}")
        if not shapes_ok or launches != expected:
            fail(f"{name} served: shapes and finite {shapes_ok}, gn_silu launches {launches}")
        if sites[name]:
            with plain_gn_silu():
                plain, plain_s = serve_requests(enh, audios, SEED, device)
            err, rel = served_differences(served, plain)
            step_err, step_rel = stepwise_kernel_vs_plain(enh, audios, device)
            rec["e2e"] = {"max_abs": err, "rel_l2": rel, "plain_s": plain_s,
                          "step_max_abs": step_err, "step_rel_l2": step_rel}
            ok = step_rel <= ZOO_E2E_TOL and (rel <= ZOO_E2E_TOL or name not in e2e_gated)
            log(f"    kernel path vs plain GroupNorm+SiLU, same weights and noise: served max|d| "
                f"{err:.3e} (printed), rel L2 {rel:.3e} "
                f"({f'limit {ZOO_E2E_TOL}' if name in e2e_gated else 'printed'}); each of the "
                f"{STEPS} steps' network output on the same input: max|d| {step_err:.3e}, worst "
                f"rel L2 {step_rel:.3e} (limit {ZOO_E2E_TOL}) {'ok' if ok else 'OVER'}; plain "
                f"serve {plain_s:.3f} s")
            if not ok:
                fail(f"{name}: the served kernel path differs from the plain path: {rec['e2e']}")
        rows = torch.from_numpy(enh._chunk(audios[0])[:ZOO_CPU_ROWS])
        rng = np.random.default_rng(SEED + 40)
        x_t = torch.from_numpy(rng.standard_normal(rows.shape).astype(np.float32))
        steps = torch.from_numpy(rng.standard_normal((STEPS,) + rows.shape).astype(np.float32))
        level = torch.full((ZOO_CPU_ROWS, 1, 1), 0.5)
        with torch.no_grad():
            card_fwd = net(rows.to(device), x_t.to(device), level.to(device)).cpu()
            cpu_fwd = cpu_net(rows, x_t, level)
        fwd_err, fwd_rel = differences(card_fwd, cpu_fwd)

        def card_sampler(start):
            return enh.model.infer(rows.to(device), noise_stream=(
                start.to(device), steps.to(device))).cpu()

        card = card_sampler(x_t)
        again = card_sampler(x_t)
        sensitivity = differences(card_sampler(torch.nextafter(x_t, x_t + 1)), card)
        rec["card_vs_cpu"] = {"forward_max_abs": fwd_err, "forward_rel_l2": fwd_rel,
                              "card_repeat_same_bits": bool(torch.equal(card, again)),
                              "sampler_one_ulp_of_x_T": list(sensitivity)}
        ok, sampler = fwd_err <= CARD_VS_CPU_TOL, "not run on the CPU"
        if name in sampler_gated:  # the networks whose sampler the card holds against the CPU
            cpu_model = build_arch(config, build_diffusion(config), cpu_net).with_sampling_steps(
                STEPS)
            start = time.perf_counter()
            on_cpu = cpu_model.infer(rows, noise_stream=(x_t, steps))
            cpu_s = time.perf_counter() - start
            err, rel = differences(card, on_cpu)
            rec["card_vs_cpu"].update(sampler_max_abs=err, sampler_rel_l2=rel)
            ok &= err <= ZOO_CARD_VS_CPU_TOL[0] and rel <= ZOO_CARD_VS_CPU_TOL[1]
            sampler = (f"max|d| {err:.3e}, rel L2 {rel:.3e} (limits {ZOO_CARD_VS_CPU_TOL}), the "
                       f"CPU's {STEPS} steps {cpu_s:.1f} s")
        log(f"    {ZOO_CPU_ROWS} rows, float32, TF32 off, card vs CPU: one forward max|d| "
            f"{fwd_err:.3e} (limit {CARD_VS_CPU_TOL}), rel L2 {fwd_rel:.3e}; {STEPS} sampler steps "
            f"under one noise stream: {sampler} {'ok' if ok else 'OVER'}; the card's sampler "
            f"again: same bits {torch.equal(card, again)}; with x_T one ulp up: max|d| "
            f"{sensitivity[0]:.3e}, rel L2 {sensitivity[1]:.3e}")
        if not ok:
            fail(f"{name}: the card differs from the CPU: {rec['card_vs_cpu']}")
        record[name] = rec
        del enh, net, cpu_net
    return record


def zoo_serving_phase(work: Path, audios, device) -> dict:
    """Phase 40: UNetTST, UNetSP, CAUNet and TSTNN through
    :func:`serving_phase` at ancestral-12 of their T = 1000 schedules (UNetSP
    the flagship's T = 100); the samplers of UNetTST and UNetSP held against
    the CPU's."""
    return serving_phase("[40]", work, audios, device,
                         {n: (ZOO_CONFIGS[n], zoo_config(n)) for n in ZOO_CONFIGS}, ZOO_SITES,
                         {n for n in ZOO_SITES if ZOO_SITES[n]},
                         {n for n in ZOO_SITES if ZOO_SITES[n]})


def train_step_phase_of(tag: str, name: str, config: dict, sites: int, rows: int,
                        device) -> dict:
    """Phases 41 (a) and 44 (a): one train step of ``name`` on the card
    (float32, the config's; ``rows`` rows, the config's AMSGrad, seeded
    weights, batch and draws, cuDNN's deterministic algorithms), the kernel
    path against the same step with both GroupNorm directions plain, at
    [24]'s ``TRAIN_TOL["float32"]``, and against itself; ``sites`` forward
    and backward calls, and the backward kernels the profiler counts in one
    more step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.cli import build_arch, build_loss, build_network, build_optimizer
    from sddm_tpu_torch.models import blocks
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_backward_reference,
        gn_silu_reference,
    )
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step
    from sddm_tpu_torch.utils.profiling import profiled

    target, condition, diffusion, draws, gen = train_batch(config, device, rows)
    nets = [build_network(config, num_samples=config["num_samples"], role="train").to(device)
            for _ in range(3)]
    init_parameters(nets[0], torch.Generator().manual_seed(SEED))
    for net in nets[1:]:
        net.load_state_dict(nets[0].state_dict())
    steps = []
    for net in nets:
        optimizer = build_optimizer(config, net)
        steps.append(make_train_step(build_arch(config, diffusion, net), build_loss(config),
                                     optimizer))
    # the comparison takes cuDNN's deterministic algorithms, so that it reads the
    # GroupNorm kernels' difference alone
    with cudnn_deterministic():
        gn_silu.launches = gn_silu_backward.launches = 0
        loss_k = steps[0](target, condition, draws=draws)
        torch.cuda.synchronize()
        launches = (gn_silu.launches, gn_silu_backward.launches)
        with routed(blocks, "gn_silu", gn_silu_reference), \
                routed(blocks, "gn_silu_backward", gn_silu_backward_reference):
            loss_p = steps[1](target, condition, draws=draws)
        torch.cuda.synchronize()
        plain_launches = (gn_silu.launches, gn_silu_backward.launches)
        steps[2](target, condition, draws=draws)  # the kernel path again: the floor
        torch.cuda.synchronize()
    if launches != (sites, sites) or plain_launches != launches:
        fail(f"one {name} train step launched gn_silu / gn_silu_backward {launches} times "
             f"({plain_launches} after the plain step), expected {sites} each")
    lr = config["optimizer"]["args"]["lr"]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(nets[0], nets[1], lr)
    floor = compare_steps(nets[0], nets[2], lr)
    tol = TRAIN_TOL["float32"]
    readings = (loss_rel, grad_rel, worst_rel, apart)
    ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
    log(f"{tag} (a) one {name} train step, float32, batch {rows} x "
        f"{config['num_samples']}: kernel path vs both GroupNorm directions plain, same weights, "
        f"batch and draws: loss {float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_rel:.2e}, "
        f"tol {tol[0]}); gradients rel L2 {grad_rel:.2e} (tol {tol[1]}), worst parameter "
        f"{worst_name} {worst_rel:.2e} (tol {tol[2]}); parameters after the step max|d| "
        f"{dmax:.2e} (<= 2 lr), share apart by > lr/2 {apart:.2e} (tol {tol[3]}) "
        f"{'ok' if ok else 'OVER'}; launches {launches[0]} gn_silu_nchw + {launches[1]} "
        f"backward calls (cuDNN's deterministic algorithms)")
    log(f"    the kernel path run twice: gradients rel L2 {floor[0]:.2e}, worst parameter "
        f"{floor[1][0]:.2e}, share apart {floor[2]:.2e}")
    if not ok:
        fail(f"the {name} kernel-path train step differs from the plain path: {readings}")
    start = time.perf_counter()
    for _ in range(3):
        steps[0](target, condition, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) / 3 * 1e3
    device_seen = []
    for margin, _ in profiler_windows():  # a window that saw no backward kernel is taken again
        gn_silu_backward.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, margin_s=margin) as prof:
            steps[0](target, condition, gen)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        device_seen += events
        bwd_kernels = sum(e.count for e in events if BWD_KERNEL in e.key)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if bwd_kernels:
            break
    blind = not profiler_saw(device_seen, f"{tag}'s profiled {name} train step")
    log(f"    profiled step: {bwd_kernels} {BWD_KERNEL}* kernels for "
        f"{gn_silu_backward.launches} calls; device busy {busy_ms:.2f} ms; a step "
        f"{step_ms:.1f} ms (mean of 3)")
    if gn_silu_backward.launches != sites or \
            (not blind and bwd_kernels != sites * BWD_LAUNCHES_PER_CALL):
        fail(f"the profiled {name} step ran {bwd_kernels} backward kernels for "
             f"{gn_silu_backward.launches} calls, expected {sites}")
    return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst_rel,
            "worst_param": worst_name, "updates_apart_share": apart, "param_max_abs_diff": dmax,
            "tol": list(tol), "kernel_repeat": {"grad_rel_l2": floor[0],
                                                "worst_param_grad_rel_l2": floor[1][0],
                                                "updates_apart_share": floor[2]},
            "launches": {"gn_silu_nchw": launches[0],
                         "gn_silu_backward": launches[1],
                         "backward_kernels": bwd_kernels},
            "rows": rows, "step_ms_mean": step_ms, "device_busy_ms": busy_ms}


def zoo_train_step_phase(device) -> dict:
    """Phase 41 (a): one UNetTST train step at batch 16 (:func:`train_step_phase_of`)."""
    return train_step_phase_of("[41]", "UNetTST", zoo_config("UNetTST"), ZOO_SITES["UNetTST"],
                               BATCH_ROWS, device)


def linked_subset(src: Path, dst: Path, n: int) -> Path:
    """The first ``n`` WAV files of a ``clean``/``noisy`` split (not the
    spectrograms [26] writes beside them), linked under ``dst`` (once: a
    later call finds them there)."""
    if dst.is_dir():
        return dst
    for side in ("clean", "noisy"):
        (dst / side).mkdir(parents=True)
        for f in sorted((src / side).glob("*.wav"))[:n]:
            (dst / side / f.name).symlink_to(f)
    return dst


def training_cli_phase(tag: str, work: Path, configs: dict, sites: dict,
                       infer_name: str) -> dict:
    """Phases 41 (b)-(c) and 44 (b)-(c): ``python -m sddm_tpu_torch.train``
    (in this process) on each config of ``configs`` (``{name: (label,
    config)}``), the first ``ZOO_TRAIN_FILES`` files of [25]'s train split,
    ``ZOO_EPOCHS`` epochs from init with a ``ZOO_VALID_STEPS``-step
    validation on [20]'s test split at the last, then one epoch resumed from
    the checkpoint it wrote; the launches of both GroupNorm directions
    (``sites`` a forward); then ``python -m sddm_tpu_torch.infer -r`` on
    ``infer_name``'s checkpoint over the first ``ZOO_INFER_FILES`` test
    files."""
    from sddm_tpu_torch.train.checkpoints import CKPT_BEST, CKPT_CURRENT, load_checkpoint

    train_root = linked_subset(work / "train_split" / "train", work / "zoo_train",
                               ZOO_TRAIN_FILES)
    val_root = work / "synth" / "test"
    record = {}
    for name, (label, config) in configs.items():
        config = json.loads(json.dumps(config))
        config["name"] = f"zoo_{name}"
        for key, root in (("tr_dataset", train_root), ("val_dataset", val_root)):
            config[key]["args"]["data_root"] = str(root)
        config.setdefault("infer_dataset", {"type": "InferDataset",
                                            "args": {"datatype": ".wav"}})
        config["infer_dataset"]["args"]["data_root"] = str(val_root)
        config["trainer"].update(save_dir=str(work / "saved"), epochs=ZOO_EPOCHS,
                                 valid_period=ZOO_EPOCHS, valid_steps=ZOO_VALID_STEPS,
                                 n_valid_data_batch=1, save_period=1)
        path = work / f"zoo_{name}.json"
        path.write_text(json.dumps(config))
        a = run_train(["-c", str(path)])
        batch = config["data_loader"]["args"]["batch_size"]
        steps = ZOO_TRAIN_FILES // batch
        want = (sites[name] * (steps * ZOO_EPOCHS + ZOO_VALID_STEPS),
                sites[name] * steps * ZOO_EPOCHS)
        losses = [lg["loss"] for _, lg in a["logs"]]
        val = a["logs"][-1][1]
        config["trainer"]["epochs"] = ZOO_EPOCHS + 1
        config["name"] = f"zoo_{name}_resumed"  # a run dir of its own, whatever the second
        path.write_text(json.dumps(config))
        b = run_train(["-c", str(path), "-r", str(a["run"] / CKPT_CURRENT)])
        resumed = [(e, lg["loss"]) for e, lg in b["logs"]]
        count = int(load_checkpoint(b["run"] / CKPT_CURRENT, with_opt_state=True)
                    ["opt_state"]["0"]["count"])
        log(f"{tag} (b) python -m sddm_tpu_torch.train -c {label} (cut: "
            f"{ZOO_TRAIN_FILES} files, {ZOO_EPOCHS} epochs of {a['len_epoch']} steps at batch "
            f"{batch}, validation {ZOO_VALID_STEPS} steps on one batch): {a['network']}, epoch "
            f"losses {', '.join(f'{x:.5f}' for x in losses)}, val_loss "
            f"{val.get('val_loss', math.nan):.5f}; launches {a['launches']} (expected {want}); "
            f"{a['seconds']:.1f} s; resumed (-r {CKPT_CURRENT}): epochs "
            f"{', '.join(f'{e}: {x:.5f}' for e, x in resumed)}, optimizer count {count} "
            f"(expected {steps * (ZOO_EPOCHS + 1)}), {b['seconds']:.1f} s")
        if a["len_epoch"] != steps or not all(math.isfinite(x) for x in losses) or \
                "val_loss" not in val or tuple(a["launches"]) != want or \
                [e for e, _ in resumed] != [ZOO_EPOCHS + 1] or \
                not math.isfinite(resumed[0][1]) or count != steps * (ZOO_EPOCHS + 1) or \
                not (a["run"] / CKPT_BEST).is_file() or a["network"] != name:
            fail(f"{name} training CLI: {a['network']}, {a['len_epoch']} steps, losses {losses}, "
                 f"launches {a['launches']}, resumed {resumed}, count {count}")
        record[name] = {"epoch_losses": losses, "val_loss": val["val_loss"],
                        "launches": list(a["launches"]), "seconds": a["seconds"],
                        "resumed": dict(resumed), "resumed_launches": list(b["launches"]),
                        "count": count, "run": a["run"]}
    infer_root = linked_subset(val_root, work / "zoo_infer", ZOO_INFER_FILES)
    from sddm_tpu_torch.ops.gn_silu import gn_silu

    run = record[infer_name]["run"]
    config = json.loads((run / "config.json").read_text())
    config["name"] = f"zoo_{infer_name}_infer"
    config["infer_dataset"]["args"]["data_root"] = str(infer_root)
    path = work / f"zoo_{infer_name}_infer.json"
    path.write_text(json.dumps(config))
    gn_silu.launches = 0
    served = run_infer(["-r", str(run / CKPT_BEST), "-c", str(path), "--steps", str(STEPS)])
    wavs = sorted((served["samples"] / "output").glob("*.wav"))
    want = sites[infer_name] * STEPS * len(served["rows"])
    sisnr = served["result"]["sisnr"]
    log(f"    (c) python -m sddm_tpu_torch.infer -r <(b)'s {infer_name} {CKPT_BEST}> --steps "
        f"{STEPS} on {ZOO_INFER_FILES} test files: {type(served['network']).__name__}, "
        f"{len(wavs)} outputs, {sum(served['rows'])} rows in {len(served['rows'])} calls, "
        f"gn_silu launches {gn_silu.launches} (expected {want}); SI-SNR noisy "
        f"{sisnr['noisy']:.3f}, output {sisnr['output']:.3f} dB (not gated: {ZOO_EPOCHS + 1} "
        f"epochs on {ZOO_TRAIN_FILES} files); serve {served['serve_s']:.2f} s, scoring "
        f"{served['score_s']:.2f} s")
    if len(wavs) != ZOO_INFER_FILES or gn_silu.launches != want or \
            type(served["network"]).__name__ != infer_name:
        fail(f"infer on the trained {infer_name}: {len(wavs)} outputs, launches "
             f"{gn_silu.launches}")
    for rec in record.values():
        rec["run"] = str(rec["run"])
    record["infer"] = {"network": infer_name, "files": len(wavs), "launches": gn_silu.launches,
                       "serve_s": served["serve_s"], "sisnr": sisnr}
    return record


def zoo_training_cli_phase(work: Path) -> dict:
    """Phase 41 (b)-(c): UNetTST's, CAUNet's and TSTNN's shipped configs
    through :func:`training_cli_phase`, ``infer`` on UNetTST's checkpoint."""
    return training_cli_phase("[41]", work, {n: (ZOO_CONFIGS[n], zoo_config(n)) for n in
                                             ("UNetTST", "CAUNet", "TSTNN")}, ZOO_SITES, "UNetTST")


def zoo_phases(work: Path, audios, device, gen, sms) -> dict:
    """Phases 39-41, the two-stage-transformer family; [41] on [20]'s and
    [25]'s v1 splits."""
    sites = zoo_sites_phase(gen, sms)
    served = zoo_serving_phase(work, audios, device)
    step = zoo_train_step_phase(device)
    training = zoo_training_cli_phase(work)
    return {"sites": sites, "serve": served, "train_step": step, "training_cli": training}


def wave_config(name: str) -> dict:
    """The config of ``name`` for phases 42-44 (``WAVE_CONFIGS``): the shipped
    file; ``configs/config.json`` with a top-level ``num_samples`` and
    without its datasets' ``T`` (the copy the run writes to train from); the
    type swapped where the file names another network; UNetModified at its
    class defaults."""
    file, ns = WAVE_CONFIGS[name]
    config = json.loads((ROOT / "configs" / file).read_text())
    for key in ("tr_dataset", "val_dataset"):
        config[key]["args"].pop("T", None)
    if name == "UNetModified":
        config["network"]["args"] = {"dropout": 0}
    config["network"]["type"] = name
    config["num_samples"] = ns
    return config


def wave_sites_phase(gen, sms) -> dict:
    """Phase 42: both NCHW kernels against their plain versions at every
    distinct GroupNorm+SiLU site of Waveunet3 (config_waveunet3.json, 1-D
    sites as ``[B, C, T, 1]``; level 0's 2 groups: 1, 16 and 32 channels x
    16384 a run) at batch 4 and 16, and of UNetModified (its class defaults,
    75 sites) at batch 16, float32 and bfloat16, every call repeated bit for
    bit and its plan printed, at [3]'s and [23]'s limits; each site's time by
    CUDA events in float32 (the configs' dtype) beside the bound of its
    bytes at 3.35 TB/s, summed over a forward."""
    import torch

    from sddm_tpu_torch.cli import build_network
    from sddm_tpu_torch.ops.gn_silu import gn_silu, gn_silu_backward

    device = gen.device
    record = {}
    for name, batches in WAVE_SITE_BATCHES.items():
        config = wave_config(name)
        net = build_network(config, num_samples=config["num_samples"]).to(device).eval()
        sites = net_sites(net, config["num_samples"], device)
        del net
        if len(sites) != WAVE_SITES[name]:
            fail(f"{name} has {len(sites)} GroupNorm sites, expected {WAVE_SITES[name]}")
        distinct = sorted(set(sites), key=lambda s: -math.prod(s[0]))
        log(f"[42] {name} ({WAVE_CONFIGS[name][0]}): {len(sites)} GroupNorm+SiLU sites, "
            f"{len(distinct)} distinct (C, H, W), G; each at batch {batches}, forward at TOL "
            f"{TOL}, backward at {BWD_REL} x scale + rtol {BWD_RTOL}; time float32 by events "
            f"(20 calls) beside the bound (bytes at 3.35 TB/s)")
        worst = {"forward": {"float32": 0.0, "bfloat16": 0.0},
                 "backward": {"float32": 0.0, "bfloat16": 0.0}}
        per_forward = {}
        for b in batches:
            totals = [0.0, 0.0, 0.0, 0.0]  # kernel fwd, bound fwd, kernel bwd, bound bwd
            for chw, g in distinct:
                shape = (b,) + chw
                for dtype_name, ok, err, plan in check_nchw(shape, g, 1.0, gen, sms):
                    worst["forward"][dtype_name] = max(worst["forward"][dtype_name], err)
                    log(f"    fwd {str(shape):22s} G={g:<3d} {dtype_name:8s} max|d|={err:.3e} "
                        f"{'ok' if ok else 'OVER'}  {plan}")
                    if not ok:
                        fail(f"gn_silu disagrees with its plain version at {shape} {dtype_name}")
                for dtype_name, ok, errs, _, plan in check_backward(shape, g, gen):
                    worst["backward"][dtype_name] = max(worst["backward"][dtype_name],
                                                        *errs.values())
                    log(f"    bwd {str(shape):22s} G={g:<3d} {dtype_name:8s} "
                        f"{' '.join(f'{k} {v:.1e}' for k, v in errs.items())} of the scale "
                        f"{'ok' if ok else 'OVER'}  {nchw_plan_text(plan)}")
                    if not ok:
                        fail(f"gn_silu_backward disagrees with its plain backward at {shape} "
                             f"{dtype_name}: {errs}")
                x = torch.randn(shape, device=device, generator=gen)
                dy = torch.randn(shape, device=device, generator=gen)
                ones = torch.ones(chw[0], device=device)
                zeros = torch.zeros(chw[0], device=device)
                times = (cuda_time_ms(lambda: gn_silu(x, ones, zeros, g), 20),
                         gn_bound(x, 2 * chw[0] * 4)[0],
                         cuda_time_ms(lambda: gn_silu_backward(x, dy, ones, zeros, g), 20),
                         gn_bwd_bound(x)[0])
                n = sites.count((chw, g))
                totals = [t + n * v for t, v in zip(totals, times)]
                log(f"    time {str(shape):22s} G={g:<3d} float32: forward {times[0]:.4f} ms "
                    f"(bound {times[1]:.4f}), backward {times[2]:.4f} ms (bound {times[3]:.4f}); "
                    f"{n} a forward")
            per_forward[b] = dict(zip(("forward_ms", "forward_bound_ms", "backward_ms",
                                       "backward_bound_ms"), totals))
            log(f"    all {len(sites)} sites of one batch-{b} forward, float32: forward "
                f"{totals[0]:.3f} ms (bound {totals[1]:.4f}), backward {totals[2]:.3f} ms "
                f"(bound {totals[3]:.4f}), by events")
        record[name] = {"sites": len(sites), "distinct_sites": len(distinct), "worst": worst,
                        "per_forward": per_forward}
    return record


def wave_phases(work: Path, audios, device, gen, sms) -> dict:
    """Phases 42-44, the waveform networks of the zoo; [44] on [20]'s and
    [25]'s v1 splits, config.json's copy written to ``work``."""
    sites = wave_sites_phase(gen, sms)
    configs = {n: (WAVE_CONFIGS[n][0] + ("" if n in ("Waveunet", "Waveunet2", "Waveunet3")
                                          else f" as {n}, {WAVE_CONFIGS[n][1]} samples"),
                   wave_config(n)) for n in WAVE_CONFIGS}
    served = serving_phase("[43]", work, audios, device, configs, WAVE_SITES,
                           ("Waveunet", "Waveunet2", "Waveunet3", "UNetModified"),
                           ("UNetModified",))
    steps = {n: train_step_phase_of("[44]", n, configs[n][1], WAVE_SITES[n],
                                    configs[n][1]["data_loader"]["args"]["batch_size"], device)
             for n in ("Waveunet3", "UNetModified")}
    training = training_cli_phase("[44]", work, {n: configs[n] for n in WAVE_TRAINED},
                                  WAVE_SITES, "Waveunet3")
    return {"sites": sites, "serve": served, "train_step": steps, "training_cli": training}


# ---- the packed variable engines and the remaining transitions (phases 45-48) ----------
def variable_config() -> dict:
    """``configs/config_unet_snr_synth.json`` with ``"packed": true``."""
    return {**json.loads(SNR_CONFIG.read_text()), "packed": True}


def site_key(module, hwc) -> tuple:
    """What a packed GroupNorm site computes: its shape, groups, channel ->
    group map, count and offset mask."""
    return (hwc, module.groups, module.count, module.offset, tuple(module.group_of.tolist()))


def variable_sites_phase(config, net_args, gen, sms) -> dict:
    """Phase 45: the packed variable engine's GroupNorm sites (random weights,
    only to list them) against the flagship packed engine's, and both NHWC
    directions at each distinct site, batch 16 and [46]'s CLI batch 8,
    float32 and bfloat16, every call repeated bit for bit, at [3]'s ``TOL``
    and [30]'s ``BWD_REL`` / ``BWD_RTOL``."""
    import torch

    from sddm_tpu_torch.cli import build_network
    from sddm_tpu_torch.models import PackedUNetModified2, PackedUNetVariable, UNetModified2

    device = gen.device
    var_cfg = variable_config()
    seg_len, stride = var_cfg["segmentor"]["args"]["F"], var_cfg["segmentor"]["args"]["stride"]
    n_seg = (var_cfg["num_samples"] - seg_len) // stride + 1
    engine = PackedUNetVariable(build_network({**var_cfg, "dtype": "float32"}).to(device))
    z = torch.zeros(1, 1, n_seg, seg_len, device=device)
    sites = packed_sites(engine, 0, device,
                         (z, z, torch.full((1, 1, n_seg, 1), 0.5, device=device)))
    flagship = PackedUNetModified2(UNetModified2(num_samples=config["num_samples"],
                                                 **net_args).to(device))
    flagship_keys = {site_key(m, h) for m, h in packed_sites(flagship, config["num_samples"],
                                                             device)}
    del flagship
    keys = [site_key(m, h) for m, h in sites]
    n_offset = sum(m.offset for m, _ in sites)
    distinct = list({k: (m, h) for k, (m, h) in zip(keys, sites)}.values())
    same = set(keys) == flagship_keys
    log(f"[45] the packed variable engine (PackedUNetVariable, {n_seg} segments of {seg_len}): "
        f"{len(sites)} GroupNorm+SiLU sites ({n_offset} offset), {len(distinct)} distinct; the "
        f"flagship packed engine's set of sites: {'the same' if same else 'NOT the same'} "
        f"({len(flagship_keys)} distinct there); both NHWC directions at each distinct site, "
        f"batch {BATCH_ROWS} and {EST_BATCH}: forward at TOL {TOL}, backward at {BWD_REL} x "
        f"scale + rtol {BWD_RTOL}")
    if (len(sites), n_offset) != (PACKED_SITES, OFFSET_SITES):
        fail(f"[45] expected {PACKED_SITES} packed GroupNorm sites ({OFFSET_SITES} offset), "
             f"found {len(sites)} ({n_offset})")
    worst = {"forward": {"float32": 0.0, "bfloat16": 0.0},
             "backward": {"float32": 0.0, "bfloat16": 0.0}}
    for rows in (BATCH_ROWS, EST_BATCH):
        for m, hwc in distinct:
            shape = (rows,) + hwc
            fwd = check_nhwc(shape, m.groups, m.group_of, m.count, m.offset, 1.0, gen, sms)
            bwd = check_nhwc_backward(shape, m.groups, m.group_of, m.count, m.offset, 1.0, gen)
            for dtype_name, ok, err, _plan in fwd:
                worst["forward"][dtype_name] = max(worst["forward"][dtype_name], err)
                if not ok:
                    fail(f"[45] gn_silu_nhwc disagrees with its plain version at {shape} "
                         f"{dtype_name}: {err}")
            for dtype_name, ok, errs, _max_abs, _plan in bwd:
                worst["backward"][dtype_name] = max(worst["backward"][dtype_name],
                                                    *errs.values())
                if not ok:
                    fail(f"[45] gn_silu_nhwc_backward disagrees with its plain backward at "
                         f"{shape} {dtype_name}: {errs}")
            plan, plan_b = fwd[-1][3], bwd[-1][4]
            log(f"    {str(shape):20s} G={m.groups:<3d} count={m.count:<3d} "
                f"{'offset' if m.offset else 'plain ':6s} fwd max|d| f32 {fwd[0][2]:.2e} bf16 "
                f"{fwd[1][2]:.2e}; bwd of the scale f32 {max(bwd[0][2].values()):.2e} bf16 "
                f"{max(bwd[1][2].values()):.2e} ok; nhwc_plan grid {plan.grid} smem {plan.smem}; "
                f"{nhwc_bwd_plan_text(plan_b)}")
    log("    every call repeated bit for bit")
    return {"sites": len(sites), "offset_sites": n_offset, "distinct": len(distinct),
            "same_as_flagship": same, "worst": worst}


def packed_joint_train_step_phase(device, plain_step: dict) -> dict:
    """Phase 46 (a): one packed joint train step (``SDDM_PACKED_TRAIN=1``'s
    ``PackedTrainUNetVariable``, bf16, batch 16, the committed estimator
    frozen, [36]'s seeded init, batch and draws): the kernel path against both
    NHWC directions plain under the same draws and tables, bf16 and f32, at
    ``TRAIN_TOL``; in f32 (TF32 off) the twin against the plain variable
    network at ``TWIN_VS_PLAIN_F32_TOL``; 33 + 33 NHWC and 7 NCHW calls a step
    and the profiler's kernel counts; the median of ``TRAIN_TIMED_STEPS``
    steps, peak memory, device busy and idle beside [36]'s."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch.cli import build_network, build_optimizer, build_snr_composite
    from sddm_tpu_torch.models import PackedTrainUNetVariable, UNetModified2_VariableNoiseLevel
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

    config = variable_config()
    est, seg, _ = committed_estimator(device, config)
    target, condition, draws, gen = joint_batch(config, device)
    with env_set("SDDM_PACKED_TRAIN", "1"):
        twins = [build_network(config, device=device, role="train").to(device) for _ in range(2)]
    if any(type(t) is not PackedTrainUNetVariable for t in twins):
        fail(f"SDDM_PACKED_TRAIN=1 built {type(twins[0]).__name__}")
    init_parameters(twins[0], torch.Generator().manual_seed(SEED))  # [36]'s weights
    initial = {k: v.clone() for k, v in twins[0].net.state_dict().items()}
    lr = config["optimizer"]["args"]["lr"]
    record, failures, captured = {}, [], []

    def fresh(dtype, network):
        plain_network(network).load_state_dict(initial)
        plain_network(network).dtype = dtype
        model = build_snr_composite(config, network, est, seg)
        return model, make_train_step(model, l1_loss, build_optimizer(config, network, est))

    def counts():
        return (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches, gn_silu.launches,
                gn_silu_backward.launches)

    want = (PACKED_SITES, PACKED_SITES, EST_SITES, 0)
    kernel_f32 = None
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        (model_k, step_k), (model_p, step_p) = fresh(dtype, twins[0]), fresh(dtype, twins[1])
        tables = model_k.tables

        def capture(cs):
            captured.append(tables(cs))
            return captured[-1]

        gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = 0
        gn_silu.launches = gn_silu_backward.launches = 0
        with routed(model_k, "tables", capture):
            loss_k = step_k(target, condition, draws=draws)
        torch.cuda.synchronize()
        launches = counts()
        if launches != want:
            fail(f"[46] one {dtype_name} packed joint step launched gn_silu_nhwc / its backward "
                 f"/ gn_silu / its backward {launches} times, expected {want}")
        with routed(model_p, "tables", lambda cs: captured[0]), plain_nhwc_directions():
            loss_p = step_p(target, condition, draws=draws)
        torch.cuda.synchronize()
        if counts() != launches:
            fail("[46] the routed packed joint step launched a GroupNorm kernel")
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(twins[0], twins[1], lr)
        tol = TRAIN_TOL[dtype_name]
        readings = (loss_rel, grad_rel, worst_rel, apart)
        ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
        record[dtype_name] = {
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst_rel,
            "worst_param": worst_name, "updates_apart_share": apart, "param_max_abs_diff": dmax,
            "tol": list(tol), "launches": list(launches)}
        log(f"[46] one {dtype_name} packed joint train step (PackedTrainUNetVariable, "
            f"configs/config_unet_snr_synth.json with \"packed\": true, batch {BATCH_ROWS}, the "
            f"committed estimator frozen): kernel path vs both NHWC directions plain, same "
            f"weights, batch, draws (t = {draws[0]}) and tables: loss {float(loss_k):.6f} vs "
            f"{float(loss_p):.6f} (rel {loss_rel:.2e}, tol {tol[0]}); gradients rel L2 "
            f"{grad_rel:.2e} (tol {tol[1]}), worst {worst_name} {worst_rel:.2e} (tol {tol[2]}); "
            f"parameters max|d| {dmax:.2e}, share apart {apart:.2e} (tol {tol[3]}) "
            f"{'ok' if ok else 'OVER'}; launches {launches[0]} gn_silu_nhwc + {launches[1]} "
            f"gn_silu_nhwc_backward + {launches[2]} gn_silu (the estimator) calls")
        if not ok:
            failures.append(f"{dtype_name}: {readings}")
        if dtype == torch.float32:
            kernel_f32 = float(loss_k)
    # float32, TF32 off: the twin (its state from the loop's last turn) against
    # the plain variable network's step, the same weights, draws and tables
    plain = build_network({**config, "packed": False}, device=device, role="train").to(device)
    if type(plain) is not UNetModified2_VariableNoiseLevel:
        fail(f"[46] the plain network is {type(plain).__name__}")
    model_pl, step_pl = fresh(torch.float32, plain)
    with routed(model_pl, "tables", lambda cs: captured[-1]):
        loss_plain = step_pl(target, condition, draws=draws)
    torch.cuda.synchronize()
    loss_rel = abs(kernel_f32 - float(loss_plain)) / abs(float(loss_plain))
    grad_rel, (worst_rel, worst_name), apart, _ = compare_steps(twins[0].net, plain, lr)
    readings = (loss_rel, grad_rel, worst_rel, apart)
    ok = all(r <= t for r, t in zip(readings, TWIN_VS_PLAIN_F32_TOL))
    record["twin_vs_plain_f32"] = {"loss_twin": kernel_f32, "loss_plain": float(loss_plain),
                                   "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                                   "worst_param_grad_rel_l2": worst_rel, "worst_param": worst_name,
                                   "updates_apart_share": apart,
                                   "tol": list(TWIN_VS_PLAIN_F32_TOL)}
    log(f"    float32, TF32 off: the packed twin vs the plain variable network (NCHW kernels), "
        f"same weights, batch, draws and tables: loss rel {loss_rel:.2e}, gradients rel L2 "
        f"{grad_rel:.2e}, worst {worst_name} {worst_rel:.2e}, share apart {apart:.2e} (tol "
        f"{TWIN_VS_PLAIN_F32_TOL}) {'ok' if ok else 'OVER'}")
    if not ok:
        failures.append(f"twin vs plain f32: {readings}")
    if failures:
        fail(f"[46] the packed joint train step differs: {failures}")
    del plain, twins[1]

    _, step = fresh(torch.bfloat16, twins[0])
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
    device_seen = []
    for margin, _ in profiler_windows():  # a window that saw no kernel of ours is taken again
        gn_silu_nhwc.launches = gn_silu_nhwc_backward.launches = gn_silu.launches = 0
        with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, margin_s=margin) as prof:
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - start) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not is_annotation(e)]
        device_seen += events
        busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events}
        fwd_kernels = sum(v[1] for k, v in busy.items() if NHWC_KERNEL in k)
        bwd_kernels = sum(v[1] for k, v in busy.items() if NHWC_BWD_KERNEL in k)
        nchw_kernels = sum(v[1] for k, v in busy.items() if is_nchw_kernel(k))
        if fwd_kernels and bwd_kernels:
            break
    blind = not profiler_saw(device_seen, "[46]'s profiled packed joint train step")
    calls = (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches, gn_silu.launches)
    busy_ms = sum(v[0] for v in busy.values())
    log(f"    profiled step: {fwd_kernels} {NHWC_KERNEL}, {bwd_kernels} {NHWC_BWD_KERNEL}* and "
        f"{nchw_kernels} gn_silu_nchw kernels on the device for {calls[0]} gn_silu_nhwc, "
        f"{calls[1]} gn_silu_nhwc_backward and {calls[2]} gn_silu calls")
    if calls != (PACKED_SITES, PACKED_SITES, EST_SITES) or not blind and (
            fwd_kernels != PACKED_SITES or
            bwd_kernels != PACKED_SITES * NHWC_BWD_LAUNCHES_PER_CALL):
        fail(f"[46] the profiled packed joint step ran {fwd_kernels} forward and {bwd_kernels} "
             f"backward NHWC kernels for {calls} calls")
    p36 = plain_step.get("profile", {})
    record.update({"launches": {"gn_silu_nhwc": calls[0], "gn_silu_nhwc_backward": calls[1],
                                "gn_silu_nchw": calls[2], "forward_kernels": fwd_kernels,
                                "backward_kernels": bwd_kernels, "nchw_kernels": nchw_kernels},
                   "step_ms_median": step_ms, "step_ms_min": min(times) * 1e3,
                   "step_ms_max": max(times) * 1e3, "peak_bytes": peak,
                   "profile": {"wall_ms": prof_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1 - busy_ms / step_ms if busy_ms else None}})
    log(f"    bf16 packed joint step: median {step_ms:.2f} ms over {TRAIN_TIMED_STEPS} (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), peak {peak / 2**20:.1f} MiB; "
        f"[36]'s plain joint step: median {plain_step['step_ms_median']:.2f} ms, peak "
        f"{plain_step['peak_bytes'] / 2**20:.1f} MiB, device busy "
        f"{p36.get('device_busy_ms') or 0:.2f} ms, idle share {p36.get('idle_share') or 0:.3f}")
    if busy_ms > 0:
        log(f"    profiled packed joint step: device busy {busy_ms:.2f} ms, idle share "
            f"{1 - busy_ms / step_ms:.3f} of the median step ({1 - busy_ms / prof_ms:.3f} of the "
            f"profiled wall, {prof_ms:.1f} ms); {sum(v[1] for v in busy.values())} kernels")
        for name, (ms, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.3f} x{count:<5d} {name[:90]}")
    else:
        log("    the profiler saw no device time: breakdown not measured")
    return record


def packed_joint_training_cli_phase(work: Path, plain_run: Path) -> dict:
    """Phase 46 (b): ``SDDM_PACKED_TRAIN=1 python -m
    sddm_tpu_torch.train_with_snr_estimator -s model_best.ckpt --bs 8`` on a
    ``"packed": true`` config, from init on [35]'s files as [37]: 2 epochs of
    25 steps with a full-T validation at the last, the second epoch's loss
    within ``JOINT_LOSS``, the launches of both NHWC directions, and the
    checkpoint in [37]'s plain names and shapes (``plain_run``'s)."""
    from sddm_tpu_torch import train_with_snr_estimator
    from sddm_tpu_torch.train.checkpoints import CKPT_BEST, CKPT_CURRENT, load_checkpoint

    t_steps = json.loads(SNR_CONFIG.read_text())["diffusion"]["args"]["n_timestep"]
    path = snr_config(work, "snr_joint_packed", SNR_CONFIG, top={"packed": True},
                      epochs=SNR_EPOCHS, valid_period=SNR_EPOCHS, save_period=1)
    with env_set("SDDM_PACKED_TRAIN", "1"):
        r = run_snr_cli(train_with_snr_estimator,
                        ["-c", str(path), "-s", str(SNR_RUN / "model_best.ckpt"),
                         "--bs", str(EST_BATCH)])
    network = type(r["trainer"].model.network).__name__
    steps = r["trainer"].len_epoch
    losses = [lg["loss"] for _, lg in r["logs"]]
    val = r["logs"][-1][1]
    want_nhwc = (SNR_EPOCHS * steps * PACKED_SITES + PACKED_SITES * t_steps,
                 SNR_EPOCHS * steps * PACKED_SITES)
    want_nchw = (SNR_EPOCHS * steps * EST_SITES + EST_SITES, 0)
    written = [n for n in (CKPT_CURRENT, CKPT_BEST) if (r["run"] / n).is_file()]
    same_tree = tree_paths(load_checkpoint(r["run"] / CKPT_CURRENT)["params"]) == \
        tree_paths(load_checkpoint(plain_run / CKPT_CURRENT)["params"])
    inside = JOINT_LOSS[0] <= losses[-1] <= JOINT_LOSS[1]
    log(f"    SDDM_PACKED_TRAIN=1 python -m sddm_tpu_torch.train_with_snr_estimator -s "
        f"artifacts/round5/snr_estimator/model_best.ckpt --bs {EST_BATCH} on a \"packed\": true "
        f"config, from init on {SNR_FILES} v2 train files ({steps} steps an epoch, bf16): network "
        f"{network}; epoch losses {', '.join(f'{x:.4f}' for x in losses)} (epoch {SNR_EPOCHS} "
        f"band {JOINT_LOSS}) {'ok' if inside else 'OVER'}; full-T validation val_loss "
        f"{val.get('val_loss', math.nan):.4f}; launches gn_silu_nhwc, its backward "
        f"{r['nhwc_launches']} (expected {want_nhwc}), gn_silu, its backward {r['launches']} "
        f"(expected {want_nchw}); wrote {written}; [37]'s parameter names and shapes: "
        f"{same_tree}; wall {r['seconds']:.1f} s")
    if network != "PackedTrainUNetVariable" or not all(math.isfinite(x) for x in losses) or \
            not inside or tuple(r["nhwc_launches"]) != want_nhwc or \
            tuple(r["launches"]) != want_nchw or written != [CKPT_CURRENT, CKPT_BEST] or \
            not same_tree:
        fail(f"[46] the packed joint training CLI: network {network}, losses {losses}, "
             f"launches {r['nhwc_launches']} {r['launches']}, wrote {written}, plain tree "
             f"{same_tree}")
    return {"network": network, "epoch_losses": losses, "band": list(JOINT_LOSS),
            "val_loss": val.get("val_loss"), "nhwc_launches": list(r["nhwc_launches"]),
            "launches": list(r["launches"]), "seconds": r["seconds"], "run": r["run"]}


def first_step_conditioning(model, rows, device) -> float:
    """The least std / |mean| over the rows and groups of every GroupNorm site
    of the packed engine's forward at a sampler's first step on ``rows`` (its
    x_T drawn from a seeded generator): how near-constant a group gets, where
    the one-pass variance of the statistics loses digits.  The forward runs
    eager: a replay of the engine's CUDA graph calls no module's hooks."""
    import torch

    from sddm_tpu_torch.ops.gn_silu import _divisor, _nhwc_moments

    engine, worst = model.network, [math.inf]
    sched = model.diffusion.to(device)

    def hook(module, args):
        x = args[0]
        _, h, w, _ = x.shape
        _, mean, var = _nhwc_moments(x, module.group_of, module.groups,
                                     _divisor(h, w, module.count, module.offset))
        ratio = var.clamp_min(0).sqrt() / mean.abs().clamp_min(1e-30)
        worst[0] = min(worst[0], float(ratio.min()))

    hooks = [m.register_forward_pre_hook(hook) for m in engine.gns.values()]
    try:
        with torch.no_grad(), routed(engine, "replays_graphs", False):
            x_t = model._x_T(sched, rows, torch.Generator(device=device).manual_seed(SEED))
            level = sched.sqrt_alpha_bar[model.num_timesteps] * torch.ones(
                (rows.shape[0], 1, 1), device=device)
            engine(rows, x_t, level)
    finally:
        for h in hooks:
            h.remove()
    return worst[0]


def transitions_phase(config, net_args, audios, device) -> dict:
    """Phase 48: the flagship's epoch-250 checkpoint through
    ``load_enhancer(steps=12)`` (the packed engine, bf16) under ``sr3``,
    ``supportive``, ``conditional`` and the conditional-q ``with_ddim()``:
    the four requests served finite, each forward replayed from the packed
    engine's CUDA graph (``graphed_launches_hold``);
    in float32 (TF32 off) each step's network output kernel vs plain
    (``ZOO_E2E_TOL``; printed for ``STEPWISE_PRINTED`` beside the first
    forward's worst std / |mean|) and 12 steps on two rows under one noise
    stream, card against the CPU (``ZOO_CARD_VS_CPU_TOL``); then one bf16
    train step of
    the plain flagship under the conditional q process, the kernel path
    against both NCHW directions plain at ``TRAIN_TOL``."""
    import numpy as np
    import torch

    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.cli import build_arch, build_diffusion, build_network, build_optimizer
    from sddm_tpu_torch.diffusion import transitions
    from sddm_tpu_torch.enhance import load_network_weights
    from sddm_tpu_torch.models import PackedUNetModified2, UNetModified2, blocks
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_backward_reference,
        gn_silu_nhwc,
        gn_silu_reference,
    )
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step

    ckpt = RUN / "model_best.ckpt"
    ns = config["num_samples"]
    cpu_engine = PackedUNetModified2(load_network_weights(
        build_network(config, num_samples=ns), ckpt).eval()).eval()
    cpu_engine.net.dtype = torch.float32
    n_batches = math.ceil(sum(math.ceil(a.size / ns) for a in audios) / BATCH_ROWS)
    record = {}
    for name, (args, ddim) in TRANSITIONS.items():
        cfg = {**config, "arch": {"type": "SDDM", "args": args}}
        start = time.perf_counter()
        enh = load_enhancer(ckpt, cfg, batch_rows=BATCH_ROWS, steps=STEPS, ddim=ddim)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        model, engine = enh.model, enh.model.network
        want_p = "ddim_conditional" if ddim else args["p_transition"]
        if type(engine) is not PackedUNetModified2 or model.p_transition != want_p or \
                model.num_timesteps != STEPS or enh.engine_fallback is not None:
            fail(f"[48] {name}: load_enhancer served {type(engine).__name__}, "
                 f"{model.p_transition} at {model.num_timesteps} steps, fallback "
                 f"{enh.engine_fallback}")
        serve_requests(enh, audios, SEED + 1, device)  # cuDNN's autotuning, the allocator
        gn_silu_nhwc.launches = gn_silu.launches = engine.captures = engine.replays = 0
        served, serve_s = serve_requests(enh, audios, SEED, device)
        launches = (gn_silu_nhwc.launches, gn_silu.launches)
        graph = {"captures": engine.captures, "replays": engine.replays}
        finite = all(y.shape == a.shape and np.isfinite(y).all() for a, y in zip(audios, served))
        forwards = STEPS * n_batches
        want = (PACKED_SITES * (forwards - graph["replays"] + graph["captures"]), 0)
        graphed = graph["replays"] == forwards if device.type == "cuda" else True
        # float32, TF32 off: each step kernel vs plain, and the card against the CPU
        engine.net.dtype = torch.float32
        step_err, step_rel = stepwise_kernel_vs_plain(enh, audios, device, plain_gn_silu_nhwc)
        served_rows = np.concatenate([enh._chunk(a) for a in audios])[:BATCH_ROWS]
        conditioning = first_step_conditioning(model, torch.from_numpy(served_rows).to(device),
                                               device)
        step_gated = name not in STEPWISE_PRINTED
        gate = f"limit {ZOO_E2E_TOL}" if step_gated else "printed"
        rows = torch.from_numpy(enh._chunk(audios[0])[:ZOO_CPU_ROWS])
        rng = np.random.default_rng(SEED + 48)
        x_t = torch.from_numpy(rng.standard_normal(rows.shape).astype(np.float32))
        noise = torch.from_numpy(rng.standard_normal((STEPS,) + rows.shape).astype(np.float32))
        card = model.infer(rows.to(device), noise_stream=(x_t.to(device), noise.to(device))).cpu()
        cpu_model = build_arch(cfg, build_diffusion(cfg), cpu_engine)
        cpu_model = (cpu_model.with_ddim() if ddim else cpu_model).with_sampling_steps(STEPS)
        start = time.perf_counter()
        on_cpu = cpu_model.infer(rows, noise_stream=(x_t, noise))
        cpu_s = time.perf_counter() - start
        err, rel = differences(card, on_cpu)
        ok = finite and launches == want and graphed and \
            (step_rel <= ZOO_E2E_TOL or not step_gated) and \
            err <= ZOO_CARD_VS_CPU_TOL[0] and rel <= ZOO_CARD_VS_CPU_TOL[1]
        record[name] = {"p_transition": model.p_transition, "q_transition": model.q_transition,
                        "load_s": load_s, "serve_s": serve_s, "launches": list(launches),
                        "graph": graph, "step_max_abs": step_err, "step_rel_l2": step_rel,
                        "step_gated": step_gated, "first_step_min_std_to_mean": conditioning,
                        "card_vs_cpu_max_abs": err, "card_vs_cpu_rel_l2": rel,
                        "cpu_sampler_s": cpu_s}
        log(f"[48] {name} ({model.p_transition}, q {model.q_transition}): load_enhancer(steps="
            f"{STEPS}{', ddim=True' if ddim else ''}) on the flagship's epoch-250 checkpoint "
            f"{load_s:.2f} s, {type(engine).__name__}; {len(audios)} requests in {n_batches} "
            f"batch at bf16: serve {serve_s:.3f} s, finite and shaped {finite}, wrapper calls "
            f"gn_silu_nhwc, gn_silu {launches} (expected {want}: {forwards} forwards, CUDA "
            f"graph {graph}); float32, TF32 off: each of the "
            f"{STEPS} steps' network output, kernel vs plain on the same input, max|d| "
            f"{step_err:.3e}, worst rel L2 {step_rel:.3e} ({gate}; the first forward's "
            f"GroupNorm groups down to std / |mean| {conditioning:.2e}); {ZOO_CPU_ROWS} "
            f"rows, {STEPS} steps under one noise stream, card vs CPU max|d| {err:.3e}, rel L2 "
            f"{rel:.3e} (limits {ZOO_CARD_VS_CPU_TOL}; the CPU's {cpu_s:.1f} s) "
            f"{'ok' if ok else 'OVER'}")
        if not ok:
            fail(f"[48] {name}: {record[name]}")
        del enh, model, engine

    # one bf16 train step of the plain flagship under the conditional q process
    cfg = {**config, "arch": {"type": "SDDM", "args": TRANSITIONS["conditional"][0]}}
    target, condition, diffusion, draws, _ = train_batch(config, device)
    draws = (draws[0], draws[2])  # q_stochastic_conditional's (t, eps)
    nets = [UNetModified2(num_samples=ns, **net_args).to(device) for _ in range(2)]
    init_parameters(nets[0], torch.Generator().manual_seed(SEED))
    initial = {k: v.clone() for k, v in nets[0].state_dict().items()}
    steps, q_calls = [], []
    for net in nets:
        net.load_state_dict(initial)
        net.dtype = torch.bfloat16
        steps.append(make_train_step(build_arch(cfg, diffusion, net), l1_loss,
                                     build_optimizer(cfg, net)))
    kept_q = transitions.q_stochastic_conditional

    def counted(*args, **kwargs):
        q_calls.append(1)
        return kept_q(*args, **kwargs)

    gn_silu.launches = gn_silu_backward.launches = 0
    with routed(transitions, "q_stochastic_conditional", counted):
        loss_k = steps[0](target, condition, draws=draws)
        torch.cuda.synchronize()
        launches = (gn_silu.launches, gn_silu_backward.launches)
        with routed(blocks, "gn_silu", gn_silu_reference), \
                routed(blocks, "gn_silu_backward", gn_silu_backward_reference):
            loss_p = steps[1](target, condition, draws=draws)
        torch.cuda.synchronize()
    lr = config["optimizer"]["args"]["lr"]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(nets[0], nets[1], lr)
    tol = TRAIN_TOL["bfloat16"]
    readings = (loss_rel, grad_rel, worst_rel, apart)
    ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001 and \
        launches == (SITES_PER_FORWARD, SITES_PER_FORWARD) and len(q_calls) == 2
    record["conditional_train_step"] = {
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
        "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst_rel, "worst_param": worst_name,
        "updates_apart_share": apart, "param_max_abs_diff": dmax, "tol": list(tol),
        "launches": {"gn_silu_nchw": launches[0], "gn_silu_backward": launches[1]}}
    log(f"    one bf16 train step of the plain flagship (batch {BATCH_ROWS}) under the conditional "
        f"q process ({len(q_calls)} q_stochastic_conditional calls): kernel path vs both NCHW "
        f"directions plain, [24]'s weights and batch, (t, eps) draws: loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f} (rel {loss_rel:.2e}, tol {tol[0]}); gradients rel L2 "
        f"{grad_rel:.2e} (tol {tol[1]}), worst {worst_name} {worst_rel:.2e} (tol {tol[2]}); "
        f"parameters max|d| {dmax:.2e}, share apart {apart:.2e} (tol {tol[3]}); launches "
        f"{launches[0]} gn_silu + {launches[1]} backward {'ok' if ok else 'OVER'}")
    if not ok:
        fail(f"[48] the conditional-q train step: {readings}, launches {launches}, "
             f"{len(q_calls)} q calls")
    return record


def variable_phases(work: Path, smi: str, config, net_args, audios, device, gen, sms,
                    snr: dict, joint_run: Path) -> dict:
    """Phases 45-48: the packed variable engines on the SNR path (on [26]'s v2
    corpus and [37]'s checkpoint for names) and the remaining transitions on
    the flagship."""
    sites = variable_sites_phase(config, net_args, gen, sms)
    step = packed_joint_train_step_phase(device, snr["joint_train_step"])
    cli = packed_joint_training_cli_phase(work, joint_run)
    served = joint_infer_phase(work, cli.pop("run"), smi, tag="[47]", files=VAR_SERVE_FILES,
                               packed=True)
    return {"sites": sites, "packed_joint_train_step": step, "packed_joint_training_cli": cli,
            "packed_joint_infer": served,
            "transitions": transitions_phase(config, net_args, audios, device)}

def launch_counts(text: str):
    """The (gn_silu, gn_silu_backward) launches a training command logged at
    its end, or None."""
    import re

    found = re.findall(r"kernel launches: gn_silu (\d+), gn_silu_backward (\d+)", text)
    return tuple(int(n) for n in found[-1]) if found else None


def torchrun_phase(work: Path, val_root: Path) -> dict:
    """Phase 49: ``python -m sddm_tpu_torch.train`` and ``torchrun --standalone
    --nproc_per_node=1 -m sddm_tpu_torch.train`` on [25]'s flagship config and
    400 files, ``TORCHRUN_EPOCHS`` from init, cuDNN deterministic, each its own
    process, both at once on the card: the two checkpoints' parameters and
    optimizer states bit for bit, 33 + 33 launches a step in each (the count
    the command logs)."""
    import numpy as np

    from sddm_tpu_torch.train.checkpoints import CKPT_CURRENT, load_checkpoint

    train_root = work / "train_split" / "train"
    steps = math.ceil(TRAIN_FILES / BATCH_ROWS) * TORCHRUN_EPOCHS
    launchers = {"cli": [sys.executable, "-m", "sddm_tpu_torch.train"],
                 "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node=1", "-m", "sddm_tpu_torch.train"]}
    def run(name):
        launcher = launchers[name]
        path = train_config(work, f"launch_{name}", train_root, val_root,
                            epochs=TORCHRUN_EPOCHS, valid_period=10**6, save_period=1,
                            tensorboard=False, deterministic=True)
        start = time.perf_counter()
        proc = subprocess.run([*launcher, "-c", str(path), *TRAIN_DEVICE_ARGS], cwd=str(ROOT),
                              capture_output=True, text=True, timeout=TORCHRUN_TIMEOUT)
        return proc, time.perf_counter() - start

    # the two commands at once, each in its own process on the card
    with concurrent.futures.ThreadPoolExecutor(len(launchers)) as pool:
        done = {name: pool.submit(run, name) for name in launchers}
        done = {name: f.result() for name, f in done.items()}
    runs = {}
    for name, (proc, seconds) in done.items():
        if proc.returncode != 0:
            fail(f"[49] {' '.join(launchers[name][1:])} exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
        (run_dir,) = (work / "saved" / f"launch_{name}").iterdir()
        info = run_dir / "info.log"
        info = info.read_text() if info.is_file() else ""
        ckpt = load_checkpoint(run_dir / CKPT_CURRENT, with_opt_state=True)
        runs[name] = {"seconds": seconds, "ckpt": ckpt,
                      "launches": launch_counts(info + proc.stdout + proc.stderr)}
    flat = {name: dict(tree_items(r["ckpt"]["params"], ("params",))
                       + tree_items(r["ckpt"]["opt_state"], ("opt_state",)))
            for name, r in runs.items()}
    def raw(a):
        return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)

    differ = [k for k in flat["cli"] if k not in flat["torchrun"]
              or not np.array_equal(raw(flat["cli"][k]), raw(flat["torchrun"][k]))]
    differ += [k for k in flat["torchrun"] if k not in flat["cli"]]
    want = (SITES_PER_FORWARD * steps, SITES_PER_FORWARD * steps)
    count = int(flat["cli"][("opt_state", "0", "count")])
    log(f"[49] python -m sddm_tpu_torch.train vs torchrun --standalone --nproc_per_node=1 -m "
        f"sddm_tpu_torch.train (NCCL, DDP at one rank), [25]'s config and {TRAIN_FILES} files, "
        f"{TORCHRUN_EPOCHS} epoch ({steps} steps) from init, cuDNN deterministic: "
        f"{len(flat['cli'])} leaves of params and opt_state, {len(differ)} differ (limit 0); "
        f"optimizer count {count}; launches (gn_silu, backward) {runs['cli']['launches']} / "
        f"{runs['torchrun']['launches']} (expected {want}: {SITES_PER_FORWARD} + "
        f"{SITES_PER_FORWARD} a step); wall "
        f"{runs['cli']['seconds']:.1f} / {runs['torchrun']['seconds']:.1f} s")
    if differ or count != steps:
        fail(f"[49] the torchrun checkpoint differs from the plain command's at {differ[:8]} "
             f"(count {count})")
    for name, r in runs.items():
        if r["launches"] != want:
            fail(f"[49] {name}: launches {r['launches']}, expected {want}")
    return {"steps": steps, "leaves": len(flat["cli"]), "differ": len(differ),
            "launches": {n: list(r["launches"]) for n, r in runs.items()},
            "seconds": {n: r["seconds"] for n, r in runs.items()}}


def tree_items(tree, path=()):
    """The (path, leaf) pairs of a nested dict of arrays."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += tree_items(v, path + (k,))
        else:
            out.append((path + (k,), v))
    return out


def gloo_ddp_phase(config, net_args, work: Path, device) -> dict:
    """Phase 50: one train step of the flagship over ``DDP_RANKS`` gloo ranks
    sharing the card (``python -m sddm_tpu_torch.parallel.dryrun --step``,
    DDP, 8 rows a rank) from [24]'s seeded weights, batch and draws, float32
    with TF32 off, against the single-process batch-16 step in this process:
    loss, gradients, parameters after the step at ``TRAIN_TOL["float32"]``;
    both GroupNorm directions launched 33 times on each rank."""
    import numpy as np
    import torch

    from sddm_tpu_torch.cli import build_arch, build_optimizer
    from sddm_tpu_torch.models import UNetModified2
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.parallel.dryrun import step_parity
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step

    ns = config["num_samples"]
    target, condition, diffusion, draws, _ = train_batch(config, device)
    net = UNetModified2(num_samples=ns, **net_args)
    init_parameters(net, torch.Generator().manual_seed(SEED))  # [24]'s weights
    weights = {f"w/{k}": v.numpy() for k, v in net.state_dict().items()}
    inputs = work / "ddp_inputs.npz"
    np.savez(inputs, config=json.dumps(dict(config, dtype="float32")),
             target=target.cpu().numpy(), condition=condition.cpu().numpy(), steps=1,
             **{f"{k}_0": d.cpu().numpy() for k, d in zip(("t", "frac", "eps"), draws)},
             **weights)
    net = net.to(device)
    net.dtype = torch.float32
    optimizer = build_optimizer(config, net)
    loss = float(make_train_step(build_arch(config, diffusion, net), l1_loss, optimizer)(
        target, condition, draws=draws))
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = step_parity(inputs, work / "ddp_out", DDP_RANKS, (1,), device=DDP_DEVICE,
                      backend="gloo", timeout=DDP_TIMEOUT)[1]
    seconds = time.perf_counter() - start
    got, ranks = out["arrays"], out["ranks"]
    lr = config["optimizer"]["args"]["lr"]
    g_all = torch.cat([p.grad.flatten().cpu() for p in net.parameters()])
    d_all = torch.cat([torch.from_numpy(got[f"grad/{n}"]).flatten() - p.grad.flatten().cpu()
                       for n, p in net.named_parameters()])
    grad_rel = float(d_all.norm() / g_all.norm())
    rms = float(g_all.norm()) / math.sqrt(g_all.numel())
    worst, apart, n_el, dmax = (0.0, ""), 0, 0, 0.0
    for name, p in net.named_parameters():
        g = p.grad.cpu()
        denom = max(float(g.norm()), rms * math.sqrt(g.numel()))
        worst = max(worst, (float((torch.from_numpy(got[f"grad/{name}"]) - g).norm()) / denom,
                            name))
        d = (torch.from_numpy(got[f"param/{name}"]) - p.detach().cpu()).abs()
        dmax = max(dmax, float(d.max()))
        apart += int((d > lr / 2).sum())
        n_el += d.numel()
    loss_rel = abs(float(got["losses"][0]) - loss) / abs(loss)
    readings = (loss_rel, grad_rel, worst[0], apart / n_el)
    tol = TRAIN_TOL["float32"]
    ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
    launches = [r["launches"] for r in ranks]
    log(f"[50] one float32 step over {DDP_RANKS} gloo ranks on the one card (DDP, "
        f"{[r['rows'] for r in ranks]} rows, backend {ranks[0]['backend']}) vs the "
        f"single-process batch-{target.shape[0]} step, [24]'s weights, batch and draws: loss "
        f"{float(got['losses'][0]):.7f} vs {loss:.7f} (rel {loss_rel:.2e}, tol {tol[0]}); "
        f"gradients rel L2 {grad_rel:.2e} (tol {tol[1]}), worst {worst[1]} {worst[0]:.2e} (tol "
        f"{tol[2]}); parameters max|d| {dmax:.2e} (<= 2 lr), share apart by > lr/2 "
        f"{apart / n_el:.2e} (tol {tol[3]}) {'ok' if ok else 'OVER'}; launches (gn_silu, "
        f"backward) by rank {launches}; {seconds:.1f} s")
    if not ok:
        fail(f"[50] the two-rank step differs from the single-process step: {readings}")
    if launches != [[SITES_PER_FORWARD, SITES_PER_FORWARD]] * DDP_RANKS:
        fail(f"[50] launches by rank {launches}, expected {SITES_PER_FORWARD} + "
             f"{SITES_PER_FORWARD} on each")
    return {"loss": float(got["losses"][0]), "loss_single": loss, "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst[0],
            "worst_param": worst[1], "updates_apart_share": apart / n_el,
            "param_max_abs_diff": dmax, "tol": list(tol), "launches": launches,
            "rows": [r["rows"] for r in ranks], "backend": ranks[0]["backend"],
            "seconds": seconds}


def readers_phase(work: Path, val_root: Path, smi: str) -> dict:
    """Phase 51: ``trainer.model_parallel: 2`` on the one card refused in the
    JAX package's words; the native WAV reader built and in use; one epoch of
    [25]'s 400 files through the flagship's loader (batch 16 of 16448, its
    workers; the streaming path, as ``configs/config_unet.json`` sets no RAM
    cache) read by the native reader, by scipy's memory map, and decoded
    whole as before this reader (the crop cut after), the same batches from
    each; the seconds of each, warm page cache."""
    import numpy as np

    from sddm_tpu_torch import native
    from sddm_tpu_torch.data import DATA_LOADERS, DATASETS, wav_io

    train_root = work / "train_split" / "train"
    path = train_config(work, "model_parallel_2", train_root, val_root, model_parallel=2)
    try:
        run_train(["-c", str(path), *TRAIN_DEVICE_ARGS])
    except ValueError as e:
        refusal = str(e)
    else:
        refusal = None
    if refusal != MP_REFUSAL:
        fail(f"[51] model_parallel 2 on one card: {refusal!r}, expected {MP_REFUSAL!r}")
    start = time.perf_counter()
    library = native.build()
    in_use = wav_io.reader()
    if not native.available() or in_use != "native":
        fail(f"[51] the native reader is not in use: {in_use}, {native.load_error()}")
    config = json.loads(path.read_text())
    args = {k: v for k, v in config["tr_dataset"]["args"].items() if k != "cache"}

    def epoch(mode):
        ds = DATASETS[config["tr_dataset"]["type"]](
            **args, sample_rate=config["sample_rate"], T=config["num_samples"])
        ds.pushdown = mode != "whole"
        loader = DATA_LOADERS[config["data_loader"]["type"]](ds, **config["data_loader"]["args"])
        with (routed(wav_io, "reader", lambda: "scipy") if mode == "scipy"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            batches = list(loader)
            return time.perf_counter() - t0, batches

    seconds, first = {}, None
    for mode in ("native", "scipy", "whole", "native_again"):
        seconds[mode], batches = epoch(mode.replace("_again", ""))
        if first is None:
            first = batches
        elif len(batches) != len(first) or not all(
                np.array_equal(a, b) for x, y in zip(batches, first) for a, b in zip(x, y)):
            fail(f"[51] the {mode} reader's batches differ from the native reader's")
    log(f"[51] model_parallel 2 on one card refused: {refusal!r}; native reader "
        f"{library.name} built and in use ({time.perf_counter() - start:.2f} s with its build "
        f"or cache); one epoch of {TRAIN_FILES} files, {len(first)} batches of "
        f"{config['data_loader']['args']['batch_size']} x {config['num_samples']}, "
        f"{config['data_loader']['args'].get('num_workers')} workers, warm page cache: native "
        f"{seconds['native']:.3f} / {seconds['native_again']:.3f} s, scipy memory map "
        f"{seconds['scipy']:.3f} s, whole files decoded {seconds['whole']:.3f} s; the same "
        f"batches by each; {smi}")
    return {"refusal": refusal, "reader": in_use, "epoch_seconds": seconds,
            "batches": len(first), "nvidia_smi": smi}


def dropout_config(work: Path, name: str, rate: float = DROPOUT, train_root: Path = None,
                   val_root: Path = None) -> Path:
    """``configs/config_unet.json`` with ``dropout`` ``rate`` in bf16 (the
    flagship recipe's compute), written under ``work``; with ``train_root``
    its datasets on [25]'s roots through the RAM cache, one epoch, no
    validation, no TensorBoard, its run dir under ``work``."""
    config = json.loads((ROOT / "configs" / "config_unet.json").read_text())
    config["name"] = name
    config["dtype"] = "bfloat16"
    config["network"]["args"]["dropout"] = rate
    if train_root is not None:
        for block, root in (("tr_dataset", train_root), ("val_dataset", val_root),
                            ("infer_dataset", val_root)):
            config[block]["args"]["data_root"] = str(root)
        for block in ("tr_dataset", "val_dataset"):
            config[block]["args"]["cache"] = "ram"
        config["trainer"].update(save_dir=str(work / "saved"), epochs=1, valid_period=25,
                                 save_period=1, tensorboard=False)
    path = work / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def kept_shares(masks, keep: float):
    """Each mask's kept share and its distance from ``keep`` in standard
    deviations of a Bernoulli(keep) mean over its elements."""
    out = []
    for m in masks:
        share = float(m.float().mean())
        out.append((share, abs(share - keep) / math.sqrt(keep * (1 - keep) / m.numel())))
    return out


def dropout_phase(work: Path, val_root: Path, audios, device) -> dict:
    """Phase 52: dropout 0.1 in training.  (a) one bf16 flagship step at [24]'s
    batch and draws, the masks drawn from a generator on the card, against the
    same step with both NCHW directions plain under those masks; the kept share
    of each site; the median step against the same weights at dropout 0; (b) the
    committed estimator's float32 step the same way; (c) the four requests
    served from the dropout config against dropout 0; (d) ``python -m
    sddm_tpu_torch.train`` for one epoch of [25]'s files at dropout 0.1."""
    import numpy as np
    import torch

    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.cli import (
        build_arch,
        build_loss,
        build_network,
        build_optimizer,
        build_segmentor,
        build_snr_estimator,
    )
    from sddm_tpu_torch.compat import network_state_dict_from_jax
    from sddm_tpu_torch.models import blocks
    from sddm_tpu_torch.models.dropout import DropoutMasks
    from sddm_tpu_torch.models.losses import l1_loss
    from sddm_tpu_torch.ops.gn_silu import (
        gn_silu,
        gn_silu_backward,
        gn_silu_backward_reference,
        gn_silu_reference,
    )
    from sddm_tpu_torch.train.checkpoints import load_checkpoint
    from sddm_tpu_torch.train.snr_trainer import make_snr_train_step
    from sddm_tpu_torch.train.trainer import init_parameters, make_train_step

    phase_start = time.perf_counter()
    keep = 1 - DROPOUT
    record, failures = {}, []

    def kernel_vs_plain(tag, step_k, step_p, net_k, net_p, gen, lr, tol, sites, n_masks, args):
        """The kernel step with masks drawn from ``gen``, the plain step under
        the same masks; the readings against ``tol``."""
        gn_silu.launches = gn_silu_backward.launches = 0
        drawn = DropoutMasks(gen)
        loss_k = step_k(*args, dropout=drawn)
        torch.cuda.synchronize()
        launches = (gn_silu.launches, gn_silu_backward.launches)
        with routed(blocks, "gn_silu", gn_silu_reference), \
                routed(blocks, "gn_silu_backward", gn_silu_backward_reference):
            loss_p = step_p(*args, dropout=DropoutMasks(masks=drawn.drawn))
        torch.cuda.synchronize()
        if (gn_silu.launches, gn_silu_backward.launches) != launches:
            failures.append(f"{tag}: the plain step launched a GroupNorm kernel")
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        grad_rel, (worst_rel, worst_name), apart, dmax = compare_steps(net_k, net_p, lr)
        readings = (loss_rel, grad_rel, worst_rel, apart)
        ok = all(r <= t for r, t in zip(readings, tol)) and dmax <= 2 * lr * 1.001
        shares = kept_shares(drawn.drawn, keep)
        worst_sigma = max((s for _, s in shares), default=math.inf)
        log(f"    {tag}: loss {float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_rel:.2e}, tol "
            f"{tol[0]}); gradients rel L2 {grad_rel:.2e} (tol {tol[1]}), worst parameter "
            f"{worst_name} {worst_rel:.2e} (tol {tol[2]}); parameters after the step max|d| "
            f"{dmax:.2e} (<= 2 lr), share apart {apart:.2e} (tol {tol[3]}) "
            f"{'ok' if ok else 'OVER'}; launches {launches[0]} + {launches[1]} (expected "
            f"{sites} + {sites}); {len(drawn.drawn)} masks (expected {n_masks}), kept shares "
            f"{min(s for s, _ in shares):.5f}-{max(s for s, _ in shares):.5f}, at most "
            f"{worst_sigma:.2f} sigma from {keep} (limit {DROPOUT_SIGMAS})")
        if not ok:
            failures.append(f"{tag}: kernel vs plain {readings}, max|d| {dmax}")
        if launches != (sites, sites):
            failures.append(f"{tag}: launches {launches}, expected {sites} + {sites}")
        if len(drawn.drawn) != n_masks or worst_sigma > DROPOUT_SIGMAS:
            failures.append(f"{tag}: {len(drawn.drawn)} masks, kept shares {shares}")
        return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
                "grad_rel_l2": grad_rel, "worst_param_grad_rel_l2": worst_rel,
                "worst_param": worst_name, "updates_apart_share": apart,
                "param_max_abs_diff": dmax, "tol": list(tol), "launches": list(launches),
                "masks": len(drawn.drawn), "kept_shares": [s for s, _ in shares],
                "worst_sigma": worst_sigma}

    # (a) the flagship's bf16 step at dropout 0.1
    path = dropout_config(work, "dropout_step")
    config = json.loads(path.read_text())
    ns, lr = config["num_samples"], config["optimizer"]["args"]["lr"]
    target, condition, diffusion, draws, _ = train_batch(config, device)
    nets = [build_network(config, num_samples=ns, device=device, role="train").to(device).train()
            for _ in range(2)]
    init_parameters(nets[0], torch.Generator().manual_seed(SEED))
    initial = {k: v.clone() for k, v in nets[0].state_dict().items()}
    steps = []
    for net in nets:
        net.load_state_dict(initial)
        optimizer = build_optimizer(config, net)
        steps.append(make_train_step(build_arch(config, diffusion, net), l1_loss, optimizer))
    log(f"[52] dropout {DROPOUT} in training: configs/config_unet.json's copy in bf16, "
        f"{nets[0].dropout} at {sum(m.rate > 0 for m in nets[0].modules() if hasattr(m, 'rate'))} "
        f"sites")
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    record["train_step"] = kernel_vs_plain(
        f"(a) one bf16 flagship step, batch {BATCH_ROWS} x {ns}", steps[0], steps[1], nets[0],
        nets[1], gen, lr, TRAIN_TOL["bfloat16"], SITES_PER_FORWARD, DROPOUT_SITES,
        (target, condition, None, draws))

    # the median step at dropout 0.1 beside the same weights at dropout 0, in turns
    net0 = build_network(dict(config, network={**config["network"], "args": {
        **config["network"]["args"], "dropout": 0}}), num_samples=ns, role="train").to(device)
    net0.load_state_dict(initial)
    step0 = make_train_step(build_arch(config, diffusion, net0), l1_loss,
                            build_optimizer(config, net0))
    timed = {"dropout": (steps[0], []), "no_dropout": (step0, [])}
    for _ in range(3):
        for step, _times in timed.values():
            step(target, condition, gen)
    torch.cuda.synchronize()
    for _ in range(DROPOUT_TIMED_STEPS):
        for step, times in timed.values():
            start = time.perf_counter()
            step(target, condition, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
    medians = {k: float(np.median(t)) * 1e3 for k, (_, t) in timed.items()}
    record["step_ms_median"] = medians
    log(f"    bf16 step median over {DROPOUT_TIMED_STEPS}, in turns: dropout {DROPOUT} "
        f"{medians['dropout']:.2f} ms, dropout 0 {medians['no_dropout']:.2f} ms")
    del nets, steps, net0, step0, timed

    # (b) the committed estimator's float32 step at dropout 0.1
    est_cfg = json.loads((SNR_RUN / "config.json").read_text())
    est_cfg["arch"]["args"]["dropout"] = DROPOUT
    seg = build_segmentor(est_cfg)
    params = load_checkpoint(SNR_RUN / "model_best.ckpt")["params"]
    ests, est_steps = [], []
    for _ in range(2):
        est = build_snr_estimator(est_cfg, seg, block="arch")
        est.load_state_dict(network_state_dict_from_jax(est, params))
        est = est.to(device).train()
        ests.append(est)
        est_steps.append(make_snr_train_step(est, seg, build_loss(est_cfg),
                                             build_optimizer(est_cfg, est)))
    clean = clips(EST_BATCH, SNR_NUM_SAMPLES)
    noisy = clean + 0.05 * np.random.default_rng(SEED + 6).standard_normal(clean.shape)
    pcm = [torch.from_numpy(np.clip(np.round(a * 32768), -32768, 32767).astype(np.int16))
           .to(device) for a in (clean, noisy)]  # the estimator's loader's int16 PCM
    record["estimator_step"] = kernel_vs_plain(
        f"(b) the committed estimator's float32 step, batch {EST_BATCH}", est_steps[0],
        est_steps[1], ests[0], ests[1], gen, est_cfg["optimizer"]["args"]["lr"],
        TRAIN_TOL["float32"], EST_SITES, DROPOUT_EST_SITES, (pcm[0], pcm[1], None))
    del ests, est_steps

    # (c) served from the dropout config: eval mode, so dropout 0's outputs bit for bit
    outs, served = {}, {}
    for name, rate in (("dropout", DROPOUT), ("no_dropout", 0.0)):
        cfg = json.loads(dropout_config(work, f"serve_{name}", rate).read_text())
        enh = load_enhancer(RUN / "model_best.ckpt", cfg, batch_rows=BATCH_ROWS, steps=STEPS,
                            packed=False)
        gn_silu.launches = 0
        outs[name], seconds = serve_requests(enh, audios, SEED, device)
        served[name] = {"network": type(enh.model.network).__name__,
                        "dropout": enh.model.network.dropout,
                        "training": enh.model.network.training,
                        "launches": gn_silu.launches, "seconds": seconds}
        del enh
    equal = all(np.array_equal(a, b) for a, b in zip(outs["dropout"], outs["no_dropout"]))
    finite = all(np.isfinite(y).all() and y.shape == a.shape
                 for a, y in zip(audios, outs["dropout"]))
    record["serve"] = dict(served, bit_equal=equal)
    log(f"    (c) the four requests served (load_enhancer, ancestral-{STEPS}) from the dropout "
        f"config: {served['dropout']['network']} at dropout {served['dropout']['dropout']}, "
        f"training {served['dropout']['training']}, {served['dropout']['launches']} launches; "
        f"bit for bit as at dropout 0: {equal}; finite: {finite}")
    if not (equal and finite) or served["dropout"]["training"] or \
            served["dropout"]["launches"] != served["no_dropout"]["launches"]:
        failures.append(f"(c) served: equal {equal}, finite {finite}, {served}")

    # (d) python -m sddm_tpu_torch.train, one epoch of [25]'s files at dropout 0.1
    path = dropout_config(work, "train_dropout", DROPOUT, work / "train_split" / "train",
                          val_root)
    draws_seen = []
    mask_fn = DropoutMasks.mask

    def counted(self, x, keep_):
        draws_seen.append(1)
        return mask_fn(self, x, keep_)

    with routed(DropoutMasks, "mask", counted):
        run = run_train(["-c", str(path)] + TRAIN_DEVICE_ARGS)
    losses = [log_["loss"] for _, log_ in run["logs"]]
    n_steps = math.ceil(TRAIN_FILES / BATCH_ROWS)
    want = (n_steps * SITES_PER_FORWARD, n_steps * SITES_PER_FORWARD)
    ok = (run["len_epoch"] == n_steps and losses and all(math.isfinite(x) for x in losses)
          and run["launches"] == want and len(draws_seen) == n_steps * DROPOUT_SITES)
    record["training_cli"] = {"epoch_losses": losses, "steps": run["len_epoch"],
                              "launches": list(run["launches"]), "masks": len(draws_seen),
                              "seconds": run["seconds"], "network": run["network"]}
    log(f"    (d) python -m sddm_tpu_torch.train -c <dropout {DROPOUT}, {TRAIN_FILES} files, 1 "
        f"epoch>: {run['len_epoch']} steps, epoch loss {', '.join(f'{x:.5f}' for x in losses)}; "
        f"launches {run['launches'][0]} + {run['launches'][1]} (expected {want[0]} + {want[1]}); "
        f"{len(draws_seen)} masks drawn (expected {n_steps * DROPOUT_SITES}); wall "
        f"{run['seconds']:.1f} s {'ok' if ok else 'OVER'}")
    if not ok:
        failures.append(f"(d) the training CLI: {record['training_cli']}")
    record["seconds"] = time.perf_counter() - phase_start
    log(f"    phase 52: {record['seconds']:.1f} s")
    if failures:
        fail(f"[52] {failures}")
    return record


def serve_mesh_phase(work: Path, audios, device) -> dict:
    """Phase 53: the flagship's epoch-250 checkpoint served through
    ``load_enhancer`` (packed engine, ancestral-12) over a data mesh, against
    the same serves in this process from the same generator seed: (a)
    ``MESH_RANKS`` gloo ranks sharing the card (``python -m
    sddm_tpu_torch.parallel.dryrun --serve``), float32 and bf16; (b)
    ``torchrun --standalone --nproc_per_node=1`` (NCCL), bf16, bit for bit;
    (c) ``Enhancer.warmup``'s seconds, then a serve built with a
    ``warmup_timeout_s`` well above them; (d) ``batch_rows`` the ranks do not
    divide, served whole on each rank."""
    import numpy as np

    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.parallel.dryrun import serve_inputs, serve_parity, serve_records

    phase_start = time.perf_counter()
    config = json.loads((RUN / "config.json").read_text())
    ckpt = RUN / "model_best.ckpt"
    f32 = {"dtype": "float32"}
    cases = [dict(name=name, checkpoint=str(ckpt), steps=STEPS, seed=SEED, **case)
             for name, case in (("float32", dict(batch_rows=BATCH_ROWS, config=f32)),
                                ("bfloat16", dict(batch_rows=BATCH_ROWS)),
                                ("nondividing", dict(batch_rows=MESH_ODD_ROWS, config=f32)))]
    gloo_in = serve_inputs(work / "mesh_gloo.npz", config, audios, cases)
    nccl_in = serve_inputs(work / "mesh_nccl.npz", config, audios, cases[1:2])
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node=1", "-m", "sddm_tpu_torch.parallel.dryrun", "--serve",
                str(nccl_in), str(work / "mesh_nccl"), "--device", MESH_DEVICE]

    def timed(fn, *args, **kwargs):
        start = time.perf_counter()
        return fn(*args, **kwargs), time.perf_counter() - start

    # the two launches at once, each rank its own process on the card; one process meanwhile
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        gloo_f = pool.submit(timed, serve_parity, gloo_in, work / "mesh_gloo", MESH_RANKS,
                             device=MESH_DEVICE, backend=MESH_BACKEND, timeout=MESH_TIMEOUT)
        nccl_f = pool.submit(timed, subprocess.run, torchrun, cwd=str(ROOT), capture_output=True,
                             text=True, timeout=MESH_TIMEOUT)
        single = {}
        for case in cases:
            enh = load_enhancer(ckpt, {**config, **case.get("config", {})},
                                batch_rows=case["batch_rows"], steps=STEPS)
            single[case["name"]] = serve_requests(enh, audios, SEED, device)[0]
            del enh
        gloo, gloo_s = gloo_f.result()
        proc, nccl_s = nccl_f.result()
    n_rows = sum(math.ceil(a.size / config["num_samples"]) for a in audios)
    failures, record = [], {"gloo_seconds": gloo_s, "torchrun_seconds": nccl_s}

    def held(name, got, limit, rows, sharded):
        """Check one case's ranks against the single-process serve; its record."""
        ranks = got["ranks"]
        same = all(np.array_equal(a, b) for outs in got["outputs"][1:]
                   for a, b in zip(outs, got["outputs"][0]))
        bits = all(np.array_equal(a, b) for a, b in zip(got["outputs"][0], single[name]))
        err, rel = served_differences(got["outputs"][0], single[name])
        calls = math.ceil(n_rows / rows) if not sharded else math.ceil(n_rows / BATCH_ROWS)
        forwards = STEPS * calls
        launches = [r["launches"]["gn_silu_nhwc"] for r in ranks]
        graphs = [(r["graph_captures"], r["graph_replays"]) for r in ranks]
        on_card = MESH_DEVICE == "cuda"
        finite = all(np.isfinite(y).all() and y.shape == a.shape
                     for a, y in zip(audios, got["outputs"][0]))
        ok = (finite and same and (bits if limit is None else rel <= limit)
              and all(graphed_launches_hold(n, forwards, c, r) and (r > 0) == on_card
                      for n, (c, r) in zip(launches, graphs))
              and all(r["launches"]["gn_silu"] == 0 and r["engine"] == "PackedUNetModified2"
                      and r["engine_fallback"] is None and r["sharded"] == sharded
                      and r["rows"] == rows for r in ranks))
        log(f"    {name}: {[r['rows'] for r in ranks]} rows a call on {len(ranks)} rank(s) "
            f"({ranks[0]['backend']}, sharded {sharded}); every rank the same bits: {same}; "
            f"against one process: bit for bit {bits}, max|d| {err:.3e}, rel L2 {rel:.3e} "
            f"(limit {'bit for bit' if limit is None else limit}); {forwards} forwards a "
            f"rank, gn_silu_nhwc wrapper calls by rank {launches}, CUDA graph (captures, "
            f"replays) by rank {graphs}; engines {[r['engine'] for r in ranks]}, "
            f"fallback {[r['engine_fallback'] for r in ranks]}; serve "
            f"{[round(r['seconds'], 3) for r in ranks]} s {'ok' if ok else 'OVER'}")
        if not ok:
            failures.append(f"{name}: same {same}, bits {bits}, rel {rel}, launches {launches}, "
                            f"graphs {graphs}, finite {finite}, ranks {ranks}")
        return {"max_abs": err, "rel_l2": rel, "bit_equal": bits, "ranks_equal": same,
                "launches": launches, "graphs": graphs, "rows": [r["rows"] for r in ranks],
                "seconds": [r["seconds"] for r in ranks]}

    log(f"[53] the flagship (packed engine, ancestral-{STEPS}, {len(audios)} requests, {n_rows} "
        f"rows) served over a data mesh against one process from seed {SEED}:")
    log(f"    (a) {MESH_RANKS} {MESH_BACKEND or 'NCCL'} ranks "
        f"{'sharing the card' if MESH_BACKEND else 'on a card each'} ({gloo_s:.1f} s for the "
        f"launch):")
    for name, limit in (("float32", MESH_F32_REL), ("bfloat16", MESH_BF16_REL)):
        record[name] = held(name, gloo[name], limit, BATCH_ROWS // MESH_RANKS, True)
    log(f"    (b) torchrun --standalone --nproc_per_node=1 (NCCL; {nccl_s:.1f} s):")
    if proc.returncode != 0:
        fail(f"[53] {' '.join(torchrun[2:])} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    nccl = serve_records(nccl_in, work / "mesh_nccl", 1)["bfloat16"]
    record["torchrun"] = held("bfloat16", nccl, None, BATCH_ROWS, False)
    if nccl["ranks"][0]["backend"] != "nccl":
        failures.append(f"(b) backend {nccl['ranks'][0]['backend']}")

    # (c) warmup's seconds, then a serve built under a limit well above them
    enh = load_enhancer(ckpt, config, batch_rows=BATCH_ROWS, steps=STEPS)
    warm_s = [enh.warmup(), enh.warmup()]
    limit_s = max(MESH_WARMUP_FLOOR, MESH_WARMUP_FACTOR * warm_s[0])
    start = time.perf_counter()
    enh = load_enhancer(ckpt, config, batch_rows=BATCH_ROWS, steps=STEPS, warmup=True,
                        warmup_timeout_s=limit_s)
    load_s = time.perf_counter() - start
    warmed = serve_requests(enh, audios, SEED, device)[0]
    del enh
    bits = all(np.array_equal(a, b) for a, b in zip(warmed, single["bfloat16"]))
    record["warmup"] = {"seconds": warm_s, "limit_s": limit_s, "load_s": load_s,
                        "bit_equal": bits}
    log(f"    (c) Enhancer.warmup(): {warm_s[0]:.3f} s, again {warm_s[1]:.3f} s; load_enhancer("
        f"warmup=True, warmup_timeout_s={limit_s:.1f}) returned in {load_s:.2f} s and served "
        f"the same bits as without it: {bits}")
    if not bits:
        failures.append("(c) the warmed-up serve differs")
    log(f"    (d) batch_rows {MESH_ODD_ROWS} over the {MESH_RANKS} ranks:")
    record["nondividing"] = held("nondividing", gloo["nondividing"], MESH_F32_REL,
                                 MESH_ODD_ROWS, False)
    record["seconds"] = time.perf_counter() - phase_start
    log(f"    phase 53: {record['seconds']:.1f} s")
    if failures:
        fail(f"[53] {failures}")
    return record


def denoiser_graph_phase(device) -> dict:
    """Phase 54: the packed denoiser's CUDA graph at the serving cells' row
    counts (``GRAPH_ROWS``): the graphed forward and ``SDDM.infer`` bit for
    bit against the eager ones, the wrapper's calls and the graph's replays,
    the profiler's view of a replayed call (and what a window of CUDA
    activity alone sees of it, eager and replayed), served calls in turns
    with and without the graph, and the memory the capture holds."""
    import collections

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sddm_tpu_torch import load_enhancer
    from sddm_tpu_torch.ops import gn_silu as gn_ops
    from sddm_tpu_torch.utils import profiling
    from sddm_tpu_torch.utils.profiling import profiled

    phase_start = time.perf_counter()
    config = json.loads((RUN / "config.json").read_text())
    n = config["num_samples"]
    audios = requests()
    n_rows = sum(math.ceil(a.size / n) for a in audios)
    record, failures = {}, []

    def drawn(seed, shape):
        g = torch.Generator(device=device).manual_seed(seed)
        return (0.1 * torch.randn(shape, device=device, generator=g),
                torch.randn(shape, device=device, generator=g),
                0.3 + 0.6 * torch.rand((shape[0], 1, 1), device=device, generator=g))

    for rows in GRAPH_ROWS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_reserved()
        start = time.perf_counter()
        enh = load_enhancer(RUN / "model_best.ckpt", config, batch_rows=rows, steps=STEPS)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        model, eng = enh.model, enh.model.network
        if type(eng).__name__ != "PackedUNetModified2" or len(eng._graphs) != 1:
            fail(f"[54] load_enhancer at {rows} rows served {type(eng).__name__} holding "
                 f"{len(getattr(eng, '_graphs', ()))} graphs after its canary, not one")
        held_gib = (torch.cuda.memory_reserved() - base) / 2**30
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        shape = (rows, 1, n)
        with torch.no_grad():
            forward_equal = []
            for k in range(3):
                args = drawn(SEED + k, shape)
                forward_equal.append(bool(torch.equal(
                    eng(*args), eng._forward_eager(*args, eng.prepare()))))

        def graph_equals_eager(run) -> bool:
            outs = []
            for graphed in (True, False):
                eng.replays_graphs = graphed
                outs.append(run())
            del eng.replays_graphs
            return bool(torch.equal(*outs))

        def seeded():
            return torch.Generator(device=device).manual_seed(SEED)

        cond = drawn(SEED + 7, shape)[0]
        stream_equal = graph_equals_eager(lambda: model.infer(
            cond, noise_stream=model.draw_noise_stream(shape, seeded(), device)))
        generator_equal = graph_equals_eager(lambda: model.infer(cond, seeded()))

        gn_ops.gn_silu_nhwc.launches = eng.captures = eng.replays = 0
        served, serve_s = serve_requests(enh, audios, SEED, device)
        launches, captures, replayed = gn_ops.gn_silu_nhwc.launches, eng.captures, eng.replays
        n_forwards = STEPS * math.ceil(n_rows / rows)
        want = PACKED_SITES * n_forwards
        finite = all(np.isfinite(y).all() and y.shape == a.shape for a, y in zip(audios, served))

        forwards = [0]
        hook = eng.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        seen, lead_seen, any_device, busy_ms = 0, 0, [], 0.0
        try:
            for margin, _ in profiler_windows():
                forwards[0] = 0
                with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA,
                              margin_s=margin) as prof:
                    lead_launches(device)
                    enh.enhance_batch(audios)
                    torch.cuda.synchronize()
                device_events = [e for e in prof.key_averages()
                                 if e.device_type == DeviceType.CUDA]
                any_device += device_events
                seen = sum(e.count for e in device_events if NHWC_KERNEL in e.key)
                lead_seen = sum(e.count for e in device_events if LEAD_KERNEL in e.key)
                busy_ms = sum(e.self_device_time_total for e in device_events
                              if LEAD_KERNEL not in e.key) / 1e3
                if seen:
                    break
                UNSEEN_WINDOWS.append(sorted((e.key[:60], e.count) for e in device_events))
        finally:
            hook.remove()
        profile_seen = profiler_saw(any_device, "[54]'s profiled call")

        # windows as a whole run once saw 395 of 396 in: CUDA activity alone, no lead
        # launches; the same call eager and from the graph in turns.  Each window
        # keeps (nhwc_gn_silu kernels, all device events, [(launch's place in the window,
        # its nhwc_gn_silu kernels)] for the launches that show fewer than most): a graph's
        # kernels share the correlation id of its launch
        cuda_only = {"eager": [], "graph": []}
        for side in ("eager", "graph") * 3:
            eng.replays_graphs = side == "graph"
            torch.cuda.synchronize()
            with profiled(ProfilerActivity.CUDA) as prof:
                enh.enhance_batch(audios)
            events = [e for e in prof.profiler.kineto_results.events()
                      if e.device_type().name == "CUDA"]
            gn = sorted((e for e in events if NHWC_KERNEL in e.name()),
                        key=lambda e: e.start_ns())
            by_launch = collections.Counter(e.correlation_id() for e in gn)
            order = list(dict.fromkeys(e.correlation_id() for e in gn))
            most = collections.Counter(by_launch.values()).most_common(1)
            short = [(i, by_launch[c]) for i, c in enumerate(order)
                     if most and by_launch[c] < most[0][0]]
            cuda_only[side].append((len(gn), len(events), short))
        del eng.replays_graphs

        turns = {"eager": [], "graph": []}
        for side in ("eager", "graph", "graph", "eager"):
            eng.replays_graphs = side == "graph"
            turns[side] += [serve_requests(enh, audios, SEED, device)[1]
                            for _ in range(GRAPH_TIMED_CALLS)]
        step_ms = {}
        for side in ("eager", "graph"):
            eng.replays_graphs = side == "graph"
            with profiling.recording() as spans:
                serve_requests(enh, audios, SEED, device)
            steps = [s.ms for s in spans if s.name == "sampler.step"]
            step_ms[side] = sum(steps) / len(steps)
            replays = sum(s.name == "denoiser.replay" for s in spans)
            if replays != (len(steps) if side == "graph" else 0):
                failures.append(f"{rows} rows, {side}: {replays} denoiser.replay spans in "
                                f"{len(steps)} steps")
        del eng.replays_graphs

        ok = (all(forward_equal) and stream_equal and generator_equal and finite
              and (launches, captures, replayed) == (0, 0, n_forwards)
              and (not profile_seen or (seen == want and forwards[0] == STEPS)))
        median = {k: float(np.median(v)) for k, v in turns.items()}
        log(f"[54] {rows} rows a call (bf16, ancestral-{STEPS}): load_enhancer {load_s:.2f} s "
            f"with the canary's capture, {held_gib:.3f} GiB more reserved, peak "
            f"{peak_gib:.3f} GiB; graphed forward == _forward_eager {forward_equal}; infer "
            f"under noise_stream bit for bit {stream_equal}, from a seeded generator "
            f"{generator_equal}; served {n_rows} rows: {replayed} of {n_forwards} forwards "
            f"replayed, {captures} captures, {launches} gn_silu_nhwc wrapper calls, finite "
            f"{finite}; profiled call: {seen} {NHWC_KERNEL} events (expected {want}), "
            f"{forwards[0]} forwards, device busy {busy_ms:.1f} ms, {lead_seen} of the window's "
            f"{LEAD_LAUNCHES} lead kernels seen {'ok' if ok else 'OVER'}")
        log(f"     windows of CUDA activity alone over the same call, eager and from the graph "
            f"in turns ({NHWC_KERNEL} kernels, all device events, [(place, kernels)] of the launches "
            f"short of most): eager {cuda_only['eager']}, graph "
            f"{cuda_only['graph']}")
        log(f"     served call in turns (eager, graph, graph, eager; {GRAPH_TIMED_CALLS} "
            f"calls each): eager median {median['eager'] * 1e3:.1f} ms, graph median "
            f"{median['graph'] * 1e3:.1f} ms ({median['eager'] / median['graph']:.3f}x); "
            f"sampler.step host wall eager {step_ms['eager']:.3f} ms, graph "
            f"{step_ms['graph']:.3f} ms")
        if not ok:
            failures.append(f"{rows} rows: forward {forward_equal}, stream {stream_equal}, "
                            f"generator {generator_equal}, wrapper calls {launches}, captures "
                            f"{captures}, replays {replayed} of {n_forwards}, finite {finite}, "
                            f"profiled {seen} kernels of {want}, {forwards[0]} forwards")
        record[str(rows)] = {
            "load_seconds": load_s, "graph_reserved_gib": held_gib, "peak_gib": peak_gib,
            "forward_bit_equal": forward_equal, "infer_stream_bit_equal": stream_equal,
            "infer_generator_bit_equal": generator_equal, "wrapper_calls": launches,
            "graph_captures": captures, "graph_replays": replayed,
            "profiled_kernels": seen, "profiled_forwards": forwards[0],
            "profiled_lead_kernels": lead_seen, "cuda_only_windows": cuda_only,
            "profiled_busy_ms": busy_ms, "serve_seconds": turns,
            "sampler_step_host_ms": step_ms}
        del enh, model, eng
    record["seconds"] = time.perf_counter() - phase_start
    log(f"    phase 54: {record['seconds']:.1f} s")
    if failures:
        fail(f"[54] {failures}")
    return record


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
            (d / "model_best.ckpt").is_file() for d in (RUN, VOCODER, SNR_RUN)):
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
        if seen is not None and not 1 <= seen <= 5:
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
        snr, joint_run = snr_phases(work, smi, device, gen, sms)
        zoo = zoo_phases(work, audios, device, gen, sms)
        wave = wave_phases(work, audios, device, gen, sms)
        var = variable_phases(work, smi, config, net_args, audios, device, gen, sms, snr,
                              joint_run)
        launched = torchrun_phase(work, work / "synth" / "test")
        ddp = gloo_ddp_phase(config, net_args, work, device)
        readers = readers_phase(work, work / "synth" / "test", smi)
        drop = dropout_phase(work, work / "synth" / "test", audios, device)
        mesh = serve_mesh_phase(work, audios, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    graph = denoiser_graph_phase(device)
    nhwc_bwd_record["launches"] = packed_step["launches"]["gn_silu_nhwc_backward"]
    nhwc_bwd_record["kernels_per_call"] = (packed_step["launches"]["backward_kernels"]
                                           / packed_step["launches"]["gn_silu_nhwc_backward"])
    nhwc_bwd_record["launches_training_cli"] = packed_cli["launches"][1]
    nhwc_record["launches_packed_train_step"] = packed_step["launches"]["gn_silu_nhwc"]
    nhwc_record["launches_packed_training_cli"] = packed_cli["launches"][0]
    dw_record["launches_vocoder_end_check"] = vocoder_cli["layer_launches"]
    dw_record["max_abs_err_vocoder_end_check"] = vocoder_cli["max_abs_err"]
    # served through the packed engine's CUDA graph: the wrapper's calls (eager forwards
    # and captures), the graph's captures and replays, and the kernels the profiler saw
    nhwc_record["wrapper_calls_file_to_score"] = f2s["nhwc_launches"]
    nhwc_record["graph_file_to_score"] = f2s["nhwc_graph"]
    nhwc_record["profiled_kernels_a_replay_file_to_score"] = f2s["replayed_kernels"]
    nhwc_record["wrapper_calls_serve_mesh_by_rank"] = mesh["bfloat16"]["launches"]
    nhwc_record["graph_serve_mesh_by_rank"] = mesh["bfloat16"]["graphs"]
    nhwc_record["wrapper_calls_serve_torchrun"] = mesh["torchrun"]["launches"][0]
    nhwc_record["graph_serve_torchrun"] = mesh["torchrun"]["graphs"][0]
    nhwc_record["profiled_kernels_graphed_serve"] = {k: v["profiled_kernels"]
                                                     for k, v in graph.items() if k != "seconds"}
    bwd_record["launches_training_cli"] = training["from_init"]["launches"][1]
    bwd_record["launches_snr_train_step"] = snr["joint_train_step"]["launches"]["gn_silu_backward"]
    bwd_record["launches_snr_estimator_cli"] = snr["estimator_cli"]["launches"][1]
    bwd_record["launches_snr_joint_cli"] = snr["joint_training_cli"]["launches"][1]
    bwd_record["launches_zoo_train_step"] = zoo["train_step"]["launches"]["gn_silu_backward"]
    bwd_record["launches_zoo_training_cli"] = zoo["training_cli"]["UNetTST"]["launches"][1]
    bwd_record["launches_wave_train_step"] = {
        n: r["launches"]["gn_silu_backward"] for n, r in wave["train_step"].items()}
    bwd_record["launches_wave_training_cli"] = wave["training_cli"]["Waveunet3"]["launches"][1]
    var_step = var["packed_joint_train_step"]["launches"]
    var_cli = var["packed_joint_training_cli"]
    nhwc_record["launches_variable_packed_train_step"] = var_step["gn_silu_nhwc"]
    nhwc_record["launches_variable_packed_training_cli"] = var_cli["nhwc_launches"][0]
    nhwc_record["launches_variable_packed_infer_cli"] = var["packed_joint_infer"]["launches"][1]
    nhwc_record["launches_transitions_serve"] = {
        n: r["launches"][0] for n, r in var["transitions"].items() if n in TRANSITIONS}
    nhwc_bwd_record["launches_variable_packed_train_step"] = var_step["gn_silu_nhwc_backward"]
    nhwc_bwd_record["launches_variable_packed_training_cli"] = var_cli["nhwc_launches"][1]
    cond_step = var["transitions"]["conditional_train_step"]["launches"]
    bwd_record["launches_conditional_train_step"] = cond_step["gn_silu_backward"]
    bwd_record["launches_torchrun_training_cli"] = launched["launches"]["torchrun"][1]
    bwd_record["launches_gloo_ddp_step_by_rank"] = [r[1] for r in ddp["launches"]]
    bwd_record["launches_dropout_train_step"] = drop["train_step"]["launches"][1]
    bwd_record["launches_dropout_estimator_step"] = drop["estimator_step"]["launches"][1]
    bwd_record["launches_dropout_training_cli"] = drop["training_cli"]["launches"][1]

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
        "launches_snr_train_step": snr["joint_train_step"]["launches"]["gn_silu_nchw"],
        "launches_snr_estimator_cli": snr["estimator_cli"]["launches"][0],
        "launches_snr_joint_cli": snr["joint_training_cli"]["launches"][0],
        "launches_snr_infer_cli": snr["joint_infer"]["launches"],
        "launches_zoo_serve": {n: r["launches"] for n, r in zoo["serve"].items()
                               if ZOO_SITES[n]},
        "launches_zoo_train_step": zoo["train_step"]["launches"]["gn_silu_nchw"],
        "launches_zoo_training_cli": zoo["training_cli"]["UNetTST"]["launches"][0],
        "launches_zoo_infer_cli": zoo["training_cli"]["infer"]["launches"],
        "launches_wave_serve": {n: r["launches"] for n, r in wave["serve"].items()
                                if WAVE_SITES[n]},
        "launches_wave_train_step": {n: r["launches"]["gn_silu_nchw"]
                                     for n, r in wave["train_step"].items()},
        "launches_wave_training_cli": wave["training_cli"]["Waveunet3"]["launches"][0],
        "launches_wave_infer_cli": wave["training_cli"]["infer"]["launches"],
        "launches_variable_packed_train_step": var_step["gn_silu_nchw"],
        "launches_variable_packed_training_cli": var_cli["launches"][0],
        "launches_variable_packed_infer_cli": var["packed_joint_infer"]["launches"][0],
        "launches_conditional_train_step": cond_step["gn_silu_nchw"],
        "launches_torchrun_training_cli": launched["launches"]["torchrun"][0],
        "launches_gloo_ddp_step_by_rank": [r[0] for r in ddp["launches"]],
        "launches_dropout_train_step": drop["train_step"]["launches"][0],
        "launches_dropout_estimator_step": drop["estimator_step"]["launches"][0],
        "launches_dropout_training_cli": drop["training_cli"]["launches"][0],
        "launches_dropout_serve": drop["serve"]["dropout"]["launches"],
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
        "snr": snr,
        "zoo": zoo,
        "wave": wave,
        "variable": var,
        "torchrun": launched,
        "gloo_ddp_step": ddp,
        "readers": readers,
        "dropout": drop,
        "serve_mesh": mesh,
        "denoiser_graph": graph,
        "build_seconds": {"gn_silu": built["seconds"], "diffwave_stack": dw_built["seconds"],
                          "gn_silu_backward": bwd_built["seconds"],
                          "gn_silu_nhwc_backward": nhwc_bwd_built["seconds"]},
        "nvidia_smi": smi,
        "profiler_not_measured": NOT_MEASURED,
        "profiler_retries": {
            "windows_without_the_kernel": len(UNSEEN_WINDOWS),
            "of_them_without_any_device_event": sum(not w for w in UNSEEN_WINDOWS),
            "measurements_retried": len(RETRIED),
            "most_windows_one_measurement": max((n for n, _ in RETRIED), default=0),
            "longest_s": max((t for _, t in RETRIED), default=0.0)}}
    log(f"profiler: {record_line['profiler_retries']}; not measured: {NOT_MEASURED}")
    log(smi)
    print(json.dumps(finite_or_none(record_line)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serve_mesh_cards(n: int) -> int:
    """``python3 chip_smoke.py --serve-mesh-cards N``: phase 53 alone, its
    ranks over NCCL on a card each (needs ``N`` cards), after the GN forward
    build; prints the phase's record and the cards' ``nvidia-smi`` line."""
    global MESH_RANKS, MESH_BACKEND
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        fail(f"--serve-mesh-cards {n} needs {n} CUDA cards")
    sys.path.insert(0, str(ROOT))
    from sddm_tpu_torch.ops.gn_silu import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[1] {torch.cuda.device_count()} cards: {' | '.join(smi.splitlines())}")
    log(f"[2] build: {build()['seconds']:.2f} s")
    MESH_RANKS, MESH_BACKEND = n, None
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        record = serve_mesh_phase(work, requests(), torch.device("cuda"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(smi)
    print(json.dumps(finite_or_none(record)), flush=True)
    return 0


def denoiser_graph_alone() -> int:
    """``python3 chip_smoke.py --denoiser-graph``: phase 54 alone; prints the
    phase's record and the card's ``nvidia-smi`` line."""
    import torch

    if not torch.cuda.is_available():
        fail("--denoiser-graph needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from sddm_tpu_torch.ops.gn_silu import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = nvidia_smi()
    log(f"[1] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(f"[2] build: {build()['seconds']:.2f} s")
    record = denoiser_graph_phase(torch.device("cuda"))
    log(smi)
    print(json.dumps(finite_or_none(record)), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-mesh-cards"]:
        sys.exit(serve_mesh_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--denoiser-graph"]:
        sys.exit(denoiser_graph_alone())
    sys.exit(main())
