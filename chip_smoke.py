#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (pigan_thz_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's slices at full published width through the
hand-written CUDA kernels: the inverse-design serving cycle on the baseline
MLP trio, dataset generation, the 1e6-candidate screen, forward pretraining,
the full training command (forward pretraining, then the PI-GAN phase), a
seed ensemble trained through the member-packed kernel, scored and served,
and the metric-gated training programs through the GAN kernel's second
generator passes (cycle, stability) and noise streams:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for every fp32 product of the plain references;
2. build: compiles the kernels from ``pigan_thz_torch/csrc`` (nvcc) and
   prints ptxas's register / shared-memory / spill report;
3. each kernel against its plain PyTorch version on the card, at
   B = 1, 77, 257, 8192, full-width seeded weights (generator BatchNorm
   stats non-trivial, so the folding is exercised);
4. the slice: answers requests at B = 1, 64, 8192, 65536 through
   ``serve.make_inverse_design_fn``, checks shapes, finiteness, the params'
   box, one launch of each kernel per request, and agreement with the
   modules' unfused eval-mode forward on the card and, at B = 64, with the
   cycle's plain CPU path;
5. times: CUDA-event medians of each kernel and of the cycle beside their
   plain versions at B = 64 and B = 8192;
6. the dip-qualification kernel (K4) against both plain versions (the
   lattice and the sparse-table form) at B = 1, 7, 1000, 8192 on four
   spectra classes: masks equal, prominence and width within tolerance at
   the peaks;
7. dataset generation: ``synthetic_dataset`` at 1000 samples and
   ``generate_dataset`` at 65536 on the card, one K4 launch each, metrics
   against the CPU plain path, a CSV round trip, and the ``generate-data``
   command in a subprocess;
8. screening: 1e6 candidates, chunk 8192, top-k 100 on seeded full-width F,
   with the fused surrogate kernel and with the module forward: 123 K4
   launches per screen (and 123 K5 launches with the kernel), a sorted,
   finite top-k in the design box, winners re-scored on the CPU;
9. times: K4 beside both plain versions at B = 8192, ``generate_dataset``
   at 1000 and 65536, and each screen's wall time;
10. the forward-training kernel (K1) against its plain version on the
    card: seeded full-width F, a 1000-sample dataset, 2 epochs (30 steps)
    from one state and one set of streams, at dropout 0.2 and 0: the same
    dropout masks, metric rows, parameters and Adam moments within
    tolerance, a rerun bit-identical; at dropout 0 also the eager autograd
    step;
11. forward pretraining: ``python -m pigan_thz_torch pretrain-forward
    --epochs 500`` in a subprocess at the reference workload (1000
    samples, batch 64, lr 1e-3 cosine to 0, clip 1, dropout 0.2): one K1
    launch per 25-epoch chunk, a finite loss that ends well below where it
    starts, artifacts that load into ``build_forward_model``, and the
    trained F answering one serving request through K5;
12. times: the 500-epoch run's wall time and steps/s, and per-epoch
    CUDA-event medians of K1, its plain version and the eager step;
13. the GAN-training kernel (K2) against its plain version on the card:
    the seeded full-width trio (F after 30 epochs through K1, G's BatchNorm
    stats non-trivial), for ``detach_forward`` False and True and for a mix
    of knobs (``d_update_every`` 2, constraint, window, ``sigmoid_squash``,
    EMA).  The first step and the first three steps against the plain
    version in float64, tensor by tensor and relative to what the steps
    changed: Adam's two moments, the parameter update, the EMA's update and
    the BatchNorm stats' as close to float64 as the float32 plain version
    is.  Then 2 epochs (30 steps) from one state and one set of streams
    against the float32 plain version (rows, and by part of the state the
    distance relative to what the steps changed, held against the float32
    plain version's own distance from float64), a rerun bit-identical; at
    the defaults also the eager autograd step;
14. ``python -m pigan_thz_torch train --mode full`` in a subprocess at the
    reference workload (500 forward epochs, then 500 GAN epochs), once as
    typed (F's input detached in the PI-GAN phase) and once with
    ``--fixed-physics`` (gradients through the frozen F): each 20 K1 and 20
    K2 launches, finite rows, the three final artifacts loading into
    ``build_trio``, the trained G and F answering a B = 64 request through
    K6 and K5 inside the design box, and (printed, not gated) the R² of G's
    normalised params over the training set; with ``--fixed-physics`` also
    a reconstruction loss that ends below half of where it starts;
15. times: both commands' wall time and steps/s, per-epoch CUDA-event medians
    of K2, its plain version and the eager step in both ``detach_forward``
    modes, and a ``torch.profiler`` breakdown of one K2 launch of 5 epochs;
16. the member-packed GAN kernel (K3) against K2 and against its plain
    version: M = 4 members (own seeds, own shuffles, one shared F), 2 epochs
    (30 steps), for ``detach_forward`` False and True and for the knob mix
    without the EMA: one launch for all members; every member's rows and
    whole state bit-identical to K2 on that member alone from the same state
    and streams; a rerun bit-identical; against the plain version (a loop of
    K2's over the members) K2's limits of phase 13; every member's first
    step against the plain version in float64 (member 0, phase 13's state,
    at K2's floor; the other seeds at K3_MEMBER_STEP_FLOOR);
17. ``python examples/torch_seed_ensemble.py --members 4 --epochs 500
    --fwd-epochs 500`` in a subprocess at the reference workload: 20 K1 and
    20 K3 launches, finite rows for every member, members that differ, every
    member's reconstruction loss ending below half of where it starts, each
    member's param R² beside the ensemble mean's (printed, not gated); the
    members' mean then served at B = 64 through
    ``serve.make_ensemble_inverse_design_fn`` inside the design box and equal
    to the mean of the members' own served params; then 50 epochs packed and
    ``--unpacked``: the two runs' states bit-identical;
18. times: K3 per epoch at M = 1, 2, 4, 8 beside M times K2's, as aggregate
    member-steps/s and per member, the plain version at M = 4, a
    ``torch.profiler`` breakdown of one K3 launch of 5 epochs at M = 4, and
    phase 17's wall time.

19. K2's second generator passes and noise streams, path by path (cycle
    through F, cycle detached, stability, stability + cycle +
    ``sigmoid_squash`` + constraint, instance noise, augmentation, all four
    with ``d_update_every`` 2 and the EMA): phase 13's checks on each (first
    step and first three steps against float64, 30 steps against the float32
    plain version, one launch per chunk, a rerun bit-identical, the eager
    step from the same seeds on two of them); then one deliberate fault of
    the plain version per path, which the first-step check must see;
20. K3 against K2 at M = 4 with cycle, stability and instance noise on:
    phase 16's checks, every member bit for bit K2's on that member alone;
21. the metric-gated programs: in this process a Trainer with a briefly
    pretrained F and a fresh G runs ``run_program(trainer,
    emergency_phases())`` with the launch counts set to 0 before it (the gate
    reads param R² < 0.7 from the port's evaluator; ``emergency_warmup`` and
    ``emergency_balanced_gan`` go through K2 on its cycle path, one launch
    per chunk); then ``python -m pigan_thz_torch program finetune |
    emergency | progressive`` and ``train --mode full --preset optimized
    --set generator.name=mlp --set discriminator.name=mlp`` (K2's stability
    path), each as typed in a subprocess, with their wall times, phases,
    launches and the evaluator's param R² and violation rate;
22. times: K2's epoch with cycle, with stability, with both, with instance
    noise, beside today's settings in the same call, the kernels a step of
    each (69 at today's settings, 58 detached: held), K3's at M = 4 with both,
    and the profiler's idle share for cycle + stability;
23. K2 with ``gan_loss="wgan_gp"`` (the critic loss, the gradient penalty and
    its second-order backward), through F and detached with ``d_update_every``
    2, stability and instance noise: phase 13's checks (the critic loss rows
    also within K2_ROUNDING of the float32 plain version's own error), then
    each WGAN-GP fault of the plain version seen by the first-step check;
24. bfloat16 operands (``train.compute_dtype=bfloat16``) in K1 and K2 against
    their plain versions with the same rounding, the float64-accumulating
    plain version's distance beside: K1's first step tensor by tensor and 30
    steps; K2's first step by row key and 30 steps by part, through F,
    detached and with WGAN-GP + cycle + stability; each bfloat16 fault (a head
    rounded, a hidden product left in float32) seen; one launch, reruns
    bit-identical;
25. K3 at M = 4 with WGAN-GP + bfloat16 + cycle + stability: every member bit
    for bit K2 alone, a rerun bit-identical;
26. ``train --mode full --fixed-physics --set train.compute_dtype=bfloat16``
    at the reference workload in a subprocess (20 K1 + 20 K2 launches), its
    param R2 and recon_spec_loss beside phase 14's float32 run;
27. ``Trainer.train_pigan`` with WGAN-GP through F for 500 epochs in this
    process after 500 forward epochs: 20 K2 launches, recon_spec_loss
    halved, param R2 printed;
28. times: K2's epoch with WGAN-GP, bfloat16 and both beside today's (and
    detached in both dtypes), the kernels a step of each (69 and 58 held), K1's
    epoch in bfloat16 beside float32, K3's at M = 4 with WGAN-GP + bfloat16.

The ``kernels`` record gives each kernel's launches on the main path, its
error against its plain version, its time beside the plain version's, the
least time the card could take for the same work (``bound_ms``: the larger
of the operations over 67 TFLOP/s fp32 and the bytes, each input read once
and each output written once, over 3.35 TB/s; ``bound_by`` says which), and
``library_ms``, the time of one PyTorch call that computes the same function
where there is one (the modules' eval-mode forward for K5 and K6), else null.
The bfloat16 rows of K1 and K2 carry their own bound, every product counted
at the bf16 tensor-core peak (989 TFLOP/s).

Any failed check raises, and the script exits non-zero.  Without a CUDA
device, or away from the package, it exits non-zero and prints no result.
Its last line is the JSON record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

K5_TOL = 1e-4   # (B, 258) surrogate output; tests/test_pallas.py:43
K6_TOL = 2e-5   # (B, 4) generator output; tests/test_pallas.py:101
# Cycle against the modules' unfused forward: fp32 on both sides, other
# summation order (cuBLAS vs the kernels' sequential FMAs) and BatchNorm
# folded on one side only.
CYCLE_TOL = 1e-4
# K4 against its plain versions: masks exact; the measures at peaks are the
# same fp32 operations on the same samples (tests/test_peaks.py:292-299).
K4_PROM_RTOL = 1e-6
K4_WIDTH_RTOL = 1e-5
K4_BATCHES = (1, 7, 1000, 8192)
METRICS_RTOL = 1e-5     # card vs CPU metrics on the same spectra
DATASET_SIZES = (1000, 65536)
# Re-scored screening winners: the fused surrogate kernel differs from its
# plain version by up to ~3e-6 in the spectra (phase 3), which moves the
# interpolated FWHM edges and so Q and FoM by up to ~1e-5 relative.
SCREEN_RTOL = 1e-4
# K1 against its plain version (and, at dropout 0, the eager step) over 30
# steps from one state: the same fp32 operations in another order.  Metric
# rows within the JAX package's own K1-vs-XLA rtol (tests/test_megakernel.py:
# 338; measured 5.4e-5, on the small late metrics loss).  Adam
# divides each moment by its own root, so an entry whose gradient is at the
# rounding level can take a step of up to lr in either direction: 1e-3 is
# one step at the peak lr (measured 4.8e-4).  The moments themselves stay
# within rounding of the gradients (measured 2.4e-6 and 8.8e-10).
K1_ROWS_RTOL = 5e-4
K1_PARAM_ATOL = 1e-3
K1_M_ATOL = 1e-5
K1_V_ATOL = 1e-8
K1_EPOCHS = 2
# K2, the first step and the first three steps against the plain version in
# float64, tensor by tensor and relative to what the steps changed
# (``gan_train.step_errors``): Adam's two moments, the parameter update, the
# EMA's update and the BatchNorm stats' are each at most K2_ROUNDING times as
# far from float64 as the float32 plain version is, or within K2_STEP_FLOOR;
# the rows agree to K2_STEP_ROWS_RTOL with equal counts.  One step is held
# to rounding (floor 1e-6): it holds the gradients, the clip, lr, eps and
# the EMA's decay.  Over three steps rounding is already amplified some
# tenfold, by another factor from run to run (measured: the kernel 7.5e-4
# where the float32 plain version was 1.4e-4 on the card and 1.2e-3 on a
# CPU), so the floor there is 1e-2 of the change: far below what a wrong
# bias correction at counts 2 and 3 (0.3 and more) or, in the knob mix, a D
# update that ignored its gate (1) would show.
K2_ROUNDING = 8.0
K2_STEP_FLOOR = {1: 1e-6, 3: 1e-2}
K2_STEP_ROWS_RTOL = 1e-4
# K2 over 30 steps against the float32 plain version (and the eager step).
# Adam divides each moment by its own root, so an entry whose gradient is at
# the rounding level steps by up to lr in either direction; G's BatchNorms
# over 64 rows spread such steps over whole columns, and D then sees other
# fakes.  Two float32 trajectories drift apart at that rate and do not come
# back.  Each part of the state (``gan_train.state_diffs``: parameters
# outside the gauge leaves, moments, BatchNorm stats, EMA) is held in
# relative L2 against what the 30 steps changed, not against its own norm,
# which 30 steps at lr 2e-4 move by 1e-2 at most: K2_PART_RTOL is four times
# the largest distance measured (parameters 5.9e-2, BatchNorm stats 2.6e-3,
# second moments 1.4e-2, first moments 9.5e-2, and 1.2e-1 to the eager
# step).  The float32 plain version's own distance from the float64 run is
# printed beside each (3e-2 to 7e-2 for G's parameters and first moments):
# the drift is float32's, not the kernel's.  A part that did not move
# (distance 1) or moved at another rate is outside every limit.  Metric rows
# within K2_ROWS_RTOL (measured 1e-2), the counts within K2_COUNT_ATOL (two
# rows of the batch on the other side of a threshold).
K2_ROWS_RTOL = 5e-2
K2_PART_RTOL = {"g": 0.25, "d": 0.25, "ema": 0.25, "bn": 2e-2, "g_v": 0.1, "d_v": 0.1,
                "g_m": 0.5, "d_m": 0.5}
K2_COUNT_ATOL = 2 / 64
K2_EPOCHS = 2
K2_F_EPOCHS = 30
K2_MIX = dict(detach_forward=False, d_update_every=2, constraint_w=0.7, window_w=0.3,
              sigmoid_squash=True, ema_decay=0.99)
# The second G passes and the noise streams, path by path and all at once.
K2_AUGMENT = dict(augment_noise=0.05, augment_shift=0.02, augment_scale=0.1)
K2_PATHS = (
    ("cycle through F", dict(detach_forward=False, cycle_w=1.0, adv_w=0.0, d_update_every=2)),
    ("cycle detached", dict(detach_forward=True, cycle_w=1.0)),
    ("stability", dict(detach_forward=False, stability_w=1.0)),
    ("stability + cycle + squash + constraint",
     dict(detach_forward=False, stability_w=1.0, cycle_w=1.0, sigmoid_squash=True,
          constraint_w=3.0)),
    ("instance noise", dict(detach_forward=False, instance_noise=0.05)),
    ("augmentation", dict(detach_forward=False, **K2_AUGMENT)),
    ("all four, D every 2nd step, EMA",
     dict(detach_forward=False, cycle_w=1.0, stability_w=1.0, instance_noise=0.05,
          d_update_every=2, ema_decay=0.99, **K2_AUGMENT)),
)
# The first step with cycle on.  Its loss is a difference of two nearly equal
# outputs, G(F(G(s))) - G(s), and G's gradient the sum of two passes'
# contributions that nearly cancel where the two passes see nearly the same
# activations: each pass's float32 rounding (1e-6) is amplified by the ratio
# of a contribution to their sum.  Measured on an H100, detached (where no
# gradient through F covers it): the kernel 1.5e-3 of the change in bn1's beta
# where the float32 plain version is 1.0e-5, and 2.5e-4 / 1.9e-5 in W1; the
# plain version's own float64 run is held to float64 autograd at 1e-10
# (tests/test_torch_gan_train.py).  The worst is W1's gradient of the second
# pass, du1c^T x recon: the columns of du1c sum to zero (BatchNorm's backward)
# and a fresh G gives every row nearly the same recon, so 64 products of size
# 10 sum to nearly nothing.  Adam's first update is lr x sign(g) wherever g is
# above eps, so one entry of 128,000 whose sign differs is 5.6e-3 of the
# update's norm (measured: the kernel, W1, detached): the updates (and the
# EMA's) get the wider floor, the BatchNorm stats, which only the first pass
# moves, keep today's.  Over three steps the distance grows as it does at
# today's settings.  A wrong or missing adjoint of this path shows at 7.6e-2
# and above, a second pass that moves the running stats at 0.5 (K2_FAULTS).
K2_CYCLE_STEP_FLOOR = {"m": 5e-3, "v": 5e-3, "p": 2e-2, "ema": 2e-2, "bn": 1e-6}
# Three steps on these paths.  The augmented stream adds no device code at all
# (the kernel reads other spectra), and its three steps land 1.5e-2 from
# float64 on this seed where the float32 plain version lands 7e-5 (measured,
# H100; at today's settings 7.5e-4 and 1.4e-4): how far rounding is amplified
# in three steps depends on the batch more than on the code.  So three steps
# are held to 5e-2 of the change on every new path: a D update that ignored
# its gate shows at 1, a wrong bias correction at 0.3.
K2_PATHS_3_STEP_FLOOR = 5e-2
# One deliberate fault of the plain version per path
# (``gan_train.FAULTS``), which the first-step check must see: with the
# faulty float64 run in the place of the right one, the kernel must fail the
# check, some tensor beyond its limit.  Instance noise at the size of the
# spectra's own features (1 dB) and with F's input detached, so that the
# adversarial term is most of G's gradient: through F the reconstruction terms
# (weight 110) hide it, and at 0.05 dB noised fake rows move G's gradient by
# 1.6e-4 only.
K2_FAULTS = (
    ("cycle through F", "cycle_seed_dropped", {}),
    ("cycle through F", "second_pass_moves_running_stats", {}),
    ("cycle detached", "drecon_c_when_detached", {}),
    ("stability", "stability_seed_dropped", {}),
    ("stability", "second_pass_moves_running_stats", {}),
    ("instance noise", "noised_fake_rows", dict(instance_noise=1.0, detach_forward=True)),
)
# WGAN-GP (phase 23).  The critic's gradients are differences of the real and
# the fake rows' contributions, rows that share 250 of D's 254 input columns
# (the fake rows differ in the 4 params only), so float32 sums lose what the
# difference keeps: with float bias sums the kernel's first step was 2.4e-5
# of the change from float64 in D's first-layer bias moment where the float32
# plain version was 1.9e-6 (H100); with the critic's bias sums in double
# (column_sum_f64) 2.4e-7, and every tensor keeps today's floor 1e-6.  A
# penalty whose W1 term is dropped or whose seed has the wrong sign shows at
# 2 and above (K2_WGAN_FAULTS).  The critic loss row is such a difference
# too: on a step with D gated off it is mean(z_fake) - mean(z_real) alone,
# -1.3e-2 where each mean is about 3.3, so its error is read against the
# size of the means, |adv_loss| (``row_errors``).
# A float32 run leaves float64 where an activation mask flips: a LeakyReLU
# or ReLU pre-activation within rounding of zero sends one row's gradient
# down the other slope, and G's gradient (a sum over 64 rows) moves by up to
# 1e-3 of the change at once (examples/torch_gan_drift.py).  Under WGAN-GP the
# flips reach D after some ten to twenty steps, and D's moments, a small
# difference of large row sums, then move by their whole size.  Through F on
# an H100 D's masks began to flip at step 6, and the float32 plain version's
# distance from float64 in D's first moments went 1.9e-4 (step 6) -> 9.0e-3
# (8) -> 0.44 (10) -> 0.98 (30); the kernel's the same to two digits (on the
# CPU the flips reached D at step 19).  So the WGAN-GP paths are held over
# their first K2_WGAN_WINDOW steps, where float32's own drift is still far
# below the change, to K2_PART_RTOL.  The kernel's three steps on the
# detached mix are 7.9e-4 of the change from float64 in G's first-layer
# moment where the float32 plain version is 1.0e-5: one ReLU of G's first
# BatchNorm at step 3 (5.3e-6 of its tensor's rms from zero) taken on the
# other side moves float64 by 7.9e-4 there and leaves the kernel 1.4e-5 from
# it (examples/torch_gan_drift.py --witness 3); K2_PATHS_3_STEP_FLOOR holds.
K2_WGAN_WINDOW = 8
K2_WGAN_PATHS = (
    ("WGAN-GP through F", dict(detach_forward=False, gan_loss="wgan_gp")),
    ("WGAN-GP detached, D every 2nd step, stability, instance noise",
     dict(detach_forward=True, gan_loss="wgan_gp", d_update_every=2, stability_w=1.0,
          instance_noise=0.05)),
)
K2_WGAN_FAULTS = (
    ("WGAN-GP through F", "wgan_gp_w1_second_term_dropped", {}),
    ("WGAN-GP through F", "wgan_gp_seed_sign", {}),
)
# bfloat16 operands (phase 24).  Where the kernel's and the plain version's
# float32 upstreams differ by an ulp, rounding an operand to bfloat16 can land
# on the other neighbour, a step of 2^-8 relative; the two are then as far
# apart as the plain version accumulating in float32 is from the same rounded
# operands accumulated in float64, which is printed beside every number.  The
# first step's rows are held per key (tests/test_torch_gan_train.py measured
# these bounds against the JAX package's kernel in interpret mode: 4.3e-5 in
# param_range_loss, 1.3e-3 in lc_loss); a G head rounded to bfloat16 moves
# param_range_loss by 1.7e-3 and D's first layer left in float32 moves
# adv_loss by 5.8e-3 and more.  The first step's state is held tensor by
# tensor against the float64-accumulating run: within K2_ROUNDING times the
# float32 plain version's distance, or K2_BF16_TENSOR_FLOOR.  G's first-layer
# gradient is a sum over rows whose BatchNorm adjoints sum to zero: float32
# accumulation of the same rounded operands lands 1.4e-2 to 1.7e-2 of the
# change from float64 in its first moment, in the kernel and the plain
# version alike (H100), and K2_ROUNDING covers it.  Where the plain version
# is closer by chance, the floor holds: D's tensors lay within 6.0e-5 of the
# change in the kernel on the BCE paths and within 9.1e-5 under WGAN-GP.
# D's backward product dp2 . W2 left in float32 (``bf16_backward_fp32``, a
# fault the rows cannot see) moves D's first-layer update by 9.3e-3 of the
# change on the BCE paths, where the faults are held.  Over 30 steps each
# part is held to K2_BF16_PART_RTOL (measured at most 0.13 for G's parts and
# 0.19 for D's, H100, with the float32 plain version 0.07 to 0.13 from
# float64), the WGAN-GP path over its first K2_WGAN_WINDOW steps.
K2_BF16_PATHS = (
    ("bf16 through F", dict(detach_forward=False)),
    ("bf16 detached", dict(detach_forward=True)),
    ("bf16 WGAN-GP + cycle + stability, D every 2nd step",
     dict(detach_forward=False, gan_loss="wgan_gp", cycle_w=1.0, stability_w=1.0,
          d_update_every=2)),
)
K2_BF16_FAULTS = ("bf16_head_rounded", "bf16_hidden_fp32", "bf16_backward_fp32")
K2_BF16_STEP_RTOL = {"lc_loss": 5e-3, "recon_metrics_loss": 1e-3, "maxwell_loss": 1e-3}
K2_BF16_STEP_FLOOR = 2e-4
K2_BF16_TENSOR_FLOOR = 5e-4
K2_BF16_PART_RTOL = {"g": 0.4, "d": 0.4, "ema": 0.4, "bn": 3e-2, "g_v": 0.1, "d_v": 0.1,
                     "g_m": 0.4, "d_m": 0.4}
# K1 in bfloat16: the first step's Adam first moments tensor by tensor (the
# head's spectrum and metrics rows apart) against the float64-accumulating
# plain version, within K2_ROUNDING of the float32 plain version's distance or
# K1_BF16_STEP_FLOOR; a fault is seen where the kernel is K1_BF16_FAULT_RATIO
# times further from the faulty run than from the right one on some tensor.
K1_BF16_STEP_FLOOR = 1e-3
K1_BF16_FAULT_RATIO = 4.0
K1_BF16_PARAMS_RTOL = 0.15      # 30 steps, parameters (measured 2.9e-2, H100)
# K3 with every new path at once (phase 25), and the bfloat16 training command
# and a WGAN-GP train_pigan at the reference workload (phases 26, 27).
K3_SLICE7 = dict(detach_forward=False, gan_loss="wgan_gp", cycle_w=1.0, stability_w=1.0)
PEAK_BF16_FLOPS = 989e12    # H100 SXM, bf16 dense tensor cores
GAN_EPOCHS = 500
K3_MEMBERS = 4
K3_PATHS = dict(detach_forward=False, cycle_w=1.0, stability_w=1.0, instance_noise=0.05)
PROGRAM_F_EPOCHS = 30       # the brief pretraining before the in-process program
PROGRAMS = ("finetune", "emergency", "progressive")
K3_MIX = {**K2_MIX, "ema_decay": 0.0}      # the member-packed kernel carries no EMA
K3_TIME_MEMBERS = (1, 2, 4, 8)
# K3's members, first step against float64.  Member 0 is phase 13's state and
# keeps K2's floor.  The others are other seeds, and a float32 step is not as
# close to float64 on every seed: G's gradient is piecewise in G's output
# (F's LeakyReLUs), so where a pre-activation lies within rounding of zero the
# float32 forward (6e-6 from float64 in G's output) lands on another piece
# and the gradient jumps: 2.9e-4 and 2.3e-4 of its norm on seeds 2 and 5,
# 1e-5 on the others, with the kernel's backward arithmetic 6e-7 from float64
# at the kernel's own forward on all of them
# (examples/torch_gan_step_conditioning.py, H100).  Which side the float32
# plain version lands on is chance, so it is no yardstick there: the other
# members are held to 1e-3 of the change, still far below what a wrong lr,
# eps, bias correction or gate shows (2e-2 and more).  K3 is held to K2 bit
# for bit besides, and K2 to float64 at 1e-6 in phase 13.
K3_MEMBER_STEP_FLOOR = 1e-3
ENSEMBLE_SHORT_EPOCHS = 50    # packed against --unpacked
ENSEMBLE_SHORT_FWD_EPOCHS = 100
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PRETRAIN_EPOCHS = 500
EPOCHS_PER_CALL = 25
REQUEST_BATCHES = (1, 64, 8192, 65536)
CHECK_BATCHES = (1, 77, 257, 8192)
TIME_BATCHES = (64, 8192)
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def perturb_batch_stats_(module, gen) -> None:
    """Non-trivial BatchNorm running stats (as tests/test_pallas.py:96-98),
    drawn on the CPU from ``gen``."""
    import torch

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                for stat in (m.running_mean, m.running_var):
                    noise = 0.1 * torch.randn(m.num_features, generator=gen) ** 2
                    stat += noise.to(stat.device)


def reset_launches(launches: dict) -> None:
    for name in launches:
        launches[name] = 0


def cuda_median_ms(fn, *args, warmup: int = 10, reps: int = 50) -> float:
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nan_equal(a, b) -> bool:
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def rel_check(got, want, rtol: float):
    """(entries whose NaN-ness differs, entries outside ``rtol`` of want,
    max |got - want|) over two tensors of one shape."""
    import torch

    nan_diff = int((got.isnan() != want.isnan()).sum())
    both = ~(got.isnan() | want.isnan())
    g, w = got[both], want[both]
    err = torch.where(g == w, 0.0, (g - w).abs())
    bad = int((err > rtol * w.abs()).sum())
    return nan_diff, bad, float(err.max()) if err.numel() else 0.0


def spectra_classes(gen, b: int, cfg, dev) -> dict:
    """The spectra classes of tests/test_peaks.py (noisy synthetic spectra,
    cumulative random walks, white noise, spectra quantized to 0.5 dB),
    (b, S) each, drawn on the card from ``gen``."""
    import torch
    from pigan_thz_torch.data import sample_params, synthesize_spectra

    def noise():
        return torch.randn((b, cfg.data.spectrum_dim), generator=gen, device=dev)

    p = sample_params(gen, b, cfg.data, device=dev)
    return {
        "synthetic": synthesize_spectra(cfg.data.frequencies, p, gen,
                                        cfg.data.noise_level),
        "random_walk": torch.cumsum(0.8 * noise(), dim=1).clamp(max=0.0),
        "white_noise": (-1.0 + 0.6 * noise()).clamp(max=0.0),
        "quantized": torch.round((-2.0 + 1.5 * noise()).clamp(max=0.0) * 2.0) / 2.0,
    }


def compare_k4(got, want):
    """(mask mismatches, measures outside tolerance at want's peaks, max
    |err| of the measures there) of two DipQualifications."""
    mism = int((got.qualified != want.qualified).sum()
               + (got.is_peak != want.is_peak).sum())
    pk = want.is_peak
    _, bad_p, err_p = rel_check(got.prominence[pk], want.prominence[pk], K4_PROM_RTOL)
    _, bad_w, err_w = rel_check(got.width[pk], want.width[pk], K4_WIDTH_RTOL)
    return mism, bad_p + bad_w, max(err_p, err_w)


def phase6_k4(gen, cfg, dev) -> dict:
    """K4 against both plain versions; returns its max |err| and mismatches."""
    import torch
    from pigan_thz_torch.ops import peaks as pk

    stats = {"max_abs_err": 0.0, "mask_mismatches": 0}
    plains = (("lattice", pk.dip_qualification),
              ("lifted", pk._dip_qualification_lifted))
    for b in K4_BATCHES:
        for cls, t in spectra_classes(gen, b, cfg, dev).items():
            got = pk.batched_dip_qualification(t)
            torch.cuda.synchronize()
            line = []
            for plain_name, plain in plains:
                mism, bad, err = compare_k4(got, plain(t))
                stats["mask_mismatches"] += mism
                stats["max_abs_err"] = max(stats["max_abs_err"], err)
                line.append(f"vs {plain_name}: {mism} mask mismatches, {bad} measures "
                            f"outside tol, max|err| {err:.3e}")
                if mism or bad:
                    fail(f"dip_qualification disagrees with its {plain_name} plain "
                         f"version at B={b} on {cls} spectra")
            print(f"K4 check B={b} {cls} ({int(got.is_peak.sum())} peaks, "
                  f"{int(got.qualified.sum())} qualified): " + "; ".join(line))
    print(f"K4 checks: {stats['mask_mismatches']} mask mismatches in all, max|err| "
          f"{stats['max_abs_err']:.3e} (prominence rtol {K4_PROM_RTOL}, width rtol "
          f"{K4_WIDTH_RTOL})")
    return stats


def phase7_dataset(cfg, dev, repo: str) -> int:
    """Dataset generation on the card; returns its K4 launches."""
    import torch
    from pigan_thz_torch.data import (
        dip_centers, generate_dataset, load_csv, save_csv, synthetic_dataset)
    from pigan_thz_torch.ops import peaks as pk
    from pigan_thz_torch.ops._cuda_build import LAUNCHES

    reset_launches(LAUNCHES)
    ds = synthetic_dataset(cfg.data, device=dev)
    torch.cuda.synchronize()
    if LAUNCHES["dip_qualification"] != 1:
        fail(f"synthetic_dataset launched K4 {LAUNCHES['dip_qualification']} times, not 1")
    gen = torch.Generator(device=dev).manual_seed(cfg.data.seed + 1)
    raw = generate_dataset(gen, DATASET_SIZES[1], cfg.data, device=dev)
    torch.cuda.synchronize()
    launches = LAUNCHES["dip_qualification"]
    if launches != 2:
        fail(f"generate_dataset launched K4 {launches - 1} times, not 1")
    print(f"dataset: launches {dict(LAUNCHES)}")

    for n, (spectra, params, metrics) in zip(
            DATASET_SIZES, ((ds.spectra, ds.params, ds.metrics), raw)):
        if (tuple(spectra.shape), tuple(metrics.shape)) != (
                (n, cfg.data.spectrum_dim), (n, cfg.data.metrics_dim)):
            fail(f"dataset n={n}: shapes {tuple(spectra.shape)}, {tuple(metrics.shape)}")
        if not bool(torch.isfinite(spectra).all() & torch.isfinite(params).all()):
            fail(f"dataset n={n}: non-finite spectra or params")
        cpu = pk.batched_peak_metrics(cfg.data.frequencies, spectra.cpu(),
                                      *dip_centers(params.cpu()))
        nan_diff, bad, err = rel_check(metrics.cpu(), cpu, METRICS_RTOL)
        print(f"dataset n={n}: metrics vs the CPU plain path: {nan_diff} NaN-pattern "
              f"differences, {bad} outside rtol {METRICS_RTOL}, max|err| {err:.3e}; "
              f"NaN share {float(metrics.isnan().float().mean()):.4f}")
        if nan_diff or bad:
            fail(f"dataset n={n}: the card's metrics disagree with the CPU plain path")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.csv")
        save_csv(ds, path)
        back = load_csv(path, cfg.data, device=dev)
        for name in ("spectra", "params", "metrics", "params_norm", "metrics_norm"):
            if not nan_equal(getattr(back, name), getattr(ds, name)):
                fail(f"CSV round trip changed {name}")
        out = os.path.join(tmp, "cli.csv")
        cmd = [sys.executable, "-m", "pigan_thz_torch", "generate-data",
               "--set", f"data.num_samples={DATASET_SIZES[0]}", "--out", out]
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stderr[-2000:]}")
        cli = load_csv(out, cfg.data, device=dev)
        same = all(nan_equal(getattr(cli, f), getattr(ds, f))
                   for f in ("spectra", "params", "metrics"))
        print(f"dataset: CSV round trip exact; `{' '.join(cmd[1:4])}` wrote "
              f"{cli.num_samples} samples, equal to synthetic_dataset's: {same}")
        if cli.num_samples != DATASET_SIZES[0] or not same:
            fail("generate-data wrote another dataset than synthetic_dataset")
    return launches


def check_screen(res, sc, cfg, label: str) -> None:
    import torch
    from pigan_thz_torch.design import METRIC_INDEX

    k, s = sc.top_k, cfg.data.spectrum_dim
    shapes = tuple(tuple(t.shape) for t in res)
    if shapes != ((k, 4), (k,), (k, 8), (k, s), (k,)):
        fail(f"screen {label}: result shapes {shapes}")
    v = res.valid
    finite = all(bool(torch.isfinite(t[v]).all())
                 for t in (res.scores, res.params, res.spectra))
    if not finite:
        fail(f"screen {label}: a valid row is not finite")
    if not bool((res.scores[:-1] >= res.scores[1:]).all()):
        fail(f"screen {label}: scores are not in descending order")
    if not bool((res.metrics[v, METRIC_INDEX[sc.objective]] == res.scores[v]).all()):
        fail(f"screen {label}: scores are not the {sc.objective} column")
    lo, hi = cfg.data.param_min, cfg.data.param_max
    if not bool(((res.params >= lo) & (res.params <= hi)).all()):
        fail(f"screen {label}: params outside [{lo}, {hi}]")
    print(f"screen {label}: {int(v.sum())} valid of {k}, {sc.objective} from "
          f"{res.scores[v].min().item():.6g} to {res.scores[v].max().item():.6g}, "
          f"params in [{res.params.min().item():.4f}, {res.params.max().item():.4f}]")


def run_screen(F, cfg, dev, lo, hi, use_pallas: bool):
    """One 1e6-candidate screen, candidates seeded from cfg.train.seed;
    (result, wall seconds)."""
    import torch
    from pigan_thz_torch.design import ScreeningConfig, screen_designs

    sc = ScreeningConfig(use_pallas=use_pallas)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    freq = cfg.data.frequencies.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = screen_designs(F, freq, lo, hi, gen, sc)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase8_screen(F, cfg, dev, lo, hi) -> dict:
    """Both screens; returns their K5 / K4 launches and wall seconds."""
    import torch
    from pigan_thz_torch.data import normalize_params
    from pigan_thz_torch.design import ScreeningConfig, screen_chunk
    from pigan_thz_torch.design.screening import make_surrogate
    from pigan_thz_torch.ops._cuda_build import LAUNCHES

    sc = ScreeningConfig()
    n_chunks = -(-sc.num_candidates // sc.chunk_size)
    out = {}
    for use_pallas in (True, False):
        label = "fused surrogate" if use_pallas else "module surrogate"
        reset_launches(LAUNCHES)
        res, wall = run_screen(F, cfg, dev, lo, hi, use_pallas)
        got = dict(LAUNCHES)
        want = {"fused_mlp_forward": n_chunks if use_pallas else 0,
                "fused_dense_chain": 0, "dip_qualification": n_chunks,
                "forward_train": 0, "gan_train": 0, "gan_ensemble_train": 0}
        print(f"screen {label}: {sc.num_candidates} candidates in {n_chunks} chunks "
              f"of {sc.chunk_size}, launches {got}")
        if got != want:
            fail(f"screen {label}: launches {got}, expected {want}")
        check_screen(res, sc, cfg, label)
        out[use_pallas] = (res, wall, got)

    # The fused screen's winners re-scored through the CPU plain path.
    res = out[True][0]
    v = res.valid
    cpu = torch.device("cpu")
    f_cpu = copy.deepcopy(F).to(cpu).eval()
    pn = normalize_params(res.params[v].cpu(), lo.cpu(), hi.cpu())
    with torch.inference_mode():
        surrogate = make_surrogate(f_cpu, True, cpu, cfg.data.spectrum_dim)
        _, _, scores = screen_chunk(surrogate, pn, cfg.data.frequencies, sc)
    nan_diff, bad, err = rel_check(scores, res.scores[v].cpu(), SCREEN_RTOL)
    rel = float(((scores - res.scores[v].cpu()).abs() / res.scores[v].cpu().abs()).max())
    print(f"screen: {int(v.sum())} winners re-scored on the CPU plain path: "
          f"max|err| {err:.3e}, max rel err {rel:.3e} (rtol {SCREEN_RTOL}), "
          f"{nan_diff + bad} disagree")
    if nan_diff or bad:
        fail("the screen's winners disagree with the CPU plain path")
    return out


def phase9_k4_times(gen, cfg, dev, f_packed) -> dict:
    """K4 beside both plain versions at B = 8192 on synthetic spectra and on
    the surrogate's predictions (a screening chunk): name -> (kernel,
    lattice, lifted) ms."""
    import torch
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.ops import peaks as pk

    b = K4_BATCHES[-1]
    pn = torch.rand((b, 4), generator=gen, device=dev) * 2 - 1
    inputs = {
        "synthetic": spectra_classes(gen, b, cfg, dev)["synthetic"],
        "screen": fk.forward_surrogate_fused(f_packed, pn)[0].contiguous(),
    }
    times = {}
    # The kernel's work depends on the data: two neighbour comparisons on
    # each side of every sample, and at each peak the walks to the higher
    # samples and the half-height crossings, at least the peak's width (in
    # samples) of loads, minima and comparisons on both sides.
    got = pk.batched_dip_qualification(inputs["screen"])
    times["screen_ops"] = 4.0 * inputs["screen"].numel() + 6.0 * float(
        got.width[got.is_peak].sum())
    times["screen_bytes"] = inputs["screen"].numel() * (4 + 1 + 1 + 4 + 4)
    for name, t in inputs.items():
        # plain, kernel, kernel, plain: the best of each side's two runs
        p1 = cuda_median_ms(pk.dip_qualification, t, warmup=3, reps=10)
        l1 = cuda_median_ms(pk._dip_qualification_lifted, t, warmup=3, reps=20)
        k1 = cuda_median_ms(pk.batched_dip_qualification, t)
        k2 = cuda_median_ms(pk.batched_dip_qualification, t)
        l2 = cuda_median_ms(pk._dip_qualification_lifted, t, warmup=3, reps=20)
        p2 = cuda_median_ms(pk.dip_qualification, t, warmup=3, reps=10)
        times[name] = (min(k1, k2), min(p1, p2), min(l1, l2))
    return times


def k1_setup(cfg, dev, ds, epochs: int):
    """Seeded full-width F and its fresh Adam state on the card, the eager
    optimiser, and the draws and streams of ``epochs`` epochs of ``ds``:
    (state, tx, indices, seeds, streams)."""
    import torch
    from pigan_thz_torch.models import build_forward_model
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.train.schedules import make_schedule
    from pigan_thz_torch.train.state import init_forward_state, make_optimizers

    b = cfg.train.batch_size
    spe = ds.num_samples // b
    _, _, ftx = make_optimizers(cfg, spe)
    f = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim,
                            device="cpu")
    state = init_forward_state(f, ftx, SEED, device=dev)
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(SEED), ds.num_samples, b,
                                  epochs)
    sched = make_schedule("cosine", cfg.train.fwd_pretrain_lr,
                          cfg.train.fwd_pretrain_epochs, spe, schedule_alpha=0.0)
    streams = ft.build_streams(ds, idx, seeds, torch.ones(epochs), 0, sched)
    return state, ftx, idx, seeds, streams


def compare_k1(label: str, rows, state, want_rows, want_state) -> tuple:
    """Metric rows and (params, m, v) of two runs from one state; fails
    beyond the K1 tolerances.  Returns (rows max rel err, params max |err|)."""
    rel = float(((rows - want_rows).abs() / want_rows.abs()).max())
    errs = [float((a - b).abs().max()) for a, b in zip(state, want_state)]
    print(f"{label}: rows max rel err {rel:.3e} (rtol {K1_ROWS_RTOL}), max|err| params "
          f"{errs[0]:.3e} (atol {K1_PARAM_ATOL}) m {errs[1]:.3e} (atol {K1_M_ATOL}) "
          f"v {errs[2]:.3e} (atol {K1_V_ATOL})")
    if not (rel <= K1_ROWS_RTOL and errs[0] <= K1_PARAM_ATOL and errs[1] <= K1_M_ATOL
            and errs[2] <= K1_V_ATOL):
        fail(f"{label}: outside tolerance")
    return rel, errs[0]


def phase10_k1(cfg, dev, ds) -> dict:
    """K1 against its plain version (and the eager step at dropout 0) over
    K1_EPOCHS epochs from one state and one set of streams."""
    import dataclasses
    import torch
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.train.steps import (
        ForwardStepSettings, make_forward_step, make_multi_epoch_fn)

    settings = ForwardStepSettings()
    b = cfg.train.batch_size
    stats = {"max_abs_err": 0.0, "rows_rel": 0.0}
    for rate in (cfg.forward_model.dropout_rate, 0.0):
        rcfg = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                             dropout_rate=rate))
        spec = ft.forward_train_spec(rcfg, settings)
        state, ftx, idx, seeds, streams = k1_setup(rcfg, dev, ds, K1_EPOCHS)
        start = (state.params.clone(), state.opt.m.clone(), state.opt.v.clone())
        kern = [t.clone() for t in start]
        work = torch.empty(ft.workspace_floats(spec, b), device=dev)
        rows = ft.forward_train(*kern, streams, spec, work=work)
        torch.cuda.synchronize()
        if rate > 0:
            # the factors the kernel applied in its last step, against the
            # plain version's hash of the same (seed, layer, row, column)
            masks = ft.saved_dropout(work, spec, b)
            last = int(seeds[-1])
            same = all(torch.equal(mk, ft.dropout_scale(last, l, b, mk.shape[1], rate, dev))
                       for l, mk in enumerate(masks))
            n = sum(mk.numel() for mk in masks)
            keep = float(sum((mk > 0).sum() for mk in masks)) / n
            sigma = ((1 - rate) * rate / n) ** 0.5
            print(f"K1 dropout {rate}: last step's masks equal the plain version's: {same}; "
                  f"keep share {keep:.5f} over {n} entries (expected {1 - rate}, "
                  f"5 sigma {5 * sigma:.5f})")
            if not same or abs(keep - (1 - rate)) > 5 * sigma:
                fail(f"K1's dropout masks at rate {rate} are not the plain version's")
        plain = [t.clone() for t in start]
        want_rows = ft.forward_train_plain(*plain, streams, spec)
        torch.cuda.synchronize()
        rel, err = compare_k1(f"K1 vs plain, dropout {rate}, {K1_EPOCHS} epochs "
                              f"({rows.shape[0]} steps)", rows, kern, want_rows, plain)
        stats["rows_rel"] = max(stats["rows_rel"], rel)
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        again = [t.clone() for t in start]
        rows2 = ft.forward_train(*again, streams, spec)
        torch.cuda.synchronize()
        if not (torch.equal(rows2, rows) and all(map(torch.equal, again, kern))):
            fail(f"K1 rerun from the same state differs (dropout {rate})")
        print(f"K1 dropout {rate}: a rerun from the same state is bit-identical")
        if rate == 0.0:
            eager = make_multi_epoch_fn(make_forward_step(ftx, settings), b)
            state, ms = eager(state, ds, torch.ones(K1_EPOCHS), indices=idx, seeds=seeds)
            torch.cuda.synchronize()
            got = torch.stack([v for v in ft.epoch_means(rows, K1_EPOCHS).values()], 1)
            want = torch.stack([ms[k] for k in ft.METRIC_KEYS], 1)
            compare_k1(f"K1 vs the eager autograd step, dropout 0, {K1_EPOCHS} epochs "
                       "(per-epoch rows)", got, kern, want,
                       (state.params, state.opt.m, state.opt.v))
    return stats


def phase11_pretrain(cfg, dev, repo: str, G, ds_serving, request) -> dict:
    """``pretrain-forward`` at the reference workload in a subprocess; the
    trained F then serves one request.  Returns its launches, wall time and
    loss curve."""
    import ast
    import glob
    import torch
    from pigan_thz_torch.config import _to_dict
    from pigan_thz_torch.models import build_forward_model
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.serve import make_inverse_design_fn
    from pigan_thz_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "saved_models")
        cmd = [sys.executable, "-m", "pigan_thz_torch", "pretrain-forward",
               "--epochs", str(PRETRAIN_EPOCHS), "--workdir", tmp, "--out", out,
               "--no-tensorboard"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{' '.join(cmd[1:5])} exited {proc.returncode}: {proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("kernel launches: ")]
        if len(lines) != 1:
            fail(f"pretrain-forward printed {len(lines)} 'kernel launches' lines")
        launches = ast.literal_eval(lines[0][len("kernel launches: "):])
        shown = ("forward-training kernel", "eager step", f"epoch {PRETRAIN_EPOCHS}/")
        for line in proc.stdout.splitlines():
            if any(key in line for key in shown):
                print(f"pretrain-forward: {line}")
        chunks = -(-PRETRAIN_EPOCHS // EPOCHS_PER_CALL)
        print(f"pretrain-forward: {PRETRAIN_EPOCHS} epochs in {wall:.3f} s wall, "
              f"launches {launches} ({chunks} chunks of {EPOCHS_PER_CALL} epochs)")
        if launches.get("forward_train") != chunks:
            fail(f"pretrain-forward launched K1 {launches.get('forward_train')} times, "
                 f"not once per chunk ({chunks})")

        runs = glob.glob(os.path.join(tmp, "fwd_pretrain_*", "scalars.jsonl"))
        with open(runs[0]) as fh:
            records = [json.loads(line) for line in fh]
        loss = [r["value"] for r in records if r["tag"] == "forward/loss"]
        finite = all(x == x and abs(x) != float("inf") for x in loss)
        marks = sorted({0, len(loss) // 5, len(loss) // 2, len(loss) - 1})
        curve = ", ".join(f"{loss[i]:.6f} ({i + 1})" for i in marks)
        print(f"pretrain-forward: loss per epoch {curve}; all finite: {finite}")
        if len(loss) != PRETRAIN_EPOCHS or not finite or not loss[-1] < 0.05 * loss[0]:
            fail("pretrain-forward's loss is not finite or did not fall twentyfold")

        saved = ckpt.load_model_config(out)
        if saved is None or saved["forward_model"] != _to_dict(cfg)["forward_model"]:
            fail("model_config.json does not hold the run's forward_model section")
        F = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim,
                                cfg.data.metrics_dim, device="cpu")
        ckpt.load_model(out, ckpt.FORWARD_MODEL_PRETRAINED, F)
    F = F.to(dev).eval()

    before = dict(fk.LAUNCHES)
    params, spec, met = make_inverse_design_fn(G, F, ds_serving)(request)
    torch.cuda.synchronize()
    served = {k: fk.LAUNCHES[k] - before[k] for k in before}
    b = request.shape[0]
    ok = (tuple(spec.shape) == (b, cfg.data.spectrum_dim) and tuple(met.shape) == (b, 8)
          and all(bool(torch.isfinite(t).all()) for t in (params, spec, met)))
    print(f"pretrain-forward: the trained F serves a B={b} request: launches {served}, "
          f"finite outputs of the right shapes: {ok}")
    if not ok or served["fused_mlp_forward"] != 1:
        fail("the trained forward surrogate did not serve a request through K5")
    return {"launches": launches, "wall": wall, "loss": loss}


def phase12_k1_times(cfg, dev, ds) -> tuple:
    """Per-epoch CUDA-event medians (ms) of K1, its plain version and the
    eager step, one epoch each from one state: (kernel, plain, eager)."""
    import torch
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.train.steps import (
        ForwardStepSettings, make_forward_step, make_multi_epoch_fn)

    settings = ForwardStepSettings()
    spec = ft.forward_train_spec(cfg, settings)
    state, ftx, idx, seeds, streams = k1_setup(cfg, dev, ds, 1)
    kern = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
    plain = [t.clone() for t in kern]
    eager = make_multi_epoch_fn(make_forward_step(ftx, settings), cfg.train.batch_size)
    ones = torch.ones(1)

    def k():
        ft.forward_train(*kern, streams, spec)

    def p():
        ft.forward_train_plain(*plain, streams, spec)

    def e():
        eager(state, ds, ones, indices=idx, seeds=seeds)

    # plain, eager, kernel, kernel, eager, plain: the best of each side's two
    p1 = cuda_median_ms(p, warmup=1, reps=5)
    e1 = cuda_median_ms(e, warmup=1, reps=5)
    k1 = cuda_median_ms(k, warmup=3, reps=20)
    k2 = cuda_median_ms(k, warmup=3, reps=20)
    e2 = cuda_median_ms(e, warmup=1, reps=5)
    p2 = cuda_median_ms(p, warmup=1, reps=5)
    return min(k1, k2), min(p1, p2), min(e1, e2)

def roofline(flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for work of
    ``flops`` fp32 operations and ``nbytes`` bytes moved once."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def chain_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def k2_setup(cfg, dev, ds, f, epochs: int, knobs: dict):
    """The seeded full-width trio on the card as a fresh PiGanState (F a
    copy of ``f``, G's BatchNorm stats perturbed), the eager optimisers, the
    settings, the kernel's spec and the draws and streams of ``epochs``
    epochs of ``ds``."""
    import torch
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule
    from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
    from pigan_thz_torch.train.steps import StepSettings

    b = cfg.train.batch_size
    spe = ds.num_samples // b
    settings = StepSettings.from_config(cfg, **knobs)
    gtx, dtx, _ = make_optimizers(cfg, spe)
    g, d, _ = build_trio(cfg, device="cpu")
    state = init_pigan_state(g, d, f, gtx, dtx, SEED, device=dev,
                             ema=settings.ema_decay > 0)
    perturb_batch_stats_(state.g, torch.Generator().manual_seed(SEED))
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(SEED), ds.num_samples, b,
                                  epochs)
    scales = torch.linspace(1.0, 0.5, epochs)
    streams = gt.build_streams(
        ds, idx, scales, 0, 0, 0, settings.d_update_every,
        cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01),
        step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25),
        settings=settings, seeds=seeds)
    spec = gt.gan_train_spec(cfg, settings)
    return state, (gtx, dtx), settings, spec, idx, seeds, scales, streams


def k2_state_tensors(state) -> list:
    """Every tensor a K2 chunk updates in place."""
    from pigan_thz_torch.ops import gan_train as gt

    bufs = gt.state_buffers(state)
    return [t for t in (*bufs[:6], *bufs.bn, bufs.g_ema) if t is not None]


def row_errors(rows, want, keys, wgan: bool):
    """|rows - want| relative to |want| (at least 1e-3), per step and key;
    under WGAN-GP the critic loss relative to the size of the two means it
    is the difference of (|adv_loss| where that is the larger)."""
    import torch

    scale = want.abs().clamp(min=1e-3)
    if wgan:
        j, a = keys.index("d_loss"), keys.index("adv_loss")
        scale[:, j] = torch.maximum(scale[:, j], want[:, a].abs())
    return (rows - want).abs() / scale


def compare_k2(label: str, rows, bufs, want_rows, want_bufs, start, yard, spec, keys,
               rows_yard: float = 0.0, part_rtol: dict | None = None) -> tuple:
    """Metric rows (T or E, len(keys)) and the state buffers of two runs from
    ``start``; ``yard`` is the float32 plain version's distance from the
    float64 run by part, printed beside.  Fails beyond the K2 trajectory
    tolerances (``part_rtol``, default K2_PART_RTOL); where the float32 plain
    version's own rows are further from float64's than K2_ROWS_RTOL
    (``rows_yard``: the second G passes detached, where the trajectories
    drift fastest), the rows are held to four times that.  Returns
    (rows max rel err, max |err| of G's and D's parameters outside the gauge
    leaves)."""
    from pigan_thz_torch.ops import gan_train as gt

    counts = [keys.index(k) for k in ("d_accuracy", "violation_rate")]
    floats = [j for j in range(len(keys)) if j not in counts]
    cnt = float((rows[:, counts] - want_rows[:, counts]).abs().max())
    rel = float(row_errors(rows, want_rows, keys, spec.wgan)[:, floats].max())
    diffs = gt.state_diffs(bufs, want_bufs, start, spec)
    parts = ", ".join(f"{k} {a:.3e}/{r:.3e} (float32 plain to float64 {yard[k][1]:.3e})"
                      for k, (a, r) in diffs.items())
    rows_rtol = max(K2_ROWS_RTOL, 4.0 * rows_yard)
    part_rtol = part_rtol or K2_PART_RTOL
    print(f"{label}: rows max rel err {rel:.3e} (rtol {rows_rtol:.3g}), counts max|err| "
          f"{cnt:.4f} (atol {K2_COUNT_ATOL:.4f}); max|err| / L2 relative to the change, by "
          f"part: {parts} (within {part_rtol})")
    far = {k: r for k, (_, r) in diffs.items() if not r <= part_rtol[k]}
    if far or not (rel <= rows_rtol and cnt <= K2_COUNT_ATOL):
        fail(f"{label}: outside tolerance; parts beyond their limit: {far}")
    return rel, max(diffs["g"][0], diffs["d"][0])


def first_steps(streams, n: int, axis: int = 0):
    """The first ``n`` steps of a chunk's streams; ``axis`` is the step axis
    of the batch streams (1 under a leading member axis)."""
    cut = (slice(None),) * axis + (slice(0, n),)

    def first(t):
        return None if t is None else t[cut].contiguous()

    return streams._replace(spectra=first(streams.spectra), params=first(streams.params),
                            metrics_norm=first(streams.metrics_norm),
                            sched=streams.sched[:n], inoise=first(streams.inoise),
                            stab=first(streams.stab), eps=first(streams.eps))


def k2_first_steps(label: str, state, streams, spec, n: int,
                   floor: float | None = None) -> float:
    """The first ``n`` steps from ``state`` through the kernel, the float32
    plain version and the float64 plain version; returns the kernel's
    largest relative error in a tensor of Adam's first moments."""
    from pigan_thz_torch.ops import gan_train as gt

    few = first_steps(streams, n)
    kern = gt.state_buffers(state.clone())
    rows = gt.gan_train(kern, few, spec)
    return first_steps_against_float64(label, state, few, spec, n, rows, kern, floor)


def tensor_kind(key: str) -> str:
    """"g_m[0]" -> "m", "g_ema[2]" -> "ema", "bn[1]" -> "bn"."""
    return key.split("[")[0].split("_")[-1]


def step_violations(e_k: dict, e_p: dict, floor) -> dict:
    """The tensors of ``step_errors`` on which the kernel (``e_k``) is further
    from float64 than K2_ROUNDING times the float32 plain version (``e_p``)
    and than ``floor``, a number or one per kind of tensor."""
    def limit(key):
        if not isinstance(floor, dict):
            return floor
        return floor.get(key.split("[")[0], floor[tensor_kind(key)])

    return {k: (e_k[k], e_p[k]) for k in e_k
            if not e_k[k] <= max(K2_ROUNDING * e_p[k], limit(k))}


def first_steps_against_float64(label: str, state, few, spec, n: int, rows, kern,
                                floor=None) -> float:
    """``rows`` and ``kern``: what a kernel made of the ``n`` steps ``few``
    from ``state``.  Runs the float32 and the float64 plain version from the
    same state and holds the kernel to the float32 one's distance from
    float64, tensor by tensor, or to ``floor`` (default K2_STEP_FLOOR[n]; a
    dict gives one per kind of tensor); returns the kernel's largest relative
    error in a tensor of Adam's first moments."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt

    floor = K2_STEP_FLOOR[n] if floor is None else floor
    start = gt.state_buffers(state)
    plain = gt.state_buffers(state.clone())
    exact = gt.to_double(gt.state_buffers(state.clone()))
    rows_p = gt.gan_train_plain(plain, few, spec)
    rows64 = gt.gan_train_plain(exact, gt.to_double(few), spec)
    torch.cuda.synchronize()
    counts = [gt.METRIC_KEYS.index(k) for k in ("d_accuracy", "violation_rate")]
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    off = row_errors(rows, rows64, keys, spec.wgan).amax(dim=0)
    rel = float(off.max())
    rel_p = float(row_errors(rows_p, rows64, keys, spec.wgan).max())
    worst_row = gt.METRIC_KEYS[int(off[:len(gt.METRIC_KEYS)].argmax())]
    rows_rtol = K2_STEP_ROWS_RTOL
    same = torch.equal(rows[:, counts].double(), rows64[:, counts])
    e_k = gt.step_errors(kern, exact, start, spec)
    e_p = gt.step_errors(plain, exact, start, spec)
    bad = step_violations(e_k, e_p, floor)
    worst = {}
    for key, e in e_k.items():
        kind = tensor_kind(key)
        if e >= worst.get(kind, (-1.0,))[0]:
            worst[kind] = (e, e_p[key], key)
    kinds = {"m": "Adam first moments", "v": "second moments", "p": "parameter update",
             "ema": "EMA update", "bn": "BatchNorm stats' update"}
    shown = "; ".join(f"{kinds[k]} {e:.3e} (float32 plain {p:.3e}, {key})"
                      for k, (e, p, key) in worst.items())
    gated = int(n - few.sched[:, 6].sum())
    print(f"{label}, first {n} step(s) ({gated} with D gated off) against float64: rows max "
          f"rel err {rel:.3e} in {worst_row} (float32 plain {rel_p:.3e}; rtol {rows_rtol:.3g}), "
          f"counts equal: {same}; the kernel's "
          f"worst tensor, relative to the change: {shown} (each of {len(e_k)} tensors within "
          f"{K2_ROUNDING}x of the float32 plain version's error or {floor})")
    if bad or not same or rel > rows_rtol:
        fail(f"{label}: the kernel's first {n} step(s) are further from float64 than "
             f"rounding explains: {bad}")
    return worst["m"][0]


def phase13_k2(cfg, dev, ds, f, cases=None, paths: bool = False) -> dict:
    """K2 against its plain version (and the eager step at the defaults).
    ``cases`` defaults to today's three; with ``paths`` (the second G passes
    and the noise streams) the launch of each chunk is counted, the first
    step with cycle on is held to K2_CYCLE_STEP_FLOOR, three steps to
    K2_PATHS_3_STEP_FLOOR, the rows also to the float32 plain version's own
    drift, and the eager step runs where there on "cycle through F", "all
    four" and "WGAN-GP through F" (from the same seeds: the same noise).
    Under WGAN-GP the trajectory is the first K2_WGAN_WINDOW steps."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.data.dataset import gather_batch
    from pigan_thz_torch.ops._cuda_build import LAUNCHES
    from pigan_thz_torch.train.steps import make_multi_epoch_fn, make_pigan_step

    b = cfg.train.batch_size
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    stats = {"max_abs_err": 0.0, "rows_rel": 0.0, "first_step_rel": 0.0}
    if cases is None:
        cases = (("through F", dict(detach_forward=False)),
                 ("detached", dict(detach_forward=True)), ("knob mix", K2_MIX))
    floats = [j for j, k in enumerate(keys) if k not in ("d_accuracy", "violation_rate")]
    for name, knobs in cases:
        state, (gtx, dtx), settings, spec, idx, seeds, scales, streams = k2_setup(
            cfg, dev, ds, f, K2_EPOCHS, knobs)
        label = f"K2 vs plain, {name}"
        for n in K2_STEP_FLOOR:
            floor = None
            if paths:
                floor = K2_PATHS_3_STEP_FLOOR if n == 3 else (
                    K2_CYCLE_STEP_FLOOR if spec.cycle_w else None)
            err = k2_first_steps(label, state, streams, spec, n, floor)
            stats["first_step_rel"] = max(stats["first_step_rel"], err)
        # under WGAN-GP the first K2_WGAN_WINDOW steps, else the whole chunk
        if spec.wgan:
            streams = first_steps(streams, K2_WGAN_WINDOW)
        steps = streams.spectra.shape[0]
        d_steps = int(streams.sched[:, 6].sum())
        start = gt.state_buffers(state)
        kern, plain, again = state.clone(), state.clone(), state.clone()
        exact = gt.to_double(gt.state_buffers(state.clone()))
        before = LAUNCHES["gan_train"]
        rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
        torch.cuda.synchronize()
        if LAUNCHES["gan_train"] != before + 1:
            fail(f"{label}: a chunk of {steps} steps was not one launch")
        if not bool(torch.isfinite(rows).all()):
            fail(f"{label}: non-finite metric rows")
        want = gt.gan_train_plain(gt.state_buffers(plain), streams, spec)
        want64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
        torch.cuda.synchronize()
        if LAUNCHES["gan_train"] != before + 1:
            fail(f"{label}: the plain version launched the kernel")
        yard = gt.state_diffs(gt.state_buffers(plain), exact, start, spec)
        rows_yard = float(row_errors(want, want64, keys, spec.wgan)[:, floats].max()
                          ) if paths else 0.0
        rel, err = compare_k2(f"{label}, {steps} steps ({d_steps} D updates)", rows,
                              gt.state_buffers(kern), want, gt.state_buffers(plain), start,
                              yard, spec, keys, rows_yard)
        stats["rows_rel"] = max(stats["rows_rel"], rel)
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        rows2 = gt.gan_train(gt.state_buffers(again), streams, spec)
        torch.cuda.synchronize()
        same = torch.equal(rows2, rows) and all(
            map(torch.equal, k2_state_tensors(again), k2_state_tensors(kern)))
        if not same:
            fail(f"K2 rerun from the same state differs ({name})")
        print(f"K2 {name}: a rerun from the same state is bit-identical")
        if knobs is not K2_MIX and (not paths or name.startswith("all four")
                                    or name in ("cycle through F", "WGAN-GP through F")):
            step_fn = make_pigan_step(gtx, dtx, settings, ds.param_lo, ds.param_hi)
            if spec.wgan:       # the window's steps one by one: per-step rows
                est, per = state.clone(), []
                for t in range(steps):
                    est, m = step_fn(est, gather_batch(ds, idx[0, t].to(dev)),
                                     scales[0].to(dev), int(seeds[t]))
                    per.append(torch.stack([m[k] for k in gt.METRIC_KEYS]))
                got_rows, eager_rows = rows[:, :len(gt.METRIC_KEYS)], torch.stack(per)
                what = f"{steps} steps (per-step rows)"
            else:
                est, ms = make_multi_epoch_fn(step_fn, b)(state.clone(), ds, scales,
                                                          indices=idx, seeds=seeds)
                got = gt.epoch_means(rows, K2_EPOCHS, False)
                got_rows = torch.stack([got[k] for k in gt.METRIC_KEYS], 1)
                eager_rows = torch.stack([ms[k] for k in gt.METRIC_KEYS], 1)
                what = f"{K2_EPOCHS} epochs (per-epoch rows)"
            torch.cuda.synchronize()
            if (est.step, est.g_opt.count, est.d_opt.count) != (steps, steps, d_steps):
                fail(f"the eager step counted {est.step} steps, {est.g_opt.count} G and "
                     f"{est.d_opt.count} D updates, the streams {steps}, {steps}, {d_steps}")
            compare_k2(f"K2 vs the eager autograd step, {name}, {what}", got_rows,
                       gt.state_buffers(kern), eager_rows, gt.state_buffers(est), start, yard,
                       spec, list(gt.METRIC_KEYS), rows_yard)
    return stats


def phase19_faults(cfg, dev, ds, f, faults=K2_FAULTS, paths=K2_PATHS,
                   augmentation: bool = True) -> None:
    """The first-step check against plain versions that are wrong on purpose,
    one fault per path: it must see each."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt

    paths = dict(paths)
    for name, fault, change in faults:
        knobs = {**paths[name], **change}
        state, _, settings, spec, _, _, _, streams = k2_setup(cfg, dev, ds, f, 1, knobs)
        few = first_steps(streams, 1)
        kern = gt.state_buffers(state.clone())
        gt.gan_train(kern, few, spec)
        plain = gt.state_buffers(state.clone())
        right = gt.to_double(gt.state_buffers(state.clone()))
        wrong = gt.to_double(gt.state_buffers(state.clone()))
        gt.gan_train_plain(plain, few, spec)
        gt.gan_train_plain(right, gt.to_double(few), spec)
        gt.gan_train_plain(wrong, gt.to_double(few), spec, faults=[fault])
        torch.cuda.synchronize()
        start = gt.state_buffers(state)
        floor = K2_CYCLE_STEP_FLOOR if spec.cycle_w else K2_STEP_FLOOR[1]
        # the float32 plain version's distance from the RIGHT float64 run is
        # the yardstick in both comparisons, as in the check itself
        e_p = gt.step_errors(plain, right, start, spec)
        e_ok = gt.step_errors(kern, right, start, spec)
        e_off = gt.step_errors(kern, wrong, start, spec)
        passes, fails = step_violations(e_ok, e_p, floor), step_violations(e_off, e_p, floor)
        worst = max(fails, key=lambda k: fails[k][0], default=None)
        print(f"K2 {name}, the kernel's first step against the float64 plain version with "
              f"'{fault}': {len(fails)} of {len(e_off)} tensors beyond their limit"
              + (f", the worst {worst} at {fails[worst][0]:.3e} of the change (against the "
                 f"right run {e_ok[worst]:.3e})" if worst else "")
              + f"; against the right run {len(passes)} beyond")
        if passes or not fails:
            fail(f"the first-step check does not see '{fault}' on the path {name}")
    if not augmentation:
        return
    # augmentation's fault lives in the streams: the recon target is the
    # augmented batch, so the plain version on the clean batch must disagree
    state, _, settings, spec, idx, _, _, streams = k2_setup(cfg, dev, ds, f, 1,
                                                           dict(paths["augmentation"]))
    few = first_steps(streams, 1)
    clean = few._replace(spectra=ds.spectra[idx[0, :1].to(dev)].contiguous())
    rows = gt.gan_train(gt.state_buffers(state.clone()), few, spec)
    want = gt.gan_train_plain(gt.state_buffers(state.clone()), clean, spec)
    j = gt.METRIC_KEYS.index("recon_spec_loss")
    got, other = float(rows[0, j]), float(want[0, j])
    print(f"K2 augmentation: recon_spec_loss on the augmented stream {got:.6f}, the plain "
          f"version on the clean batch {other:.6f}; spectra stay <= 0 dB: "
          f"{float(few.spectra.max()) <= 0.0}")
    if abs(got - other) <= 1e-2 * other or float(few.spectra.max()) > 0.0:
        fail("the augmented stream is not what the kernel reconstructs")


def phase14_train(cfg, dev, repo: str, ds_serving, request, train_ds, fixed: bool,
                  extra: tuple = ()) -> dict:
    """``train --mode full`` at the reference workload in a subprocess, as
    typed (the PI-GAN phase with F's input detached) or, with ``fixed``,
    with ``--fixed-physics`` (gradients through the frozen F); the trained G
    and F then serve one request.  Returns its launches, wall time and
    metric curves."""
    import glob
    import torch
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.ops.metrics import r2_score
    from pigan_thz_torch.serve import make_inverse_design_fn
    from pigan_thz_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "saved_models")
        cmd = [sys.executable, "-m", "pigan_thz_torch", "train", "--mode", "full",
               *(["--fixed-physics"] if fixed else []),
               "--forward-epochs", str(PRETRAIN_EPOCHS),
               "--epochs", str(GAN_EPOCHS), "--workdir", tmp, "--out", out,
               "--no-tensorboard", *extra]
        name = "train --mode full" + (" --fixed-physics" if fixed else "") + "".join(
            f" {a}" for a in extra)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{' '.join(cmd[1:6])} exited {proc.returncode}: {proc.stderr[-3000:]}")
        launches = launches_line(proc.stdout, "train")
        shown = ("-training kernel", "eager step", f"epoch {PRETRAIN_EPOCHS}/",
                 f"epoch {GAN_EPOCHS}/")
        for line in proc.stdout.splitlines():
            if any(key in line for key in shown):
                print(f"{name}: {line}")
        want = {"forward_train": -(-PRETRAIN_EPOCHS // EPOCHS_PER_CALL),
                "gan_train": -(-GAN_EPOCHS // EPOCHS_PER_CALL)}
        print(f"{name}: {PRETRAIN_EPOCHS} + {GAN_EPOCHS} epochs in {wall:.3f} s "
              f"wall, launches {launches}")
        for kernel, n in want.items():
            if launches.get(kernel) != n:
                fail(f"{name} launched {kernel} {launches.get(kernel)} times, not once per "
                     f"{EPOCHS_PER_CALL}-epoch chunk ({n})")

        runs = glob.glob(os.path.join(tmp, "train_full_*", "scalars.jsonl"))
        with open(runs[0]) as fh:
            records = [json.loads(line) for line in fh]
        curves = {}
        for r in records:
            if r["tag"].startswith("pigan/"):
                curves.setdefault(r["tag"][len("pigan/"):], []).append(r["value"])
        finite = all(x == x and abs(x) != float("inf") for v in curves.values() for x in v)
        for key in ("d_loss", "g_loss", "d_accuracy", "recon_spec_loss", "violation_rate"):
            v = curves.get(key, [])
            if len(v) != GAN_EPOCHS:
                fail(f"train logged {len(v)} epochs of pigan/{key}, not {GAN_EPOCHS}")
            marks = sorted({0, len(v) // 5, len(v) // 2, len(v) - 1})
            print(f"{name}: pigan/{key} per epoch "
                  + ", ".join(f"{v[i]:.6f} ({i + 1})" for i in marks))
        recon = curves["recon_spec_loss"]
        print(f"{name}: all {len(curves)} pigan curves finite: {finite}")
        # with F's input detached the reconstruction loss sends G no gradient:
        # its fall is held only where gradients flow through F
        if not finite or (fixed and not recon[-1] < 0.5 * recon[0]):
            fail(f"{name}: rows are not finite or recon_spec_loss did not halve")
        history = ckpt.load_train_history(out)
        if history is None or len(history.get("pigan/g_loss", [])) != GAN_EPOCHS:
            fail("training_history.json does not hold the run's curves")

        G, D, F = build_trio(cfg, device="cpu")
        ckpt.load_final_trio(out, G, D, F)
    G, F = G.to(dev).eval(), F.to(dev).eval()

    before = dict(fk.LAUNCHES)
    params, spec, met = make_inverse_design_fn(G, F, ds_serving)(request)
    torch.cuda.synchronize()
    served = {k: fk.LAUNCHES[k] - before[k] for k in before}
    b = request.shape[0]
    lo, hi = cfg.data.param_min, cfg.data.param_max
    ok = (tuple(params.shape) == (b, 4) and tuple(spec.shape) == (b, cfg.data.spectrum_dim)
          and tuple(met.shape) == (b, 8)
          and all(bool(torch.isfinite(t).all()) for t in (params, spec, met))
          and bool(((params >= lo) & (params <= hi)).all()))
    print(f"{name}: the trained G and F serve a B={b} request: launches {served}, finite "
          f"outputs of the right shapes with params in [{params.min().item():.4f}, "
          f"{params.max().item():.4f}]: {ok}")
    if not ok or served["fused_mlp_forward"] != 1 or served["fused_dense_chain"] != 1:
        fail("the trained generator and surrogate did not serve a request through K6 and K5")
    with torch.inference_mode():
        pred = G(train_ds.spectra).float()
        r2 = float(r2_score(train_ds.params_norm, pred))
        recon_r2 = float(r2_score(train_ds.spectra, F(pred)[0].float()))
    print(f"{name}: R2 of G's normalised params over the {train_ds.num_samples} training "
          f"samples {r2:.4f} (the JAX package records 0.9792 for the --fixed-physics "
          f"recipe, RESULTS.md); R2 of F(G(s)) against s {recon_r2:.4f} (printed, not gated)")
    return {"launches": launches, "wall": wall, "curves": curves, "r2": r2}


def phase15_k2_times(cfg, dev, ds, f) -> dict:
    """Per-epoch CUDA-event medians (ms) of K2, its plain version and the
    eager step in both detach modes: {detach: (kernel, plain, eager)}; and a
    torch.profiler breakdown of one through-F K2 launch of 5 epochs."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.train.steps import make_multi_epoch_fn, make_pigan_step

    out = {}
    for detach in (False, True):
        state, (gtx, dtx), settings, spec, idx, seeds, scales, streams = k2_setup(
            cfg, dev, ds, f, 1, dict(detach_forward=detach))
        kern, plain = gt.state_buffers(state.clone()), gt.state_buffers(state.clone())
        est = state.clone()
        eager = make_multi_epoch_fn(
            make_pigan_step(gtx, dtx, settings, ds.param_lo, ds.param_hi),
            cfg.train.batch_size)

        def k():
            gt.gan_train(kern, streams, spec)

        def p():
            gt.gan_train_plain(plain, streams, spec)

        def e():
            eager(est, ds, scales, indices=idx, seeds=seeds)

        # plain, eager, kernel, kernel, eager, plain: the best of each side's two
        p1 = cuda_median_ms(p, warmup=1, reps=5)
        e1 = cuda_median_ms(e, warmup=1, reps=5)
        k1 = cuda_median_ms(k, warmup=3, reps=20)
        k2 = cuda_median_ms(k, warmup=3, reps=20)
        e2 = cuda_median_ms(e, warmup=1, reps=5)
        p2 = cuda_median_ms(p, warmup=1, reps=5)
        out[detach] = (min(k1, k2), min(p1, p2), min(e1, e2))

    # one launch of 5 epochs under the profiler, after 2 warm-up launches
    state, _, _, spec, _, _, _, streams = k2_setup(cfg, dev, ds, f, 5,
                                                    dict(detach_forward=False))
    bufs = gt.state_buffers(state)
    out["profile"] = profile_launch("one K2 launch of 5 epochs",
                                    lambda: gt.gan_train(bufs, streams, spec),
                                    streams.spectra.shape[0])
    return out


def profile_launch(label: str, launch, steps: int) -> tuple:
    """``launch()`` (one kernel launch of ``steps`` steps, gradients through
    F) under ``torch.profiler`` after 2 warm-up launches: prints the wall
    time, the kernel time, the idle share and the kernels by time; returns
    (wall ms, kernel ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(ev.key, ev.count, getattr(ev, "device_time_total",
                                          getattr(ev, "cuda_time_total", 0.0)))
               for ev in prof.key_averages()
               if getattr(ev, "device_type", None) is not None
               and "cuda" in str(ev.device_type).lower()]
    busy_ms = sum(t for _, _, t in kernels) / 1e3
    print(f"profile: {label} ({steps} steps, through F): {wall_ms:.3f} ms "
          f"wall, {busy_ms:.3f} ms of kernel time, idle share "
          f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}, "
          f"{sum(c for _, c, _ in kernels) / steps:.1f} kernels a step")
    for key, count, total in sorted(kernels, key=lambda r: -r[2])[:14]:
        print(f"profile:   {total / 1e3:9.3f} ms  {count:6d} calls  {total / count:8.2f} us  "
              f"{key[:100]}")
    return wall_ms, busy_ms


def k3_setup(cfg, dev, ds, f, epochs: int, knobs: dict, members: int):
    """``members`` seeded full-width members on the card, stacked (member m
    from seed SEED + m: its own G, D, BatchNorm stats and shuffles; F a copy
    of ``f``, shared), the settings, the kernel's spec and the stacked
    streams of ``epochs`` epochs of ``ds``."""
    import torch
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.parallel.state_utils import tree_stack
    from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule
    from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
    from pigan_thz_torch.train.steps import StepSettings

    b = cfg.train.batch_size
    spe = ds.num_samples // b
    settings = StepSettings.from_config(cfg, **knobs)
    gtx, dtx, _ = make_optimizers(cfg, spe)
    g, d, _ = build_trio(cfg, device="cpu")
    states, idx, seeds = [], [], []
    for m in range(members):
        st = init_pigan_state(g, d, f, gtx, dtx, SEED + m, device=dev)
        perturb_batch_stats_(st.g, torch.Generator().manual_seed(SEED + m))
        states.append(st)
        drawn = ft.resolve_draws(torch.Generator().manual_seed(SEED + m), ds.num_samples,
                                 b, epochs)
        idx.append(drawn[0])
        seeds.append(drawn[1])
    ens = tree_stack(states)
    if not ens.shared_f:
        fail("k3_setup: the members' copies of one F are not shared after stacking")
    streams = gt.build_streams(
        ds, torch.stack(idx), torch.linspace(1.0, 0.5, epochs), 0, 0, 0,
        settings.d_update_every,
        cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01),
        step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25),
        settings=settings, seeds=torch.stack(seeds))
    return ens, settings, gt.gan_train_spec(cfg, settings), streams


def ensemble_tensors(bufs) -> list:
    """Every tensor a K3 chunk updates in place (stacked or one member's)."""
    return [*bufs[:6], *bufs.bn]


def phase16_k3(cfg, dev, ds, f, cases=None) -> dict:
    """K3 against K2 on each member alone (bit for bit) and against its plain
    version (K2's limits).  ``cases`` defaults to today's three; a case with
    cycle on holds every member's first step to K2_CYCLE_STEP_FLOOR and the
    rows also to the float32 plain version's own drift."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.ops._cuda_build import LAUNCHES

    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    stats = {"max_abs_err": 0.0, "rows_rel": 0.0, "first_step_rel": 0.0}
    if cases is None:
        cases = (("through F", dict(detach_forward=False)),
                 ("detached", dict(detach_forward=True)), ("knob mix, no EMA", K3_MIX))
    floats = [j for j, k in enumerate(keys) if k not in ("d_accuracy", "violation_rate")]
    for name, knobs in cases:
        start, settings, spec, streams = k3_setup(cfg, dev, ds, f, K2_EPOCHS, knobs,
                                                  K3_MEMBERS)
        steps = streams.spectra.shape[1]
        d_steps = int(streams.sched[:, 6].sum())
        kern, plain, again = start.clone(), start.clone(), start.clone()
        before = dict(LAUNCHES)
        rows = gt.gan_ensemble_train(gt.ensemble_buffers(kern), streams, spec)
        torch.cuda.synchronize()
        if (LAUNCHES["gan_ensemble_train"] != before["gan_ensemble_train"] + 1
                or LAUNCHES["gan_train"] != before["gan_train"]):
            fail(f"K3 {name}: {K3_MEMBERS} members did not train in exactly one K3 launch")
        if tuple(rows.shape) != (K3_MEMBERS, steps, gt.ROW_WIDTH) or not bool(
                torch.isfinite(rows).all()):
            fail(f"K3 {name}: rows of shape {tuple(rows.shape)} or not finite")
        if any(torch.equal(rows[0], rows[m]) for m in range(1, K3_MEMBERS)):
            fail(f"K3 {name}: two members have the same rows")

        # bit for bit K2 on each member alone, from the same state and streams
        for m in range(K3_MEMBERS):
            solo = start[m].clone()
            got, own = gt._member(gt.ensemble_buffers(kern), streams, m)
            want = gt.gan_train(gt.state_buffers(solo), own, spec)
            torch.cuda.synchronize()
            same = torch.equal(rows[m], want) and all(map(
                torch.equal, ensemble_tensors(got), ensemble_tensors(gt.state_buffers(solo))))
            if not same:
                fail(f"K3 {name}: member {m} differs from K2 on that member alone")
        print(f"K3 {name}: one launch for {K3_MEMBERS} members, {steps} steps ({d_steps} D "
              f"updates); every member's rows and state (G, D, four moments, BatchNorm "
              f"stats) bit-identical to K2 on that member alone")

        rows2 = gt.gan_ensemble_train(gt.ensemble_buffers(again), streams, spec)
        torch.cuda.synchronize()
        if not (torch.equal(rows2, rows) and all(map(
                torch.equal, ensemble_tensors(gt.ensemble_buffers(again)),
                ensemble_tensors(gt.ensemble_buffers(kern))))):
            fail(f"K3 rerun from the same state differs ({name})")
        print(f"K3 {name}: a rerun from the same state is bit-identical")

        # against the plain version (a loop of K2's plain version), K2's limits
        before = dict(LAUNCHES)
        want = gt.gan_ensemble_train_plain(gt.ensemble_buffers(plain), streams, spec)
        torch.cuda.synchronize()
        if LAUNCHES != before:
            fail("K3's plain version launched a kernel")
        for m in range(K3_MEMBERS):
            own = gt._member(gt.ensemble_buffers(start), streams, m)[1]
            exact = gt.to_double(gt.state_buffers(start[m].clone()))
            want64 = gt.gan_train_plain(exact, gt.to_double(own), spec)
            start_m = gt.state_buffers(start[m])
            yard = gt.state_diffs(gt.state_buffers(plain[m]), exact, start_m, spec)
            rows_yard = float(((want[m] - want64).abs() / want64.abs().clamp(min=1e-3))[
                :, floats].max()) if spec.cycle_w or spec.stability_w else 0.0
            rel, err = compare_k2(
                f"K3 vs plain, {name}, member {m}, {K2_EPOCHS} epochs ({steps} steps)",
                rows[m], gt.state_buffers(kern[m]), want[m], gt.state_buffers(plain[m]),
                start_m, yard, spec, keys, rows_yard)
            stats["rows_rel"] = max(stats["rows_rel"], rel)
            stats["max_abs_err"] = max(stats["max_abs_err"], err)

        # every member's first step against float64
        few = first_steps(streams, 1, axis=1)
        one = start.clone()
        rows1 = gt.gan_ensemble_train(gt.ensemble_buffers(one), few, spec)
        for m in range(K3_MEMBERS):
            got, own = gt._member(gt.ensemble_buffers(one), few, m)
            err = first_steps_against_float64(
                f"K3 vs plain, {name}, member {m}", start[m], own, spec, 1, rows1[m], got,
                floor=K2_CYCLE_STEP_FLOOR if spec.cycle_w else (
                    None if m == 0 else K3_MEMBER_STEP_FLOOR))
            stats["first_step_rel"] = max(stats["first_step_rel"], err)
    return stats


def run_seed_ensemble(repo: str, tmp: str, tag: str, epochs: int, fwd_epochs: int,
                      unpacked: bool) -> tuple:
    """``examples/torch_seed_ensemble.py`` with K3_MEMBERS members in a
    subprocess; returns (its JSON line, its saved stacked state, wall s)."""
    import torch

    saved = os.path.join(tmp, f"{tag}.pt")
    cmd = [sys.executable, os.path.join("examples", "torch_seed_ensemble.py"), "--members",
           str(K3_MEMBERS), "--epochs", str(epochs), "--fwd-epochs", str(fwd_epochs),
           "--epochs-per-call", str(EPOCHS_PER_CALL), "--save", saved,
           *(["--unpacked"] if unpacked else [])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return out, torch.load(saved, map_location="cpu", weights_only=True), wall


def phase17_ensemble(cfg, dev, repo: str, ds_serving, request) -> dict:
    """The seed-ensemble path at the reference workload in a subprocess; the
    members' mean then serves one request; then packed against unpacked at
    ENSEMBLE_SHORT_EPOCHS.  Returns its launches, wall times and scores."""
    import torch
    from pigan_thz_torch.models import build_forward_model, build_generator
    from pigan_thz_torch.serve import make_ensemble_inverse_design_fn, make_inverse_design_fn

    name = f"torch_seed_ensemble --members {K3_MEMBERS} --epochs {GAN_EPOCHS}"
    chunks = -(-GAN_EPOCHS // EPOCHS_PER_CALL)
    f_chunks = -(-PRETRAIN_EPOCHS // EPOCHS_PER_CALL)
    with tempfile.TemporaryDirectory() as tmp:
        out, saved, wall = run_seed_ensemble(repo, tmp, "main", GAN_EPOCHS, PRETRAIN_EPOCHS,
                                             False)
        launches = out["launches"]
        print(f"{name}: {PRETRAIN_EPOCHS} forward epochs, then {K3_MEMBERS} members x "
              f"{GAN_EPOCHS} epochs in {wall:.3f} s wall for the command "
              f"({out['wall_s']:.3f} s in train_seed_ensemble, "
              f"{out['member_steps_per_s']:.1f} member-steps/s), launches {launches}")
        if (launches.get("forward_train") != f_chunks
                or launches.get("gan_ensemble_train") != chunks or launches.get("gan_train")):
            fail(f"{name}: launches {launches}, not {f_chunks} K1, {chunks} K3 (one per "
                 f"{EPOCHS_PER_CALL}-epoch chunk for all members) and no K2")
        first, last = out["first_recon_spec_loss"], out["final_recon_spec_loss"]
        print(f"{name}: recon_spec_loss per member, first -> last epoch: "
              + ", ".join(f"{a:.6f} -> {b:.6f}" for a, b in zip(first, last))
              + f"; all rows finite: {out['all_rows_finite']}")
        if not out["all_rows_finite"] or len(last) != K3_MEMBERS:
            fail(f"{name}: rows are not finite for every member")
        if not all(b < 0.5 * a for a, b in zip(first, last)):
            fail(f"{name}: a member's recon_spec_loss did not halve")
        if len(set(out["final_g_loss"])) != K3_MEMBERS or len(set(out["member_r2"])) != \
                K3_MEMBERS:
            fail(f"{name}: two members ended alike: {out['final_g_loss']}")
        print(f"{name}: param R2 over the training set per member "
              + ", ".join(f"{x:.4f}" for x in out["member_r2"])
              + f"; of the members' mean {out['ensemble_mean_r2']:.4f}; member spread "
              f"{out['member_spread']:.4f}; recon MSE per member "
              + ", ".join(f"{x:.5f}" for x in out["member_recon_mse"])
              + f", of the mean {out['ensemble_mean_recon_mse']:.5f} (printed, not gated; "
              "one member through K2 reaches 0.98, phase 14)")

        # packed against unpacked at a smaller depth: bit-identical states
        packed, p_state, p_wall = run_seed_ensemble(
            repo, tmp, "packed", ENSEMBLE_SHORT_EPOCHS, ENSEMBLE_SHORT_FWD_EPOCHS, False)
        unpacked, u_state, u_wall = run_seed_ensemble(
            repo, tmp, "unpacked", ENSEMBLE_SHORT_EPOCHS, ENSEMBLE_SHORT_FWD_EPOCHS, True)
    short = -(-ENSEMBLE_SHORT_EPOCHS // EPOCHS_PER_CALL)
    if packed["launches"]["gan_ensemble_train"] != short or unpacked["launches"][
            "gan_train"] != short * K3_MEMBERS or unpacked["launches"]["gan_ensemble_train"]:
        fail(f"packed / unpacked launches {packed['launches']} / {unpacked['launches']}")
    same = all(all(map(torch.equal, p_state[k], u_state[k])) if isinstance(p_state[k], list)
               else torch.equal(p_state[k], u_state[k]) for k in p_state)
    print(f"torch_seed_ensemble at {ENSEMBLE_SHORT_EPOCHS} epochs: packed "
          f"({packed['launches']['gan_ensemble_train']} K3 launches, "
          f"{packed['member_steps_per_s']:.1f} member-steps/s) and --unpacked "
          f"({unpacked['launches']['gan_train']} K2 launches, "
          f"{unpacked['member_steps_per_s']:.1f} member-steps/s): states (G, D, moments, "
          f"BatchNorm stats of {K3_MEMBERS} members, F) bit-identical: {same}")
    if not same or packed["member_r2"] != unpacked["member_r2"]:
        fail("packed and unpacked seed ensembles differ")

    # the trained members serve their mean
    gens = []
    for m in range(K3_MEMBERS):
        g = build_generator(cfg.generator, cfg.data.spectrum_dim, device="cpu")
        torch.nn.utils.vector_to_parameters(saved["g"][m], g.parameters())
        norms = [mod for mod in g.modules() if isinstance(mod, torch.nn.BatchNorm1d)]
        for j, bn in enumerate(norms):
            bn.running_mean.copy_(saved["bn"][2 * j][m])
            bn.running_var.copy_(saved["bn"][2 * j + 1][m])
        gens.append(g.to(dev).eval())
    F = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim,
                            device="cpu")
    torch.nn.utils.vector_to_parameters(saved["f"], F.parameters())
    F = F.to(dev).eval()
    params, spec, met = make_ensemble_inverse_design_fn(gens, F, ds_serving)(request)
    own = torch.stack([make_inverse_design_fn(g, F, ds_serving)(request)[0] for g in gens])
    torch.cuda.synchronize()
    b = request.shape[0]
    lo, hi = cfg.data.param_min, cfg.data.param_max
    ok = (tuple(params.shape) == (b, 4) and tuple(spec.shape) == (b, cfg.data.spectrum_dim)
          and tuple(met.shape) == (b, 8)
          and all(bool(torch.isfinite(t).all()) for t in (params, spec, met))
          and bool(((params >= lo) & (params <= hi)).all()))
    err = float((params - own.mean(dim=0)).abs().max())
    apart = float((own - own.mean(dim=0)).abs().max())
    print(f"{name}: the members' mean serves a B={b} request: finite outputs of the right "
          f"shapes with params in [{params.min().item():.4f}, {params.max().item():.4f}]: "
          f"{ok}; max|err| against the mean of the members' own served params (K6) "
          f"{err:.3e} (tol {K6_TOL}); the members are up to {apart:.3e} from their mean")
    if not ok or not err <= K6_TOL or not apart > 10 * K6_TOL:
        fail("the ensemble mean was not served inside the design box as the members' mean")
    extra = {k: packed["launches"][k] + unpacked["launches"][k] for k in launches}
    return {"launches": launches, "short_launches": extra, "wall": wall, "out": out,
            "short": (packed["member_steps_per_s"], unpacked["member_steps_per_s"])}


def phase18_k3_times(cfg, dev, ds, f) -> dict:
    """Per-epoch CUDA-event medians (ms), gradients through F: K3 at each M
    of K3_TIME_MEMBERS with K2 timed before and after in the same call, K3
    detached and K3's plain version at M = K3_MEMBERS; then a profile of one
    K3 launch of 5 epochs at M = K3_MEMBERS."""
    from pigan_thz_torch.ops import gan_train as gt

    state, _, _, spec, _, _, _, streams = k2_setup(cfg, dev, ds, f, 1,
                                                    dict(detach_forward=False))
    solo = gt.state_buffers(state)

    def k2():
        gt.gan_train(solo, streams, spec)

    out = {"k2": [cuda_median_ms(k2, warmup=3, reps=20)], "k3": {}}
    for members in (*K3_TIME_MEMBERS, *reversed(K3_TIME_MEMBERS)):
        ens, _, espec, estreams = k3_setup(cfg, dev, ds, f, 1, dict(detach_forward=False),
                                           members)
        bufs = gt.ensemble_buffers(ens)
        ms = cuda_median_ms(lambda: gt.gan_ensemble_train(bufs, estreams, espec),
                            warmup=3, reps=20)
        out["k3"][members] = min(ms, out["k3"].get(members, ms))
    out["k2"].append(cuda_median_ms(k2, warmup=3, reps=20))

    ens, _, espec, estreams = k3_setup(cfg, dev, ds, f, 1, dict(detach_forward=False),
                                       K3_MEMBERS)
    bufs = gt.ensemble_buffers(ens)
    out["plain"] = cuda_median_ms(
        lambda: gt.gan_ensemble_train_plain(bufs, estreams, espec), warmup=1, reps=3)
    ens, _, dspec, dstreams = k3_setup(cfg, dev, ds, f, 1, dict(detach_forward=True),
                                       K3_MEMBERS)
    dbufs = gt.ensemble_buffers(ens)
    out["detached"] = cuda_median_ms(
        lambda: gt.gan_ensemble_train(dbufs, dstreams, dspec), warmup=3, reps=20)

    ens, _, pspec, pstreams = k3_setup(cfg, dev, ds, f, 5, dict(detach_forward=False),
                                       K3_MEMBERS)
    pbufs = gt.ensemble_buffers(ens)
    out["profile"] = profile_launch(
        f"one K3 launch of 5 epochs at M = {K3_MEMBERS}",
        lambda: gt.gan_ensemble_train(pbufs, pstreams, pspec), pstreams.spectra.shape[1])
    return out


def launches_line(stdout: str, what: str) -> dict:
    import ast

    lines = [ln for ln in stdout.splitlines() if ln.startswith("kernel launches: ")]
    if len(lines) != 1:
        fail(f"{what} printed {len(lines)} 'kernel launches' lines")
    return ast.literal_eval(lines[0][len("kernel launches: "):])


def r2_and_violation(ev: dict) -> tuple:
    return (ev["pigan_evaluation"]["parameter_prediction"]["r2"],
            ev["structural_prediction_evaluation"]["param_range_violation_rate"])


def phase21_programs(cfg, dev, repo: str, train_ds) -> dict:
    """The metric-gated programs on the card.  In this process: a Trainer
    with a briefly pretrained F and a fresh G runs ``emergency_phases()``;
    the gate must read param R² < 0.7 from the port's evaluator and
    ``emergency_warmup`` (cycle, ``adv_w`` 0, ``d_update_every`` 2) must go
    through the GAN-training kernel.  Then the three ``program`` commands
    and ``train --preset optimized`` on the baseline trio as typed, each in
    a subprocess.  Returns the launches and wall times."""
    import glob
    import torch
    from pigan_thz_torch.ops._cuda_build import LAUNCHES
    from pigan_thz_torch.train import programs as P
    from pigan_thz_torch.train.trainer import Trainer

    spe = train_ds.num_samples // cfg.train.batch_size
    trainer = Trainer(cfg, ds=train_ds, device=dev)
    trainer.pretrain_forward(epochs=PROGRAM_F_EPOCHS)
    trainer.init_pigan()
    before = trainer.evaluate()
    r2_0, viol_0 = r2_and_violation(before)
    phases = P.emergency_phases()
    if not all(p.gate(before) for p in phases) or not r2_0 < 0.7:
        fail(f"a fresh G reads param R2 {r2_0:.4f}: the emergency gates (R2 < 0.7) stay shut")
    reset_launches(LAUNCHES)
    t0 = time.perf_counter()
    result = P.run_program(trainer, phases)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(LAUNCHES)
    r2_1, viol_1 = r2_and_violation(result.final_eval)
    hist = trainer.train_history
    gan_epochs = len(hist["pigan/g_loss"])
    fwd_epochs = len(hist["forward/loss"]) - PROGRAM_F_EPOCHS
    print(f"run_program(emergency_phases()) on the card: phases run {result.phases_run}, "
          f"skipped {result.phases_skipped}; the evaluator's param R2 {r2_0:.4f} -> "
          f"{r2_1:.4f}, violation rate {viol_0:.4f} -> {viol_1:.4f}; {fwd_epochs} forward "
          f"and {gan_epochs} GAN epochs in {wall:.3f} s; launches {counted}")
    want_gan = -(-gan_epochs // EPOCHS_PER_CALL)
    if (result.phases_run != [p.name for p in phases] or result.phases_skipped
            or counted["gan_train"] != want_gan or counted["forward_train"] < 1
            or gan_epochs != phases[1].epochs + phases[2].epochs):
        fail("emergency_warmup and emergency_balanced_gan did not run through the "
             f"GAN-training kernel, one launch per chunk ({want_gan})")
    finite = all(x == x and abs(x) != float("inf") for v in hist.values() for x in v)
    if not finite or not all(map(lambda x: x == x, (r2_1, viol_1))):
        fail("the emergency program left non-finite rows or scores")
    st = trainer.pigan_state
    if st.d_opt.count >= st.g_opt.count:
        fail("d_update_every=2 did not gate D's updates in the emergency phases")
    out = {"inprocess": counted, "inprocess_wall": wall, "commands": {}}

    with tempfile.TemporaryDirectory() as tmp:
        for name in PROGRAMS:
            work = os.path.join(tmp, name)
            cmd = [sys.executable, "-m", "pigan_thz_torch", "program", name, "--workdir",
                   work, "--no-tensorboard"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"program {name} exited {proc.returncode}: {proc.stderr[-3000:]}")
            launches = launches_line(proc.stdout, f"program {name}")
            ran = [ln for ln in proc.stdout.splitlines() if ln.startswith("phases run: ")]
            (path,) = glob.glob(os.path.join(work, f"program_{name}_*", "final_eval.json"))
            with open(path) as fh:
                ev = json.load(fh)
            r2, viol = r2_and_violation(ev)
            saved = os.path.join(work, "saved_models")
            have = all(os.path.isfile(os.path.join(saved, f"{stem}_{kind}.pth"))
                       for stem in ("generator", "discriminator", "forward_model")
                       for kind in ("final", name))
            print(f"program {name}: {ran[0] if ran else 'no phases line'}; {wall:.3f} s wall "
                  f"for the command; final_eval.json param R2 {r2:.4f}, violation rate "
                  f"{viol:.4f}; finals and their _{name} copies written: {have}; launches "
                  f"{launches}")
            if (len(ran) != 1 or not have or r2 != r2 or viol != viol
                    or launches["gan_train"] < 1):
                fail(f"program {name} did not run its phases through the kernel and write "
                     "its artifacts")
            if name != "finetune" and launches["forward_train"] < 1:
                fail(f"program {name} trained no forward phase through the kernel")
            out["commands"][name] = (launches, wall)

        # the OptimizedTrainer loss mix (stability, constraint, window, through
        # F) on the baseline trio: K2's stability path, as typed
        work = os.path.join(tmp, "optimized")
        saved = os.path.join(work, "saved_models")
        cmd = [sys.executable, "-m", "pigan_thz_torch", "train", "--mode", "full", "--preset",
               "optimized", "--set", "generator.name=mlp", "--set", "discriminator.name=mlp",
               "--workdir", work, "--no-tensorboard"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"train --preset optimized exited {proc.returncode}: {proc.stderr[-3000:]}")
        launches = launches_line(proc.stdout, "train --preset optimized")
        loaded = Trainer(cfg, ds=train_ds, device=dev)
        loaded.load_final(saved)
        r2, viol = r2_and_violation(loaded.evaluate())
        hist = loaded.train_history
        epochs = len(hist["pigan/g_loss"]) + len(hist["forward/loss"])
        finite = all(x == x and abs(x) != float("inf") for v in hist.values() for x in v)
        print(f"train --mode full --preset optimized --set generator.name=mlp --set "
              f"discriminator.name=mlp: {len(hist['forward/loss'])} + "
              f"{len(hist['pigan/g_loss'])} epochs in {wall:.3f} s wall for the command, "
              f"{epochs * spe / wall:.1f} steps/s; launches {launches}; param R2 {r2:.4f}, "
              f"violation rate {viol:.4f}; constraint_loss "
              f"{hist['pigan/constraint_loss'][0]:.4f} -> {hist['pigan/constraint_loss'][-1]:.4f}"
              f"; all curves finite: {finite}")
        if (launches["gan_train"] != -(-len(hist["pigan/g_loss"]) // EPOCHS_PER_CALL)
                or launches["forward_train"] < 1 or not finite or r2 != r2):
            fail("train --preset optimized did not train through K1 and K2")
        out["commands"]["optimized"] = (launches, wall)
    return out


def phase22_path_times(cfg, dev, ds, f) -> dict:
    """Per-epoch CUDA-event medians (ms) of K2 with cycle, with stability and
    with both beside today's settings (through F), and of K3 at M =
    K3_MEMBERS with both beside today's, all in this one call, each timed
    twice in turns; the kernels a step of each as the C loop counts them;
    ``torch.profiler``'s idle share for cycle + stability."""
    from pigan_thz_torch.ops import gan_train as gt

    variants = {"today": dict(detach_forward=False),
                "cycle": dict(detach_forward=False, cycle_w=1.0),
                "stability": dict(detach_forward=False, stability_w=1.0),
                "both": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0),
                "detached": dict(detach_forward=True),
                "instance noise": dict(detach_forward=False, instance_noise=0.05)}
    runs = {}
    for name, knobs in variants.items():
        state, _, _, spec, _, _, _, streams = k2_setup(cfg, dev, ds, f, 1, knobs)
        runs[name] = (gt.state_buffers(state), streams, spec)
    out = {"k2": {}, "k3": {}, "launches_a_step": {}}
    order = list(variants)
    for name in (*order, *reversed(order)):
        bufs, streams, spec = runs[name]
        ms = cuda_median_ms(lambda: gt.gan_train(bufs, streams, spec), warmup=3, reps=20)
        out["k2"][name] = min(ms, out["k2"].get(name, ms))
    # the launches a step, as the C loop counts what it enqueues (the
    # profiler's count drops a few events a trace)
    for name in order:
        bufs, streams, spec = runs[name]
        gt.gan_train(bufs, streams, spec)
        out["launches_a_step"][name] = gt.kernels_enqueued() / streams.spectra.shape[0]
    # the idle share as phase 15 takes today's: one launch of 5 epochs
    state, _, _, spec5, _, _, _, streams5 = k2_setup(cfg, dev, ds, f, 5, variants["both"])
    bufs5 = gt.state_buffers(state)
    wall, busy = profile_launch("one K2 launch of 5 epochs, cycle + stability",
                                   lambda: gt.gan_train(bufs5, streams5, spec5),
                                   streams5.spectra.shape[0])
    out["both_idle_share"] = max(0.0, 1.0 - busy / wall)
    ens = {}
    for name in ("today", "both"):
        states, _, spec, streams = k3_setup(cfg, dev, ds, f, 1, variants[name], K3_MEMBERS)
        ens[name] = (gt.ensemble_buffers(states), streams, spec)
    for name in ("today", "both", "both", "today"):
        bufs, streams, spec = ens[name]
        ms = cuda_median_ms(lambda: gt.gan_ensemble_train(bufs, streams, spec),
                            warmup=3, reps=20)
        out["k3"][name] = min(ms, out["k3"].get(name, ms))
    bufs, streams, spec = ens["both"]
    gt.gan_ensemble_train(bufs, streams, spec)
    out["launches_a_step"]["k3 both"] = gt.kernels_enqueued() / streams.spectra.shape[1]
    return out


def bf16_config(cfg):
    import dataclasses

    return cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))


def bf16_rows_over(rows, want) -> dict:
    """Per row key of a first step: |a - b| / |b| over that key's bfloat16
    tolerance (K2_BF16_STEP_RTOL, else K2_BF16_STEP_FLOOR)."""
    from pigan_thz_torch.ops import gan_train as gt

    out = {}
    for j, k in enumerate(gt.METRIC_KEYS):
        if k in ("d_accuracy", "violation_rate"):
            continue
        err = abs(float(rows[0, j]) - float(want[0, j])) / max(abs(float(want[0, j])), 1e-6)
        out[k] = err / K2_BF16_STEP_RTOL.get(k, K2_BF16_STEP_FLOOR)
    return out


def phase23_wgan(cfg, dev, ds, f) -> dict:
    """WGAN-GP through K2: phase 13's checks on its paths (first step and
    first three against float64, 30 steps against the float32 plain version,
    one launch, a rerun bit-identical, through F also the eager step), then
    each WGAN-GP fault of the plain version seen by the first-step check."""
    stats = phase13_k2(cfg, dev, ds, f, cases=K2_WGAN_PATHS, paths=True)
    phase19_faults(cfg, dev, ds, f, faults=K2_WGAN_FAULTS, paths=K2_WGAN_PATHS,
                   augmentation=False)
    return stats


def k1_first_moments(spec, m) -> dict:
    """Adam's first moments of F by tensor, the head's spectrum and metrics
    rows apart: {name: flat tensor}."""
    out = {}
    S = spec.spectrum_dim
    for l in range(len(spec.dims) - 1):
        views = spec.views(m, l)
        if l == spec.n_hidden:
            out["head W spectrum rows"] = views[0][:S]
            out["head W metrics rows"] = views[0][S:]
            out["head b"] = views[1]
        else:
            for name, t in zip(("W", "b", "gamma", "beta"), views):
                out[f"layer {l} {name}"] = t
    return {k: t.reshape(-1).double() for k, t in out.items()}


def phase24_bf16(cfg, dev, ds, f) -> dict:
    """bfloat16 operands in K1 and K2 against their plain versions with the
    same rounding, the distance from the float64-accumulating plain version
    beside; each bfloat16 fault seen; one launch, reruns bit-identical."""
    import torch
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.ops._cuda_build import LAUNCHES
    from pigan_thz_torch.train.steps import ForwardStepSettings

    bcfg = bf16_config(cfg)
    stats = {}
    # -- K1 -----------------------------------------------------------------
    spec = ft.forward_train_spec(bcfg, ForwardStepSettings())
    if not spec.bf16:
        fail("K1's spec does not read train.compute_dtype")
    state, _, _, _, streams = k1_setup(bcfg, dev, ds, K1_EPOCHS)
    start = (state.params.clone(), state.opt.m.clone(), state.opt.v.clone())
    one = streams._replace(params_norm=streams.params_norm[:1].contiguous(),
                           spectra=streams.spectra[:1].contiguous(),
                           metrics_norm=streams.metrics_norm[:1].contiguous(),
                           sched=streams.sched[:1], seeds=streams.seeds[:1])

    def run(streams_, dbl=False, faults=()):
        bufs = [t.clone().double() if dbl else t.clone() for t in start]
        if faults or dbl:
            rows = ft.forward_train_plain(*bufs, streams_, spec, faults=faults)
        else:
            rows = ft.forward_train(*bufs, streams_, spec)
        return rows, bufs

    before = LAUNCHES["forward_train"]
    rows_k, kern = run(one)
    torch.cuda.synchronize()
    if LAUNCHES["forward_train"] != before + 1:
        fail("K1 in bfloat16: one step was not one launch")
    plain = [t.clone() for t in start]
    rows_p = ft.forward_train_plain(*plain, one, spec)
    rows_x, exact = run(one, dbl=True)

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))

    mk, mp, mx = (k1_first_moments(spec, x[1]) for x in (kern, plain, exact))
    e_k = {k: rel(mk[k], mx[k]) for k in mx}
    e_p = {k: rel(mp[k], mx[k]) for k in mx}
    bad = {k: (e_k[k], e_p[k]) for k in mx if not e_k[k] <= max(K2_ROUNDING * e_p[k],
                                                                  K1_BF16_STEP_FLOOR)}
    row_k = float(((rows_k.double() - rows_x).abs() / rows_x.abs()).max())
    row_p = float(((rows_p.double() - rows_x).abs() / rows_x.abs()).max())
    worst = max(e_k, key=e_k.get)
    print(f"K1 bf16, first step against the float64-accumulating plain version: rows max rel "
          f"err kernel {row_k:.3e}, float32 plain {row_p:.3e}; Adam's first moments by "
          f"tensor, worst {worst} kernel {e_k[worst]:.3e} (float32 plain {e_p[worst]:.3e}); "
          f"head metrics rows kernel {e_k['head W metrics rows']:.3e} (float32 plain "
          f"{e_p['head W metrics rows']:.3e}); {len(bad)} of {len(e_k)} tensors beyond "
          f"{K2_ROUNDING}x the float32 plain version or {K1_BF16_STEP_FLOOR}")
    if bad or row_k > max(1e-4, K2_ROUNDING * row_p):
        fail(f"K1 in bfloat16: the first step is further from float64 than rounding: {bad}")
    stats["k1_first_step_rel"] = max(e_k.values())
    for fault in ft.FAULTS:
        _, wrong = run(one, dbl=True, faults=(fault,))
        mw = k1_first_moments(spec, wrong[1])
        ratio = {k: rel(mk[k], mw[k]) / max(e_k[k], e_p[k], 1e-9) for k in mw}
        seen = max(ratio, key=ratio.get)
        print(f"K1 bf16 against the float64 plain version with '{fault}': the kernel is "
              f"{ratio[seen]:.1f}x further from it than from the right run on {seen} "
              f"({rel(mk[seen], mw[seen]):.3e} of the tensor)")
        if not ratio[seen] > K1_BF16_FAULT_RATIO:
            fail(f"K1's bfloat16 check does not see '{fault}'")
    # 30 steps: against the float32 plain version, float64's distance beside
    rows, kern = run(streams)
    rows2, again = run(streams)
    plain = [t.clone() for t in start]
    want = ft.forward_train_plain(*plain, streams, spec)
    _, exact = run(streams, dbl=True)
    torch.cuda.synchronize()
    if not (torch.equal(rows, rows2) and all(map(torch.equal, kern, again))):
        fail("K1 in bfloat16: a rerun from the same state differs")
    moved = float(torch.linalg.norm(exact[0] - start[0].double()))
    d_k = float(torch.linalg.norm(kern[0].double() - plain[0].double())) / moved
    d_p = float(torch.linalg.norm(plain[0].double() - exact[0])) / moved
    rrel = float(((rows - want).abs() / want.abs()).max())
    print(f"K1 bf16, {rows.shape[0]} steps: rows max rel err against the float32 plain "
          f"version {rrel:.3e}; parameters {d_k:.3e} of the change from it (the float32 plain "
          f"version {d_p:.3e} from the float64-accumulating one); a rerun bit-identical")
    if not (d_k <= K1_BF16_PARAMS_RTOL and rrel <= 5e-2):
        fail(f"K1 in bfloat16 drifts from its plain version beyond {K1_BF16_PARAMS_RTOL} of "
             "the change")
    stats["k1_params_rel"], stats["k1_rows_rel"] = d_k, rrel

    # -- K2 -----------------------------------------------------------------
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    floats = [j for j, k in enumerate(keys) if k not in ("d_accuracy", "violation_rate")]
    stats["k2_first_step_rows"] = 0.0
    stats["k2_parts"] = {}
    for name, knobs in K2_BF16_PATHS:
        state, _, settings, spec, _, _, _, streams = k2_setup(bcfg, dev, ds, f, K2_EPOCHS,
                                                               knobs)
        if not spec.bf16:
            fail("K2's spec does not read train.compute_dtype")
        few = first_steps(streams, 1)
        rows1 = gt.gan_train(gt.state_buffers(state.clone()), few, spec)
        want1 = gt.gan_train_plain(gt.state_buffers(state.clone()), few, spec)
        want1x = gt.gan_train_plain(gt.to_double(gt.state_buffers(state.clone())),
                                    gt.to_double(few), spec)
        right = bf16_rows_over(rows1, want1)
        yard1 = bf16_rows_over(want1, want1x)
        print(f"K2 {name}, first step: rows over their bfloat16 limits, the kernel against "
              f"the float32 plain version {max(right.values()):.3f} (worst "
              f"{max(right, key=right.get)}), the float32 plain version against the "
              f"float64-accumulating one {max(yard1.values()):.3f}")
        if max(right.values()) > 1.0:
            fail(f"K2 {name}: the first step's rows are outside their bfloat16 limits: {right}")
        stats["k2_first_step_rows"] = max(stats["k2_first_step_rows"], max(right.values()))
        # the kernel's first step, tensor by tensor, against the float64-
        # accumulating run, within K2_ROUNDING of the float32 plain version's
        # distance or the floor; each fault seen by the same gate (or, a
        # fault of the forward, by the rows)
        start1 = gt.state_buffers(state)
        kern1 = gt.state_buffers(state.clone())
        gt.gan_train(kern1, few, spec)
        plain1 = gt.state_buffers(state.clone())
        gt.gan_train_plain(plain1, few, spec)
        right64 = gt.to_double(gt.state_buffers(state.clone()))
        gt.gan_train_plain(right64, gt.to_double(few), spec)
        e_ok = gt.step_errors(kern1, right64, start1, spec)
        e_p = gt.step_errors(plain1, right64, start1, spec)
        floor = K2_BF16_TENSOR_FLOOR
        bad = step_violations(e_ok, e_p, floor)
        worst = max(e_ok, key=lambda k: e_ok[k] / max(K2_ROUNDING * e_p[k], floor))
        print(f"K2 {name}, first step against the float64-accumulating plain version, tensor "
              f"by tensor: {len(bad)} of {len(e_ok)} beyond {K2_ROUNDING}x the float32 plain "
              f"version's distance or {floor}; the nearest to its limit {worst} at "
              f"{e_ok[worst]:.3e} (float32 plain {e_p[worst]:.3e}); largest by part: "
              + ", ".join(f"{p} {max(e for k, e in e_ok.items() if k.startswith(p + '[')):.3e}"
                          for p in ("g_m", "g_v", "g_p", "d_m", "d_v", "d_p", "bn")))
        if bad:
            fail(f"K2 {name}: the first bfloat16 step is further from float64 than rounding "
                 f"explains: {bad}")
        stats["k2_first_step_tensors"] = max(
            stats.get("k2_first_step_tensors", 0.0),
            max(e_ok[k] / max(K2_ROUNDING * e_p[k], floor) for k in e_ok))
        # (under WGAN-GP D's seeds do not read G's head: the faults are held
        # on the BCE paths)
        for fault in () if spec.wgan else K2_BF16_FAULTS:
            off = gt.gan_train_plain(gt.state_buffers(state.clone()), few, spec, faults=[fault])
            seen = bf16_rows_over(rows1, off)
            key = max(seen, key=seen.get)
            wrong64 = gt.to_double(gt.state_buffers(state.clone()))
            gt.gan_train_plain(wrong64, gt.to_double(few), spec, faults=[fault])
            beyond = step_violations(gt.step_errors(kern1, wrong64, start1, spec), e_p, floor)
            tk = max(beyond, key=lambda k: beyond[k][0], default=None)
            print(f"K2 {name}, the first step against the plain version with '{fault}': "
                  f"rows {key} {seen[key]:.1f}x its limit; {len(beyond)} of {len(e_ok)} tensors "
                  f"beyond their limit" + (f", the worst {tk} at {beyond[tk][0]:.3e} of the "
                                           f"change (against the right run {e_ok[tk]:.3e})"
                                           if tk else ""))
            if not (seen[key] > 2.0 or beyond):
                fail(f"K2's bfloat16 first-step check does not see '{fault}' ({name})")
        # the trajectory: 30 steps, under WGAN-GP the first K2_WGAN_WINDOW
        if spec.wgan:
            streams = first_steps(streams, K2_WGAN_WINDOW)
        steps = streams.spectra.shape[0]
        start = gt.state_buffers(state)
        kern, plain, again = state.clone(), state.clone(), state.clone()
        exact = gt.to_double(gt.state_buffers(state.clone()))
        before = LAUNCHES["gan_train"]
        rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
        torch.cuda.synchronize()
        if LAUNCHES["gan_train"] != before + 1:
            fail(f"K2 {name}: a chunk was not one launch")
        want = gt.gan_train_plain(gt.state_buffers(plain), streams, spec)
        want64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
        yard = gt.state_diffs(gt.state_buffers(plain), exact, start, spec)
        rows_yard = float(row_errors(want, want64, keys, spec.wgan)[:, floats].max())
        compare_k2(f"K2 vs plain, {name}, {steps} steps", rows, gt.state_buffers(kern), want,
                   gt.state_buffers(plain), start, yard, spec, keys, rows_yard,
                   part_rtol=K2_BF16_PART_RTOL)
        stats["k2_parts"][name] = {k: r for k, (_, r) in gt.state_diffs(
            gt.state_buffers(kern), gt.state_buffers(plain), start, spec).items()}
        rows2 = gt.gan_train(gt.state_buffers(again), streams, spec)
        torch.cuda.synchronize()
        if not (torch.equal(rows2, rows) and all(
                map(torch.equal, k2_state_tensors(again), k2_state_tensors(kern)))):
            fail(f"K2 {name}: a rerun from the same state differs")
        print(f"K2 {name}: one launch; a rerun from the same state is bit-identical")
    return stats


def phase25_k3_slice7(cfg, dev, ds, f) -> None:
    """K3 at M = K3_MEMBERS with WGAN-GP + bfloat16 + cycle + stability, D
    every 2nd step: one launch, every member bit for bit K2 on that member
    alone, a rerun bit-identical."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.ops._cuda_build import LAUNCHES

    bcfg = bf16_config(cfg)
    knobs = {**K3_SLICE7, "d_update_every": 2}
    start, settings, spec, streams = k3_setup(bcfg, dev, ds, f, K2_EPOCHS, knobs, K3_MEMBERS)
    if not (spec.bf16 and spec.wgan and spec.cycle_w and spec.stability_w):
        fail("K3's spec does not carry every path")
    kern, again = start.clone(), start.clone()
    before = dict(LAUNCHES)
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(kern), streams, spec)
    torch.cuda.synchronize()
    if (LAUNCHES["gan_ensemble_train"] != before["gan_ensemble_train"] + 1
            or LAUNCHES["gan_train"] != before["gan_train"]):
        fail("K3 with every path: the members did not train in one K3 launch")
    if not bool(torch.isfinite(rows).all()):
        fail("K3 with every path: non-finite rows")
    for m in range(K3_MEMBERS):
        solo = start[m].clone()
        got, own = gt._member(gt.ensemble_buffers(kern), streams, m)
        want = gt.gan_train(gt.state_buffers(solo), own, spec)
        torch.cuda.synchronize()
        if not (torch.equal(rows[m], want) and all(map(
                torch.equal, ensemble_tensors(got), ensemble_tensors(gt.state_buffers(solo))))):
            fail(f"K3 with every path: member {m} differs from K2 on that member alone")
    rows2 = gt.gan_ensemble_train(gt.ensemble_buffers(again), streams, spec)
    torch.cuda.synchronize()
    if not (torch.equal(rows2, rows) and all(map(
            torch.equal, ensemble_tensors(gt.ensemble_buffers(again)),
            ensemble_tensors(gt.ensemble_buffers(kern))))):
        fail("K3 with every path: a rerun differs")
    print(f"K3 WGAN-GP + bf16 + cycle + stability, D every 2nd step: one launch for "
          f"{K3_MEMBERS} members, {streams.spectra.shape[1]} steps; every member's rows and "
          "state bit-identical to K2 on that member alone; a rerun bit-identical")


def phase27_wgan_train(cfg, dev, train_ds) -> dict:
    """``Trainer.train_pigan`` with WGAN-GP through F (gradients through the
    frozen F, as ``--fixed-physics``) for GAN_EPOCHS epochs in this process,
    after PRETRAIN_EPOCHS of forward pretraining; the launch counts set to 0
    just before and read just after."""
    import torch
    from pigan_thz_torch.ops._cuda_build import LAUNCHES
    from pigan_thz_torch.ops.metrics import r2_score
    from pigan_thz_torch.train.steps import StepSettings
    from pigan_thz_torch.train.trainer import Trainer

    trainer = Trainer(cfg, ds=train_ds, device=dev)
    trainer.pretrain_forward(epochs=PRETRAIN_EPOCHS)
    trainer.init_pigan()
    settings = StepSettings.from_config(cfg, detach_forward=False, gan_loss="wgan_gp")
    reset_launches(LAUNCHES)
    t0 = time.perf_counter()
    hist = trainer.train_pigan(epochs=GAN_EPOCHS, settings=settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(LAUNCHES)
    st = trainer.pigan_state
    with torch.inference_mode():
        r2 = float(r2_score(train_ds.params_norm, st.g.eval()(train_ds.spectra).float()))
    recon, dl = hist["pigan/recon_spec_loss"], hist["pigan/d_loss"]
    finite = all(x == x and abs(x) != float("inf") for v in hist.values() for x in v)
    print(f"Trainer.train_pigan({GAN_EPOCHS} epochs, gan_loss='wgan_gp', through F) after "
          f"{PRETRAIN_EPOCHS} forward epochs: {wall:.3f} s, launches {counted}; critic loss "
          f"{dl[0]:.4f} -> {dl[-1]:.4f}, recon_spec_loss {recon[0]:.6f} -> {recon[-1]:.6f}, "
          f"param R2 over the training set {r2:.4f}; all curves finite: {finite}")
    if (counted["gan_train"] != -(-GAN_EPOCHS // EPOCHS_PER_CALL) or not finite
            or not recon[-1] < 0.5 * recon[0]):
        fail("the WGAN-GP train_pigan did not train through K2, one launch per chunk, to a "
             "halved recon_spec_loss")
    return {"launches": counted, "wall": wall, "r2": r2, "recon": (recon[0], recon[-1])}


def phase28_slice7_times(cfg, dev, ds, f) -> dict:
    """Per-epoch CUDA-event medians (ms), all in this one call, each timed
    twice in turns: K2 through F at today's settings, with WGAN-GP, in
    bfloat16 and both, and detached in float32 and bfloat16; K1 in float32
    and bfloat16; K3 at M = K3_MEMBERS today and with WGAN-GP + bfloat16; the
    kernels a step of each K2 variant as the C loop counts them."""
    import torch
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.train.steps import ForwardStepSettings

    bcfg = bf16_config(cfg)
    variants = {"today": (cfg, dict(detach_forward=False)),
                "wgan_gp": (cfg, dict(detach_forward=False, gan_loss="wgan_gp")),
                "bf16": (bcfg, dict(detach_forward=False)),
                "wgan_gp + bf16": (bcfg, dict(detach_forward=False, gan_loss="wgan_gp")),
                "detached": (cfg, dict(detach_forward=True)),
                "bf16 detached": (bcfg, dict(detach_forward=True))}
    runs = {}
    for name, (c, knobs) in variants.items():
        state, _, _, spec, _, _, _, streams = k2_setup(c, dev, ds, f, 1, knobs)
        runs[name] = (gt.state_buffers(state), streams, spec)
    out = {"k2": {}, "k1": {}, "k3": {}, "launches_a_step": {}}
    order = list(variants)
    for name in (*order, *reversed(order)):
        bufs, streams, spec = runs[name]
        ms = cuda_median_ms(lambda: gt.gan_train(bufs, streams, spec), warmup=3, reps=20)
        out["k2"][name] = min(ms, out["k2"].get(name, ms))
    for name in order:
        bufs, streams, spec = runs[name]
        gt.gan_train(bufs, streams, spec)
        out["launches_a_step"][name] = gt.kernels_enqueued() / streams.spectra.shape[0]
    k1 = {}
    for name, c in (("float32", cfg), ("bf16", bcfg)):
        spec = ft.forward_train_spec(c, ForwardStepSettings())
        state, _, _, _, streams = k1_setup(c, dev, ds, 1)
        k1[name] = ([state.params, state.opt.m, state.opt.v], streams, spec)
    for name in ("float32", "bf16", "bf16", "float32"):
        bufs, streams, spec = k1[name]
        ms = cuda_median_ms(lambda: ft.forward_train(*bufs, streams, spec), warmup=3, reps=20)
        out["k1"][name] = min(ms, out["k1"].get(name, ms))
    ens = {}
    for name, (c, knobs) in (("today", (cfg, dict(detach_forward=False))),
                             ("wgan_gp + bf16", (bcfg, dict(detach_forward=False,
                                                            gan_loss="wgan_gp")))):
        states, _, spec, streams = k3_setup(c, dev, ds, f, 1, knobs, K3_MEMBERS)
        ens[name] = (gt.ensemble_buffers(states), streams, spec)
    for name in ("today", "wgan_gp + bf16", "wgan_gp + bf16", "today"):
        bufs, streams, spec = ens[name]
        ms = cuda_median_ms(lambda: gt.gan_ensemble_train(bufs, streams, spec),
                            warmup=3, reps=20)
        out["k3"][name] = min(ms, out["k3"].get(name, ms))
    torch.cuda.synchronize()
    return out


def run_slice7_phases(cfg, dev, repo: str, ds_serving, request, train_ds, f_k2,
                      tag: str, fixed_run: dict) -> dict:
    """Phases 23 to 28: WGAN-GP and bfloat16 operands through K1, K2 and K3,
    the bfloat16 training command and a WGAN-GP train_pigan; returns their
    stats, launches and times."""
    spe = train_ds.num_samples // cfg.train.batch_size
    # -- 23. WGAN-GP in K2 --------------------------------------------------------
    wgan = phase23_wgan(cfg, dev, train_ds, f_k2)
    # -- 24. bfloat16 operands in K1 and K2 ------------------------------------------
    bf16 = phase24_bf16(cfg, dev, train_ds, f_k2)
    # -- 25. K3 with every new path ----------------------------------------------------
    phase25_k3_slice7(cfg, dev, train_ds, f_k2)
    # -- 26. the bfloat16 training command at the reference workload ------------------
    train_bf16 = phase14_train(bf16_config(cfg), dev, repo, ds_serving, request, train_ds,
                               True, extra=("--set", "train.compute_dtype=bfloat16"))
    r32, rb = fixed_run, train_bf16
    print(f"train --mode full --fixed-physics, float32 and bfloat16 operands: param R2 "
          f"{r32['r2']:.4f} and {rb['r2']:.4f}; recon_spec_loss "
          f"{r32['curves']['recon_spec_loss'][0]:.6f} -> "
          f"{r32['curves']['recon_spec_loss'][-1]:.6f} and "
          f"{rb['curves']['recon_spec_loss'][0]:.6f} -> "
          f"{rb['curves']['recon_spec_loss'][-1]:.6f}; {r32['wall']:.3f} and "
          f"{rb['wall']:.3f} s wall")
    # -- 27. WGAN-GP train_pigan at the reference workload -----------------------------
    wgan_train = phase27_wgan_train(cfg, dev, train_ds)
    # -- 28. times ----------------------------------------------------------------------
    times = phase28_slice7_times(cfg, dev, train_ds, f_k2)
    for name, ms in times["k2"].items():
        print(f"time {tag} gan_train one epoch ({spe} steps, B = 64), {name}: kernel "
              f"{ms:.4f} ms ({ms / times['k2']['today']:.3f} x today's settings in the same "
              f"call), {times['launches_a_step'][name]:g} kernels a step (CUDA-event "
              "medians of 20 after 3 warm-up, best of two runs)")
    for name, ms in times["k1"].items():
        print(f"time {tag} forward_train one epoch ({spe} steps, B = 64), {name}: kernel "
              f"{ms:.4f} ms ({ms / times['k1']['float32']:.3f} x float32 in the same call)")
    for name, ms in times["k3"].items():
        print(f"time {tag} gan_ensemble_train one epoch, M = {K3_MEMBERS}, {name}: kernel "
              f"{ms:.4f} ms ({ms / times['k3']['today']:.3f} x today's settings)")
    steps = times["launches_a_step"]
    if steps["today"] != 69 or steps["detached"] != 58:
        fail(f"a step at today's settings is no longer 69 launches (58 detached): {steps}")
    return {"wgan": wgan, "bf16": bf16, "train_bf16": train_bf16, "wgan_train": wgan_train,
            "times": times}


def run_path_phases(cfg, dev, repo: str, train_ds, f_k2, tag: str) -> tuple:
    """Phases 19 to 22; returns (K2's path stats, K3's, the programs'
    launches and wall times, the paths' times)."""
    spe = train_ds.num_samples // cfg.train.batch_size
    # -- 19. K2's second G passes and noise streams, path by path ----------------
    k2_paths = phase13_k2(cfg, dev, train_ds, f_k2, cases=K2_PATHS, paths=True)
    phase19_faults(cfg, dev, train_ds, f_k2)

    # -- 20. K3 against K2 with the paths on ----------------------------------------
    k3_paths = phase16_k3(cfg, dev, train_ds, f_k2,
                          cases=(("cycle + stability + instance noise", K3_PATHS),))

    # -- 21. the metric-gated programs and the optimized preset ----------------------
    programs = phase21_programs(cfg, dev, repo, train_ds)

    # -- 22. times of the paths -------------------------------------------------------
    path_times = phase22_path_times(cfg, dev, train_ds, f_k2)
    for name, ms in path_times["k2"].items():
        print(f"time {tag} gan_train one epoch ({spe} steps, B = 64), {name}: kernel "
              f"{ms:.4f} ms ({ms / path_times['k2']['today']:.3f} x today's settings in the "
              f"same call), {path_times['launches_a_step'][name]:g} kernels a step "
              f"(CUDA-event medians of 20 after 3 warm-up, best of two runs)")
    for name, ms in path_times["k3"].items():
        print(f"time {tag} gan_ensemble_train one epoch ({spe} steps, B = 64), M = "
              f"{K3_MEMBERS}, {name}: kernel {ms:.4f} ms "
              f"({ms / path_times['k3']['today']:.3f} x today's settings in the same call)")
    print(f"time {tag} gan_ensemble_train with both second passes: "
          f"{path_times['launches_a_step']['k3 both']:g} kernels a step at M = "
          f"{K3_MEMBERS}")
    if path_times["launches_a_step"]["today"] != 69 or path_times["launches_a_step"][
            "detached"] != 58:
        fail("a step at today's settings is no longer 69 launches (58 detached): "
             f"{path_times['launches_a_step']}")
    return k2_paths, k3_paths, programs, path_times


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pigan_thz_torch import default_config
        from pigan_thz_torch.data import (
            build_dataset, generate_dataset, sample_params, synthesize_spectra)
        from pigan_thz_torch.data.dataset import denormalize_params
        from pigan_thz_torch.models import build_forward_model, build_generator
        from pigan_thz_torch.ops import _cuda_build
        from pigan_thz_torch.ops import fused_kernels as fk
        from pigan_thz_torch.serve import make_inverse_design_fn
    except ImportError as e:
        fail(f"cannot import the port next to this script: {e}")

    dev = torch.device("cuda", 0)

    # -- 1. environment ------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{card}]"

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda_build.build()
    _cuda_build.load_library()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.1f} s")
    log = (lib_path.parent / "nvcc.log").read_text()
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "spill" in line
                                     or "Compiling" in line):
            print("  " + line.strip())

    cfg = default_config()
    repo = os.path.dirname(os.path.abspath(__file__))

    # -- 3. each kernel against its plain version ----------------------------
    # Full-width G and F through the registry, on the card, seeded.
    gen = torch.Generator().manual_seed(SEED)
    G = build_generator(cfg.generator, cfg.data.spectrum_dim, device=dev, generator=gen)
    perturb_batch_stats_(G, gen)
    F = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim,
                            cfg.data.metrics_dim, device=dev, generator=gen)
    G, F = G.eval(), F.eval()
    g_packed = fk.pack_generator(G, dev)
    f_packed = fk.pack_forward_model(F, dev)

    dgen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = {"fused_mlp_forward": 0.0, "fused_dense_chain": 0.0}
    for b in CHECK_BATCHES:
        x = torch.rand((b, 4), generator=dgen, device=dev) * 2 - 1
        got = fk.fused_mlp_forward(x, f_packed)
        torch.cuda.synchronize()
        want = fk.fused_mlp_forward_plain(x, f_packed)
        torch.cuda.synchronize()
        e5 = (got - want).abs().max().item()
        s = torch.randn((b, cfg.data.spectrum_dim), generator=dgen, device=dev)
        got = fk.fused_dense_chain(s, g_packed)
        torch.cuda.synchronize()
        want = fk.fused_dense_chain_plain(s, g_packed)
        torch.cuda.synchronize()
        e6 = (got - want).abs().max().item()
        print(f"kernel check B={b}: fused_mlp_forward max|err| {e5:.3e} "
              f"(tol {K5_TOL}), fused_dense_chain max|err| {e6:.3e} (tol {K6_TOL})")
        if not e5 <= K5_TOL:
            fail(f"fused_mlp_forward disagrees with its plain version at B={b}")
        if not e6 <= K6_TOL:
            fail(f"fused_dense_chain disagrees with its plain version at B={b}")
        max_err["fused_mlp_forward"] = max(max_err["fused_mlp_forward"], e5)
        max_err["fused_dense_chain"] = max(max_err["fused_dense_chain"], e6)

    # -- 4. the slice --------------------------------------------------------
    requests = {}
    for b in REQUEST_BATCHES:
        p = sample_params(dgen, b, cfg.data, device=dev)
        requests[b] = synthesize_spectra(cfg.data.frequencies, p, dgen, cfg.data.noise_level)
    # serving reads only param_lo, param_hi and spectrum_dim of the dataset
    raw = generate_dataset(dgen, 64, cfg.data, device=dev)
    ds = build_dataset(raw.spectra, raw.params, raw.metrics, cfg.data, device=dev)
    fn = make_inverse_design_fn(G, F, ds)

    serving = {"fused_mlp_forward": 1, "fused_dense_chain": 1, "dip_qualification": 0}
    reset_launches(fk.LAUNCHES)
    answers = {}
    for b in REQUEST_BATCHES:
        before = dict(fk.LAUNCHES)
        answers[b] = fn(requests[b])
        torch.cuda.synchronize()
        for name, want in serving.items():
            if fk.LAUNCHES[name] - before[name] != want:
                fail(f"request B={b} advanced {name} by "
                     f"{fk.LAUNCHES[name] - before[name]}, not {want}")
    launches = dict(fk.LAUNCHES)
    print(f"slice: launches over {len(REQUEST_BATCHES)} requests: {launches}")
    for name, want in serving.items():
        if launches[name] != want * len(REQUEST_BATCHES):
            fail(f"{name} launched {launches[name]} times for "
                 f"{len(REQUEST_BATCHES)} requests")

    lo, hi = ds.param_lo, ds.param_hi
    with torch.inference_mode():
        for b in REQUEST_BATCHES:
            params, spec, met = answers[b]
            shapes = (tuple(params.shape), tuple(spec.shape), tuple(met.shape))
            if shapes != ((b, 4), (b, cfg.data.spectrum_dim), (b, cfg.data.metrics_dim)):
                fail(f"B={b}: output shapes {shapes}")
            if not all(bool(torch.isfinite(t).all()) for t in answers[b]):
                fail(f"B={b}: non-finite output")
            if not bool(((params >= lo) & (params <= hi)).all()):
                fail(f"B={b}: params outside [{cfg.data.param_min}, {cfg.data.param_max}]")
            pn = G(requests[b])
            ref = (denormalize_params(pn, lo, hi), *F(pn))
            errs = [(a - r).abs().max().item() for a, r in zip(answers[b], ref)]
            print(f"slice B={b}: params in [{params.min().item():.4f}, "
                  f"{params.max().item():.4f}], max|err| vs unfused modules "
                  f"params {errs[0]:.3e} spectrum {errs[1]:.3e} metrics {errs[2]:.3e} "
                  f"(tol {CYCLE_TOL})")
            if not max(errs) <= CYCLE_TOL:
                fail(f"B={b}: the cycle disagrees with the unfused modules")

    # The same cycle on the CPU (plain path) at B = 64.
    cpu = torch.device("cpu")
    ds_cpu = type(ds)(*(t.to(cpu) for t in ds))
    fn_cpu = make_inverse_design_fn(
        copy.deepcopy(G).to(cpu), copy.deepcopy(F).to(cpu), ds_cpu)
    cpu_out = fn_cpu(requests[64].cpu())
    errs = [(a.cpu() - r).abs().max().item() for a, r in zip(answers[64], cpu_out)]
    print(f"slice B=64 vs the CPU plain path: max|err| params {errs[0]:.3e} "
          f"spectrum {errs[1]:.3e} metrics {errs[2]:.3e} (tol {CYCLE_TOL})")
    if not max(errs) <= CYCLE_TOL:
        fail("the card's cycle disagrees with the CPU plain path")

    # -- 5. times ------------------------------------------------------------
    def plain_cycle(spectra):
        pn = fk.fused_dense_chain_plain(spectra, g_packed)
        out = fk.fused_mlp_forward_plain(pn, f_packed)
        s_dim = cfg.data.spectrum_dim
        return denormalize_params(pn, lo, hi), out[:, :s_dim], out[:, s_dim:]

    times = {}
    with torch.inference_mode():
        for b in TIME_BATCHES:
            x = torch.rand((b, 4), generator=dgen, device=dev) * 2 - 1
            s = requests[b]
            rows = {
                "fused_mlp_forward": (fk.fused_mlp_forward, fk.fused_mlp_forward_plain,
                                      x, f_packed),
                "fused_dense_chain": (fk.fused_dense_chain, fk.fused_dense_chain_plain,
                                      s, g_packed),
            }
            for name, (kern, plain, inp, packed) in rows.items():
                # plain, kernel, kernel, plain: median of each side's two runs
                p1 = cuda_median_ms(plain, inp, packed)
                k1 = cuda_median_ms(kern, inp, packed)
                k2 = cuda_median_ms(kern, inp, packed)
                p2 = cuda_median_ms(plain, inp, packed)
                times[(name, b)] = (min(k1, k2), min(p1, p2))
            # the one PyTorch call that computes the same function: the
            # module's eval-mode forward (cuBLAS products, torch's norms)
            times[("library fused_mlp_forward", b)] = (cuda_median_ms(F, x),) * 2
            times[("library fused_dense_chain", b)] = (cuda_median_ms(G, s),) * 2
            p1 = cuda_median_ms(plain_cycle, s)
            k1 = cuda_median_ms(fn, s)
            k2 = cuda_median_ms(fn, s)
            p2 = cuda_median_ms(plain_cycle, s)
            times[("cycle", b)] = (min(k1, k2), min(p1, p2))
    for (name, b), (k, p) in times.items():
        if name.startswith("library"):
            print(f"time {tag} {name} B={b}: the module's eval forward {k:.4f} ms "
                  f"(CUDA-event median of 50 after 10 warm-up)")
            continue
        print(f"time {tag} {name} B={b}: kernel {k:.4f} ms, plain {p:.4f} ms "
              f"(CUDA-event median of 50 after 10 warm-up, best of two runs each)")

    # -- 6. K4 against both plain versions ------------------------------------
    k4_stats = phase6_k4(dgen, cfg, dev)

    # -- 7. dataset generation -----------------------------------------------
    dataset_k4 = phase7_dataset(cfg, dev, repo)

    # -- 8. screening --------------------------------------------------------
    screens = phase8_screen(F, cfg, dev, lo, hi)

    # -- 9. times ------------------------------------------------------------
    from pigan_thz_torch.design import ScreeningConfig

    k4_times = phase9_k4_times(dgen, cfg, dev, f_packed)
    k4_ops, k4_bytes = k4_times.pop("screen_ops"), k4_times.pop("screen_bytes")
    for name, (k, p, l) in k4_times.items():
        print(f"time {tag} dip_qualification B={K4_BATCHES[-1]} {name} spectra: "
              f"kernel {k:.4f} ms, plain lattice {p:.4f} ms, plain lifted {l:.4f} ms "
              f"(CUDA-event medians, best of two runs each)")
    for n in DATASET_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        ms = cuda_median_ms(lambda: generate_dataset(g, n, cfg.data, device=dev),
                            warmup=3, reps=20)
        print(f"time {tag} generate_dataset n={n}: {ms:.4f} ms "
              f"(CUDA-event median of 20 after 3 warm-up)")
    for use_pallas, (_, wall, _) in screens.items():
        _, again = run_screen(F, cfg, dev, lo, hi, use_pallas)
        label = "fused surrogate" if use_pallas else "module surrogate"
        n = ScreeningConfig().num_candidates
        print(f"time {tag} screen {label} 1e6 candidates: {wall:.4f} s and {again:.4f} s "
              f"wall (first and second run), {n / wall:.0f} and {n / again:.0f} "
              f"candidates/s")

    # -- 10. K1 against its plain version ------------------------------------
    from pigan_thz_torch.data import synthetic_dataset

    train_ds = synthetic_dataset(cfg.data, device=dev)
    k1_stats = phase10_k1(cfg, dev, train_ds)

    # -- 11. forward pretraining ----------------------------------------------
    pretrain = phase11_pretrain(cfg, dev, repo, G, ds, requests[64])

    # -- 12. times -------------------------------------------------------------
    k1_ms, k1_plain_ms, k1_eager_ms = phase12_k1_times(cfg, dev, train_ds)
    steps = PRETRAIN_EPOCHS * (train_ds.num_samples // cfg.train.batch_size)
    print(f"time {tag} pretrain-forward {PRETRAIN_EPOCHS} epochs ({steps} steps): "
          f"{pretrain['wall']:.4f} s wall for the command, {steps / pretrain['wall']:.1f} "
          f"steps/s")
    print(f"time {tag} forward_train one epoch (15 steps, B = 64): kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms, eager step {k1_eager_ms:.4f} ms (CUDA-event "
          f"medians; kernel 20 and the others 5 after warm-up, best of two runs each)")

    # -- 13. K2 against its plain version ------------------------------------
    from pigan_thz_torch.train.trainer import Trainer

    f_trainer = Trainer(cfg, ds=train_ds, device=dev)
    f_trainer.pretrain_forward(epochs=K2_F_EPOCHS)
    f_k2 = f_trainer.forward_state.f
    k2_stats = phase13_k2(cfg, dev, train_ds, f_k2)

    # -- 14. the training command, as typed and with --fixed-physics ----------
    trains = {fixed: phase14_train(cfg, dev, repo, ds, requests[64], train_ds, fixed)
              for fixed in (False, True)}

    # -- 15. times -------------------------------------------------------------
    k2_times = phase15_k2_times(cfg, dev, train_ds, f_k2)
    spe = train_ds.num_samples // cfg.train.batch_size
    steps = (PRETRAIN_EPOCHS + GAN_EPOCHS) * spe
    for fixed, flag in ((False, ""), (True, " --fixed-physics")):
        wall = trains[fixed]["wall"]
        print(f"time {tag} train --mode full{flag} {PRETRAIN_EPOCHS} + {GAN_EPOCHS} "
              f"epochs ({steps} steps): {wall:.4f} s wall for the command, "
              f"{steps / wall:.1f} steps/s")
    for detach, name in ((False, "through F"), (True, "detached")):
        k, p, e = k2_times[detach]
        print(f"time {tag} gan_train one epoch ({spe} steps, B = 64), {name}: kernel "
              f"{k:.4f} ms, plain {p:.4f} ms, eager step {e:.4f} ms (CUDA-event medians; "
              f"kernel 20 and the others 5 after warm-up, best of two runs each)")

    # -- 16. K3 against K2 and its plain version --------------------------------
    k3_stats = phase16_k3(cfg, dev, train_ds, f_k2)

    # -- 17. the seed-ensemble path ----------------------------------------------
    ensemble = phase17_ensemble(cfg, dev, repo, ds, requests[64])

    # -- 18. times ----------------------------------------------------------------
    k3_times = phase18_k3_times(cfg, dev, train_ds, f_k2)
    k2_ms = min(k3_times["k2"])
    print(f"time {tag} torch_seed_ensemble --members {K3_MEMBERS} --epochs {GAN_EPOCHS} "
          f"--fwd-epochs {PRETRAIN_EPOCHS}: {ensemble['wall']:.4f} s wall for the command, "
          f"{ensemble['out']['wall_s']:.4f} s for the members' {K3_MEMBERS} x "
          f"{GAN_EPOCHS * spe} steps, {ensemble['out']['member_steps_per_s']:.1f} "
          f"member-steps/s; at {ENSEMBLE_SHORT_EPOCHS} epochs packed "
          f"{ensemble['short'][0]:.1f} and --unpacked {ensemble['short'][1]:.1f} "
          f"member-steps/s")
    print(f"time {tag} gan_train one epoch ({spe} steps, B = 64), through F, before and "
          f"after the K3 runs: {k3_times['k2'][0]:.4f} and {k3_times['k2'][1]:.4f} ms "
          f"({spe / k2_ms * 1e3:.1f} steps/s)")
    for members, ms in k3_times["k3"].items():
        print(f"time {tag} gan_ensemble_train one epoch ({spe} steps, B = 64), through F, "
              f"M = {members}: kernel {ms:.4f} ms ({ms / members:.4f} ms per member; M x "
              f"K2 {members * k2_ms:.4f} ms, ratio {members * k2_ms / ms:.3f}), "
              f"{members * spe / ms * 1e3:.1f} member-steps/s aggregate, "
              f"{ms / k2_ms:.3f} x K2's epoch (CUDA-event medians of 20 after 3 warm-up, "
              f"best of two runs)")
    print(f"time {tag} gan_ensemble_train one epoch, M = {K3_MEMBERS}: detached kernel "
          f"{k3_times['detached']:.4f} ms; plain version through F "
          f"{k3_times['plain']:.4f} ms (median of 3 after 1 warm-up)")

    # -- 19 to 22. the second G passes, the noise streams, the programs ------------
    k2_paths, k3_paths, programs, path_times = run_path_phases(
        cfg, dev, repo, train_ds, f_k2, tag)

    # -- 23 to 28. WGAN-GP and bfloat16 operands ---------------------------------
    s7 = run_slice7_phases(cfg, dev, repo, ds, requests[64], train_ds, f_k2, tag,
                           trains[True])

    # -- the record -------------------------------------------------------------
    # bound_ms: operations over the fp32 peak against bytes moved once over the
    # memory rate, from the shapes each timed call was given.
    bsz = cfg.train.batch_size
    S, nm = cfg.data.spectrum_dim, cfg.data.metrics_dim
    f_dims = (4, *cfg.forward_model.hidden_dims, S + nm)
    g_dims = (S, *cfg.generator.hidden_dims, 4)
    d_dims = (S + 4, *cfg.discriminator.hidden_dims, 1)
    macs_f, macs_g, macs_d = chain_macs(f_dims), chain_macs(g_dims), chain_macs(d_dims)
    n_f = sum(p.numel() for p in F.parameters())
    n_g = sum(p.numel() for p in G.parameters())
    n_d = sum(p.numel() for p in f_trainer.discriminator.parameters())
    big = max(TIME_BATCHES)   # the times in the record are at B = 8192
    bound = {
        "fused_mlp_forward": roofline(2.0 * big * macs_f, 4.0 * (big * 4 + n_f + big * (S + nm))),
        # BatchNorm folded: its four vectors per hidden layer are read too
        "fused_dense_chain": roofline(2.0 * big * macs_g,
                                      4.0 * (big * S + n_g + 2 * sum(g_dims[1:-1]) + big * 4)),
        "dip_qualification": roofline(k4_ops, k4_bytes),
        # an epoch of K1: forward, dW and dx products (no dx below the first
        # layer); params, m and v read and written once, the streams read
        "forward_train": roofline(
            spe * (6.0 * bsz * macs_f - 2.0 * bsz * f_dims[0] * f_dims[1]),
            4.0 * (6 * n_f + spe * bsz * (4 + S + nm) + spe * 3)),
        # an epoch of K2, gradients through F: G forward, dW and dx; D on 2B
        # rows forward, dW and dx; the adversarial pass (forward, dx down to
        # the 4 parameter columns); F forward and input-backward
        "gan_train": roofline(
            spe * 2.0 * bsz * (
                3 * macs_g - g_dims[0] * g_dims[1]
                + 2 * (3 * macs_d - d_dims[0] * d_dims[1])
                + 2 * macs_d - (d_dims[0] - 4) * d_dims[1]
                + 2 * macs_f),
            4.0 * (6 * (n_g + n_d) + n_f + 4 * sum(g_dims[1:-1])
                   + spe * bsz * (S + 4 + nm) + spe * 11)),
    }
    k5_screen = screens[True][2]["fused_mlp_forward"]
    k4_screen = sum(s[2]["dip_qualification"] for s in screens.values())
    k1_launches = pretrain["launches"]["forward_train"]
    tl = {k: sum(t["launches"][k] for t in trains.values()) for k in trains[True]["launches"]}
    # the seed-ensemble commands: the 500-epoch run and the two short ones
    el = {k: ensemble["launches"][k] + ensemble["short_launches"][k]
          for k in ensemble["launches"]}
    bound["gan_ensemble_train"] = (K3_MEMBERS * bound["gan_train"][0], bound["gan_train"][1])
    # the new paths: WGAN-GP adds the penalty's 8 B-row products on a D-update
    # step; the bfloat16 rows are bounded at the bf16 tensor-core peak (989
    # TFLOP/s, NVIDIA's H100 SXM data sheet, dense), every product counted there
    nd, d1, d2 = d_dims[0], d_dims[1], d_dims[2]
    gp_flops = spe * 2.0 * bsz * (4 * nd * d1 + 4 * d1 * d2)
    k1_flops = spe * (6.0 * bsz * macs_f - 2.0 * bsz * f_dims[0] * f_dims[1])
    k2_flops = spe * 2.0 * bsz * (
        3 * macs_g - g_dims[0] * g_dims[1] + 2 * (3 * macs_d - d_dims[0] * d_dims[1])
        + 2 * macs_d - (d_dims[0] - 4) * d_dims[1] + 2 * macs_f)
    k1_bytes = 4.0 * (6 * n_f + spe * bsz * (4 + S + nm) + spe * 3)
    k2_bytes = 4.0 * (6 * (n_g + n_d) + n_f + 4 * sum(g_dims[1:-1])
                      + spe * bsz * (S + 4 + nm) + spe * 11)
    bound["gan_train wgan_gp"] = roofline(k2_flops + gp_flops, k2_bytes + 4.0 * spe * bsz)

    def bf16_bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    bound["forward_train bf16"] = bf16_bound(k1_flops, k1_bytes)
    bound["gan_train bf16"] = bf16_bound(k2_flops, k2_bytes)
    # the two commands of this slice, counted from 0 around each
    sl = {k: s7["train_bf16"]["launches"].get(k, 0) + s7["wgan_train"]["launches"].get(k, 0)
          for k in s7["wgan_train"]["launches"]}
    print(f"main-path launches of phases 26 and 27: train --mode full --fixed-physics --set "
          f"train.compute_dtype=bfloat16 {s7['train_bf16']['launches']}, the WGAN-GP "
          f"train_pigan {s7['wgan_train']['launches']}")
    # the programs: run_program in this process (counted from 0 around it),
    # the three program commands and train --preset optimized
    pl = {k: programs["inprocess"][k] + sum(c[0][k] for c in programs["commands"].values())
          for k in programs["inprocess"]}
    print(f"main-path launches: serving {launches}, dataset dip_qualification "
          f"{dataset_k4}, screens fused_mlp_forward {k5_screen} dip_qualification "
          f"{k4_screen}, pretrain-forward forward_train {k1_launches}, train --mode full with and without "
          f"--fixed-physics {tl}, torch_seed_ensemble at {GAN_EPOCHS} epochs and twice at "
          f"{ENSEMBLE_SHORT_EPOCHS} {el}, run_program(emergency_phases()), program "
          f"{' | '.join(PROGRAMS)} and train --preset optimized {pl}")

    def bounds(name):
        ms, by = bound[name]
        return {"bound_ms": ms, "bound_by": by}

    record = {"kernels": [
        {"name": "fused_mlp_forward", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:73",
         "launches": launches["fused_mlp_forward"] + k5_screen,
         "max_abs_err": max_err["fused_mlp_forward"],
         "ms": times[("fused_mlp_forward", big)][0],
         "plain_ms": times[("fused_mlp_forward", big)][1],
         **bounds("fused_mlp_forward"),
         "library_ms": times[("library fused_mlp_forward", big)][0]},
        {"name": "fused_dense_chain", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:185",
         "launches": launches["fused_dense_chain"],
         "max_abs_err": max_err["fused_dense_chain"],
         "ms": times[("fused_dense_chain", big)][0],
         "plain_ms": times[("fused_dense_chain", big)][1],
         **bounds("fused_dense_chain"),
         "library_ms": times[("library fused_dense_chain", big)][0]},
        {"name": "dip_qualification", "route": "cuda",
         "source": "pigan_thz_torch/csrc/dip_qualification.cu",
         "replaces": "pigan_thz_tpu/ops/peaks.py:306",
         "launches": dataset_k4 + k4_screen + tl["dip_qualification"]
         + el["dip_qualification"] + pl["dip_qualification"],
         "max_abs_err": k4_stats["max_abs_err"],
         "mask_mismatches": k4_stats["mask_mismatches"],
         "ms": k4_times["screen"][0],
         "plain_ms": k4_times["screen"][1],
         "plain_lifted_ms": k4_times["screen"][2],
         **bounds("dip_qualification"), "library_ms": None},
        {"name": "forward_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/forward_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:2623",
         "launches": k1_launches + tl["forward_train"] + el["forward_train"]
         + pl["forward_train"] + sl["forward_train"],
         "launches_bf16": s7["train_bf16"]["launches"]["forward_train"],
         "bf16_ms": s7["times"]["k1"]["bf16"], "float32_ms_same_call": s7["times"]["k1"][
             "float32"],
         "bf16_first_step_rel_err_vs_float64": s7["bf16"]["k1_first_step_rel"],
         "bf16_params_rel_err_30_steps": s7["bf16"]["k1_params_rel"],
         "bf16_bound_ms": bound["forward_train bf16"][0],
         "bf16_bound_by": bound["forward_train bf16"][1],
         "max_abs_err": k1_stats["max_abs_err"],
         "rows_max_rel_err": k1_stats["rows_rel"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "eager_ms": k1_eager_ms,
         **bounds("forward_train"), "library_ms": None},
        {"name": "gan_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/gan_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:779",
         "launches": tl["gan_train"] + el["gan_train"] + pl["gan_train"] + sl["gan_train"],
         "launches_on_the_paths": pl["gan_train"],
         "launches_bf16_command": s7["train_bf16"]["launches"]["gan_train"],
         "launches_wgan_gp_train_pigan": s7["wgan_train"]["launches"]["gan_train"],
         "wgan_gp_max_abs_err": s7["wgan"]["max_abs_err"],
         "wgan_gp_rows_max_rel_err": s7["wgan"]["rows_rel"],
         "wgan_gp_first_step_rel_err_vs_float64": s7["wgan"]["first_step_rel"],
         "bf16_first_step_rows_over_limit": s7["bf16"]["k2_first_step_rows"],
         "bf16_first_step_tensors_over_limit": s7["bf16"]["k2_first_step_tensors"],
         "bf16_parts_rel_err": s7["bf16"]["k2_parts"],
         "ms_by_new_path": s7["times"]["k2"],
         "kernels_a_step_by_new_path": s7["times"]["launches_a_step"],
         "wgan_gp_bound_ms": bound["gan_train wgan_gp"][0],
         "bf16_bound_ms": bound["gan_train bf16"][0],
         "bf16_bound_by": bound["gan_train bf16"][1],
         "max_abs_err": max(k2_stats["max_abs_err"], k2_paths["max_abs_err"]),
         "rows_max_rel_err": k2_stats["rows_rel"],
         "first_step_rel_err_vs_float64": k2_stats["first_step_rel"],
         "paths_rows_max_rel_err": k2_paths["rows_rel"],
         "paths_first_step_rel_err_vs_float64": k2_paths["first_step_rel"],
         "ms_by_path": path_times["k2"],
         "kernels_a_step_by_path": path_times["launches_a_step"],
         "idle_share_cycle_and_stability": path_times["both_idle_share"],
         "ms": k2_times[False][0], "plain_ms": k2_times[False][1],
         "eager_ms": k2_times[False][2], "detached_ms": k2_times[True][0],
         "detached_plain_ms": k2_times[True][1], "detached_eager_ms": k2_times[True][2],
         **bounds("gan_train"), "library_ms": None},
        {"name": "gan_ensemble_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/gan_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:2128",
         "launches": el["gan_ensemble_train"],
         "members": K3_MEMBERS,
         "max_abs_err": max(k3_stats["max_abs_err"], k3_paths["max_abs_err"]),
         "rows_max_rel_err": k3_stats["rows_rel"],
         "first_step_rel_err_vs_float64": k3_stats["first_step_rel"],
         "paths_rows_max_rel_err": k3_paths["rows_rel"],
         "ms_by_path": path_times["k3"],
         "ms_by_new_path": s7["times"]["k3"],
         "ms": k3_times["k3"][K3_MEMBERS], "plain_ms": k3_times["plain"],
         "detached_ms": k3_times["detached"],
         "ms_by_members": {str(m): t for m, t in k3_times["k3"].items()},
         "gan_train_ms_same_call": k2_ms,
         **bounds("gan_ensemble_train"), "library_ms": None},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
