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
   B = 1, 77, 257, 8192, 65536 and on both sides of the serving kernels'
   crossover from the cluster shape to the row-tile shape, full-width
   seeded weights (generator BatchNorm stats non-trivial, so the folding is
   exercised); reruns bit-identical, and a cluster-shape launch equal to the
   row-tile shape's bit for bit;
4. the slice: answers requests at B = 1, 64, 8192, 65536 through
   ``serve.make_inverse_design_fn``, checks shapes, finiteness, the params'
   box, one launch of each kernel per request, and agreement with the
   modules' unfused eval-mode forward on the card and, at B = 64, with the
   cycle's plain CPU path;
5. times: CUDA-event medians of each serving kernel and of the cycle beside
   their plain versions and, in turns, the modules' eval forward (cuBLAS) at
   B = 1, 64, 8192 and 65536, with the launch shape chosen at each; a
   profile of one request at B = 64 and 8192;
6. the dip-qualification kernel (K4) against both plain versions (the
   lattice and the sparse-table form) at B = 1, 7, 1000, 8192 on four
   spectra classes and the screen's spectra (K5 on random candidates):
   masks equal, prominence and width within tolerance at the peaks; its
   metrics entry (qualification, selection and FWHM in one launch) against
   ``spectrum_metrics`` on the lattice's qualification on the card, without
   centres and with per-row centres, NaN in some rows, and on hostile rows
   (tests/peak_rows.py): NaN pattern equal, every value equal;
7. dataset generation: ``synthetic_dataset`` at 1000 samples and
   ``generate_dataset`` at 65536 on the card, one K4 launch each, metrics
   against the CPU plain path, a CSV round trip, and the ``generate-data``
   command in a subprocess;
8. screening: 1e6 candidates, chunk 8192, top-k 100 on seeded full-width F,
   with the fused surrogate kernel and with the module forward: 123 K4
   launches per screen (and 123 K5 launches with the kernel), a sorted,
   finite top-k in the design box, winners re-scored on the CPU;
9. times: K4's four-output entry at B = 8192 on each class, beside both
   plain versions on the synthetic and the screen's spectra; its metrics
   entry beside its plain version (the sparse-table form, then
   ``spectrum_metrics``), beside ``spectrum_metrics`` given the mask and
   beside the four-output entry followed by ``spectrum_metrics``;
   ``generate_dataset`` at 1000 and 65536, and each screen's wall time;
10. the forward-training kernel (K1) against its plain version on the
    card: seeded full-width F, a 1000-sample dataset; its first float32
    step against the plain version run in float64 (rows and Adam's first
    moments tensor by tensor, as K2's first step is held), with a planted
    fault of its batch-row products seen; then 2 epochs (30 steps)
    from one state and one set of streams, at dropout 0.2 and 0: the same
    dropout masks, metric rows, parameters and Adam moments within
    tolerance, a rerun bit-identical; at dropout 0 also the eager autograd
    step;
11. forward pretraining: ``python -m pigan_thz_torch pretrain-forward
    --epochs 500`` in a subprocess at the reference workload (1000
    samples, batch 64, lr 1e-3 cosine to 0, clip 1, dropout 0.2): one K1
    launch per 25-epoch chunk, ``brow_products`` batch-row launches a step
    inside them, a finite loss that ends well below where it
    starts, artifacts that load into ``build_forward_model``, and the
    trained F answering one serving request through K5;
12. times: the 500-epoch run's wall time and steps/s, and per-epoch
    CUDA-event medians of K1, its plain version and the eager step; K1's
    launches a step (36) and batch-row launches a step as its C loop counts
    them, and a profile of one K1 launch (device time by kernel, idle
    share);
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
    --fwd-epochs 500 --holdout`` in a subprocess at the reference workload,
    on an 800-cell split: 20 K1 and
    20 K3 launches, finite rows for every member, members that differ, every
    member's reconstruction loss ending below half of where it starts, each
    member's param R² beside the ensemble mean's, on the training split and
    on the 200 held-out cells (printed, not gated); the
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
    epoch in bfloat16 beside float32, K3's at M = 4 with WGAN-GP + bfloat16;
29. the batch-row products that K1, K2 and K3 launch through
    ``csrc/brow_gemm.cuh`` (every product with the batch as its rows: G's,
    D's and F's forward layers and input gradients), each shape and flag of
    a step at M = 1 and 4, with its launches a step on each path (K1's
    among them): the plan (the C rule against ``brow_plan``), the
    kernel against its plain version and float64 within BROW_TOL_*, a rerun
    bit-identical, each member bit for bit its own launch, and the us a
    launch of the kernel, of the tiled SGEMM the step used before and of
    ``torch.matmul`` on the same operands, back to back in a CUDA graph,
    beside the roofline.  Phases 13,
    16, 19, 23 and 24 also hold each chunk's count of batch-row launches to
    ``brow_products``, and the main paths' counts are read (LAUNCHES);
30. a ``torch.profiler`` trace of five fused screening chunks
    (``screen_chunk`` through K5 and K4's metrics entry, after warm-up):
    kernels a chunk, kernel time, idle share, the kernels by time.  It runs right after
    phase 9, beside the screens: after phase 29's CUDA graphs the profiler
    records no kernel;
31. the evaluation entry point, on phase 14's ``--fixed-physics`` trio: (a)
    ``noise_ceilings`` on the card (two launches of K4's metrics entry)
    against the CPU's plain versions on the same draws, the metrics equal
    (NaN pattern and values) and every ceiling within CEILING_TOL; (b) the
    four suites, the ceilings, the clean oracle and the report in this
    process on the card's dataset, every scalar within EVAL_TOL of the same
    trio and tensors on the CPU, the report's target section printed beside
    the JAX package's 7/7, param R² held to "TARGET MET" and the count to
    7/7, the evaluator's CUDA-event ms; (c)
    ``python -m pigan_thz_torch evaluate`` as typed in a subprocess: 3 K4
    launches, the JAX command's JSON keys, the saved report, ``--suite
    pigan``'s rubric; (d) ``train --mode full --fixed-physics --holdout 0.2
    --holdout-seed 9`` (20 K1 + 20 K2 launches) and ``evaluate --holdout``
    with the same pair: the held-out rows equal field by field, printed
    beside the JAX record; (e) ``evaluate --violation-window sane --plot``:
    violation rate 0 and, where matplotlib imports, the seven figures;
32. serving completed, on a copy of phase 14's ``--fixed-physics`` trio:
    (a) the bf16 and int8 cycles (``make_inverse_design_fn(compute_dtype=
    ...)``) at B = 1, 64, 8192, 65536 beside the fp32 kernel cycle: shapes,
    finite outputs, params in the box, no kernel launch, their distances
    from the fp32 cycle printed; int8 within the JAX package's envelope of
    fp32 where it states it (fresh weights: phase 3's seeded trio, B = 64);
    each dtype at B = 64 against itself on the CPU; CUDA-event medians of each; the fp32 cycle's latency at B = 1 and 64
    (median and p99 over 1000 requests); (b) ``export`` in fp32, bf16 and
    int8 (written on the CPU), with ``--pallas`` (the kernels' custom ops)
    and ``--artifact ensemble`` from phase 17's saved members: each artifact
    loaded with ``load_exported`` on the card and held against the
    in-process function (the ``--pallas`` designer bit for bit, one launch
    each of K6 and K5 a call), a wrong batch refused; (c) ``screen
    --candidates 1000000`` with ``--pallas`` and with ``--dtype bfloat16``
    as typed (in this process): K4 once a chunk and once for the dataset,
    the top-k valid and sorted, the wall time and bf16's gap in the top
    FoM1; (d) ``design --target-index 0 --target-index 1 --refine-steps 200
    --uncertainty`` beside ``--refine-steps 0``: the MSE no higher, the MC
    std finite and positive;
33. preemption-safe training and the operational commands, at full width
    on the 1000-sample dataset: (a) in process, an uninterrupted trainer
    (forward 2 x 25 epochs, then PI-GAN 2 x 25 through F with the EMA, two
    calls a stage) against one that saves after each stage's first call and
    resumes in a fresh ``Trainer``: bit for bit equal (parameters, moments,
    counts, BatchNorm buffers, EMA, the generator's state, the history);
    (b) ``examples/torch_full_pipeline.py --fwd-epochs 100 --gan-epochs 100
    --ft-epochs 50 --chunk 25`` uninterrupted, sent SIGKILL at ``gan
    50/100`` and rerun to DONE: ``saved_models/*`` and ``final_eval.json``
    equal byte for byte; (c) ``train --mode full --checkpoint-dir`` at
    100 + 100 epochs with ``train.save_interval=50``: epochs 50 and 100
    kept, the latest restored into a fresh ``Trainer`` equal to the saved
    finals; (d) the shadow replay of K1 and K2 with ``shadow_parity="all"``
    over 2 chunks each, all ``ok`` (worst key and relative difference
    printed), a planted first-epoch fault (``loss`` / ``g_loss`` x 10)
    raising ``RuntimeError``, one replay's ms, and the training of ``train
    --mode full`` (500 + 500) with the default cadence against ``"off"`` in
    turns; a checkpoint's size and its save and restore ms; (e) ``doctor``
    (exit 0, the card named), ``profile --epochs 10 --repeats 3`` (3 K2
    launches counted, the trace written) and ``cache-data`` of a
    1000-sample CSV (arrays equal to the CSV's), with the CSV, native CSV
    and ``.thzb`` load times;
34. the enhanced variants, at full published width on the 1000-sample
    dataset: ``train --preset optimized`` as typed (its residual G and
    spectral-norm dual-encoder D; GAN depth cut to ``--epochs 50``) in a
    subprocess: F pretrains through K1 at the preset's 200 epochs, the GAN
    phase on the eager step with the engine rule's log line, no K2 launch,
    finite history; ``evaluate`` on the saved trio (finite param R²); one
    B = 64 request through ``make_inverse_design_fn`` with K5 serving F and
    the residual G's module (1 K5 launch, no K6; params in the design box;
    equal to the all-module cycle); then each of the eight variants swapped
    alone into the baseline trio, its state built on the CPU from a seed and
    carried to the card through ``state_dict`` / ``load_state_dict_``,
    takes eager steps on the card (PI-GAN steps; a surrogate also forward
    steps, the uncertainty one with ``nll_w`` 0.5), finite, each variant's
    steps/s beside the baseline trio's eager steps in the same call; the K1
    and K4 launches of the phase printed;
35. ensembles and data parallelism, two ranks on the one card (processes
    of a gloo group: NCCL refuses two ranks on one device), spawned once:
    (i) ``Trainer(mesh=...)`` 10 forward + 10 GAN epochs at B = 64 global
    (the eager step, as JAX's mesh path runs no training kernel) against a
    world-1 eager run of the same phase: the replicas' state hashes equal
    after every 5-epoch chunk, the first epoch's rows of each phase within
    1e-4 (the GAN phase over the ranks from world 1's F), the later rows'
    distance printed (float32's drift), PI-GAN and forward steps/s at world 1 and 2; (ii) the
    1e6 fused and module screens over the ranks (K5 and K4 on each rank's
    chunks, launches counted per rank) equal to phase 8's, row for row;
    (iii) ``screen --mesh-data`` beyond the devices refused before work;
    (iv) ``examples/torch_ablation_sweep.py --members 8 --forward-epochs 100
    --epochs 10`` at ``--world 1`` and ``--world 2 --backend gloo`` in
    subprocesses (K1 pretrains F on rank 0, K4 each rank's dataset): the
    rankings equal bit for bit in param R², member-steps/s of each;
36. the last modules, at full published width on the 1000-sample dataset:
    (i) the seed search (``parallel/ensemble_megakernel.py:seed_search``,
    the loop of ``examples/torch_seed_search.py``) with 4 members on the
    800-cell split, F pretrained 500 epochs through K1, 500 GAN epochs (cut
    from 24,000) in 25-epoch K3 launches, every member on the same draws,
    scored every 100 epochs on both splits; the chunk's first two epochs
    held first against the eager engine (the λ-ensemble step with the
    default weights) from the same state on the same draws, at K2's
    trajectory limits member by member; the best snapshot saved as
    ``--save-best`` saves it and served through ``export --artifact ensemble
    --ensemble-members 4`` (or, if a member wins, the designer of its trio):
    the served held-out param R² equal to the in-process snapshot's within
    1e-4; (ii) tensor parallelism: two gloo ranks on the card as
    ``make_mesh(data=1, model=2)``, ``Trainer`` 5 forward + 5 GAN epochs
    against a world-1 eager run, the first epoch's rows of each phase
    within 1e-4, F's 1024-wide layers' shard shapes printed; (iii)
    ``examples/torch_holdout_eval.py --fwd-epochs 100 --gan-epochs 100
    --ema-decay 0.99`` (K4, K1, K2 with its EMA) in a subprocess: the JSON
    keys, finite rows; (iv) ``examples/torch_scaled_batch_probe.py
    --throughput`` at B = 64 and 512, kernel (K2) and eager, with TFLOP/s
    and MFU from ``ops/costs.py``.
37. the enhanced designer's residual G (run right after phase 5): a seeded
    full-width ``ResidualGenerator`` (BatchNorm stats non-trivial, folded at
    packing) through its chain kernel (``csrc/fused_residual_chain.cu``,
    no TPU kernel) at B = 1, 77, 8192, 8192 + 37, 65536 and on both sides
    of its crossover, within the design cells' ``params_gap`` limit (3e-5
    of the reference's RMS) of the fp32 module and of the plain folded
    chain, reruns bit-identical, one launch a call; the default designer
    with phase 3's F (K5) at B = 8192, 65536 and on both sides of the
    crossover, 8 requests each with the launch counts zeroed just before:
    one launch of the kernel a request from the crossover up (the G span's
    ``shape`` "wgmma", ``replayed`` 0) and none below it (the graphed module
    stage, ``replayed`` 1), the params within 3e-5 of the all-module
    designer's; then CUDA-event medians at the crossover, 8192 and 65536 of
    the kernel, its plain version and the graphed module stage, in turns.

The ``kernels`` record gives each kernel's launches on the main path, its
error against its plain version, its time beside the plain version's, the
least time the card could take for the same work (``bound_ms``: the larger
of the operations over 67 TFLOP/s fp32 and the bytes, each input read once
and each output written once, over 3.35 TB/s; ``bound_by`` says which), and
``library_ms``, the time of one PyTorch call that computes the same function
where there is one (the modules' eval-mode forward for K5 and K6; the
graphed module stage for the residual chain kernel, whose entry also
carries its bound at the TF32 tensor-core rate and its design's 3xTF32
bound, its gaps by batch and its launches in phase 37's serving), else
null.
K4's entry also carries its metrics entry's time, plain time and bound, and
phase 30's profile of a screening chunk.
The bfloat16 rows of K1 and K2 carry their own bound, every product counted
at the bf16 tensor-core peak (989 TFLOP/s).  K1's, K2's and K3's entries note
that their batch-row products go through ``brow_gemm`` and carry its launches
on the main paths and its per-product times; K1's also its first step
against float64, its launches a step and its profile.

Any failed check raises, and the script exits non-zero.  Without a CUDA
device, or away from the package, it exits non-zero and prints no result.
Its last line is the JSON record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    # the card's peaks and the bound of every kernel in the record
    from pigan_thz_torch.ops.costs import (  # noqa: E402
        PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, design_bound_3xtf32, roofline)
except ImportError:
    # away from the package: main() fails before any work
    roofline = design_bound_3xtf32 = None

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
# K1's first float32 step (phase 10) is held as K2's is (K2_ROUNDING below,
# floor K2_STEP_FLOOR[1] for the moments and the rows): the batch-row
# products split their depth over a cluster, which changes the order of
# every such sum, so the gate is against float64, not against the float32
# plain version's own order.  The fault a wrong cluster sum would make, layer
# 3's input gradient without its last K slice, must be seen by it
# (K1_BF16_FAULT_RATIO).
K1_FP32_FAULTS = ("dx_layer3_last_slice_dropped",)
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
PRETRAIN_EPOCHS = 500
EPOCHS_PER_CALL = 25
REQUEST_BATCHES = (1, 64, 8192, 65536)
CHECK_BATCHES = (1, 77, 257, 8192, 65536)   # and the crossover's two sides
TIME_BATCHES = (1, 64, 8192, 65536)
SEED = 0
# Phase 31, the evaluation entry point.  The ceilings on the card and on the
# CPU come from the same CPU draws and the same metrics (held equal), so
# only the R2 sums' order differs; the suites and the oracle run the same
# modules through cuBLAS and the CPU's BLAS (TF32 off).
CEILING_TOL = 1e-5
EVAL_TOL = 1e-4
HOLDOUT = ("0.2", "9")      # --holdout, --holdout-seed: the 800 / 200 split
EVAL_KEYS = {"forward_network_evaluation", "pigan_evaluation",
             "structural_prediction_evaluation", "model_validation", "total_samples",
             "noise_ceilings", "oracle_validation", "evaluation_time"}
# Phase 32, serving completed.  int8 against the fp32 cycle: the JAX
# package's accuracy contract (tests/test_quantized.py:70-73): params_norm
# within 0.05, spectrum and metrics within 10 % of their scale, stated on
# flax-initialised weights and 64 spectra, and held there (phase 3's seeded
# trio).  A trained G leans on finer features of the spectrum than one step
# of its int8 rows (a row's range / 127): on a trio trained 150 + 150 epochs
# the int8 params_norm sit a median 0.046 and up to 0.18 from fp32, as the
# JAX package's cycle would, whose int8 the port follows to 1e-6
# (tests/test_torch_quantized.py); so on the trained trio they are printed.  Each dtype
# at B = 64 against the same dtype on the CPU: fp32 the kernels against their
# plain versions (CYCLE_TOL); bf16 within the bf16 models' 2e-2 of the
# largest magnitude (tests/test_torch_bf16.py); int8 the same (its products
# are exact on both, the fp32 sums around them may move a row's rounding by
# one step).  Exported artifacts against the in-process function: the
# --pallas designer bit for bit (the same kernels), the others within 1e-5.
INT8_PN_TOL, INT8_SCALE_TOL = 0.05, 0.10
DTYPE_CPU_RTOL = 2e-2
ARTIFACT_TOL = 1e-5
LATENCY_REQUESTS = 1000
SERVING_DTYPES = ("float32", "bfloat16", "int8")
EVAL_FIGURES = ("forward_network_evaluation.png", "pigan_evaluation.png",
                "structural_prediction_evaluation.png", "model_validation_evaluation.png",
                "evaluation_summary.png", "forward_predictions.png", "gan_comparison.png")


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


def screen_spectra(gen, b: int, dev, f_packed):
    """The screen's spectra: K5 on b random candidates, (b, S)."""
    import torch
    from pigan_thz_torch.ops import fused_kernels as fk

    pn = torch.rand((b, 4), generator=gen, device=dev) * 2 - 1
    return fk.forward_surrogate_fused(f_packed, pn)[0].contiguous()


def metrics_plain(freq, t, c1=None, c2=None):
    """K4's metrics entry's plain version on the card: ``spectrum_metrics``
    on the lattice's qualification."""
    from pigan_thz_torch.ops import peaks as pk

    return pk.spectrum_metrics(freq, t, c1, c2, qualified=pk.dip_qualification(t).qualified)


def compare_metrics(got, want) -> tuple:
    """(entries whose NaN-ness differs, other entries that differ, max
    |got - want| over those)."""
    nan_diff = int((got.isnan() != want.isnan()).sum())
    both = ~(got.isnan() | want.isnan())
    diff = got[both] != want[both]
    err = float((got[both] - want[both]).abs().max()) if both.any() else 0.0
    return nan_diff, int(diff.sum()), err


def phase6_k4(gen, cfg, dev, f_packed, repo: str) -> dict:
    """K4's two entries against their plain versions; returns the four-output
    entry's max |err| and mismatches and the metrics entry's differences."""
    import numpy as np
    import torch
    from pigan_thz_torch.ops import peaks as pk

    stats = {"max_abs_err": 0.0, "mask_mismatches": 0, "metrics_nan_diff": 0,
             "metrics_values_differing": 0, "metrics_max_abs_err": 0.0}
    plains = (("lattice", pk.dip_qualification),
              ("lifted", pk._dip_qualification_lifted))
    freq = cfg.data.frequencies.to(dev)

    def check_metrics(label, t, c1, c2):
        got = pk.batched_peak_metrics(freq, t, c1, c2)
        torch.cuda.synchronize()
        nan_diff, bad, err = compare_metrics(got, metrics_plain(freq, t, c1, c2))
        stats["metrics_nan_diff"] += nan_diff
        stats["metrics_values_differing"] += bad
        stats["metrics_max_abs_err"] = max(stats["metrics_max_abs_err"], err)
        if nan_diff or bad:
            fail(f"the metrics entry disagrees with spectrum_metrics on the lattice's "
                 f"qualification: {label}: {nan_diff} NaN-pattern differences, {bad} "
                 f"values differ, max|err| {err:.3e}")
        return f"metrics ({int(got[:, 2].isfinite().sum())} Q1): equal"

    for b in K4_BATCHES:
        classes = spectra_classes(gen, b, cfg, dev)
        classes["screen"] = screen_spectra(gen, b, dev, f_packed)
        for cls, t in classes.items():
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
            # centres: none, and per row from the grid with NaN in every third
            ci = torch.randint(0, t.shape[1], (2, b), generator=gen, device=dev)
            c1, c2 = freq[ci[0]], freq[ci[1]]
            c1[::3] = torch.nan
            line.append(check_metrics(f"B={b} {cls}", t, None, None))
            line.append(check_metrics(f"B={b} {cls} with centres", t, c1, c2)
                        + " with centres")
            print(f"K4 check B={b} {cls} ({int(got.is_peak.sum())} peaks, "
                  f"{int(got.qualified.sum())} qualified): " + "; ".join(line))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from peak_rows import hostile_rows

    f_h, t_h, c1_h, c2_h = (torch.from_numpy(np.asarray(a)).to(dev)
                            for a in hostile_rows(cfg.data.spectrum_dim))
    for label, c1, c2 in (("no centres", None, None), ("centres", c1_h, c2_h),
                          ("scalar centres", 0.9, 2.1)):
        got = pk.batched_peak_metrics(f_h, t_h, c1, c2)
        nan_diff, bad, _ = compare_metrics(got, metrics_plain(f_h, t_h, c1, c2))
        if nan_diff or bad:
            fail(f"the metrics entry disagrees with its plain version on hostile rows, "
                 f"{label}: {nan_diff} NaN-pattern differences, {bad} values differ")
        mism, _, _ = compare_k4(pk.batched_dip_qualification(t_h),
                                pk.dip_qualification(t_h))
        if mism:
            fail(f"dip_qualification disagrees with the lattice on hostile rows: {mism}")
    print(f"K4 check hostile rows ({t_h.shape[0]} of N = {t_h.shape[1]}: NaN, +-inf, "
          f"all-equal, border plateaus, border dips, ties): masks and metrics equal")
    print(f"K4 checks: {stats['mask_mismatches']} mask mismatches in all, max|err| "
          f"{stats['max_abs_err']:.3e} (prominence rtol {K4_PROM_RTOL}, width rtol "
          f"{K4_WIDTH_RTOL}); metrics entry: {stats['metrics_nan_diff']} NaN-pattern "
          f"differences, {stats['metrics_values_differing']} values differing")
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
                "fused_mlp_forward.wgmma": n_chunks if use_pallas else 0,   # chunks of 8192
                "fused_dense_chain": 0, "fused_residual_chain": 0,
                "dip_qualification": n_chunks, "forward_train": 0, "gan_train": 0,
                "gan_ensemble_train": 0,
                "brow_gemm": 0, "deep_narrow_gemm": 0, "batch_depth_gemm": 0, "sgemm": 0}
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


def k4_work(t, got) -> tuple:
    """(operations, bytes) of K4's four-output entry on spectra t with its
    result got, and of its metrics entry."""
    # The kernel's work depends on the data: two neighbour comparisons on
    # each side of every sample, and at each peak the walks to the higher
    # samples and the half-height crossings, at least the peak's width (in
    # samples) of loads, minima and comparisons on both sides.
    ops = 4.0 * t.numel() + 6.0 * float(got.width[got.is_peak].sum())
    b, n = t.shape
    # the metrics entry: the same, then two argmin passes over the row (a
    # select and a compare a sample); reads t, freq and two centres a row,
    # writes 8 floats a row
    return (ops, t.numel() * (4 + 1 + 1 + 4 + 4),
            ops + 4.0 * t.numel(), 4.0 * (t.numel() + n + 2 * b + 8 * b))


def phase9_k4_times(gen, cfg, dev, f_packed) -> dict:
    """K4's entries at B = 8192: the four-output entry on each class, beside
    both plain versions on the synthetic spectra and the surrogate's
    predictions (a screening chunk): name -> (kernel, lattice, lifted) ms
    (None where not timed); the metrics entry on the screen's spectra and on
    the synthetic ones with centres beside its plain version: "metrics
    <name>" -> dict of ms."""
    import torch
    from pigan_thz_torch.ops import peaks as pk

    b = K4_BATCHES[-1]
    inputs = spectra_classes(gen, b, cfg, dev)
    inputs["screen"] = screen_spectra(gen, b, dev, f_packed)
    times = {}
    # The kernel's work depends on the data: two neighbour comparisons on
    # each side of every sample, and at each peak the walks to the higher
    # samples and the half-height crossings, at least the peak's width (in
    # samples) of loads, minima and comparisons on both sides.
    times["work"] = k4_work(inputs["screen"], pk.batched_dip_qualification(inputs["screen"]))
    for name, t in inputs.items():
        if name not in ("synthetic", "screen"):
            times[name] = (cuda_median_ms(pk.batched_dip_qualification, t), None, None)
            continue
        # plain, kernel, kernel, plain: the best of each side's two runs
        p1 = cuda_median_ms(pk.dip_qualification, t, warmup=3, reps=10)
        l1 = cuda_median_ms(pk._dip_qualification_lifted, t, warmup=3, reps=20)
        k1 = cuda_median_ms(pk.batched_dip_qualification, t)
        k2 = cuda_median_ms(pk.batched_dip_qualification, t)
        l2 = cuda_median_ms(pk._dip_qualification_lifted, t, warmup=3, reps=20)
        p2 = cuda_median_ms(pk.dip_qualification, t, warmup=3, reps=10)
        times[name] = (min(k1, k2), min(p1, p2), min(l1, l2))

    freq = cfg.data.frequencies.to(dev)
    ci = torch.randint(0, freq.shape[0], (2, b), generator=gen, device=dev)
    centres = {"screen": (None, None), "synthetic": (freq[ci[0]], freq[ci[1]])}
    for name, (c1, c2) in centres.items():
        t = inputs[name]
        runs = {
            # the whole function in plain torch: the sparse-table form, then
            # selection and FWHM
            "plain": lambda: pk.spectrum_metrics(
                freq, t, c1, c2, qualified=pk._dip_qualification_lifted(t).qualified),
            # selection and FWHM alone, the mask given
            "selection": lambda q=pk.batched_dip_qualification(t).qualified:
                pk.spectrum_metrics(freq, t, c1, c2, qualified=q),
            # the four-output entry, then selection and FWHM in torch
            "two_step": lambda: pk.spectrum_metrics(
                freq, t, c1, c2, qualified=pk.batched_dip_qualification(t).qualified),
            "kernel": lambda: pk.batched_peak_metrics(freq, t, c1, c2),
        }
        ms = {k: [] for k in runs}
        for k in (*runs, *reversed(runs)):
            ms[k].append(cuda_median_ms(runs[k], warmup=3, reps=20))
        times["metrics " + name] = {k: min(v) for k, v in ms.items()}
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


def k1_first_step_distances(spec, start, streams, faults=()) -> dict:
    """K1's first step from ``start`` (params, m, v) on the first step of
    ``streams``, its plain version's in float32 and in float64 (and with
    each of ``faults``, in float64): the rows' max relative distance from
    the float64 run, and Adam's first moments' relative L2 distance tensor
    by tensor (``k1_first_moments``): {"rows": {run: x}, "moments": {run:
    {tensor: x}}, "faulty": {fault: {tensor: the kernel's distance from the
    faulty run}}, "launches": K1's launches in the kernel's run}."""
    import torch
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops._cuda_build import LAUNCHES

    one = streams._replace(params_norm=streams.params_norm[:1].contiguous(),
                           spectra=streams.spectra[:1].contiguous(),
                           metrics_norm=streams.metrics_norm[:1].contiguous(),
                           sched=streams.sched[:1], seeds=streams.seeds[:1])

    def run(dbl=False, faults_=(), kernel=False):
        bufs = [t.clone().double() if dbl else t.clone() for t in start]
        if kernel:
            rows = ft.forward_train(*bufs, one, spec)
        else:
            rows = ft.forward_train_plain(*bufs, one, spec, faults=faults_)
        torch.cuda.synchronize()
        return rows.double(), k1_first_moments(spec, bufs[1])

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))

    before = LAUNCHES["forward_train"]
    runs = {"kernel": run(kernel=True)}
    launches = LAUNCHES["forward_train"] - before
    runs["plain"] = run()
    rows_x, mx = run(dbl=True)
    out = {"rows": {}, "moments": {}, "faulty": {}, "launches": launches}
    for name, (rows, m) in runs.items():
        out["rows"][name] = float(((rows - rows_x).abs() / rows_x.abs()).max())
        out["moments"][name] = {k: rel(m[k], mx[k]) for k in mx}
    mk = runs["kernel"][1]
    for fault in faults:
        _, mw = run(dbl=True, faults_=(fault,))
        out["faulty"][fault] = {k: rel(mk[k], mw[k]) for k in mw}
    return out


def k1_first_step(label: str, spec, start, streams, floor: float, row_floor: float,
                  faults) -> dict:
    """K1's first step against its plain version run in float64
    (``k1_first_step_distances``): the rows and Adam's first moments tensor
    by tensor within K2_ROUNDING times the float32 plain version's distance,
    or ``floor`` (``row_floor`` for the rows); each of ``faults`` is
    K1_BF16_FAULT_RATIO times further from the kernel than the right run on
    some tensor.  One step is one launch.  Returns the distances and each
    fault's ratio."""
    d = k1_first_step_distances(spec, start, streams, faults)
    if d["launches"] != 1:
        fail(f"{label}: one step was not one launch")
    e_k, e_p = d["moments"]["kernel"], d["moments"]["plain"]
    row_k, row_p = d["rows"]["kernel"], d["rows"]["plain"]
    bad = {k: (e_k[k], e_p[k]) for k in e_k if not e_k[k] <= max(K2_ROUNDING * e_p[k], floor)}
    worst = max(e_k, key=e_k.get)
    print(f"{label}, first step against the float64 plain version: rows max rel err kernel "
          f"{row_k:.3e}, float32 plain {row_p:.3e}; Adam's first moments by tensor, worst "
          f"{worst} kernel {e_k[worst]:.3e} (float32 plain {e_p[worst]:.3e}); head metrics "
          f"rows kernel {e_k['head W metrics rows']:.3e} (float32 plain "
          f"{e_p['head W metrics rows']:.3e}); {len(bad)} of {len(e_k)} tensors beyond "
          f"{K2_ROUNDING}x the float32 plain version or {floor}")
    if bad or row_k > max(row_floor, K2_ROUNDING * row_p):
        fail(f"{label}: the first step is further from float64 than rounding: {bad}")
    ratios = {}
    for fault, e_w in d["faulty"].items():
        ratio = {k: e_w[k] / max(e_k[k], e_p[k], 1e-9) for k in e_w}
        seen = max(ratio, key=ratio.get)
        print(f"{label} against the float64 plain version with '{fault}': the kernel is "
              f"{ratio[seen]:.1f}x further from it than from the right run on {seen} "
              f"({e_w[seen]:.3e} of the tensor)")
        if not ratio[seen] > K1_BF16_FAULT_RATIO:
            fail(f"{label}: the first-step check does not see '{fault}'")
        ratios[fault] = ratio[seen]
    return {"first_step_rel": e_k[worst], "worst": worst, "plain_rel": e_p[worst],
            "rows_rel": row_k, "plain_rows_rel": row_p, "fault_ratio": ratios}


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
    # the first step against float64, at the published dropout
    spec = ft.forward_train_spec(cfg, settings)
    state, _, _, _, streams = k1_setup(cfg, dev, ds, 1)
    gate = k1_first_step("K1 float32", spec, (state.params, state.opt.m, state.opt.v),
                         streams, K2_STEP_FLOOR[1], K2_STEP_FLOOR[1], K1_FP32_FAULTS)
    stats = {"max_abs_err": 0.0, "rows_rel": 0.0, "first_step": gate}
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
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.serve import make_inverse_design_fn
    from pigan_thz_torch.train import checkpoint as ckpt
    from pigan_thz_torch.train.steps import ForwardStepSettings

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
        # every step's batch-row products through brow_gemm.cuh (brow_products)
        steps = PRETRAIN_EPOCHS * (cfg.data.num_samples // cfg.train.batch_size)
        want = steps * len(ft.brow_products(ft.forward_train_spec(cfg, ForwardStepSettings()),
                                            cfg.train.batch_size))
        if launches.get("brow_gemm") != want:
            fail(f"pretrain-forward launched the batch-row kernel {launches.get('brow_gemm')} "
                 f"times, brow_products says {want}")

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


def phase12_k1_times(cfg, dev, ds) -> dict:
    """Per-epoch CUDA-event medians (ms) of K1, its plain version and the
    eager step, one epoch each from one state; the launches a step and the
    batch-row launches a step as the C loop counts them (held to 36 and to
    ``brow_products``); and a torch.profiler breakdown of one K1 launch of 5
    epochs."""
    import torch
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops._cuda_build import report_of
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
    steps = streams.params_norm.shape[0]
    report = report_of(ft.forward_train(*kern, streams, spec))
    a_step = report.kernels / steps
    brow_a_step = report.brow / steps
    listed = len(ft.brow_products(spec, cfg.train.batch_size))
    print(f"K1: {a_step:g} launches a step, {brow_a_step:g} of them batch-row products "
          f"through brow_gemm.cuh (brow_products lists {listed})")
    if a_step != 36 or brow_a_step != listed:
        fail(f"K1 enqueues {a_step:g} launches a step ({brow_a_step:g} batch-row), not 36 "
             f"({listed})")
    state5, _, _, _, streams5 = k1_setup(cfg, dev, ds, 5)
    bufs5 = [state5.params, state5.opt.m, state5.opt.v]
    prof = profile_launch("one K1 launch of 5 epochs, dropout "
                          f"{cfg.forward_model.dropout_rate}",
                          lambda: ft.forward_train(*bufs5, streams5, spec),
                          streams5.params_norm.shape[0])
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "eager_ms": min(e1, e2),
            "a_step": a_step, "brow_a_step": brow_a_step, "profile": prof}


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


def check_brow_launches(label: str, rows, spec, streams, batch: int) -> int:
    """The batch-row kernel's launches in the K2 / K3 chunk that returned
    ``rows``, as its C loop counted them, against ``brow_products`` over the
    chunk's steps (D's update per the schedule's gate): every batch-row
    product of every step went through ``brow_gemm.cuh``.  Returns the
    count."""
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.ops._cuda_build import report_of

    gates = (streams.sched[:, gt.SCHED_LANES.index("d_gate")] > 0).tolist()
    want = sum(len(gt.brow_products(spec, batch, bool(u))) for u in gates)
    got = report_of(rows).brow
    if got != want:
        fail(f"{label}: {got} batch-row kernel launches in {len(gates)} steps, "
             f"brow_products says {want}")
    return got


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
    from pigan_thz_torch.ops._cuda_build import LAUNCHES, report_of
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
        brow = check_brow_launches(label, rows, spec, streams, b)
        print(f"{label}: {brow} batch-row products through brow_gemm in {steps} steps, "
              f"{report_of(rows).kernels} launches in all")
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
                  extra: tuple = (), then=None) -> dict:
    """``train --mode full`` at the reference workload in a subprocess, as
    typed (the PI-GAN phase with F's input detached) or, with ``fixed``,
    with ``--fixed-physics`` (gradients through the frozen F); the trained G
    and F then serve one request.  ``then(models_dir)`` runs on the saved
    trio before its directory goes.  Returns its launches, wall time and
    metric curves, and what ``then`` returned."""
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
        after = then(out) if then is not None else None
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
    return {"launches": launches, "wall": wall, "curves": curves, "r2": r2, "then": after}


def evaluate_command(repo: str, models: str, *extra) -> tuple:
    """``python -m pigan_thz_torch evaluate --models models`` in a
    subprocess: (its stdout, its launches, wall s)."""
    cmd = [sys.executable, "-m", "pigan_thz_torch", "evaluate", "--models", models, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"evaluate {' '.join(extra)} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, launches_line(proc.stdout, "evaluate " + " ".join(extra)), wall


def flat_scalars(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_scalars(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def scalars_apart(got: dict, want: dict) -> tuple:
    """(the key furthest apart, its distance relative to max(1, |want|))."""
    got, want = flat_scalars(got), flat_scalars(want)
    if set(got) != set(want):
        fail(f"the results' keys differ: {sorted(set(got) ^ set(want))}")
    worst = max(want, key=lambda k: abs(got[k] - want[k]) / max(1.0, abs(want[k])))
    return worst, abs(got[worst] - want[worst]) / max(1.0, abs(want[worst]))


def phase31_evaluate(cfg, dev, repo: str, models: str, tag: str) -> dict:
    """The evaluation entry point on a trained trio (``models``): (a) the
    noise ceilings on the card against the CPU; (b) the suites, ceilings,
    oracle and report in this process against the CPU; (c) the evaluate
    command as typed, and ``--suite pigan``; (d) the held-out protocol of
    ``train --holdout`` / ``evaluate --holdout``; (e) ``--violation-window
    sane`` with ``--plot``.  Returns the main-path launches of its commands
    and its numbers."""
    import copy
    import glob
    import re
    import torch
    from pigan_thz_torch.evaluate import (
        SUITE_RUBRICS, Evaluator, generate_summary_report, noise_ceilings, oracle_validation)
    from pigan_thz_torch.evaluate import ceilings as ce
    from pigan_thz_torch.ops._cuda_build import LAUNCHES, launch_counts
    from pigan_thz_torch.train.trainer import Trainer

    # -- (a) the ceilings: two launches of K4's metrics entry
    before = LAUNCHES["dip_qualification"]
    card = noise_ceilings(cfg.data, device=dev)
    torch.cuda.synchronize()
    k4 = LAUNCHES["dip_qualification"] - before
    cpu = noise_ceilings(cfg.data, device="cpu")
    draws = ce.ceiling_draws(cfg.data)
    _, card_m = ce.ceilings_from_draws(*(t.to(dev) for t in draws), cfg.data.noise_level)
    _, cpu_m = ce.ceilings_from_draws(*draws, cfg.data.noise_level)
    same = all(nan_equal(a.cpu(), b) for a, b in zip(card_m, cpu_m))
    apart = max(abs(card[k] - cpu[k]) for k in cpu)
    print(f"evaluate: noise_ceilings on the card: {k4} K4 launches; spectrum R2 ceiling "
          f"{card['spectrum_r2_ceiling']:.4f}, metrics R2 ceiling "
          f"{card['metrics_r2_ceiling']:.4f}, cycle-error floor "
          f"{card['cycle_error_floor']:.4g}, draw-to-draw spectrum / metrics R2 "
          f"{card['draw_to_draw_spectrum_r2']:.4f} / {card['draw_to_draw_metrics_r2']:.4f} "
          f"(the JAX package's 0.4978 / 0.7879 / 0.01 from its own draws, RESULTS.md); "
          f"the two draws' metrics equal to the CPU's (NaN pattern and values): {same}; "
          f"ceilings at most {apart:.3e} from the CPU's (tol {CEILING_TOL})")
    if k4 != 2 or not same or not apart <= CEILING_TOL:
        fail("the noise ceilings on the card do not match the CPU's plain versions")

    # -- (b) in this process, on the card and on the CPU
    trainer = Trainer(cfg, device=dev)
    trainer.load_final(models)
    ds, st = trainer.ds, trainer.pigan_state
    ev = trainer.evaluator()
    results = ev.run_comprehensive_evaluation(ds)
    oracle = oracle_validation(ev, ds)
    cpu_ds = ds._replace(**{k: v.cpu() for k, v in ds._asdict().items()})
    cpu_ev = Evaluator(*(copy.deepcopy(m).cpu() for m in (st.g, st.d, st.f)))
    key, err = scalars_apart({**results, "oracle": oracle},
                             {**cpu_ev.run_comprehensive_evaluation(cpu_ds),
                              "oracle": oracle_validation(cpu_ev, cpu_ds)})
    eval_ms = cuda_median_ms(lambda: ev.run_comprehensive_evaluation(ds), warmup=3, reps=20)
    extras_ms = cuda_median_ms(lambda: (noise_ceilings(cfg.data, device=dev),
                                        oracle_validation(ev, ds)), warmup=2, reps=10)
    print(f"evaluate (in process): the four suites and the oracle on the card against the "
          f"same trio and dataset tensors on the CPU: furthest apart {key}, {err:.3e} "
          f"(tol {EVAL_TOL}, relative to max(1, |x|))")
    if not err <= EVAL_TOL:
        fail(f"the evaluation on the card differs from the CPU's at {key} by {err:.3e}")
    report = generate_summary_report(results, ceilings=card, oracle=oracle)
    lines = report.splitlines()
    start = lines.index("5. TARGETS vs ACHIEVABLE CEILINGS")
    section = lines[start:start + 10]
    for line in section:
        print(f"evaluate (in process): {line}")
    (adjusted,) = [ln for ln in lines if ln.startswith("CEILING-ADJUSTED RATING")]
    met, total = map(int, re.search(r"\((\d+)/(\d+) targets", adjusted).groups())
    print(f"evaluate (in process): {adjusted}; the JAX package's 500 + 500 run: EXCELLENT "
          f"(7/7 targets met or at the statistical limit), RESULTS.md")
    (param_line,) = [ln for ln in section if ln.startswith("parameter R2")]
    if not param_line.endswith("TARGET MET"):
        fail(f"param R2 did not meet its target: {param_line}")
    # held to the JAX package's 7/7 on its 500 + 500 run (RESULTS.md): every
    # card run of the --fixed-physics trio has shown it (H100: phase 14's
    # trio twice, seeds 1 and 2 once each), the noisy cycle error,
    # 0.01036-0.01037, nearest its cut (1.1 x the 0.01 floor)
    if (met, total) != (7, 7):
        fail(f"the ceiling-adjusted count is {met}/{total}, not 7/7")

    launches = {k: 0 for k in launch_counts()}

    def add(counted):
        for k in launches:
            launches[k] += counted.get(k, 0)

    with tempfile.TemporaryDirectory() as tmp:
        # -- (c) the command as typed, and one suite
        path = os.path.join(tmp, "eval.json")
        said, counted, wall_c = evaluate_command(repo, models, "--json", path)
        add(counted)
        with open(path) as fh:
            got = json.load(fh)
        saved_report = os.path.isfile(os.path.join(models, "unified_evaluation_report.txt"))
        print(f"evaluate --models OUT --json: {wall_c:.3f} s wall, launches {counted}, keys "
              f"{sorted(got)}, unified_evaluation_report.txt written: {saved_report}")
        if counted["dip_qualification"] != 3 or set(got) != EVAL_KEYS or not saved_report \
                or "5. TARGETS vs ACHIEVABLE CEILINGS" not in said:
            fail("evaluate did not launch K4 3 times, print the target report and write "
                 "the JAX command's JSON keys and its report")
        key, err = scalars_apart({k: got[k] for k in EVAL_KEYS - {"evaluation_time"}},
                                 {**results, "noise_ceilings": card,
                                  "oracle_validation": oracle})
        print(f"evaluate --models OUT: its numbers against this process's on the card "
              f"(one dataset seed, one trio): furthest apart {key}, {err:.3e} (printed)")
        path = os.path.join(tmp, "pigan.json")
        said, counted, _ = evaluate_command(repo, models, "--suite", "pigan", "--json", path)
        add(counted)
        with open(path) as fh:
            rubric = SUITE_RUBRICS["pigan"](json.load(fh))
        for line in rubric.splitlines():
            print(f"evaluate --suite pigan: {line}")
        if not said.startswith(rubric + "\n"):
            fail("evaluate --suite pigan did not print the suite's rubric")

        # -- (e) the sane window, with the figures where matplotlib imports
        try:
            import matplotlib  # noqa: F401
            plot = ["--plot"]
        except ImportError:
            plot = []
        path = os.path.join(tmp, "sane.json")
        said, counted, wall_e = evaluate_command(repo, models, "--violation-window", "sane",
                                                 "--json", path, *plot)
        add(counted)
        with open(path) as fh:
            rate = json.load(fh)["structural_prediction_evaluation"][
                "param_range_violation_rate"]
        print(f"evaluate --violation-window sane{' --plot' if plot else ''}: violation rate "
              f"{rate} (the JAX package's 0, RESULTS.md), {wall_e:.3f} s wall")
        if rate != 0.0 or "Parameter Violation Rate: 0.0000" not in said:
            fail("evaluate --violation-window sane did not print violation rate 0")
        if plot:
            sizes = {f: os.path.getsize(os.path.join(models, f))
                     if os.path.isfile(os.path.join(models, f)) else 0 for f in EVAL_FIGURES}
            print(f"evaluate --plot: {sizes}")
            if min(sizes.values()) < 10_000:
                fail("evaluate --plot did not write the seven figures")
        else:
            print("evaluate --plot: matplotlib does not import on this machine, so --plot "
                  "was not run")

        # -- (d) the held-out protocol
        work = os.path.join(tmp, "holdout")
        cmd = [sys.executable, "-m", "pigan_thz_torch", "train", "--mode", "full",
               "--fixed-physics", "--holdout", HOLDOUT[0], "--holdout-seed", HOLDOUT[1],
               "--forward-epochs", str(PRETRAIN_EPOCHS), "--epochs", str(GAN_EPOCHS),
               "--workdir", work, "--no-tensorboard"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
        wall_d = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"train --holdout exited {proc.returncode}: {proc.stderr[-3000:]}")
        counted = launches_line(proc.stdout, "train --holdout")
        add(counted)
        chunks = {"forward_train": -(-PRETRAIN_EPOCHS // EPOCHS_PER_CALL),
                  "gan_train": -(-GAN_EPOCHS // EPOCHS_PER_CALL)}
        (summary_path,) = glob.glob(os.path.join(work, "train_full_*", "holdout_eval.json"))
        with open(summary_path) as fh:
            summary = json.load(fh)
        path = os.path.join(tmp, "holdout.json")
        said, counted_h, wall_h = evaluate_command(
            repo, os.path.join(work, "saved_models"), "--holdout", HOLDOUT[0],
            "--holdout-seed", HOLDOUT[1], "--json", path)
        add(counted_h)
        with open(path) as fh:
            comparison = json.load(fh)["holdout_comparison"]
        held = summary["heldout"]
        print(f"train --mode full --fixed-physics --holdout {HOLDOUT[0]} --holdout-seed "
              f"{HOLDOUT[1]}: {PRETRAIN_EPOCHS} + {GAN_EPOCHS} epochs on the 800-cell split in "
              f"{wall_d:.3f} s wall, launches {counted}; train rows {summary['train']}")
        print(f"evaluate --holdout {HOLDOUT[0]} --holdout-seed {HOLDOUT[1]}: {wall_h:.3f} s "
              f"wall, launches {counted_h}; held-out row {comparison['heldout']}, equal to "
              f"train's holdout_eval.json field by field: {comparison['heldout'] == held}")
        print(f"held-out param / spectrum / metrics R2 {held['param_r2']:.4f} / "
              f"{held['spectrum_r2']:.4f} / {held['metrics_r2']:.4f} (the JAX package records "
              f"0.9614 / 0.488 / 0.774 at 1000 GAN epochs, RESULTS.md; printed, not gated)")
        if any(counted.get(k) != n for k, n in chunks.items()) or \
                comparison["heldout"] != held or comparison["train"] != summary["train"]:
            fail("train --holdout and evaluate --holdout disagree, or train did not launch "
                 "K1 and K2 once per chunk")
    print(f"time {tag} evaluate: the four suites {eval_ms:.4f} ms a comprehensive evaluation, "
          f"ceilings + oracle {extras_ms:.4f} ms (CUDA-event medians); the command "
          f"{wall_c:.3f} s wall, with the sane window{' and the figures' if plot else ''} "
          f"{wall_e:.3f} s; train --holdout {wall_d:.3f} s and evaluate --holdout "
          f"{wall_h:.3f} s wall")
    return {"launches": launches, "ceilings": card, "eval_ms": eval_ms,
            "ceilings_oracle_ms": extras_ms, "adjusted": f"{met}/{total}",
            "walls": {"evaluate": wall_c, "evaluate_sane": wall_e, "train_holdout": wall_d,
                      "evaluate_holdout": wall_h},
            "heldout": held, "plot": bool(plot)}


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
    out["profile"] = profile_launch("one K2 launch of 5 epochs through F",
                                    lambda: gt.gan_train(bufs, streams, spec),
                                    streams.spectra.shape[0])
    return out


def profile_launch(label: str, launch, steps: int) -> dict:
    """``launch()`` (one kernel launch of ``steps`` steps) under
    ``torch.profiler`` after 2 warm-up launches: prints the wall time, the
    kernel time, the idle share and the kernels by time; returns them, with
    the device time and calls a step of the batch-row kernel, of the deep
    narrow and batch-depth kernels, of the tiled SGEMM and of the rest."""
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
    idle = max(0.0, 1.0 - busy_ms / wall_ms)
    print(f"profile: {label} ({steps} steps): {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of "
          f"kernel time, idle share {idle:.3f}, "
          f"{sum(c for _, c, _ in kernels) / steps:.1f} kernels a step")
    for key, count, total in sorted(kernels, key=lambda r: -r[2])[:14]:
        print(f"profile:   {total / 1e3:9.3f} ms  {count:6d} calls  {total / count:8.2f} us  "
              f"{key[:100]}")
    marks = {"brow_gemm": "brow_gemm_kernel", "deep_narrow": "deep_narrow_gemm<",
             "batch_depth": "batch_depth_gemm<", "sgemm": "sgemm<"}
    kinds = {k: [0.0, 0] for k in (*marks, "other")}
    for key, count, total in kernels:
        kind = next((k for k, mark in marks.items() if mark in key), "other")
        kinds[kind][0] += total / 1e3
        kinds[kind][1] += count
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms, "idle_share": idle,
            "by_kind_ms": {k: v[0] for k, v in kinds.items()},
            "by_kind_calls_a_step": {k: v[1] / steps for k, v in kinds.items()},
            "by_kernel": [[key[:100], count, total / 1e3]
                          for key, count, total in sorted(kernels, key=lambda r: -r[2])[:8]]}


def profile_cycle(fn, spectra, label: str, calls: int = 1) -> dict:
    """``calls`` serving requests ``fn(spectra)`` under ``torch.profiler``
    after 3 warm-up requests: prints and returns the wall time, kernel time
    and kernels a request, the idle share and the kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(3):
            fn(spectra)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(spectra)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [(ev.key, ev.count, getattr(ev, "device_time_total",
                                          getattr(ev, "cuda_time_total", 0.0)))
               for ev in prof.key_averages()
               if getattr(ev, "device_type", None) is not None
               and "cuda" in str(ev.device_type).lower()]
    busy_ms = sum(t for _, _, t in kernels) / 1e3 / calls
    idle = max(0.0, 1.0 - busy_ms / wall_ms)
    n_kernels = sum(c for _, c, _ in kernels) / calls
    print(f"profile: {label}: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of kernel time, "
          f"idle share {idle:.3f}, {n_kernels:g} kernels"
          + ("" if calls == 1 else f" (a call, over {calls} calls)"))
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    for key, count, total in top:
        print(f"profile:   {total / 1e3:9.4f} ms  {count:3d} calls  {key[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms, "idle_share": idle,
            "kernels": n_kernels, "calls": calls,
            "by_kernel": [[key[:90], count, total / 1e3] for key, count, total in top]}


def phase30_chunk_profile(F, cfg, dev, tag: str) -> dict:
    """Chunks of the fused screen (K5, then K4's metrics entry, the scores)
    under ``torch.profiler`` after warm-up; returns the profile a chunk."""
    import torch
    from pigan_thz_torch.design import ScreeningConfig, screen_chunk
    from pigan_thz_torch.design.screening import make_surrogate

    sc = ScreeningConfig(use_pallas=True)
    freq = cfg.data.frequencies.to(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    pn = torch.rand((sc.chunk_size, 4), generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        surrogate = make_surrogate(F, True, dev, cfg.data.spectrum_dim)
    # five chunks: a profiler session can lose its first kernels
    return profile_cycle(lambda x: screen_chunk(surrogate, x, freq, sc), pn,
                         f"{tag} one fused screening chunk B={sc.chunk_size}", calls=5)


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
        check_brow_launches(f"K3 {name}", rows, spec, streams, cfg.train.batch_size)
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
                      unpacked: bool, holdout: bool = False) -> tuple:
    """``examples/torch_seed_ensemble.py`` with K3_MEMBERS members in a
    subprocess (with ``holdout`` on the 800-cell split); returns (its JSON
    line, its saved stacked state, wall s)."""
    import torch

    saved = os.path.join(tmp, f"{tag}.pt")
    cmd = [sys.executable, os.path.join("examples", "torch_seed_ensemble.py"), "--members",
           str(K3_MEMBERS), "--epochs", str(epochs), "--fwd-epochs", str(fwd_epochs),
           "--epochs-per-call", str(EPOCHS_PER_CALL), "--save", saved,
           *(["--unpacked"] if unpacked else []), *(["--holdout"] if holdout else [])]
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

    name = f"torch_seed_ensemble --members {K3_MEMBERS} --epochs {GAN_EPOCHS} --holdout"
    chunks = -(-GAN_EPOCHS // EPOCHS_PER_CALL)
    f_chunks = -(-PRETRAIN_EPOCHS // EPOCHS_PER_CALL)
    with tempfile.TemporaryDirectory() as tmp:
        out, saved, wall = run_seed_ensemble(repo, tmp, "main", GAN_EPOCHS, PRETRAIN_EPOCHS,
                                             False, holdout=True)
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
        print(f"{name}: param R2 over the {out['train_cells']} training cells per member "
              + ", ".join(f"{x:.4f}" for x in out["member_r2"])
              + f"; of the members' mean {out['ensemble_mean_r2']:.4f}; member spread "
              f"{out['member_spread']:.4f}; recon MSE per member "
              + ", ".join(f"{x:.5f}" for x in out["member_recon_mse"])
              + f", of the mean {out['ensemble_mean_recon_mse']:.5f} (printed, not gated; "
              "one member through K2 reaches 0.98, phase 14)")
        print(f"{name}: param R2 over the {out['heldout_cells']} held-out cells per member "
              + ", ".join(f"{x:.4f}" for x in out["heldout_member_r2"])
              + f"; of the members' mean {out['heldout_ensemble_mean_r2']:.4f} (the JAX "
              "package's held-out mean 0.9811 at 8000 epochs, RESULTS.md; printed, not gated)")
        if out["heldout_cells"] + out["train_cells"] != cfg.data.num_samples:
            fail(f"{name}: the split does not cover the {cfg.data.num_samples} cells")

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
            "short": (packed["member_steps_per_s"], unpacked["member_steps_per_s"]),
            "saved": saved}


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
    from pigan_thz_torch.ops._cuda_build import LAUNCHES, launch_counts
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
    counted = launch_counts()
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
            or counted["brow_gemm"] < 13 * gan_epochs * spe
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
    from pigan_thz_torch.ops._cuda_build import report_of

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
        rows = gt.gan_train(bufs, streams, spec)
        out["launches_a_step"][name] = report_of(rows).kernels / streams.spectra.shape[0]
    # the idle share as phase 15 takes today's: one launch of 5 epochs
    state, _, _, spec5, _, _, _, streams5 = k2_setup(cfg, dev, ds, f, 5, variants["both"])
    bufs5 = gt.state_buffers(state)
    out["both_idle_share"] = profile_launch(
        "one K2 launch of 5 epochs through F, cycle + stability",
        lambda: gt.gan_train(bufs5, streams5, spec5), streams5.spectra.shape[0])["idle_share"]
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
    rows = gt.gan_ensemble_train(bufs, streams, spec)
    out["launches_a_step"]["k3 both"] = report_of(rows).kernels / streams.spectra.shape[1]
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
    rows apart: {name: flat float64 tensor}."""
    return {k: t.reshape(-1).double() for k, t in spec.named_tensors(m).items()}


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
    gate = k1_first_step("K1 bf16", spec, start, streams, K1_BF16_STEP_FLOOR, 1e-4, ft.FAULTS)
    stats["k1_first_step_rel"] = gate["first_step_rel"]

    def run(streams_, dbl=False):
        bufs = [t.clone().double() if dbl else t.clone() for t in start]
        if dbl:
            rows = ft.forward_train_plain(*bufs, streams_, spec)
        else:
            rows = ft.forward_train(*bufs, streams_, spec)
        return rows, bufs

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
        check_brow_launches(f"K2 {name}", rows, spec, streams, cfg.train.batch_size)
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
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.ops._cuda_build import LAUNCHES, launch_counts
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
    counted = launch_counts()
    st = trainer.pigan_state
    with torch.inference_mode():
        r2 = float(r2_score(train_ds.params_norm, st.g.eval()(train_ds.spectra).float()))
    recon, dl = hist["pigan/recon_spec_loss"], hist["pigan/d_loss"]
    finite = all(x == x and abs(x) != float("inf") for v in hist.values() for x in v)
    print(f"Trainer.train_pigan({GAN_EPOCHS} epochs, gan_loss='wgan_gp', through F) after "
          f"{PRETRAIN_EPOCHS} forward epochs: {wall:.3f} s, launches {counted}; critic loss "
          f"{dl[0]:.4f} -> {dl[-1]:.4f}, recon_spec_loss {recon[0]:.6f} -> {recon[-1]:.6f}, "
          f"param R2 over the training set {r2:.4f}; all curves finite: {finite}")
    # every step's batch-row products through brow_gemm: 18 a step with D's
    # update gated off, 25 with it (brow_products)
    spe = train_ds.num_samples // cfg.train.batch_size
    spec = gt.gan_train_spec(cfg, settings)
    lo, hi = (len(gt.brow_products(spec, cfg.train.batch_size, u)) * GAN_EPOCHS * spe
              for u in (False, True))
    if (counted["gan_train"] != -(-GAN_EPOCHS // EPOCHS_PER_CALL) or not finite
            or not recon[-1] < 0.5 * recon[0] or not lo <= counted["brow_gemm"] <= hi):
        fail("the WGAN-GP train_pigan did not train through K2, one launch per chunk "
             f"({lo} to {hi} batch-row products), to a halved recon_spec_loss")
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
    from pigan_thz_torch.ops._cuda_build import report_of
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
        rows = gt.gan_train(bufs, streams, spec)
        out["launches_a_step"][name] = report_of(rows).kernels / streams.spectra.shape[0]
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


# The batch-row products (phase 29), each against brow_gemm_plain (the same
# K slices, summed in rank order) and against float64 of the same operands
# (of the bfloat16-rounded ones on the bf16 path), both within a multiple of
# the float32 worst-case sum bound (K + S + 2) u sum |a| |b| (+ |bias|),
# u = 2^-24, doubled because the tensor cores' fp32 accumulation may
# truncate where the FMAs round: the same bound as tests/test_torch_cuda.py.
BROW_TOL_FLOAT64 = 1.0     # of the doubled bound
BROW_TOL_PLAIN = 1.5       # the kernel and its plain version each within the bound
BROW_MEMBERS = (1, 4)
BROW_CALLS = 20            # launches a CUDA graph, a route and shape


def brow_step_products(cfg) -> dict:
    """{(m, n, k, bnc, rnd, bias): {"name": the first step product of that
    shape and flags, "a_step": {path: launches a step}}} over the paths whose
    batch-row products differ: K2 through F, detached, both second passes,
    WGAN-GP (a D-update step) and bfloat16 operands; K1 ("K1", "K1 bf16")."""
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.train.steps import ForwardStepSettings, StepSettings

    paths = {"through F": (cfg, dict(detach_forward=False)),
             "detached": (cfg, dict(detach_forward=True)),
             "cycle + stability": (cfg, dict(detach_forward=False, cycle_w=1.0,
                                             stability_w=1.0)),
             "WGAN-GP": (cfg, dict(detach_forward=False, gan_loss="wgan_gp")),
             "bf16": (bf16_config(cfg), dict(detach_forward=False))}
    out = {}
    for path, (c, knobs) in paths.items():
        spec = gt.gan_train_spec(c, StepSettings.from_config(c, **knobs))
        for p in gt.brow_products(spec, c.train.batch_size):
            key = (p.m, p.n, p.k, p.bnc, p.rnd, p.bias)
            entry = out.setdefault(key, {"name": p.name, "a_step": {}})
            entry["a_step"][path] = entry["a_step"].get(path, 0) + 1
    for path, c in (("K1", cfg), ("K1 bf16", bf16_config(cfg))):
        for p in ft.brow_products(ft.forward_train_spec(c, ForwardStepSettings()),
                                  c.train.batch_size):
            key = (p.m, p.n, p.k, p.bnc, p.rnd, p.bias)
            entry = out.setdefault(key, {"name": f"K1 {p.name}", "a_step": {}})
            entry["a_step"][path] = entry["a_step"].get(path, 0) + 1
    return out


def graph_us(fn, calls: int = BROW_CALLS) -> float:
    """us a call of ``fn`` back to back on the card: ``calls`` calls captured
    in one CUDA graph, its replay timed with CUDA events (median of 5 after
    2 warm-up replays), so no host work sits between the launches.  (A
    torch.profiler session drops the first kernels it sees, and a product's
    launch from Python costs the host more than the product costs the card.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) * 1e3 / calls


def phase29_brow_products(cfg, dev, tag: str) -> dict:
    """Every batch-row product shape and flag of a K2 step at M = 1 and 4:
    the plan (the C rule against its Python mirror), the kernel against its
    plain version and float64 (BROW_TOL_*), a rerun bit-identical, at M = 4
    each member bit for bit the launch on it alone; device us of the
    kernel, of the tiled SGEMM the step used before and of torch.matmul on
    the same operands (a yardstick the port never calls), beside the
    roofline (back to back in a CUDA graph)."""
    import torch
    from pigan_thz_torch.ops import brow

    products = brow_step_products(cfg)
    rows = []
    for (m, n, k, bnc, rnd, with_bias), entry in sorted(products.items()):
        plan = brow.brow_plan(m, n, k)
        if brow.brow_plan_on_card(m, n, k) != plan:
            fail(f"brow_plan and the C rule differ at {m}x{n}x{k}: "
                 f"{brow.brow_plan_on_card(m, n, k)} vs {plan}")
        for members in BROW_MEMBERS:
            gen = torch.Generator(device=dev).manual_seed(m * n + k + members)
            lead = () if members == 1 else (members,)
            pad = 8 if k == cfg.data.spectrum_dim else 0   # rows ld apart, as the
            a = torch.randn((*lead, m, k + pad), generator=gen, device=dev)[..., :k]
            w = torch.randn((*lead, k, n) if bnc else (*lead, n, k), generator=gen, device=dev)
            b = w if bnc else w.transpose(-1, -2)            # step's strided inputs
            bias = torch.randn((*lead, n), generator=gen, device=dev) if with_bias else None
            got = brow.brow_gemm(a, b, bias, rnd=rnd)
            again = brow.brow_gemm(a, b, bias, rnd=rnd)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"brow {m}x{n}x{k}: a rerun is not bit-identical")
            if members > 1 and not all(torch.equal(got[i], brow.brow_gemm(
                    a[i], b[i], None if bias is None else bias[i], rnd=rnd))
                    for i in range(members)):
                fail(f"brow {m}x{n}x{k}: a member at M = {members} differs from its own launch")
            want = brow.brow_gemm_plain(a, b, bias, rnd=rnd, split=plan.split)
            exact = brow.brow_gemm_plain(a.double(), b.double(),
                                       None if bias is None else bias.double(), rnd=rnd)
            ra, rb = (a.bfloat16().float(), b.bfloat16().float()) if rnd else (a, b)
            mag = ra.double().abs() @ rb.double().abs()
            if bias is not None:
                mag = mag + bias.double().abs().unsqueeze(-2)
            bound = 2 * (k + plan.split + 2) * 2.0 ** -24 * mag
            rel_p = float(((got.double() - want.double()).abs() / bound).max())
            rel_x = float(((got.double() - exact).abs() / bound).max())
            err = float((got.double() - exact).abs().max())
            if not (rel_x <= BROW_TOL_FLOAT64 and rel_p <= BROW_TOL_PLAIN):
                fail(f"brow {m}x{n}x{k} bnc={bnc} rnd={rnd} M={members}: {rel_x:.3e} (float64) "
                     f"/ {rel_p:.3e} (plain) of the bound")
            out = torch.empty_like(got)
            if bias is None:
                lib = (lambda: torch.matmul(a, b, out=out))
            elif members == 1:
                lib = (lambda: torch.addmm(bias, a, b, out=out))
            else:
                lib = (lambda: torch.baddbmm(bias.unsqueeze(1), a, b, out=out))
            us = {"brow": graph_us(lambda: brow.brow_gemm(a, b, bias, out=out, rnd=rnd)),
                  "sgemm": graph_us(lambda: brow.brow_gemm(a, b, bias, out=out, rnd=rnd,
                                                         route="sgemm")),
                  "library": graph_us(lib)}
            flops = 2.0 * members * m * n * k
            nbytes = 4.0 * members * (m * k + k * n + m * n + (n if with_bias else 0))
            bound_ms, by = (max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3,
                            "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES_PER_S
                            else "bytes") if rnd else roofline(flops, nbytes)
            row = {"shape": [m, n, k], "bnc": bnc, "bf16": rnd, "bias": with_bias,
                   "members": members, "name": entry["name"], "a_step": entry["a_step"],
                   "split": plan.split, "blocks": plan.blocks * members, "slice": plan.slice,
                   "us": us["brow"], "sgemm_us": us["sgemm"], "matmul_us": us["library"],
                   "bound_us": bound_ms * 1e3, "bound_by": by, "max_abs_err_vs_float64": err,
                   "of_bound_vs_float64": rel_x, "of_bound_vs_plain": rel_p}
            rows.append(row)
            print(f"brow {entry['name']} ({m}x{n}x{k} {'nn' if bnc else 'nt'}"
                  f"{' bf16' if rnd else ''}{' +bias' if with_bias else ''}), M = {members}: "
                  f"S = {plan.split}, {plan.blocks * members} blocks of {plan.slice} columns; "
                  f"a step {entry['a_step']}; kernel {us['brow']:.2f} us, sgemm "
                  f"{us['sgemm']:.2f} us, torch.matmul {us['library']:.2f} us, bound "
                  f"{bound_ms * 1e3:.3f} us ({by}); max|err| vs float64 {err:.3e} "
                  f"({rel_x:.3e} of the bound), vs plain {rel_p:.3e} of the bound")
    # a through-F fp32 step's batch-row products at M = 1, summed; and K1's
    solo = [row for row in rows if row["members"] == 1]
    sums = {}
    for path, what in (("through F", "a through-F K2 step's"), ("K1", "a K1 step's"),
                       ("K1 bf16", "a bf16 K1 step's")):
        step = {r: sum(row[r] * row["a_step"].get(path, 0) for row in solo)
                for r in ("us", "sgemm_us", "matmul_us", "bound_us")}
        n_step = sum(row["a_step"].get(path, 0) for row in solo)
        print(f"time {tag} brow_gemm: {what} {n_step} "
              f"batch-row products, their us a launch summed: kernel {step['us']:.2f} us, "
              f"sgemm {step['sgemm_us']:.2f} us, torch.matmul {step['matmul_us']:.2f} us, "
              f"bound {step['bound_us']:.3f} us (us a launch, {BROW_CALLS} back to back in a "
              "CUDA graph, CUDA events)")
        sums[path] = step
    return {"products": rows, "through_f_step": sums["through F"], "k1_step": sums["K1"],
            "k1_bf16_step": sums["K1 bf16"]}


def served_ok(out, b: int, cfg) -> bool:
    import torch

    params, spec, met = out
    lo, hi = cfg.data.param_min, cfg.data.param_max
    return (tuple(params.shape) == (b, 4) and tuple(spec.shape) == (b, cfg.data.spectrum_dim)
            and tuple(met.shape) == (b, cfg.data.metrics_dim)
            and all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in out)
            and bool(((params >= lo) & (params <= hi)).all()))


def latency_ms(fn, x, requests: int) -> tuple:
    """(median, p99) ms of ``requests`` requests, each timed on the host from
    the call to its synchronisation."""
    import torch

    for _ in range(10):
        fn(x)
    torch.cuda.synchronize()
    t = []
    for _ in range(requests):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    t.sort()
    return statistics.median(t), t[min(len(t) - 1, int(round(0.99 * (len(t) - 1))))]


def counted(launches: dict, into: dict, fn, *args):
    """``fn(*args)`` with the kernels' launch counts around it added to ``into``."""
    import torch

    before = dict(launches)
    out = fn(*args)
    torch.cuda.synchronize()
    for k in launches:
        into[k] = into.get(k, 0) + launches[k] - before[k]
    return out


def envelope(got, want, span) -> tuple:
    """(params_norm max|err|, spectrum and metrics max|err| of their scale)."""
    return (float((2.0 * (got[0] - want[0]).abs() / span).max()),
            *(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got[1:], want[1:])))


def fmt3(t) -> str:
    return " / ".join(f"{x:.3e}" for x in t)


def phase32_serving(cfg, dev, repo: str, models: str, ds, requests: dict, ensemble_state,
                    G_seed, F_seed, tag: str) -> dict:
    """Serving completed, on phase 14's ``--fixed-physics`` trio: the bf16 and
    int8 cycles at every request batch against the fp32 kernel cycle and the
    CPU, their times and the fp32 cycle's latency; every ``export`` artifact
    (``all`` in fp32 / bf16 / int8 written on the CPU, ``--pallas`` written
    on the card, ``--artifact ensemble`` from phase 17's saved members) loaded
    on the card and held against the in-process function; ``screen
    --candidates 1000000`` with ``--pallas`` and with ``--dtype bfloat16``;
    ``design --refine-steps 200 --uncertainty``.  Returns its main-path
    launches and its numbers."""
    import torch
    from pigan_thz_torch import cli
    from pigan_thz_torch.design import ScreeningConfig
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops._cuda_build import LAUNCHES
    from pigan_thz_torch.serve import (
        load_exported, make_ensemble_inverse_design_fn, make_inverse_design_fn)
    from pigan_thz_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    main = {}                       # the phase's main-path launches
    G, D, F = build_trio(cfg, device="cpu")
    ckpt.load_final_trio(models, G, D, F)
    G_cpu, F_cpu = G.eval(), F.eval()
    G_dev, F_dev = copy.deepcopy(G).to(dev).eval(), copy.deepcopy(F).to(dev).eval()
    ds_cpu = type(ds)(*(t.cpu() for t in ds))
    kw = {"float32": None, "bfloat16": torch.bfloat16, "int8": "int8"}
    fns = {d: make_inverse_design_fn(G_dev, F_dev, ds, compute_dtype=kw[d])
           for d in SERVING_DTYPES}
    span = (ds.param_hi - ds.param_lo)

    # (a) the cycles at every request batch
    out, distances = {}, {}
    for b, x in requests.items():
        for d, fn in fns.items():
            before = dict(LAUNCHES)
            out[(d, b)] = counted(LAUNCHES, main, fn, x)
            k5 = LAUNCHES["fused_mlp_forward"] - before["fused_mlp_forward"]
            k6 = LAUNCHES["fused_dense_chain"] - before["fused_dense_chain"]
            if (k5, k6) != ((1, 1) if d == "float32" else (0, 0)):
                fail(f"serving {d} at B={b} launched K5 {k5} and K6 {k6} times")
            if not served_ok(out[(d, b)], b, cfg):
                fail(f"serving {d} at B={b}: shapes, finiteness or params outside the box")
        dist = {d: envelope(out[(d, b)], out[("float32", b)], span)
                for d in ("bfloat16", "int8")}
        distances[str(b)] = dist
        print(f"serving B={b} on the trained trio: bf16 and int8 finite, params in the box; "
              f"from the fp32 kernel cycle (params_norm, spectrum and metrics of their "
              f"scale): bf16 {fmt3(dist['bfloat16'])}, int8 {fmt3(dist['int8'])} (printed, "
              f"not gated: the JAX package states its int8 envelope on fresh weights)")
    # the JAX package's int8 contract where it states it (tests/test_quantized.py:
    # 56-73: flax-initialised weights, 64 spectra): phase 3's seeded trio
    fresh = {d: make_inverse_design_fn(G_seed, F_seed, ds, compute_dtype=kw[d])(requests[64])
             for d in ("float32", "int8")}
    pn_err, s_err, m_err = envelope(fresh["int8"], fresh["float32"], span)
    print(f"serving int8 B=64 on phase 3's seeded trio: params_norm {pn_err:.3e} from the "
          f"fp32 kernel cycle (tol {INT8_PN_TOL}), spectrum {s_err:.3e} and metrics "
          f"{m_err:.3e} of their scale (tol {INT8_SCALE_TOL})")
    if not (pn_err < INT8_PN_TOL and s_err < INT8_SCALE_TOL and m_err < INT8_SCALE_TOL):
        fail("int8 serving is outside the JAX package's envelope of fp32")
    x64 = requests[64]
    for d in SERVING_DTYPES:
        want = make_inverse_design_fn(G_cpu, F_cpu, ds_cpu, compute_dtype=kw[d])(x64.cpu())
        errs = [float((a.cpu() - w).abs().max() / (w.abs().max() if d != "float32" else 1.0))
                for a, w in zip(out[(d, 64)], want)]
        tol = CYCLE_TOL if d == "float32" else DTYPE_CPU_RTOL
        unit = "max|err|" if d == "float32" else "of the largest magnitude"
        print(f"serving {d} B=64 against {d} on the CPU: params {errs[0]:.3e}, spectrum "
              f"{errs[1]:.3e}, metrics {errs[2]:.3e} ({unit}, tol {tol})")
        if not max(errs) <= tol:
            fail(f"serving {d} on the card disagrees with the CPU")

    # times: CUDA-event medians of each dtype beside the fp32 kernel cycle,
    # and the fp32 cycle's latency
    times = {}
    with torch.inference_mode():
        for b, x in requests.items():
            row = {d: cuda_median_ms(fns[d], x) for d in SERVING_DTYPES}
            row["float32 again"] = cuda_median_ms(fns["float32"], x)
            times[str(b)] = row
            print(f"time {tag} serving B={b}: fp32 kernels {row['float32']:.4f} / "
                  f"{row['float32 again']:.4f} ms, bf16 {row['bfloat16']:.4f} ms, int8 "
                  f"{row['int8']:.4f} ms (CUDA-event medians of 50 after 10 warm-up)")
    latency = {}
    for b in (1, 64):
        med, p99 = latency_ms(fns["float32"], requests[b], LATENCY_REQUESTS)
        latency[str(b)] = {"median_ms": med, "p99_ms": p99}
        print(f"time {tag} serving fp32 latency B={b}: median {med:.4f} ms, p99 {p99:.4f} ms "
              f"over {LATENCY_REQUESTS} requests (host clock, call to synchronisation)")

    # (b) every export artifact, loaded and run on the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        t0 = time.perf_counter()
        for d in SERVING_DTYPES:
            counted(LAUNCHES, main, cli.main, ["export", "--models", models, "--dtype", d,
                                               "--batch-size", "64", "--device", "cpu",
                                               "--out", os.path.join(tmp, d)])
        counted(LAUNCHES, main, cli.main, ["export", "--models", models, "--pallas",
                                           "--batch-size", "64", "--out",
                                           os.path.join(tmp, "pallas")])
        torch.save(ensemble_state, os.path.join(models, cli.ENSEMBLE_FILE))
        counted(LAUNCHES, main, cli.main, ["export", "--models", models, "--artifact",
                                           "ensemble", "--ensemble-members", str(K3_MEMBERS),
                                           "--batch-size", "64", "--out",
                                           os.path.join(tmp, "ensemble")])
        export_wall = time.perf_counter() - t0
        modules = make_inverse_design_fn(G_dev, F_dev, ds, use_pallas=False)
        gens, f_ens = cli._load_ensemble(cfg, models, K3_MEMBERS, dev)
        ens = make_ensemble_inverse_design_fn(gens, f_ens, ds)
        pn64 = torch.rand((64, 4), generator=torch.Generator(device=dev).manual_seed(5),
                          device=dev) * 2 - 1
        checks = []
        for d in (*SERVING_DTYPES, "pallas", "ensemble"):
            folder = os.path.join(tmp, d)
            for name in sorted(os.listdir(folder)):
                fn = load_exported(os.path.join(folder, name), device=dev)
                inp = pn64 if name == "surrogate.pt2" else x64
                before = dict(LAUNCHES)
                got = counted(LAUNCHES, main, fn, inp)
                k = {n: LAUNCHES[n] - before[n] for n in ("fused_dense_chain",
                                                          "fused_mlp_forward")}
                got = got if isinstance(got, tuple) else (got,)
                if name == "designer.pt2":
                    want = (fns["float32"] if d == "pallas" else
                            modules if d == "float32" else fns[d])(x64)
                elif name == "ensemble_designer.pt2":
                    want = ens(x64)
                elif name == "generator.pt2":
                    want = ((modules if d != "bfloat16" else fns[d])(x64)[0],)
                else:
                    want = artifact_surrogate(F_dev, d, pn64)
                if d == "pallas" and name != "generator.pt2":
                    ok = all(torch.equal(a, w) for a, w in zip(got, want))
                    err = 0.0 if ok else float("inf")
                    if k != {"fused_dense_chain": int(name == "designer.pt2"),
                             "fused_mlp_forward": 1}:
                        fail(f"--pallas {name}: one call launched {k}")
                else:
                    err = max(float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
                              for a, w in zip(got, want))
                    ok = err <= ARTIFACT_TOL and k == {"fused_dense_chain": 0,
                                                       "fused_mlp_forward": 0}
                try:
                    fn(inp[:63])
                    ok = False
                except ValueError:
                    pass
                size = os.path.getsize(os.path.join(folder, name)) / 1e6
                checks.append((f"{d}/{name}", err, k))
                print(f"export {d}/{name} ({size:.1f} MB, written on the "
                      f"{'card' if d in ('pallas', 'ensemble') else 'CPU'}): loaded on the "
                      f"card, {'bit for bit' if d == 'pallas' and name != 'generator.pt2' else f'max|err| {err:.3e} (tol {ARTIFACT_TOL})'} "
                      f"against the in-process function, launches a call {k}, a batch of 63 "
                      f"refused: {ok}")
                if not ok:
                    fail(f"the exported {d}/{name} disagrees with the in-process function")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) the 1e6 screen as typed, fused and in bf16
    sc = ScreeningConfig()
    n_chunks = -(-sc.num_candidates // sc.chunk_size)
    screens = {}
    for label, extra in (("--pallas", ["--pallas"]), ("--dtype bfloat16",
                                                      ["--dtype", "bfloat16"])):
        path = os.path.join(models, "screening_results.json")
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        counted(LAUNCHES, main, cli.main, ["screen", "--models", models, "--candidates",
                                           str(sc.num_candidates), "--out", path, *extra])
        wall = time.perf_counter() - t0
        k = {n: LAUNCHES[n] - before[n] for n in ("dip_qualification", "fused_mlp_forward")}
        with open(path) as fh:
            rows = json.load(fh)["designs"]
        scores = [r["score"] for r in rows]
        ok = (len(rows) == sc.top_k and all(a >= b for a, b in zip(scores, scores[1:]))
              and all(cfg.data.param_min <= r[n] <= cfg.data.param_max for r in rows
                      for n in ("r1", "r2", "w", "g")))
        screens[label] = {"wall_s": wall, "top": scores[0], "launches": k}
        print(f"screen {label} as typed: {sc.num_candidates} candidates, {wall:.3f} s wall "
              f"for the command in this process, K4 {k['dip_qualification']} launches "
              f"({n_chunks} chunks + the dataset), K5 {k['fused_mlp_forward']}; "
              f"{len(rows)} winners sorted in the box: {ok}; top FoM1 {scores[0]:.6g}")
        want_k5 = n_chunks if label == "--pallas" else 0
        if not ok or k != {"dip_qualification": n_chunks + 1, "fused_mlp_forward": want_k5}:
            fail(f"screen {label}: launches {k} or its top-k is not valid and sorted")
    gap = (screens["--pallas"]["top"] - screens["--dtype bfloat16"]["top"]) / abs(
        screens["--pallas"]["top"])
    print(f"screen: bf16's top FoM1 {gap:+.3e} of fp32's (relative gap)")

    # (d) design, refined and not, with MC dropout
    designs = {}
    for steps in (0, 200):
        path = os.path.join(models, f"design_{steps}.json")
        counted(LAUNCHES, main, cli.main, [
            "design", "--models", models, "--target-index", "0", "--target-index", "1",
            "--refine-steps", str(steps), "--uncertainty", "--out", path])
        with open(path) as fh:
            designs[steps] = json.load(fh)["designs"]
    for i, (a, b) in enumerate(zip(designs[0], designs[200])):
        ok = (b["spectrum_mse"] <= a["spectrum_mse"]
              and all(0.0 < r[k] < float("inf") for r in (a, b)
                      for k in ("spectrum_std_mean", "metrics_std_mean")))
        print(f"design --target-index {i} --refine-steps 200 --uncertainty: spectrum_mse "
              f"{a['spectrum_mse']:.6g} -> {b['spectrum_mse']:.6g}, std of the spectrum "
              f"{b['spectrum_std_mean']:.4g}, of the metrics {b['metrics_std_mean']:.4g}: {ok}")
        if not ok:
            fail("design: refinement raised the MSE or the MC-dropout std is not positive")
    wall = time.perf_counter() - t_phase
    print(f"phase 32: main-path launches {main}; {wall:.1f} s")
    return {"launches": main, "times": times, "latency": latency, "screens": screens,
            "screen_bf16_gap": gap, "export_wall_s": export_wall, "distances": distances,
            "int8_fresh_envelope": (pn_err, s_err, m_err),
            "design": {k: v for k, v in designs.items()}, "wall_s": wall}


def artifact_surrogate(F, d: str, pn):
    """What a surrogate artifact of kind ``d`` computes, in this process."""
    import torch
    from pigan_thz_torch.models.blocks import bf16_twin
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.ops import quantized

    with torch.inference_mode():
        if d == "pallas":
            return fk.forward_surrogate_fused(fk.pack_forward_model(F, pn.device), pn)
        if d == "int8":
            return quantized.int8_forward_apply(quantized.quantize_forward(F), pn,
                                                F.spectrum_dim)
        module = bf16_twin(F) if d == "bfloat16" else F
        return tuple(t.float() for t in module(pn))


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


# ---------------------------------------------------------------------------
# Phase 33: preemption-safe training and the operational commands
# ---------------------------------------------------------------------------

RESUME_EPOCHS = 25          # each stage: two calls of one chunk each
PIPELINE_ARGS = ("--fwd-epochs", "100", "--gan-epochs", "100", "--ft-epochs", "50",
                 "--chunk", "25")
PIPELINE_KILL_AT = "gan 50/100"
CKPT_COMMAND_EPOCHS = 100   # train --mode full --checkpoint-dir, each stage
CKPT_INTERVAL = 50
SHADOW_CHUNKS = 2
SHADOW_FAULT = 10.0         # the planted first-epoch fault (the round-3d class)
CKPT_REPEATS = 5            # save / restore timings, medians


def _payload_equal(a: dict, b: dict) -> list:
    """The keys of two state_dicts that differ (tensors compared on the CPU,
    bit for bit)."""
    import torch

    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        same = (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor) else x == y)
        if not same:
            bad.append(k)
    return bad


def _counted(fn):
    """(fn's result, the kernel launches it made): the counts set to 0 just
    before and read just after."""
    from pigan_thz_torch.ops import _cuda_build

    reset_launches(_cuda_build.LAUNCHES)
    out = fn()
    return out, _cuda_build.launch_counts()


def _add(total: dict, launches: dict) -> dict:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def p33_resume_in_process(cfg, dev, train_ds, epochs: int = RESUME_EPOCHS) -> dict:
    """An uninterrupted trainer (forward 2 x ``epochs``, then PI-GAN
    2 x ``epochs`` through F with the EMA, two calls a stage with the
    pipeline's seeding) against one that saves after each stage's first
    call, where a fresh trainer resumes: bit for bit equal at the end."""
    import torch
    from pigan_thz_torch.train import checkpoint as ckpt
    from pigan_thz_torch.train.steps import StepSettings
    from pigan_thz_torch.train.trainer import Trainer

    settings = StepSettings.from_config(cfg, detach_forward=False, ema_decay=0.999)

    def trainer():
        return Trainer(cfg, ds=train_ds, device=dev, epochs_per_call=epochs, engine="kernel")

    def run(tmp=None):
        t = trainer()
        t.pretrain_forward(epochs=epochs, seed=0, log_every=10**9)
        if tmp:
            mgr = ckpt.CheckpointManager(os.path.join(tmp, "fwd"), save_interval=1)
            mgr.save(epochs, t.forward_state, history=t.train_history, config=cfg)
            t = trainer()
            if t.resume_from(mgr, "forward") != epochs:
                fail("phase 33: the forward checkpoint did not restore")
        t.pretrain_forward(epochs=epochs, seed=epochs, log_every=10**9)
        forward = {k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in t.forward_state.state_dict().items()}
        t.init_pigan()
        t.train_pigan(epochs=epochs, settings=settings, seed=0, log_every=10**9)
        if tmp:
            mgr = ckpt.CheckpointManager(os.path.join(tmp, "gan"), save_interval=1)
            mgr.save(epochs, t.pigan_state, history=t.train_history, config=cfg)
            t = trainer()
            if t.resume_from(mgr, "pigan") != epochs:
                fail("phase 33: the PI-GAN checkpoint did not restore")
        t.train_pigan(epochs=epochs, settings=settings, seed=epochs, log_every=10**9)
        _sync(dev)
        return forward, t

    def both():
        with tempfile.TemporaryDirectory() as tmp:
            return run(), run(tmp)

    ((ref_f, ref), (got_f, got)), launches = _counted(both)
    bad = (_payload_equal(got_f, ref_f)
           + _payload_equal(got.pigan_state.state_dict(), ref.pigan_state.state_dict()))
    same_history = got.train_history == ref.train_history
    print(f"phase 33 in-process kill and resume: forward 2 x {epochs} then PI-GAN 2 x "
          f"{epochs} epochs through F with the EMA; the resumed run against the "
          f"uninterrupted one: {len(ref.pigan_state.state_dict())} PI-GAN and "
          f"{len(ref_f)} forward state entries, {len(bad)} differ {bad[:6]}; history "
          f"equal: {same_history}; launches {launches}")
    if bad or not same_history or got.pigan_state.g_ema is None:
        fail("phase 33: the resumed run is not bit for bit the uninterrupted one")
    if dev.type == "cuda" and not (launches["forward_train"] and launches["gan_train"]):
        fail(f"phase 33: kill and resume ran no K1 / K2 launch: {launches}")
    return {"launches": launches}


def _json_block(stdout: str) -> dict:
    """The JSON object a command printed with indent=2 (from a line "{" to
    the next line "}")."""
    lines = stdout.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start: lines.index("}", start) + 1]))


def _pipeline_cmd(repo: str, workdir: str, extra) -> list:
    return [sys.executable, os.path.join(repo, "examples", "torch_full_pipeline.py"),
            "--workdir", workdir, *PIPELINE_ARGS, *extra]


def _pipeline_outputs(workdir: str) -> dict:
    """{name: bytes} of saved_models/* and final_eval.json."""
    out = {}
    models = os.path.join(workdir, "saved_models")
    for name in sorted(os.listdir(models)):
        with open(os.path.join(models, name), "rb") as fh:
            out[f"saved_models/{name}"] = fh.read()
    with open(os.path.join(workdir, "final_eval.json"), "rb") as fh:
        out["final_eval.json"] = fh.read()
    return out


def p33_pipeline(repo: str, extra=()) -> dict:
    """``examples/torch_full_pipeline.py`` three times: uninterrupted; sent
    SIGKILL when it prints ``gan 50/100``; that workdir rerun to DONE.  The
    killed-and-resumed run writes the uninterrupted run's files bit for
    bit."""
    import signal

    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.perf_counter()
        proc = subprocess.run(_pipeline_cmd(repo, a, extra), cwd=repo, capture_output=True,
                              text=True, timeout=900)
        wall_a = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 33: the pipeline exited {proc.returncode}: {proc.stderr[-3000:]}")
        launches = launches_line(proc.stdout, "the pipeline")

        t0 = time.perf_counter()
        killed = subprocess.Popen(_pipeline_cmd(repo, b, extra), cwd=repo,
                                  stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        seen = False
        for line in killed.stdout:
            if line.startswith(PIPELINE_KILL_AT):
                killed.send_signal(signal.SIGKILL)
                seen = True
                break
        killed.stdout.close()
        rc_killed = killed.wait(timeout=120)
        wall_killed = time.perf_counter() - t0
        if not seen or rc_killed != -signal.SIGKILL:
            fail(f"phase 33: the pipeline was not killed at '{PIPELINE_KILL_AT}' (rc "
                 f"{rc_killed})")
        with open(os.path.join(b, "progress.json")) as fh:
            at_kill = json.load(fh)
        t0 = time.perf_counter()
        proc_b = subprocess.run(_pipeline_cmd(repo, b, extra), cwd=repo, capture_output=True,
                                text=True, timeout=900)
        wall_rerun = time.perf_counter() - t0
        if proc_b.returncode != 0 or not os.path.exists(os.path.join(b, "DONE")):
            fail(f"phase 33: the rerun exited {proc_b.returncode}: {proc_b.stderr[-3000:]}")
        launches_rerun = launches_line(proc_b.stdout, "the pipeline's rerun")
        resumed = [ln for ln in proc_b.stdout.splitlines() if ln.startswith("resume state")]
        want, got = _pipeline_outputs(a), _pipeline_outputs(b)
        differ = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        summary = _json_block(proc.stdout)
    print(f"phase 33 pipeline {' '.join(PIPELINE_ARGS)}: uninterrupted {wall_a:.3f} s wall "
          f"(launches {launches}); killed at '{PIPELINE_KILL_AT}' after {wall_killed:.3f} s "
          f"with progress {at_kill}, rerun ({resumed[0] if resumed else '?'}) "
          f"{wall_rerun:.3f} s (launches {launches_rerun}); {len(want)} files compared, "
          f"{len(differ)} differ {differ}; param R2 {summary['param_r2']:.4f}, repair "
          f"accepted {summary['repair_accepted']}")
    if differ or at_kill.get("gan_epochs") != int(PIPELINE_KILL_AT.split()[1].split("/")[0]):
        fail("phase 33: the killed and resumed pipeline differs from the uninterrupted one")
    return {"launches": _add(dict(launches), launches_rerun),
            "walls": {"uninterrupted": wall_a, "killed": wall_killed, "rerun": wall_rerun}}


def p33_checkpoint_command(cfg, dev, train_ds, extra=()) -> dict:
    """``train --mode full --checkpoint-dir`` at 100 + 100 epochs with
    ``train.save_interval=50`` in process: the epochs kept, and the latest
    checkpoint restored into a fresh trainer equal to the saved finals."""
    import torch
    from pigan_thz_torch.cli import main as cli_main
    from pigan_thz_torch.train import checkpoint as ckpt
    from pigan_thz_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        ck, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "saved_models")
        argv = ["train", "--mode", "full", "--forward-epochs", str(CKPT_COMMAND_EPOCHS),
                "--epochs", str(CKPT_COMMAND_EPOCHS), "--workdir", tmp, "--out", out,
                "--no-tensorboard", "--checkpoint-dir", ck, "--set",
                f"train.save_interval={CKPT_INTERVAL}", *extra]
        t0 = time.perf_counter()
        rc, launches = _counted(lambda: cli_main(argv))
        wall = time.perf_counter() - t0
        mgr = ckpt.CheckpointManager(ck)
        kept = mgr.all_epochs()
        t = Trainer(cfg, ds=train_ds, device=dev)
        epoch = t.resume_from(mgr, "pigan")
        differ = []
        for name, module in (("generator_final", t.pigan_state.g),
                             ("discriminator_final", t.pigan_state.d),
                             ("forward_model_final", t.pigan_state.f)):
            saved = torch.load(os.path.join(out, f"{name}.pth"), weights_only=True)
            differ += [f"{name}:{k}" for k, v in module.state_dict().items()
                       if not torch.equal(v.cpu(), saved[k])]
    print(f"phase 33 train --mode full --checkpoint-dir, {CKPT_COMMAND_EPOCHS} + "
          f"{CKPT_COMMAND_EPOCHS} epochs, train.save_interval={CKPT_INTERVAL}: rc {rc}, "
          f"{wall:.3f} s in process, epochs kept {kept} (25-epoch chunks; max_to_keep 3), "
          f"the latest ({epoch}) restored into a fresh Trainer against the saved finals: "
          f"{len(differ)} tensors differ; launches {launches}")
    want = [e for e in range(EPOCHS_PER_CALL, CKPT_COMMAND_EPOCHS + 1, EPOCHS_PER_CALL)
            if e % CKPT_INTERVAL == 0][-3:]
    if rc != 0 or kept != want or epoch != CKPT_COMMAND_EPOCHS or differ:
        fail("phase 33: train --checkpoint-dir kept the wrong epochs or its latest "
             "checkpoint is not the saved final trio")
    return {"launches": launches, "wall": wall, "kept": kept}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p33_shadow(cfg, dev, train_ds, epochs: int = EPOCHS_PER_CALL,
               full_epochs: int = PRETRAIN_EPOCHS) -> dict:
    """K1 and K2 with ``shadow_parity="all"`` over two chunks each (every
    replay ``ok``); the planted first-epoch fault raising ``RuntimeError``;
    one replay's time; the training of ``train --mode full`` (as typed) at
    ``full_epochs`` + ``full_epochs`` with the default cadence against
    ``"off"``, in turns."""
    from pigan_thz_torch.train import trainer as trainer_mod
    from pigan_thz_torch.train.steps import StepSettings
    from pigan_thz_torch.train.trainer import Trainer

    through_f = StepSettings.from_config(cfg, detach_forward=False)

    def timed_replays(t, into):
        replay = t._shadow_replay

        def timed(*a):
            _sync(dev)
            t0 = time.perf_counter()
            replay(*a)
            _sync(dev)
            into.append((a[0], (time.perf_counter() - t0) * 1e3))
        t._shadow_replay = timed

    def clean():
        t = Trainer(cfg, ds=train_ds, device=dev, epochs_per_call=epochs, engine="kernel",
                    shadow_parity="all")
        replays = []
        timed_replays(t, replays)
        t.pretrain_forward(epochs=SHADOW_CHUNKS * epochs, log_every=10**9)
        t.init_pigan()
        t.train_pigan(epochs=SHADOW_CHUNKS * epochs, settings=through_f, log_every=10**9)
        return t, replays

    (t, replays), launches = _counted(clean)
    checks = t.shadow_checks
    worst = {}
    for c in checks:
        if c["worst_rel"] >= worst.get(c["what"], {}).get("worst_rel", -1.0):
            worst[c["what"]] = {k: c[k] for k in ("worst_key", "worst_rel", "rtol")}
    print(f"phase 33 shadow replay, shadow_parity='all', {SHADOW_CHUNKS} chunks of {epochs} "
          f"epochs each through K1 and K2: {len(checks)} replays, all ok: "
          f"{all(c['ok'] for c in checks)}; worst by kind {worst}; launches {launches}")
    print("phase 33 shadow replay ms (first epoch on the eager step, synchronised; the first "
          "of each kind includes the eager step's warm-up): "
          + ", ".join(f"{w} {ms:.3f}" for w, ms in replays))
    if len(checks) != 2 * SHADOW_CHUNKS or not all(c["ok"] for c in checks):
        fail(f"phase 33: the shadow replays on the card did not all pass: {checks}")

    def faulty(make, keys):
        def factory(*a, **kw):
            fn = make(*a, **kw)

            def multi_epoch(*args, **kwargs):
                state, ms = fn(*args, **kwargs)
                ms = dict(ms)
                for k in keys:
                    ms[k] = ms[k].clone()
                    ms[k][0] *= SHADOW_FAULT
                return state, ms
            return multi_epoch
        return factory

    faults = {}
    for what, name, keys in (("forward", "make_forward_epoch_fn", ["loss"]),
                             ("pigan", "make_gan_epoch_fn", ["g_loss"])):
        t = Trainer(cfg, ds=train_ds, device=dev, epochs_per_call=epochs, engine="kernel")
        if what == "pigan":
            t.pretrain_forward(epochs=epochs, log_every=10**9)
            t.init_pigan()
        real = getattr(trainer_mod, name)
        setattr(trainer_mod, name, faulty(real, keys))
        try:
            if what == "pigan":
                t.train_pigan(epochs=epochs, settings=through_f, log_every=10**9)
            else:
                t.pretrain_forward(epochs=epochs, log_every=10**9)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        finally:
            setattr(trainer_mod, name, real)
        check = t.shadow_checks[-1] if t.shadow_checks else {}
        faults[what] = {k: check.get(k) for k in ("ok", "worst_key", "worst_rel")}
        print(f"phase 33 planted fault, {what}: the kernel function's first-epoch "
              f"{'/'.join(keys)} x {SHADOW_FAULT:g}: RuntimeError raised: {raised is not None}; "
              f"the replay's record {faults[what]}")
        if raised is None or check.get("ok") is not False:
            fail(f"phase 33: the planted {what} fault did not raise")

    def full(parity):
        t = Trainer(cfg, ds=train_ds, device=dev, engine="kernel", shadow_parity=parity)
        _sync(dev)
        t0 = time.perf_counter()
        t.pretrain_forward(epochs=full_epochs, log_every=10**9)
        t.init_pigan()
        t.train_pigan(epochs=full_epochs, settings=StepSettings.from_config(cfg),
                      log_every=10**9)
        _sync(dev)
        return time.perf_counter() - t0, len(t.shadow_checks)

    walls, total = {"every:20": [], "off": []}, {}
    for parity in ("off", "every:20", "every:20", "off"):
        (wall, n), launched = _counted(lambda: full(parity))
        walls[parity].append(wall)
        _add(total, launched)
    on, off = min(walls["every:20"]), min(walls["off"])
    print(f"phase 33 the training of train --mode full ({full_epochs} + {full_epochs} "
          f"epochs, as typed) in process, in turns off / every:20 / every:20 / off: "
          f"{', '.join(f'{w:.4f}' for w in walls['off'][:1] + walls['every:20'] + walls['off'][1:])}"
          f" s; the default cadence's share (best of each) {(on - off) / off:+.4f}")
    return {"launches": _add(launches, total), "checks": worst, "faults": faults,
            "replay_ms": replays, "full_walls": walls, "share": (on - off) / off}


def p33_checkpoint_cost(cfg, dev, train_ds) -> dict:
    """A checkpoint's size, and its save and restore ms (host clock, the
    card synchronised), for a ForwardState and a PiGanState with the EMA."""
    import torch
    from pigan_thz_torch.train import checkpoint as ckpt
    from pigan_thz_torch.train.steps import StepSettings
    from pigan_thz_torch.train.trainer import Trainer

    t = Trainer(cfg, ds=train_ds, device=dev, shadow_parity="off")
    t.pretrain_forward(epochs=1, log_every=10**9)
    t.init_pigan()
    t.train_pigan(epochs=1, settings=StepSettings.from_config(cfg, ema_decay=0.999),
                  log_every=10**9)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for what, state in (("forward", t.forward_state), ("pigan", t.pigan_state)):
            mgr = ckpt.CheckpointManager(os.path.join(tmp, what), max_to_keep=2,
                                         save_interval=1)
            saves, restores = [], []
            for i in range(CKPT_REPEATS):
                _sync(dev)
                t0 = time.perf_counter()
                mgr.save(i + 1, state, history=t.train_history, config=cfg)
                saves.append((time.perf_counter() - t0) * 1e3)
                target = state.clone()
                _sync(dev)
                t0 = time.perf_counter()
                mgr.restore(target, i + 1)
                _sync(dev)
                restores.append((time.perf_counter() - t0) * 1e3)
                if _payload_equal(target.state_dict(), state.state_dict()):
                    fail(f"phase 33: a restored {what} state differs from the saved one")
            size = os.path.getsize(os.path.join(tmp, what, "train_state", str(CKPT_REPEATS),
                                                "state.pt"))
            floats = sum(v.numel() for v in state.state_dict().values()
                         if isinstance(v, torch.Tensor) and v.is_floating_point())
            out[what] = {"bytes": size, "floats": floats,
                         "save_ms": statistics.median(saves),
                         "restore_ms": statistics.median(restores)}
            print(f"phase 33 checkpoint of a {what} state: {size} bytes ({floats} floats), "
                  f"save {statistics.median(saves):.3f} ms, restore "
                  f"{statistics.median(restores):.3f} ms (medians of {CKPT_REPEATS}; save: "
                  f"the copy to the host, torch.save, fsync, rename)")
    return out


def p33_commands(cfg, dev, repo: str, train_ds, extra=(), doctor_must_pass=True) -> dict:
    """``doctor`` (exits 0 and names the card), ``profile --epochs 10
    --repeats 3`` (its report, the K2 launches counted, the trace there) and
    ``cache-data`` of a 1000-sample CSV (arrays equal to the CSV's), with
    the walls of a ``.thzb`` load and of the CSV loads."""
    import torch
    from pigan_thz_torch.cli import main as cli_main
    from pigan_thz_torch.data import native_io, save_csv
    from pigan_thz_torch.data.dataset import load_csv

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "doctor.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pigan_thz_torch", "doctor", "--json",
                               report], cwd=repo, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"phase 33 doctor: {line}")
        card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card"
        if doctor_must_pass and (proc.returncode != 0 or card not in proc.stdout):
            fail(f"phase 33: doctor exited {proc.returncode} or did not name {card}: "
                 f"{proc.stderr[-2000:]}")
        out["doctor"] = {"rc": proc.returncode, "wall": wall}

        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pigan_thz_torch", "profile", "--epochs",
                               "10", "--repeats", "3", "--trace-dir", trace_dir, *extra],
                              cwd=repo, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 33: profile exited {proc.returncode}: {proc.stderr[-3000:]}")
        prof = _json_block(proc.stdout)
        traced = os.path.getsize(os.path.join(trace_dir, "trace.json"))
        print(f"phase 33 profile --epochs 10 --repeats 3: {wall:.3f} s wall; report {prof}; "
              f"trace.json {traced} bytes")
        if dev.type == "cuda" and prof["launches"].get("gan_train") != 3:
            fail(f"phase 33: profile counted {prof['launches']} launches, not 3 of K2")
        out["profile"] = prof

        csv_path, thzb = os.path.join(tmp, "d.csv"), os.path.join(tmp, "d.thzb")
        save_csv(train_ds, csv_path)
        t0 = time.perf_counter()
        rc, launches = _counted(lambda: cli_main(["cache-data", "--csv", csv_path, "--out",
                                                  thzb, *extra]))
        cache_wall = time.perf_counter() - t0
        loads = {}
        for name, fn in (("csv", lambda: load_csv(csv_path, cfg.data, device=dev)),
                         ("csv_native", lambda: native_io.load_csv_native(
                             csv_path, cfg.data, device=dev)),
                         ("thzb", lambda: native_io.load_cached(thzb, cfg.data, device=dev))):
            times = []
            for _ in range(3):
                _sync(dev)
                t0 = time.perf_counter()
                ds = fn()
                _sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            loads[name] = (min(times), ds)
        ref = loads["csv"][1]
        differ = [f"{n}:{k}" for n, (_, ds) in loads.items() for k in ("spectra", "params",
                                                                        "metrics")
                  if not torch.equal(getattr(ds, k), getattr(ref, k))]
        print(f"phase 33 cache-data of {ref.num_samples} samples: rc {rc}, {cache_wall:.3f} s in "
              f"process (native extension: {native_io.native_available()}); loads, best of "
              f"3: CSV {loads['csv'][0]:.3f} ms, CSV native {loads['csv_native'][0]:.3f} ms, "
              f".thzb {loads['thzb'][0]:.3f} ms; arrays differing from the CSV's: {differ}")
        if rc != 0 or differ or ref.num_samples != train_ds.num_samples:
            fail("phase 33: cache-data did not round-trip the CSV's arrays")
        out["cache"] = {"wall": cache_wall, "native": native_io.native_available(),
                        "load_ms": {k: v[0] for k, v in loads.items()}}
    return out


def phase33_preemption(cfg, dev, repo: str, train_ds, k2_epoch_ms: float, tag: str) -> dict:
    """Preemption-safe training and the operational commands at full width
    (module docstring, phase 33).  Returns the main-path launches and the
    numbers for the record."""
    t0 = time.perf_counter()
    launches = {}
    resume = p33_resume_in_process(cfg, dev, train_ds)
    _add(launches, resume["launches"])
    pipeline = p33_pipeline(repo)
    _add(launches, pipeline["launches"])
    command = p33_checkpoint_command(cfg, dev, train_ds)
    _add(launches, command["launches"])
    shadow = p33_shadow(cfg, dev, train_ds)
    _add(launches, shadow["launches"])
    cost = p33_checkpoint_cost(cfg, dev, train_ds)
    commands = p33_commands(cfg, dev, repo, train_ds)
    _add(launches, {"gan_train": commands["profile"]["launches"].get("gan_train", 0)})
    spe = train_ds.num_samples // cfg.train.batch_size
    prof = commands["profile"]
    print(f"time {tag} profile: {prof['train_steps_per_sec']} train steps/s "
          f"({1e3 * spe / prof['train_steps_per_sec']:.4f} ms an epoch) beside phase 15's K2 "
          f"epoch {k2_epoch_ms:.4f} ms ({1e3 * spe / k2_epoch_ms:.1f} steps/s), as typed")
    print(f"time {tag} checkpoints: " + "; ".join(
        f"{w} {c['bytes'] / 1e6:.2f} MB, save {c['save_ms']:.3f} ms, restore "
        f"{c['restore_ms']:.3f} ms" for w, c in cost.items()))
    print(f"time {tag} pipeline {' '.join(PIPELINE_ARGS)}: uninterrupted "
          f"{pipeline['walls']['uninterrupted']:.3f} s, killed at '{PIPELINE_KILL_AT}' after "
          f"{pipeline['walls']['killed']:.3f} s and rerun {pipeline['walls']['rerun']:.3f} s")
    wall = time.perf_counter() - t0
    print(f"phase 33: main-path launches {launches}; {wall:.1f} s")
    return {"launches": launches, "pipeline": pipeline["walls"], "checkpoint": cost,
            "shadow": {k: shadow[k] for k in ("checks", "faults", "replay_ms", "full_walls",
                                              "share")},
            "checkpoint_command": {"wall": command["wall"], "kept": command["kept"]},
            "commands": commands, "wall": wall}


P34_GAN_EPOCHS = 50          # train --preset optimized: the GAN depth, cut
P34_WARMUP, P34_STEPS = 2, 10  # eager steps a variant: untimed, then timed
P34_VARIANTS = (("generator", "residual"), ("generator", "conv_attn"),
                ("discriminator", "dual_encoder"), ("discriminator", "conv"),
                ("discriminator", "multi_scale"), ("forward_model", "branched"),
                ("forward_model", "physics"), ("forward_model", "uncertainty"))


def _p34_variant_steps(cfg, dev, train_ds, role: str, name: str) -> dict:
    """Eager steps of the baseline trio with ``role`` swapped for ``name``
    (``role`` None: the baseline trio itself) on the card: the state built
    on the CPU from SEED and carried over as a ``state_dict``; steps/s of
    the PI-GAN step (and of the forward step for a surrogate)."""
    import dataclasses

    import torch

    from pigan_thz_torch.data.dataset import gather_batch
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.train.state import (init_forward_state, init_pigan_state,
                                             make_optimizers)
    from pigan_thz_torch.train.steps import (ForwardStepSettings, StepSettings,
                                             make_forward_step, make_pigan_step)

    c = cfg
    if role is not None:
        section = getattr(cfg, role)
        knobs = {"name": name}
        if role == "discriminator" and name != "conv":
            knobs["use_spectral_norm"] = True
        c = cfg.replace(**{role: dataclasses.replace(section, **knobs)})
    spe = train_ds.num_samples // c.train.batch_size
    g_tx, d_tx, f_tx = make_optimizers(c, spe)
    states = []
    for device in ("cpu", dev):
        g, d, f = build_trio(c, device="cpu", generator=torch.Generator().manual_seed(SEED))
        states.append(init_pigan_state(g, d, f, g_tx, d_tx, SEED, device=device,
                                       fresh_forward=True))
    cpu_state, state = states
    state.load_state_dict_(cpu_state.state_dict())
    if state.d_params.data_ptr() != next(state.d.parameters()).data_ptr():
        fail(f"phase 34: the {name} state's parameters are not views of its buffers")
    idx = torch.randperm(train_ds.num_samples, generator=torch.Generator().manual_seed(SEED))
    idx = idx.to(dev)
    out = {}
    steps = {"pigan": (make_pigan_step(g_tx, d_tx, StepSettings.from_config(c),
                                       train_ds.param_lo, train_ds.param_hi), state)}
    if role == "forward_model":
        f_state = init_forward_state(build_trio(c, device="cpu")[2], f_tx, SEED, device=dev)
        nll = 0.5 if name == "uncertainty" else 0.0
        steps["forward"] = (make_forward_step(f_tx, ForwardStepSettings(nll_w=nll)), f_state)
    for what, (step, st) in steps.items():
        rows = []
        for i in range(P34_WARMUP + P34_STEPS):
            if i == P34_WARMUP:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
            b = i % spe
            batch = gather_batch(train_ds, idx[b * c.train.batch_size:(b + 1) * c.train.batch_size])
            st, m = step(st, batch, 1.0, 1000 + i)
            rows.append(m)
        torch.cuda.synchronize(dev)
        rate = P34_STEPS / (time.perf_counter() - t0)
        finite = st.is_finite() and all(bool(torch.isfinite(v).all()) for r in rows
                                        for v in r.values())
        if not finite:
            fail(f"phase 34: {name} ({role}) {what} steps are not finite on the card")
        out[what] = {"steps_per_s": rate, "loss": float(rows[-1].get("g_loss", rows[-1].get(
            "loss")))}
    return out


def phase34_enhanced(cfg, dev, repo: str, train_ds, tag: str) -> dict:
    """The enhanced variants on the card (module docstring, phase 34).
    Returns the main-path launches and the numbers for the record."""
    import tempfile

    import torch

    from pigan_thz_torch import config_presets
    from pigan_thz_torch.ops import _cuda_build
    from pigan_thz_torch.serve import make_inverse_design_fn
    from pigan_thz_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    launches, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "optimized")
        saved = os.path.join(work, "saved_models")
        cmd = [sys.executable, "-m", "pigan_thz_torch", "train", "--mode", "full", "--preset",
               "optimized", "--epochs", str(P34_GAN_EPOCHS), "--workdir", work,
               "--no-tensorboard"]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t1
        if proc.returncode != 0:
            fail(f"phase 34: train --preset optimized exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        got = launches_line(proc.stdout, "train --preset optimized (phase 34)")
        _add(launches, got)
        said = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                if "on the eager step" in ln or "through the forward-training kernel" in ln]
        for line in said:
            print(f"phase 34 engine: {line}")
        if (got.get("gan_train", 0) != 0 or got.get("forward_train", 0) < 1
                or not any("no TPU kernel covers the generator 'residual'" in ln
                           for ln in said)):
            fail(f"phase 34: train --preset optimized did not pretrain F through K1 and train "
                 f"the GAN phase on the eager step as the engine rule says: {got}")
        ocfg = config_presets.apply_optimization_config(cfg)
        loaded = Trainer(ocfg, ds=train_ds, device=dev)
        loaded.load_final(saved)
        hist = loaded.train_history
        finite = all(x == x and abs(x) != float("inf") for v in hist.values() for x in v)
        g, f = loaded.pigan_state.g, loaded.pigan_state.f
        print(f"phase 34 train --mode full --preset optimized --epochs {P34_GAN_EPOCHS} as "
              f"typed: {type(g).__name__} + {type(loaded.pigan_state.d).__name__}, "
              f"{len(hist['forward/loss'])} + {len(hist['pigan/g_loss'])} epochs in "
              f"{wall:.3f} s wall; launches {got}; recon_spec_loss "
              f"{hist['pigan/recon_spec_loss'][0]:.4f} -> {hist['pigan/recon_spec_loss'][-1]:.4f}"
              f"; all curves finite: {finite}")
        if not finite or type(g).__name__ != "ResidualGenerator":
            fail("phase 34: the optimized trio's history is not finite or not the residual G")
        out["optimized"] = {"wall_s": wall, "launches": got,
                            "epochs": [len(hist["forward/loss"]), len(hist["pigan/g_loss"])]}

        epath = os.path.join(tmp, "eval.json")
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pigan_thz_torch", "evaluate", "--models",
                               saved, "--json", epath], cwd=repo, capture_output=True,
                              text=True, timeout=600)
        ewall = time.perf_counter() - t1
        if proc.returncode != 0:
            fail(f"phase 34: evaluate exited {proc.returncode}: {proc.stderr[-3000:]}")
        egot = launches_line(proc.stdout, "evaluate (phase 34)")
        _add(launches, egot)
        with open(epath) as fh:
            ev = json.load(fh)
        r2, viol = r2_and_violation(ev)
        print(f"phase 34 evaluate --models (the optimized trio): param R2 {r2:.4f}, violation "
              f"rate {viol:.4f}, {ewall:.3f} s wall, launches {egot}")
        if r2 != r2:
            fail("phase 34: evaluate gave no finite param R2 for the optimized trio")
        out["evaluate"] = {"param_r2": r2, "violation_rate": viol, "wall_s": ewall}

        spectra = train_ds.spectra[:64].contiguous()
        fn = make_inverse_design_fn(g, f, train_ds)
        (served, spec), sl = _counted(lambda: tuple(t.clone() for t in fn(spectra))[:2])
        _add(launches, sl)
        plain = make_inverse_design_fn(g, f, train_ds, use_pallas=False)(spectra)
        diff = float((served - plain[0]).abs().max())
        spec_diff = float((spec - plain[1]).abs().max())
        lo, hi = train_ds.param_lo, train_ds.param_hi
        inside = bool(((served >= lo - 1e-4) & (served <= hi + 1e-4)).all())
        print(f"phase 34 B = 64 request, K5 serving F and the residual G's module: launches "
              f"{ {k: v for k, v in sl.items() if v} }, against the all-module cycle params "
              f"max|diff| {diff:.3e}, spectra (K5) {spec_diff:.3e} (tol {K5_TOL}); inside the "
              f"design box: {inside}")
        if (sl.get("fused_mlp_forward") != 1 or sl.get("fused_dense_chain", 0) != 0
                or not inside or diff > 1e-6 or not spec_diff <= K5_TOL):
            fail("phase 34: the B = 64 request did not go through K5 and the residual G's "
                 "module, or its params are off")
        out["request"] = {"launches": sl, "params_max_diff_vs_modules": diff,
                          "spectra_max_diff_vs_modules": spec_diff}

    rates = {"baseline": _p34_variant_steps(cfg, dev, train_ds, None, "mlp")}
    for role, name in P34_VARIANTS:
        rates[name] = _p34_variant_steps(cfg, dev, train_ds, role, name)
    for name, r in rates.items():
        extra = (f", forward step {r['forward']['steps_per_s']:.1f} steps/s"
                 if "forward" in r else "")
        print(f"time {tag} phase 34 eager {name}: PI-GAN step {r['pigan']['steps_per_s']:.1f} "
              f"steps/s{extra} (B = {cfg.train.batch_size}, {P34_STEPS} steps after "
              f"{P34_WARMUP})")
    out["eager_steps_per_s"] = rates
    wall = time.perf_counter() - t0
    k1k4 = {k: launches.get(k, 0) for k in ("forward_train", "dip_qualification")}
    print(f"phase 34: main-path launches {launches} (K1 and K4: {k1k4}); {wall:.1f} s")
    out.update(launches=launches, wall=wall)
    return out


# ---------------------------------------------------------------------------
# Phase 35: ensembles and data parallelism
# ---------------------------------------------------------------------------
# Two ranks, each a process of its own, on the one card: NCCL refuses two
# ranks on one device, so they form a gloo group, which moves CUDA tensors
# through the host.  Trainer(mesh=...) trains P35_EPOCHS forward then
# P35_EPOCHS GAN epochs in chunks of P35_EPOCHS_PER_CALL (B = 64 global, 32 a
# rank), and the replicas' states are hashed and compared after every chunk.
# Against the world-1 eager run of the same phase every history row of the
# first P35_HELD_EPOCHS epoch of each phase is held to
# tests/test_torch_parallel.py's tolerance (rtol 1e-4; the count rows,
# d_accuracy and violation_rate, within one sample of the epoch), each phase
# from one state: the GAN phase over the ranks starts from world 1's
# pretrained F.  The later rows are printed, not held: two float32 orders of
# the same sums part where an activation mask flips and do not come back
# (measured on an H100: the forward rows 1e-7 apart for 4 epochs, 1e-3 by
# epoch 17; a GAN phase started from those two Fs 4e-3 apart in its first
# epoch; from one F the GAN rows 1.2e-5 apart in epoch 1 (15 steps), 4.2e-4
# in epoch 2, 2e-2 by epoch 12, as K2's 30 steps against its float32 plain
# version drift, K2_ROWS_RTOL).  The CPU test holds 8 steps at narrow width.
P35_WORLD = 2
P35_EPOCHS = 10              # cut from 20, to keep the whole run near half its time limit
P35_EPOCHS_PER_CALL = 5
P35_ROWS_RTOL = 1e-4
P35_HELD_EPOCHS = 1
P35_COUNT_ROWS = ("pigan/d_accuracy", "pigan/violation_rate")
P35_SWEEP = ("--members", "8", "--forward-epochs", "100", "--epochs", "10")


def _p35_digest(state, mesh) -> list:
    """Every rank's sha256 of ``state``'s payload, in rank order."""
    import hashlib

    import torch
    import torch.distributed as dist

    h = hashlib.sha256()
    for key, v in state.state_dict().items():
        h.update(key.encode())
        if isinstance(v, torch.Tensor):
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
        else:
            h.update(repr(v).encode())
    every = [None] * mesh.size
    dist.all_gather_object(every, h.hexdigest())
    return every


def _p35_rank(rank: int, world: int, address: str, out_dir: str, device: str) -> None:
    """One rank of phase 35 (i) and (ii); writes ``out_dir/rank<r>.pt``."""
    import torch

    from pigan_thz_torch import default_config
    from pigan_thz_torch.design import ScreeningConfig, screen_designs
    from pigan_thz_torch.models import build_forward_model
    from pigan_thz_torch.ops import _cuda_build
    from pigan_thz_torch.parallel import initialize_distributed, make_mesh
    from pigan_thz_torch.train.trainer import Trainer

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(address, world, rank, backend="gloo", device=dev)
    mesh = make_mesh(data=world)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    cfg = inputs["cfg"]
    out = {"rank": rank, "digests": []}

    class Checked(Trainer):
        def _run_chunk(self, *args, **kw):
            state, rows = super()._run_chunk(*args, **kw)
            out["digests"].append(_p35_digest(state, mesh))
            return state, rows

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh.barrier()

    reset_launches(_cuda_build.LAUNCHES)
    trainer = Checked(cfg, device=dev, mesh=mesh, epochs_per_call=P35_EPOCHS_PER_CALL)
    sync()
    t0 = time.perf_counter()
    trainer.pretrain_forward(epochs=inputs["epochs"])
    sync()
    t1 = time.perf_counter()
    trainer.forward_state.load_state_dict_(inputs["forward_world1"])   # one start state
    trainer.init_pigan()
    trainer.train_pigan(epochs=inputs["epochs"])
    sync()
    out.update(history=trainer.train_history, forward_s=t1 - t0,
               pigan_s=time.perf_counter() - t1, train_launches=dict(_cuda_build.LAUNCHES),
               steps_per_epoch=trainer.steps_per_epoch)

    f = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim,
                            device=dev)
    f.load_state_dict(inputs["F"])
    f.eval()
    lo, hi = inputs["lo"].to(dev), inputs["hi"].to(dev)
    for use_pallas in (True, False):
        reset_launches(_cuda_build.LAUNCHES)
        sc = ScreeningConfig(use_pallas=use_pallas, **inputs["screen"])
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
        sync()
        t0 = time.perf_counter()
        res = screen_designs(f, cfg.data.frequencies.to(dev), lo, hi, gen, sc, mesh=mesh)
        sync()
        out[f"screen_{use_pallas}"] = ({k: getattr(res, k).cpu() for k in res._fields},
                                       time.perf_counter() - t0, dict(_cuda_build.LAUNCHES))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _p35_rows_apart(got: dict, want: dict, atol_count: float) -> tuple:
    """Each history row's largest |got - want| / (rtol |want| + atol) over
    the first P35_HELD_EPOCHS epochs (above 1 fails), and its largest
    relative difference over every epoch, with the epoch it is at."""
    held, every = {}, {}
    for k, w in want.items():
        g = got[k]
        if len(g) != len(w):
            fail(f"phase 35: history {k} has {len(g)} rows over the ranks, {len(w)} alone")
        atol = atol_count if k in P35_COUNT_ROWS else 1e-6
        held[k] = max(abs(a - b) / (P35_ROWS_RTOL * abs(b) + atol)
                      for a, b in list(zip(g, w))[:P35_HELD_EPOCHS])
        rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(g, w)]
        every[k] = (max(rel), rel.index(max(rel)))
    return held, every


def phase35_parallel(cfg, dev, repo: str, F, lo, hi, screens: dict, tag: str,
                     epochs: int = P35_EPOCHS, sweep: tuple = P35_SWEEP,
                     screen: dict | None = None) -> dict:
    """Ensembles and data parallelism on the card (module docstring, phase
    35).  ``screens`` are the world-1 screens of ``F`` (phase 8's); the
    other arguments cut the phase for a rehearsal on the CPU.  Returns the
    main-path launches and the numbers for the record."""
    import torch

    from pigan_thz_torch.cli import main as cli_main
    from pigan_thz_torch.ops import _cuda_build
    from pigan_thz_torch.parallel.mesh import spawn_ranks
    from pigan_thz_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    with tempfile.TemporaryDirectory(prefix="p35_") as out_dir:
        # (i) world 1, the eager step
        reset_launches(_cuda_build.LAUNCHES)
        alone = Trainer(cfg, device=dev, engine="eager", epochs_per_call=P35_EPOCHS_PER_CALL)
        sync()
        t0 = time.perf_counter()
        alone.pretrain_forward(epochs=epochs)
        sync()
        t1 = time.perf_counter()
        forward_world1 = {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
                          for k, v in alone.forward_state.state_dict().items()}
        alone.init_pigan()
        alone.train_pigan(epochs=epochs)
        sync()
        w1 = dict(forward_s=t1 - t0, pigan_s=time.perf_counter() - t1)
        add(_cuda_build.LAUNCHES)
        torch.save({"cfg": cfg, "epochs": epochs, "screen": screen or {},
                    "F": {k: v.cpu() for k, v in F.state_dict().items()},
                    "lo": lo.cpu(), "hi": hi.cpu(), "forward_world1": forward_world1},
                   os.path.join(out_dir, "inputs.pt"))
        # (i) and (ii) over the ranks, one spawn
        t0 = time.perf_counter()
        spawn_ranks(_p35_rank, P35_WORLD, out_dir, str(dev))
        spawn_wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(P35_WORLD)]

        r0 = ranks[0]
        spe = r0["steps_per_epoch"]
        for chunk, digests in enumerate(r0["digests"]):
            if len(set(digests)) != 1:
                fail(f"phase 35: the replicas differ after chunk {chunk}: {digests}")
        for r in ranks[1:]:
            if r["digests"] != r0["digests"] or r["history"] != r0["history"]:
                fail(f"phase 35: rank {r['rank']} saw other replicas or rows than rank 0")
        held, apart = _p35_rows_apart(r0["history"], alone.train_history,
                                      1.0 / (spe * cfg.train.batch_size))
        worst = max(held, key=held.get)
        rates = {"world1_pigan_steps_per_s": epochs * spe / w1["pigan_s"],
                 "world2_pigan_steps_per_s": epochs * spe / r0["pigan_s"],
                 "world1_forward_steps_per_s": epochs * spe / w1["forward_s"],
                 "world2_forward_steps_per_s": epochs * spe / r0["forward_s"]}
        print(f"phase 35 (i) Trainer(mesh=...) on {P35_WORLD} gloo ranks of {dev}, "
              f"{epochs} forward + {epochs} GAN epochs of {spe} steps (B = "
              f"{cfg.train.batch_size} global): forward {r0['forward_s']:.3f} s, PI-GAN "
              f"{r0['pigan_s']:.3f} s; world 1 eager {w1['forward_s']:.3f} s / "
              f"{w1['pigan_s']:.3f} s; replicas equal after each of "
              f"{len(r0['digests'])} chunks; the first {P35_HELD_EPOCHS} epoch's rows at "
              f"most {held[worst]:.3g} of the limit ({worst}; rtol {P35_ROWS_RTOL})")
        for k, (rel, at) in apart.items():
            first = [abs(a - b) / max(abs(b), 1e-12) for a, b in
                     zip(r0["history"][k][:4], alone.train_history[k][:4])]
            print(f"phase 35 (i) {k}: world 2 against world 1, relative, epochs 1-4 "
                  + " ".join(f"{x:.2e}" for x in first)
                  + f"; largest {rel:.3e} at epoch {at + 1}; world 1 last "
                  f"{alone.train_history[k][-1]:.6g}, world 2 last {r0['history'][k][-1]:.6g}")
        print(f"time {tag} phase 35 PI-GAN steps/s: world 1 "
              f"{rates['world1_pigan_steps_per_s']:.1f}, world 2 "
              f"{rates['world2_pigan_steps_per_s']:.1f}; forward steps/s: world 1 "
              f"{rates['world1_forward_steps_per_s']:.1f}, world 2 "
              f"{rates['world2_forward_steps_per_s']:.1f}")
        failures = []
        if held[worst] > 1.0:
            failures.append(f"{worst} over the ranks is {held[worst]:.3g} of its limit in the "
                            f"first {P35_HELD_EPOCHS} epoch")
        out.update(rates, rows_apart={k: v[0] for k, v in apart.items()},
                   rows_held=held, spawn_s=spawn_wall)
        for r in ranks:
            add(r["train_launches"])

        # (ii) the screens over the ranks against phase 8's world-1 screens
        for use_pallas in (True, False):
            want = screens[use_pallas][0]
            label = "fused" if use_pallas else "module"
            per_rank = []
            for r in ranks:
                got, wall, counted = r[f"screen_{use_pallas}"]
                for k in got:
                    w = getattr(want, k).cpu()
                    if not (torch.equal(got[k], w) or bool(
                            ((got[k] == w) | (got[k] != got[k]) & (w != w)).all())):
                        fail(f"phase 35: the {label} screen over the ranks differs from "
                             f"world 1's in {k} (rank {r['rank']})")
                per_rank.append(counted)
                add(counted)
            if dev.type == "cuda" and (
                    not all(c.get("dip_qualification", 0) for c in per_rank)
                    or use_pallas and not all(c.get("fused_mlp_forward", 0) for c in per_rank)):
                fail(f"phase 35: a rank of the {label} screen launched no kernel: {per_rank}")
            wall = r0[f"screen_{use_pallas}"][1]
            print(f"phase 35 (ii) {label} screen over {P35_WORLD} ranks: {wall:.3f} s "
                  f"(world 1 {screens[use_pallas][1]:.3f} s), equal to world 1's row for "
                  f"row; launches per rank {per_rank}")
            out[f"screen_{label}_s"] = wall
            out[f"screen_{label}_world1_s"] = screens[use_pallas][1]

        # (iii) more ranks than devices: refused before any work
        try:
            cli_main(["screen", "--models", out_dir, "--mesh-data",
                      str(torch.cuda.device_count() + 1)])
        except ValueError as e:
            print(f"phase 35 (iii) screen --mesh-data {torch.cuda.device_count() + 1}: "
                  f"refused: {e}")
        else:
            fail("phase 35: screen --mesh-data beyond the devices did not raise")

    # (iv) the λ-sweep, one rank and two ranks on one card
    sweeps = {}
    for world in (1, P35_WORLD):
        cmd = [sys.executable, os.path.join(repo, "examples", "torch_ablation_sweep.py"),
               *sweep, "--world", str(world), "--device", str(dev)]
        if world > 1:
            cmd += ["--backend", "gloo"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 35: the sweep at world {world} exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        sweeps[world] = res
        for counted in res["launches"]:
            add(counted)
        print(f"phase 35 (iv) torch_ablation_sweep.py {' '.join(sweep)} --world {world}: "
              f"{wall:.1f} s wall, members' phase {res['wall_s']:.3f} s, "
              f"{res['member_steps_per_s']:.1f} member-steps/s, {res['members_a_rank']} "
              f"members a rank, launches per rank {res['launches']}, best member "
              f"{res['ranking'][0]['member']} param R2 {res['ranking'][0]['param_r2']:.6f}")
        if not res["all_rows_finite"]:
            fail(f"phase 35: the sweep at world {world} has non-finite rows")
    key = [(r["member"], r["param_r2"]) for r in sweeps[1]["ranking"]]
    if key != [(r["member"], r["param_r2"]) for r in sweeps[P35_WORLD]["ranking"]]:
        fail("phase 35: the sweep's ranking over the ranks is not the one-rank ranking")
    print(f"phase 35 (iv) the rankings at world 1 and {P35_WORLD} are equal bit for bit in "
          f"param R2: {key}")
    if failures:
        fail("phase 35: " + "; ".join(failures))
    out.update(sweep_member_steps_per_s={w: s["member_steps_per_s"] for w, s in sweeps.items()},
               sweep_ranking=sweeps[1]["ranking"])
    wall = time.perf_counter() - t_phase
    print(f"phase 35: main-path launches {launches}; {wall:.1f} s")
    out.update(launches=launches, wall=wall)
    return out


P36_MEMBERS = 4
P36_EPOCHS = 500             # the seed search's GAN depth, cut from 24,000
P36_EVAL_EVERY = 100
P36_FWD_EPOCHS = 500
P36_SERVE_TOL = 1e-4         # the served ensemble's held-out param R2 against the snapshot's
P36_TP_EPOCHS = 5
P36_TP_ROWS_RTOL = 1e-4
# the EMA at 0.99: at 0.999 the track still holds 22 % of the initial G after
# 100 epochs of 15 steps (its held-out param R2 -1.96, NVIDIA H100 80GB HBM3)
P36_HOLDOUT = ("--fwd-epochs", "100", "--gan-epochs", "100", "--ema-decay", "0.99")
P36_THROUGHPUT = ("--throughput", "--batches", "64,512", "--chunk", "20", "--chain", "2",
                  "--meas", "2", "--eager-chunk", "1")


def _p36_tp_rank(rank: int, world: int, address: str, out_dir: str, device: str) -> None:
    """One rank of phase 36 (ii); writes ``out_dir/rank<r>.pt``."""
    import torch

    from pigan_thz_torch.ops import _cuda_build
    from pigan_thz_torch.parallel import initialize_distributed, make_mesh
    from pigan_thz_torch.train.trainer import Trainer

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(address, world, rank, backend="gloo", device=dev)
    mesh = make_mesh(data=1, model=world)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    cfg, epochs = inputs["cfg"], inputs["epochs"]
    reset_launches(_cuda_build.LAUNCHES)
    trainer = Trainer(cfg, device=dev, mesh=mesh, epochs_per_call=epochs)
    t0 = time.perf_counter()
    trainer.pretrain_forward(epochs=epochs)
    trainer.init_pigan()
    trainer.train_pigan(epochs=epochs)
    _sync(dev)
    wall = time.perf_counter() - t0
    f = trainer.pigan_state.f
    shapes = {n: tuple(p.shape) for n, p in f.named_parameters()
              if n in ("model.8.weight", "model.8.bias", "model.9.weight",
                       "model.12.weight", "model.12.bias")}
    torch.save({"rank": rank, "history": trainer.train_history, "wall": wall,
                "shapes": shapes, "launches": dict(_cuda_build.LAUNCHES),
                "model_rank": mesh.model_rank, "f_split": trainer.pigan_state.f.tp_plan.split},
               os.path.join(out_dir, f"rank{rank}.pt"))


def _p36_search(cfg, dev, repo: str, tag: str, add, epochs: int, eval_every: int,
                fwd_epochs: int) -> dict:
    """Phase 36 (i): the seed search, its first chunk against the eager
    engine, the snapshot served."""
    import dataclasses

    import torch

    from pigan_thz_torch.cli import main as cli_main
    from pigan_thz_torch.data import split_dataset, synthetic_dataset
    from pigan_thz_torch.data.dataset import denormalize_params
    from pigan_thz_torch.ops import _cuda_build
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.ops.forward_train import resolve_draws
    from pigan_thz_torch.ops.metrics import r2_score
    from pigan_thz_torch.parallel.ensemble import evaluate_ensemble
    from pigan_thz_torch.parallel.ensemble_megakernel import (
        SEARCH_DRAW_SEED, SEARCH_EPOCHS_PER_CALL, save_ensemble_best, search_chunk_fn,
        search_settings, search_states, seed_search)
    from pigan_thz_torch.serve import load_exported
    from pigan_thz_torch.train import checkpoint as ckpt
    from pigan_thz_torch.train.trainer import Trainer

    out = {}
    scfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=epochs))
    reset_launches(_cuda_build.LAUNCHES)
    full = synthetic_dataset(scfg.data, device=dev)
    train_ds, held = split_dataset(full, val_frac=0.2,
                                   generator=torch.Generator().manual_seed(9))
    t0 = time.perf_counter()
    trainer = Trainer(scfg, ds=train_ds, epochs_per_call=50, device=dev, shadow_parity="off")
    trainer.pretrain_forward(epochs=fwd_epochs, log_every=10**9)
    _sync(dev)
    f_s = time.perf_counter() - t0
    add(_cuda_build.LAUNCHES)
    f = trainer.forward_state.f

    # the first chunk's first two epochs: K3 against the eager engine from
    # the search's own start, on the search's own first draws
    spec = gt.gan_train_spec(scfg, search_settings())
    start = search_states(scfg, train_ds, P36_MEMBERS, f)
    indices, seeds = resolve_draws(torch.Generator().manual_seed(SEARCH_DRAW_SEED),
                                   train_ds.num_samples, scfg.train.batch_size,
                                   SEARCH_EPOCHS_PER_CALL)
    keep = K2_EPOCHS
    spe = indices.shape[1]
    runs = {}
    for engine in ("kernel", "eager"):
        st = start.clone()
        before = dict(_cuda_build.LAUNCHES)
        st, rows = search_chunk_fn(scfg, train_ds, engine, P36_MEMBERS)(
            st, indices[:keep], seeds[:keep * spe])
        _sync(dev)
        launched = {k: _cuda_build.LAUNCHES[k] - before[k] for k in before}
        want = {"gan_ensemble_train": int(engine == "kernel" and dev.type == "cuda"),
                "gan_train": 0}
        if any(launched[k] != v for k, v in want.items()):
            fail(f"phase 36: the {engine} engine's chunk launched {launched}")
        runs[engine] = (st, rows)
    (ks, kr), (es, er) = runs["kernel"], runs["eager"]
    keys = list(er[0])
    counts = [keys.index(k) for k in ("d_accuracy", "violation_rate")]
    floats = [j for j in range(len(keys)) if j not in counts]
    worst = 0.0
    for m in range(P36_MEMBERS):
        a = torch.stack([kr[m][k] for k in keys], 1).cpu()
        b = torch.stack([er[m][k] for k in keys], 1).cpu()
        rel = float(row_errors(a, b, keys, False)[:, floats].max())
        cnt = float((a[:, counts] - b[:, counts]).abs().max())
        diffs = gt.state_diffs(gt.state_buffers(ks[m]), gt.state_buffers(es[m]),
                               gt.state_buffers(start[m]), spec)
        far = {k: r for k, (_, r) in diffs.items() if not r <= K2_PART_RTOL[k]}
        print(f"phase 36 (i) first chunk, K3 against the eager engine, member {m}, {keep} "
              f"epochs ({keep * spe} steps): rows max rel err {rel:.3e} (rtol "
              f"{K2_ROWS_RTOL}), counts {cnt:.4f} (atol {K2_COUNT_ATOL:.4f}); by part "
              + ", ".join(f"{k} {r:.3e}" for k, (_, r) in diffs.items())
              + f" (within {K2_PART_RTOL})")
        if far or not (rel <= K2_ROWS_RTOL and cnt <= K2_COUNT_ATOL):
            fail(f"phase 36: K3's first chunk against the eager engine, member {m}: rows "
                 f"{rel:.3e}, counts {cnt:.4f}, parts beyond their limit {far}")
        worst = max(worst, rel)
    out["first_chunk_rows_rel"] = worst

    # the search, as examples/torch_seed_search.py runs it
    reset_launches(_cuda_build.LAUNCHES)
    _sync(dev)
    t0 = time.perf_counter()
    printed = []

    def on_row(row):
        printed.append(row)
        print(f"phase 36 (i) {json.dumps(row)}")

    states, best, _ = seed_search(scfg, train_ds, P36_MEMBERS, forward_model=f,
                                  epochs=epochs, eval_every=eval_every, heldout=held,
                                  engine="kernel", keep_snapshot=True, on_row=on_row)
    _sync(dev)
    search_s = time.perf_counter() - t0
    launched = dict(_cuda_build.LAUNCHES)
    add(launched)
    want = -(-epochs // SEARCH_EPOCHS_PER_CALL)
    if launched["gan_ensemble_train"] != want * (dev.type == "cuda") or launched["gan_train"]:
        fail(f"phase 36: the search launched {launched}, not {want} K3 launches")
    if len(printed) != -(-epochs // eval_every) or best.snapshot is None:
        fail("phase 36: the search printed the wrong rows or kept no snapshot")
    member_steps = P36_MEMBERS * epochs * spe / search_s
    print(f"time {tag} phase 36 (i) seed search: F {f_s:.3f} s ({fwd_epochs} epochs, "
          f"K1), {P36_MEMBERS} members x {epochs} epochs in {search_s:.3f} s "
          f"({member_steps:.1f} member-steps/s, {want} K3 launches, evaluations "
          f"included); best {best.member} param R2 {best.r2:.6f} at epoch {best.epoch}")

    # --save-best, then the artifact the export command writes
    with tempfile.TemporaryDirectory(prefix="p36_") as tmp:
        models = os.path.join(tmp, "best")
        if isinstance(best.member, int):
            ckpt.save_final_trio(models, best.snapshot[best.member])
            artifact = ["--artifact", "designer"]
            name = "designer.pt2"
        else:
            save_ensemble_best(models, best.snapshot)
            artifact = ["--artifact", "ensemble", "--ensemble-members", str(P36_MEMBERS)]
            name = "ensemble_designer.pt2"
        ckpt.save_model_config(models, scfg)
        reset_launches(_cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        rc = cli_main(["export", *artifact, "--models", models, "--out",
                       os.path.join(tmp, "art"), "--batch-size", str(held.num_samples),
                       "--device", str(dev)])
        export_s = time.perf_counter() - t0
        add(_cuda_build.LAUNCHES)
        if rc != 0:
            fail(f"phase 36: export {' '.join(artifact)} exited {rc}")
        served = load_exported(os.path.join(tmp, "art", name), device=dev)(held.spectra)
        params = served[0]
        served_r2 = float(r2_score(held.params, params))
    if isinstance(best.member, int):
        snap_r2 = float(evaluate_ensemble(best.snapshot, held)["param_r2"][best.member])
    else:
        from pigan_thz_torch.parallel.ensemble import member_predictions

        mean = member_predictions(best.snapshot, held.spectra).mean(0)
        snap_r2 = float(r2_score(held.params, denormalize_params(mean, held.param_lo,
                                                                 held.param_hi)))
    print(f"phase 36 (i) export {' '.join(artifact)} in {export_s:.1f} s: the served "
          f"held-out param R2 {served_r2:.6f}, the snapshot's in process {snap_r2:.6f} "
          f"(the search's best {best.r2:.6f}), |diff| {abs(served_r2 - snap_r2):.2e} "
          f"(tol {P36_SERVE_TOL})")
    if not abs(served_r2 - snap_r2) <= P36_SERVE_TOL or not abs(snap_r2 - best.r2) <= 1e-5:
        fail(f"phase 36: the served snapshot's held-out param R2 {served_r2} is not the "
             f"snapshot's {snap_r2} (best {best.r2})")
    out.update(search_s=search_s, f_s=f_s, member_steps_per_s=member_steps, best=best.r2,
               best_member=best.member, best_epoch=best.epoch, served_r2=served_r2,
               rows=printed)
    return out


def _p36_subprocess(repo: str, script: str, args, add, what: str, timeout: int = 900):
    """``examples/<script>`` in a subprocess: (its stdout, wall s); its
    ``kernel launches`` line (on stderr) added to the phase's."""
    cmd = [sys.executable, os.path.join(repo, "examples", script), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 36: {what} exited {proc.returncode}: {proc.stderr[-3000:]}")
    add(launches_line(proc.stderr, what))
    return proc.stdout, wall


def phase36_slice18(cfg, dev, repo: str, tag: str, epochs: int = P36_EPOCHS,
                    eval_every: int = P36_EVAL_EVERY, fwd_epochs: int = P36_FWD_EPOCHS,
                    tp_epochs: int = P36_TP_EPOCHS, holdout=P36_HOLDOUT,
                    throughput=P36_THROUGHPUT) -> dict:
    """The last modules on the card (module docstring, phase 36).  The
    arguments cut the phase for a rehearsal on the CPU.  Returns the
    main-path launches and the numbers for the record."""
    import torch

    from pigan_thz_torch.ops import _cuda_build
    from pigan_thz_torch.parallel.mesh import spawn_ranks
    from pigan_thz_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    out = {"search": _p36_search(cfg, dev, repo, tag, add, epochs, eval_every, fwd_epochs)}

    # (ii) tensor parallelism: two gloo ranks on the card as a model axis
    with tempfile.TemporaryDirectory(prefix="p36_tp_") as out_dir:
        reset_launches(_cuda_build.LAUNCHES)
        alone = Trainer(cfg, device=dev, engine="eager", epochs_per_call=tp_epochs)
        t0 = time.perf_counter()
        alone.pretrain_forward(epochs=tp_epochs)
        alone.init_pigan()
        alone.train_pigan(epochs=tp_epochs)
        _sync(dev)
        w1_wall = time.perf_counter() - t0
        add(_cuda_build.LAUNCHES)
        torch.save({"cfg": cfg, "epochs": tp_epochs}, os.path.join(out_dir, "inputs.pt"))
        t0 = time.perf_counter()
        spawn_ranks(_p36_tp_rank, 2, out_dir, str(dev))
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    r0 = ranks[0]
    for r in ranks:
        add(r["launches"])
    if ranks[1]["history"] != r0["history"] or not r0["f_split"]:
        fail("phase 36: the model ranks saw other rows, or F did not compute split")
    spe = cfg.data.num_samples // cfg.train.batch_size
    held = {}
    for k, w in alone.train_history.items():
        g = r0["history"][k]
        atol = 1.0 / (spe * cfg.train.batch_size) if k in P35_COUNT_ROWS else 1e-6
        held[k] = abs(g[0] - w[0]) / (P36_TP_ROWS_RTOL * abs(w[0]) + atol)
    worst = max(held, key=held.get)
    print(f"phase 36 (ii) Trainer(mesh=make_mesh(data=1, model=2)) on two gloo ranks of "
          f"{dev}, {tp_epochs} + {tp_epochs} epochs: {r0['wall']:.2f} s (world 1 "
          f"eager {w1_wall:.2f} s, spawn {spawn_s:.1f} s); F's 1024-wide layers on each "
          f"rank: " + ", ".join(f"{n} {s}" for n, s in r0["shapes"].items())
          + f"; the first epoch's rows at most {held[worst]:.3g} of the limit ({worst}, "
          f"rtol {P36_TP_ROWS_RTOL})")
    for k, w in alone.train_history.items():
        print(f"phase 36 (ii) {k}: model axis " + " ".join(f"{x:.6g}" for x in
                                                         r0["history"][k])
              + " | world 1 " + " ".join(f"{x:.6g}" for x in w))
    if held[worst] > 1.0:
        fail(f"phase 36: the model axis's first-epoch {worst} is {held[worst]:.3g} of its "
             "limit from world 1's")
    out.update(tp_wall=r0["wall"], tp_world1_wall=w1_wall, tp_shapes=r0["shapes"],
               tp_rows_held=held)

    # (iii) the held-out example
    stdout, wall = _p36_subprocess(repo, "torch_holdout_eval.py",
                                   [*holdout, "--device", str(dev)], add,
                                   "torch_holdout_eval.py")
    res = json.loads(stdout)
    if set(res) != {"ceilings", "train", "heldout", "heldout_ema", "wall_s"} or not all(
            v == v and abs(v) != float("inf") for part in ("train", "heldout", "heldout_ema")
            for v in res[part].values()):
        fail(f"phase 36: torch_holdout_eval.py printed {res}")
    print(f"phase 36 (iii) torch_holdout_eval.py {' '.join(holdout)}: {wall:.1f} s; "
          f"train {res['train']}, held out {res['heldout']}, held out EMA "
          f"{res['heldout_ema']}")
    out["holdout"] = res

    # (iv) the scaled-batch throughput
    stdout, wall = _p36_subprocess(repo, "torch_scaled_batch_probe.py",
                                   [*throughput, "--device", str(dev)], add,
                                   "torch_scaled_batch_probe.py")
    res = json.loads(stdout.strip().splitlines()[-1])
    rows = res["rows"]
    if len(rows) != 4 or any("error" in r for r in rows):
        fail(f"phase 36: the throughput probe's rows {rows}")
    for r in rows:
        print(f"time {tag} phase 36 (iv) B = {r['batch']} {r['backend']}: "
              f"{r['steps_per_sec']} steps/s, {r['samples_per_sec']} samples/s, "
              f"{r['tflops_per_sec']} TFLOP/s, MFU {r.get('mfu_pct')} %")
    out["throughput"] = rows
    wall = time.perf_counter() - t_phase
    print(f"phase 36: main-path launches {launches}; {wall:.1f} s")
    out.update(launches=launches, wall=wall)
    return out


# ---------------------------------------------------------------------------
# Phase 37: the residual generator's chain kernel
# ---------------------------------------------------------------------------
# The enhanced designer's residual G (250 -> 512, three residual blocks of
# two 512 x 512, 256, 128 -> 4, BatchNorm folded at packing) through its
# hand-written kernel (csrc/fused_residual_chain.cu), which replaces no TPU
# kernel.  Held within the design cells' params_gap limit (the widest gap
# over the reference's RMS) of the fp32 module and of the plain folded chain
# (cuBLAS, TF32 off); served through the default designer with the baseline
# F (K5), one launch a request from the crossover up and none below it.
P37_GAP = 3e-5
P37_CHECK_BATCHES = (1, 77, 8192, 8192 + 37, 65536)    # and the crossover's two sides
P37_SERVE_BATCHES = (8192, 65536)                      # and the crossover's two sides
P37_REQUESTS = 8
P37_TIME_BATCHES = (8192, 65536)                       # and the crossover


def p37_gap(got, want) -> float:
    return float((got - want).abs().max()) / float(want.pow(2).mean().sqrt())


def p37_work(b: int, dims) -> tuple:
    """(flops, bytes) of the residual chain at batch b: its products; x read,
    the output written and every folded W and b read once."""
    n_w = sum(i * o + o for i, o in zip(dims, dims[1:]))
    return 2.0 * b * chain_macs(dims), 4.0 * (b * dims[0] + n_w + b * dims[-1])


def phase37_residual(cfg, dev, F, ds, tag: str) -> dict:
    """The residual generator's chain kernel on the card (module docstring,
    phase 37).  Returns its numbers for the record."""
    import torch

    from pigan_thz_torch import serve
    from pigan_thz_torch.config import GeneratorConfig
    from pigan_thz_torch.models import build_generator
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.ops.costs import PEAK_TF32_FLOPS
    from pigan_thz_torch.utils import profiling

    t0 = time.perf_counter()
    saved = dict(fk.LAUNCHES)
    gen = torch.Generator().manual_seed(SEED + 37)
    G = build_generator(GeneratorConfig(name="residual"), cfg.data.spectrum_dim, device=dev,
                        generator=gen)
    perturb_batch_stats_(G, gen)
    G = G.eval().requires_grad_(False)
    packed = fk.pack_residual(G, dev)
    cross = serve.ResidualStage.crossover
    dgen = torch.Generator(device=dev).manual_seed(SEED + 37)
    out = {"crossover": cross, "gap": {}, "gap_vs_plain": {}}

    # (a) the kernel against the fp32 module and the plain folded chain
    with torch.inference_mode():
        for b in sorted({*P37_CHECK_BATCHES, cross - 1, cross}):
            x = torch.randn((b, cfg.data.spectrum_dim), generator=dgen, device=dev)
            reset_launches(fk.LAUNCHES)
            got = fk.fused_residual_chain(x, packed)
            again = fk.fused_residual_chain(x, packed)
            torch.cuda.synchronize()
            n = fk.LAUNCHES["fused_residual_chain"]
            gap = p37_gap(got, G(x))
            gap_plain = p37_gap(got, fk.fused_residual_chain_plain(x, packed))
            print(f"phase 37 kernel check B={b}: gap over the module's RMS {gap:.3e}, over the "
                  f"plain folded chain's {gap_plain:.3e} (limit {P37_GAP}), launches {n}, "
                  f"rerun bit-identical {bool(torch.equal(got, again))}")
            if not (gap <= P37_GAP and gap_plain <= P37_GAP):
                fail(f"phase 37: the residual chain kernel is off at B={b}")
            if not torch.equal(got, again) or n != 2:
                fail(f"phase 37: at B={b} a rerun differs or the calls launched {n} times")
            out["gap"][str(b)], out["gap_vs_plain"][str(b)] = gap, gap_plain

    # (b) served: the default designer, launches counted from 0 around each
    # batch's requests, the G span's shape, against the all-module designer
    fn = serve.make_inverse_design_fn(G, F, ds)
    modules = serve.make_inverse_design_fn(G, F, ds, use_pallas=False)
    out["serving"] = {}
    for b in sorted({*P37_SERVE_BATCHES, cross - 1, cross}):
        spectra = torch.randn((b, cfg.data.spectrum_dim), generator=dgen, device=dev)
        fn(spectra)
        fn(spectra)                     # a module stage below the crossover captures here
        want = modules(spectra)
        torch.cuda.synchronize()
        reset_launches(fk.LAUNCHES)
        profiling.reset()
        with profiling.recording():
            answers = [fn(spectra) for _ in range(P37_REQUESTS)]
            torch.cuda.synchronize()
            snap = profiling.snapshot()
        got = dict(fk.LAUNCHES)
        spans = [r["attrs"] for r in snap["recent"] if r["name"] == "pigan.serve.gen_stage"]
        gap = max(p37_gap(a[0], want[0]) for a in answers)
        kernel = b >= cross
        print(f"phase 37 serving B={b}: {P37_REQUESTS} requests, launches "
              f"{ {k: v for k, v in got.items() if v} }, G spans {spans[-1]}, params gap "
              f"against the module designer {gap:.3e} (limit {P37_GAP})")
        shape = fk.WGMMA if kernel else "module"
        if (got["fused_residual_chain"] != P37_REQUESTS * kernel
                or got["fused_mlp_forward"] != P37_REQUESTS or got["fused_dense_chain"] != 0
                or spans != [{"replayed": int(not kernel), "shape": shape}] * P37_REQUESTS):
            fail(f"phase 37: at B={b} the designer's G stage did not take the "
                 f"{'kernel' if kernel else 'module graph'} once a request: {got}, {spans}")
        if not gap <= P37_GAP:
            fail(f"phase 37: at B={b} the designer's params are off the module designer's")
        out["serving"][str(b)] = {"launches": got["fused_residual_chain"],
                                  "requests": P37_REQUESTS, "params_gap": gap}

    # (c) times, in turns: plain, the graphed module stage, kernel, kernel,
    # module stage, plain; the best of each side's two medians
    out["times"] = {}
    dims = packed.dims
    with torch.inference_mode():
        for b in (cross, *P37_TIME_BATCHES):
            x = torch.randn((b, cfg.data.spectrum_dim), generator=dgen, device=dev)
            stage = serve.ModuleStage(copy.deepcopy(G))
            stage(x)
            stage(x)                    # captured: later calls replay
            p1 = cuda_median_ms(fk.fused_residual_chain_plain, x, packed)
            l1 = cuda_median_ms(stage, x)
            k1 = cuda_median_ms(fk.fused_residual_chain, x, packed)
            k2 = cuda_median_ms(fk.fused_residual_chain, x, packed)
            l2 = cuda_median_ms(stage, x)
            p2 = cuda_median_ms(fk.fused_residual_chain_plain, x, packed)
            flops, nbytes = p37_work(b, dims)
            bound_ms, bound_by = roofline(flops, nbytes)
            tf32_ms = max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
            row = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
                   "replayed": stage.replayed, "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_tf32_ms": tf32_ms,
                   "bound_3xtf32_ms": design_bound_3xtf32(flops, nbytes)}
            out["times"][str(b)] = row
            print(f"time {tag} fused_residual_chain B={b}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, the graphed module stage {row['library_ms']:.4f} "
                  f"ms (replayed {stage.replayed}); bound {bound_ms:.4f} ms fp32 ({bound_by}), "
                  f"{row['bound_tf32_ms']:.4f} TF32, {row['bound_3xtf32_ms']:.4f} 3xTF32 "
                  f"(CUDA-event median of 50 after 10 warm-up, best of two runs each, in turns)")
    fk.LAUNCHES.update(saved)
    out["wall"] = time.perf_counter() - t0
    print(json.dumps({"phase37": out}))
    return out


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
    crossovers = {fk.crossover_for(p) for p in (f_packed, g_packed)}
    print(f"launch shape: {fk.chain_limits(f_packed)[0]} SMs; clusters resident at once "
          f"for K5 {fk.chain_limits(f_packed)[1]}, for K6 {fk.chain_limits(g_packed)[1]}; "
          f"the row-tile shape from B = {sorted(crossovers)}")
    for b in sorted({*CHECK_BATCHES, *(c - 1 for c in crossovers), *crossovers}):
        x = torch.rand((b, 4), generator=dgen, device=dev) * 2 - 1
        s = torch.randn((b, cfg.data.spectrum_dim), generator=dgen, device=dev)
        line = []
        for name, inp, packed, tol in (
                ("fused_mlp_forward", x, f_packed, K5_TOL),
                ("fused_dense_chain", s, g_packed, K6_TOL)):
            kern = getattr(fk, name)
            got = kern(inp, packed)
            again = kern(inp, packed)
            torch.cuda.synchronize()
            want = getattr(fk, name + "_plain")(inp, packed)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            shape = fk.chosen_shape(inp, packed)
            line.append(f"{name} max|err| {err:.3e} (tol {tol}, cluster {shape})")
            if not err <= tol:
                fail(f"{name} disagrees with its plain version at B={b}")
            if not torch.equal(got, again):
                fail(f"{name}: a rerun at B={b} is not bit-identical")
            # the row-tile shape sums every output in the same order (the
            # wgmma shape in another)
            if shape not in (1, fk.WGMMA) and not torch.equal(got, kern(inp, packed, cluster=1)):
                fail(f"{name}: cluster {shape} and the row-tile shape differ at B={b}")
            max_err[name] = max(max_err[name], err)
        print(f"kernel check B={b}: " + ", ".join(line) + ", reruns bit-identical")

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

    # plain, library, kernel, kernel, library, plain: the best of each
    # side's two medians
    times = {}
    with torch.inference_mode():
        for b in TIME_BATCHES:
            x = torch.rand((b, 4), generator=dgen, device=dev) * 2 - 1
            s = requests[b]
            rows = {
                "fused_mlp_forward": (fk.fused_mlp_forward, fk.fused_mlp_forward_plain,
                                      F, x, f_packed),
                "fused_dense_chain": (fk.fused_dense_chain, fk.fused_dense_chain_plain,
                                      G, s, g_packed),
            }
            for name, (kern, plain, module, inp, packed) in rows.items():
                p1 = cuda_median_ms(plain, inp, packed)
                # the one PyTorch call that computes the same function: the
                # module's eval-mode forward (cuBLAS products, torch's norms)
                l1 = cuda_median_ms(module, inp)
                k1 = cuda_median_ms(kern, inp, packed)
                k2 = cuda_median_ms(kern, inp, packed)
                l2 = cuda_median_ms(module, inp)
                p2 = cuda_median_ms(plain, inp, packed)
                times[(name, b)] = (min(k1, k2), min(p1, p2))
                times[("library " + name, b)] = (min(l1, l2),) * 2
                times[("shape " + name, b)] = fk.chosen_shape(inp, packed)
            p1 = cuda_median_ms(plain_cycle, s)
            k1 = cuda_median_ms(fn, s)
            k2 = cuda_median_ms(fn, s)
            p2 = cuda_median_ms(plain_cycle, s)
            times[("cycle", b)] = (min(k1, k2), min(p1, p2))
    for (name, b), t in times.items():
        if name.startswith("shape"):
            continue
        k, p = t
        if name.startswith("library"):
            print(f"time {tag} {name} B={b}: the module's eval forward {k:.4f} ms "
                  f"(CUDA-event median of 50 after 10 warm-up, best of two runs, in turns "
                  f"with the kernel)")
            continue
        shape = times.get(("shape " + name, b))
        print(f"time {tag} {name} B={b}: kernel {k:.4f} ms, plain {p:.4f} ms "
              f"(CUDA-event median of 50 after 10 warm-up, best of two runs each)"
              + (f", cluster {shape}" if shape is not None else ""))

    for b in (64, 8192):
        profile_cycle(fn, requests[b], f"serving cycle B={b}")

    # -- 37. the residual generator's chain kernel, here beside the serving
    # kernels (and ahead of the training phases) ------------------------------
    residual = phase37_residual(cfg, dev, F, ds, tag)

    # -- 6. K4 against both plain versions ------------------------------------
    k4_stats = phase6_k4(dgen, cfg, dev, f_packed, repo)

    # -- 7. dataset generation -----------------------------------------------
    dataset_k4 = phase7_dataset(cfg, dev, repo)

    # -- 8. screening --------------------------------------------------------
    screens = phase8_screen(F, cfg, dev, lo, hi)

    # -- 9. times ------------------------------------------------------------
    from pigan_thz_torch.design import ScreeningConfig

    k4_times = phase9_k4_times(dgen, cfg, dev, f_packed)
    k4_ops, k4_bytes, k4m_ops, k4m_bytes = k4_times.pop("work")
    for name, row in k4_times.items():
        if name.startswith("metrics"):
            print(f"time {tag} peak_metrics B={K4_BATCHES[-1]} {name[8:]} spectra: kernel "
                  f"{row['kernel']:.4f} ms, plain (sparse-table form + spectrum_metrics) "
                  f"{row['plain']:.4f} ms, spectrum_metrics given the mask "
                  f"{row['selection']:.4f} ms, four-output entry + spectrum_metrics "
                  f"{row['two_step']:.4f} ms (CUDA-event medians, best of two runs each)")
            continue
        k, p, l = row
        print(f"time {tag} dip_qualification B={K4_BATCHES[-1]} {name} spectra: "
              f"kernel {k:.4f} ms" + ("" if p is None else
                                      f", plain lattice {p:.4f} ms, plain lifted {l:.4f} ms")
              + " (CUDA-event medians, best of two runs each)")
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

    # -- 30. one fused screening chunk under the profiler, here beside the
    # screens: after phase 29's CUDA graphs the profiler records no kernel
    chunk_profile = phase30_chunk_profile(F, cfg, dev, tag)

    # -- 10. K1 against its plain version ------------------------------------
    from pigan_thz_torch.data import synthetic_dataset

    train_ds = synthetic_dataset(cfg.data, device=dev)
    k1_stats = phase10_k1(cfg, dev, train_ds)

    # -- 11. forward pretraining ----------------------------------------------
    pretrain = phase11_pretrain(cfg, dev, repo, G, ds, requests[64])

    # -- 12. times -------------------------------------------------------------
    k1_times = phase12_k1_times(cfg, dev, train_ds)
    k1_ms, k1_plain_ms, k1_eager_ms = (k1_times[k] for k in ("ms", "plain_ms", "eager_ms"))
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
    # -- 31. the evaluation entry point, on the --fixed-physics trio ------------
    # -- 32 runs later on a copy of the --fixed-physics trio ----------------------
    kept = tempfile.mkdtemp(prefix="chip_smoke_trio_")
    serving_models = os.path.join(kept, "saved_models")

    def on_fixed_trio(out):
        shutil.copytree(out, serving_models)
        return phase31_evaluate(cfg, dev, repo, out, tag)

    trains = {fixed: phase14_train(
        cfg, dev, repo, ds, requests[64], train_ds, fixed,
        then=on_fixed_trio if fixed else None)
        for fixed in (False, True)}
    evaluation = trains[True]["then"]

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
          f"--fwd-epochs {PRETRAIN_EPOCHS} --holdout: {ensemble['wall']:.4f} s wall for the "
          f"command, {ensemble['out']['wall_s']:.4f} s for the members' {K3_MEMBERS} x "
          f"{GAN_EPOCHS * ensemble['out']['steps_per_epoch']} steps, "
          f"{ensemble['out']['member_steps_per_s']:.1f} "
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

    # -- 29. the batch-row products of K2 and K3 -----------------------------------
    brow = phase29_brow_products(cfg, dev, tag)

    # -- 32. serving completed: the dtypes, the artifacts, screen, design ----------
    reset_launches(_cuda_build.LAUNCHES)
    try:
        serving = phase32_serving(cfg, dev, repo, serving_models, ds, requests,
                                  ensemble["saved"], G, F, tag)
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    sv = serving["launches"]

    # -- 33. preemption-safe training and the operational commands ---------------
    preempt = phase33_preemption(cfg, dev, repo, train_ds, k2_times[True][0], tag)
    pr = preempt["launches"]

    # -- 34. the enhanced variants ---------------------------------------------------
    enhanced = phase34_enhanced(cfg, dev, repo, train_ds, tag)
    p34 = enhanced["launches"]

    # -- 35. ensembles and data parallelism --------------------------------------------
    parallel = phase35_parallel(cfg, dev, repo, F, lo, hi, screens, tag)
    p35 = parallel["launches"]

    # -- 36. the last modules: the seed search, the model axis, the examples -------------
    slice18 = phase36_slice18(cfg, dev, repo, tag)
    p36 = slice18["launches"]

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
    big = 8192   # the times in the record are at B = 8192, and at B = 64 beside
    def serving_work(b):
        """(flops, bytes) of K5 and K6 at batch b; BatchNorm folded: its
        four vectors per hidden layer are read too."""
        return {"fused_mlp_forward": (2.0 * b * macs_f, 4.0 * (b * 4 + n_f + b * (S + nm))),
                "fused_dense_chain": (2.0 * b * macs_g,
                                      4.0 * (b * S + n_g + 2 * sum(g_dims[1:-1]) + b * 4))}

    serving_rec = {name: {"bound_3xtf32_ms": design_bound_3xtf32(*serving_work(big)[name]),
                      "bound_ms_b64": roofline(*serving_work(64)[name])[0],
                      "bound_3xtf32_ms_b64": design_bound_3xtf32(*serving_work(64)[name]),
                      "ms_b64": times[(name, 64)][0],
                      "plain_ms_b64": times[(name, 64)][1],
                      "library_ms_b64": times[("library " + name, 64)][0],
                      "ms_by_batch": {str(b): times[(name, b)][0] for b in TIME_BATCHES},
                      "library_ms_by_batch": {str(b): times[("library " + name, b)][0]
                                              for b in TIME_BATCHES},
                      "shape": {str(b): times[("shape " + name, b)] for b in TIME_BATCHES}}
               for name in ("fused_mlp_forward", "fused_dense_chain")}
    print(f"time {tag} serving cycle: " + ", ".join(
        f"B={b} {times[('cycle', b)][0]:.4f} ms" for b in TIME_BATCHES))
    bound = {
        "fused_mlp_forward": roofline(*serving_work(big)["fused_mlp_forward"]),
        "fused_dense_chain": roofline(*serving_work(big)["fused_dense_chain"]),
        "dip_qualification": roofline(k4_ops, k4_bytes),
        "peak_metrics": roofline(k4m_ops, k4m_bytes),
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
          f"{' | '.join(PROGRAMS)} and train --preset optimized {pl}, phase 31's evaluate "
          f"commands and train --holdout {evaluation['launches']}, phase 32's serving "
          f"paths and commands {sv}")
    ev_l = evaluation["launches"]

    def bounds(name):
        ms, by = bound[name]
        return {"bound_ms": ms, "bound_by": by}

    # K1, K2 and K3 launch their batch-row products through brow_gemm.cuh from
    # their C loops: its launches on the main paths (K1's among them: every
    # command here pretrains F first), and each product's numbers
    k1_brow = pretrain["launches"]["brow_gemm"]
    brow_main = (k1_brow + tl["brow_gemm"] + el["brow_gemm"] + pl["brow_gemm"]
                 + sl["brow_gemm"] + ev_l["brow_gemm"] + pr.get("brow_gemm", 0)
                 + p34.get("brow_gemm", 0) + p35.get("brow_gemm", 0)
                 + p36.get("brow_gemm", 0))
    if not k1_brow or not tl["brow_gemm"] or not el["brow_gemm"]:
        fail(f"the main paths launched the batch-row kernel {brow_main} times "
             f"(pretrain-forward {k1_brow}, train {tl['brow_gemm']}, ensemble "
             f"{el['brow_gemm']})")
    brow_note = {
        "note": "K1, K2 and K3 route their batch-row products (M = B or 2B rows) through "
                "brow_gemm (cluster split-K, fixed-order DSMEM sum, cp.async ring)",
        "source": "pigan_thz_torch/csrc/brow_gemm.cuh",
        "launches": brow_main,
        "launches_k1_pretrain_forward": k1_brow,
        "launches_k3_commands": el["brow_gemm"],
        "through_f_step_us": brow["through_f_step"],
        # a through-F fp32 step's products at M = 1 (every shape and flag at
        # M = 1 and 4 is printed above)
        "products": [{k: row[k] for k in ("shape", "bnc", "bias", "split", "us", "sgemm_us",
                                          "matmul_us", "bound_us", "of_bound_vs_float64")}
                     | {"a_step": row["a_step"]["through F"]}
                     for row in brow["products"] if row["members"] == 1
                     and not row["bf16"] and "through F" in row["a_step"]]}

    record = {"kernels": [
        {"name": "fused_mlp_forward", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:73",
         "launches": launches["fused_mlp_forward"] + k5_screen + sv["fused_mlp_forward"]
         + p34.get("fused_mlp_forward", 0) + p35.get("fused_mlp_forward", 0) + p36.get("fused_mlp_forward", 0),
         "launches_serving_completed": sv["fused_mlp_forward"],
         "launches_enhanced_variants": p34.get("fused_mlp_forward", 0),
         "launches_ensembles_and_data_parallelism": p35.get("fused_mlp_forward", 0),
         "screens_over_ranks": {k: parallel[k] for k in (
             "screen_fused_s", "screen_fused_world1_s", "screen_module_s",
             "screen_module_world1_s")},
         "serving": {k: serving[k] for k in ("times", "latency", "screens",
                                             "screen_bf16_gap", "export_wall_s",
                                             "distances", "int8_fresh_envelope")},
         "max_abs_err": max_err["fused_mlp_forward"],
         "ms": times[("fused_mlp_forward", big)][0],
         "plain_ms": times[("fused_mlp_forward", big)][1],
         **bounds("fused_mlp_forward"),
         "library_ms": times[("library fused_mlp_forward", big)][0],
         **serving_rec["fused_mlp_forward"]},
        {"name": "fused_dense_chain", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:185",
         "launches": launches["fused_dense_chain"] + sv["fused_dense_chain"]
         + p35.get("fused_dense_chain", 0) + p36.get("fused_dense_chain", 0),
         "launches_serving_completed": sv["fused_dense_chain"],
         "max_abs_err": max_err["fused_dense_chain"],
         "ms": times[("fused_dense_chain", big)][0],
         "plain_ms": times[("fused_dense_chain", big)][1],
         **bounds("fused_dense_chain"),
         "library_ms": times[("library fused_dense_chain", big)][0],
         **serving_rec["fused_dense_chain"]},
        {"name": "fused_residual_chain", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_residual_chain.cu",
         "replaces": None,
         "launches": sum(r["launches"] for r in residual["serving"].values()),
         "serving": residual["serving"], "crossover": residual["crossover"],
         "max_abs_err": None, "gap_over_module_rms": residual["gap"],
         "gap_over_plain_rms": residual["gap_vs_plain"],
         **residual["times"][str(big)],
         "by_batch": residual["times"]},
        {"name": "dip_qualification", "route": "cuda",
         "source": "pigan_thz_torch/csrc/dip_qualification.cu",
         "replaces": "pigan_thz_tpu/ops/peaks.py:306",
         "launches": dataset_k4 + k4_screen + tl["dip_qualification"]
         + el["dip_qualification"] + pl["dip_qualification"] + ev_l["dip_qualification"]
         + sv["dip_qualification"] + pr.get("dip_qualification", 0)
         + p34.get("dip_qualification", 0) + p35.get("dip_qualification", 0)
         + p36.get("dip_qualification", 0),
         "launches_preemption_safe_training": pr.get("dip_qualification", 0),
         "launches_enhanced_variants": p34.get("dip_qualification", 0),
         "launches_ensembles_and_data_parallelism": p35.get("dip_qualification", 0),
         "launches_last_modules": p36.get("dip_qualification", 0),
         "launches_serving_completed": sv["dip_qualification"],
         "launches_evaluate_path": ev_l["dip_qualification"],
         "evaluate": {k: evaluation[k] for k in ("ceilings", "eval_ms", "ceilings_oracle_ms",
                                                 "adjusted", "walls", "heldout", "plot")},
         "max_abs_err": k4_stats["max_abs_err"],
         "mask_mismatches": k4_stats["mask_mismatches"],
         "metrics_nan_diff": k4_stats["metrics_nan_diff"],
         "metrics_values_differing": k4_stats["metrics_values_differing"],
         "ms": k4_times["screen"][0],
         "plain_ms": k4_times["screen"][1],
         "plain_lifted_ms": k4_times["screen"][2],
         "ms_by_class": {k: v[0] for k, v in k4_times.items()
                         if not k.startswith("metrics")},
         "metrics_ms": k4_times["metrics screen"]["kernel"],
         "metrics_plain_ms": k4_times["metrics screen"]["plain"],
         "metrics_selection_plain_ms": k4_times["metrics screen"]["selection"],
         "metrics_two_step_ms": k4_times["metrics screen"]["two_step"],
         "metrics_with_centres": k4_times["metrics synthetic"],
         "metrics_bound_ms": bound["peak_metrics"][0],
         "metrics_bound_by": bound["peak_metrics"][1],
         "chunk_profile": chunk_profile,
         **bounds("dip_qualification"), "library_ms": None},
        {"name": "forward_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/forward_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:2623",
         "launches": k1_launches + tl["forward_train"] + el["forward_train"]
         + pl["forward_train"] + sl["forward_train"] + ev_l["forward_train"]
         + pr.get("forward_train", 0) + p34.get("forward_train", 0)
         + p35.get("forward_train", 0) + p36.get("forward_train", 0),
         "launches_preemption_safe_training": pr.get("forward_train", 0),
         "launches_enhanced_variants": p34.get("forward_train", 0),
         "launches_ensembles_and_data_parallelism": p35.get("forward_train", 0),
         "launches_last_modules": p36.get("forward_train", 0),
         "data_parallelism": {k: parallel[k] for k in (
             "world1_pigan_steps_per_s", "world2_pigan_steps_per_s",
             "world1_forward_steps_per_s", "world2_forward_steps_per_s", "rows_apart",
             "sweep_member_steps_per_s", "wall")},
         "enhanced_variants": {k: enhanced[k] for k in ("optimized", "evaluate", "request",
                                                        "eager_steps_per_s", "wall")},
         "preemption_safe_training": {
             "shadow_replay": preempt["shadow"], "checkpoint": preempt["checkpoint"]["forward"],
             "pipeline_walls_s": preempt["pipeline"]},
         "launches_bf16": s7["train_bf16"]["launches"]["forward_train"],
         "bf16_ms": s7["times"]["k1"]["bf16"], "float32_ms_same_call": s7["times"]["k1"][
             "float32"],
         "bf16_first_step_rel_err_vs_float64": s7["bf16"]["k1_first_step_rel"],
         "bf16_params_rel_err_30_steps": s7["bf16"]["k1_params_rel"],
         "bf16_bound_ms": bound["forward_train bf16"][0],
         "bf16_bound_by": bound["forward_train bf16"][1],
         "max_abs_err": k1_stats["max_abs_err"],
         "rows_max_rel_err": k1_stats["rows_rel"],
         "first_step_vs_float64": k1_stats["first_step"],
         "kernels_a_step": k1_times["a_step"],
         "profile_5_epochs": k1_times["profile"],
         "brow_gemm": {"note": "K1's ten batch-row products a step (F's forward layers 2-5 "
                               "and head, their input gradients) go through brow_gemm",
                       "source": "pigan_thz_torch/csrc/brow_gemm.cuh",
                       "a_step": k1_times["brow_a_step"],
                       "launches_pretrain_forward": k1_brow,
                       "step_us": brow["k1_step"], "bf16_step_us": brow["k1_bf16_step"]},
         "ms": k1_ms, "plain_ms": k1_plain_ms, "eager_ms": k1_eager_ms,
         **bounds("forward_train"), "library_ms": None},
        {"name": "gan_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/gan_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:779",
         "launches": tl["gan_train"] + el["gan_train"] + pl["gan_train"] + sl["gan_train"]
         + ev_l["gan_train"] + pr.get("gan_train", 0) + p35.get("gan_train", 0)
         + p36.get("gan_train", 0),
         "launches_preemption_safe_training": pr.get("gan_train", 0),
         "launches_last_modules": p36.get("gan_train", 0),
         "preemption_safe_training": {
             "checkpoint": preempt["checkpoint"]["pigan"],
             "checkpoint_command": preempt["checkpoint_command"],
             "profile": preempt["commands"]["profile"],
             "cache_data": preempt["commands"]["cache"]},
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
         "brow_gemm": brow_note,
         **bounds("gan_train"), "library_ms": None},
        {"name": "gan_ensemble_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/gan_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:2128",
         "launches": el["gan_ensemble_train"] + p35.get("gan_ensemble_train", 0)
         + p36.get("gan_ensemble_train", 0),
         "members": K3_MEMBERS,
         "launches_last_modules": p36.get("gan_ensemble_train", 0),
         "seed_search": {k: slice18["search"][k] for k in (
             "search_s", "f_s", "member_steps_per_s", "best", "best_member", "best_epoch",
             "served_r2", "first_chunk_rows_rel")},
         "model_axis": {k: slice18[k] for k in ("tp_wall", "tp_world1_wall", "tp_shapes")},
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
         "brow_gemm": {"note": brow_note["note"], "source": brow_note["source"],
                       "launches": el["brow_gemm"]},
         **bounds("gan_ensemble_train"), "library_ms": None},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
