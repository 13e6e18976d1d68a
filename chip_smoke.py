#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (pigan_thz_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's slices at full published width through the
hand-written CUDA kernels: the inverse-design serving cycle on the baseline
MLP trio, dataset generation, and the 1e6-candidate screen:

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
    CUDA-event medians of K1, its plain version and the eager step.

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
                "forward_train": 0}
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
    f = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim)
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
                                cfg.data.metrics_dim)
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

    # -- 3. each kernel against its plain version ----------------------------
    # Full-width G and F through the registry, on the card, seeded.
    cfg = default_config()
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
            p1 = cuda_median_ms(plain_cycle, s)
            k1 = cuda_median_ms(fn, s)
            k2 = cuda_median_ms(fn, s)
            p2 = cuda_median_ms(plain_cycle, s)
            times[("cycle", b)] = (min(k1, k2), min(p1, p2))
    for (name, b), (k, p) in times.items():
        print(f"time {tag} {name} B={b}: kernel {k:.4f} ms, plain {p:.4f} ms "
              f"(CUDA-event median of 50 after 10 warm-up, best of two runs each)")

    # -- 6. K4 against both plain versions ------------------------------------
    k4_stats = phase6_k4(dgen, cfg, dev)

    # -- 7. dataset generation -----------------------------------------------
    repo = os.path.dirname(os.path.abspath(__file__))
    dataset_k4 = phase7_dataset(cfg, dev, repo)

    # -- 8. screening --------------------------------------------------------
    screens = phase8_screen(F, cfg, dev, lo, hi)

    # -- 9. times ------------------------------------------------------------
    from pigan_thz_torch.design import ScreeningConfig

    k4_times = phase9_k4_times(dgen, cfg, dev, f_packed)
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

    big = max(TIME_BATCHES)   # the times in the record are at B = 8192
    k5_screen = screens[True][2]["fused_mlp_forward"]
    k4_screen = sum(s[2]["dip_qualification"] for s in screens.values())
    k1_launches = pretrain["launches"]["forward_train"]
    print(f"main-path launches: serving {launches}, dataset dip_qualification "
          f"{dataset_k4}, screens fused_mlp_forward {k5_screen} dip_qualification "
          f"{k4_screen}, pretrain-forward forward_train {k1_launches}")
    record = {"kernels": [
        {"name": "fused_mlp_forward", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:73",
         "launches": launches["fused_mlp_forward"] + k5_screen,
         "max_abs_err": max_err["fused_mlp_forward"],
         "ms": times[("fused_mlp_forward", big)][0],
         "plain_ms": times[("fused_mlp_forward", big)][1]},
        {"name": "fused_dense_chain", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:185",
         "launches": launches["fused_dense_chain"],
         "max_abs_err": max_err["fused_dense_chain"],
         "ms": times[("fused_dense_chain", big)][0],
         "plain_ms": times[("fused_dense_chain", big)][1]},
        {"name": "dip_qualification", "route": "cuda",
         "source": "pigan_thz_torch/csrc/dip_qualification.cu",
         "replaces": "pigan_thz_tpu/ops/peaks.py:306",
         "launches": dataset_k4 + k4_screen,
         "max_abs_err": k4_stats["max_abs_err"],
         "mask_mismatches": k4_stats["mask_mismatches"],
         "ms": k4_times["screen"][0],
         "plain_ms": k4_times["screen"][1],
         "plain_lifted_ms": k4_times["screen"][2]},
        {"name": "forward_train", "route": "cuda",
         "source": "pigan_thz_torch/csrc/forward_train.cu",
         "replaces": "pigan_thz_tpu/ops/megakernel.py:2623",
         "launches": k1_launches,
         "max_abs_err": k1_stats["max_abs_err"],
         "rows_max_rel_err": k1_stats["rows_rel"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "eager_ms": k1_eager_ms},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
