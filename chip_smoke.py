#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (pigan_thz_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's serving slice, the inverse-design cycle on the baseline
MLP trio at full published width, through the hand-written CUDA kernels:

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
   plain versions at B = 64 and B = 8192.

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
import time

K5_TOL = 1e-4   # (B, 258) surrogate output; tests/test_pallas.py:43
K6_TOL = 2e-5   # (B, 4) generator output; tests/test_pallas.py:101
# Cycle against the modules' unfused forward: fp32 on both sides, other
# summation order (cuBLAS vs the kernels' sequential FMAs) and BatchNorm
# folded on one side only.
CYCLE_TOL = 1e-4
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pigan_thz_torch import default_config
        from pigan_thz_torch.data import build_dataset, sample_params, synthesize_spectra
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
    ds_n = 64
    p = sample_params(dgen, ds_n, cfg.data, device=dev)
    ds = build_dataset(
        synthesize_spectra(cfg.data.frequencies, p, dgen, cfg.data.noise_level), p,
        torch.full((ds_n, cfg.data.metrics_dim), float("nan")), cfg.data, device=dev,
    )
    print("dataset: metrics NaN-filled (serving reads only param_lo, param_hi and "
          "spectrum_dim; synthetic metrics need the peaks kernel, not ported yet)")
    fn = make_inverse_design_fn(G, F, ds)

    for name in fk.LAUNCHES:
        fk.LAUNCHES[name] = 0
    answers = {}
    for b in REQUEST_BATCHES:
        before = dict(fk.LAUNCHES)
        answers[b] = fn(requests[b])
        torch.cuda.synchronize()
        for name, n in fk.LAUNCHES.items():
            if n - before[name] != 1:
                fail(f"request B={b} advanced {name} by {n - before[name]}, not 1")
    launches = dict(fk.LAUNCHES)
    print(f"slice: launches over {len(REQUEST_BATCHES)} requests: {launches}")
    for name, n in launches.items():
        if n != len(REQUEST_BATCHES):
            fail(f"{name} launched {n} times for {len(REQUEST_BATCHES)} requests")

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

    big = max(TIME_BATCHES)   # the times in the record are at B = 8192
    record = {"kernels": [
        {"name": "fused_mlp_forward", "route": "cuda",
         "source": "pigan_thz_torch/csrc/fused_mlp_chain.cu",
         "replaces": "pigan_thz_tpu/ops/pallas_kernels.py:73",
         "launches": launches["fused_mlp_forward"],
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
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
