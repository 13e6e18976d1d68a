"""The dip-qualification kernel of pigan_thz_torch, K4, timed on the card.

At B = 8192, N = 250: the four-output entry (``batched_dip_qualification``)
on each spectra class of ``chip_smoke.py`` (synthetic, random walk, white
noise, quantized) and on the screen's spectra (K5 on random candidates);
``batched_peak_metrics`` (the metrics) on the screen's spectra without
centres, as the screen calls it, and on the synthetic ones with per-row
centres, as dataset generation does; five fused screening chunks under
``torch.profiler`` (kernels, kernel time and idle share a chunk); and the wall
time of the 1e6-candidate screen, fused (K5) and with the module
surrogate, twice each.  Seeded full-width F, flax's initialisation.
``--root`` imports the package from another checkout (an unpacked ``git
archive`` of a parent commit, say), so two versions can be timed in turns
within one call: run it for parent, change, change, parent.

``--ablate`` (this checkout only) rebuilds ``csrc/dip_qualification.cu``
with one part changed at a time: the walks sample by sample (``serial``,
the parent kernel's walks in this kernel's layout), the walk inlined at its
four calls (``inline_walk``), and, timed only, the kernel stopped after the
row's load (``load_only``), after the local maxima (``no_measures``) and
without the half-height walks (``no_width_walks``).  It times each
variant's four-output entry on each class and its metrics entry on the
screen's spectra, the checked variants' masks and metrics held bit for bit
against the built kernel's.  Prints the card's name and power limit and, last, one JSON
line.

    python examples/torch_k4_times.py
    python examples/torch_k4_times.py --root build/parent
    python examples/torch_k4_times.py --ablate --no-screens
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import (  # noqa: E402  (the timing helpers and the spectra)
    card_line, cuda_median_ms, phase30_chunk_profile, run_screen, screen_spectra,
    spectra_classes)

WALKS = "  const bool blocks = !__any_sync(kFull, has_nan);"
WALK = "__device__ __noinline__ int walk("
CLASSIFY = "  // Plateau-aware local maxima, 32 candidates a step."
MEASURE = "  // The peaks' measures, 32 peaks a step, each lane walking its own."
WIDTH = ("  const int jl = walk<-1, false>(", "  const int jr = walk<1, false>(")
# variant -> (the source's edits, whether its outputs are checked); the
# unchecked ones stop early on purpose and are only timed
ABLATE = {
    "kernel": ([], True),
    "serial": ([(WALKS, "  const bool blocks = false;")], True),
    "inline_walk": ([(WALK, "__device__ __forceinline__ int walk(")], True),
    "load_only": ([(CLASSIFY, "  if (n > 0) return;\n" + CLASSIFY)], False),
    "no_measures": ([(MEASURE, "  if (n > 0) return;\n" + MEASURE)], False),
    "no_width_walks": ([(WIDTH[0], "  const int jl = i - 1, jr = i + 1;\n"
                                   "  if (n < 0) walk<-1, false>("),
                        (WIDTH[1], "  if (n < 0) walk<1, false>(")], False),
}


def ablate_build(name: str, edits):
    """The kernel source with the edits, built alone into
    ``build/kernels/ablate/``; the loaded library."""
    from pigan_thz_torch.ops import _cuda_build

    src = (_cuda_build.CSRC / "dip_qualification.cu").read_text()
    for old in (WALKS, WALK, CLASSIFY, MEASURE, *WIDTH):
        if old not in src:
            raise RuntimeError(f"the source no longer has {old!r}")
    for old, new in edits:
        src = src.replace(old, new)
    out = _cuda_build.BUILD_ROOT / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"k4_{name}.cu", out / f"k4_{name}.so"
    cu.write_text(src)
    cmd = [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for entry in ("pigan_dip_qualification", "pigan_peak_metrics"):
        getattr(lib, entry).argtypes = _cuda_build.ENTRY_POINTS[entry]
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def ablate(inputs: dict, freq, reps: int) -> tuple:
    """Each variant's times; the failures of its checks."""
    import torch
    from pigan_thz_torch.ops import peaks as pk

    stream = torch.cuda.current_stream().cuda_stream
    result, failures = {}, []
    for name, (edits, checked) in ABLATE.items():
        lib = ablate_build(name, edits)
        row = {}
        for cls, t in inputs.items():
            b, n = t.shape
            want = pk.batched_dip_qualification(t)
            out = pk.DipQualification(*(torch.empty_like(f) for f in want))

            def call(t=t, out=out, b=b, n=n):
                rc = lib.pigan_dip_qualification(t.data_ptr(), *(o.data_ptr() for o in out),
                                                 b, n, 1.0, 1.0, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if checked and not all(torch.equal(a, w) for a, w in zip(out, want)):
                failures.append(f"{name} {cls}: the four outputs differ from the kernel's")
            row[cls] = cuda_median_ms(call, warmup=3, reps=reps)
        t = inputs["screen"]
        b, n = t.shape
        met = torch.empty((b, 8), device=t.device)

        def metrics():
            rc = lib.pigan_peak_metrics(t.data_ptr(), freq.data_ptr(), None, None,
                                        met.data_ptr(), b, n, 1.0, 1.0, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        metrics()
        torch.cuda.synchronize()
        want = pk.batched_peak_metrics(freq, t)
        if checked and not (torch.equal(met.isnan(), want.isnan())
                            and torch.equal(met.nan_to_num(), want.nan_to_num())):
            failures.append(f"{name}: the metrics differ from the kernel's")
        row["metrics screen"] = cuda_median_ms(metrics, warmup=3, reps=reps)
        result[name] = row
        print(f"ablate {name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()),
              flush=True)
    return result, failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-screens", action="store_true",
                    help="skip the two 1e6-candidate screens")
    ap.add_argument("--ablate", action="store_true",
                    help="time the kernel rebuilt with other blocks for its walks")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import pigan_thz_torch
    if not os.path.abspath(pigan_thz_torch.__file__).startswith(root + os.sep):
        print(f"torch_k4_times: FAIL: imported {pigan_thz_torch.__file__}, "
              f"not the package under {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_k4_times: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    if a.ablate and root != os.path.dirname(HERE):
        print("torch_k4_times: FAIL: --ablate rebuilds this checkout's kernel only",
              file=sys.stderr)
        return 1
    from pigan_thz_torch import default_config
    from pigan_thz_torch.data import dip_centers, sample_params, synthesize_spectra
    from pigan_thz_torch.models import build_forward_model
    from pigan_thz_torch.ops import fused_kernels as fk
    from pigan_thz_torch.ops import peaks as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    cfg = default_config()
    tag = f"[{card}]"
    gen = torch.Generator().manual_seed(0)
    F = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim,
                            device=dev, generator=gen).eval()
    dgen = torch.Generator(device=dev).manual_seed(0)
    inputs = spectra_classes(dgen, a.batch, cfg, dev)
    inputs["screen"] = screen_spectra(dgen, a.batch, dev, fk.pack_forward_model(F, dev))
    freq = cfg.data.frequencies.to(dev)
    result = {"root": root, "card": card, "batch": a.batch, "k4_ms": {}, "metrics_ms": {}}
    for cls, t in inputs.items():
        ms = cuda_median_ms(pk.batched_dip_qualification, t, warmup=5, reps=a.reps)
        result["k4_ms"][cls] = ms
        print(f"K4 four-output entry, {cls} spectra: {ms:.4f} ms (CUDA-event median of "
              f"{a.reps})", flush=True)

    p = sample_params(dgen, a.batch, cfg.data, device=dev)
    synthetic = synthesize_spectra(freq, p, dgen, cfg.data.noise_level)
    for label, t, centres in (("screen", inputs["screen"], (None, None)),
                              ("synthetic with centres", synthetic, dip_centers(p))):
        ms = cuda_median_ms(lambda: pk.batched_peak_metrics(freq, t, *centres), warmup=5,
                            reps=a.reps)
        result["metrics_ms"][label] = ms
        print(f"batched_peak_metrics, {label}: {ms:.4f} ms (CUDA-event median of "
              f"{a.reps})", flush=True)

    result["chunk_profile"] = phase30_chunk_profile(F, cfg, dev, tag)

    if not a.no_screens:
        lo = torch.full((4,), cfg.data.param_min, device=dev)
        hi = torch.full((4,), cfg.data.param_max, device=dev)
        result["screen_s"] = {}
        for use_pallas in (True, False):
            label = "fused" if use_pallas else "module"
            walls = [run_screen(F, cfg, dev, lo, hi, use_pallas)[1] for _ in range(2)]
            result["screen_s"][label] = walls
            print(f"1e6 screen, {label} surrogate: {walls[0]:.4f} s and {walls[1]:.4f} s "
                  f"wall (first and second run)", flush=True)

    failures = []
    if a.ablate:
        result["ablate"], failures = ablate(inputs, freq, a.reps)
        result["ablate_failures"] = failures
    print(json.dumps(result))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
