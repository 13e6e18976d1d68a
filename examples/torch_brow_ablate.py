"""Where a batch-row product's time goes: the kernel of ``csrc/brow_gemm.cuh``
rebuilt with one part changed or taken out at a time, on the card.

Each variant is the header with one edit (named below), compiled with
``gan_train.cu`` and the port's nvcc flags into its own library under
``build/kernels/brow_ablate/`` (all variants' nvcc started together) and
timed through its ``pigan_brow_gemm`` entry at three products of a K2 step:
G's first layer (64 x 512 x 250, two ring stages a block), F's fourth
(64 x 512 x 1024, eight) and D's first on [real; fake] (128 x 512 x 254),
fp32 operands, each in us a launch, 20 launches back to back in a CUDA graph
(median of 5 replays); then the base kernel at every cluster size.  Variants
that keep the arithmetic are checked against ``brow_gemm_plain``; the
others compute wrong numbers on purpose and are only timed.  Prints the
card's name and power limit and one JSON line.

    python examples/torch_brow_ablate.py                 # on the card
    python examples/torch_brow_ablate.py base bk32       # some variants
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch

from pigan_thz_torch.ops import _cuda_build, brow

from chip_smoke import card_line, graph_us  # noqa: E402  (the timing helpers)

COMPUTE = """      for (int kk = 0; kk < kBrowBK; ++kk) {
        float a[4], b[2];"""
LOAD_AHEAD = """    if (nx < nt) {
      brow_load<AK, BNC>"""
PROLOGUE = """    if (s < nt) {
      brow_load<AK, BNC>"""

# name -> (what it measures, [(text, replacement)], checked against plain)
VARIANTS = {
    "base": ("the kernel as it is", [], True),
    "bk32": ("32-column ring stages, 3 of them (half the barriers a column)",
             [("constexpr int kBrowBK = 16;", "constexpr int kBrowBK = 32;"),
              ("constexpr int kBrowStages = 4;", "constexpr int kBrowStages = 3;")], True),
    "stages2": ("a ring of 2 stages: one tile in flight while one is used",
                [("constexpr int kBrowStages = 4;", "constexpr int kBrowStages = 2;")], True),
    "stages6": ("a ring of 6 stages: 5 tiles in flight",
                [("constexpr int kBrowStages = 4;", "constexpr int kBrowStages = 6;")], True),
    "no_fma": ("the FMAs taken out: copies, barriers and the cluster sum alone",
               [(COMPUTE, "      for (int kk = 0; kk < 0; ++kk) {\n        float a[4], b[2];")],
               False),
    "no_copies": ("the tile copies taken out: FMAs on stale shared memory, barriers, sum",
                  [(LOAD_AHEAD, "    if (nx < 0) {\n      brow_load<AK, BNC>"),
                   (PROLOGUE, "    if (s < 0) {\n      brow_load<AK, BNC>")], False),
}
PRODUCTS = {"G layer 1": (64, 512, 250), "F layer 4": (64, 512, 1024),
            "D layer 1 [real; fake]": (128, 512, 254)}


def build_all(names) -> dict:
    """One library a variant, the nvcc runs started together."""
    out = _cuda_build.BUILD_ROOT / "brow_ablate"
    jobs = {}
    for name in names:
        _, edits, _ = VARIANTS[name]
        src = (_cuda_build.CSRC / "brow_gemm.cuh").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: the header no longer has {old!r}")
            src = src.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("gan_train.cu", "train_common.cuh"):
            shutil.copy(_cuda_build.CSRC / f, d / f)
        (d / "brow_gemm.cuh").write_text(src)
        so = d / "lib.so"
        cmd = [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / "gan_train.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.pigan_brow_gemm.argtypes = _cuda_build.ENTRY_POINTS["pigan_brow_gemm"]
        lib.pigan_brow_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_brow_ablate: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    libs = build_all(names)
    gen = torch.Generator(device=dev).manual_seed(0)
    operands = {}
    for label, (m, n, k) in PRODUCTS.items():
        a = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev)        # (out, in): B = W^T
        bias = torch.randn(n, generator=gen, device=dev)
        operands[label] = (a, w, bias, torch.empty((m, n), device=dev))

    def launcher(lib, label, split=0):
        a, w, bias, out = operands[label]
        (m, k), n = a.shape, w.shape[0]

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.pigan_brow_gemm(0, split, m, n, k, a.data_ptr(), k, 1, 0, w.data_ptr(),
                                     1, k, 0, out.data_ptr(), n, 0, bias.data_ptr(), 0, 1,
                                     1, stream)       # flags: AK
            if rc != 0:
                raise RuntimeError(f"{label}: CUDA error {rc}")
        return call

    result, failures = {"variants": {}, "splits": {}}, []
    for name in names:
        what, _, checked = VARIANTS[name]
        row = {"measures": what}
        for label in PRODUCTS:
            call = launcher(libs[name], label)
            row[label] = {"us": graph_us(call)}
            if checked:
                a, w, bias, out = operands[label]
                call()
                torch.cuda.synchronize()
                m, n, k = PRODUCTS[label]
                want = brow.brow_gemm_plain(a, w.t(), bias, split=brow.brow_plan(m, n, k).split)
                err = float((out - want).abs().max())
                row[label]["max_abs_err_vs_plain"] = err
                if not err <= 1e-4:    # same terms, same slices (except bk32's stages)
                    failures.append(f"{name} {label}: {err}")
        result["variants"][name] = row
        print(name, json.dumps(row), flush=True)
    base = libs.get("base")
    if base is not None:
        for label in PRODUCTS:
            result["splits"][label] = {s: graph_us(launcher(base, label, s))
                                       for s in (1, 2, 4, 8)}
        print("splits", json.dumps(result["splits"]), flush=True)
    print(f"card: {card}")
    print(json.dumps({**result, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
