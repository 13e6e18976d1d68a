"""Builds the port's CUDA kernels with nvcc at first use; loads them with ctypes.

The sources under ``pigan_thz_torch/csrc/`` have a plain C interface (no
PyTorch headers), so nvcc builds them in seconds: one nvcc per source, all
started together, then one link into a shared library.  It lands in
``build/kernels/<hash of sources and flags>/`` at the root of the checkout
(``build/`` is git-ignored); a later process with the same sources loads it
without building.  ``nvcc.log`` beside it keeps ptxas's register,
shared-memory and spill report.

No ``--use_fast_math``: tanhf, rsqrtf and the divisions stay IEEE so that
the kernels hold fp32 parity with their plain PyTorch versions.

``LAUNCHES`` counts each kernel's successful launches: ``launch``, which
the wrappers (``fused_kernels.py``, ``peaks.py``, ``brow.py``,
``products.py``) call, adds one a call; ``launch_loop``, through which the
training wrappers (``forward_train.py``, ``gan_train.py``) launch K1, K2 and
K3, also adds the product kernels their C loops enqueued, from the call's
``LoopReport``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_mlp_chain.cu", "fused_residual_chain.cu", "dip_qualification.cu",
           "forward_train.cu", "gan_train.cu")
# included by the training sources (brow_gemm.cuh by forward_train.cu and
# gan_train.cu) and the serving chains' (chain_common.cuh), each source with
# its own copy: everything in them is in an anonymous namespace
HEADERS = ("train_common.cuh", "brow_gemm.cuh", "chain_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libpigan_kernels.so"

# Successful kernel launches, by kernel; a key "<kernel>.<shape>" counts, of
# those, a kernel's launches in one of its launch shapes.  The last four are
# the product kernels of K1, K2 and K3: the batch-row kernel
# (csrc/brow_gemm.cuh) and the dispatch's kernels by route
# (csrc/train_common.cuh, ``products.ROUTES`` in that order), launched from
# the C loops or one at a time by ``brow.brow_gemm`` / ``products.product_gemm``.
LAUNCHES: dict[str, int] = {
    "fused_mlp_forward": 0,
    "fused_mlp_forward.wgmma": 0,   # of those, K5's launches in its wgmma shape
    "fused_dense_chain": 0,
    "fused_residual_chain": 0,
    "dip_qualification": 0,
    "forward_train": 0,
    "gan_train": 0,
    "gan_ensemble_train": 0,
    "brow_gemm": 0,
    "deep_narrow_gemm": 0,
    "batch_depth_gemm": 0,
    "sgemm": 0,
}


def launch_counts() -> dict[str, int]:
    """A copy of every count."""
    return dict(LAUNCHES)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_OFFSETS = ctypes.POINTER(ctypes.c_longlong)
_DIMS = ctypes.POINTER(ctypes.c_int)
_U32 = ctypes.c_uint32
_LL = ctypes.c_longlong

# C entry point -> argtypes; every one returns a cudaError_t as int.  The
# three training entry points take a LoopReport's 7 long longs before the
# stream.
ENTRY_POINTS = {
    "pigan_fused_mlp_forward": [_P, _P, _P, _OFFSETS, _OFFSETS, _DIMS, _I, _I, _I, _F, _F, _P],
    "pigan_fused_dense_chain": [_P, _P, _P, _OFFSETS, _OFFSETS, _DIMS, _I, _I, _I, _P],
    "pigan_fused_mlp_forward_wgmma": [
        _P, _P, _P, _P, _OFFSETS, _OFFSETS, _DIMS, _I, _I, _I, _F, _F, _P],
    "pigan_fused_chain_max_clusters": [_DIMS, _I, _I, _I, ctypes.POINTER(_I)],
    "pigan_fused_mlp_wgmma_max_clusters": [_DIMS, _I, _I, ctypes.POINTER(_I)],
    "pigan_fused_residual_chain": [_P, _P, _P, _P, _OFFSETS, _DIMS, _I, _U32, _I, _P],
    "pigan_dip_qualification": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "pigan_peak_metrics": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "pigan_forward_train": [
        _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_U32),
        _P, _P, ctypes.c_longlong, _DIMS, _I, _OFFSETS, _I, _I, _I,
        ctypes.POINTER(ctypes.c_double), _U32, _I, _OFFSETS, _P,
    ],
    "pigan_gan_train": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.POINTER(ctypes.c_float), _P, _P, ctypes.c_longlong, _DIMS, _DIMS, _I,
        _OFFSETS, _I, _I, ctypes.POINTER(ctypes.c_double), _I, _OFFSETS, _P,
    ],
    "pigan_gan_ensemble_train": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.POINTER(ctypes.c_float), _P, _P, ctypes.c_longlong, _DIMS, _DIMS, _I,
        _OFFSETS, _I, _I, ctypes.POINTER(ctypes.c_double), _I, _OFFSETS, _P,
    ],
    "pigan_brow_gemm": [
        _I, _I, _I, _I, _I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _I, _LL, _P, _LL,
        _I, _I, _P,
    ],
    "pigan_product_gemm": [
        _I, _I, _I, _I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _I, _LL, _P, _LL,
        _I, _I, _P,
    ],
}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on PATH"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the sources into ``build/kernels/<hash>/`` unless the library
    is there; returns its path."""
    out = BUILD_ROOT / source_hash() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in SOURCES:
            obj, log = (tmp / (Path(src).stem + ext) for ext in (".o", ".log"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((cmd, obj, log, proc))
        report, failed = [], []
        for cmd, _, log, proc in jobs:
            rc = proc.wait()
            report.append(log.read_text())
            if rc != 0:
                failed.append(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{report[-1]}")
        lib = tmp / LIB_NAME
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(lib), *(str(j[1]) for j in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            report.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{report[-1]}")
        (out.parent / "nvcc.log").write_text("".join(report))
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(lib, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pigan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pigan_cuda_error_string.restype = ctypes.c_char_p
    lib.pigan_product_route.argtypes = [_I, _I]
    lib.pigan_product_route.restype = ctypes.c_int
    lib.pigan_brow_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    lib.pigan_brow_plan.restype = ctypes.c_int
    return lib


@functools.cache
def check_capability(index: int) -> None:
    """The kernels are built for sm_90a only; refuse any other card."""
    import torch

    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); cuda:{index} is "
            f"sm_{cap[0]}{cap[1]}"
        )


def launch(name: str, device, *args, count_as: str | None = None) -> None:
    """Call entry point ``pigan_<name>`` with ``args`` and the current stream
    of ``device``; raise on a CUDA error, else count the launch in LAUNCHES
    under ``count_as`` (default ``name``): the metrics entry of K4 counts as
    ``dip_qualification``."""
    import torch

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"pigan_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} ({lib.pigan_cuda_error_string(rc).decode()})"
        )
    LAUNCHES[count_as or name] += 1


class LoopReport(NamedTuple):
    """What one call of a training C loop enqueued (``csrc/train_common.cuh``'s
    ``LoopReport``, field for field): its device kernels; of those, the
    batch-row products and the other products by route (``products.ROUTES``);
    the launches of its enqueue head (the first 512 or more, whole steps,
    before the card's launch queue can fill) and the host nanoseconds they
    took."""

    kernels: int
    brow: int
    deep_narrow: int
    batch_depth: int
    sgemm: int
    head_kernels: int
    head_ns: int


NO_REPORT = LoopReport(0, 0, 0, 0, 0, 0, 0)
_last_report = NO_REPORT


def launch_loop(name: str, device, *args) -> LoopReport:
    """``launch`` a training C loop with ``args`` and a report for it to fill;
    add the product kernels it enqueued to LAUNCHES, keep the report as this
    process's last (``report_of``) and return it."""
    global _last_report
    buf = (ctypes.c_longlong * len(LoopReport._fields))()
    launch(name, device, *args, buf)
    report = LoopReport(*buf)
    LAUNCHES["brow_gemm"] += report.brow
    LAUNCHES["deep_narrow_gemm"] += report.deep_narrow
    LAUNCHES["batch_depth_gemm"] += report.batch_depth
    LAUNCHES["sgemm"] += report.sgemm
    _last_report = report
    return report


def report_of(rows) -> LoopReport:
    """The report of the training launch that returned ``rows``: this
    process's last where ``rows`` are on the card and hold a step, else
    ``NO_REPORT`` (the plain version ran, or no step did: a report from
    before would be stale)."""
    return _last_report if rows.is_cuda and rows.shape[-2] else NO_REPORT


def span_attrs(report: LoopReport) -> dict[str, int]:
    """The ``pigan.train.launch`` span's attributes of a launch's report: its
    kernels, its enqueue head and its products by route."""
    return {"kernels": report.kernels, "head_kernels": report.head_kernels,
            "head_ns": report.head_ns, "deep_narrow": report.deep_narrow,
            "batch_depth": report.batch_depth, "sgemm": report.sgemm}
