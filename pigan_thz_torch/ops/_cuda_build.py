"""Builds the port's CUDA kernels with nvcc at first use; loads them with ctypes.

The sources under ``pigan_thz_torch/csrc/`` have a plain C interface (no
PyTorch headers), so one nvcc call builds a shared library in seconds.  It
lands in ``build/kernels/<hash of sources and flags>/`` at the root of the
checkout (``build/`` is git-ignored); a later process with the same sources
loads it without building.  ``nvcc.log`` beside it keeps ptxas's register,
shared-memory and spill report.

No ``--use_fast_math``: tanhf, rsqrtf and the divisions stay IEEE so that
the kernels hold fp32 parity with their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_mlp_chain.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libpigan_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_OFFSETS = ctypes.POINTER(ctypes.c_longlong)
_DIMS = ctypes.POINTER(ctypes.c_int)

# C entry point -> argtypes; every one returns a cudaError_t as int.
ENTRY_POINTS = {
    "pigan_fused_mlp_forward": [_P, _P, _P, _OFFSETS, _DIMS, _I, _I, _F, _F, _P],
    "pigan_fused_dense_chain": [_P, _P, _P, _OFFSETS, _DIMS, _I, _I, _P],
}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
    return lib
