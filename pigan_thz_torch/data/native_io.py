"""Native host IO: the C++ CSV parser and the binary ``.thzb`` cache.

The port of ``pigan_thz_tpu/data/native_io.py``.  The extension is the
repo's shared host-IO source, ``native/thzio.cpp`` (an mmap'd,
multi-threaded CSV float parser and a raw float32 cache: magic, shape,
little-endian data).  It is built with ``g++`` at first use into
``build/native/`` at the root of the checkout (``build/`` is git-ignored),
beside and apart from the JAX package's own build, and loaded as a Python
extension.  A ``.thzb`` written by either package loads in the other.

Without a toolchain every entry point falls back, and says so once on
stderr: CSVs are read by ``dataset.py``'s parser, and the cache is a
``<path>.npy`` file, as in the JAX package.  This is host IO; the dataset
lands on the requested device either way.

- ``load_csv_native(path, cfg, device=...)`` -> ``ThzDataset`` (as ``load_csv``)
- ``cache_dataset(ds, path)`` / ``load_cached(path, cfg, device=...)``
- ``native_available()`` -> bool
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile

import numpy as np

from ..config import METRIC_NAMES, PARAM_NAMES, DataConfig

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "thzio.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")

_module = None
_build_error: str | None = None


def _so_path() -> str:
    return os.path.join(BUILD_DIR, "thzio" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))


def _build() -> str:
    """Compile the extension unless a build newer than the source is there;
    returns the .so path.  The build goes to a temporary file that is
    renamed into place, so concurrent processes never load half a file."""
    so = _so_path()
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.partial")
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load():
    """The extension module, or None (the reason in ``build_error()``)."""
    global _module, _build_error
    if _module is not None or _build_error is not None:
        return _module
    try:
        if not os.path.exists(_SRC):
            raise FileNotFoundError(_SRC)
        spec = importlib.util.spec_from_file_location("thzio", _build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    except (OSError, ImportError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        _build_error = f"{type(e).__name__}: {detail.strip()[-300:]}"
        print(f"native IO: the C++ extension is unavailable ({_build_error}); "
              "using the Python fallback", file=sys.stderr)
    return _module


def native_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the extension is unavailable, or None."""
    _load()
    return _build_error


def parse_csv(path: str) -> tuple[list[str], np.ndarray]:
    """(header, float32 (rows, cols) array) by the native parser, else by
    ``dataset.py``'s."""
    mod = _load()
    if mod is not None:
        return mod.parse_csv(path)
    from .dataset import _read_table

    header, table = _read_table(path)
    return header, table.astype(np.float32)


def load_csv_native(path: str, cfg: DataConfig, *, device):
    """``dataset.load_csv`` through the native parser: the same column
    discovery and validation, the dataset on ``device``."""
    from .dataset import build_dataset, discover_spectrum_schema

    if not os.path.exists(path):
        raise FileNotFoundError(f"dataset not found: {path}")
    header, data = parse_csv(path)
    spec_cols, freqs = discover_spectrum_schema(header)

    def columns(names):   # the first column of a name, as load_csv takes it
        return data[:, [header.index(c) for c in names]]

    return build_dataset(columns(spec_cols), columns(PARAM_NAMES), columns(METRIC_NAMES),
                         cfg, frequencies=freqs, device=device)


# ---------------------------------------------------------------------------
# Binary cache (.thzb): [spectra | params | metrics] stacked column-wise
# ---------------------------------------------------------------------------


def cache_dataset(ds, path: str) -> None:
    """Write ``ds``'s raw spectra, params and metrics as one float32 block:
    a ``.thzb`` by the extension, else ``<path>.npy``."""
    block = np.concatenate([t.detach().cpu().numpy() for t in (ds.spectra, ds.params,
                                                                ds.metrics)],
                           axis=1).astype(np.float32)
    mod = _load()
    if mod is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        mod.write_cache(path, block)
    else:
        np.save(path + ".npy", block)


def load_cached(path: str, cfg: DataConfig, *, device):
    """The dataset of a cache written by ``cache_dataset`` (of either
    package), on ``device``; ``cfg.spectrum_dim`` splits the block."""
    from .dataset import build_dataset

    mod = _load()
    if mod is not None and os.path.exists(path):
        block = mod.read_cache(path)
    elif os.path.exists(path + ".npy"):
        block = np.load(path + ".npy")
    elif os.path.exists(path):
        raise RuntimeError(
            f"native cache {path} exists but the C++ extension is unavailable here "
            f"({build_error()}); build it or cache the dataset again on this machine")
    else:
        raise FileNotFoundError(path)
    s, p = cfg.spectrum_dim, cfg.param_dim
    return build_dataset(block[:, :s], block[:, s: s + p], block[:, s + p:], cfg,
                         device=device)
