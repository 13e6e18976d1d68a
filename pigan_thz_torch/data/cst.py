"""Raw CST Studio export → reference CSV schema converter.

The port of ``pigan_thz_tpu/data/cst.py`` (numpy, copied), with two
changes: the metrics come from the port's ``ops.peaks.batched_peak_metrics``
on an explicit device (the dip-qualification kernel on the card), and the
CSV goes through the port's writer (``data.dataset.write_csv``), not pandas.

The reference's real dataset (`dataset/THz_Metamaterial_Spectra_With_Metrics
.csv`) is a missing large blob upstream, but the raw simulator export format
it was built from is documented by the reference's sample
`dataset/THZ.txt:1-4`:

    #Parameters = {d=500; p=50; phi=0; r1=40; r2=15; t=0.2; theta=0; w=2.5; ...}
    #"Frequency / THz"\t"S2,1 (3) [Magnitude / dB]"
    #---------------------------------------------
    0.50000000000000\t-2.2574566262793
    ...

i.e. one or more blocks of (geometry parameters, tab-separated
frequency/S21-magnitude rows).  This module parses that format and emits
the `Freq_*` CSV schema the framework (and the reference's
MetamaterialDataset) ingests:

- every `#Parameters = {...}` header starts a new sample block; `key=value`
  pairs are parsed permissively (spaces in keys allowed, e.g. "Mesh Pass");
- spectra are linearly resampled onto the target frequency grid
  (`DataConfig.frequencies`, 250 points over 0.5-3.0 THz by default) so
  exports with any sweep density produce a fixed-width CSV;
- the 8 physics metrics (f1,f2,Q1,FoM1,S1,Q2,FoM2,S2) are computed from
  each resampled spectrum with the scipy-parity peak analysis
  (`ops.peaks.batched_peak_metrics`); with no expected resonance centres
  available from a raw export, dips are the two deepest prominence-
  qualified minima and missing dips follow the reference NaN policy
  (NaN metrics → 0.5 after normalization, data_loader.py:203-219);
- the structural columns (r1, r2, w, g) are pulled from the parameter
  header by name; `param_map` renames (e.g. gap recorded as "p") and
  `defaults` fills keys the export does not sweep.

Raw CST geometry is in simulator units (µm) — when converting real
exports, set `data.param_min`/`data.param_max` to the true sweep range so
[-1,1] normalization is meaningful (the 2.2-2.8 defaults mirror the
reference's hardcoded ranges, data_loader.py:127-129).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import DataConfig, PARAM_NAMES

_PARAM_LINE = re.compile(r"^#\s*Parameters\s*=\s*\{(.*)\}\s*$")


@dataclass
class CstBlock:
    """One simulated sample: geometry parameters + its frequency sweep."""

    params: Dict[str, float]
    freq: np.ndarray       # (n,) THz, ascending
    values: np.ndarray     # (n,) S21 magnitude in dB


def parse_cst_export(path: str) -> List[CstBlock]:
    """Parse a raw CST text export into sample blocks.

    Tolerates CRLF, blank lines, repeated header/separator comment lines,
    and multiple concatenated parameter blocks (CST's "export all runs"
    layout).  Raises on a file with no data rows.
    """
    blocks: List[CstBlock] = []
    params: Dict[str, float] = {}
    fs: List[float] = []
    vs: List[float] = []

    def flush():
        nonlocal fs, vs
        if fs:
            f = np.asarray(fs, np.float64)
            v = np.asarray(vs, np.float64)
            order = np.argsort(f, kind="stable")
            blocks.append(
                CstBlock(params=dict(params), freq=f[order], values=v[order])
            )
            fs, vs = [], []

    with open(path, "r", encoding="utf-8-sig", errors="replace") as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            m = _PARAM_LINE.match(line)
            if m:
                flush()
                params = {}
                for part in m.group(1).split(";"):
                    if "=" not in part:
                        continue
                    k, _, val = part.partition("=")
                    try:
                        params[k.strip()] = float(val.strip())
                    except ValueError:
                        continue  # non-numeric parameter (names, units)
                continue
            if line.startswith("#"):
                continue  # column header / separator comments
            cols = line.replace(",", "\t").split()
            if len(cols) < 2:
                continue
            try:
                f, v = float(cols[0]), float(cols[1])
            except ValueError:
                continue  # stray non-numeric row
            fs.append(f)
            vs.append(v)
    flush()
    if not blocks:
        raise ValueError(f"no CST data blocks found in {path}")
    return blocks


def blocks_to_arrays(
    blocks: List[CstBlock],
    cfg: DataConfig,
    param_map: Optional[Dict[str, str]] = None,
    defaults: Optional[Dict[str, float]] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(params (B,4), spectra (B,S)) on the config's frequency grid.

    `param_map` maps the dataset's column name to the export's parameter
    key (e.g. {"g": "p"} when the gap was swept as "p"); `defaults`
    supplies values for keys absent from the export header.  A structural
    parameter found in neither raises with the block's available keys.
    """
    param_map = param_map or {}
    defaults = defaults or {}
    grid = cfg.frequencies.numpy().astype(np.float64)
    spectra = np.empty((len(blocks), grid.shape[0]), np.float32)
    params = np.empty((len(blocks), len(PARAM_NAMES)), np.float32)
    for b, blk in enumerate(blocks):
        # 1e-5 THz slack: the config grid is float32, the raw sweep float64
        if blk.freq[0] > grid[0] + 1e-5 or blk.freq[-1] < grid[-1] - 1e-5:
            # np.interp would silently clamp-extrapolate; make the sweep
            # mismatch loud instead
            raise ValueError(
                f"block {b}: sweep [{blk.freq[0]:.3f}, {blk.freq[-1]:.3f}] THz "
                f"does not cover the target grid "
                f"[{grid[0]:.3f}, {grid[-1]:.3f}] THz — re-export or adjust "
                "data.freq_min/freq_max"
            )
        spectra[b] = np.interp(grid, blk.freq, blk.values).astype(np.float32)
        for i, name in enumerate(PARAM_NAMES):
            key = param_map.get(name, name)
            if key in blk.params:
                params[b, i] = blk.params[key]
            elif name in defaults:
                params[b, i] = defaults[name]
            else:
                raise ValueError(
                    f"block {b}: structural parameter {name!r} (export key "
                    f"{key!r}) not in the export header "
                    f"{sorted(blk.params)} and no default given"
                )
    return params, spectra


def convert_cst_export(
    path: str,
    out_csv: str,
    cfg: Optional[DataConfig] = None,
    param_map: Optional[Dict[str, str]] = None,
    defaults: Optional[Dict[str, float]] = None,
    min_prominence: float = 1.0,
    fit_grid: bool = False,
    *,
    device: torch.device | str,
) -> int:
    """Convert a raw CST export file to the `Freq_*` CSV schema.

    Returns the number of samples written.  Metrics are derived from the
    resampled spectra on ``device`` with the scipy-parity peak analysis
    (deepest-two selection; NaN where a dip or its FWHM is missing — the
    loader's NaN→0.5 policy absorbs these exactly like the reference's).

    `fit_grid=True` derives the target grid from the export itself (the
    intersection of all blocks' sweeps, `cfg.spectrum_dim` points) instead
    of requiring the export to cover the configured 0.5-3.0 THz span —
    the in-repo reference sample sweeps only to 2.75 THz
    (`dataset/THZ.txt`); the emitted `Freq_*` labels carry the actual grid
    and `load_csv` adapts from the header."""
    from ..ops.peaks import batched_peak_metrics
    from .dataset import write_csv

    cfg = cfg or DataConfig()
    blocks = parse_cst_export(path)
    if fit_grid:
        lo = max(float(b.freq[0]) for b in blocks)
        hi = min(float(b.freq[-1]) for b in blocks)
        if hi <= lo:
            raise ValueError("blocks' sweeps do not overlap; cannot fit grid")
        cfg = DataConfig(**{**cfg.__dict__, "freq_min": lo, "freq_max": hi})
    params, spectra = blocks_to_arrays(blocks, cfg, param_map, defaults)
    metrics = batched_peak_metrics(
        cfg.frequencies, torch.from_numpy(spectra).to(device),
        min_prominence=min_prominence,
    )
    write_csv(out_csv, params, spectra, metrics, cfg.frequencies)
    return len(blocks)
