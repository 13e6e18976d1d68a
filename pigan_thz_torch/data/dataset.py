"""Device-resident dataset and de/normalization for THz metamaterial data.

The pure functions and ``ThzDataset`` of ``pigan_thz_tpu/data/dataset.py``,
on torch tensors.  Reference behaviour (file:line under the reference repo):
- params normalized to [0,1] via hardcoded ranges then to [-1,1] for the GAN
  (data_loader.py:185-194);
- metrics min-max normalized to [0,1] with per-column ranges computed from the
  *valid* (non-NaN) entries, then NaN -> 0.5 (data_loader.py:198-219);
- denormalize_params maps [-1,1] -> physical (data_loader.py:238-252);
- denormalize_metrics maps [0,1] -> physical with NaN -> 0.0
  (data_loader.py:255-293);
- normalize_spectrum min-max -> [0,1], clamped (data_loader.py:298-329);
- CSV schema: `Freq_x.xx` spectrum columns auto-discovered and sorted by
  frequency, param columns r1,r2,w,g, metric columns f1..S2
  (data_loader.py:135-176).

The whole dataset (1000 x 250 floats, about 1 MB) lives as tensors on one
device, named explicitly by the caller.

The CSV reader and writer use the ``csv`` module and numpy, not pandas, and
read and write what the JAX package's pandas path does: float32 values in
their shortest round-trip form, NaN as an empty field, pandas' default NA
spellings read as NaN, blank lines skipped.  The native C++ loader and
its ``.thzb`` cache are ``data/native_io.py``.
"""

from __future__ import annotations

import csv
import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import DataConfig, METRIC_NAMES, PARAM_NAMES
from .synthetic import SyntheticBatch, generate_dataset

# ---------------------------------------------------------------------------
# Pure normalization functions
# ---------------------------------------------------------------------------


def normalize_params(
    params: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """Physical -> [-1, 1] (data_loader.py:185-194)."""
    span = hi - lo
    ok = span > 1e-6
    unit = torch.where(ok, (params - lo) / torch.where(ok, span, 1.0), 0.5)
    return unit * 2.0 - 1.0


def denormalize_params(
    params_norm: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """[-1, 1] -> physical (data_loader.py:238-252)."""
    unit = (params_norm + 1.0) / 2.0
    return unit * (hi - lo) + lo


def metric_ranges_from_data(
    metrics: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column (min, max) over non-NaN entries; (0, 1) if all-NaN
    (data_loader.py:200-211)."""
    valid = ~torch.isnan(metrics)
    any_valid = valid.any(dim=0)
    lo = torch.where(valid, metrics, torch.inf).amin(dim=0)
    hi = torch.where(valid, metrics, -torch.inf).amax(dim=0)
    lo = torch.where(any_valid, lo, 0.0)
    hi = torch.where(any_valid, hi, 1.0)
    return lo, hi


def normalize_metrics(
    metrics: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """Physical -> [0, 1]; zero-span columns -> 0.5; NaN -> 0.5
    (data_loader.py:213-219)."""
    span = hi - lo
    ok = span > 1e-6
    unit = torch.where(ok, (metrics - lo) / torch.where(ok, span, 1.0), 0.5)
    return torch.where(torch.isnan(unit), 0.5, unit)


def denormalize_metrics(
    metrics_norm: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """[0, 1] -> physical; zero-span -> lo; NaN -> 0.0 (data_loader.py:255-293)."""
    span = hi - lo
    out = torch.where(span > 1e-6, metrics_norm * span + lo, lo)
    return torch.where(torch.isnan(out), 0.0, out)


def normalize_spectrum(
    spectrum: torch.Tensor,
    global_min: float | torch.Tensor | None = None,
    global_max: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Min-max -> [0,1] clamped (data_loader.py:298-329)."""
    lo = spectrum.min() if global_min is None else torch.as_tensor(global_min)
    hi = spectrum.max() if global_max is None else torch.as_tensor(global_max)
    lo = lo.to(spectrum.device, spectrum.dtype)
    hi = hi.to(spectrum.device, spectrum.dtype)
    span = hi - lo
    ok = span > 1e-8
    out = torch.where(ok, (spectrum - lo) / torch.where(ok, span, 1.0), 0.5)
    return out.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Device-resident dataset
# ---------------------------------------------------------------------------


class ThzDataset(NamedTuple):
    """All tensors on one device.

    Mirrors the 5-tuple yielded by MetamaterialDataset.__getitem__
    (data_loader.py:227-234) plus the normalization statistics that the
    reference keeps as Python dict attributes (param_ranges, metric_ranges).
    """

    spectra: torch.Tensor        # (N, S) raw dB spectra
    params: torch.Tensor         # (N, 4) physical units
    params_norm: torch.Tensor    # (N, 4) in [-1, 1]
    metrics: torch.Tensor        # (N, 8) physical units (may contain NaN)
    metrics_norm: torch.Tensor   # (N, 8) in [0, 1], NaN -> 0.5
    param_lo: torch.Tensor       # (4,)
    param_hi: torch.Tensor       # (4,)
    metric_lo: torch.Tensor      # (8,)
    metric_hi: torch.Tensor      # (8,)
    frequencies: torch.Tensor    # (S,)

    @property
    def num_samples(self) -> int:
        return self.spectra.shape[0]

    @property
    def spectrum_dim(self) -> int:
        return self.spectra.shape[1]


def build_dataset(
    spectra,
    params,
    metrics,
    cfg: DataConfig,
    frequencies=None,
    *,
    device: torch.device | str,
) -> ThzDataset:
    """Normalise raw arrays (tensors or numpy) into a ``ThzDataset`` whose
    tensors all lie on ``device``.  ``frequencies`` overrides the config
    linspace (a CSV's actual Freq_* header values)."""

    def f32(a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
        return a.to(device=device, dtype=torch.float32)

    lo = torch.full((cfg.param_dim,), cfg.param_min, dtype=torch.float32, device=device)
    hi = torch.full((cfg.param_dim,), cfg.param_max, dtype=torch.float32, device=device)
    spectra, params, metrics = f32(spectra), f32(params), f32(metrics)
    mlo, mhi = metric_ranges_from_data(metrics)
    freq = f32(frequencies if frequencies is not None else cfg.frequencies)
    return ThzDataset(
        spectra=spectra,
        params=params,
        params_norm=normalize_params(params, lo, hi),
        metrics=metrics,
        metrics_norm=normalize_metrics(metrics, mlo, mhi),
        param_lo=lo,
        param_hi=hi,
        metric_lo=mlo,
        metric_hi=mhi,
        frequencies=freq,
    )


def synthetic_dataset(
    cfg: DataConfig,
    generator: torch.Generator | None = None,
    *,
    device: torch.device | str,
) -> ThzDataset:
    """Generate ``cfg.num_samples`` samples on ``device`` (from a generator
    seeded with ``cfg.seed`` unless one is given), then normalise."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    raw: SyntheticBatch = generate_dataset(generator, cfg.num_samples, cfg, device=device)
    return build_dataset(raw.spectra, raw.params, raw.metrics, cfg, device=device)


# ---------------------------------------------------------------------------
# CSV interop (host-side; the reference schema)
# ---------------------------------------------------------------------------

# pandas.read_csv's default NA spellings: these fields read as NaN.
_NA_FIELDS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def discover_spectrum_schema(header) -> tuple:
    """Freq_* column discovery + required-column validation, shared by the
    loader and the metadata-only loader.  Returns (sorted spec_cols,
    frequencies float32 array)."""
    cols = list(header)
    spec_cols = [
        c for c in cols
        if c.startswith("Freq_")
        and c.split("_", 1)[1].replace(".", "", 1).isdigit()
    ]
    if not spec_cols:
        raise ValueError("no 'Freq_*' spectrum columns found in CSV")
    spec_cols = sorted(spec_cols, key=lambda c: float(c.split("_", 1)[1]))
    present = set(cols)
    missing = [c for c in (*PARAM_NAMES, *METRIC_NAMES) if c not in present]
    if missing:
        raise ValueError(f"CSV missing required columns: {missing}")
    freqs = np.array([float(c.split("_", 1)[1]) for c in spec_cols], np.float32)
    return spec_cols, freqs


def _spectrum_columns(freqs: np.ndarray) -> list[str]:
    """Reference format is 2 decimals (data_loader.py:135); raise precision
    automatically when a finer grid would produce duplicate labels."""
    for decimals in range(2, 8):
        cols = [f"Freq_{f:.{decimals}f}" for f in freqs]
        if len(set(cols)) == len(cols):
            return cols
    raise ValueError("cannot produce unique Freq_* labels for this grid")


def _field(text: str) -> float:
    text = text.strip()
    return np.nan if text in _NA_FIELDS else float(text)


def _read_table(path: str) -> tuple[list[str], np.ndarray]:
    """(header, float64 (rows, cols) values) of a CSV file.  Blank lines
    are skipped; a short row is filled with NaN; a long one raises."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"dataset not found: {path}")
    with open(path, newline="", encoding="utf-8-sig") as fh:
        reader = csv.reader(fh)
        header = next(reader, [])
        width = len(header)
        values = []
        for row in reader:
            if len(row) <= 1 and not "".join(row).strip():
                continue
            if len(row) > width:
                raise ValueError(
                    f"{path}: line {reader.line_num} has {len(row)} fields, "
                    f"the header {width}"
                )
            values.append([_field(f) for f in row] + [np.nan] * (width - len(row)))
    return header, np.array(values, np.float64).reshape(len(values), width)


def load_csv(path: str, cfg: DataConfig, *, device: torch.device | str) -> ThzDataset:
    """Load the reference CSV schema (data_loader.py:149-181) onto ``device``.

    Spectrum columns are auto-discovered by the `Freq_` prefix and sorted by
    their numeric frequency; param/metric columns are required by name."""
    header, table = _read_table(path)
    spec_cols, freqs = discover_spectrum_schema(header)

    def columns(names):   # the first column of a name, as pandas reads it
        return table[:, [header.index(c) for c in names]].astype(np.float32)

    return build_dataset(
        columns(spec_cols), columns(PARAM_NAMES), columns(METRIC_NAMES), cfg,
        frequencies=freqs, device=device,
    )


def write_csv(path: str, params, spectra, metrics, frequencies) -> None:
    """Write (B, 4) params, (B, S) spectra and (B, 8) metrics (arrays or
    tensors) in the reference CSV schema, labelled by ``frequencies``."""
    arrays = [
        np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)
        for a in (params, spectra, metrics, frequencies)
    ]
    table = np.concatenate(arrays[:3], axis=1)
    text = table.astype(str)          # shortest float32 round-trip form
    text[np.isnan(table)] = ""
    header = [*PARAM_NAMES, *_spectrum_columns(arrays[3]), *METRIC_NAMES]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(text.tolist())


def save_csv(ds: ThzDataset, path: str) -> None:
    """Write a dataset in the reference CSV schema (round-trips load_csv)."""
    write_csv(path, ds.params, ds.spectra, ds.metrics, ds.frequencies)


class ThzMetadata(NamedTuple):
    """Dataset metadata without the data (the reference's
    ``MetamaterialDataset(load_data=False)``, data_loader.py:116-122).
    From a CSV only the header is parsed."""

    frequencies: np.ndarray      # (S,)
    param_names: tuple
    metric_names: tuple
    spectrum_dim: int
    num_samples: int | None      # None when no CSV was given


def load_metadata(cfg: DataConfig, csv_path: str | None = None) -> ThzMetadata:
    """Metadata-only load.  With a CSV path: read the header, discover and
    sort the Freq_* columns, validate the required columns, count the data
    rows without parsing a float.  Without: everything from the config."""
    if csv_path:
        if not os.path.exists(csv_path):
            raise FileNotFoundError(f"dataset not found: {csv_path}")
        # utf-8-sig + csv.reader: BOM'd and quoted headers parse as the
        # loader sees them (Excel writes both)
        with open(csv_path, "r", newline="", encoding="utf-8-sig") as fh:
            reader = csv.reader(fh)
            header = [c.strip() for c in next(reader, [])]
            # quoted fields with embedded newlines count as one row
            n_rows = sum(1 for row in reader if any(c.strip() for c in row))
        spec_cols, freqs = discover_spectrum_schema(header)
        return ThzMetadata(
            frequencies=freqs,
            param_names=tuple(PARAM_NAMES),
            metric_names=tuple(METRIC_NAMES),
            spectrum_dim=len(spec_cols),
            num_samples=n_rows,
        )
    return ThzMetadata(
        frequencies=cfg.frequencies.numpy(),
        param_names=tuple(PARAM_NAMES),
        metric_names=tuple(METRIC_NAMES),
        spectrum_dim=cfg.spectrum_dim,
        num_samples=None,
    )


def load_or_synthesize(
    cfg: DataConfig, csv_path: str | None = None, *, device: torch.device | str
) -> ThzDataset:
    """The CSV if it exists (reference workflow), else a synthetic dataset
    (the CSV is a missing large blob in the reference repo)."""
    if csv_path and os.path.exists(csv_path):
        return load_csv(csv_path, cfg, device=device)
    return synthetic_dataset(cfg, device=device)


def split_dataset(
    ds: ThzDataset, val_frac: float = 0.2, generator: torch.Generator | None = None
) -> tuple[ThzDataset, ThzDataset]:
    """Shuffled (train, validation) split.  The permutation comes from
    ``generator`` (a CPU generator; seed 0 when None).  Normalisation
    statistics stay those of the full dataset, so both splits share one
    scale."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n = ds.num_samples
    n_val = max(1, int(round(n * val_frac)))
    perm = torch.randperm(n, generator=generator).to(ds.spectra.device)
    val_idx, train_idx = perm[:n_val], perm[n_val:]

    def take(idx):
        return ds._replace(
            spectra=ds.spectra[idx],
            params=ds.params[idx],
            params_norm=ds.params_norm[idx],
            metrics=ds.metrics[idx],
            metrics_norm=ds.metrics_norm[idx],
        )

    return take(train_idx), take(val_idx)


# ---------------------------------------------------------------------------
# Batching (index-shuffled)
# ---------------------------------------------------------------------------


def epoch_indices(
    generator: torch.Generator, num_samples: int, batch_size: int
) -> torch.Tensor:
    """(steps, batch) int64 index matrix of one shuffled epoch, on the CPU,
    with steps = max(1, N // B).  As in the JAX package, the last N mod B
    samples of the permutation sit the epoch out, and a dataset smaller than
    one batch repeats its permutation (tiled) to fill the batch, so every
    step has the full batch shape."""
    steps = max(1, num_samples // batch_size)
    perm = torch.randperm(num_samples, generator=generator)
    needed = steps * batch_size
    if needed > num_samples:
        perm = perm.repeat(-(-needed // num_samples))
    return perm[:needed].reshape(steps, batch_size)


def gather_batch(ds: ThzDataset, idx: torch.Tensor):
    """One minibatch (spectra, params, params_norm, metrics, metrics_norm)
    at the indices ``idx`` (on the dataset's device)."""
    return (
        ds.spectra[idx],
        ds.params[idx],
        ds.params_norm[idx],
        ds.metrics[idx],
        ds.metrics_norm[idx],
    )
