from .dataset import (
    ThzDataset,
    build_dataset,
    denormalize_metrics,
    denormalize_params,
    metric_ranges_from_data,
    normalize_metrics,
    normalize_params,
    normalize_spectrum,
)
from .synthetic import dip_centers, sample_params, synthesize_spectra

__all__ = [
    "ThzDataset",
    "build_dataset",
    "denormalize_metrics",
    "denormalize_params",
    "dip_centers",
    "metric_ranges_from_data",
    "normalize_metrics",
    "normalize_params",
    "normalize_spectrum",
    "sample_params",
    "synthesize_spectra",
]
