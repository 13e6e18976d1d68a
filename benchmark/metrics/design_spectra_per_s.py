"""Spectra inverted in the window (parameters, spectrum and metrics
returned and synchronised) over the window's host time."""


def read(run):
    rec = run["record"]
    if "rows" not in rec or rec["window_s"] <= 0:
        return None
    return rec["rows"] / rec["window_s"]
