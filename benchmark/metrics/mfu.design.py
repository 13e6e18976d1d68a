"""The whole cycle's share of the card's peak: model FLOPs of the spectra
the traced run's window inverted outside its traced segment, over that part
of the window's host time, over 495 TFLOP/s."""

from benchmark.costs import peaks, pigan


def read(run):
    rec = run["record"]
    if run["trace"] is None or rec.get("free_s", 0) <= 0:
        return None
    rows = rec["free_requests"] * run["traffic"]["batch"]
    return 100.0 * pigan.design_flops(run["cfg"], rows) / rec["free_s"] / peaks.PEAK_FLOPS
