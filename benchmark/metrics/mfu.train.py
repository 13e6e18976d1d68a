"""The whole step's share of the card's peak: model FLOPs of the steps the
traced run's window completed outside its traced segments, over that part
of the window's host time, over 495 TFLOP/s."""

from benchmark.costs import peaks, pigan


def read(run):
    rec, cfg = run["record"], run["cfg"]
    if run["trace"] is None or rec.get("free_s", 0) <= 0:
        return None
    flops = (rec.get("free_fwd_steps", 0) * pigan.forward_step_flops(cfg)
             + rec["free_gan_steps"] * rec.get("members", 1) * pigan.gan_step_flops(cfg))
    return 100.0 * flops / rec["free_s"] / peaks.PEAK_FLOPS
