"""F's pretraining steps: their bound (operations at the TF32 peak, or the
batches and F's state once at the HBM rate) over the device time of every
kernel the F phase enqueued in its traced segment."""

from benchmark.costs import peaks, pigan


def read(run):
    t = run["trace"]
    seg = t and t["segments"].get("forward")
    if not seg or seg["busy_s"] <= 0:
        return None
    steps = run["record"]["traced_steps_per_phase"]
    cfg = run["cfg"]
    return peaks.share(pigan.forward_step_flops(cfg) * steps,
                       pigan.forward_phase_bytes(cfg, steps), seg["busy_s"])
