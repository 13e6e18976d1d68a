"""The D-then-G steps, counted per member-step: their bound over the device
time of every kernel the GAN phase enqueued in its traced segment."""

from benchmark.costs import peaks, pigan


def read(run):
    t = run["trace"]
    seg = t and (t["segments"].get("pigan") or t["segments"].get("ensemble"))
    if not seg or seg["busy_s"] <= 0:
        return None
    rec, cfg = run["record"], run["cfg"]
    steps, members = rec["traced_steps_per_phase"], rec.get("members", 1)
    return peaks.share(pigan.gan_step_flops(cfg) * steps * members,
                       pigan.gan_phase_bytes(cfg, steps, members), seg["busy_s"])
