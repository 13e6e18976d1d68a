"""A designer stage's share of its roofline, shared by the stages' readers:
the stage's bound over the traced requests (from its shapes) over the
device time of the kernels launched inside its ``bench.<stage>_stage``
range."""

from benchmark.costs import peaks, pigan


def share(run, stage: str):
    t = run["trace"]
    device_s = t and t["ranges"].get(f"bench.{stage}_stage")
    if not device_s:
        return None
    traffic = run["traffic"]
    flops, nbytes = pigan.stage_costs(run["cfg"], traffic["batch"])[stage]
    n = traffic["trace_requests"]
    return peaks.share(flops * n, nbytes * n, device_s)
