"""The host time of the designer's F stage (K5) from its call to its
return, the mean over the ``pigan.serve.fwd_stage`` spans of the traced
requests.  Read from the program's own spans
(``pigan_thz_torch.utils.profiling``), which record only while the
profiler runs: host time under the profiler."""


def read(run):
    if run["trace"] is None:
        return None
    try:
        from pigan_thz_torch.utils.profiling import snapshot
    except ImportError:
        return None
    stage = snapshot()["spans"].get("pigan.serve.fwd_stage")
    if not stage or not stage["count"]:
        return None
    return stage["total_s"] / stage["count"] * 1e3
