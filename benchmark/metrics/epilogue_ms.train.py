"""The Trainer's host time after a chunk's one transfer: the finite check
(``pigan.train.check``, the mean over its spans) and the per-epoch
bookkeeping (``pigan.train.record``'s self time: the records, plateau,
checkpoint offer and log, the mean over its spans), the transfer's wait on
the device left out.  Read from the program's own spans
(``pigan_thz_torch.utils.profiling``), which record only while the profiler
runs: host time under the profiler."""


def read(run):
    if run["trace"] is None:
        return None
    try:
        from pigan_thz_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    check, record = spans.get("pigan.train.check"), spans.get("pigan.train.record")
    if not check or not record or not check["count"] or not record["count"]:
        return None
    return (check["total_s"] / check["count"] + record["self_s"] / record["count"]) * 1e3
