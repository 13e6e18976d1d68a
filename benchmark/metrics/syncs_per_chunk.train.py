"""Device-to-host reads a Trainer chunk: the program's ``host_syncs``
counter (the chunk's transfer and each read of its finite check) over the
count of ``pigan.train.chunk`` spans, both recorded only while the profiler
runs (``pigan_thz_torch.utils.profiling``)."""


def read(run):
    if run["trace"] is None:
        return None
    try:
        from pigan_thz_torch.utils.profiling import HOST_SYNCS, snapshot
    except ImportError:
        return None
    snap = snapshot()
    chunk = snap["spans"].get("pigan.train.chunk")
    syncs = snap["counters"].get(HOST_SYNCS)
    if not chunk or not chunk["count"] or syncs is None:
        return None
    return syncs / chunk["count"]
