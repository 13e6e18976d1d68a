"""The host time of the training C loop a device kernel it enqueues, before
the card's launch queue fills: over the ``pigan.train.launch`` spans of the
traced segments, the host nanoseconds of each C loop's enqueue head (its
first 512 or more launches, whole steps, from an idle card) over the
launches in those heads (the spans' ``head_ns`` and ``head_kernels``).  The
rest of a launch runs at the card's pace once the queue is full, so the
span's whole length would read the card, not the enqueue.  Read from the
program's own spans (``pigan_thz_torch.utils.profiling``), which record only
while the profiler runs: host time under the profiler."""


def read(run):
    if run["trace"] is None:
        return None
    try:
        from pigan_thz_torch.utils.profiling import snapshot
    except ImportError:
        return None
    launch = snapshot()["spans"].get("pigan.train.launch")
    kernels = launch and launch["attrs"].get("head_kernels")
    if not kernels:
        return None
    return launch["attrs"]["head_ns"] / kernels * 1e-3
