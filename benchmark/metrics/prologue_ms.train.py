"""The host time a multi-epoch function spends before its launch: the
``pigan.train.draws`` and ``pigan.train.streams`` spans of the traced
segments (the chunk's shuffles and step seeds, then the gathered batches and
schedule lanes), their total over the count of ``pigan.train.launch`` spans.
Read from the program's own spans (``pigan_thz_torch.utils.profiling``),
which record only while the profiler runs: host time under the profiler."""


def read(run):
    if run["trace"] is None:
        return None
    try:
        from pigan_thz_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    parts = [spans.get(f"pigan.train.{name}") for name in ("draws", "streams")]
    launch = spans.get("pigan.train.launch")
    if None in parts or not launch or not launch["count"]:
        return None
    return sum(p["total_s"] for p in parts) / launch["count"] * 1e3
