"""The serving call's host time from the call until it returns, before the
synchronise, averaged over the requests of the traced run's window outside
its traced segment (the tracer slows every host call inside it); their sum
spans seconds, far above the host clock's error."""


def read(run):
    rec = run["record"]
    if run["trace"] is None or not rec.get("free_requests"):
        return None
    return rec["free_enqueue_s"] / rec["free_requests"] * 1e3
