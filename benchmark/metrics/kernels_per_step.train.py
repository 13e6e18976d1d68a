"""Device kernels in the traced segments over the optimiser steps they
completed (member-steps)."""


def read(run):
    t, rec = run["trace"], run["record"]
    if t is None or not t["segments"]:
        return None
    steps = rec["traced_steps_per_phase"] * rec.get("members", 1) * len(t["segments"])
    return t["kernels"] / steps if steps else None
