"""Set-up: from the process's start to the first timed operation, the
kernel library's load (and, on a checkout's first run, its build), the
inputs, the weights and the warm-up included."""


def read(run):
    return run["setup_s"]
