"""Seconds from the process's start to the window's start: imports,
weights, the source's fill, the checked steps, and in a checkout's first
run the kernels' build (host clock)."""


def read(rec):
    return rec.get("setup_s")
