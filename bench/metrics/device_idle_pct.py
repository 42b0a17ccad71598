"""The share of a plain step in which the device runs nothing: one less
the device's busy seconds per profiled step (``torch.profiler``, the
union of every device operation's interval) over the mean wall seconds
of the traced run's plain steps (host clock, no profiler, no spans)."""


def read(rec):
    prof, plain = rec.get("profile"), rec.get("plain")
    if not prof or not plain or not prof["busy_s"]:
        return None
    busy = prof["busy_s"] / prof["steps"]
    wall = sum(plain["step_s"]) / len(plain["step_s"])
    return 100.0 * (1.0 - busy / wall)
