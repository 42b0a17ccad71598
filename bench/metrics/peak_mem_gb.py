"""The device's peak of allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), in GB of 10^9 bytes."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec.get("peak_bytes") else None
