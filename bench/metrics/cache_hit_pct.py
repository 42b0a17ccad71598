"""The share of the window's served samples that the cache answered (any
tier, any form), from the server's per-tier serve counters; the rest were
storage fetches."""


def read(rec):
    serves = rec.get("serves")
    if rec["cell"]["source"] != "loader" or not serves:
        return None
    total = sum(serves.values())
    if not total:
        return None
    return 100.0 * (total - serves.get("storage", 0)) / total
