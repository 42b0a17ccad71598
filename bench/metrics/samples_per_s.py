"""Samples (images, or sequences) of the window's steps over the window's
seconds: from the window's start to the synchronize that ends its last
step, whole steps only (host clock)."""


def read(rec):
    w = rec.get("window")
    if not w or not w["step_s"]:
        return None
    return rec["batch"] * len(w["step_s"]) / w["seconds"]
