"""The 95th percentile, over every step of the window, of the time from
the batch request to the synchronize that ends the step, loader wait
included (host clock; numpy's linear interpolation between the two
nearest steps)."""
import numpy as np


def read(rec):
    w = rec.get("window")
    if not w or not w["step_s"]:
        return None
    return float(np.percentile(np.asarray(w["step_s"]) * 1e3, 95))
