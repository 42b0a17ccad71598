"""Mean milliseconds of the optimizer's update (``AdamW.update``), a
synchronized span around the call, over the traced run's span steps."""


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans.get("update_s"):
        return None
    return 1e3 * sum(spans["update_s"]) / len(spans["update_s"])
