"""Mean milliseconds of the step's loss and gradients: the synchronized
train-step call less its synchronized update, over the traced run's span
steps."""


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans.get("update_s"):
        return None
    rest = [s - u for s, u in zip(spans["step_call_s"], spans["update_s"])]
    return 1e3 * sum(rest) / len(rest)
