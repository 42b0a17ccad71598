"""Mean milliseconds per batch of the loader: ``pipe.next_batch()`` and
the stub patchify, synchronized before and after, over the traced run's
span steps."""


def read(rec):
    spans = rec.get("spans")
    if rec["cell"]["source"] != "loader" or not spans:
        return None
    return 1e3 * sum(spans["loader_s"]) / len(spans["loader_s"])
