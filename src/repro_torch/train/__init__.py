"""Training: AdamW with tiered moment state, the train step, and the
explicit-collective data-parallel step with int8 error-feedback gradient
compression (the port's twin of ``repro.train``)."""
