"""Training: AdamW with tiered moment state and the train step
(the port's twin of ``repro.train``; gradient compression and the
data-parallel shard belong to the distributed layer, not ported yet)."""
