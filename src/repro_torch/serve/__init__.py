"""Serving of the port: batched decode with KV caches (:mod:`.step`)."""
