"""Crop + flip + normalize: the K2 kernel and its host-seeded ops."""
