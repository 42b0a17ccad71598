"""Data plane of the port: datasets, storage, augmentation, pipeline."""
