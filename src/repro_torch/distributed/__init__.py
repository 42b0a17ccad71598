"""Fault tolerance for training: atomic checkpoints and the resilient
trainer loop (the port's twin of ``repro.distributed.{checkpoint,ft}``;
the mesh, sharding and pipeline modules are not ported yet)."""
