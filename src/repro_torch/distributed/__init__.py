"""The distributed layer (the port's twin of ``repro.distributed``):
atomic checkpoints and the resilient trainer loop (``checkpoint``,
``ft``) and the logical-axis sharding rules (``sharding``).  Pipeline
parallelism and elastic resharding (``pp``, ``elastic``) are not ported
yet (ROADMAP.md)."""
