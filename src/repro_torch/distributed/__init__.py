"""The distributed layer (the port's twin of ``repro.distributed``):
atomic checkpoints and the resilient trainer loop (``checkpoint``,
``ft``), the logical-axis sharding rules (``sharding``), GPipe-style
pipeline parallelism over a ``pipe`` mesh axis, forward only (``pp``),
and re-meshing and resharding when the rank count changes
(``elastic``)."""
