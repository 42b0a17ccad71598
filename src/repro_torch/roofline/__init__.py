"""Roofline arithmetic (the port's twin of ``repro.roofline``).

* :mod:`~repro_torch.roofline.analysis`: a device :class:`Profile` (peak
  bf16 FLOP/s, HBM and link bytes/s, HBM per chip; the H100's by
  default), the analytic model FLOPs of an (arch x shape) cell and the
  compute / memory / collective terms of a :class:`RooflineRecord`;
* :mod:`~repro_torch.roofline.memory_ledger`: what lives in one chip's
  HBM for a cell (parameters, gradients, moments, caches, activations)
  and how many pods it needs;
* :mod:`~repro_torch.roofline.hlo_collectives`: the reference's
  collective accounting (ring wire-byte factors per kind and group
  size), fed by the collectives the port issues through
  ``torch.distributed`` (``record()``), since the port has no HLO.

Nothing here touches a device or a process group when imported.
"""
