"""Public op: the SSD scan entry point.

``ssd(x, dt, A, Bm, Cm, chunk=...)`` is the reference's ``ssd`` with the
kernel always on: a CUDA tensor goes through K5, a CPU tensor through
its plain twin (the reference's ``use_kernel`` / ``interpret`` knobs
have no counterpart; the tensor's device decides).  Inputs are made
contiguous and ``dt``/``A`` float32, as the model passes them.  The
call goes through :class:`SsdScan`, so gradients flow through K5's
backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import SsdScan


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128):
    return SsdScan.apply(x.contiguous(), dt.float().contiguous(),
                         A.float().contiguous(), Bm.to(x.dtype).contiguous(),
                         Cm.to(x.dtype).contiguous(), chunk)
