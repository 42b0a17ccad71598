"""Public op: the SSD scan entry point.

``ssd(x, dt, A, Bm, Cm, chunk=...)`` is the reference's ``ssd`` with the
kernel always on: a CUDA tensor goes through K5, a CPU tensor through
its plain twin (the reference's ``use_kernel`` / ``interpret`` knobs
have no counterpart; the tensor's device decides).  Inputs are made
contiguous and ``dt``/``A`` float32, as the model passes them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128):
    return ssd_scan(x.contiguous(), dt.float().contiguous(),
                    A.float().contiguous(), Bm.to(x.dtype).contiguous(),
                    Cm.to(x.dtype).contiguous(), chunk=chunk)
