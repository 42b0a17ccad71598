"""The reference's training steps: plain float32 forward and backward of
a configuration's model (``bench/reference/<family>.py``) over the same
weights and batches as the program, then :class:`AdamW8`.

Parameters are kept by leaf path (``blocks/attn/wq``: the layers of a
block parameter stacked along a first axis; ``embed/tok``), as the
optimizer's moments are.  A batch is run in blocks of ``rows`` examples
whose summed losses over the batch's example count add up to the
batch's mean loss, so a full-size step fits the card.
"""
from __future__ import annotations

import importlib
import re
from typing import Dict, List

import torch

from bench.reference.adamw import AdamW8
from bench.reference.plain import PRECISIONS

F32 = torch.float32


def family(cfg: Dict):
    return importlib.import_module(f"bench.reference.{cfg['family']}")


def leaf_path(name: str) -> str:
    """``blocks.3.attn.wq`` -> ``blocks/attn/wq``; ``embed.tok`` ->
    ``embed/tok``."""
    return re.sub(r"^blocks\.\d+\.", "blocks.", name).replace(".", "/")


def stack(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Parameters by leaf path, float32, the layers of a block parameter
    stacked in layer order."""
    groups: Dict[str, List] = {}
    for name, t in named.items():
        m = re.match(r"^blocks\.(\d+)\.", name)
        groups.setdefault(leaf_path(name), []).append(
            (int(m.group(1)) if m else -1, t))
    out = {}
    for path, items in sorted(groups.items()):
        items.sort(key=lambda it: it[0])
        if items[0][0] < 0:
            out[path] = items[0][1].to(F32).clone()
        else:
            out[path] = torch.stack([t.to(F32) for _, t in items])
    return out


def split(batch: Dict, rows: int) -> List[Dict]:
    n = next(iter(batch.values())).shape[0]
    return [{k: v[i:i + rows] for k, v in batch.items()}
            for i in range(0, n, rows)]


def loss_and_grads(P: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
                   mm, rows: int):
    fam = family(cfg)
    total = fam.count(batch)
    for p in P.values():
        p.grad = None
        p.requires_grad_(True)
    loss = 0.0
    for part in split(batch, rows):
        part_loss = fam.loss_sum(P, cfg, part, mm) / total
        part_loss.backward()
        loss += float(part_loss.detach())
    grads = {k: p.grad for k, p in P.items()}
    for p in P.values():
        p.requires_grad_(False)
        p.grad = None
    return loss, grads


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.to(F32)))
            for k, t in tensors.items()}


def follow(cfg: Dict, lr: float, named0: Dict[str, torch.Tensor],
           batches: List[Dict], precision: str = "float32",
           rows: int = 1) -> Dict:
    """The reference's steps from the weights ``named0`` over
    ``batches``: each step's loss, the norm of each leaf's first
    gradient (``grad1``) and of its first moment after one step decoded
    and divided by ``1 - b1`` (``m1``), that moment's codes on the host
    (``codes``: (int8 codes, scales) by leaf), the norm of each leaf's
    change after the last step (``change``)."""
    mm = PRECISIONS[precision]
    P = stack(named0)
    P0 = {k: v.clone() for k, v in P.items()}
    opt = AdamW8(lr)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        loss, grads = loss_and_grads(P, cfg, batch, mm, rows)
        out["losses"].append(loss)
        if i == 0:
            out["grad1"] = norms(grads)
        opt.step(P, grads)
        del grads
        if i == 0:
            out["m1"] = {k: float(torch.linalg.vector_norm(
                opt.first_moment(k, p.shape))) / (1 - opt.b1)
                for k, p in P.items()}
            out["codes"] = {k: (q.cpu(), s.cpu())
                            for k, (q, s) in opt.m.items()}
    out["change"] = {k: float(torch.linalg.vector_norm(P[k] - P0[k]))
                     for k in P}
    return out
