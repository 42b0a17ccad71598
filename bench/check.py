"""The numbers that decide ``correct``, each against its limit.

Training: the program's readings of its first steps against the
reference's over the same weights and batches:

* ``loss_gap``: the largest gap, in nats, between a step's loss and the
  reference's, over the checked steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (its first moment after one step,
  decoded, over 1 - b1), over the larger of the reference's norm of that
  leaf and of the median leaf;
* ``change_gap``: the same for the norm of each leaf's change over the
  checked steps, over the leaves whose first gradient in the reference
  is at least a thousandth of the median leaf's (the others move by
  round-off alone);
* ``grad_dir_gap``: one less the cosine between the program's and the
  reference's first moments (decoded from their int8 codes), of the
  whole model.  Where the norms agree to rounding in a model whose bf16
  activations already round each element (mamba2-1.3b: a control in
  float8 moves them less than three times), the direction still
  separates the two.

A cell compares the numbers its file gives a limit (``limits``); the
others are printed as readings.

Loader cells: ``rows_bad``, the served rows (every row of the checked
steps, and rows drawn from the seed in every step of the window) whose
patch embedding equals no legitimate recomputation bit for bit;
``ids_bad``, ids outside the set, labels that are not the id's, and ids
served twice in one epoch.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

#: a leaf counts for ``change_gap`` where its first gradient's norm in
#: the reference is at least this share of the median leaf's
MOVED = 1e-3


def worst(values) -> float:
    """The largest of ``values``; infinite where one is not a number."""
    values = list(values)
    return float("inf") if any(v != v for v in values) else max(values)


def norm_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """Each leaf's gap between the two norms over the larger of the
    reference's norm of the leaf and of the median leaf."""
    floor = statistics.median(want[k] for k in want)
    return [abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in leaves]


def direction_gap(a: Dict, b: Dict, device) -> float:
    """One less the cosine between two first moments, each given as its
    codes ((int8 codes, scales) by leaf), over the whole model."""
    import torch
    dots, aa, bb = 0.0, 0.0, 0.0
    for k in sorted(a):
        x, y = ((c[k][0].to(device, torch.float64) * c[k][1].to(device))
                .reshape(-1) for c in (a, b))
        dots += float(torch.sum(x * y))
        aa += float(torch.sum(x * x))
        bb += float(torch.sum(y * y))
    return 1.0 - dots / max((aa * bb) ** 0.5, 1e-300)


def training(prog: Dict, ref: Dict, device="cpu") -> Dict[str, float]:
    """The training numbers from the program's readings ``prog``
    and the reference's ``ref`` (as :func:`bench.reference.train.follow`
    returns them)."""
    g1 = ref["grad1"]
    floor = statistics.median(g1.values())
    moved = [k for k in g1 if g1[k] >= MOVED * floor]
    losses = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"],
                                          strict=True)]
    grads = norm_gaps(prog["m1"], ref["m1"], sorted(ref["m1"]))
    changes = norm_gaps(prog["change"], ref["change"], moved)
    out = {"loss_gap": worst(losses), "grad_gap": worst(grads),
           "change_gap": worst(changes)}
    if "codes" in prog and "codes" in ref:
        out["grad_dir_gap"] = direction_gap(prog["codes"], ref["codes"],
                                            device)
    return out


def ids(batches, ds) -> int:
    """Faults among the served ids: ``batches`` of (ids, labels, epoch)."""
    bad, seen = 0, {}
    for sids, labels, epoch in batches:
        done = seen.setdefault(epoch, set())
        for sid, label in zip(sids.tolist(), labels.tolist()):
            bad += not (0 <= sid < ds.n) or label != ds.label(sid) \
                or sid in done
            done.add(sid)
    return bad


def verdict(numbers: Dict[str, float], limits: Dict) -> bool:
    """Every number that ``limits`` names within its limit (a limit not
    set yet fails)."""
    return all(limits[k] is not None and numbers[k] <= limits[k]
               for k in limits)
