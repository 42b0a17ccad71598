"""``"source": "loader"``: the program's own loader feeds the step.

A ``SenecaServer`` over the cell's synthetic image set with the cell's
``server`` settings, one session of ``batch`` samples, the device
executor, each batch through the stub patchify
(``launch.train.patch_batch``); ``fill_epochs`` epochs run through the
loader alone in set-up.  The reference recomputes every row it judges
from the image's id (:mod:`bench.reference.images`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import check
from bench.reference import images


class Feed:
    """The program's loader over the cell's image set."""

    def __init__(self, cell: Dict, cfg: Dict, model_cfg, seed: int,
                 device):
        from repro_torch.api import SenecaServer
        from repro_torch.data import synthetic
        from repro_torch.data.pipeline import DSIPipeline
        from repro_torch.data.storage import RemoteStorage
        from repro_torch.launch.train import patch_batch
        ds_spec = cell["dataset"]
        self.ds = getattr(synthetic, ds_spec["kind"])(n=ds_spec["n"])
        kw = dict(cell["server"])
        kw["hbm_split"] = tuple(kw["hbm_split"])
        kw["device_cache_bytes"] = int(kw["device_cache_bytes"])
        self.server = SenecaServer.for_dataset(self.ds, seed=seed,
                                               device=device, **kw)
        self.session = self.server.open_session(batch_size=cell["batch"])
        self.pipe = DSIPipeline(self.session, RemoteStorage(self.ds),
                                executor="device", seed=seed)
        self.cell, self.model_cfg = cell, model_cfg
        self._patch = patch_batch

    def next(self):
        """(the step's batch, (ids, labels, epoch) of its rows)."""
        raw = self.pipe.next_batch()
        batch = self._patch(raw, self.model_cfg)
        return batch, (raw["ids"], raw["labels"], self.session.epoch)

    def fill(self) -> None:
        n = -(-self.ds.n_samples // self.cell["batch"])
        for _ in range(self.cell.get("fill_epochs", 0) * n):
            self.pipe.next_batch()

    def served(self) -> Dict[str, int]:
        """Lookups so far by the tier that answered (``storage``: a
        fetch)."""
        return dict(self.server.stats()["telemetry"]["serve_counts"])

    def close(self) -> None:
        self.pipe.stop()
        self.server.close()


def dataset(cell: Dict) -> images.Dataset:
    spec = cell["dataset"]
    return images.DATASETS[spec["kind"]](n=spec["n"])


def batch_of(ds, sids, rows: List[torch.Tensor], cfg: Dict,
             device) -> Dict:
    return {"patch_embeds": torch.stack(rows).to(device),
            "labels": torch.tensor([ds.label(int(s)) % cfg["n_classes"]
                                    for s in sids], device=device)}


def control_batches(cell: Dict, cfg: Dict, seed: int,
                    device) -> List[Dict]:
    """The first rows that the seed draws from the image set, recomputed
    as the reference recomputes the loader's rows (the control stands in
    for the whole program, loader included)."""
    ds, n, b = dataset(cell), cell["checked_steps"], cell["batch"]
    ids = np.random.default_rng(seed).choice(ds.n, n * b, replace=False)
    out = []
    for i in range(n):
        sids = ids[i * b:(i + 1) * b]
        rows = [next(images.row_candidates(ds, int(s), 0,
                                           cfg["frontend_tokens"],
                                           cfg["d_model"])) for s in sids]
        out.append(batch_of(ds, sids, rows, cfg, device))
    return out


def judge(cell: Dict, cfg: Dict, seed: int, device, checked: List,
          picked: List, served: List) -> Tuple[List[Dict], Dict]:
    """The reference's batches of the checked steps, each served row
    recomputed from its id (``checked``: (embeddings, (ids, labels,
    epoch)) a step), and the numbers on the served data: ``rows_bad``
    over those rows and the window's ``picked`` ones ((embeddings, ids,
    epoch) a step), ``ids_bad`` over every step's ids (``served``)."""
    ds = dataset(cell)
    bad, out = 0, []
    for emb, (sids, _labels, epoch) in checked:
        rows = [images.match_row(ds, int(s), epoch, got)
                for s, got in zip(sids, emb)]
        bad += sum(not ok for ok, _ in rows)
        out.append(batch_of(ds, sids, [r for _, r in rows], cfg, device))
    for emb, sids, epoch in picked:
        for got, sid in zip(emb.cpu(), sids):
            bad += not images.match_row(ds, int(sid), epoch, got)[0]
    return out, {"rows_bad": bad, "ids_bad": check.ids(served, ds)}
