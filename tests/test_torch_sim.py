"""The port's simulator (``repro_torch.sim.desim``, ``repro_torch.baselines``)
against the reference's: the checks of ``tests/test_sim.py`` on the port,
and equal results for the same specs and seed.

The simulator is numpy on both sides over the same MDP, ODS and
performance-model code, so equal means equal: every field of
:class:`SimResult` is compared exactly, with no tolerance.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sim import desim as ref_desim  # noqa: E402
from repro_torch import api, baselines  # noqa: E402
from repro_torch.core.perf_model import (AZURE_NC96, GB,  # noqa: E402
                                         DatasetProfile, JobProfile,
                                         dsi_throughput)
from repro_torch.sim.desim import (ALL_LOADERS, DSISimulator,  # noqa: E402
                                   LoaderSpec, MDP_ONLY, MINIO, PYTORCH,
                                   QUIVER, SENECA, SimJob)

DS = DatasetProfile("openimages-tiny", 60_000, 315.84e3)


def _run(spec, jobs=2, epochs=2, cache=12 * GB, seed=0):
    sim = DSISimulator(AZURE_NC96, DS, spec, cache_bytes=cache, seed=seed)
    return sim.run([SimJob(j, gpu_rate=3500, batch_size=512, epochs=epochs)
                    for j in range(jobs)]), sim


def test_seneca_beats_all_baselines():
    results = {s.name: _run(s)[0].throughput
               for s in (PYTORCH, MINIO, QUIVER, SENECA)}
    assert results["seneca"] >= results["minio"], results
    assert results["seneca"] >= results["pytorch"], results
    assert results["seneca"] >= results["quiver"] * 0.95, results


def test_seneca_makespan_reduction_vs_pytorch():
    r_pt, _ = _run(PYTORCH)
    r_se, _ = _run(SENECA)
    assert 1 - r_se.makespan / r_pt.makespan > 0.25


def test_mdp_only_beats_static_encoded():
    r_minio, _ = _run(MINIO)
    r_mdp, _ = _run(MDP_ONLY)
    assert r_mdp.throughput >= r_minio.throughput


def test_epoch_times_monotone_warmup():
    r, _ = _run(SENECA, epochs=3)
    for j in r.first_epoch_s:
        assert r.first_epoch_s[j] >= 0.8 * r.stable_epoch_s[j]


def test_model_sim_correlation_quick():
    splits = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
              (0.5, 0.5, 0.0), (0.0, 0.5, 0.5)]
    model_v, sim_v = [], []
    for sp in splits:
        spec = LoaderSpec(f"fixed{sp}", split_override=sp,
                          cache_forms=("encoded", "decoded", "augmented"),
                          sampling="random", evict_refcount=False)
        r, _ = _run(spec, jobs=1, epochs=2)
        sim_v.append(r.throughput)
        model_v.append(float(dsi_throughput(
            AZURE_NC96, DatasetProfile(DS.name, DS.n_total, DS.s_data),
            JobProfile(), *sp).overall))
    corr = np.corrcoef(model_v, sim_v)[0, 1]
    assert corr > 0.8, (corr, model_v, sim_v)


def test_preprocess_sharing_reduces_ops():
    r_pt, _ = _run(PYTORCH, jobs=4, epochs=1)
    r_se, _ = _run(SENECA, jobs=4, epochs=1)
    assert r_se.preprocess_ops < r_pt.preprocess_ops


def test_reexports_are_the_simulator():
    assert api.DSISimulator is DSISimulator
    assert api.SimJob is SimJob and api.LoaderSpec is LoaderSpec
    assert baselines.ALL_LOADERS is ALL_LOADERS
    assert [s.name for s in ALL_LOADERS] == \
        [s.name for s in ref_desim.ALL_LOADERS]
    for mine, ref in zip(ALL_LOADERS, ref_desim.ALL_LOADERS):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", [s.name for s in ALL_LOADERS])
def test_results_equal_reference(name):
    """Same spec, hardware, dataset, jobs and seed: every field of the
    port's SimResult equals the reference's exactly."""
    spec = next(s for s in ALL_LOADERS if s.name == name)
    ref_spec = next(s for s in ref_desim.ALL_LOADERS if s.name == name)
    ds = DatasetProfile("openimages-tiny", 20_000, 315.84e3)
    jobs = [dict(job_id=j, gpu_rate=3500 - 1000 * j, batch_size=256,
                 epochs=2) for j in range(2)]
    mine = DSISimulator(AZURE_NC96, ds, spec, cache_bytes=4 * GB,
                        seed=3).run([SimJob(**j) for j in jobs])
    ref = ref_desim.DSISimulator(AZURE_NC96, ds, ref_spec,
                                 cache_bytes=4 * GB, seed=3).run(
        [ref_desim.SimJob(**j) for j in jobs])
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
