"""One run of one cell: set-up, the measured window, the traced steps,
then the comparison with the reference that decides ``correct``.

Set-up builds the program's model from the benchmark's weights
(:mod:`bench.weights`), its AdamW with int8 moments, the train step of
``train.step.build_train_step`` (block remat) and the cell's source
(``bench/sources/<source>.py``), runs the source's fill epochs, then the checked
steps: the first steps of that same step object, fed by that same
source, whose losses, first moments and changes the reference follows.
The window then runs steps, each a batch request, the step, and a
synchronize, until ``seconds`` have passed.  With ``trace`` the window
runs plain steps for half the time, then steps with synchronized spans
around the calls into the loader, the step and the update, then two
steps under ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import cells, check, trace, weights
from bench.reference import train as ref_train

#: the benchmark's spans, as named in a trace
LABELS = ("loader", "step", "update")
#: steps under the profiler in a traced run
PROFILED_STEPS = 2
#: the program's launch counters (function attributes), by kernel
COUNTERS = {"k1": ("repro_torch.kernels.decode.kernel", "decode_augment"),
            "k4": ("repro_torch.kernels.flash_attention.kernel",
                   "flash_attention"),
            "k4_bwd": ("repro_torch.kernels.flash_attention.kernel",
                       "flash_attention_backward"),
            "k5": ("repro_torch.kernels.ssd_scan.kernel", "ssd_scan"),
            "k5_bwd": ("repro_torch.kernels.ssd_scan.kernel",
                       "ssd_scan_backward")}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall-clock time at which this process started."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def counters() -> Dict[str, int]:
    import importlib
    out = {}
    for key, (mod, fn) in COUNTERS.items():
        out[key] = getattr(getattr(importlib.import_module(mod), fn),
                           "launches", 0)
    return out


def nvidia_smi(query: str) -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def timed_adamw(base):
    """``base`` (the program's AdamW) with a synchronized span around
    ``update`` while :attr:`spans` is a list, and a profiler label while
    :attr:`label` is set."""
    class SpanAdamW(base):
        spans: Optional[List[float]] = None
        label = False

        def update(self, grads, state, params):
            ctx = torch.profiler.record_function("update") if self.label \
                else contextlib.nullcontext()
            with ctx:
                if self.spans is None:
                    return super().update(grads, state, params)
                sync()
                t0 = time.perf_counter()
                out = super().update(grads, state, params)
                sync()
                self.spans.append(time.perf_counter() - t0)
                return out
    return SpanAdamW


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Run:
    def __init__(self, cell: Dict, cfg: Dict, seed: int, device,
                 seconds: float, traced: bool):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.device = torch.device(device)
        self.seconds, self.traced = float(seconds), traced
        self.rng = np.random.default_rng(self.seed ^ 0x5CA1AB1E)
        self.specs = ref_train.family(cfg).param_specs(cfg)
        self.rec: Dict = {"cell": cell, "config": cfg,
                          "batch": cell["batch"]}
        self.served_rows: List = []     # (ids, labels, epoch) per step
        self.checked: List = []         # checked steps' batches (host)
        self.picked: List = []          # window rows: (emb rows, ids, epoch)
        self.n_steps = 0                # steps of the window

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.configs.base import ParallelismConfig
        from repro_torch.models.model import build
        from repro_torch.train.optimizer import AdamW
        from repro_torch.train.step import build_train_step
        cfg, cell = self.cfg, self.cell
        self.mcfg = cells.model_config(cfg)
        self.model = build(self.mcfg)
        weights.load(self.model, weights.make(self.specs, self.seed,
                                              self.device))
        self.opt = timed_adamw(AdamW)(lr=cell["lr"],
                                      state_dtype=cfg["opt_state_dtype"])
        self.step = build_train_step(self.model, ParallelismConfig(
            remat=cfg["remat"], opt_state_dtype=cfg["opt_state_dtype"]),
            self.opt)
        self.state = self.opt.init(self.model)
        self.source = cells.source(cell["source"]).Feed(
            cell, cfg, self.mcfg, self.seed, self.device)
        self.source.fill()
        losses = []
        for i in range(cell["checked_steps"]):
            batch, info = self.source.next()
            if info is not None:
                self.served_rows.append(info)
                self.checked.append((batch["patch_embeds"].cpu(), info))
            _, self.state, metrics = self.step(self.model, self.state, batch)
            losses.append(float(metrics["loss"]))
            if i == 0:
                m1 = self.first_moments()
                # copies: the step updates the moments in place
                codes = {k: (m.q.to("cpu", copy=True),
                             m.scale.to("cpu", copy=True))
                         for k, m in self.state.m.items()}
        self.readings = {"losses": losses, "m1": m1,
                         "change": self.changes(), "codes": codes}

    def first_moments(self) -> Dict[str, float]:
        out = {}
        for path, m in self.state.m.items():
            deq = m.q.to(torch.float32) * m.scale
            out[path] = float(torch.linalg.vector_norm(deq)) \
                / (1 - self.opt.b1)
        return out

    def changes(self) -> Dict[str, float]:
        """Each leaf's norm of its change since the weights were made,
        each group of weights made again to compare."""
        named = dict(self.model.named_parameters())
        sq: Dict[str, float] = {}
        for i, group in enumerate(weights.groups(self.specs)):
            p0 = weights.make_group(group, self.seed, i, self.device)
            for name, t in p0.items():
                d = named[name].detach().float() - t.float()
                path = ref_train.leaf_path(name)
                sq[path] = sq.get(path, 0.0) + float(torch.sum(d * d))
            del p0
        return {k: v ** 0.5 for k, v in sq.items()}

    # -- the window -----------------------------------------------------------
    def one_step(self, spans: Optional[Dict] = None, label: bool = False):
        """A batch request, the step and a synchronize; with ``spans``
        each call synchronized and timed."""
        def region(name):
            return torch.profiler.record_function(name) if label \
                else contextlib.nullcontext()
        if spans is not None:
            sync()
        t0 = time.perf_counter()
        with region("loader"):
            batch, info = self.source.next()
            if spans is not None:
                sync()
        t1 = time.perf_counter()
        with region("step"):
            _, self.state, _ = self.step(self.model, self.state, batch)
            sync()
        t2 = time.perf_counter()
        self.n_steps += 1
        if spans is not None:
            spans["loader_s"].append(t1 - t0)
            spans["step_call_s"].append(t2 - t1)
        if info is not None:
            self.served_rows.append(info)
            k = min(self.cell.get("rows_per_batch", 0), len(info[0]))
            slots = np.sort(self.rng.choice(len(info[0]), k, replace=False))
            idx = torch.from_numpy(slots).to(self.device)
            self.picked.append((batch["patch_embeds"].index_select(0, idx),
                                info[0][slots], info[2]))
        return t2 - t0

    def window(self) -> None:
        served0 = self.source.served()
        steps: List[float] = []
        sync()
        t_start = time.perf_counter()
        self.rec["setup_s"] = time.time() - self.t_process
        if not self.traced:
            while time.perf_counter() - t_start < self.seconds:
                steps.append(self.one_step())
            self.rec["window"] = {"step_s": steps,
                                  "seconds": time.perf_counter() - t_start}
        else:
            self.traced_window(t_start)
        self.rec["serves"] = {k: v - served0.get(k, 0)
                              for k, v in self.source.served().items()}
        self.rec["steps"] = self.n_steps
        self.rec["peak_bytes"] = torch.cuda.max_memory_allocated() \
            if self.device.type == "cuda" else 0

    def traced_window(self, t_start: float) -> None:
        plain: List[float] = []
        while not plain or time.perf_counter() - t_start < self.seconds / 2:
            plain.append(self.one_step())
        spans = {"loader_s": [], "step_call_s": []}
        self.opt.spans = []
        while len(spans["loader_s"]) < 2 \
                or time.perf_counter() - t_start < self.seconds:
            self.one_step(spans)
        spans["update_s"], self.opt.spans = self.opt.spans, None
        self.rec["plain"] = {"step_s": plain}
        self.rec["spans"] = spans
        self.profiled()

    def profiled(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        before, served = counters(), self.source.served()
        self.opt.label = True
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                self.one_step(label=True)
            t1 = time.perf_counter()
        self.opt.label = False
        after, served1 = counters(), self.source.served()
        tr = trace.read(prof, LABELS)
        # the host events' clock: the first and last host event in the
        # profiled steps bound the window the gaps are sought in
        steps_ev = [(s, e) for name, s, e in tr["host"] if name == "loader"
                    or name == "step"]
        lo = min(s for s, _ in steps_ev) if steps_ev else 0.0
        hi = max(e for _, e in steps_ev) if steps_ev else 0.0
        self.rec["profile"] = {
            "steps": PROFILED_STEPS, "kernels": tr["kernels"],
            "busy_s": tr["busy_s"], "window_s": t1 - t0,
            "launches": {k: after[k] - before[k] for k in after},
            "rows_decoded": sum(served1.get(k, 0) - served.get(k, 0)
                                for k in ("storage", "encoded")),
            "top_ops": trace.top_ops(tr["kernels"]),
            "idle_gaps": trace.idle_gaps(tr, (lo, hi)),
        }

    # -- the comparison -------------------------------------------------------
    def release(self) -> None:
        self.source.close()
        del self.model, self.state, self.step, self.opt, self.source
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, precision: str = "float32") -> Dict[str, float]:
        from bench.reference.plain import strict_float32
        strict_float32()
        batches, numbers = cells.source(self.cell["source"]).judge(
            self.cell, self.cfg, self.seed, self.device, self.checked,
            self.picked, self.served_rows)
        named0 = weights.make(self.specs, self.seed, self.device)
        ref = ref_train.follow(self.cfg, self.cell["lr"], named0, batches,
                               precision, self.cell.get("reference_rows", 1))
        self.ref_readings = ref
        numbers.update(check.training(self.readings, ref, self.device))
        return numbers


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device="cuda", t_process: Optional[float] = None,
        bench=cells.BENCH, man: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object, ``checks`` last, and
    the run itself under ``_run``."""
    cell = cells.load_cell(cell_name, bench)
    cfg = cells.load_config(cell["config"], bench)
    man = man if man is not None else cells.manifest()
    r = Run(cell, cfg, seed, device, seconds, traced)
    r.t_process = t_process if t_process is not None else time.time()
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        name_ = torch.cuda.get_device_name()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = nvidia_smi("clocks.max.sm")
        r.rec["sm_clocks"] = sms * float(mhz) * 1e6 if mhz else None
        r.rec["power_limit_w"] = nvidia_smi("power.limit")
    else:
        name_ = "cpu"
    r.setup()
    r.window()
    r.release()
    numbers = r.compare()
    limits = cell["limits"]
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cells.metrics_of(man, cell_name, kind):
        value = cells.metric_reader(m["name"], bench)(r.rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
              "kind": name_, "count": 1,
              "memory_peak_bytes": int(r.rec["peak_bytes"])}
    out = {"correct": check.verdict(numbers, limits),
           "attempted": r.rec["steps"], "failed": 0,
           "metrics": metrics, "device": device}
    if traced:
        prof = r.rec["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["top_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    r.numbers = numbers
    out["_run"] = r
    return out
