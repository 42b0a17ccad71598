"""Reading a ``torch.profiler`` trace of a few steps: each device
operation's time and count by name, the seconds in which the device ran
anything, the operations that took most time, and the longest idle
gaps, each named by what the host was doing then (the benchmark's own
span around the call into the layer, and the innermost host operation
open at the gap's start).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments and parameters."""
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = re.sub(r"\(.*$", "", "".join(out)).replace("void ", "").strip()
    return s[:width]


def union(spans: List[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def read(prof, labels: Tuple[str, ...]) -> Dict:
    """``kernels``: {name: [microseconds, count]} of every device
    operation; ``busy_s``: the union of their intervals; ``first_us`` and
    ``last_us`` their extent; ``host``: the host events (name, start,
    end), for :func:`idle_gaps`."""
    from torch.autograd import DeviceType
    kernels: Dict[str, List[float]] = {}
    dev: List[Interval] = []
    host = []
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in labels:
                continue          # a span's annotation, not an operation
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += hi - lo
            k[1] += 1
            dev.append((lo, hi))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, lo, hi))
    busy = union(dev)
    return {"kernels": kernels,
            "busy_s": sum(hi - lo for lo, hi in busy) / 1e6,
            "busy": busy, "host": host, "labels": labels}


def top_ops(kernels: Dict[str, List[float]], n: int = 10):
    """The ``n`` device operations that took most time: [name, s]."""
    by: Dict[str, float] = {}
    for name, (us, _count) in kernels.items():
        by[short(name)] = by.get(short(name), 0.0) + us / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Dict, window: Interval, n: int = 10):
    """The ``n`` longest stretches of ``window`` (host microseconds) in
    which the device ran nothing: [what the host was doing, s]."""
    lo, hi = window
    gaps, reach = [], lo
    for a, b in tr["busy"]:
        if a > reach:
            gaps.append((reach, min(a, hi)))
        reach = max(reach, b)
    if reach < hi:
        gaps.append((reach, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        at = [(name, s, e) for name, s, e in tr["host"] if s <= a < e]
        span = [x for x in at if x[0] in tr["labels"]]
        inner = min(at, key=lambda x: x[2] - x[1])[0] if at else "none"
        what = (span[0][0] + ": " if span else "") + inner
        out.append([what[:120], (b - a) / 1e6])
    return out
