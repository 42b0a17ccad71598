"""A kernel's share of its roofline in a traced run: the least time the
card could take for the kernel's launches in the profiled steps
(``bench/yardstick.py``), over the device time the profiler saw them
take.  A launch of several passes takes the sum of each pass's mean time
per launch; where the profiler saw fewer launches than the program's
counter made, the time seen is scaled to the counted launches."""
from __future__ import annotations

from typing import Callable, Dict, Optional


def kernel_times(rec: Dict, match: Callable[[str], bool]):
    """{name: [microseconds, launches seen]} of the matching kernels."""
    prof = rec.get("profile") or {}
    return {k: v for k, v in prof.get("kernels", {}).items() if match(k)}


def share(rec: Dict, match: Callable[[str], bool], counter: str,
          least_ms_per_launch: float) -> Optional[float]:
    """Percent of roofline of a kernel of one shape for every launch."""
    times = kernel_times(rec, match)
    launches = rec["profile"]["launches"].get(counter, 0)
    if not times or not launches:
        return None
    per_launch_ms = sum(us / n for us, n in times.values()) / 1e3
    return 100.0 * least_ms_per_launch / per_launch_ms


def named(needle: str) -> Callable[[str], bool]:
    return lambda name: needle in name


def attention_shape(rec: Dict):
    """(batch, tokens, heads, kv heads, head size) of the encoder."""
    cfg = rec["config"]
    hd = cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]
    return (rec["batch"], cfg["frontend_tokens"], cfg["n_heads"],
            cfg["n_kv_heads"], hd)


def ssd_shape(rec: Dict):
    """(batch, sequence, SSD heads, head size, state) of the ssm family."""
    cfg = rec["config"]
    s = cfg["ssm"]
    nh = s["expand"] * cfg["d_model"] // s["head_dim"]
    return (rec["batch"], rec["cell"]["seq"], nh, s["head_dim"],
            s["d_state"])
