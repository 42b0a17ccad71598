"""Build and check K4's backward on one NVIDIA GPU, shape by shape.

    python3 scripts/check_flash_attention_bwd.py

Compiles ``src/repro_torch/csrc/flash_attention_bwd.cu`` and
``flash_attention.cu`` once with ``-Xptxas -v`` and prints each kernel's
registers and spills, counts the HGMMA, FFMA and local-memory (LDL/STL)
instructions of each function of the built backward library
(``cuobjdump -sass``), then runs ``flash_attention_backward`` at small,
ragged and qwen3-8b shapes (bf16 causal and not, and float32) against
its plain version: per gradient, whether it is within the card check
(bf16: 1e-3 + 2**-7 |x|, relative RMS <= 2**-8; float32: 1e-4), the
elements outside it, the relative RMS and the largest difference, and
whether a second call gives the same bits.  Last it times the bf16
backward at (4, 1024, 32 | 8, 128), causal (``chip_smoke.time_ms``: the
L2 flushed before each launch) and prints each kernel's device time
from ``torch.profiler``.  A launch that does not finish within 30 s
ends the script with exit code 3 instead of hanging the card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (B, S, H, K, hd, dtype, causal)
SHAPES = [(2, 70, 4, 4, 16, torch.bfloat16, True),
          (2, 70, 4, 4, 16, torch.bfloat16, False),
          (2, 200, 8, 2, 64, torch.bfloat16, True),
          (2, 333, 8, 2, 128, torch.bfloat16, True),
          (2, 333, 8, 2, 128, torch.bfloat16, False),
          (2, 129, 32, 8, 128, torch.bfloat16, True),
          (2, 1000, 8, 2, 64, torch.bfloat16, False),
          (2, 1025, 8, 2, 128, torch.bfloat16, True),
          (2, 1025, 8, 2, 64, torch.bfloat16, True),
          (4, 1024, 32, 8, 128, torch.bfloat16, True),
          (4, 1024, 32, 8, 128, torch.bfloat16, False),
          (2, 200, 32, 8, 128, torch.float32, True)]


def finished(tag: str, limit: float = 30.0) -> None:
    """Wait for the stream; exit 3 if it has not drained in ``limit`` s."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.time()
    while not ev.query():
        if time.time() - t0 > limit:
            print(f"no progress in {limit} s: {tag}", flush=True)
            os._exit(3)
        time.sleep(0.01)


def ptxas_report() -> None:
    from repro_torch.kernels import device
    for src in ("flash_attention_bwd.cu", "flash_attention.cu"):
        out = ROOT / "build" / f"ptxas_{src}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([device._nvcc(), *device.NVCC_FLAGS, "-Xptxas",
                            "-v", "-o", str(out), str(device.CSRC / src)],
                           capture_output=True, text=True)
        print(f"{src}: nvcc rc {r.returncode}", flush=True)
        keep = [line for line in (r.stdout + r.stderr).splitlines()
                if re.search(r"error|registers|spill|Compiling entry|C7513",
                             line)]
        print("\n".join(keep), flush=True)
        if r.returncode != 0:
            sys.exit(1)


def sass_report(lib_path: str) -> None:
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        counts = {op: len(re.findall(rf"\b{op}", func))
                  for op in ("HGMMA", "FFMA", "LDL", "STL")}
        print(f"SASS {name[:72]}: {counts}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("check_flash_attention_bwd: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.device import build_all
    from repro_torch.kernels.flash_attention import kernel as fa
    print(f"card: {chip_smoke.card_line()}", flush=True)
    ptxas_report()
    sass_report(build_all()["flash_attention_bwd"]._name)
    dev = torch.device("cuda")
    failures = 0
    for B, S, H, K, hd, dtype, causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(S + H)
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                   .to(dtype) for n in (H, K, K))
        dout = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
        out = fa.flash_attention(q, k, v, causal=causal)
        got = fa.flash_attention_backward(q, k, v, out, dout, causal=causal)
        finished(f"({B}, {S}, {H} | {K}, {hd}) {dtype} causal={causal}")
        again = fa.flash_attention_backward(q, k, v, out, dout,
                                            causal=causal)
        finished("second call")
        want = fa.flash_attention_backward_plain(q, k, v, out, dout, causal)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        report = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            if dtype == torch.float32:
                close = torch.isclose(g, w, atol=1e-4, rtol=1e-4)
            else:
                close = torch.isclose(g, w, atol=1e-3, rtol=2.0 ** -7)
            rel = float((g - w).norm() / w.norm())
            ok = bool(close.all()) and (dtype == torch.float32
                                        or rel <= 2.0 ** -8)
            failures += not ok
            report.append(f"{name} {'ok' if ok else 'OUTSIDE'} "
                          f"({int((~close).sum())} outside, rel RMS "
                          f"{rel:.2e}, max {float((g - w).abs().max()):.4g})")
        failures += not same
        print(f"({B}, {S}, {H} | {K}, {hd}) {str(dtype)[6:]} causal={causal}:"
              f" bitwise repeat {same}; " + "; ".join(report), flush=True)
        del q, k, v, dout, out, got, again, want
        torch.cuda.empty_cache()
    B, S, H, K, hd = 4, 1024, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                     .bfloat16() for n in (H, K, K, H))
    out = fa.flash_attention(q, k, v, causal=True)
    ms = chip_smoke.time_ms(
        lambda: fa.flash_attention_backward(q, k, v, out, dout, causal=True),
        10)
    print(f"bf16 backward at ({B}, {S}, {H} | {K}, {hd}), causal: {ms:.4f} "
          f"ms ({chip_smoke.card_line()})", flush=True)
    split = chip_smoke.pass_ms(
        lambda: fa.flash_attention_backward(q, k, v, out, dout, causal=True),
        chip_smoke.BWD_PASSES)
    print("by pass (torch.profiler): " + ", ".join(
        f"{name} {ms:.4f} ms (mean of {n} launches)"
        for name, (ms, n) in split.items()), flush=True)
    print(f"shapes outside the check or not repeatable: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
