"""Time the port's kernels alone on one NVIDIA GPU, with one-edit variants.

    python3 scripts/time_model_kernels.py [--loader] [--variants] [--seed N]

Builds the port's kernels from ``src/repro_torch/csrc`` as the port does
(at first use, into ``build/repro_torch/``), then runs
``chip_smoke.model_kernel_phase``: K4 at qwen3-8b's prefill shapes and K5
at mamba2-1.3b's forward shapes, each held against its plain version and
timed with CUDA events beside its bound (and, for K4,
``scaled_dot_product_attention``).  It also prints the device time of each
of K5's four launches (``torch.profiler``).  With ``--loader`` it runs
``chip_smoke.kernel_phase`` instead: K1-K3 at the loader's main-path
shapes (batch 256, 256x256 -> 224x224), the L2 flushed before each launch.

``--variants`` also builds, into ``build/variants/``, copies of the
sources (with ``common.cuh`` inlined) with one edit each (``VARIANTS``
below: the model kernels' by default, the loader kernels' with
``--loader``) and times every copy beside the committed source on the
same inputs, in turns (committed, variant, variant, committed); K1 and
K2 are called through the port's wrappers with the variant's library in
place of the committed one, K4 and K5 through their C entry points.  A
variant shows what one design choice costs; it may compute something
else, so it is timed and not checked.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: name -> (source stem, [(text, replacement), ...])
VARIANTS = {
    # P as one bf16 part: drops the lo product of P V (misses the card check)
    "k4_single_bf16_p": ("flash_attention", [(
        "          wgmma_rs<HDP>(o, p_lo[kk], vd);\n", "")]),
    "k4_128_key_tiles": ("flash_attention", [(
        "constexpr int kBlockN = 64;", "constexpr int kBlockN = 128;")]),
    # the scan kernel's staging alone, without its products
    "k5_scan_no_products": ("ssd_scan", [
        ("    if (active) {\n      const float* cbt",
         "    if (false) {\n      const float* cbt"),
        ("  if (c > 0) {\n    for (int k0 = 0; k0 < N; k0 += 16) {",
         "  if (false) {\n    for (int k0 = 0; k0 < N; k0 += 16) {")]),
}
#: the loader kernels' variants (K1 in decode.cu, K2 in augment.cu)
LOADER_VARIANTS = {
    # the hash rounds dropped: what K1's integer operations cost
    "k1_no_hash": ("decode", [("return (hash_rounds(x) + mix) & 0xFFu;",
                               "return (x + mix) & 0xFFu;")]),
    # the table lookup replaced by its index: what the shared-memory
    # lookups cost
    "k1_no_table": ("decode", [(
        "vals[t] = s_table[coff + src.pixel(cur)];",
        "vals[t] = coff + src.pixel(cur);")]),
    "k2_no_table": ("augment", [(
        "vals[t] = s_table[coff + src.pixel(cur)];",
        "vals[t] = coff + src.pixel(cur);")]),
    # K2 without its staging loads (reads buffers never written)
    "k2_no_loads": ("augment", [("stage_row(buf, src, row_len, lane);", "")]),
    # K2 held to 32 registers, so eight blocks (64 warps) fit on an SM
    "k2_8_blocks_per_sm": ("augment", [(
        "__launch_bounds__(kLoaderWarps * 32)\n    augment_kernel",
        "__launch_bounds__(kLoaderWarps * 32, 8)\n    augment_kernel")]),
}


def build_variant(name: str) -> ctypes.CDLL:
    from repro_torch.kernels.device import CSRC, NVCC_FLAGS, _nvcc
    stem, edits = {**VARIANTS, **LOADER_VARIANTS}[name]
    text = (CSRC / f"{stem}.cu").read_text().replace(
        '#include "common.cuh"', (CSRC / "common.cuh").read_text())
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: its edit no longer applies")
        text = text.replace(old, new)
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(text)
    lib = out / f"lib{name}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def model_inputs(dev, seed: int):
    """K4's and K5's inputs at the models' shapes, as chip_smoke draws
    them."""
    from chip_smoke import ATTN_B, ATTN_S, SSM_B, SSM_S
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    q = t(rng.standard_normal((ATTN_B, ATTN_S, 32, 128)))
    k, v = (t(rng.standard_normal((ATTN_B, ATTN_S, 8, 128)))
            for _ in range(2))
    x = t(rng.standard_normal((SSM_B, SSM_S, 64, 64)))
    dt = torch.nn.functional.softplus(
        t(rng.standard_normal((SSM_B, SSM_S, 64)), torch.float32))
    A = -torch.exp(t(rng.standard_normal(64) * 0.3, torch.float32))
    Bm, Cm = (t(rng.standard_normal((SSM_B, SSM_S, 128))) for _ in range(2))
    return (q, k, v), (x, dt, A, Bm, Cm)


def loader_inputs(dev, seed: int):
    """K1's five (256,) scalars at 256x256 -> 224x224, and K3's decoded
    images of them for K2."""
    from chip_smoke import BATCH
    from repro_torch.kernels.decode import kernel as decode_k
    rng = np.random.default_rng(seed)
    scalars = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 2**32, BATCH, dtype=np.int64),
        rng.integers(0, 256, BATCH, dtype=np.int32),
        rng.integers(0, 256 - 224 + 1, BATCH, dtype=np.int32),
        rng.integers(0, 256 - 224 + 1, BATCH, dtype=np.int32),
        rng.integers(0, 2, BATCH, dtype=np.int32))]
    return scalars, decode_k.decode(*scalars[:2], h=256, w=256)


def loader_launcher(lib: ctypes.CDLL, stem: str, scalars, imgs,
                    out_dtype: torch.dtype):
    """A no-argument call of the port's K1 (``decode``) or K2
    (``augment``) wrapper that launches from ``lib`` instead of the
    committed library."""
    from repro_torch.kernels import device
    from repro_torch.kernels.augment import kernel as augment_k
    from repro_torch.kernels.decode import kernel as decode_k
    crop = dict(crop_h=224, crop_w=224, out_dtype=out_dtype)
    if stem == "decode":
        def run():
            return decode_k.decode_augment(*scalars, img_h=256, img_w=256,
                                           **crop)
    else:
        def run():
            return augment_k.augment(imgs, *scalars[2:], **crop)

    def call():
        committed = device.build_all()[stem]
        device._libraries[stem] = lib
        try:
            run()
        finally:
            device._libraries[stem] = committed
    return call


def launcher(lib: ctypes.CDLL, stem: str, attn, ssm):
    """A no-argument call of the library's K4 or K5 entry point."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if stem == "flash_attention":
        q, k, v = attn
        out = torch.empty_like(q)
        fn = lib.repro_torch_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        B, S, H, hd = q.shape
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, k.shape[2], hd, 1, 1 / math.sqrt(hd), 1, stream)
        tensors = (out,)
    else:
        from repro_torch.kernels.ssd_scan.kernel import kernel_chunk
        x, dt, A, Bm, Cm = ssm
        B, S, nh, P = x.shape
        N = Bm.shape[-1]
        L = kernel_chunk(256, S)
        lib.repro_torch_ssd_scan_scratch.argtypes = [ctypes.c_int] * 6
        lib.repro_torch_ssd_scan_scratch.restype = ctypes.c_longlong
        scratch = torch.empty(lib.repro_torch_ssd_scan_scratch(
            B, S, nh, P, N, L), dtype=torch.uint8, device=x.device)
        y = torch.empty_like(x)
        h = torch.empty((B, nh, P, N), device=x.device)
        fn = lib.repro_torch_ssd_scan
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
                scratch.data_ptr(), B, S, nh, P, N, L, 1, stream)
        tensors = (scratch, y, h)
    fn.restype = ctypes.c_int

    def call(_alive=tensors):  # the outputs live as long as the call
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{stem} launch failed: {err}")
    return call


def k5_split(dev, ssm) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    for _ in range(3):
        ssd_k.ssd_scan(*ssm, chunk=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssd_k.ssd_scan(*ssm, chunk=256)
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0].split("::")[-1]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 10
    print("K5 launches (torch.profiler, mean of 10 calls): " + ", ".join(
        f"{n} {us:.1f} us" for n, us in sorted(by.items(),
                                               key=lambda kv: -kv[1])),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loader", action="store_true",
                    help="K1-K3 and their variants instead of K4/K5")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_model_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.device import build_all
    dev = torch.device("cuda")
    print(f"card: {chip_smoke.card_line()}", flush=True)
    libs = build_all()
    if args.loader:
        chip_smoke.kernel_phase(dev, args.seed)
        scalars, imgs = loader_inputs(dev, args.seed)
        flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                            device=dev)

        def make(lib, stem, dtype):
            return loader_launcher(lib, stem, scalars, imgs, dtype)

        variants, dtypes = LOADER_VARIANTS, (torch.float32, torch.bfloat16)
    else:
        chip_smoke.model_kernel_phase(dev, args.seed)
        attn, ssm = model_inputs(dev, args.seed)
        k5_split(dev, ssm)
        flush = None

        def make(lib, stem, dtype):
            return launcher(lib, stem, attn, ssm)

        variants, dtypes = VARIANTS, (None,)
    if args.variants:
        for name, (stem, _) in variants.items():
            lib = build_variant(name)
            for dtype in dtypes:
                base = make(libs[stem], stem, dtype)
                var = make(lib, stem, dtype)
                times = [chip_smoke.time_ms(fn, 20, flush=flush)
                         for fn in (base, var, var, base)]
                tag = "" if dtype is None else f" ({dtype})"
                print(f"variant {name}{tag}: {(times[1] + times[2]) / 2:.4f} "
                      f"ms against {(times[0] + times[3]) / 2:.4f} ms for the "
                      f"committed {stem}.cu (turns: "
                      + ", ".join(f"{t:.4f}" for t in times) + ")",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
