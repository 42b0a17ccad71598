"""Time the port's kernels alone on one NVIDIA GPU, with one-edit variants.

    python3 scripts/time_model_kernels.py [--loader] [--variants [NAME ...]]
        [--against DIR] [--seed N]

Builds the port's kernels from ``src/repro_torch/csrc`` as the port does
(at first use, into ``build/repro_torch/``), then runs
``chip_smoke.model_kernel_phase``: K4 and its backward at qwen3-8b's
shapes, K5 at mamba2-1.3b's forward shapes and its backward at the same
shapes (mamba2-1.3b's training batch), each held against its plain
version and timed with CUDA events beside its bound (and, for K4 and its
backward, ``scaled_dot_product_attention``; both backwards also by
pass).  It also prints the device time of each
of K5's four launches (``torch.profiler``).  With ``--loader`` it runs
``chip_smoke.kernel_phase`` instead: K1-K3 at the loader's main-path
shapes (batch 256, 256x256 -> 224x224), and prints the SASS instruction
mix per hashed byte of K3 and K1 (``cuobjdump -sass`` of the built
library).  Every timing flushes the L2 before each launch
(``chip_smoke.time_ms``).

``--variants`` also builds, into ``build/variants/``, copies of the
sources (with ``common.cuh`` inlined) with one design choice changed each
(``VARIANTS`` below: the model kernels' by default, the loader kernels'
with ``--loader``; only the ones named, if any are) and times every copy
beside the committed source on the same inputs, in turns (committed,
variant, variant, committed); K1-K3
are called through the port's wrappers with the variant's library in
place of the committed one, as is K5's backward (in bf16 at K5's shape
on ``chip_smoke.ssd_bwd_inputs``, without the final state's gradient),
K4, K5 and K4's backward through their C entry points (K4's backward in
bf16 at qwen3-8b's shape, causal).  A
variant shows what one design choice costs; it may compute something
else, so it is timed and not checked.

``--against DIR`` times the K4, K4-backward, K5 and K5-backward sources
of another checkout (``DIR/src/repro_torch/csrc``, e.g. the parent
commit unpacked with ``git archive``) beside the committed ones, built
and called the same way, in turns (there, here, here, there); a source
the other checkout lacks is reported and skipped.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: name -> (kernel, [(text, replacement), ...]); a kernel is named by its
#: wrapper, and ``SOURCE_OF`` gives the source that holds it
VARIANTS = {
    # P as one bf16 part: drops the lo product of P V (misses the card check)
    "k4_single_bf16_p": ("flash_attention", [(
        "          wgmma_rs<HDP>(o, p_lo[kk], vd);\n", "")]),
    "k4_128_key_tiles": ("flash_attention", [(
        "constexpr int kBlockN = 64;", "constexpr int kBlockN = 128;")]),
    # K4's bf16 backward: P and dS as one bf16 part, the lo products
    # dropped (misses the card check): what the hi + lo split costs
    "k4_bwd_single_bf16": ("flash_attention_bwd", [(
        "    wgmma_rs<HDP>(acc, lo[kk], mnmajor(b, kk));\n", "")]),
    # work items in a plain stride of the grid, not the snake order
    "k4_bwd_stride_order": ("flash_attention_bwd", [(
        "const int w = r * g + ((r & 1) ? g - 1 - b : b);",
        "const int w = r * g + b;")]),
    # one buffer of the prep and dQ items' Q, O and dO tiles, not two
    "k4_bwd_single_buffer": ("flash_attention_bwd", [
        ("kBuffers = 2;  // of the items' Q, O", "kBuffers = 1;  // of the items' Q, O"),
        ("kBuffers = 2;  // of the items' Q and", "kBuffers = 1;  // of the items' Q and")]),
    # the prep pass with one input buffer and a deeper K ring
    "k4_bwd_prep_4_stages": ("flash_attention_bwd", [
        ("kBuffers = 2;  // of the items' Q, O", "kBuffers = 1;  // of the items' Q, O"),
        ("kStages = 2;   // of the K ring", "kStages = 4;   // of the K ring")]),
    "k4_bwd_prep_6_stages": ("flash_attention_bwd", [
        ("kBuffers = 2;  // of the items' Q, O", "kBuffers = 1;  // of the items' Q, O"),
        ("kStages = 2;   // of the K ring", "kStages = 6;   // of the K ring")]),
    # the prep pass with one of its parts taken out (what each costs): D
    # from O and dO, the exponentials of the row sums, the O and dO
    # loads, the score products and softmax (the K ring alone)
    "k4_bwd_prep_no_d": ("flash_attention_bwd", [(
        "      for (int i = 0; i < kHalf; ++i) {\n        const int ch",
        "      for (int i = 0; i < 0; ++i) {\n        const int ch")]),
    "k4_bwd_prep_no_exp": ("flash_attention_bwd", [(
        "l[(j >> 1) & 1] += ex2(s[j] - m[(j >> 1) & 1]);",
        "l[(j >> 1) & 1] += s[j];")]),
    "k4_bwd_prep_no_o_do_loads": ("flash_attention_bwd", [(
        "        mbar_expect_tx(q_full(qb), L::kIn);\n"
        "        load_tile<HDP, kBlock>(in + L::kQ, &q_map, q_full(qb), it.h, "
        "it.q0, it.b);\n"
        "        load_tile<HDP, kBlock>(in + L::kO, &o_map, q_full(qb), it.h, "
        "it.q0, it.b);\n"
        "        load_tile<HDP, kBlock>(in + L::kDO, &do_map, q_full(qb), it.h, "
        "it.q0, it.b);\n",
        "        mbar_expect_tx(q_full(qb), tile_bytes(HDP, kBlock));\n"
        "        load_tile<HDP, kBlock>(in + L::kQ, &q_map, q_full(qb), it.h, "
        "it.q0, it.b);\n")]),
    "k4_bwd_prep_no_scores": ("flash_attention_bwd", [(
        "        if (t < n_mine) {\n          const int k0 = t * kRows;\n"
        "          float s[32];",
        "        if (false) {\n          const int k0 = t * kRows;\n"
        "          float s[32];")]),
    # the accurate exp2f in place of ex2.approx.ftz, and the mask on every
    # tile, not only on those that cross the diagonal or S
    "k4_bwd_accurate_exp2": ("flash_attention_bwd", [(
        'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "y = exp2f(x);")]),
    "k4_bwd_mask_every_tile": ("flash_attention_bwd", [
        ("if (edge) {", "if (true) {")]),
    # deeper rings of the dK/dV and dQ passes
    "k4_bwd_dkdv_3_stages": ("flash_attention_bwd", [(
        "kStages = 2;  // of the Q/dO ring", "kStages = 3;  // of the Q/dO ring")]),
    "k4_bwd_dq_3_stages": ("flash_attention_bwd", [(
        "kStages = 2;   // of the K/V ring", "kStages = 3;   // of the K/V ring")]),
    # the scan kernel's staging alone, without its products
    "k5_scan_no_products": ("ssd_scan", [
        ("    if (active) {\n      const float* cbt",
         "    if (false) {\n      const float* cbt"),
        ("  if (c > 0) {\n    for (int k0 = 0; k0 < N; k0 += 16) {",
         "  if (false) {\n    for (int k0 = 0; k0 < N; k0 += 16) {")]),
    # K5's backward: dx_kernel's staging and elementwise work alone,
    # without its four products
    "k5_bwd_dx_no_products": ("ssd_scan_bwd", [
        ("  tile_fma<1>(a1, mt_s, kLd, x_s, kMaxP, kL);\n"
         "  tile_fma<1>(a2, ct_s, kLd, ht_s, kLd, N);\n", ""),
        ("  tile_fma<1>(a1, m_s, kL, g_s, kMaxP, kL);\n"
         "  tile_fma<1>(a2, bt_s, kLd, gg_s, kLd, N);\n", "")]),
}
#: the loader kernels' variants: K3 (``decode``) and K1
#: (``decode_augment``) in decode.cu, K2 (``augment``) in augment.cu
LOADER_VARIANTS = {
    # K3's hash rounds dropped: the counter words, mix and packing alone
    "k3_no_hash": ("decode", [("h[j] = hash_rounds(x) + mix;",
                               "h[j] = x + mix;")]),
    # a constant word stored: no hash and no packing, the stores alone
    "k3_no_pack": ("decode", [(
        "vecs[v] = make_uint4(words[0], words[1], words[2], words[3]);",
        "vecs[v] = make_uint4(mix, mix, mix, mix);")]),
    # the four low bytes packed by masks, shifts and ors, not byte permutes
    "k3_shift_pack": ("decode", [(
        "  return __byte_perm(__byte_perm(w0, w1, 0x0040), "
        "__byte_perm(w2, w3, 0x0040),\n                     0x5410);",
        "  return (w0 & 0xFFu) | ((w1 & 0xFFu) << 8) | ((w2 & 0xFFu) << 16) "
        "| (w3 << 24);")]),
    # 16-byte vectors per thread: 1, 2 and 8 against the committed 4
    "k3_1_vec": ("decode", [("constexpr int kDecodeVecs = 4;",
                             "constexpr int kDecodeVecs = 1;")]),
    "k3_2_vecs": ("decode", [("constexpr int kDecodeVecs = 4;",
                              "constexpr int kDecodeVecs = 2;")]),
    "k3_8_vecs": ("decode", [("constexpr int kDecodeVecs = 4;",
                              "constexpr int kDecodeVecs = 8;")]),
    # the hash rounds dropped: what K1's integer operations cost
    "k1_no_hash": ("decode_augment", [(
        "return (hash_rounds(x) + mix) & 0xFFu;",
        "return (x + mix) & 0xFFu;")]),
    # the table lookup replaced by its index: what the shared-memory
    # lookups cost
    "k1_no_table": ("decode_augment", [(
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
#: kernel -> the source stem under ``src/repro_torch/csrc`` that holds it
SOURCE_OF = {"decode": "decode", "decode_augment": "decode",
             "augment": "augment", "flash_attention": "flash_attention",
             "flash_attention_bwd": "flash_attention_bwd",
             "ssd_scan": "ssd_scan", "ssd_scan_bwd": "ssd_scan_bwd"}
#: SASS opcodes by the pipe that executes them (Nsight Compute's pipe
#: names): the integer and logic ALU pipe, and the FMA pipe, which also
#: runs integer multiplies and the IMAD forms of adds, shifts and moves
ALU_OPCODES = {"IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA",
               "IMNMX", "IABS", "FLO", "POPC", "BMSK", "SGXT"}
FMA_OPCODES = {"IMAD", "IMUL"}
#: the first multiplier of the hash (``kHashM1``): one per hashed byte
HASH_M1 = "0x7feb352d"


def build_source(name: str, csrc: Path, stem: str, edits=()) -> ctypes.CDLL:
    """``csrc/<stem>.cu`` with ``edits`` applied (``common.cuh`` inlined,
    the other headers from ``csrc``), built into ``build/variants/``."""
    from repro_torch.kernels.device import NVCC_FLAGS, _nvcc
    text = (csrc / f"{stem}.cu").read_text().replace(
        '#include "common.cuh"', (csrc / "common.cuh").read_text())
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: its edit no longer applies")
        text = text.replace(old, new)
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(text)
    lib = out / f"lib{name}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def build_variant(name: str) -> ctypes.CDLL:
    from repro_torch.kernels.device import CSRC
    kernel, edits = {**VARIANTS, **LOADER_VARIANTS}[name]
    return build_source(name, CSRC, SOURCE_OF[kernel], edits)


def model_inputs(dev, seed: int):
    """K4's, K5's and K5's backward's inputs at the models' shapes, as
    chip_smoke draws them."""
    from chip_smoke import ATTN_B, ATTN_S, SSM_B, SSM_S, ssd_bwd_inputs
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
    return (q, k, v), (x, dt, A, Bm, Cm), ssd_bwd_inputs(
        dev, rng, SSM_B, SSM_S, 64, 64, 128, torch.bfloat16)


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


def loader_launcher(lib: ctypes.CDLL, kernel: str, scalars, imgs,
                    out_dtype: torch.dtype):
    """A no-argument call of the port's K3 (``decode``), K1
    (``decode_augment``) or K2 (``augment``) wrapper that launches from
    ``lib`` instead of the committed library."""
    from repro_torch.kernels.augment import kernel as augment_k
    from repro_torch.kernels.decode import kernel as decode_k
    stem = SOURCE_OF[kernel]
    crop = dict(crop_h=224, crop_w=224, out_dtype=out_dtype)
    if kernel == "decode":
        def run():
            return decode_k.decode(*scalars[:2], h=256, w=256)
    elif kernel == "decode_augment":
        def run():
            return decode_k.decode_augment(*scalars, img_h=256, img_w=256,
                                           **crop)
    else:
        def run():
            return augment_k.augment(imgs, *scalars[2:], **crop)
    return swapped(stem, lib, run)


def swapped(stem: str, lib: ctypes.CDLL, run):
    """A no-argument call of ``run`` with ``lib`` in place of the port's
    library of ``csrc/<stem>.cu``."""
    from repro_torch.kernels import device

    def call():
        committed = device.build_all()[stem]
        device._libraries[stem] = lib
        try:
            run()
        finally:
            device._libraries[stem] = committed
    return call


def sass_mix(lib: ctypes.CDLL, only: str = "", tag: str = "") -> None:
    """Per hashed byte, the SASS instructions of K3's and K1's functions
    in ``lib`` (``cuobjdump -sass``), or of one of them (``only``: the
    kernel's name), by opcode and by pipe, printed under ``tag``.  A static
    count over each function's code, its set-up and scalar ends
    included; the hashed bytes are counted by the hash's first
    multiplier, an immediate of one instruction per hashed byte."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", lib._name], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name = func.split("\n", 1)[0].strip()
        if "decode_kernel" in name and only in ("", "decode"):
            label = "K3 decode_kernel"
        elif "decode_augment_kernel" in name and only in ("",
                                                          "decode_augment"):
            # the template's Bits: unsigned short (t) for bf16
            label = ("K1 decode_augment_kernel (bf16)" if "kernelItE" in name
                     else "K1 decode_augment_kernel (fp32)")
        else:
            continue
        # (opcode, operands) of each instruction; the encoding comment
        # after the ';' is left out
        insts = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                           r"([A-Z][A-Z0-9_.]*)([^;]*);", func)
        ops = collections.Counter(op for op, _ in insts
                                  if op not in ("NOP", "BRA"))
        hashed = sum(HASH_M1 in args for _, args in insts)
        if not hashed:
            print(f"SASS{tag} {label}: hashed bytes not counted (no "
                  f"{HASH_M1})", flush=True)
            continue
        total = sum(ops.values())
        alu = sum(n for op, n in ops.items() if op.split(".")[0] in
                  ALU_OPCODES)
        fma = sum(n for op, n in ops.items() if op.split(".")[0] in
                  FMA_OPCODES)
        top = ", ".join(f"{op} {n / hashed:.2f}"
                        for op, n in ops.most_common(12))
        print(f"SASS{tag} {label} (cuobjdump, static): {hashed} hashed "
              f"bytes in the code; per hashed byte {total / hashed:.2f} "
              f"instructions, ALU pipe {alu / hashed:.2f}, FMA pipe "
              f"{fma / hashed:.2f}, other {(total - alu - fma) / hashed:.2f};"
              f" {top}", flush=True)


def launcher(lib: ctypes.CDLL, stem: str, attn, ssm, ssm_bwd):
    """A no-argument call of the library's K4, K5 or K4-backward entry
    point, or of K5's backward's wrapper launching from ``lib``."""
    if stem == "ssd_scan_bwd":
        from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward
        return swapped(stem, lib, lambda: ssd_scan_backward(*ssm_bwd))
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
    elif stem == "flash_attention_bwd":
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention
        q, k, v = attn
        out = flash_attention(q, k, v, causal=True)
        dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
            q.shape).astype(np.float32)).to(q.device, q.dtype)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        B, S, H, hd = q.shape
        # a source without the entry (the CUDA-core form alone) takes
        # (B, H, S) scratch
        rows = lib.repro_torch_flash_attention_bwd_rows(S) if hasattr(
            lib, "repro_torch_flash_attention_bwd_rows") else S
        lse, delta = (torch.empty((B, H, rows), device=q.device)
                      for _ in range(2))
        fn = lib.repro_torch_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        args = tuple(t.data_ptr() for t in (q, k, v, out, dout, *grads, lse,
                                            delta)) \
            + (B, S, H, k.shape[2], hd, 1, 1 / math.sqrt(hd), 1, stream)
        tensors = (out, dout, *grads, lse, delta)
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
    ap.add_argument("--variants", nargs="*", metavar="NAME",
                    help="time every variant, or the ones named")
    ap.add_argument("--against", metavar="DIR",
                    help="time this checkout's K4, K5 and backward "
                         "sources beside the committed ones")
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
        sass_mix(libs["decode"])
        scalars, imgs = loader_inputs(dev, args.seed)

        def make(lib, kernel, dtype):
            return loader_launcher(lib, kernel, scalars, imgs, dtype)

        variants = LOADER_VARIANTS
    else:
        chip_smoke.model_kernel_phase(dev, args.seed)
        attn, ssm, ssm_bwd = model_inputs(dev, args.seed)
        k5_split(dev, ssm)

        def make(lib, kernel, dtype):
            return launcher(lib, kernel, attn, ssm, ssm_bwd)

        variants = VARIANTS
    if args.variants is not None:
        unknown = set(args.variants) - set(variants)
        if unknown:
            ap.error(f"no variants {sorted(unknown)}")
        for name, (kernel, _) in variants.items():
            if args.variants and name not in args.variants:
                continue
            lib = build_variant(name)
            stem = SOURCE_OF[kernel]
            if kernel in ("decode", "decode_augment"):
                sass_mix(lib, kernel, f" of variant {name}")
            dtypes = (torch.float32, torch.bfloat16) if kernel in (
                "decode_augment", "augment") else (None,)
            for dtype in dtypes:
                base = make(libs[stem], kernel, dtype)
                var = make(lib, kernel, dtype)
                times = [chip_smoke.time_ms(fn, 20)
                         for fn in (base, var, var, base)]
                tag = "" if dtype is None else f" ({dtype})"
                print(f"variant {name}{tag}: {(times[1] + times[2]) / 2:.4f} "
                      f"ms against {(times[0] + times[3]) / 2:.4f} ms for the "
                      f"committed {kernel} in {stem}.cu (turns: "
                      + ", ".join(f"{t:.4f}" for t in times) + ")",
                      flush=True)
    if args.against and not args.loader:
        csrc = Path(args.against).resolve() / "src" / "repro_torch" / "csrc"
        for stem in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                     "ssd_scan_bwd"):
            if not (csrc / f"{stem}.cu").exists():
                print(f"against {args.against}: no {stem}.cu there",
                      flush=True)
                continue
            there = make(build_source(f"against_{stem}", csrc, stem), stem,
                         None)
            here = make(libs[stem], stem, None)
            times = [chip_smoke.time_ms(fn, 10)
                     for fn in (there, here, here, there)]
            print(f"against {args.against}: {stem} "
                  f"{(times[0] + times[3]) / 2:.4f} ms there, "
                  f"{(times[1] + times[2]) / 2:.4f} ms here (turns: "
                  + ", ".join(f"{t:.4f}" for t in times) + ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
