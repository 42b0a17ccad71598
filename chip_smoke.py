"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (first use,
into ``build/repro_torch/``), then:

1. prints the toolchain (card name and power limit from ``nvidia-smi``,
   torch, CUDA and nvcc versions);
2. kernel phase: at the main path's shapes (batch 256, ImageNet-like
   256x256 images, 224x224 crops) each kernel — K3 decode, K1 fused
   decode+augment, K2 augment (float32 and bfloat16 out) — is held
   bitwise against its plain PyTorch version on the card, K1 against K3
   followed by K2, and timed with CUDA events beside its bound: the
   larger of its bytes at the memory rate and its hash's integer
   operations at the integer pipes' rates (every timing in the script
   flushes the L2 before each launch, ``time_ms``);
3. main path, augmented: ``SenecaServer.for_dataset(imagenet_like(n))``
   at n = ``N_AUGMENTED`` with an HBM tier sized for every augmented
   sample, the device executor at batch 256 for two epochs: every id
   once per epoch, rows equal to a CPU recomputation, zero h2d bytes in
   the all-HBM epoch, K1 launched; the cold epoch runs under
   ``torch.profiler`` (device activity only), which gives K1's device
   time in it and the card's idle share;
4. main path, decoded hits: at n = ``N_DECODED`` every decoded form
   pre-warmed into the HBM tier through K3 (traced: K3's device time),
   one epoch through K2 with no cache or h2d bytes;
5. model kernel phase: K4 flash attention at qwen3-8b's prefill shapes
   and K5 SSD scan at mamba2-1.3b's forward shapes (both on the tensor
   cores in bf16), each against its plain version on the card, timed
   with the L2 flushed beside its bound and (K4) beside
   ``scaled_dot_product_attention`` as a yardstick the port never calls;
6. serving path, dense: qwen3-8b at full width (random weights from
   ``--seed``): ``Model.prefill`` of 4 x 1024 tokens (K4 launched once
   per layer; prefill logits equal forward's; decode at index S agrees
   with forward on the extended sequence within ``depth_tolerance``),
   a device-time split of one prefill from ``torch.profiler``, the
   CLI's ``Server`` defaults (8 requests, 4 slots, prompts of 12, 16 new
   tokens), and one request alone whose first token is forward's
   argmax;
7. serving path, ssm: mamba2-1.3b at full width: ``Model.forward`` of
   4 x 1024 tokens (K5 launched once per layer), token-by-token decode
   from zero state against forward on a 64-token prefix (bf16 reported;
   float32 checked), and the ``Server`` as for qwen3-8b (each serving
   run with the device split of one decode step);
8. the kernel JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

Float32 products on the card run in full float32: the script sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False.

Any failed check raises and the script exits non-zero without a result
line; a machine without CUDA, or a directory without ``src/repro_torch``
beside the script, exits 2 at once with a message.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: integer lanes of one SM: the ALU pipe's 64 (shifts and logic
#: operations), and the 128 thread-instructions its four schedulers issue
#: per clock, which also carry the FMA pipe's multiplies and adds
ALU_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
#: operations per hashed byte of the counter hash
#: (``src/repro_torch/csrc/decode.cu``'s note), as (on the ALU pipe, in
#: all): three shifts and three xors on the ALU pipe, and the counter
#: word, two multiplies and the mix add beside them; K1 also masks the
#: byte into its table index, while K3's byte store needs no mask
K3_HASH_OPS = (6, 10)
K1_HASH_OPS = (7, 11)
#: bytes written between two timed launches, so each finds the 50 MB L2
#: holding none of its data
L2_FLUSH_BYTES = 2 * 50 * 2**20
#: cycles the card spins after a flush (~0.5 ms at 1.98 GHz), so the
#: stream is still busy when the host has enqueued the timed launch: the
#: flush alone drains in ~0.04 ms, less than a wrapper's host time, and
#: the events would then time the host's enqueue as well
SPIN_CYCLES = 1_000_000
BATCH = 256
#: samples of the augmented and the decoded-hit main-path runs
#: (multiples of BATCH)
N_AUGMENTED = 16_384
N_DECODED = 2_048


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                          "--version"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[-1]


@functools.lru_cache(maxsize=None)
def _flush_buffer(device_index: int) -> torch.Tensor:
    return torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                       device=torch.device("cuda", device_index))


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` launches, each
    between its own pair of CUDA events, after ``warmup`` calls.  Before
    each launch, outside its events, ``L2_FLUSH_BYTES`` are written so
    the launch starts with a cold L2, and the card then spins
    ``SPIN_CYCLES`` so the start event waits for no host work."""
    flush = _flush_buffer(torch.cuda.current_device())
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes: int, flops: int, peak: float = FP32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over ``peak`` (float32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clocks_per_s() -> float:
    """SMs x the card's maximum SM clock, read with ``nvidia-smi`` in
    this run: times lanes per SM, an integer rate."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * mhz * 1e6


def int_ops_ms(hashed: int, ops, sm_clocks: float) -> float:
    """Least milliseconds for the hash of ``hashed`` bytes at ``ops`` =
    (ALU-pipe operations, all integer operations) per byte: the larger of
    the ALU pipe's share at ``ALU_LANES_PER_SM`` and the whole at
    ``DISPATCH_LANES_PER_SM``."""
    alu, total = ops
    return max(hashed * alu / (sm_clocks * ALU_LANES_PER_SM),
               hashed * total / (sm_clocks * DISPATCH_LANES_PER_SM)) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------------
def kernel_phase(dev, seed: int):
    """Each kernel against its plain version at the main path's shapes,
    timed beside its bound.  Launches made here are comparisons and do
    not count toward the main path."""
    from repro_torch.data.augment import derive_batch_params
    from repro_torch.data.synthetic import imagenet_like
    from repro_torch.kernels.augment import kernel as augment_k
    from repro_torch.kernels.decode import kernel as decode_k
    from repro_torch.kernels.decode.ops import (decode_params,
                                                params_to_device)

    sm_clocks = sm_clocks_per_s()
    print(f"integer rates (SMs x clocks.max.sm x lanes): ALU pipe "
          f"{sm_clocks * ALU_LANES_PER_SM / 1e12:.2f} T/s, issue "
          f"{sm_clocks * DISPATCH_LANES_PER_SM / 1e12:.2f} T/s", flush=True)
    ds = imagenet_like(n=BATCH * 4)
    (H, W), (ch, cw) = ds.image_hw, ds.crop_hw
    rng = np.random.default_rng(seed)
    ids = rng.choice(ds.n_samples, BATCH, replace=False)
    bases, mixes = decode_params(ds.seed, ids,
                                 [ds.encoded(int(s)) for s in ids])
    tops, lefts, flips = derive_batch_params((H, W), (ch, cw),
                                             rng.integers(0, 2**31, BATCH))
    b_t, m_t, t_t, l_t, f_t = params_to_device(bases, mixes, tops, lefts,
                                               flips, device=dev)
    scalars = [b_t, m_t, t_t, l_t, f_t]
    scalar_bytes = sum(t.numel() * t.element_size() for t in scalars)
    n_out = BATCH * ch * cw * 3

    def run_k3():
        return decode_k.decode(b_t, m_t, h=H, w=W)

    def run_k1(dtype=torch.float32):
        return decode_k.decode_augment(*scalars, img_h=H, img_w=W,
                                       crop_h=ch, crop_w=cw, out_dtype=dtype)

    imgs = run_k3()

    def run_k2(dtype=torch.float32):
        return augment_k.augment(imgs, t_t, l_t, f_t, crop_h=ch, crop_w=cw,
                                 out_dtype=dtype)

    rows = {}
    # K3: byte-equal to its plain version
    plain3 = decode_k.decode_plain(b_t, m_t, H, W)
    check(torch.equal(imgs, plain3), "K3 decode differs from decode_plain")
    rows["decode"] = dict(
        name="decode", route="cuda", source="src/repro_torch/csrc/decode.cu",
        replaces="src/repro/kernels/decode/kernel.py:47",
        max_abs_err=max_abs_err(imgs, plain3),
        ms=time_ms(run_k3, 30),
        plain_ms=time_ms(lambda: decode_k.decode_plain(b_t, m_t, H, W), 5,
                         warmup=1),
        nbytes=BATCH * H * W * 3 + 12 * BATCH,
        int_ms=int_ops_ms(BATCH * H * W * 3, K3_HASH_OPS, sm_clocks))
    del plain3
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        size = torch.finfo(dtype).bits // 8
        k1 = run_k1(dtype)
        plain1 = decode_k.decode_augment_plain(*scalars, W, ch, cw, dtype)
        check(torch.equal(k1, plain1),
              f"K1 decode_augment{tag} differs from its plain version")
        k2 = run_k2(dtype)
        check(torch.equal(k1, k2), f"K1{tag} differs from K3 then K2")
        plain2 = augment_k.augment_plain(imgs, t_t, l_t, f_t, ch, cw, dtype)
        check(torch.equal(k2, plain2),
              f"K2 augment{tag} differs from its plain version")
        rows["decode_augment" + tag] = dict(
            name="decode_augment" + tag, route="cuda",
            source="src/repro_torch/csrc/decode.cu",
            replaces="src/repro/kernels/decode/kernel.py:103",
            max_abs_err=max_abs_err(k1, plain1),
            ms=time_ms(lambda: run_k1(dtype), 30),
            plain_ms=time_ms(lambda: decode_k.decode_augment_plain(
                *scalars, W, ch, cw, dtype), 5, warmup=1),
            nbytes=n_out * size + scalar_bytes,
            int_ms=int_ops_ms(n_out, K1_HASH_OPS, sm_clocks))
        rows["augment" + tag] = dict(
            name="augment" + tag, route="cuda",
            source="src/repro_torch/csrc/augment.cu",
            replaces="src/repro/kernels/augment/kernel.py:61",
            max_abs_err=max_abs_err(k2, plain2),
            ms=time_ms(lambda: run_k2(dtype), 30),
            plain_ms=time_ms(lambda: augment_k.augment_plain(
                imgs, t_t, l_t, f_t, ch, cw, dtype), 5, warmup=1),
            # the crop windows are what the function must read; it hashes
            # nothing
            nbytes=n_out + n_out * size + 12 * BATCH, int_ms=0.0)
        del k1, k2, plain1, plain2
    for row in rows.values():
        nbytes, int_ms = row.pop("nbytes"), row.pop("int_ms")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_ms"], row["bound_by"] = (bytes_ms, "bytes") \
            if bytes_ms >= int_ms else (int_ms, "operations")
        row["library_ms"] = None       # no single PyTorch call computes it
        print_row(row, "bitwise equal to plain, L2 flushed before each "
                  f"launch; bytes {bytes_ms:.4f} ms, integer operations "
                  f"{int_ms:.4f} ms")
    return rows


def print_row(row, how: str) -> None:
    lib = "" if row["library_ms"] is None \
        else f", library {row['library_ms']:.4f} ms"
    print(f"kernel {row['name']}: {how} (max_abs_err {row['max_abs_err']}),"
          f" {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms{lib}, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound", flush=True)


def _wrappers():
    from repro_torch.kernels.augment import kernel as augment_k
    from repro_torch.kernels.decode import kernel as decode_k
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    return {"decode": decode_k.decode,
            "decode_augment": decode_k.decode_augment,
            "augment": augment_k.augment,
            "flash_attention": fa.flash_attention,
            "ssd_scan": ssd_k.ssd_scan}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def expected_row(ds, sid: int, seed: int) -> np.ndarray:
    """CPU recomputation of one augmented row through the plain
    versions (fused decode+augment on a CPU tensor)."""
    from repro_torch.kernels.augment.ops import decode_augment_batch_seeded
    return decode_augment_batch_seeded(
        [ds.encoded(sid)], [sid], np.asarray([seed]), ds_seed=ds.seed,
        image_hw=ds.image_hw, crop_h=ds.crop_hw[0], crop_w=ds.crop_hw[1],
        device="cpu")[0].numpy()


def check_rows(ds, picks, epoch_seeds) -> None:
    """Each picked (batch images, slot, id, epoch tag) row equals the
    plain recomputation for one seed that can have produced it: this
    epoch's augment seed, an earlier epoch's (an augmented HBM hit keeps
    the crop it was cached with) or the background refill's."""
    from repro_torch.data.pipeline import _aug_seed
    for images, slot, sid, epoch in picks:
        got = images[slot].cpu().numpy()
        check(got.shape == (*ds.crop_hw, 3) and np.isfinite(got).all(),
              f"row of sample {sid} is malformed")
        seeds = [_aug_seed(e, sid) for e in range(epoch + 1)] \
            if epoch_seeds else [_aug_seed(epoch, sid)]
        seeds.append(sid ^ 0x5EED)
        check(any(np.array_equal(got, expected_row(ds, sid, s))
                  for s in seeds),
              f"row of sample {sid} equals no CPU recomputation")


def run_epoch(pipe, sess, ds, dev, n_batches, rng, n_picks=4):
    """One epoch of ``n_batches``; returns (ids served, seconds, picked
    rows to check) and prints the pipeline's host-clock stage times."""
    before = pipe.times.as_dict()
    pick_at = set(rng.choice(n_batches, min(n_picks, n_batches),
                             replace=False).tolist())
    ids, picks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_batches):
        batch = pipe.next_batch()
        images = batch["images"]
        check(images.device.type == dev.type
              and images.dtype == torch.float32
              and tuple(images.shape) == (BATCH, *ds.crop_hw, 3),
              f"batch images are {images.dtype} {tuple(images.shape)} on "
              f"{images.device}")
        ids.extend(batch["ids"].tolist())
        if i in pick_at:
            slot = int(rng.integers(0, BATCH))
            picks.append((images, slot, int(batch["ids"][slot]),
                          sess.epoch))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = pipe.times.as_dict()
    print("  stage seconds: " + ", ".join(
        f"{k} {after[k] - before[k]:.4f}"
        for k in ("fetch", "decode", "augment", "collate")), flush=True)
    return ids, secs, picks


def traced(fn):
    """``fn()`` under ``torch.profiler`` with device activity only;
    returns its result and the (name, start us, end us) of every kernel
    and copy the card ran meanwhile, in any thread.  Four spin kernels
    run first under the profiler and are left out of the spans: one
    traced pre-warm saw 7 of its 8 K3 launches and 2,069 of the 2,072
    activities that other traces of it saw, the first ones missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "spin_kernel" not in e.name]


def busy_us(spans) -> float:
    """Microseconds in which the card ran at least one of ``spans``."""
    total, reach = 0.0, float("-inf")
    for _, lo, hi in sorted(spans, key=lambda s: s[1]):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


def main_path_augmented(dev, n: int, seed: int, card: str):
    from repro_torch.api import SenecaServer
    from repro_torch.data.pipeline import DSIPipeline
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.data.synthetic import imagenet_like

    ds = imagenet_like(n=n)
    server = SenecaServer.for_dataset(
        ds, use_ods=False, admission="capacity", eviction="lru",
        device_cache_bytes=int(1.2 * n * ds.augmented_bytes()),
        hbm_split=(0.0, 0.0, 1.0), seed=seed, device=dev)
    sess = server.open_session(batch_size=BATCH)
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       seed=seed)
    tel = server.service.telemetry
    rng = np.random.default_rng(seed)
    try:
        reset_counts()
        results = []
        for epoch in range(2):
            h2d_before = tel.channel_total_bytes("h2d")
            if epoch == 0:
                (ids, secs, picks), spans = traced(lambda: run_epoch(
                    pipe, sess, ds, dev, n // BATCH, rng))
            else:
                ids, secs, picks = run_epoch(pipe, sess, ds, dev,
                                             n // BATCH, rng)
            check(sorted(ids) == list(range(n)),
                  f"epoch {epoch + 1} did not serve every id once")
            check_rows(ds, picks, epoch_seeds=True)
            h2d = tel.channel_total_bytes("h2d") - h2d_before
            results.append((n / secs, h2d))
            print(f"main path augmented, epoch {epoch + 1}"
                  f"{' (traced)' if epoch == 0 else ''}: {n} samples in "
                  f"{secs:.3f} s = {n / secs:.1f} samples/s, h2d bytes "
                  f"{h2d} ({card})", flush=True)
            if epoch == 0:
                device_time("augmented epoch 1", spans, secs, "K1",
                            "decode_augment_kernel",
                            read_counts()["decode_augment"])
        counts = read_counts()
        check(results[1][1] == 0,
              f"the all-HBM epoch moved {results[1][1]} h2d bytes")
        check(counts["decode_augment"] > 0,
              "K1 was not launched on the augmented main path")
        stats = server.stats()
        print(f"main path augmented: launches {counts}, residency "
              f"{stats['residency_counts']}, hbm bytes "
              f"{stats['hbm_bytes_used']}", flush=True)
        return counts
    finally:
        pipe.stop()
        server.close()


def device_time(what: str, spans, secs: float, kernel: str, needle: str,
                launched: int) -> None:
    """``kernel``'s traced launches (names holding ``needle``) and their
    device time in ``what``, a span of ``secs`` host seconds, beside the
    ``launched`` count of its wrapper, and the share of the span in which
    the card ran nothing."""
    if not spans:
        print(f"{what} device time: not measured (the profiler saw no "
              f"device activity)", flush=True)
        return
    ks = [hi - lo for name, lo, hi in spans if needle in name]
    busy = busy_us(spans)
    print(f"{what} device time (torch.profiler): {kernel} {len(ks)} of "
          f"{launched} launches traced, {sum(ks) / 1e3:.4f} ms "
          f"({sum(ks) / max(len(ks), 1):.1f} us each); all {len(spans)} "
          f"kernels and copies busy {busy / 1e3:.3f} ms of the {secs:.3f} s,"
          f" idle {100 * (1 - busy / (secs * 1e6)):.3f}%", flush=True)


def main_path_decoded(dev, n: int, seed: int, card: str):
    from repro_torch.api import SenecaServer
    from repro_torch.data.pipeline import DSIPipeline
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.data.synthetic import imagenet_like
    from repro_torch.kernels.decode.ops import decode_batch

    ds = imagenet_like(n=n)
    server = SenecaServer.for_dataset(
        ds, use_ods=False, admission="capacity", eviction="lru",
        split=(0.0, 1.0, 0.0),
        device_cache_bytes=int(1.2 * n * ds.decoded_bytes()),
        hbm_split=(0.0, 1.0, 0.0), seed=seed, device=dev)
    sess = server.open_session(batch_size=BATCH)
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       seed=seed)
    tel = server.service.telemetry

    def prewarm():
        for lo in range(0, n, BATCH):
            chunk = list(range(lo, min(lo + BATCH, n)))
            rows = decode_batch([ds.encoded(s) for s in chunk], chunk,
                                seed=ds.seed, image_hw=ds.image_hw,
                                device=dev, as_device=True)
            entries = [(s, rows[i].clone(), ds.decoded_bytes())
                       for i, s in enumerate(chunk)]
            check(bool(sess.admit_batch("decoded", entries).all()),
                  "a decoded row was not admitted into the HBM tier")
        torch.cuda.synchronize()

    try:
        reset_counts()
        t0 = time.perf_counter()
        _, spans = traced(prewarm)
        device_time("decoded-hit pre-warm", spans, time.perf_counter() - t0,
                    "K3", "decode_kernel", read_counts()["decode"])
        check(server.stats()["hbm"]["decoded"]["hbm_entries"] == n,
              "not every decoded form is HBM-resident")
        ids, secs, picks = run_epoch(pipe, sess, ds, dev, n // BATCH,
                                     np.random.default_rng(seed + 1))
        counts = read_counts()
        check(sorted(ids) == list(range(n)),
              "the decoded-hit epoch did not serve every id once")
        check_rows(ds, picks, epoch_seeds=False)
        cache_b = tel.channel_total_bytes("cache")
        h2d_b = tel.channel_total_bytes("h2d")
        check(cache_b == 0 and h2d_b == 0,
              f"decoded HBM hits moved {cache_b} cache and {h2d_b} h2d "
              f"bytes")
        check(counts["augment"] > 0 and counts["decode"] > 0,
              "K2 or K3 was not launched on the decoded-hit path")
        print(f"main path decoded hits: {n} samples in {secs:.3f} s = "
              f"{n / secs:.1f} samples/s, cache bytes 0, h2d bytes 0, "
              f"launches {counts} ({card})", flush=True)
        return counts
    finally:
        pipe.stop()
        server.close()


# ----------------------------------------------------------------------
# The serving path: qwen3-8b (dense, K4) and mamba2-1.3b (ssm, K5)
#: qwen3-8b prefill: B prompts of S tokens into a cache of S_MAX
ATTN_B, ATTN_S, ATTN_S_MAX = 4, 1024, 1088
#: mamba2-1.3b forward, and the prefix its decode trajectory checks
SSM_B, SSM_S, SSM_PREFIX = 4, 1024, 64
#: the serving CLI's defaults (``repro_torch.launch.serve``)
SERVE = dict(requests=8, slots=4, prompt_len=12, max_new=16, s_max=128)
#: bf16's unit roundoff (8 significant bits)
BF16_EPS = 2.0 ** -8
#: two logits within this many bf16 ulps of a row's top logit are a near
#: tie.  Random weights give logits of unit scale, so a row's top lies in
#: [4, 8), where an ulp is 2**-5; decode and forward at qwen3-8b's full
#: depth differed by at most 0.0938 there on an H100, 3 ulps.
NEAR_TIE_ULPS = 4


def depth_tolerance(n_layers: int) -> float:
    """Relative RMS difference allowed between two bf16 paths through
    ``n_layers`` layers that round differently (decode's 4-row products
    against forward's 4,096-row ones pick other cuBLAS kernels, which
    sum in another order): each layer adds rounding noise of about one
    unit roundoff relative to the residual stream, independent layers
    add like a random walk, and the bound allows twice that,
    ``2 * 2**-8 * sqrt(n_layers)``.  At the reference's reduced depth
    (2 layers) it is 1.1e-2, the reference's own 1e-2."""
    return 2 * BF16_EPS * float(np.sqrt(n_layers))


def near_tie(want: torch.Tensor) -> torch.Tensor:
    """Per row of ``want``: ``NEAR_TIE_ULPS`` bf16 ulps at its top logit,
    the gap below which another candidate counts as a near tie that
    rounding may break either way."""
    top = want.float().abs().amax(-1, keepdim=True).clamp_min(2.0 ** -126)
    return NEAR_TIE_ULPS * torch.exp2(torch.floor(torch.log2(top)) - 7)


def compare_logits(got: torch.Tensor, want: torch.Tensor):
    """(relative RMS difference, max abs difference, share of rows whose
    argmax agrees with ``want``'s or lies within ``near_tie`` of its top
    logit, share of rows whose argmax agrees exactly)."""
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm())
    err = float((got - want).abs().max())
    top = want.argmax(-1, keepdim=True)
    picked = got.argmax(-1, keepdim=True)
    gap = want.gather(-1, top) - want.gather(-1, picked)
    return (rel, err, float((gap <= near_tie(want)).float().mean()),
            float((picked == top).float().mean()))


def model_kernel_phase(dev, seed: int):
    """K4 and K5 against their plain versions at the exact shapes the
    model phases launch them with, timed beside their bounds.  Launches
    made here are comparisons and do not count."""
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd_k

    rng = np.random.default_rng(seed)
    rows = {}
    # ---- K4 at qwen3-8b's prefill: (4, 1024, 32 | 8, 128) bf16, causal
    cfg = registry.get("qwen3-8b")
    B, S, H, K, hd = ATTN_B, ATTN_S, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dev, torch.bfloat16)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    out = fa.flash_attention(q, k, v, causal=True)
    plain = fa.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    # both compute in float32 and round once to bf16 at the end, so they
    # differ by one bf16 ulp where their float32 sums round apart: at most
    # 2**-7 of the value (atol covers outputs near 0); one ulp is rare, so
    # the relative RMS difference stays well below bf16's unit roundoff.
    # (The reference's 2e-2, tests/test_kernels.py:52, is ~40% of a
    # typical |output| ~ 0.05 here.)
    err = max_abs_err(out, plain)
    rel = float((out.float() - plain.float()).norm() / plain.float().norm())
    check(torch.allclose(out.float(), plain.float(), atol=1e-3,
                         rtol=2.0 ** -7) and rel <= BF16_EPS,
          f"K4 flash_attention differs from its plain version by {err} "
          f"(relative RMS {rel})")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:87",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, True), 5,
                         warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20))
    # each input read once, the output written once; the causal half of
    # the two products (query i sees keys 0..i)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    rows["flash_attention"]["bound_ms"], rows["flash_attention"][
        "bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
    print_row(rows["flash_attention"], f"within 1e-3 + 2**-7 |x| of plain, "
              f"relative RMS {rel:.2e} <= 2**-8")
    del q, k, v, qt, kt, vt, out, plain

    # ---- K5 at mamba2-1.3b's forward: x (4, 1024, 64, 64) bf16, N 128
    cfg = registry.get("mamba2-1.3b")
    s = cfg.ssm
    B, S, nh, P, N = SSM_B, SSM_S, s.expand * cfg.d_model // s.head_dim, \
        s.head_dim, s.d_state
    x = torch.from_numpy(rng.standard_normal((B, S, nh, P), np.float32)
                         ).to(dev, torch.bfloat16)
    dt = F.softplus(torch.from_numpy(
        rng.standard_normal((B, S, nh), np.float32)).to(dev))
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(nh).astype(np.float32) * 0.3).to(dev))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, S, N), np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    chunk = s.chunk
    y, h = ssd_k.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y_p, h_p = ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    # the reference's tolerances (tests/test_kernels.py:89): 5e-2 for
    # the bf16 y, 5e-4 for the float32 state
    err = max(max_abs_err(y, y_p), max_abs_err(h, h_p))
    check(torch.allclose(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
          and torch.allclose(h, h_p, atol=5e-4, rtol=5e-4),
          f"K5 ssd_scan differs from its plain version by {err}")
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:79", max_abs_err=err,
        ms=time_ms(lambda: ssd_k.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk), 20),
        plain_ms=time_ms(lambda: ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                      chunk), 5, warmup=1),
        library_ms=None)              # no single PyTorch call computes it
    nbytes = 2 * (2 * x.numel() + Bm.numel() + Cm.numel()) \
        + 4 * (dt.numel() + A.numel() + h.numel())
    # float32 accuracy on the bf16 tensor cores takes at most twice the
    # float32 operations (a float32 operand as hi + lo bf16 parts)
    flops = ssd_flops(B, S, nh, P, N)
    rows["ssd_scan"]["bound_ms"], rows["ssd_scan"]["bound_by"] = \
        bound(nbytes, 2 * flops, BF16_FLOPS_PER_S)
    print_row(rows["ssd_scan"], "within 5e-2 (y) / 5e-4 (h) of plain")
    print(f"kernel ssd_scan: bound priced at the float32 CUDA-core rate "
          f"(before the tensor-core form) {bound(nbytes, flops)[0]:.4f} ms",
          flush=True)
    return rows


def ssd_flops(B: int, S: int, nh: int, P: int, N: int) -> int:
    """Float32 operations of the SSD scan at the chunk length that needs
    fewest (y and h do not depend on it).  At chunk c, with ``pairs`` the
    (i, j <= i) pairs of all chunks: per batch row the lower triangle of
    C.B^T, shared by every head (ngroups = 1), 2 N per pair; per (batch,
    head) its product with dt*x, 2 P per pair, the chunk states and the
    carried state's contribution to y, 2 P N per row each, and the state
    recurrence, 2 P N per chunk."""
    def at(c: int) -> int:
        nc = -(-S // c)
        pairs = nc * c * (c + 1) // 2
        return B * (2 * pairs * N + nh * (2 * pairs * P + 4 * S * P * N
                                          + 2 * nc * P * N))
    return min(at(c) for c in range(1, S + 1))


def build_model(arch: str, dev, seed: int):
    from repro_torch.configs import registry
    from repro_torch.models.model import build
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = build(registry.get(arch)).init(gen, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"{arch}: {model.n_params():,} parameters in bf16 "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
          f"initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    return model


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_split(fn, label: str) -> None:
    """Device time of one call of ``fn`` by kernel, from
    ``torch.profiler``, and the busy share of its host-clock span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    total = sum(by_name.values())
    if total <= 0:
        print(f"{label} device split: not measured (the profiler saw no "
              f"device time)", flush=True)
        return
    groups = {"flash_attention (K4)": 0.0, "ssd_scan (K5)": 0.0,
              "matmul (cuBLAS)": 0.0, "other": 0.0}
    for name, us in by_name.items():
        if "repro_torch::flash" in name:
            groups["flash_attention (K4)"] += us
        elif "repro_torch::ssd" in name:
            groups["ssd_scan (K5)"] += us
        elif any(t in name.lower() for t in ("gemm", "cutlass", "xmma",
                                              "cublas", "nvjet")):
            groups["matmul (cuBLAS)"] += us
        else:
            groups["other"] += us
    print(f"{label} device split (torch.profiler, one call): "
          f"{total / 1e3:.3f} ms of kernels in {wall_us / 1e3:.3f} ms "
          f"host span, busy {100 * total / wall_us:.1f}%; " + ", ".join(
              f"{g} {us / 1e3:.3f} ms ({100 * us / total:.1f}%)"
              for g, us in groups.items() if us), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {name[:110]}", flush=True)


def serve_phase(model, seed: int, card: str) -> None:
    """The CLI's defaults through ``Server``: every request finishes
    with ``max_new`` tokens inside the vocabulary."""
    from repro_torch.launch.serve import make_requests, serve_requests
    from repro_torch.serve.step import Server
    cfg = model.cfg
    cache = model.init_cache(SERVE["slots"], SERVE["s_max"])
    tok = torch.zeros((SERVE["slots"], 1), dtype=torch.int64,
                      device=model.device)
    device_split(lambda: model.decode_step(cache, tok, SERVE["prompt_len"]),
                 f"{cfg.name} decode step")
    del cache
    server = Server(model, n_slots=SERVE["slots"], s_max=SERVE["s_max"])
    pending = make_requests(SERVE["requests"], SERVE["prompt_len"],
                            cfg.vocab_size, max_new=SERVE["max_new"],
                            seed=seed)
    done, secs = serve_requests(server, pending, verbose=False)
    check(len(done) == SERVE["requests"], f"{cfg.name}: {len(done)} of "
          f"{SERVE['requests']} requests finished")
    for r in done:
        check(len(r.generated) == SERVE["max_new"]
              and all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{cfg.name}: request {r.req_id} generated {r.generated}")
    gen = sum(len(r.generated) for r in done)
    total = gen + SERVE["requests"] * SERVE["prompt_len"]
    print(f"{cfg.name} serving: {SERVE['requests']} requests, {total} "
          f"tokens ({gen} generated) in {secs:.3f} s = {total / secs:.1f} "
          f"tok/s, {server.steps} decode steps, "
          f"{1e3 * secs / server.steps:.2f} ms/step ({card})", flush=True)


def dense_phase(dev, seed: int, card: str) -> int:
    """qwen3-8b at full width; returns K4's launches in one prefill."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.serve.step import Request, Server
    model = build_model("qwen3-8b", dev, seed)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ATTN_B, ATTN_S))).to(dev)
    cache = model.init_cache(ATTN_B, ATTN_S_MAX)
    reset_counts()
    (logits_pf, cache), secs = synced_seconds(
        lambda: model.prefill({"tokens": tokens}, cache))
    launches = read_counts()["flash_attention"]
    check(launches == cfg.n_layers,
          f"K4 launched {launches} times in one prefill, expected "
          f"{cfg.n_layers}")
    print(f"qwen3-8b prefill: {ATTN_B} x {ATTN_S} tokens in {secs:.3f} s = "
          f"{ATTN_B * ATTN_S / secs:.1f} tok/s, K4 launches {launches} "
          f"({card})", flush=True)
    (full, _), secs = synced_seconds(lambda: model({"tokens": tokens}))
    check(torch.equal(logits_pf, full), "prefill logits differ from forward")
    check(bool(torch.isfinite(full).all()), "forward logits are not finite")
    print(f"qwen3-8b forward: {secs:.3f} s; prefill logits equal forward's "
          f"(torch.equal)", flush=True)
    del full, logits_pf
    device_split(lambda: model.prefill({"tokens": tokens},
                                       model.init_cache(ATTN_B, ATTN_S_MAX)),
                 "qwen3-8b prefill")
    # decode at index S against forward on the extended sequence
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ATTN_B, 1))
                           ).to(dev)
    dec, _ = model.decode_step(cache, nxt, ATTN_S)
    ext, _ = model({"tokens": torch.cat([tokens, nxt], dim=1)})
    tol = depth_tolerance(cfg.n_layers)
    rel, err, agree, exact = compare_logits(dec[:, 0], ext[:, -1])
    check(rel <= tol and agree == 1.0,
          f"decode at index {ATTN_S} differs from forward: relative RMS "
          f"{rel} (tolerance {tol}), argmax agreement {agree} (near ties "
          f"of {NEAR_TIE_ULPS} bf16 ulps included)")
    top = float(ext[:, -1].float().abs().amax())
    print(f"qwen3-8b decode at index {ATTN_S} vs forward on {ATTN_S + 1} "
          f"tokens: relative RMS {rel:.5f} (tolerance {tol:.5f}), max abs "
          f"{err:.4f} (largest |logit| {top:.4f}), argmax agreement "
          f"{agree:.2f} with near ties of {NEAR_TIE_ULPS} ulps, {exact:.2f} "
          f"exact", flush=True)
    del cache, dec, ext
    torch.cuda.empty_cache()

    serve_phase(model, seed, card)
    # one request alone: its first token is forward's argmax, or a near
    # tie (``near_tie``)
    prompt = rng.integers(0, cfg.vocab_size, SERVE["prompt_len"])
    server = Server(model, n_slots=1, s_max=SERVE["s_max"])
    req = Request(0, prompt, max_new=1)
    server.add_request(req)
    server.decode_round()
    lg, _ = model({"tokens": torch.from_numpy(prompt)[None].to(dev)})
    row = lg[0, -1, :cfg.vocab_size].float()
    best, got = int(row.argmax()), req.generated[0]
    gap = float(row[best] - row[got])
    check(got == best or gap <= float(near_tie(row)),
          f"served token {got} is not forward's argmax {best} (gap {gap})")
    print(f"qwen3-8b one request: first token {got}, forward's argmax "
          f"{best} (logit gap {gap:.4f})", flush=True)
    del model, server, lg
    torch.cuda.empty_cache()
    return launches


def ssm_trajectory(model, prefix: torch.Tensor):
    """``compare_logits`` of token-by-token decode from zero state
    against forward on ``prefix``, plus the plain argmax agreement."""
    full, _ = model({"tokens": prefix})
    cache = model.init_cache(*prefix.shape)
    outs = []
    for t in range(prefix.shape[1]):
        lg, cache = model.decode_step(cache, prefix[:, t:t + 1], t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel, err, _, exact = compare_logits(dec, full)
    return rel, err, exact


def ssm_phase(dev, seed: int, card: str) -> int:
    """mamba2-1.3b at full width; returns K5's launches in one forward."""
    model = build_model("mamba2-1.3b", dev, seed)
    cfg = model.cfg
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SSM_B, SSM_S))).to(dev)
    reset_counts()
    (full, _), secs = synced_seconds(lambda: model({"tokens": tokens}))
    launches = read_counts()["ssd_scan"]
    check(launches == cfg.n_layers,
          f"K5 launched {launches} times in one forward, expected "
          f"{cfg.n_layers}")
    check(bool(torch.isfinite(full).all()), "forward logits are not finite")
    print(f"mamba2-1.3b forward: {SSM_B} x {SSM_S} tokens in {secs:.3f} s "
          f"= {SSM_B * SSM_S / secs:.1f} tok/s, K5 launches {launches} "
          f"({card})", flush=True)
    del full
    device_split(lambda: model({"tokens": tokens}), "mamba2-1.3b forward")
    # decode token by token from zero state against forward on a prefix:
    # in bf16 the two drift apart with depth, in the reference as in the
    # port (tests/test_torch_models.py::test_ssm_bf16_decode_drift_is_the_
    # reference_drift), so bf16 is reported and float32 is checked
    prefix = tokens[:, :SSM_PREFIX]
    rel, err, agree = ssm_trajectory(model, prefix)
    print(f"mamba2-1.3b bf16 decode trajectory over {SSM_PREFIX} tokens vs "
          f"forward: relative RMS {rel:.5f}, max abs {err:.4f}, argmax "
          f"agreement {agree:.3f} (reported, not checked)", flush=True)
    serve_phase(model, seed, card)
    model.float()
    rel, err, agree = ssm_trajectory(model, prefix)
    # float32's unit roundoff is 2**-16 of bf16's: the bf16 drift above
    # scaled by that is ~1e-6; 1e-4 leaves room for the kernel's other
    # summation order.  Argmax: the reference's criterion.
    check(rel <= 1e-4 and agree >= 0.9,
          f"float32 decode trajectory differs from forward: relative RMS "
          f"{rel}, argmax agreement {agree}")
    print(f"mamba2-1.3b float32 decode trajectory over {SSM_PREFIX} tokens "
          f"vs forward: relative RMS {rel:.2e} (tolerance 1e-4), max abs "
          f"{err:.2e}, argmax agreement {agree:.3f}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside "
              f"{ROOT / 'chip_smoke.py'}; run it from the root of a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    from repro_torch.kernels.device import build_all, resolve_device
    dev = resolve_device(None)
    torch.manual_seed(args.seed)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"toolchain: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc_version()}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("float32 products in full float32 (allow_tf32 off for matmul "
          "and cuDNN)", flush=True)

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    phase("build (every csrc/*.cu, in parallel)", build_all)
    rows = phase("loader kernels", kernel_phase, dev, args.seed)
    counts = phase("loader main path, augmented", main_path_augmented, dev,
                   N_AUGMENTED, args.seed, card)
    rows["decode_augment"]["launches"] = counts["decode_augment"]
    counts = phase("loader main path, decoded hits", main_path_decoded, dev,
                   N_DECODED, args.seed, card)
    rows["decode"]["launches"] = counts["decode"]
    rows["augment"]["launches"] = counts["augment"]
    rows.update(phase("model kernels", model_kernel_phase, dev, args.seed))
    rows["flash_attention"]["launches"] = phase(
        "serving, qwen3-8b", dense_phase, dev, args.seed, card)
    rows["ssd_scan"]["launches"] = phase(
        "serving, mamba2-1.3b", ssm_phase, dev, args.seed, card)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name in ("decode_augment_bf16", "augment_bf16"):
        r = rows.pop(name)
        print(f"variant {name} (not on the main path): {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
              flush=True)
    kernels = [{k: rows[name][k] for k in keys}
               for name in ("decode_augment", "augment", "decode",
                            "flash_attention", "ssd_scan")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
