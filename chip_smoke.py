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
   then the ODS step on the card: ``TorchOdsBackend`` at ImageNet-1k's
   1,281,167 samples, 3 jobs, batch 256, tiered and tiered + in-flight,
   median ms per ``sample_batch`` beside the "numpy" backend, the share
   of its host-device copies, the ODS invariants on every step; and the
   multi-job workload: 3 jobs, one epoch each through the device
   executor, on one shared cache with the ODS step on the card
   (``server.run_workload`` on a real clock): every id once per job,
   sampled rows equal to a CPU recomputation, K1 launched,
   substitutions > 0, the makespan beside private per-job servers';
   then the sharded data plane: (a) the augmented main path over 4 sim
   shards (HBM tier sized from the router's fullest shard): every id
   once per epoch, sampled rows equal to a CPU recomputation, K1 once
   per batch of the cold epoch (traced, as the unsharded one), the
   all-HBM epoch served as CUDA tensors from the shards' tiers with 0
   h2d bytes, samples/s beside the unsharded run's; (b) 2 process
   shards, each with its HBM tier in a CUDA context of its own: a client
   with the dataset ingests every id through the shards' host produce
   path (rows equal a CPU recomputation), then the server's own process
   shards (``for_dataset(..., shard_transport="process")``) under the
   device executor: a cold epoch whose K1 rows are shipped into the
   shards' HBM tiers, every decoded form admitted through the session,
   and an epoch whose host copies are uploaded (h2d bytes equal the
   shipped rows' bytes) and whose decoded hits run through K2; (c) two
   jobs on 2 sim shards with the ODS step on
   the card, shard 1 killed and restarted mid-run: every id once per
   job, the dead shard's ids IN_STORAGE in the ODS tables, one kill and
   one restart counted, failovers > 0;
5. model kernel phase: K4 flash attention at qwen3-8b's prefill shapes
   and K5 SSD scan at mamba2-1.3b's forward shapes (both on the tensor
   cores in bf16), each against its plain version on the card, timed
   with the L2 flushed beside its bound and (K4) beside
   ``scaled_dot_product_attention`` as a yardstick the port never calls;
   K4's backward likewise (float32 at a ragged S through the CUDA-core
   form, checked; bf16 at K4's shape through the tensor-core kernels,
   checked, bitwise repeatable and timed beside
   ``scaled_dot_product_attention``'s backward, with each pass's device
   time from ``torch.profiler`` and a check that each bf16 kernel's SASS
   holds HGMMA, from ``cuobjdump -sass``); K4 and its backward again at
   vit-huge's training shape, (256, 197, 16 | 16, 80) bf16, non-causal,
   and at deepseek-moe-16b's prefill shape, (4, 1024, 16 | 16, 128) bf16,
   causal, with the same checks and yardsticks; K5's backward likewise
   (float32 at a ragged S with the final state's gradient, checked; bf16
   at mamba2-1.3b's training shape, each gradient within a relative RMS
   of its plain version, bitwise repeatable, timed, each of its six
   launches' device time from ``torch.profiler``);
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
8. training path: qwen3-8b at its published widths and full depth
   (random bf16 weights from ``--seed``), ``TRAIN_STEPS`` steps of 2 x
   1024 tokens on one fixed batch through ``launch.train.train_steps``
   with block remat and int8 AdamW moments: the loss finite and falling,
   every layer's attention weights with finite non-zero gradients at
   every step, K4 launched 2 x 36 times and its backward 36 times per
   step; step time, tokens/s and peak memory printed; then mamba2-1.3b
   likewise (the qwen3-8b model freed first), 4 x 1024 tokens per step,
   every layer's wx, wB, wC, wdt, A_log, dt_bias and conv weights with
   finite non-zero gradients at every step, K5 launched 2 x 48 times
   and its backward 48 times per step;
9. training path, vit-huge at its published widths and full depth: (a)
   ``TRAIN_STEPS`` steps on one fixed batch, the first batch of the
   loader's device route (``imagenet_like(N_VIT)``) through
   ``launch.train.patch_batch``, checked as the other training runs
   (K4 launched 2 x 32 times and its backward 32 times per step); (b)
   two epochs of the loader's device route as the augmented main path
   sets it up (n = ``N_VIT``), each batch through ``patch_batch`` and the
   train step: every id once per epoch, sampled rows equal to a CPU
   recomputation, K1 once per batch of the cold epoch, 0 h2d bytes in
   the all-HBM epoch, the loss finite at every step, K4's launches as in
   (a); per epoch the loader's and the step's seconds, images/s, the
   loader's share and the card's idle share over ``VIT_TRACED_STEPS``
   steps traced by ``torch.profiler``;
10. the moe family, deepseek-moe-16b at its published widths (random
    bf16 weights from ``--seed``): (a) serving at full depth (28 layers,
    16.88 B parameters): ``Model.prefill`` of 4 x 1024 tokens (K4 once
    per layer, logits equal to forward's, the assignments the capacity
    dropped per layer printed), the device split of one prefill; at
    capacity factor ``MOE_DECODE_FACTOR`` (nothing dropped) decode at
    index 64 against forward on the extended prefix within
    ``depth_tolerance``, with forward's experts and with its own (forward
    given them too), its own router decisions held against forward's
    on the same hidden states by ``flips_check`` (two planted wrong
    routers must fail it), and one request alone, served both ways,
    whose first token is forward's argmax; then the ``Server``
    defaults; (b) ``train_phase`` at ``MOE_TRAIN_LAYERS`` = 14
    layers (8.65 B parameters): every layer's attention, router, expert
    and shared-expert weights with finite non-zero gradients at every
    step, K4 launched 2 x 14 times and its backward 14 times per step;
11. the kernel JSON line, the card line, and the result line
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
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
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
#: the ODS step at ImageNet-1k's size: jobs, timed steps per variant
N_ODS = 1_281_167
ODS_JOBS = 3
ODS_STEPS = 20
#: the multi-job workload: samples, job arrivals (s), HBM tier as a
#: share of the augmented set, DRAM cache as a share of it
N_WORKLOAD = 16_384
WORKLOAD_ARRIVALS = (0.0, 1.0, 2.0)
WORKLOAD_HBM_FRAC = 0.5
WORKLOAD_DRAM_FRAC = 0.1
#: the sharded data plane: (a) sim shards over the augmented main path,
#: (b) process shards: an ingest through their host produce path, then
#: the server's own under the device executor, (c) a shard kill
#: under two jobs paced at KILL_RATE samples/s each (so the run lasts at
#: least N_KILL / KILL_RATE seconds and the restart lands inside it)
N_SHARDED_SIM, SIM_SHARDS = 16_384, 4
N_SHARDED_PROCESS, PROCESS_SHARDS = 2_048, 2
N_KILL, KILL_SHARDS, KILL_RATE = 4_096, 2, 1024.0


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
            "flash_attention_bwd": fa.flash_attention_backward,
            "ssd_scan": ssd_k.ssd_scan,
            "ssd_scan_bwd": ssd_k.ssd_scan_backward}


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


def device_route(dev, n: int, seed: int):
    """The loader's device route over ``imagenet_like(n)``: no ODS,
    capacity admission, LRU, an HBM tier of 1.2x the augmented set, the
    device executor at batch ``BATCH``.  Returns (ds, server, session,
    pipeline)."""
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
    return ds, server, sess, pipe


def main_path_augmented(dev, n: int, seed: int, card: str):
    ds, server, sess, pipe = device_route(dev, n, seed)
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
        return counts, [rate for rate, _ in results]
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
# The ODS step on the card, and concurrent jobs on one shared cache
def ods_scores(status, seen, requested, residency, inflight):
    """Each sample's candidate score as the reference's ODS step scores
    it (0 = no candidate), and the direct-hit mask of ``requested``."""
    cached = status != 0
    direct = cached[requested] & ~seen[requested]
    in_batch = np.zeros(len(status), bool)
    in_batch[requested[direct]] = True
    free = ~seen & ~in_batch
    if residency is None:
        score = np.where(free & cached, 2, 0)
    else:
        score = np.select([free & cached & (residency >= 3),
                           free & cached & (residency == 2),
                           free & cached & (residency < 2)], [4, 3, 2], 0)
    score = np.where(free & ~cached, 1, score)
    if inflight is not None:
        score = np.where(inflight & (score > 0), 2 * score - 1, 2 * score)
    return score, direct


def check_ods_step(pre_status, pre_seen, served, requested, residency,
                   inflight, batch) -> None:
    """The ODS invariants of one step: unique unseen ids, direct hits in
    their slots, every substitute from the best class with a free
    candidate (the rollover clears ``seen`` first)."""
    N, B = len(pre_status), len(requested)
    if N - served < B:
        pre_seen = np.zeros_like(pre_seen)
    score, direct = ods_scores(pre_status, pre_seen, requested, residency,
                               inflight)
    check(len(np.unique(batch)) == B, "ODS batch holds a duplicate id")
    check(not pre_seen[batch].any(), "ODS served an id seen this epoch")
    check(np.array_equal(batch[direct], requested[direct]),
          "ODS moved a direct hit out of its slot")
    subs = batch[~direct]
    if len(subs):
        taken = np.zeros(N, bool)
        taken[subs] = True
        left = score[(score > 0) & ~taken]
        check(bool((score[subs] > 0).all())
              and (not len(left) or score[subs].min() >= left.max()),
              "an ODS substitute is not from the best free class")


def ods_phase(dev, seed: int, card: str) -> None:
    """``TorchOdsBackend`` at ImageNet-1k's 1,281,167 samples with 3 jobs
    and batch 256: half the ids cached across the three forms, a
    residency vector (the tiered variant) and then a random in-flight
    mask (tiered + in-flight).  Median ms per ``sample_batch`` on the
    card beside the "numpy" backend on the host, the copies' share of
    the card's step, and the invariants on every step."""
    from repro_torch.api import NumpyOdsBackend, TorchOdsBackend
    from repro_torch.core import ods_torch

    N, B = N_ODS, BATCH
    rng = np.random.default_rng(seed)
    cached = rng.choice(N, N // 2, replace=False)
    forms = rng.integers(1, 4, len(cached))
    status = np.zeros(N, np.uint8)
    status[cached] = forms
    residency = np.zeros(N, np.uint8)
    residency[cached] = rng.integers(1, 4, len(cached))
    inflight = rng.random(N) < 0.05
    backends = {"torch": TorchOdsBackend(N, seed=seed, device=dev),
                "numpy": NumpyOdsBackend(N, seed=seed)}
    for be in backends.values():
        for job in range(ODS_JOBS):
            be.register_job(job)
        for form in (1, 2, 3):
            be.mark_cached(cached[forms == form], form)
        be.set_residency(residency)
    core_devices = set()
    core = ods_torch._substitute_core

    def spy(state, *args, **kwargs):
        core_devices.add(state.status.device.type)
        return core(state, *args, **kwargs)

    ods_torch._substitute_core = spy
    ms = {}
    # first use of each device op (allocator growth, sort set-up) stays
    # out of the timed steps
    for i in range(5):
        backends["torch"].sample_batch(i % ODS_JOBS,
                                       rng.choice(N, B, replace=False),
                                       evict_threshold=ODS_JOBS)
    try:
        for variant, mask in (("tiered", None),
                              ("tiered+inflight", inflight)):
            for name, be in backends.items():
                be.set_inflight(mask)
                times = []
                for i in range(ODS_STEPS + 2):
                    job = i % ODS_JOBS
                    req = rng.choice(N, B, replace=False)
                    if name == "torch":
                        pre = (be.status.copy(), be.seen[job].copy(),
                               be.served[job])
                    t0 = time.perf_counter()
                    batch, _ = be.sample_batch(job, req,
                                               evict_threshold=ODS_JOBS)
                    dt = time.perf_counter() - t0
                    if i >= 2:                     # two warm-up steps
                        times.append(dt * 1e3)
                    if name == "torch":
                        check_ods_step(*pre, req, residency, mask, batch)
                ms[(variant, name)] = float(np.median(times))
    finally:
        ods_torch._substitute_core = core
    check(core_devices == {dev.type},
          f"the ODS core ran on {core_devices}, not on {dev.type}")
    be = backends["torch"]
    check(be.generator.device.type == dev.type,
          "the ODS generator is not on the card")
    # the copies alone: the step's uploads (status, refcount, seen,
    # residency, in-flight mask, request) and downloads (status,
    # refcount, seen, evict mask, batch), on the backend's stream
    req64 = rng.choice(N, B, replace=False).astype(np.int64)

    def copies():
        with torch.cuda.stream(be._stream):
            up = [torch.from_numpy(a).to(dev)
                  for a in (be.status, be.refcount, be.seen[0], residency,
                            inflight, req64)]
            for t in (up[0], up[1], up[2], up[4], up[5]):
                t.cpu()

    copy_times = []
    for i in range(ODS_STEPS + 2):
        t0 = time.perf_counter()
        copies()
        if i >= 2:
            copy_times.append((time.perf_counter() - t0) * 1e3)
    copy_ms = float(np.median(copy_times))
    step_ms = ms[("tiered+inflight", "torch")]
    moved = 2 * (N * (1 + 4 + 1) + N) + N + B * 16
    for variant in ("tiered", "tiered+inflight"):
        card_ms, host_ms = ms[(variant, "torch")], ms[(variant, "numpy")]
        print(f"ods step {variant}, N {N:,}, {ODS_JOBS} jobs, batch {B}: "
              f"card {card_ms:.3f} ms, host numpy {host_ms:.3f} ms per "
              f"sample_batch (median of {ODS_STEPS}; host clock), "
              f"invariants held on every step ({card})", flush=True)
    print(f"ods step copies alone: {copy_ms:.3f} ms for {moved / 1e6:.2f} "
          f"MB both ways, {100 * copy_ms / step_ms:.1f}% of the "
          f"tiered+inflight step; substitutions {be.substitutions}, "
          f"hit rate {be.hit_rate():.4f}; core tensors on "
          f"{sorted(core_devices)}", flush=True)


def picking_pacer(pacer_cls, picks, rng, p: float):
    """A subclass of the workload runner's ingest pacer that keeps about
    a share ``p`` of the batches it paces for ``check_rows``."""
    lock = threading.Lock()

    class PickingPacer(pacer_cls):
        def __call__(self, batch):
            with lock:
                if rng.random() < p:
                    slot = int(rng.integers(0, len(batch["ids"])))
                    picks.append((batch["images"], slot,
                                  int(batch["ids"][slot]), 0))
            super().__call__(batch)

    return PickingPacer


def workload_setup(dev, seed: int, n: int):
    """The multi-job configuration: the dataset, the trace, a factory of
    the shared server (``backend`` selects its ODS engine) and one of
    the private per-job servers."""
    from repro_torch.api import JobSpec, SenecaServer
    from repro_torch.data.synthetic import imagenet_like

    ds = imagenet_like(n=n)
    aug_set = n * ds.augmented_bytes()
    dram = int(WORKLOAD_DRAM_FRAC * aug_set)
    trace = [JobSpec(f"job{i}", arrival_s=a, epochs=1, batch_size=BATCH,
                     executor="device")
             for i, a in enumerate(WORKLOAD_ARRIVALS)]

    def shared(backend: str = "torch"):
        return SenecaServer.for_dataset(
            ds, cache_bytes=dram, split=(0.0, 0.0, 1.0), backend=backend,
            use_ods=True,
            device_cache_bytes=int(WORKLOAD_HBM_FRAC * aug_set),
            hbm_split=(0.0, 0.0, 1.0), seed=seed, device=dev)

    def private(spec):
        return SenecaServer.for_dataset(
            ds, cache_bytes=dram // len(trace), seed=seed, use_ods=False,
            split=(1.0, 0.0, 0.0), eviction="lru", device=dev)

    return ds, trace, shared, private


def workload_phase(dev, seed: int, card: str):
    """Three training jobs on one shared cache: ``imagenet_like``,
    batch 256, ``backend="torch"`` (the ODS step on the card), an HBM
    tier of half the augmented set and a DRAM share for the augmented
    form, each job one epoch through the device executor on a real
    clock, arriving at 0, 1 and 2 s.  Then the same trace on a private
    server per job (the reference benchmark's naive baseline: no ODS,
    encoded-only LRU cache of a third of the DRAM budget each)."""
    import repro_torch.workload.runner as runner_mod
    from repro_torch.api import RealClock
    from repro_torch.data.storage import RemoteStorage

    n = N_WORKLOAD
    ds, trace, shared, private = workload_setup(dev, seed, n)
    server = shared()
    storage = RemoteStorage(ds)
    picks = []
    pacer_cls = runner_mod._IngestPacer
    runner_mod._IngestPacer = picking_pacer(
        pacer_cls, picks, np.random.default_rng(seed), 4 / (n // BATCH))
    try:
        reset_counts()
        res = server.run_workload(trace, storage, clock=RealClock(),
                                  seed=seed, timeout=900,
                                  raise_on_error=False)
        counts = read_counts()
    finally:
        runner_mod._IngestPacer = pacer_cls
    stats = res.stats
    h2d = server.service.telemetry.channel_total_bytes("h2d")
    server.close()
    for j in res.jobs:
        check(j.error is None and not j.cancelled,
              f"{j.spec.name} failed: {j.error}")
        check(sorted(j.sample_ids) == list(range(n)),
              f"{j.spec.name} did not serve every id exactly once")
        print(f"  {j.spec.name}: arrived {j.spec.arrival_s:.1f} s, "
              f"{j.duration_s:.3f} s, {j.samples / j.duration_s:.1f} "
              f"samples/s", flush=True)
    check(len(picks) > 0, "no batch was picked for the row check")
    check_rows(ds, picks, epoch_seeds=False)
    check(counts["decode_augment"] > 0,
          "K1 was not launched on the multi-job path")
    check(stats["substitutions"] > 0, "ODS substituted nothing")
    check(stats["backend"] == "torch", f"backend {stats['backend']}")
    print(f"multi-job shared cache ({len(trace)} jobs, {n} samples, "
          f"batch {BATCH}): makespan {res.makespan:.3f} s, wall "
          f"{res.wall_s:.3f} s, ods_hit_rate {stats['ods_hit_rate']:.4f}, "
          f"substitutions {stats['substitutions']}, h2d bytes {h2d}, hbm "
          f"bytes {stats.get('hbm_bytes_used')}, launches K1 "
          f"{counts['decode_augment']} K2 {counts['augment']}, "
          f"{len(picks)} rows equal a CPU recomputation ({card})",
          flush=True)
    # every storage fetch beyond the foreground's misses is a background
    # refill, which decodes and augments on the host
    print(f"multi-job shared cache: storage fetches {storage.fetches} "
          f"({stats['misses']} foreground misses, so about "
          f"{storage.fetches - stats['misses']} background refills), "
          f"refill errors {stats['refill_errors']}", flush=True)

    storage = RemoteStorage(ds)
    runner = runner_mod.WorkloadRunner(
        server_factory=private, storage=storage, clock=RealClock(),
        seed=seed, record_ids=False)
    priv = runner.run(trace, timeout=900)
    print(f"multi-job private caches (naive, one server per job): "
          f"makespan {priv.makespan:.3f} s (shared {res.makespan:.3f} s), "
          f"storage fetches {storage.fetches}, "
          + ", ".join(f"{j.spec.name} {j.duration_s:.3f} s"
                      for j in priv.jobs) + f" ({card})", flush=True)
    return counts


# ----------------------------------------------------------------------
# The sharded data plane: sim shards, process shards, a shard kill
def recording_lookups(sess, seen):
    """Wrap ``sess.lookup_tiered`` to append each answer's (form, tier,
    value's device or type) to ``seen``."""
    lookup = sess.lookup_tiered

    def record(sid):
        form, value, tier = lookup(sid)
        seen.append((form, tier, value.device.type
                     if isinstance(value, torch.Tensor)
                     else type(value).__name__))
        return form, value, tier

    sess.lookup_tiered = record


def sharded_sim_part(dev, seed: int, card: str, unsharded):
    """(a) The augmented main path over ``SIM_SHARDS`` sim shards: the
    HBM tier, split evenly per shard, sized for the router's fullest
    shard; a cold epoch through K1, traced as the unsharded cold epoch
    is, and an all-HBM epoch whose rows are the shards' CUDA tensors."""
    from repro_torch.api import SenecaServer, ShardRouter
    from repro_torch.data.pipeline import DSIPipeline
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.data.synthetic import imagenet_like

    n = N_SHARDED_SIM
    ds = imagenet_like(n=n)
    load = ShardRouter(SIM_SHARDS, 64, seed).load(np.arange(n))
    server = SenecaServer.for_dataset(
        ds, use_ods=False, admission="capacity", eviction="lru",
        device_cache_bytes=int(1.2 * n * ds.augmented_bytes()
                               * load.max() / load.mean()),
        hbm_split=(0.0, 0.0, 1.0), shards=SIM_SHARDS, seed=seed,
        device=dev)
    sess = server.open_session(batch_size=BATCH)
    pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                       seed=seed)
    tel = server.service.telemetry
    rng = np.random.default_rng(seed + 2)
    rates, launches = [], {}
    try:
        for epoch in range(2):
            reset_counts()
            seen = []
            if epoch == 1:
                recording_lookups(sess, seen)
            h2d_before = tel.channel_total_bytes("h2d")
            if epoch == 0:
                # traced as the unsharded cold epoch is, so the two
                # compare under the same instrumentation
                (ids, secs, picks), spans = traced(lambda: run_epoch(
                    pipe, sess, ds, dev, n // BATCH, rng))
            else:
                ids, secs, picks = run_epoch(pipe, sess, ds, dev,
                                             n // BATCH, rng)
            counts = read_counts()
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            check(sorted(ids) == list(range(n)),
                  f"sharded epoch {epoch + 1} did not serve every id once")
            check_rows(ds, picks, epoch_seeds=True)
            h2d = tel.channel_total_bytes("h2d") - h2d_before
            rates.append(n / secs)
            print(f"sharded sim x{SIM_SHARDS}, epoch {epoch + 1}"
                  f"{' (traced)' if epoch == 0 else ''}: {n} samples in "
                  f"{secs:.3f} s = {n / secs:.1f} samples/s (unsharded "
                  f"{unsharded[epoch]:.1f}{', traced' if epoch == 0 else ''}"
                  f"), h2d bytes {h2d}, K1 launches "
                  f"{counts['decode_augment']} ({card})", flush=True)
            if epoch == 0:
                device_time("sharded sim epoch 1", spans, secs, "K1",
                            "decode_augment_kernel",
                            counts["decode_augment"])
                check(counts["decode_augment"] == n // BATCH,
                      f"K1 launched {counts['decode_augment']} times in "
                      f"the cold sharded epoch, not {n // BATCH}")
            else:
                check(h2d == 0, f"the sharded all-HBM epoch moved {h2d} "
                                f"h2d bytes")
                bad = [s for s in seen
                       if s != ("augmented", "hbm", dev.type)]
                check(len(seen) == n and not bad,
                      f"{len(bad)} of {len(seen)} epoch-2 rows were not "
                      f"{dev.type} tensors from a shard's HBM tier: "
                      f"{bad[:3]}")
        shards = server.stats()["shards"]
        used = [s["hbm_bytes_used"] for s in shards]
        check(all(u > 0 for u in used)
              and sum(used) == n * ds.augmented_bytes(),
              f"per-shard hbm bytes {used} do not hold the {n} rows")
        check(all(s["hbm_device"].startswith(dev.type) for s in shards),
              f"shard HBM tiers on {[s['hbm_device'] for s in shards]}")
        print(f"sharded sim: router load {load.tolist()} (max/mean "
              f"{load.max() / load.mean():.4f}), hbm bytes per shard "
              f"{used}, lookups per shard "
              f"{[s['hits'] + s['misses'] for s in shards]}", flush=True)
        return launches, rates
    finally:
        pipe.stop()
        server.close()


def process_ingest(dev, seed: int, card: str, ds, sizes):
    """(b), first half: the shards' host produce path.  A client built
    with the dataset starts ``PROCESS_SHARDS`` process shards (HBM tiers
    on ``dev`` in their own CUDA contexts) and ingests every id; sampled
    payloads equal a CPU recomputation of the ``produce_seed``-seeded
    host decode + augment."""
    from repro_torch.api import ShardedCache
    from repro_torch.service.shard import produce_seed

    n = ds.n_samples
    t0 = time.perf_counter()
    cache = ShardedCache(
        sizes["cache_bytes"], sizes["split"],
        hbm_bytes=sizes["device_cache_bytes"], hbm_split=sizes["hbm_split"],
        shards=PROCESS_SHARDS, transport="process", seed=seed, dataset=ds,
        device=dev)
    start_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        check(cache.ingest(np.arange(n), epoch_tag=0) == n,
              "ingest did not produce every id")
        ingest_s = time.perf_counter() - t0
        shards = cache.shard_stats()
        check(all(s["hbm_device"].startswith(dev.type)
                  and s["hbm_bytes_used"] > 0 for s in shards),
              f"ingesting shards report hbm "
              f"{[(s['hbm_device'], s['hbm_bytes_used']) for s in shards]}")
        for sid in np.random.default_rng(seed + 3).choice(n, 4,
                                                          replace=False):
            got = np.asarray(cache.produce(int(sid), epoch_tag=0))
            check(np.array_equal(got, expected_row(
                      ds, int(sid), produce_seed(0, int(sid)))),
                  f"ingested row of sample {sid} equals no CPU "
                  f"recomputation")
    finally:
        cache.close()
    print(f"sharded process x{PROCESS_SHARDS}, ingest: start {start_s:.3f} "
          f"s, {n} samples in {ingest_s:.3f} s = {n / ingest_s:.1f} "
          f"samples/s, hbm on {sorted({s['hbm_device'] for s in shards})} "
          f"({card})", flush=True)


def sharded_process_part(dev, seed: int, card: str):
    """(b) ``PROCESS_SHARDS`` process shards.  After the ingest
    (``process_ingest``), the server's own process shards
    (``SenecaServer.for_dataset(..., shard_transport="process")``) under
    the device executor: a cold epoch through K1 whose admitted CUDA rows
    are brought down, shipped and uploaded into the shards' HBM tiers;
    the decoded form of every id admitted through the session; then an
    epoch whose hits arrive as host copies, are uploaded and metered on
    "h2d", and whose decoded hits run through K2."""
    from repro_torch.api import SenecaServer
    from repro_torch.data.pipeline import DSIPipeline
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.data.synthetic import imagenet_like

    n = N_SHARDED_PROCESS
    ds = imagenet_like(n=n)
    aug, dec = ds.augmented_bytes(), ds.decoded_bytes()
    # both forms get a DRAM and an HBM share (a form with no DRAM share
    # never admits into its empty HBM tier); about half the augmented
    # rows fit, every decoded one does
    sizes = dict(cache_bytes=int(0.25 * n * aug + 1.2 * n * dec),
                 split=(0.0, 0.6, 0.4),
                 device_cache_bytes=int(0.25 * n * aug + 0.6 * n * dec),
                 hbm_split=(0.0, 0.5, 0.5))
    process_ingest(dev, seed, card, ds, sizes)
    t0 = time.perf_counter()
    server = SenecaServer.for_dataset(
        ds, use_ods=False, admission="capacity", eviction="lru",
        shards=PROCESS_SHARDS, shard_transport="process", seed=seed,
        device=dev, **sizes)
    start_s = time.perf_counter() - t0
    pipe = None
    try:
        sess = server.open_session(batch_size=BATCH)
        pipe = DSIPipeline(sess, RemoteStorage(ds), executor="device",
                           seed=seed)
        tel = server.service.telemetry
        rng = np.random.default_rng(seed + 4)
        reset_counts()
        ids, cold_s, picks = run_epoch(pipe, sess, ds, dev, n // BATCH, rng)
        cold = read_counts()
        check(sorted(ids) == list(range(n)),
              "the cold process-shard epoch did not serve every id once")
        check(cold["decode_augment"] == n // BATCH,
              f"K1 launched {cold['decode_augment']} times in the cold "
              f"process-shard epoch, not {n // BATCH}")
        check_rows(ds, picks, epoch_seeds=True)
        shards = server.stats()["shards"]
        check(all(s["hbm_device"].startswith(dev.type)
                  and s["hbm_bytes_used"] > 0 for s in shards),
              f"the server's process shards report hbm "
              f"{[(s['hbm_device'], s['hbm_bytes_used']) for s in shards]}"
              f" after the cold epoch")
        cold_hbm = [s["hbm_bytes_used"] for s in shards]
        t0 = time.perf_counter()
        for lo in range(0, n, BATCH):
            entries = [(s, ds.decode(ds.encoded(s), s), dec)
                       for s in range(lo, min(lo + BATCH, n))]
            check(bool(sess.admit_batch("decoded", entries).all()),
                  "a decoded form was not admitted by the process shards")
        admit_s = time.perf_counter() - t0
        before = dict(tel.snapshot().serve_counts)
        h2d_before = tel.channel_total_bytes("h2d")
        seen = []
        recording_lookups(sess, seen)
        reset_counts()
        ids, secs, picks = run_epoch(pipe, sess, ds, dev, n // BATCH, rng)
        counts = read_counts()
        check(sorted(ids) == list(range(n)),
              "the process-shard epoch did not serve every id once")
        check_rows(ds, picks, epoch_seeds=True)
        served = {k: v - before.get(k, 0)
                  for k, v in tel.snapshot().serve_counts.items()}
        shipped = served["augmented"] * aug + served["decoded"] * dec
        h2d = tel.channel_total_bytes("h2d") - h2d_before
        check(counts["augment"] > 0 and served["decoded"] > 0,
              f"decoded hits {served['decoded']}, K2 launches "
              f"{counts['augment']}")
        check(h2d == shipped > 0,
              f"h2d bytes {h2d}, shipped rows' bytes {shipped}")
        check(all(v != "cuda" for _f, _t, v in seen),
              "a process shard's value arrived as a CUDA tensor")
        hbm_hits = sum(1 for _f, t, _v in seen if t == "hbm")
        print(f"sharded process x{PROCESS_SHARDS}, server: start "
              f"{start_s:.3f} s; cold epoch {n} samples in {cold_s:.3f} s = "
              f"{n / cold_s:.1f} samples/s, K1 {cold['decode_augment']} "
              f"launches, hbm bytes per shard {cold_hbm} on "
              f"{sorted({s['hbm_device'] for s in shards})}; decoded forms "
              f"admitted in {admit_s:.3f} s; epoch {n} samples in "
              f"{secs:.3f} s = {n / secs:.1f} samples/s, served augmented "
              f"{served['augmented']} decoded {served['decoded']} storage "
              f"{served.get('storage', 0)} ({hbm_hits} from shard HBM "
              f"tiers, as host copies), h2d bytes {h2d}, launches K1 "
              f"{counts['decode_augment']} K2 {counts['augment']} ({card})",
              flush=True)
        return {k: cold[k] + counts[k] for k in counts}
    finally:
        if pipe is not None:
            pipe.stop()
        server.close()


def shard_kill_part(dev, seed: int, card: str):
    """(c) Two jobs on two sim shards with the ODS step on the card, on a
    real clock; shard 1 is killed a third of the way into the paced run
    and restarted a third later."""
    import repro_torch.workload.runner as runner_mod
    from repro_torch.api import (FaultSpec, JobSpec, RealClock,
                                 SenecaServer)
    from repro_torch.core.ods import IN_STORAGE
    from repro_torch.data.storage import RemoteStorage
    from repro_torch.data.synthetic import imagenet_like

    n = N_KILL
    ds = imagenet_like(n=n)
    aug_set = n * ds.augmented_bytes()
    server = SenecaServer.for_dataset(
        ds, cache_bytes=int(WORKLOAD_DRAM_FRAC * aug_set),
        split=(0.0, 0.0, 1.0), backend="torch", use_ods=True,
        device_cache_bytes=int(WORKLOAD_HBM_FRAC * aug_set),
        hbm_split=(0.0, 0.0, 1.0), shards=KILL_SHARDS, seed=seed,
        device=dev)
    svc = server.service
    owned = np.flatnonzero(
        svc.cache.router.shard_of_many(np.arange(n)) == 1)
    dead_status = []
    fail_shard = svc.fail_shard

    def checked_fail_shard(shard):
        fail_shard(shard)
        dead_status.append(svc.backend.status_of(owned))

    svc.fail_shard = checked_fail_shard
    run_s = n / KILL_RATE
    trace = [JobSpec(f"job{i}", arrival_s=0.25 * i, epochs=1,
                     batch_size=BATCH, gpu_rate=KILL_RATE,
                     executor="device") for i in range(2)]
    faults = [FaultSpec("shard-kill", at_s=run_s / 3, shard=1,
                        duration_s=run_s / 3)]
    picks = []
    pacer_cls = runner_mod._IngestPacer
    runner_mod._IngestPacer = picking_pacer(
        pacer_cls, picks, np.random.default_rng(seed + 5), 4 / (n // BATCH))
    try:
        reset_counts()
        res = server.run_workload(trace, RemoteStorage(ds),
                                  clock=RealClock(), seed=seed, timeout=600,
                                  faults=faults, raise_on_error=False)
        counts = read_counts()
    finally:
        runner_mod._IngestPacer = pacer_cls
        server.close()
    stats = res.stats
    for j in res.jobs:
        check(j.error is None and not j.cancelled,
              f"{j.spec.name} failed: {j.error}")
        check(sorted(j.sample_ids) == list(range(n)),
              f"{j.spec.name} did not serve every id exactly once")
    check(len(picks) > 0, "no batch was picked for the row check")
    check_rows(ds, picks, epoch_seeds=False)
    faults_out = stats.get("faults", {})
    fc = faults_out.get("counts", {})
    check(fc.get("fault.shard-kill") == 1
          and fc.get("recovery.shard-restart") == 1,
          f"fault counts {fc}")
    check(faults_out.get("shard_failovers", 0) > 0, "no shard failover")
    check(len(dead_status) == 1 and len(owned) > 0
          and bool((dead_status[0] == IN_STORAGE).all()),
          "the dead shard's ids do not read IN_STORAGE in the ODS tables")
    check(stats["backend"] == "torch", f"backend {stats['backend']}")
    print(f"shard kill ({len(trace)} jobs x {n} samples on {KILL_SHARDS} "
          f"sim shards, paced at {KILL_RATE:.0f} samples/s, shard 1 "
          f"killed at {run_s / 3:.3f} s for {run_s / 3:.3f} s): makespan "
          f"{res.makespan:.3f} s, "
          + ", ".join(f"{j.spec.name} {j.duration_s:.3f} s"
                      for j in res.jobs)
          + f"; {len(owned)} ids failed over read IN_STORAGE, shard "
          f"failovers {faults_out['shard_failovers']}, counts {fc}, "
          f"ods_hit_rate {stats['ods_hit_rate']:.4f}, launches K1 "
          f"{counts['decode_augment']}, {len(picks)} rows equal a CPU "
          f"recomputation ({card})", flush=True)
    return counts


def sharded_phase(dev, seed: int, card: str, unsharded):
    """The sharded data plane: (a) sim shards, (b) process shards, (c) a
    shard kill.  Returns the K1-K5 launches of its three runs."""
    launches, rates = sharded_sim_part(dev, seed, card, unsharded)
    torch.cuda.empty_cache()
    for counts in (sharded_process_part(dev, seed, card),
                   shard_kill_part(dev, seed, card)):
        for k, v in counts.items():
            launches[k] += v
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# The serving path: qwen3-8b (dense, K4) and mamba2-1.3b (ssm, K5)
#: qwen3-8b prefill: B prompts of S tokens into a cache of S_MAX
ATTN_B, ATTN_S, ATTN_S_MAX = 4, 1024, 1088
#: K4's backward in float32: a short S that is not a multiple of 64
BWD_S_F32 = 200
#: vit-huge trains on the main path's batch of BATCH images: the samples
#: of its loader-fed run (two epochs of N_VIT / BATCH steps; the depth
#: cut from ImageNet-1k's 1.28 M so both fit), and the steps of each
#: epoch traced for the card's idle share
N_VIT = 4_096
VIT_TRACED_STEPS = 4
#: vit-huge's learning rate.  One AdamW step moves every weight by about
#: lr, which over 840 M weights fits the fixed batch of 256 at once from
#: 3e-5 up (loss 7.44 -> 0.46 in two steps at 3e-5, -> 0.0155 in one at
#: 1e-4, and the gradient norm then falls from 12 to below 1e-4); at 3e-6
#: the loss falls ~0.2 a step and the gradients keep their first step's
#: size (scripts/vit_lr_sweep.py on an H100)
VIT_LR = 3e-6
#: the training phase: qwen3-8b at its published widths, TRAIN_B x
#: TRAIN_S tokens, TRAIN_STEPS steps on one fixed batch
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 1024, 4, 3e-4
#: deepseek-moe-16b trains at MOE_TRAIN_LAYERS of its 28 layers: bf16
#: weights and gradients plus int8 moments take ~6.15 bytes per
#: parameter, ~104 GB at full depth and ~53 GB at half.  Its decode check
#: runs on a MOE_PREFIX-token prefix at capacity factor MOE_DECODE_FACTOR,
#: where forward drops no assignment that decode keeps (the reference's
#: own check, tests/test_models.py:84)
MOE_TRAIN_LAYERS = 14
MOE_PREFIX, MOE_DECODE_FACTOR = 64, 100.0
#: decode's router decisions with its own experts against forward's, with
#: forward given decode's experts so that both route the same hidden
#: states up to rounding (``flips_check``): the router's logits are bf16,
#: so a decision near the top-k boundary may flip.  A decision may differ
#: only where forward's logits across the boundary lie within
#: MOE_FLIP_ULPS bf16 ulps of the row's top logit, and at most a share
#: MOE_FLIP_SHARE of decisions may differ.  An H100 (seed 0, 28 layers)
#: read 7 of 112 decode decisions (6.2%) at gaps up to 5.0 ulps, and 17 of
#: 364 (4.7%) up to 3.5 for one request served alone; a router that takes
#: a slot-mate's experts, or drops its best expert for the next one,
#: differed in 112 of 112, at gaps up to 181.25 and 151.0 ulps (the
#: latter none below 19.0).  Against forward's own decisions, whose
#: hidden states drift further once a layer flips, the sound readings
#: were 25% and up to 64 ulps: no limit there parts them from the faults
MOE_FLIP_ULPS, MOE_FLIP_SHARE = 16, 0.2
#: mamba2-1.3b forward, and the prefix its decode trajectory checks
SSM_B, SSM_S, SSM_PREFIX = 4, 1024, 64
#: mamba2-1.3b's training batch (of TRAIN_S tokens)
SSM_TRAIN_B = 4
#: K5's backward in float32: a short S that is not a multiple of 64
SSD_BWD_S_F32 = 300
#: the gradients of K5's backward against its plain version, as a
#: relative RMS by the type each is stored in.  The kernel sums in float32
#: in another order: at most 6.9e-5 (bf16) and 1.7e-6 (float32) on an H100
#: with dt on mamba2's scale (``ssd_bwd_inputs``; 9.9e-5 and 4.9e-5 with
#: dt = softplus(z), where states barely pass between chunks).  A
#: tensor-core form that rounds its float32 operands once to bf16 misses
#: both limits in every gradient, by 4x or more (2.0e-3 to 4.3e-3 in a CPU
#: emulation, tests/test_torch_ssd_scan_grad.py), and once to tf32 in dx,
#: dA, dB and dC; as hi + lo bf16 parts it holds them (at most 1.3e-4)
SSD_BWD_RMS = {torch.bfloat16: 5e-4, torch.float32: 2e-4}
#: the range of mamba2's dt at initialisation (its dt_bias is drawn so
#: that softplus(dt_bias) is log-uniform on it)
SSM_DT_RANGE = (1e-3, 0.1)
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
    from repro_torch.kernels.ssd_scan import kernel as ssd_k

    rng = np.random.default_rng(seed)
    rows = {}
    # ---- K4 and its backward at qwen3-8b's prefill and training shape,
    # (4, 1024, 32 | 8, 128) bf16, causal, then at vit-huge's training
    # shape, (256, 197, 16 | 16, 80) bf16, non-causal
    cfg = registry.get("qwen3-8b")
    rows["flash_attention"], rows["flash_attention_bwd"] = k4_rows(
        dev, rng, "", ATTN_B, ATTN_S, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, causal=True)
    flash_attention_bwd_checks(dev, rng, cfg)
    cfg = registry.get("vit-huge")
    rows["flash_attention_vit"], rows["flash_attention_bwd_vit"] = k4_rows(
        dev, rng, "_vit", BATCH, cfg.frontend_tokens, cfg.n_heads,
        cfg.n_kv_heads, cfg.resolved_head_dim, causal=False)
    # deepseek-moe-16b's prefill shape, (4, 1024, 16 | 16, 128) causal
    # (its training step runs (2, 1024, ...))
    cfg = registry.get("deepseek-moe-16b")
    rows["flash_attention_moe"], rows["flash_attention_bwd_moe"] = k4_rows(
        dev, rng, "_moe", ATTN_B, ATTN_S, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, causal=True)

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
    # float32 accuracy on the bf16 tensor cores: a float32 operand as hi +
    # lo bf16 parts, two products
    rows["ssd_scan"]["bound_ms"], rows["ssd_scan"]["bound_by"] = bound(
        nbytes, ssd_flops(B, S, nh, P, N, 2), BF16_FLOPS_PER_S)
    print_row(rows["ssd_scan"], "within 5e-2 (y) / 5e-4 (h) of plain")
    print(f"kernel ssd_scan: bound priced at the float32 CUDA-core rate "
          f"(before the tensor-core form) "
          f"{bound(nbytes, ssd_flops(B, S, nh, P, N))[0]:.4f} ms", flush=True)
    del x, dt, A, Bm, Cm, y, h, y_p, h_p
    rows["ssd_scan_bwd"] = ssd_scan_bwd_row(dev, rng, B, S, nh, P, N, chunk)
    return rows


def ssd_scan_bwd_row(dev, rng, B, S, nh, P, N, chunk):
    """K5's backward against its plain version: in float32 at a short
    ragged S with the final state's gradient (checked only), then in
    bf16 at mamba2-1.3b's training shape without it, as the model calls
    it (checked, bitwise repeatable, timed, by pass).  Each gradient is
    held to ``SSD_BWD_RMS`` by the type it is stored in; the bf16 call
    must run the six tensor-core passes and none of the CUDA-core
    design's, and each bf16 pass with products must hold HMMA."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k

    def held(got, want, what):
        rel = {}
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and bool(torch.isfinite(g.float()).all()),
                  f"K5 backward {what}: {name} is {g.dtype} {tuple(g.shape)} "
                  f"or not finite")
            rel[name] = float((g.float() - w.float()).norm()
                              / w.float().norm())
        over = [f"{name} {rel[name]} > {SSD_BWD_RMS[g.dtype]}" for name, g
                in zip(rel, got) if rel[name] > SSD_BWD_RMS[g.dtype]]
        check(not over, f"K5 backward {what} differs from its plain version "
              f"by a relative RMS of {rel}: {', '.join(over)}")
        return rel

    args = ssd_bwd_inputs(dev, rng, 2, SSD_BWD_S_F32, nh, P, N,
                          torch.float32)
    dh = torch.from_numpy(rng.standard_normal((2, nh, P, N), np.float32)
                          ).to(dev)
    got = ssd_k.ssd_scan_backward(*args, dh, chunk=chunk)
    again = ssd_k.ssd_scan_backward(*args, dh, chunk=chunk)
    want = ssd_k.ssd_scan_backward_plain(*args, dh, chunk)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K5 backward (float32) gave other bits on a second run")
    rel = held(got, want, f"float32 (2, {SSD_BWD_S_F32}, {nh}, {P}, {N})")
    print(f"kernel ssd_scan_bwd float32 (2, {SSD_BWD_S_F32}, {nh}, {P}, {N}) "
          f"with dh: relative RMS " + ", ".join(
              f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tolerance {SSD_BWD_RMS[torch.float32]}), bitwise equal on a "
          f"second run", flush=True)
    del args, dh, got, again, want

    args = ssd_bwd_inputs(dev, rng, B, S, nh, P, N, torch.bfloat16)
    got = ssd_k.ssd_scan_backward(*args, chunk=chunk)
    again = ssd_k.ssd_scan_backward(*args, chunk=chunk)
    want = ssd_k.ssd_scan_backward_plain(*args, None, chunk)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K5 backward gave other bits on a second run")
    rel = held(got, want, f"bf16 ({B}, {S}, {nh}, {P}, {N})")
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    del got, again, want
    x, dt, A, Bm, Cm, dy = args
    row = dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="none (XLA autodiff of src/repro/models/ssm.py:91 "
                 "_ssd_core)",
        max_abs_err=err,
        ms=time_ms(lambda: ssd_k.ssd_scan_backward(*args, chunk=chunk), 10),
        plain_ms=time_ms(lambda: ssd_k.ssd_scan_backward_plain(
            *args, None, chunk), 3, warmup=1),
        library_ms=None)              # no single PyTorch call computes it
    # x, dy, B, C (bf16), dt and A read once; dx, dB, dC (bf16), ddt and
    # dA written once
    nbytes = 2 * (3 * x.numel() + 4 * Bm.numel()) \
        + 4 * (2 * dt.numel() + 2 * A.numel())
    flops = ssd_bwd_flops(B, S, nh, P, N)
    # float32 accuracy on the bf16 tensor cores: a float32 operand as hi +
    # lo bf16 parts, two products, as for K5
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, ssd_bwd_flops(B, S, nh, P, N, 2), BF16_FLOPS_PER_S)
    print_row(row, "relative RMS " + ", ".join(
        f"{k} {v:.2e}" for k, v in rel.items())
        + f" within {SSD_BWD_RMS[torch.bfloat16]} (bf16) / "
        f"{SSD_BWD_RMS[torch.float32]} (float32) of plain, bitwise equal on "
        f"a second run")
    split = pass_ms(lambda: ssd_k.ssd_scan_backward(*args, chunk=chunk),
                    SSD_BWD_PASSES)
    # late in a long process the profiler may miss some launches (K4's
    # backward's passes read 6-7 of 10 in one run), so every tensor-core
    # pass must be seen and no CUDA-core one
    check(all(split[k][1] for k in SSD_BWD_TC_PASSES)
          and not any(split[k][1] for k in SSD_BWD_CUDA_CORE_PASSES),
          f"K5 backward (bf16): 10 calls did not launch every tensor-core "
          f"pass and no CUDA-core pass (torch.profiler): {split}")
    hmma = sass_count("ssd_scan_bwd", "HMMA", SSD_BWD_PRODUCT_PASSES)
    check(all(n > 0 for n in hmma.values()),
          f"K5 backward: a bf16 product pass's SASS holds no HMMA: {hmma}")
    print(f"kernel ssd_scan_bwd: bound priced at the float32 CUDA-core rate "
          f"{bound(nbytes, flops)[0]:.4f} ms ({flops / 1e9:.2f} GFLOP); by "
          f"pass (torch.profiler, 10 calls): " + ", ".join(
              f"{k.split('::')[-1]} {split[k][0]:.4f} ms (mean of "
              f"{split[k][1]})" for k in SSD_BWD_TC_PASSES)
          + "; CUDA-core passes launched: 0; HMMA in the SASS (cuobjdump): "
          + ", ".join(f"{k} {n}" for k, n in hmma.items()), flush=True)
    return row


def ssd_bwd_inputs(dev, rng, B, S, nh, P, N, dtype):
    """K5's backward's inputs (x, dt, A, Bm, Cm, dy) from ``rng``: x, B
    and C at half scale and dy at unit scale in ``dtype``; dt log-uniform
    on ``SSM_DT_RANGE`` and A = -exp(0.3 z), so that a state decays by
    about e^-1.4 over a 64-row chunk and the chunks pass it on."""
    def t(shape, dt=dtype, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape, np.float32))
                * scale).to(dev, dt)
    lo, hi = np.log(SSM_DT_RANGE)
    dt = torch.from_numpy(np.exp(rng.uniform(lo, hi, (B, S, nh))).astype(
        np.float32)).to(dev)
    return (t((B, S, nh, P), scale=0.5), dt,
            -torch.exp(t((nh,), torch.float32, 0.3)),
            t((B, S, N), scale=0.5), t((B, S, N), scale=0.5),
            t((B, S, nh, P)))


def k4_rows(dev, rng, suffix: str, B: int, S: int, H: int, K: int, hd: int,
            causal: bool):
    """K4 and its backward in bf16 at (B, S, H | K, hd): each against its
    plain version on the same inputs, bitwise repeatable, timed with the
    L2 flushed beside its bound and beside ``scaled_dot_product_attention``
    (forward, and its backward) as a yardstick the port never calls; the
    backward's passes timed by ``torch.profiler``.  Returns the two rows,
    named ``flash_attention`` and ``flash_attention_bwd`` + ``suffix``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa

    where = f"({B}, {S}, {H} | {K}, {hd}), {'' if causal else 'non-'}causal"
    q, k, v, dout = (
        torch.from_numpy(rng.standard_normal(shape, np.float32))
        .to(dev, torch.bfloat16) for shape in ((B, S, H, hd), (B, S, K, hd),
                                               (B, S, K, hd), (B, S, H, hd)))
    out = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    plain = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K4 at {where} gave other bits on a "
          f"second run")
    # both compute in float32 and round once to bf16 at the end, so they
    # differ by one bf16 ulp where their float32 sums round apart: at most
    # 2**-7 of the value (atol covers outputs near 0); one ulp is rare, so
    # the relative RMS difference stays well below bf16's unit roundoff.
    # (The reference's 2e-2, tests/test_kernels.py:52, is ~40% of a
    # typical |output| ~ 0.05 at qwen3-8b's shape.)
    err = max_abs_err(out, plain)
    rel = float((out.float() - plain.float()).norm() / plain.float().norm())
    check(torch.allclose(out.float(), plain.float(), atol=1e-3,
                         rtol=2.0 ** -7) and rel <= BF16_EPS,
          f"K4 at {where} differs from its plain version by {err} "
          f"(relative RMS {rel})")
    del again, plain
    gqa = dict(enable_gqa=True) if H != K else {}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = dict(
        name="flash_attention" + suffix, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:87",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                         5, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **gqa), 20))
    # each input read once, the output written once; the two products
    # over the (query, key) pairs the mask keeps (query i sees keys 0..i
    # under the causal mask, every key without it)
    pairs = S * (S + 1) // 2 if causal else S * S
    size = q.element_size()
    fwd["bound_ms"], fwd["bound_by"] = bound(
        size * (2 * q.numel() + k.numel() + v.numel()),
        4 * B * H * hd * pairs, BF16_FLOPS_PER_S)
    print_row(fwd, f"{where}: within 1e-3 + 2**-7 |x| of plain, relative "
              f"RMS {rel:.2e} <= 2**-8, bitwise equal on a second run")

    args = (q, k, v, out, dout)
    got = fa.flash_attention_backward(*args, causal=causal)
    again = fa.flash_attention_backward(*args, causal=causal)
    want = fa.flash_attention_backward_plain(*args, causal)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K4 backward at {where} gave other bits on a second run")
    # as K4: both round once from float32 to bf16, so they differ by one
    # bf16 ulp where their float32 sums round apart
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    rel = max(float((a.float() - b.float()).norm() / b.float().norm())
              for a, b in zip(got, want))
    check(all(torch.allclose(a.float(), b.float(), atol=1e-3,
                             rtol=2.0 ** -7) for a, b in zip(got, want))
          and rel <= BF16_EPS,
          f"K4 backward at {where} differs from its plain version by {err} "
          f"(relative RMS {rel})")
    del got, again, want
    qt, kt, vt = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             **gqa)
    lib_dout = dout.transpose(1, 2)
    bwd = dict(
        name="flash_attention_bwd" + suffix, route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none (XLA autodiff of src/repro/models/layers.py:109 "
                 "_sdpa and :127 blockwise_attention)",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention_backward(*args, causal=causal),
                   10),
        plain_ms=time_ms(lambda: fa.flash_attention_backward_plain(
            *args, causal), 3, warmup=1),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_dout, retain_graph=True), 20))
    # q, k, v, out and dout read once, dq, dk, dv written once; five
    # products over the kept pairs (Q K^T, dO V^T, P^T dO, dS^T Q, dS K)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        size * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()),
        5 * 2 * B * H * hd * pairs, BF16_FLOPS_PER_S)
    print_row(bwd, f"{where}: within 1e-3 + 2**-7 |x| of plain, relative "
              f"RMS {rel:.2e} <= 2**-8, bitwise equal on a second run")
    split = pass_ms(lambda: fa.flash_attention_backward(*args, causal=causal),
                    BWD_PASSES)
    print(f"kernel flash_attention_bwd{suffix} by pass (torch.profiler, 10 "
          f"calls): " + ("not measured (the profiler saw no device time)"
                         if not any(n for _, n in split.values()) else
                         ", ".join(f"{k} {ms:.4f} ms (mean of {n} launches)"
                                   for k, (ms, n) in split.items())),
          flush=True)
    return fwd, bwd


def flash_attention_bwd_checks(dev, rng, cfg) -> None:
    """K4's backward in float32 at a short ragged S (the CUDA-core form,
    checked against plain), and HGMMA in the SASS of each bf16 kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = 2, BWD_S_F32
    q, k, v, dout = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
        for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                      (B, S, H, hd)))
    args = (q, k, v, fa.flash_attention(q, k, v, causal=True), dout)
    got = fa.flash_attention_backward(*args, causal=True)
    want = fa.flash_attention_backward_plain(*args, True)
    torch.cuda.synchronize()
    # both sum in float32, in other orders: 1e-4 leaves ~50x the
    # differences seen (~2e-6 at gradients of magnitude ~10)
    err32 = max(max_abs_err(a, b) for a, b in zip(got, want))
    check(all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
              for a, b in zip(got, want)),
          f"K4 backward (float32, S={S}) differs from its plain version by "
          f"{err32}")
    print(f"kernel flash_attention_bwd float32 ({B}, {S}, {H} | {K}, {hd}): "
          f"within 1e-4 of plain (max_abs_err {err32})", flush=True)
    hgmma = sass_count("flash_attention_bwd", "HGMMA", BWD_PASSES)
    check(all(n > 0 for n in hgmma.values()),
          f"K4 backward: a bf16 kernel's SASS holds no HGMMA: {hgmma}")
    print("kernel flash_attention_bwd: HGMMA in the SASS (cuobjdump): "
          + ", ".join(f"{k} {n}" for k, n in hgmma.items()), flush=True)


#: the bf16 kernels of K4's backward, one per pass (csrc/flash_attention_bwd.cu)
BWD_PASSES = ("prep_tc_kernel", "dkdv_tc_kernel", "dq_tc_kernel")
#: the six launches of each design of K5's backward (csrc/ssd_scan_bwd.cu):
#: the tensor-core kernels of bf16 inputs, then the CUDA-core kernels of
#: float32 inputs, which a bf16 call must not reach
SSD_BWD_TC_PASSES = tuple(f"ssd_bwd::tc::{k}" for k in (
    "prep_tc_kernel", "pair_tc_kernel", "pass_tc_kernel", "dx_tc_kernel",
    "finish_tc_kernel", "dbc_tc_kernel"))
SSD_BWD_CUDA_CORE_PASSES = tuple(f"ssd_bwd::{k}" for k in (
    "prep_kernel", "pair_kernel", "pass_kernel", "dx_kernel", "dbc_kernel",
    "da_kernel"))
SSD_BWD_PASSES = SSD_BWD_TC_PASSES + SSD_BWD_CUDA_CORE_PASSES
#: the bf16 passes of K5's backward that hold products (mma.sync: HMMA)
SSD_BWD_PRODUCT_PASSES = ("prep_tc_kernel", "pair_tc_kernel",
                          "dx_tc_kernel", "dbc_tc_kernel")


def sass_count(stem: str, opcode: str, kernels) -> dict:
    """Instructions ``opcode`` in the SASS of each of ``kernels`` (all
    instantiations summed) in the built library of ``csrc/<stem>.cu``,
    from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels.device import library
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", library(stem)._name], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts = dict.fromkeys(kernels, 0)
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name = func.split("\n", 1)[0]
        for k in kernels:
            if k in name:
                counts[k] += len(re.findall(rf"\b{opcode}\b", func))
    return counts


def pass_ms(fn, kernels, iters: int = 10) -> dict:
    """Device milliseconds of a launch of each of ``kernels`` over
    ``iters`` calls of ``fn``, from ``torch.profiler``: (mean, launches
    seen) by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = {k: [] for k in kernels}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in kernels:
                if f"{k}<" in e.name or f"{k}(" in e.name:
                    us[k].append(e.time_range.elapsed_us())
    return {k: (float(np.mean(v)) / 1e3 if v else 0.0, len(v))
            for k, v in us.items()}


def ssd_flops(B: int, S: int, nh: int, P: int, N: int,
              f32_cost: int = 1) -> int:
    """Operations of the SSD scan at the chunk length that needs fewest
    (y and h do not depend on it), a product with a float32 operand
    counted ``f32_cost`` times: once on the CUDA cores, twice on the bf16
    tensor cores, whose float32 accuracy takes a float32 operand as hi +
    lo bf16 parts.  At chunk c, with ``pairs`` the (i, j <= i) pairs of
    all chunks: per batch row the lower triangle of C.B^T (bf16 operands),
    shared by every head (ngroups = 1), 2 N per pair; per (batch, head)
    its product with dt*x, 2 P per pair, the chunk states and the carried
    state's contribution to y, 2 P N per row each, and the state
    recurrence, 2 P N per chunk."""
    def at(c: int) -> int:
        nc = -(-S // c)
        pairs = nc * c * (c + 1) // 2
        return B * (2 * pairs * N + f32_cost * nh * (
            2 * pairs * P + 4 * S * P * N + 2 * nc * P * N))
    return min(at(c) for c in range(1, S + 1))


def ssd_bwd_flops(B: int, S: int, nh: int, P: int, N: int,
                  f32_cost: int = 1) -> int:
    """Operations of K5's backward at the chunk length that needs fewest,
    counted as ``ssd_flops`` counts the forward's (``f32_cost`` for a
    product with a float32 operand).  At chunk c, with ``pairs`` the (i,
    j <= i) pairs of all chunks: per batch row C.B^T (bf16 operands) and
    the two products of the head-summed W with B and C, 2 N per pair
    each; per (batch, head) the products g.x^T (bf16 operands) and M^T g,
    2 P per pair each; per row five products of a (P, N) state with a row
    (the chunk state, G B_j, H^T g_i, G^T x_j and exp(cum_i) g_i C_i^T),
    2 P N each, and cum's gradient's inter-chunk term exp(cum_i) C_i.(H^T
    g_i), 2 N, from H^T g_i; per chunk the two state recurrences, forward
    and reverse, 2 P N each."""
    def at(c: int) -> int:
        nc = -(-S // c)
        pairs = nc * c * (c + 1) // 2
        bf16 = 2 * pairs * N + nh * 2 * pairs * P
        f32 = 4 * pairs * N + nh * (2 * pairs * P + 10 * S * P * N
                                    + 2 * S * N + 4 * nc * P * N)
        return B * (bf16 + f32_cost * f32)
    return min(at(c) for c in range(1, S + 1))


def build_model(arch: str, dev, seed: int, n_layers=None):
    """``arch`` at its published widths, random bf16 weights from
    ``seed``, at full depth or ``n_layers``."""
    from repro_torch.configs import registry
    from repro_torch.models.model import build
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = registry.get(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build(cfg).init(gen, torch.bfloat16)
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


def device_split(fn, label: str, dispatch: bool = False) -> None:
    """Device time of one call of ``fn`` by kernel, from
    ``torch.profiler``, and the busy share of its host-clock span.  With
    ``dispatch`` (a moe model) the sort, gather, index and scatter
    kernels form a group of their own, the moe dispatch's with the
    embedding's gather (whose kernels share their names); without it
    they stay in "other", as in the splits of the other families."""
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
    groups = {"flash_attention (K4)": 0.0,
              "flash_attention backward (K4 bwd)": 0.0,
              "ssd_scan (K5)": 0.0, "ssd_scan backward (K5 bwd)": 0.0,
              "matmul (cuBLAS)": 0.0,
              "sort, gather and scatter (moe dispatch, embedding)": 0.0,
              "other": 0.0}
    for name, us in by_name.items():
        if "repro_torch::flash_bwd" in name:
            groups["flash_attention backward (K4 bwd)"] += us
        elif "repro_torch::flash" in name:
            groups["flash_attention (K4)"] += us
        elif "repro_torch::ssd_bwd" in name:
            groups["ssd_scan backward (K5 bwd)"] += us
        elif "repro_torch::ssd" in name:
            groups["ssd_scan (K5)"] += us
        elif any(t in name.lower() for t in ("gemm", "cutlass", "xmma",
                                              "cublas", "nvjet")):
            groups["matmul (cuBLAS)"] += us
        elif dispatch and any(t in name.lower() for t in (
                "sort", "radix", "gather", "index", "scatter",
                "searchsorted", "bincount")):
            groups["sort, gather and scatter (moe dispatch, embedding)"] \
                += us
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
                 f"{cfg.name} decode step", dispatch=cfg.moe is not None)
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
    one_request(model, rng)
    del model
    torch.cuda.empty_cache()
    return launches


def served_first_token(model, prompt, forced=None):
    """One request alone through ``Server`` (``routes(forced)`` around
    it): its first token and the router's records."""
    from repro_torch.serve.step import Request, Server
    server = Server(model, n_slots=1, s_max=SERVE["s_max"])
    req = Request(0, prompt, max_new=1)
    with routes(forced) as seen:
        server.add_request(req)
        server.decode_round()
    return req.generated[0], seen


def first_token_check(name: str, logits: torch.Tensor, got: int,
                      how: str) -> None:
    """``got`` is the argmax of ``logits`` (one row) or a near tie."""
    row = logits.float()
    best = int(row.argmax())
    gap = float(row[best] - row[got])
    check(got == best or gap <= float(near_tie(row)),
          f"{name}: served token {got}{how} is not forward's argmax {best} "
          f"(gap {gap})")
    print(f"{name} one request{how}: first token {got}, forward's argmax "
          f"{best} (logit gap {gap:.4f})", flush=True)


def one_request(model, rng) -> None:
    """One request alone through ``Server``: its first token is
    forward's argmax, or a near tie (``near_tie``), on the sequence the
    server decoded.  That is the prompt and then its last token again:
    the server prefills the prompt through the decode step, and its
    first decode round feeds the prompt's last token at the next position
    (as the reference's, ``repro/serve/step.py:93``).  A moe model is
    served twice: with forward's experts at every position and layer,
    against forward; and with its own, the path users are served, whose
    router decisions must pass ``flips_hold`` against forward's and
    whose token is held against forward given the served experts."""
    cfg = model.cfg
    prompt = rng.integers(0, cfg.vocab_size, SERVE["prompt_len"])
    decoded = np.append(prompt, prompt[-1])
    seq = torch.from_numpy(decoded)[None].to(model.device)
    with routes() as fwd:
        lg, _ = model({"tokens": seq})
    row = lg[0, -1, :cfg.vocab_size]
    if not fwd:                           # the dense family has no router
        got, _ = served_first_token(model, prompt)
        first_token_check(cfg.name, row, got, "")
        return
    n, L = len(decoded), len(fwd)
    # forward's decisions per (position, layer), in the server's call order
    want = [(te[t:t + 1], lt[t:t + 1]) for t in range(n) for te, lt in fwd]
    got, _ = served_first_token(model, prompt, [te for te, _ in want])
    first_token_check(cfg.name, row, got, " with forward's experts")
    got, served = served_first_token(model, prompt)
    print(f"{cfg.name} one request with its own experts against forward's "
          f"(reported): {flips_line(routing_flips(served, want), len(want))}",
          flush=True)
    with routes([torch.cat([served[t * L + l][0] for t in range(n)])
                 for l in range(L)]) as fwd_own:
        lg_own, _ = model({"tokens": seq})
    flips_check(served, [(te[t:t + 1], lt[t:t + 1]) for t in range(n)
                         for te, lt in fwd_own],
                depth_tolerance(cfg.n_layers),
                f"{cfg.name} one request with its own experts against "
                f"forward given them")
    first_token_check(cfg.name, lg_own[0, -1, :cfg.vocab_size], got,
                      " with its own experts (forward given them too)")


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


#: per arch: the training batch and learning rate, the depth (None: the
#: published one), the scan or attention kernel and its backward (names
#: of ``_wrappers``), and the per-layer weights (names within a block)
#: whose gradients reach that kernel (a gradient dropped at the kernel
#: would leave them without one), for moe also the router's, the
#: experts' and the shared experts'
ATTN_WEIGHTS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
TRAIN_RUNS = {
    "qwen3-8b": dict(batch=TRAIN_B, lr=TRAIN_LR, layers=None,
                     kernel="flash_attention", bwd="flash_attention_bwd",
                     weights=ATTN_WEIGHTS),
    "mamba2-1.3b": dict(batch=SSM_TRAIN_B, lr=TRAIN_LR, layers=None,
                        kernel="ssd_scan", bwd="ssd_scan_bwd",
                        weights=tuple(f"ssm.{w}" for w in (
                            "wx", "wB", "wC", "wdt", "A_log", "dt_bias",
                            "conv_x", "conv_B", "conv_C"))),
    "vit-huge": dict(batch=BATCH, lr=VIT_LR, layers=None,
                     kernel="flash_attention", bwd="flash_attention_bwd",
                     weights=ATTN_WEIGHTS),
    "deepseek-moe-16b": dict(
        batch=TRAIN_B, lr=TRAIN_LR, layers=MOE_TRAIN_LAYERS,
        kernel="flash_attention", bwd="flash_attention_bwd",
        weights=ATTN_WEIGHTS + tuple(f"moe.{w}" for w in (
            "router", "we_gate", "we_up", "we_out", "ws_gate", "ws_up",
            "ws_out"))),
}


def train_phase(dev, seed: int, card: str, arch: str = "qwen3-8b") -> int:
    """``arch`` at its published widths and full depth (or
    ``TRAIN_RUNS[arch]["layers"]``) trained through
    ``launch.train.train_steps``: block remat, int8 moments, one fixed
    batch of ``TRAIN_RUNS[arch]["batch"]`` x ``TRAIN_S`` tokens (for
    vit-huge, of as many images: the first batch of the loader's device
    route through ``launch.train.patch_batch``).  The loss
    falls, every layer's weights that reach the family's kernel get
    finite, non-zero gradients at every step (a gradient dropped at K4 or
    K5 would leave them without one), and the kernel launches twice per
    layer per step (forward, and again under remat) and its backward
    once.  Returns the backward's launches in the run."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.launch.train import train_steps
    from repro_torch.train.optimizer import AdamW

    run = TRAIN_RUNS[arch]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(arch, dev, seed, run["layers"])
    cfg = model.cfg
    if cfg.family == "encoder":
        batch = first_image_batch(dev, seed, cfg)
        items, unit = run["batch"], "images"
        what = f"{items} images"
    else:
        rng = np.random.default_rng(seed + 2)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (run["batch"], TRAIN_S + 1))).to(dev)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        items, unit = run["batch"] * TRAIN_S, "tok"
        what = f"{run['batch']} x {TRAIN_S} tokens"
    L = cfg.n_layers
    want = {f"blocks.{l}.{w}" for l in range(L) for w in run["weights"]}
    norms = []                         # per step: parameter -> grad norm
    update_s = []                      # per step: the update's seconds

    class Recording(AdamW):
        """AdamW that keeps the watched weights' gradient norms of every
        step it is handed, and times its update."""

        def update(self, grads, state, params):
            norms.append({
                n: float(torch.linalg.vector_norm(g, dtype=torch.float32))
                for n, g in grads.items() if n in want})
            out, secs = synced_seconds(
                lambda: super(Recording, self).update(grads, state, params))
            update_s.append(secs)
            return out

    parallel = ParallelismConfig(remat="block", opt_state_dtype="int8")
    opt = Recording(lr=run["lr"], state_dtype=parallel.opt_state_dtype)
    reset_counts()
    hist = train_steps(model, opt, parallel, lambda: batch, TRAIN_STEPS)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = counts[run["kernel"]], counts[run["bwd"]]
    check(fwd == 2 * L * TRAIN_STEPS,
          f"{run['kernel']} launched {fwd} times in {TRAIN_STEPS} steps, "
          f"expected {2 * L * TRAIN_STEPS} (forward and remat, once per "
          f"layer each)")
    check(bwd == L * TRAIN_STEPS,
          f"{run['bwd']} launched {bwd} times in {TRAIN_STEPS} steps, "
          f"expected {L * TRAIN_STEPS}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training losses {losses} are not finite or do not fall")
    check(all(np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
              for h in hist), f"grad norms {[h['grad_norm'] for h in hist]}")
    for i, seen in enumerate(norms):
        check(set(seen) == want, f"step {i + 1}: gradients for "
              f"{sorted(want - set(seen))[:4]} missing")
        bad = [n for n, x in seen.items() if not (np.isfinite(x) and x > 0)]
        check(not bad, f"step {i + 1}: gradients zero or not finite: "
              f"{bad[:4]}")
    secs = [h["seconds"] for h in hist]
    steady = float(np.median(secs[1:]))
    depth = f"full depth {L}" if run["layers"] is None \
        else f"{L} of {registry.get(arch).n_layers} layers"
    print(f"{arch} training ({depth}, published widths, block "
          f"remat, int8 moments, lr {run['lr']}): {TRAIN_STEPS} steps of "
          f"{what} on one batch; losses "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; step seconds "
          f"{[round(x, 3) for x in secs]}; median of steps 2-{TRAIN_STEPS} "
          f"{steady:.3f} s = {items / steady:.1f} {unit}/s; peak memory "
          f"{peak / 1e9:.2f} GB of {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; "
          f"{run['kernel']} launches {fwd}, backward {bwd}; gradient norms "
          f"of {len(want)} per-layer weights ({', '.join(run['weights'])}) "
          f"finite and non-zero at every step, last step min "
          f"{min(norms[-1].values()):.3e} "
          f"({card})", flush=True)
    print(f"{arch} training step split (host clock, synchronized): "
          f"optimizer update {[round(x, 3) for x in update_s]} s, the rest "
          f"(batch, forward, remat, backward, gradient norms) "
          f"{[round(a - b, 3) for a, b in zip(secs, update_s)]} s",
          flush=True)
    params = [p for _, p in model.named_parameters()]
    device_split(lambda: torch.autograd.grad(
        model.loss(batch, remat=parallel.remat), params),
        f"{arch} forward + backward (block remat)",
        dispatch=model.cfg.moe is not None)
    del model, opt, batch, params
    gc.collect()
    torch.cuda.empty_cache()
    return bwd


def first_image_batch(dev, seed: int, cfg):
    """The first batch of the loader's device route over
    ``imagenet_like(N_VIT)`` through ``launch.train.patch_batch``: (B, T,
    d) bf16 patch embeddings and labels, on the card."""
    from repro_torch.launch.train import patch_batch
    _, server, _, pipe = device_route(dev, N_VIT, seed)
    try:
        return patch_batch(pipe.next_batch(), cfg)
    finally:
        pipe.stop()
        server.close()


def vit_loader_part(dev, seed: int, card: str):
    """vit-huge at its published widths trained from the loader's device
    route: ``device_route(imagenet_like(N_VIT))``, two epochs of N_VIT /
    BATCH steps, each batch through ``launch.train.patch_batch`` and the
    train step (block remat, int8 moments).  Every id once per epoch,
    sampled rows equal to a CPU recomputation, K1 once per batch of the
    cold epoch, 0 h2d bytes in the all-HBM epoch, the loss finite at
    every step, K4 twice per layer per step and its backward once.
    Prints per epoch the loader's and the step's seconds (each ending in
    a synchronize), images/s of the loop, the loader's share of it and
    the card's idle share over ``VIT_TRACED_STEPS`` traced steps.
    Returns the launch counts of the run."""
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.launch.train import patch_batch
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model("vit-huge", dev, seed + 1)
    cfg = model.cfg
    L = cfg.n_layers
    ds, server, sess, pipe = device_route(dev, N_VIT, seed)
    tel = server.service.telemetry
    parallel = ParallelismConfig(remat="block", opt_state_dtype="int8")
    opt = AdamW(lr=VIT_LR, state_dtype=parallel.opt_state_dtype)
    step = build_train_step(model, parallel, opt)
    rng = np.random.default_rng(seed + 3)
    n_batches = N_VIT // BATCH
    run = {"state": opt.init(model)}
    try:
        reset_counts()
        for epoch in range(2):
            h2d_before = tel.channel_total_bytes("h2d")
            pick_at = set(rng.choice(n_batches, 4, replace=False).tolist())
            ids, picks, load_s, step_s, losses = [], [], [], [], []

            def one(i):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                raw = pipe.next_batch()
                batch = patch_batch(raw, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, run["state"], metrics = step(model, run["state"], batch)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
                load_s.append(t1 - t0)
                ids.extend(raw["ids"].tolist())
                if i in pick_at:
                    slot = int(rng.integers(0, BATCH))
                    picks.append((raw["images"][slot:slot + 1].clone(), 0,
                                  int(raw["ids"][slot]), sess.epoch))

            def steps(lo, hi):
                for i in range(lo, hi):
                    one(i)

            steps(0, 1)
            t0 = time.perf_counter()
            _, spans = traced(lambda: steps(1, 1 + VIT_TRACED_STEPS))
            window = time.perf_counter() - t0
            steps(1 + VIT_TRACED_STEPS, n_batches)
            counts = read_counts()
            h2d = tel.channel_total_bytes("h2d") - h2d_before
            check(sorted(ids) == list(range(N_VIT)),
                  f"vit-huge loader epoch {epoch + 1} did not serve every id "
                  f"once")
            check_rows(ds, picks, epoch_seeds=True)
            check(all(np.isfinite(losses)),
                  f"vit-huge loader epoch {epoch + 1}: losses {losses}")
            check(counts["decode_augment"] == n_batches,
                  f"K1 launched {counts['decode_augment']} times by the end "
                  f"of epoch {epoch + 1}, expected once per batch of the "
                  f"cold epoch ({n_batches})")
            if epoch == 1:
                check(h2d == 0, f"the all-HBM epoch moved {h2d} h2d bytes")
            # the profiler adds host time to every launch, which stretches
            # host-bound work (the update's small kernels, the loader), so
            # the times below leave the traced steps out
            plain = [i for i in range(n_batches)
                     if not 1 <= i < 1 + VIT_TRACED_STEPS]
            ld = [load_s[i] for i in plain]
            st = [step_s[i] for i in plain]
            loop = sum(ld) + sum(st)
            print(f"vit-huge from the loader, epoch {epoch + 1} "
                  f"({'cold, K1' if epoch == 0 else 'all HBM'}): "
                  f"{n_batches} steps of {BATCH} images, the {len(plain)} "
                  f"untraced ones: loader {1e3 * sum(ld) / len(plain):.1f} "
                  f"ms per batch (median {1e3 * float(np.median(ld)):.1f}), "
                  f"step {1e3 * sum(st) / len(plain):.1f} ms per batch "
                  f"(median {1e3 * float(np.median(st)):.1f}); "
                  f"{len(plain) * BATCH / loop:.1f} images/s over them, "
                  f"loader {100 * sum(ld) / loop:.1f}% of it; h2d bytes "
                  f"{h2d}; losses {losses[0]:.4f} -> {losses[-1]:.4f} "
                  f"({card})", flush=True)
            if spans:
                busy = busy_us(spans)
                k4 = [hi - lo for name, lo, hi in spans
                      if "repro_torch::flash" in name]
                per_step = busy / 1e6 / VIT_TRACED_STEPS
                print(f"  traced steps 2-{1 + VIT_TRACED_STEPS} "
                      f"(torch.profiler, loader included): {len(spans)} "
                      f"kernels and copies, device busy {per_step:.4f} s "
                      f"per step (K4 and its backward "
                      f"{sum(k4) / 1e3 / VIT_TRACED_STEPS:.3f} ms), so the "
                      f"card is idle "
                      f"{100 * (1 - per_step * len(plain) / loop):.2f}% of "
                      f"an untraced step's {loop / len(plain):.4f} s; the "
                      f"traced window itself {window:.3f} s, idle "
                      f"{100 * (1 - busy / (window * 1e6)):.2f}%", flush=True)
            else:
                print("  traced steps: not measured (the profiler saw no "
                      "device activity)", flush=True)
        counts = read_counts()
        steps_run = 2 * n_batches
        check(counts["flash_attention"] == 2 * L * steps_run,
              f"K4 launched {counts['flash_attention']} times in "
              f"{steps_run} steps, expected {2 * L * steps_run}")
        check(counts["flash_attention_bwd"] == L * steps_run,
              f"K4 backward launched {counts['flash_attention_bwd']} times "
              f"in {steps_run} steps, expected {L * steps_run}")
        print(f"vit-huge from the loader: launches {counts}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, hbm bytes "
              f"{server.stats()['hbm_bytes_used']}", flush=True)
        return counts
    finally:
        pipe.stop()
        server.close()
        del model, run
        gc.collect()
        torch.cuda.empty_cache()


def vit_phase(dev, seed: int, card: str):
    """vit-huge at published widths and full depth: (a) ``train_phase``
    on the first batch of the loader's device route, (b)
    ``vit_loader_part``.  Returns (b)'s launch counts."""
    train_phase(dev, seed, card, "vit-huge")
    return vit_loader_part(dev, seed, card)


@contextlib.contextmanager
def dropped_per_layer():
    """Inside the block, every call of the moe dispatch appends to the
    yielded list how many assignments its capacity dropped."""
    from repro_torch.models import moe as moe_mod
    plan, dropped = moe_mod.dispatch_plan, []

    def counting(top_e, n_experts, capacity):
        slot, src = plan(top_e, n_experts, capacity)
        dropped.append(int((slot == n_experts * capacity).sum()))
        return slot, src

    moe_mod.dispatch_plan = counting
    try:
        yield dropped
    finally:
        moe_mod.dispatch_plan = plan


@contextlib.contextmanager
def routes(forced=None):
    """Inside the block, every call of the moe router appends (its
    experts, its float32 logits), on the host, to the yielded list; with
    ``forced`` (one (T, k) tensor of expert ids per call, in call order)
    the i-th call takes ``forced[i]``'s experts, its gates renormalised
    from its own probabilities at them."""
    from repro_torch.models import moe as moe_mod
    route, seen = moe_mod._route, []

    def recording(x2d, router_w, k):
        top_e, top_g, aux = route(x2d, router_w, k)
        logits = torch.matmul(x2d, router_w).float()
        seen.append((top_e.cpu(), logits.cpu()))
        if forced is not None:
            top_e = forced[len(seen) - 1].to(x2d.device)
            top_g = moe_mod.gates(torch.softmax(logits, dim=-1), top_e,
                                  x2d.dtype)
        return top_e, top_g, aux

    moe_mod._route = recording
    try:
        yield seen
    finally:
        moe_mod._route = route


def routing_flips(got, want):
    """Decisions (row, layer) whose expert set differs between two lists
    of ``routes`` records of the same rows, and for each the gap in
    ``want``'s logits across the top-k boundary (its lowest chosen expert
    that ``got`` left out, minus ``got``'s highest pick that ``want`` left
    out), in bf16 ulps at the row's largest |logit| (as ``near_tie``)."""
    gaps = []
    for (ge, _), (we, wl) in zip(got, want):
        for row in range(we.shape[0]):
            g, w = set(ge[row].tolist()), set(we[row].tolist())
            if g == w:
                continue
            out = min(float(wl[row, e]) for e in w - g)
            into = max(float(wl[row, e]) for e in g - w)
            gaps.append((out - into) / float(near_tie(wl[row])) *
                        NEAR_TIE_ULPS)
    return gaps


def flips_hold(gaps, n: int) -> bool:
    """``routing_flips`` ``gaps`` of ``n`` decisions are rounding's:
    at most MOE_FLIP_SHARE of them, none across a gap above
    MOE_FLIP_ULPS."""
    return len(gaps) <= MOE_FLIP_SHARE * n \
        and max(gaps, default=0.0) <= MOE_FLIP_ULPS


def flips_line(gaps, n: int) -> str:
    return (f"{len(gaps)} of {n} router decisions differ "
            f"({100 * len(gaps) / n:.1f}%), gaps across the top-k boundary "
            f"there up to {max(gaps, default=0.0):.2f} bf16 ulps: "
            f"{sorted(round(g, 2) for g in gaps)}")


def flips_check(got, want, tol: float, label: str) -> None:
    """``got``'s router decisions against ``want``'s, two lists of
    ``routes`` records of the same rows whose hidden states agree up to
    rounding (forward given ``got``'s experts): ``flips_hold``, and every
    layer's router logits within ``tol`` in relative RMS."""
    gaps = routing_flips(got, want)
    n = sum(te.shape[0] for te, _ in want)
    rel = max(float((gl - wl).norm() / wl.norm())
              for (_, gl), (_, wl) in zip(got, want))
    check(flips_hold(gaps, n) and rel <= tol,
          f"{label}: {len(gaps)} of {n} router decisions differ (limit "
          f"{MOE_FLIP_SHARE:.0%}), largest gap {max(gaps, default=0.0)} "
          f"bf16 ulps (limit {MOE_FLIP_ULPS}); router logits' relative RMS "
          f"up to {rel} (tolerance {tol})")
    print(f"{label}: router logits within relative RMS {rel:.5f} "
          f"(tolerance {tol:.5f}); {flips_line(gaps, n)} (limits "
          f"{MOE_FLIP_SHARE:.0%}, {MOE_FLIP_ULPS} ulps)", flush=True)


def planted_routes(own, k: int):
    """Two wrong routers' decisions at ``own``'s rows: each row takes the
    next row's experts (a slot-mate's), and each row drops its best
    expert for its (k+1)-th."""
    rolled = [(torch.roll(te, 1, 0), lt) for te, lt in own]
    shifted = [(torch.sort(lt, dim=-1, descending=True,
                           stable=True).indices[:, 1:k + 1], lt)
               for _, lt in own]
    return {"a slot-mate's experts": rolled,
            "the best expert dropped": shifted}


def moe_phase(dev, seed: int, card: str):
    """deepseek-moe-16b: (a) serving at published widths and full depth,
    (b) ``train_phase`` at published widths and ``MOE_TRAIN_LAYERS``
    layers.  Returns (K4's launches in one prefill, K4 backward's in the
    training run)."""
    from repro_torch.models import moe as moe_mod
    arch = "deepseek-moe-16b"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(arch, dev, seed)
    cfg = model.cfg
    e = cfg.moe
    rng = np.random.default_rng(seed + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ATTN_B, ATTN_S))).to(dev)
    cache = model.init_cache(ATTN_B, ATTN_S_MAX)
    reset_counts()
    (logits_pf, cache), secs = synced_seconds(
        lambda: model.prefill({"tokens": tokens}, cache))
    launches = read_counts()["flash_attention"]
    check(launches == cfg.n_layers,
          f"K4 launched {launches} times in one {arch} prefill, expected "
          f"{cfg.n_layers}")
    T = ATTN_B * ATTN_S
    cap = moe_mod._capacity(T, e.top_k, e.n_experts, e.capacity_factor)
    _, warm = synced_seconds(lambda: model.prefill(
        {"tokens": tokens}, model.init_cache(ATTN_B, ATTN_S_MAX)))
    print(f"{arch} prefill: {ATTN_B} x {ATTN_S} tokens in {secs:.3f} s "
          f"(first call), {warm:.3f} s = {T / warm:.1f} tok/s (second), K4 "
          f"launches {launches}, expert capacity {cap} slots ({e.n_experts} "
          f"x {cap} x {cfg.d_model} buffer per layer) ({card})", flush=True)
    with dropped_per_layer() as dropped:
        (full, _), secs = synced_seconds(lambda: model({"tokens": tokens}))
    check(len(dropped) == cfg.n_layers,
          f"the moe dispatch ran {len(dropped)} times in one forward")
    check(torch.equal(logits_pf, full), f"{arch} prefill logits differ from "
          f"forward")
    check(bool(torch.isfinite(full).all()), "forward logits are not finite")
    print(f"{arch} forward (counting drops, a sync a layer): {secs:.3f} s; "
          f"prefill logits equal forward's "
          f"(torch.equal); assignments dropped per layer (of "
          f"{T * e.top_k} at capacity factor {e.capacity_factor}): "
          f"{dropped}, {100 * sum(dropped) / (T * e.top_k * cfg.n_layers):.3f}"
          f"% in all", flush=True)
    del full, logits_pf, cache
    torch.cuda.empty_cache()
    device_split(lambda: model.prefill({"tokens": tokens},
                                       model.init_cache(ATTN_B, ATTN_S_MAX)),
                 f"{arch} prefill", dispatch=True)
    # decode at index MOE_PREFIX against forward on the extended prefix,
    # and one request alone against forward on its prompt, at a capacity
    # factor where forward drops nothing that decode keeps.  Decode's
    # 4-row products round apart from forward's 260-row ones, and a
    # router decision near a tie can then pick another expert: decode
    # with forward's experts is held against forward; decode with its
    # own experts, the served path, against forward given the same
    # experts at the last position, and its decisions against forward's
    # by ``flips_hold``
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=MOE_DECODE_FACTOR))
    try:
        prefix = tokens[:, :MOE_PREFIX]
        _, cache = model.prefill({"tokens": prefix},
                                 model.init_cache(ATTN_B, MOE_PREFIX + 1))
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ATTN_B, 1))
                               ).to(dev)
        seq = torch.cat([prefix, nxt], dim=1)
        with dropped_per_layer() as dropped, routes() as fwd:
            ext, _ = model({"tokens": seq})
        check(not any(dropped), f"forward at capacity factor "
              f"{MOE_DECODE_FACTOR} dropped {dropped}")
        last = [(te.reshape(ATTN_B, MOE_PREFIX + 1, -1)[:, -1],
                 lg.reshape(ATTN_B, MOE_PREFIX + 1, -1)[:, -1])
                for te, lg in fwd]
        with routes() as own:
            dec_own, _ = model.decode_step(cache, nxt, MOE_PREFIX)
        with routes([te for te, _ in last]):
            dec, _ = model.decode_step(cache, nxt, MOE_PREFIX)
        # forward with decode's own experts at the last position
        mixed = [torch.cat([te.reshape(ATTN_B, -1, e.top_k)[:, :-1],
                            oe[:, None]], dim=1).reshape(-1, e.top_k)
                 for (te, _), (oe, _) in zip(fwd, own)]
        with routes(mixed) as fwd_own:
            ext_own, _ = model({"tokens": seq})
        last_own = [(te.reshape(ATTN_B, MOE_PREFIX + 1, -1)[:, -1],
                     lg.reshape(ATTN_B, MOE_PREFIX + 1, -1)[:, -1])
                    for te, lg in fwd_own]
        tol = depth_tolerance(cfg.n_layers)
        top = float(ext[:, -1].float().abs().amax())
        for how, got, want in (("forward's experts", dec, ext),
                               ("its own experts (forward given them too)",
                                dec_own, ext_own)):
            rel, err, agree, exact = compare_logits(got[:, 0], want[:, -1])
            check(rel <= tol and agree == 1.0,
                  f"{arch} decode at index {MOE_PREFIX} with {how} differs "
                  f"from forward: relative RMS {rel} (tolerance {tol}), "
                  f"argmax agreement {agree} (near ties of {NEAR_TIE_ULPS} "
                  f"bf16 ulps included)")
            print(f"{arch} decode at index {MOE_PREFIX} with {how} vs "
                  f"forward on {MOE_PREFIX + 1} tokens (capacity factor "
                  f"{MOE_DECODE_FACTOR}, nothing dropped): relative RMS "
                  f"{rel:.5f} (tolerance {tol:.5f}), max abs {err:.4f} "
                  f"(largest |logit| {top:.4f}), argmax agreement "
                  f"{agree:.2f} with near ties of {NEAR_TIE_ULPS} ulps, "
                  f"{exact:.2f} exact", flush=True)
        rel, err, agree, exact = compare_logits(dec_own[:, 0], ext[:, -1])
        print(f"{arch} decode with its own experts vs forward with its own "
              f"(reported): relative RMS {rel:.5f}, max abs {err:.4f}, "
              f"argmax agreement {agree:.2f} with near ties, {exact:.2f} "
              f"exact", flush=True)
        n = ATTN_B * cfg.n_layers
        print(f"{arch} decode with its own experts against forward's "
              f"(reported; a flip moves the later layers' inputs): "
              f"{flips_line(routing_flips(own, last), n)}", flush=True)
        flips_check(own, last_own, tol, f"{arch} decode with its own "
                    f"experts against forward given them")
        for fault, planted in planted_routes(own, e.top_k).items():
            gaps = routing_flips(planted, last_own)
            check(not flips_hold(gaps, n), f"a router that takes {fault} "
                  f"passes the flip check: {len(gaps)} of {n} decisions, "
                  f"largest gap {max(gaps, default=0.0)} bf16 ulps")
            print(f"{arch} decode, planted fault ({fault}): {len(gaps)} of "
                  f"{n} decisions differ, largest gap "
                  f"{max(gaps, default=0.0):.2f} bf16 ulps, smallest "
                  f"{min(gaps, default=0.0):.2f}: fails the flip check",
                  flush=True)
        del ext_own
        del cache, dec, dec_own, ext
        one_request(model, rng)
    finally:
        model.cfg = cfg
    torch.cuda.empty_cache()
    serve_phase(model, seed, card)
    print(f"{arch} serving peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})",
          flush=True)
    del model
    bwd = train_phase(dev, seed, card, arch)
    return launches, bwd


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
    counts, unsharded = phase("loader main path, augmented",
                              main_path_augmented, dev, N_AUGMENTED,
                              args.seed, card)
    rows["decode_augment"]["launches"] = counts["decode_augment"]
    counts = phase("loader main path, decoded hits", main_path_decoded, dev,
                   N_DECODED, args.seed, card)
    rows["decode"]["launches"] = counts["decode"]
    rows["augment"]["launches"] = counts["augment"]
    phase("ods step, ImageNet-1k scale", ods_phase, dev, args.seed, card)
    phase("multi-job workload, shared cache", workload_phase, dev,
          args.seed, card)
    counts = phase("sharded data plane", sharded_phase, dev, args.seed,
                   card, unsharded)
    rows["decode_augment"]["launches"] += counts["decode_augment"]
    rows["augment"]["launches"] += counts["augment"]
    rows.update(phase("model kernels", model_kernel_phase, dev, args.seed))
    rows["flash_attention"]["launches"] = phase(
        "serving, qwen3-8b", dense_phase, dev, args.seed, card)
    rows["ssd_scan"]["launches"] = phase(
        "serving, mamba2-1.3b", ssm_phase, dev, args.seed, card)
    rows["flash_attention_bwd"]["launches"] = phase(
        "training, qwen3-8b", train_phase, dev, args.seed, card)
    rows["ssd_scan_bwd"]["launches"] = phase(
        "training, mamba2-1.3b", train_phase, dev, args.seed, card,
        "mamba2-1.3b")
    counts = phase("training, vit-huge", vit_phase, dev, args.seed, card)
    rows["flash_attention_vit"]["launches"] = counts["flash_attention"]
    rows["flash_attention_bwd_vit"]["launches"] = \
        counts["flash_attention_bwd"]
    rows["decode_augment"]["launches"] += counts["decode_augment"]
    rows["flash_attention_moe"]["launches"], \
        rows["flash_attention_bwd_moe"]["launches"] = phase(
            "serving and training, deepseek-moe-16b", moe_phase, dev,
            args.seed, card)

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
                            "flash_attention", "flash_attention_bwd",
                            "ssd_scan", "ssd_scan_bwd", "flash_attention_vit",
                            "flash_attention_bwd_vit", "flash_attention_moe",
                            "flash_attention_bwd_moe")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
