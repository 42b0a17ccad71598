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
   launches' device time from ``torch.profiler``); then at
   zamba2-1.2b's shapes: K4 at its prefill launch (1, 32768, 32 | 32,
   64), causal with the window 4096, against its plain version over
   query blocks, timed beside the same launch without the window (it
   must take less than half that time) and beside SDPA with the window
   as a boolean mask; K4 and its backward with the window against
   their plain versions at (1, 8192, 32 | 32, 64) in bf16 and float32;
   K4 and its backward at its training shape (2, 4096, 32 | 32, 64); K5
   at (1, 32768) and (2, 4096) with 64 heads, P 64, N 64, and its
   backward at the latter; K5 and its backward at a rank's shape of the
   train multi cell under the reference's layout (``TP_RANK_SHAPE``:
   8 x 4096, 4 of mamba2-1.3b's 64 heads, P 64, N 128), checked and
   timed as at mamba2's; then K4 at internvl2-2b's prefill (4, 1024,
   16 | 8, 128) causal and its backward at (2, 1024); K4 at each of
   seamless-m4t-large-v2's three shapes, its encoder's (4, 128, 16 |
   16, 64) non-causal, its decoder's self-attention (4, 1024, 16 | 16,
   64) causal and its cross-attention (4, 1024 | 128, 16 | 16, 64)
   non-causal with the key length of its own, each with its backward at
   the training batch of 2, with the same checks and yardsticks; K4 and
   its backward non-causal at Sq in ``CROSS_SQ`` x Sk in ``CROSS_SK``,
   bf16 and float32, against plain, two backward calls bitwise equal;
6. serving path, dense: qwen3-8b at full width (random weights from
   ``--seed``): ``Model.prefill`` of 4 x 1024 tokens (K4 launched once
   per layer; prefill logits equal forward's; decode at index S agrees
   with forward on the extended sequence within ``depth_tolerance``),
   a device-time split of one prefill from ``torch.profiler``, the
   CLI's ``Server`` defaults (8 requests, 4 slots, prompts of 12, 16 new
   tokens), and one request alone whose first token is forward's
   argmax;
7. the mesh layer's world: one NCCL process group of world size 1 on a
   file store under ``build/`` and the (1, 1) ``("data", "model")``
   ``DeviceMesh`` over it (``mesh_world``; a failure to initialise it
   fails the run; destroyed before the last lines); over it
   qwen3-8b's pipeline (the model of 6): its 36 full-width blocks through
   ``distributed.pp.pipeline_forward`` on a ``("pipe",)`` mesh of the
   one rank (``pp_phase``): 4 x 1024 embedded tokens in 4 microbatches,
   bitwise equal to ``run_decoder`` on each microbatch in turn, K4
   launched (M + S - 1) x L/S = 144 times, the largest difference from
   ``run_decoder`` over the whole batch printed, the collectives recorded
   by ``roofline.hlo_collectives.record``; the schedule over 4 stages of 9
   blocks run in one process through the same tick
   (``pipeline_forward_local``: 7 ticks, K4 252 times, bitwise equal to
   the same reference), its 7 hand-offs and the all-reduce of its output
   accounted on the H100 profile (wire bytes, collective term), and
   ``roofline.analysis.model_flops`` of the prefill over the pipeline's
   seconds; then elastic resharding (``elastic_phase``): the parameters
   resharded by ``partition_specs`` under the prefill rules onto
   ``distributed.elastic.make_mesh(1)``, no demotion, every local block
   equal to its source, and a prefill from the local blocks giving
   ``dense_phase``'s logits bitwise (K4 36 times); then the dry-run
   against the run (``dryrun_phase``): ``launch.dryrun.lower_cell``
   traces, in a child process on a fake world of one (fake CUDA tensors,
   nothing runs), (a) qwen3-8b's 4 x 1024 prefill and (b) one
   data-parallel step of mamba2-1.3b at 4 x 1024; here the same steps
   run for real under the same rules on the NCCL world of one inside the
   same counters (``dry_check``; (b) in ``dryrun_train_phase``, once
   qwen3-8b is freed, tensor parallelism off: the replicated program):
   FLOPs, bytes accessed and collectives per kind
   equal, K4's op calls (36) and K5's and its backward's (48
   each) equal to the launches, the traced peak within ``DRY_PEAK_TOL``
   of ``max_memory_allocated``, the record's terms on the H100 profile
   beside the measured seconds; (c) the production sweep comes after
   the last timed phase (item 14); then the reference's sharded layout
   (``layout_phase``): qwen3-8b at its published widths and
   ``LAYOUT_LAYERS`` layers placed by ``distribute_model`` under
   ``make_rules`` with FSDP, TP, 2 microbatches and block remat (int8
   moments) on that mesh, ``LAYOUT_STEPS`` steps of 2 x 1024 through
   ``build_train_step`` and a 4 x 1024 prefill, bitwise equal to the same
   steps and prefill from the same seed with no rules (every parameter's
   and moment's digest after each step, the loss, the gradient norm,
   ``LAYOUT_WHOLE``'s parameters whole, the logits and the cache), K4
   launched 4 x L and its backward 2 x L times a step on both paths;
   ``LAYOUT_DECODE`` decode steps after each prefill, the sharded ones
   under the decode_32k cell's production mapping (``DECODE_TP``: the
   cache's sequence on ``model``, re-laid from the prefill's spec by
   ``sharding.relayout``; the flash-decoding combine over one block),
   each step's logits and new keys and values bitwise or within
   ``depth_tolerance`` of the plain decode's (``compare_decode``, which
   the line states), K4 not launched; then ``dry_check`` of that train
   cell and of the decode cell under the same layout and depth;
   then the serving path, ssm: mamba2-1.3b at full width:
   ``Model.forward`` of 4 x 1024 tokens (K5 launched once per layer),
   the same forward under the prefill rules of ``default_parallelism``
   over that mesh, the sequence-parallel SSD of ``models/ssm_sp.py``
   (K5 once per layer, logits equal to the local forward's;
   ``sp_part``), layer 0's block
   with the sequence cut into 2 and 4 segments chained through the
   hand-off that ranks past 0 take (``segments_check``, bf16 and
   float32, against the local block), token-by-token decode
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
   and its backward 48 times per step; then mamba2-1.3b's
   data-parallel step over the NCCL mesh (``dp_phase``): two
   ``build_dp_train_step`` steps against two ``build_train_step`` steps
   from the same weights (parameters within one bf16 ulp), then
   ``TRAIN_STEPS`` steps with the int8 error-feedback all-reduce (last
   loss within 0.1 of the uncompressed run's and below ln V), K5 and its
   backward once per layer per step, step seconds and the seconds of
   each ``allreduce_compressed`` over the 1.45 B gradient printed;
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
    dropped per layer printed), the same prefill expert-parallel over
    the NCCL mesh (the experts' weights placed by the prefill rules as
    DTensors, 64 local experts from offset 0, K4 once per layer, logits
    equal to the local prefill's; ``ep_part``), the first moe layer's
    dispatch over 2 and 4 expert ranges from offsets above 0, summed,
    against the dispatch over all experts (``ranges_check``), the device
    split of one prefill; at
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
    (c) the reference's layout at one NCCL rank (``moe_layout_phase``):
    the same 14 layers placed by ``distribute_model`` under
    ``make_rules`` with expert and tensor parallelism (the attention,
    the shared experts and the vocab over ``model`` beside the experts,
    the router read whole), one step of 2 x 1024 through
    ``build_train_step`` (block remat, int8 moments), a 4 x 1024
    prefill and ``MOE_LAYOUT_DECODE`` decode steps, then the same from
    the same seed with no rules: every parameter's and moment's digest,
    the loss, the gradient norm, the prefill's logits and cache equal,
    the decode steps by ``compare_decode``; K4 2 x 14 and its backward
    14 times in the step, 14 in the prefill, none in decode; no global
    switch makes the step deterministic (the dispatch's backward adds
    without atomics); (d) the ssm and hybrid families under the
    reference's layout at one NCCL rank (``ssm_layout_phase``):
    mamba2-1.3b (48 layers) and zamba2-1.2b (38 layers) at their
    published widths placed by ``distribute_model`` under the production
    cells' rules (``production_rules``: train multi on a (1, 1, 1)
    ``("pod", "data", "model")`` mesh, prefill_32k, decode_32k and
    long_500k; the SSD heads, zamba2's shared attention and MLP and the
    vocab over ``model``), ``SSM_LAYOUT_STEPS`` steps through
    ``build_train_step`` (mamba2 4 x 1024; zamba2 2 x 4096 under block
    remat), zamba2's 1 x 8192 prefill, decode from a zero cache under
    the decode_32k rules (mamba2 8 steps of 4 rows; zamba2 12 steps of
    4 rows on an 8-slot ring, which wraps) and zamba2's under the
    long_500k rules (1 row, its ring's slots on ``data``: the combine
    over one block), then the same from the same seed with no rules:
    every digest, loss, gradient norm, the prefill's logits and the
    decode_32k decodes bitwise, the long_500k decode bitwise or within
    ``depth_tolerance``; K5, its backward and K4 launched as often on
    both paths, none in decode; then ``dry_check`` of mamba2's decode
    cell and zamba2's 1 x 8192 prefill cell on that layout;
11. the hybrid family, zamba2-1.2b at its published widths and full
    depth (38 mamba2 layers, the shared attention block after every 6,
    1.17 B parameters; ``hybrid_phase``): (a) ``Model.prefill`` of 1 x
    32,768 tokens (the reference's prefill_32k sequence, batch cut from
    32): K4 6 times with the window, K5 38 times, logits equal to
    forward's and finite, the device split of one prefill; (b) decode
    from zero state against forward on 4 x 64 tokens (bf16 reported,
    float32 checked with the ring buffers cast to float32), and the
    ``Server`` defaults; (c) ``train_phase`` on 2 x 4096 tokens (the
    reference's train_4k sequence, batch cut from 256): K5 2 x 38 and
    its backward 38 times per step, K4 and its backward 6 times each
    (the shared block is not recomputed), every layer's ssm weights and
    the shared block's attention and MLP weights with finite non-zero
    gradients at every step;
12. the vlm family, internvl2-2b at its published widths and full depth
    (24 layers, 1.90 B parameters; ``vlm_encdec_phase``): (a)
    ``Model.prefill`` of 4 x 1024 positions, 256 patch embeddings and
    768 tokens (K4 24 times, logits equal to forward's and finite), the
    device split of one prefill, decode at index 1024 against forward on
    the extended sequence within ``depth_tolerance(24)``; (b) the
    ``Server`` defaults; (c) ``train_phase`` on 2 x 1024 positions: K4
    2 x 24 and its backward 24 times per step, every layer's attention
    weights with finite non-zero gradients at every step;
13. the encdec family, seamless-m4t-large-v2 likewise (24 encoder and 24
    decoder layers, 2.04 B parameters): 1024 tokens over
    ``encdec_src_len(1024)`` = 128 frames, K4 72 times a prefill, 24 at
    each of its three shapes (encoder, self, cross at Sq 1024 | Sk 128;
    ``k4_shapes``), prefill's 128 cross rows replacing the cache's 136,
    decode at index 1024 reading them; the ``Server`` (which decodes
    against the zero cross cache, as the reference's) reported; training
    with K4 2 x 72 and its backward 72 times per step, 2 x 24 and 24 at
    each shape, gradients checked on the encoder's and the decoder's
    attention weights and every layer's ``cross.{wq,wk,wv,wo}``, at the
    rate ``SEAMLESS_LR``; every training phase's last loss must lie
    below ln V, a uniform prediction's;
14. the dry-run's production sweep (``sweep_phase``), after every timed
    phase: ``launch.dryrun`` over every assigned arch x shape on the
    ``SWEEP_MESHES`` (the multi-pod mesh), one process per arch,
    ``SWEEP_PROCS`` at a time; each
    cell's bottleneck and trace seconds, ok, failed and skipped, 0
    failed and every applicable cell recorded; the peak per rank of
    each cell whose production rules run the sharded layout
    (``sweep_sharded``: every dense and moe cell, the ssm and hybrid
    cells with tensor parallelism), each holding its analytic bytes,
    every other cell on the replicated program, and how many of all the
    cells fit 80 GB; then the
    kernel JSON line (one
    row per kernel and shape; the rows of K5, its backward and K4 at moe
    also carry ``launches_sp``, ``launches_dp`` and ``launches_ep``,
    their launches on the sequence-, data- and expert-parallel paths,
    K4's qwen3-8b row ``launches_pp``, its launches in the pipeline,
    K4's, K5's and K5's backward's rows ``launches_dry``, their launches
    in the dry-run's real runs, and K4's and its backward's qwen3-8b rows
    ``launches_layout`` and ``launches_dry_layout``, theirs in the
    sharded layout's run and in its dry-run check, their moe rows
    ``launches_layout``, theirs in ``moe_layout_phase``'s sharded run,
    K5's and its backward's mamba2 rows and the zamba2 rows
    ``launches_layout``, theirs in ``ssm_layout_phase``'s sharded runs,
    zamba2's prefill rows ``launches_dry_layout``, theirs in its dry-run
    check; the ``_tp`` rows' ``launches`` are mamba2's sharded steps'),
    the card line, and
    the result line
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

try:
    from repro_torch.roofline.analysis import H100
except ImportError:          # no port beside the script: main() exits 2
    H100 = None
#: NVIDIA H100 SXM data-sheet peaks, from the port's device profile
#: (``repro_torch.roofline.analysis.H100``)
HBM_BYTES_PER_S = H100.hbm_bytes_per_s if H100 else None
FP32_FLOPS_PER_S = H100.fp32_flops_per_s if H100 else None
BF16_FLOPS_PER_S = H100.peak_bf16_flops if H100 else None
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
#: (multiples of BATCH).  This size, the workload's, the shards',
#: N_VIT and LAYOUT_LAYERS were halved when the whole run passed its
#: 1,200 s limit on one H100 (977 s, and over 1,200 s on another
#: machine, with them at twice these): each phase keeps its checks
N_AUGMENTED = 8_192
N_DECODED = 2_048
#: the ODS step at ImageNet-1k's size: jobs, timed steps per variant
N_ODS = 1_281_167
ODS_JOBS = 3
ODS_STEPS = 20
#: the multi-job workload: samples, job arrivals (s), HBM tier as a
#: share of the augmented set, DRAM cache as a share of it
N_WORKLOAD = 8_192
WORKLOAD_ARRIVALS = (0.0, 1.0, 2.0)
WORKLOAD_HBM_FRAC = 0.5
WORKLOAD_DRAM_FRAC = 0.1
#: the sharded data plane: (a) sim shards over the augmented main path,
#: (b) process shards: an ingest through their host produce path, then
#: the server's own under the device executor, (c) a shard kill
#: under two jobs paced at KILL_RATE samples/s each (so the run lasts at
#: least N_KILL / KILL_RATE seconds and the restart lands inside it)
N_SHARDED_SIM, SIM_SHARDS = 8_192, 4
N_SHARDED_PROCESS, PROCESS_SHARDS = 1_024, 2
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


@contextlib.contextmanager
def k4_shapes():
    """Within the block, K4's and its backward's launches by shape:
    yields a Counter of ``(wrapper, Sq, Sk, causal)`` (wrapper
    ``flash_attention`` or ``flash_attention_bwd``) that each call adds
    its wrapper's own count's rise to, so a launch counts where the
    wrapper counts it and nowhere else.  The model reaches both wrappers
    through the kernel module's globals (``FlashAttention``), where each
    is swapped for a spy for the block's length.  A wrapper counts on
    the module's global of its name (``flash_attention.launches += 1``),
    so within the block it counts on its spy, which starts from the
    wrapper's count and hands it back after the block."""
    import collections
    from repro_torch.kernels.flash_attention import kernel as fa

    seen = collections.Counter()
    real = {"flash_attention": fa.flash_attention,
            "flash_attention_backward": fa.flash_attention_backward}

    def spy(name, fn):
        def call(q, k, *args, causal=True, **kwargs):
            before = call.launches
            try:
                return fn(q, k, *args, causal=causal, **kwargs)
            finally:
                seen[(name, q.shape[1], k.shape[1], causal)] += \
                    call.launches - before
        call.launches = fn.launches
        return call

    for attr, name in (("flash_attention", "flash_attention"),
                       ("flash_attention_backward", "flash_attention_bwd")):
        setattr(fa, attr, spy(name, real[attr]))
    try:
        yield seen
    finally:
        for attr, fn in real.items():
            fn.launches = getattr(fa, attr).launches
            setattr(fa, attr, fn)


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
N_VIT = 2_048
VIT_TRACED_STEPS = 1
#: vit-huge's learning rate.  One AdamW step moves every weight by about
#: lr, which over 840 M weights fits the fixed batch of 256 at once from
#: 3e-5 up (loss 7.44 -> 0.46 in two steps at 3e-5, -> 0.0155 in one at
#: 1e-4, and the gradient norm then falls from 12 to below 1e-4); at 3e-6
#: the loss falls ~0.2 a step and the gradients keep their first step's
#: size (scripts/vit_lr_sweep.py on an H100)
VIT_LR = 3e-6
#: seamless-m4t-large-v2's learning rate.  At TRAIN_LR the loss over
#: its first 8 steps on the fixed batch reads 12.96, 12.58, 12.02, 12.52,
#: 11.71, ... 10.48: step 4 overshoots above ln V = 12.4537 before it
#: falls, and so it does with K4's plain versions, float32 parameters or
#: float32 moments (an AdamW step moves every weight by about lr; the
#: 258,048-row head included).  At 3e-5 the four steps fall 12.96 ->
#: 11.97 (scripts/check_training.py on an H100)
SEAMLESS_LR = 3e-5
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
#: zamba2-1.2b (hybrid): prefill of one row at the reference's prefill_32k
#: sequence (batch cut from 32: the bf16 logits alone take 2.1 GB a row),
#: its decode trajectory over HYB_PREFIX tokens of HYB_B rows, and
#: training on HYB_TRAIN_B x HYB_TRAIN_S tokens (the reference's train_4k
#: sequence, batch cut from 256)
HYB_PREFILL_S = 32_768
HYB_B, HYB_PREFIX = 4, 64
HYB_TRAIN_B, HYB_TRAIN_S = 2, 4_096
#: K4's windowed forward and backward are held against their plain
#: versions at HYB_CHECK_S (at HYB_PREFILL_S the plain scores would take
#: 137 GB; at HYB_CHECK_S they run over HYB_HEAD_PARTS slices of the
#: heads), and the prefill launch against the plain version taken over
#: query blocks of HYB_PLAIN_ROWS rows, each with the keys of its window
HYB_CHECK_S, HYB_HEAD_PARTS, HYB_PLAIN_ROWS = 8_192, 4, 1_024
#: K4 and its backward with a key length of their own (seamless's
#: cross-attention) are held against plain at these query and key
#: lengths: queries on both sides of a 128-row item, keys short of one
#: 64-key tile, ragged past one and two, and one past 1024
CROSS_SQ, CROSS_SK = (37, 1000), (16, 100, 130, 1025)
#: mamba2-1.3b forward, and the prefix its decode trajectory checks
SSM_B, SSM_S, SSM_PREFIX = 4, 1024, 64
#: mamba2-1.3b's training batch (of TRAIN_S tokens)
SSM_TRAIN_B = 4
#: (B, S, heads) of K5's launch on a rank of the train multi cell under
#: the reference's layout: 256 sequences over 2 x 16 data ranks, 4,096
#: tokens, 64 heads over 16 model ranks
TP_RANK_SHAPE = (8, 4_096, 4)
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
    from repro_torch.configs import registry

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
    nh = s.expand * cfg.d_model // s.head_dim
    rows["ssd_scan"] = k5_row(dev, rng, "", SSM_B, SSM_S, nh, s.head_dim,
                              s.d_state, s.chunk)
    rows["ssd_scan_bwd"] = ssd_scan_bwd_row(dev, rng, SSM_B, SSM_S, nh,
                                            s.head_dim, s.d_state, s.chunk)
    # ---- K5 and its backward at the train multi cell's rank: its block
    # of the batch (256 over 2 x 16 data ranks) and its 4 of the 64 heads
    # (over 16 model ranks), at the cell's 4,096 tokens
    rows["ssd_scan_tp"] = k5_row(dev, rng, "_tp", *TP_RANK_SHAPE,
                                 s.head_dim, s.d_state, s.chunk)
    rows["ssd_scan_bwd_tp"] = ssd_scan_bwd_row(
        dev, rng, *TP_RANK_SHAPE, s.head_dim, s.d_state, s.chunk, "_tp")
    rows.update(zamba2_kernel_rows(dev, rng))
    rows.update(vlm_encdec_kernel_rows(dev, rng))
    return rows


def seamless_shapes(S: int = None):
    """seamless-m4t-large-v2's K4 launches over S tokens (default
    ``ATTN_S``) by row suffix: (Sq, Sk, causal) of its encoder over
    ``encdec_src_len(S)`` frames (128 at 1024), its decoder's
    self-attention over the S tokens, and its cross-attention from those
    tokens to the frames."""
    from repro_torch.models.transformer import encdec_src_len
    S = S or ATTN_S
    src = encdec_src_len(S)
    return {"_seamless_enc": (src, src, False),
            "_seamless_self": (S, S, True),
            "_seamless_cross": (S, src, False)}


def vlm_encdec_kernel_rows(dev, rng):
    """K4 and its backward at the shapes internvl2-2b and
    seamless-m4t-large-v2 launch them with: internvl2's prefill (4, 1024,
    16 | 8, 128) causal; each of seamless's three (``seamless_shapes``:
    the encoder's (4, 128, 16 | 16, 64) non-causal, the decoder's
    self-attention (4, 1024, ...) causal, and the cross-attention (4,
    1024 | 128, ...) non-causal, 1024 decoder rows over 128 encoder
    rows); each backward at the training batch of 2; then
    ``k4_cross_checks``."""
    from repro_torch.configs import registry

    rows = {}
    cfg = registry.get("internvl2-2b")
    rows["flash_attention_internvl2"], \
        rows["flash_attention_bwd_internvl2"] = k4_rows(
            dev, rng, "_internvl2", ATTN_B, ATTN_S, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, causal=True,
            bwd_batch=TRAIN_B)
    cfg = registry.get("seamless-m4t-large-v2")
    for suffix, (Sq, Sk, causal) in seamless_shapes().items():
        rows["flash_attention" + suffix], \
            rows["flash_attention_bwd" + suffix] = k4_rows(
                dev, rng, suffix, ATTN_B, Sq, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, causal=causal, Sk=Sk,
                bwd_batch=TRAIN_B)
    k4_cross_checks(dev, rng, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    return rows


def k4_cross_checks(dev, rng, H: int, K: int, hd: int):
    """K4 and its backward non-causal with a key length of their own,
    at Sq in ``CROSS_SQ`` and Sk in ``CROSS_SK`` (B 2, seamless's heads),
    in bf16 and float32, against their plain versions (bf16 within one
    bf16 ulp, float32 2e-5 forward and 1e-4 gradients), two backward
    calls bitwise equal."""
    from repro_torch.kernels.flash_attention import kernel as fa

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for Sq in CROSS_SQ:
            for Sk in CROSS_SK:
                where = f"{dtype} (2, {Sq} | {Sk}, {H} | {K}, {hd})"
                q, k, v, dout = (
                    torch.from_numpy(rng.standard_normal(shape, np.float32))
                    .to(dev, dtype) for shape in (
                        (2, Sq, H, hd), (2, Sk, K, hd), (2, Sk, K, hd),
                        (2, Sq, H, hd)))
                out = fa.flash_attention(q, k, v, causal=False)
                got = fa.flash_attention_backward(q, k, v, out, dout,
                                                  causal=False)
                again = fa.flash_attention_backward(q, k, v, out, dout,
                                                    causal=False)
                plain = fa.flash_attention_plain(q, k, v, False)
                want = fa.flash_attention_backward_plain(q, k, v, out, dout,
                                                         False)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K4 backward at {where} gave other bits on a second "
                      f"run")
                check(all(g.shape == t.shape for g, t in zip(got, (q, k, v))),
                      f"K4 backward at {where}: gradient shapes "
                      f"{[tuple(g.shape) for g in got]}")
                if dtype == torch.bfloat16:
                    ok = within_one_bf16_ulp([(out, plain)])[0] and \
                        within_one_bf16_ulp(list(zip(got, want)))[0]
                else:
                    ok = torch.allclose(out, plain, atol=2e-5, rtol=2e-5) \
                        and all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                                for a, b in zip(got, want))
                err = max(max_abs_err(a, b) for a, b in
                          [(out, plain)] + list(zip(got, want)))
                check(ok, f"K4 or its backward at {where} differs from plain "
                      f"by {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    print(f"kernel flash_attention (+ backward) non-causal at Sq "
          f"{list(CROSS_SQ)} x Sk {list(CROSS_SK)}, (2, Sq | Sk, {H} | {K}, "
          f"{hd}): within one bf16 ulp of plain in bf16 (max_abs_err "
          f"{worst[torch.bfloat16]:.3e}), within 2e-5 / 1e-4 in float32 "
          f"(max_abs_err {worst[torch.float32]:.3e}); two backward calls "
          f"bitwise equal", flush=True)


def zamba2_kernel_rows(dev, rng):
    """K4, K5 and their backwards at the shapes zamba2-1.2b launches them
    with: K4 at the prefill (1, 32768, 32 | 32, 64) with the window 4096,
    timed beside the same launch without it (``k4_window_prefill_row``);
    the windowed forward and backward against plain at ``HYB_CHECK_S``
    (``k4_window_checks``); K4 and its backward at the training shape (2,
    4096, 32 | 32, 64) (the window does not bite at S = 4096); K5 at the
    prefill (1, 32768, 64, 64, 64) and training (2, 4096, ...) shapes and
    its backward at the latter (P 64, N 64, chunk 256)."""
    from repro_torch.configs import registry

    cfg = registry.get("zamba2-1.2b")
    H, K, hd, W = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                   cfg.attn_window)
    rows = {"flash_attention_zamba2": k4_window_prefill_row(dev, rng, H, K,
                                                            hd, W)}
    k4_window_checks(dev, rng, H, K, hd, W)
    rows["flash_attention_zamba2_train"], \
        rows["flash_attention_bwd_zamba2_train"] = k4_rows(
            dev, rng, "_zamba2_train", HYB_TRAIN_B, HYB_TRAIN_S, H, K, hd,
            causal=True, window=W)
    s = cfg.ssm
    nh, P, N = s.expand * cfg.d_model // s.head_dim, s.head_dim, s.d_state
    rows["ssd_scan_zamba2"] = k5_row(dev, rng, "_zamba2", 1, HYB_PREFILL_S,
                                     nh, P, N, s.chunk)
    rows["ssd_scan_zamba2_train"] = k5_row(dev, rng, "_zamba2_train",
                                           HYB_TRAIN_B, HYB_TRAIN_S, nh, P,
                                           N, s.chunk)
    rows["ssd_scan_bwd_zamba2_train"] = ssd_scan_bwd_row(
        dev, rng, HYB_TRAIN_B, HYB_TRAIN_S, nh, P, N, s.chunk,
        "_zamba2_train")
    return rows


def windowed_plain(q, k, v, window: int, rows: int = HYB_PLAIN_ROWS):
    """K4's plain version with ``window`` over query blocks of ``rows``:
    block [i0, i1) runs ``flash_attention_plain`` on positions [i0 -
    window + 1, i1), which hold every key its queries see (the mask
    depends only on i - j), and keeps its last i1 - i0 rows."""
    from repro_torch.kernels.flash_attention import kernel as fa
    S = q.shape[1]
    out = torch.empty_like(q)
    for i0 in range(0, S, rows):
        i1, j0 = min(S, i0 + rows), max(0, i0 - window + 1)
        part = fa.flash_attention_plain(q[:, j0:i1], k[:, j0:i1],
                                        v[:, j0:i1], True, window)
        out[:, i0:i1] = part[:, i0 - j0:]
    return out


def by_heads(fn, tensors, parts: int = HYB_HEAD_PARTS):
    """``fn`` over ``parts`` slices of the head axis of ``tensors`` (H =
    K: query head h reads kv head h), outputs joined along it: a plain
    version without all its (S, S) scores in memory at once."""
    n = tensors[0].shape[2] // parts
    outs = [fn(*(t[:, :, i * n:(i + 1) * n] for t in tensors))
            for i in range(parts)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o, dim=2) for o in zip(*outs))
    return torch.cat(outs, dim=2)


def within_one_bf16_ulp(pairs):
    """K4's bf16 card check over (kernel, plain) pairs: every element
    within 1e-3 + 2**-7 |x| of plain and each relative RMS <= 2**-8.
    Returns (passed, the largest relative RMS).  Both sides compute in
    float32 and round once to bf16 at the end, so they differ by one bf16
    ulp where their float32 sums round apart: at most 2**-7 of the value
    (atol covers outputs near 0); one ulp is rare, so the relative RMS
    stays well below bf16's unit roundoff.  (The reference's 2e-2,
    tests/test_kernels.py:52, is ~40% of a typical |output| ~ 0.05 at
    qwen3-8b's shape.)"""
    rel = max(float((a.float() - b.float()).norm() / b.float().norm())
              for a, b in pairs)
    close = all(torch.allclose(a.float(), b.float(), atol=1e-3,
                               rtol=2.0 ** -7) for a, b in pairs)
    return close and rel <= BF16_EPS, rel


def k4_window_prefill_row(dev, rng, H: int, K: int, hd: int, window: int):
    """K4 at zamba2-1.2b's prefill launch, (1, HYB_PREFILL_S, H | K, hd)
    bf16, causal with ``window``: bitwise repeatable, within one bf16 ulp
    of its plain version (taken over query blocks, ``windowed_plain``),
    timed beside the same launch without the window, which it must beat
    by more than 2x (the window keeps 4.27x fewer pairs: key tiles wholly
    below it are skipped, not masked), and beside
    ``scaled_dot_product_attention`` with the window as a boolean mask
    (memory-efficient backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import kernel as fa

    S = HYB_PREFILL_S
    where = f"(1, {S}, {H} | {K}, {hd}), causal, window {window}"
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dev, torch.bfloat16)
               for shape in ((1, S, H, hd), (1, S, K, hd), (1, S, K, hd)))
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    again = fa.flash_attention(q, k, v, causal=True, window=window)
    plain = windowed_plain(q, k, v, window)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K4 at {where} gave other bits on a "
          f"second run")
    err = max_abs_err(out, plain)
    ok, rel = within_one_bf16_ulp([(out, plain)])
    check(ok, f"K4 at {where} differs from its plain version by {err} "
          f"(relative RMS {rel})")
    del again, plain
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = sdpa_mask(S, window, dev)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 5)
    del mask
    row = dict(
        name="flash_attention_zamba2", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:87",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=window), 20),
        plain_ms=time_ms(lambda: windowed_plain(q, k, v, window), 3,
                         warmup=1),
        library_ms=library_ms)
    full_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    check(row["ms"] < 0.5 * full_ms,
          f"K4 at {where} took {row['ms']} ms against {full_ms} ms without "
          f"the window: not less than half")
    pairs = window_pairs(S, True, window)
    row["bound_ms"], row["bound_by"] = bound(
        2 * (2 * q.numel() + k.numel() + v.numel()), 4 * H * hd * pairs,
        BF16_FLOPS_PER_S)
    print_row(row, f"{where}: within one bf16 ulp of plain (over query "
              f"blocks of {HYB_PLAIN_ROWS} rows; plain_ms is that), "
              f"relative RMS {rel:.2e}, bitwise equal on a second run")
    print(f"kernel flash_attention_zamba2: {row['ms']:.4f} ms with the "
          f"window against {full_ms:.4f} ms without it "
          f"({full_ms / row['ms']:.2f}x; pairs "
          f"{window_pairs(S, True) / pairs:.2f}x), bound without it "
          f"{bound(0, 4 * H * hd * window_pairs(S, True), BF16_FLOPS_PER_S)[0]:.4f} ms",
          flush=True)
    return row


def k4_window_checks(dev, rng, H: int, K: int, hd: int, window: int):
    """K4 and its backward with ``window`` at (1, HYB_CHECK_S, H | K, hd)
    against their plain versions (over ``HYB_HEAD_PARTS`` slices of the
    heads), in bf16 within one bf16 ulp and in float32 within 1e-4."""
    from repro_torch.kernels.flash_attention import kernel as fa

    S = HYB_CHECK_S
    for dtype in (torch.bfloat16, torch.float32):
        where = f"{dtype} (1, {S}, {H} | {K}, {hd}), window {window}"
        q, k, v, dout = (
            torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, dtype) for shape in ((1, S, H, hd), (1, S, K, hd),
                                          (1, S, K, hd), (1, S, H, hd)))
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        got = fa.flash_attention_backward(q, k, v, out, dout, causal=True,
                                          window=window)
        plain = by_heads(lambda *t: fa.flash_attention_plain(
            *t, True, window), (q, k, v))
        want = by_heads(lambda *t: fa.flash_attention_backward_plain(
            *t, True, window), (q, k, v, out, dout))
        torch.cuda.synchronize()
        pairs = [(out, plain)] + list(zip(got, want))
        err = max(max_abs_err(a, b) for a, b in pairs)
        if dtype == torch.bfloat16:
            ok, tol = within_one_bf16_ulp(pairs)[0], "one bf16 ulp"
        else:
            ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                     for a, b in pairs)
            tol = "1e-4"
        check(ok, f"K4 or its backward at {where} differs from plain by "
              f"{err} (tolerance {tol})")
        print(f"kernel flash_attention (+ backward) {where}: out, dq, dk, dv "
              f"within {tol} of plain (max_abs_err {err:.3e})", flush=True)
        del q, k, v, dout, out, got, plain, want, pairs
        torch.cuda.empty_cache()


def k5_row(dev, rng, suffix: str, B, S, nh, P, N, chunk):
    """K5 in bf16 at (B, S, nh, P, N) against its plain version, timed
    with the L2 flushed beside its bound; the row ``ssd_scan`` +
    ``suffix``."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel as ssd_k

    x = torch.from_numpy(rng.standard_normal((B, S, nh, P), np.float32)
                         ).to(dev, torch.bfloat16)
    dt = F.softplus(torch.from_numpy(
        rng.standard_normal((B, S, nh), np.float32)).to(dev))
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(nh).astype(np.float32) * 0.3).to(dev))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, S, N), np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    y, h = ssd_k.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y_p, h_p = ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    # the reference's tolerances (tests/test_kernels.py:89): 5e-2 for
    # the bf16 y, 5e-4 for the float32 state
    where = f"({B}, {S}, {nh}, {P}, {N}), chunk {chunk}"
    err = max(max_abs_err(y, y_p), max_abs_err(h, h_p))
    check(torch.allclose(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
          and torch.allclose(h, h_p, atol=5e-4, rtol=5e-4),
          f"K5 ssd_scan at {where} differs from its plain version by {err}")
    del y_p, h_p
    row = dict(
        name="ssd_scan" + suffix, route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:79", max_abs_err=err,
        ms=time_ms(lambda: ssd_k.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk), 20),
        plain_ms=time_ms(lambda: ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                      chunk), 5, warmup=1),
        library_ms=None)              # no single PyTorch call computes it
    nbytes = 2 * (2 * x.numel() + Bm.numel() + Cm.numel()) \
        + 4 * (dt.numel() + A.numel() + h.numel())
    # float32 accuracy on the bf16 tensor cores: a float32 operand as hi +
    # lo bf16 parts, two products
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, ssd_flops(B, S, nh, P, N, 2), BF16_FLOPS_PER_S)
    print_row(row, f"{where}: within 5e-2 (y) / 5e-4 (h) of plain")
    print(f"kernel ssd_scan{suffix}: bound priced at the float32 CUDA-core "
          f"rate (before the tensor-core form) "
          f"{bound(nbytes, ssd_flops(B, S, nh, P, N))[0]:.4f} ms", flush=True)
    return row


def ssd_scan_bwd_row(dev, rng, B, S, nh, P, N, chunk, suffix: str = ""):
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
        name="ssd_scan_bwd" + suffix, route="cuda",
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
    print(f"kernel ssd_scan_bwd{suffix}: bound priced at the float32 "
          f"CUDA-core rate "
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


def window_pairs(S: int, causal: bool, window: int = 0, Sk=None) -> int:
    """The (query, key) pairs K4's mask keeps per (batch, head): query i
    sees keys 0..i under the causal mask, the last ``window`` of them
    under a window, every one of the ``Sk`` keys (default S) without a
    mask."""
    if not causal:
        return S * (Sk or S)
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def sdpa_mask(S: int, window: int, dev):
    """The window as ``scaled_dot_product_attention``'s boolean mask
    (True = attend): ``i - window < j <= i``."""
    pos = torch.arange(S, device=dev)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                            - window)


def k4_rows(dev, rng, suffix: str, B: int, S: int, H: int, K: int, hd: int,
            causal: bool, window: int = 0, Sk=None, bwd_batch=None):
    """K4 and its backward in bf16 at (B, S, H | K, hd) (with ``window``,
    causal only; with ``Sk`` keys, default S, non-causal where Sk != S):
    each against its plain version on the same inputs, bitwise
    repeatable, timed with the L2 flushed beside its bound and beside
    ``scaled_dot_product_attention`` (forward, and its backward; a window
    below S as a boolean mask) as a yardstick the port never calls; the
    backward's passes timed by ``torch.profiler``.  The backward runs on
    the first ``bwd_batch`` rows of the batch when given (the training
    shape beside the prefill's).  Returns the two rows, named
    ``flash_attention`` and ``flash_attention_bwd`` + ``suffix``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa

    Sk = Sk or S
    lengths = f"{S}" if Sk == S else f"{S} | {Sk}"
    mask = f"{'' if causal else 'non-'}causal" \
        + (f", window {window}" if window else "")
    where = f"({B}, {lengths}, {H} | {K}, {hd}), {mask}"
    q, k, v, dout = (
        torch.from_numpy(rng.standard_normal(shape, np.float32))
        .to(dev, torch.bfloat16) for shape in ((B, S, H, hd), (B, Sk, K, hd),
                                               (B, Sk, K, hd), (B, S, H, hd)))
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    plain = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K4 at {where} gave other bits on a "
          f"second run")
    err = max_abs_err(out, plain)
    ok, rel = within_one_bf16_ulp([(out, plain)])
    check(ok, f"K4 at {where} differs from its plain version by {err} "
          f"(relative RMS {rel})")
    del again, plain
    gqa = dict(enable_gqa=True) if H != K else {}
    # SDPA's mask: the causal flag, or the window as a boolean mask
    lib_mask = dict(attn_mask=sdpa_mask(S, window, dev)) \
        if window and window < S else dict(is_causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = dict(
        name="flash_attention" + suffix, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:87",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window), 20),
        plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, causal,
                                                          window),
                         5, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **lib_mask, **gqa), 20))
    # each input read once, the output written once; the two products
    # over the (query, key) pairs the mask keeps
    pairs = window_pairs(S, causal, window, Sk)
    size = q.element_size()
    fwd["bound_ms"], fwd["bound_by"] = bound(
        size * (2 * q.numel() + k.numel() + v.numel()),
        4 * B * H * hd * pairs, BF16_FLOPS_PER_S)
    print_row(fwd, f"{where}: within 1e-3 + 2**-7 |x| of plain, relative "
              f"RMS {rel:.2e} <= 2**-8, bitwise equal on a second run")

    if bwd_batch:
        B = bwd_batch
        q, k, v, out, dout = (t[:B] for t in (q, k, v, out, dout))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        where = f"({B}, {lengths}, {H} | {K}, {hd}), {mask}"
    args = (q, k, v, out, dout)
    got = fa.flash_attention_backward(*args, causal=causal, window=window)
    again = fa.flash_attention_backward(*args, causal=causal, window=window)
    want = fa.flash_attention_backward_plain(*args, causal, window)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K4 backward at {where} gave other bits on a second run")
    # as K4: both round once from float32 to bf16
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    ok, rel = within_one_bf16_ulp(list(zip(got, want)))
    check(ok, f"K4 backward at {where} differs from its plain version by "
          f"{err} (relative RMS {rel})")
    del got, again, want
    qt, kt, vt = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, **lib_mask, **gqa)
    lib_dout = dout.transpose(1, 2)
    bwd = dict(
        name="flash_attention_bwd" + suffix, route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none (XLA autodiff of src/repro/models/layers.py:109 "
                 "_sdpa and :127 blockwise_attention)",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention_backward(
            *args, causal=causal, window=window), 10),
        plain_ms=time_ms(lambda: fa.flash_attention_backward_plain(
            *args, causal, window), 3, warmup=1),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_dout, retain_graph=True), 20))
    # q, k, v, out and dout read once, dq, dk, dv written once; five
    # products over the kept pairs (Q K^T, dO V^T, P^T dO, dS^T Q, dS K)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        size * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()),
        5 * 2 * B * H * hd * pairs, BF16_FLOPS_PER_S)
    print_row(bwd, f"{where}: within 1e-3 + 2**-7 |x| of plain, relative "
              f"RMS {rel:.2e} <= 2**-8, bitwise equal on a second run")
    split = pass_ms(lambda: fa.flash_attention_backward(
        *args, causal=causal, window=window), BWD_PASSES)
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
              "collectives (NCCL)": 0.0, "other": 0.0}
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
        elif "nccl" in name.lower():
            groups["collectives (NCCL)"] += us
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


def dense_phase(dev, seed: int, card: str):
    """qwen3-8b at full width; returns K4's launches in one prefill, the
    model, the prefill's tokens and its logits (for the pipeline and
    elastic phases)."""
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
    del full
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
    torch.cuda.empty_cache()
    return launches, model, tokens, logits_pf


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


def ssm_trajectory(model, prefix: torch.Tensor, ring_dtype=None):
    """``compare_logits`` of token-by-token decode from zero state
    against forward on ``prefix``, plus the plain argmax agreement; a
    hybrid model's attention ring buffers cast to ``ring_dtype`` when
    given."""
    full, _ = model({"tokens": prefix})
    cache = model.init_cache(*prefix.shape)
    if ring_dtype is not None:
        cache.update((k, cache[k].to(ring_dtype)) for k in ("ak", "av"))
    outs = []
    for t in range(prefix.shape[1]):
        lg, cache = model.decode_step(cache, prefix[:, t:t + 1], t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel, err, _, exact = compare_logits(dec, full)
    return rel, err, exact


def ssm_phase(dev, seed: int, card: str, mesh):
    """mamba2-1.3b at full width; returns K5's launches in one forward
    and in one sequence-parallel forward over ``mesh`` (``sp_part``)."""
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
    sp_launches = sp_part(model, tokens, full, secs, mesh, card)
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
    return launches, sp_launches


def mesh_rules(cfg, mesh):
    """The sharding rules of ``cfg``'s prefill cell on ``mesh`` (one rank
    on each axis): the reference's ``default_parallelism`` layout through
    ``make_rules``."""
    from repro_torch.configs.base import PREFILL_32K
    from repro_torch.configs.registry import default_parallelism
    from repro_torch.distributed.sharding import make_rules
    return make_rules(cfg, PREFILL_32K, default_parallelism(cfg, PREFILL_32K),
                      tp_size=1, dp_size=1, mesh=mesh)


def sp_part(model, tokens, full, secs: float, mesh, card: str) -> int:
    """The sequence-parallel SSD (``models/ssm_sp.py``) over the NCCL
    world of one: ``Model.forward`` of the same tokens under mamba2-1.3b's
    prefill rules (``act_seq`` -> ``model``), K5 once per layer, logits
    against the local forward's ``full`` (bitwise expected at one rank:
    ``h0`` is 0 and the halo zeros; at most ``depth_tolerance``).
    Returns K5's launches in it."""
    from repro_torch.distributed.sharding import local_block, use_rules
    cfg = model.cfg
    rules = mesh_rules(cfg, mesh)
    check(rules.mapping["act_seq"] == "model",
          f"mamba2-1.3b prefill rules map act_seq to "
          f"{rules.mapping['act_seq']}, not model")
    local = local_block(tokens, rules, "batch", "act_seq")
    reset_counts()
    with use_rules(rules):
        (sp, _), sp_secs = synced_seconds(lambda: model({"tokens": local}))
    launches = read_counts()["ssd_scan"]
    with use_rules(rules):
        _, warm = synced_seconds(lambda: model({"tokens": local}))
    _, local_warm = synced_seconds(lambda: model({"tokens": tokens}))
    check(launches == cfg.n_layers,
          f"K5 launched {launches} times in one sequence-parallel forward, "
          f"expected {cfg.n_layers}")
    rel, err, agree, _ = compare_logits(sp, full)
    tol = depth_tolerance(cfg.n_layers)
    same = bool(torch.equal(sp, full))
    check(same or (rel <= tol and agree == 1.0),
          f"sequence-parallel forward differs from the local forward: "
          f"relative RMS {rel} (tolerance {tol}), argmax agreement {agree}")
    print(f"mamba2-1.3b sequence-parallel forward over a (1, 1) NCCL mesh "
          f"(rules act_seq -> model): {SSM_B} x {SSM_S} tokens in "
          f"{sp_secs:.3f} s (first call), {warm:.3f} s (second) against "
          f"the local forward's {secs:.3f} s (first), {local_warm:.3f} s "
          f"(again), K5 launches {launches} in the first; logits "
          + ("equal the local forward's (torch.equal)" if same else
             f"within relative RMS {rel:.2e} of the local forward's "
             f"(tolerance {tol:.2e}), max abs {err:.3e}") + f" ({card})",
          flush=True)
    segments_check(model, card)
    return launches


def segments_check(model, card: str) -> None:
    """The sequence-parallel hand-off on the card, which a world of one
    never takes (its rank 0 enters from a zero state): layer 0's block at
    full width, the 4 x 1024 sequence cut into 2 and 4 segments, each
    through K5 from a zero state with its halo from the segment before
    and its incoming state from ``ssm_sp.hand_off``
    (``ssm_block_in_segments``), against the local ``ssm_block`` on the
    same input, in bf16 (relative RMS within 2**-6: each segment's y is
    rounded to bf16 once more) and with the block's weights in float32
    (within 1e-4 of the largest output, the reference's SP bound)."""
    from repro_torch.models.ssm import ssm_block
    from repro_torch.models.ssm_sp import ssm_block_in_segments
    cfg = model.cfg
    block = model.blocks[0]["ssm"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(SSM_B, SSM_S, cfg.d_model, generator=gen,
                    device="cuda") * 0.5
    parts = []
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            p = {k: block[k].to(dtype) for k in block.keys()}
            xd = x.to(dtype)
            want = ssm_block(p, xd, cfg).float()
            for n in (2, 4):
                got = ssm_block_in_segments(p, xd, cfg, n).float()
                check(bool(torch.isfinite(got).all()),
                      f"{n} segments: output not finite")
                rel = float((got - want).norm() / want.norm())
                err = float((got - want).abs().max())
                top = float(want.abs().max())
                ok = rel <= 2.0 ** -6 if dtype == torch.bfloat16 \
                    else err <= 1e-4 * top
                check(ok, f"mamba2-1.3b block in {n} segments ({dtype}) "
                      f"differs from the local block: relative RMS {rel}, "
                      f"max abs {err} of {top}")
                parts.append(f"{str(dtype)[6:]} {n} segments: relative RMS "
                             f"{rel:.3e}, max abs {err:.3e} of {top:.3f}")
    print(f"mamba2-1.3b block 0 in segments (halo and K5-state hand-off "
          f"between segments, as ranks 1..n-1 of the sequence-parallel "
          f"path take them) against the local block, {SSM_B} x {SSM_S}: "
          + "; ".join(parts) + " (bf16 tolerance relative RMS 2**-6, "
          f"float32 1e-4 of the largest) ({card})", flush=True)


#: per arch: the training batch and learning rate, the depth (None: the
#: published one), the scan or attention kernel and its backward (names
#: of ``_wrappers``), and the per-layer weights (names within a block)
#: whose gradients reach that kernel (a gradient dropped at the kernel
#: would leave them without one), for moe also the router's, the
#: experts' and the shared experts'; for the hybrid family the sequence
#: (default ``TRAIN_S``) and the weights of the shared attention block
#: (names within it), whose gradients reach K4; for the encdec family the
#: encoder blocks' weights (names within a block of ``enc_blocks``) too
ATTN_WEIGHTS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
SSM_WEIGHTS = tuple(f"ssm.{w}" for w in (
    "wx", "wB", "wC", "wdt", "A_log", "dt_bias", "conv_x", "conv_B",
    "conv_C"))
TRAIN_RUNS = {
    "qwen3-8b": dict(batch=TRAIN_B, lr=TRAIN_LR, layers=None,
                     kernel="flash_attention", bwd="flash_attention_bwd",
                     weights=ATTN_WEIGHTS),
    "mamba2-1.3b": dict(batch=SSM_TRAIN_B, lr=TRAIN_LR, layers=None,
                        kernel="ssd_scan", bwd="ssd_scan_bwd",
                        weights=SSM_WEIGHTS),
    "vit-huge": dict(batch=BATCH, lr=VIT_LR, layers=None,
                     kernel="flash_attention", bwd="flash_attention_bwd",
                     weights=ATTN_WEIGHTS),
    "deepseek-moe-16b": dict(
        batch=TRAIN_B, lr=TRAIN_LR, layers=MOE_TRAIN_LAYERS,
        kernel="flash_attention", bwd="flash_attention_bwd",
        weights=ATTN_WEIGHTS + tuple(f"moe.{w}" for w in (
            "router", "we_gate", "we_up", "we_out", "ws_gate", "ws_up",
            "ws_out"))),
    "zamba2-1.2b": dict(
        batch=HYB_TRAIN_B, seq=HYB_TRAIN_S, lr=TRAIN_LR, layers=None,
        kernel="ssd_scan", bwd="ssd_scan_bwd", weights=SSM_WEIGHTS,
        shared=ATTN_WEIGHTS + ("mlp.wi_gate", "mlp.wi_up", "mlp.wo")),
    "internvl2-2b": dict(batch=TRAIN_B, lr=TRAIN_LR, layers=None,
                         kernel="flash_attention", bwd="flash_attention_bwd",
                         weights=ATTN_WEIGHTS),
    "seamless-m4t-large-v2": dict(
        batch=TRAIN_B, lr=SEAMLESS_LR, layers=None, kernel="flash_attention",
        bwd="flash_attention_bwd",
        weights=ATTN_WEIGHTS + ("cross.wq", "cross.wk", "cross.wv",
                                "cross.wo"),
        encoder=ATTN_WEIGHTS),
}


def step_launches(run, cfg) -> dict:
    """Kernel launches per training step under block remat: the run's
    kernel twice per layer (forward, and again when remat recomputes the
    layer) and its backward once; the encdec family's layers are the
    encoder's and the decoder's, and a decoder layer launches K4 twice
    (self- and cross-attention); the hybrid family's shared attention
    block, which remat leaves out as the reference does, launches K4 and
    its backward once per site."""
    L = cfg.n_layers
    if cfg.family in ("encdec", "audio"):
        L = 2 * L + cfg.n_encoder_layers
    want = {run["kernel"]: 2 * L, run["bwd"]: L}
    if cfg.family == "hybrid":
        sites = L // cfg.hybrid_attn_every
        want.update(flash_attention=sites, flash_attention_bwd=sites)
    return want


def train_phase(dev, seed: int, card: str, arch: str = "qwen3-8b") -> int:
    """``arch`` at its published widths and full depth (or
    ``TRAIN_RUNS[arch]["layers"]``) trained through
    ``launch.train.train_steps``: block remat, int8 moments, one fixed
    batch of ``TRAIN_RUNS[arch]["batch"]`` x ``TRAIN_S`` tokens (for
    vit-huge, of as many images: the first batch of the loader's device
    route through ``launch.train.patch_batch``).  The loss falls and
    ends below ln V (a uniform prediction's), every layer's weights that
    reach the family's kernel get finite, non-zero gradients at every
    step (a gradient dropped at K4 or K5 would leave them without one),
    and the kernel launches twice per layer per step (forward, and again
    under remat) and its backward
    once (``step_launches``; for zamba2-1.2b also K4 and its backward
    once per site of the shared block, whose weights must get gradients
    too; for seamless-m4t-large-v2 the encoder's layers and the decoder's
    cross-attention too).  The token batch is ``launch.train.
    lm_batch_source``'s first (with internvl2-2b's patch embeddings and
    seamless-m4t-large-v2's frame embeddings).  Returns the launch counts
    of the run, and under ``by_shape`` K4's and its backward's by shape
    (``k4_shapes``)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.launch.train import lm_batch_source, train_steps
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
        seq = run.get("seq", TRAIN_S)
        batch = lm_batch_source(model, run["batch"], seq, seed + 2)()
        items, unit = run["batch"] * seq, "tok"
        what = f"{run['batch']} x {seq} tokens"
    L = cfg.n_layers
    want = {f"blocks.{l}.{w}" for l in range(L) for w in run["weights"]} \
        | {f"shared.{w}" for w in run.get("shared", ())} \
        | {f"enc_blocks.{l}.{w}" for l in range(cfg.n_encoder_layers)
           for w in run.get("encoder", ())}
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
    with k4_shapes() as shapes:
        hist = train_steps(model, opt, parallel, lambda: batch, TRAIN_STEPS)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {k: n * TRAIN_STEPS for k, n in step_launches(run, cfg).items()}
    for name, n in expect.items():
        check(counts[name] == n,
              f"{name} launched {counts[name]} times in {TRAIN_STEPS} steps, "
              f"expected {n} (step_launches)")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training losses {losses} are not finite or do not fall")
    # a uniform prediction's loss: a model that fits its batch ends below
    uniform = math.log(cfg.n_classes if cfg.family == "encoder"
                       else cfg.vocab_size)
    check(losses[-1] < uniform, f"training losses {losses} end at or above "
          f"ln V = {uniform:.4f}, a uniform prediction's loss")
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
          f"{[round(x, 4) for x in losses]} (ln V {uniform:.4f}); grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; step seconds "
          f"{[round(x, 3) for x in secs]}; median of steps 2-{TRAIN_STEPS} "
          f"{steady:.3f} s = {items / steady:.1f} {unit}/s; peak memory "
          f"{peak / 1e9:.2f} GB of {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; "
          f"launches " + ", ".join(f"{k} {counts[k]}" for k in expect)
          + f"; gradient norms of {len(want)} weights "
          f"({', '.join(run['weights'] + run.get('shared', ()))}"
          + (f"; encoder {', '.join(run['encoder'])}" if "encoder" in run
             else "") + ") "
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
    return dict({k: counts[k] for k in expect}, by_shape=shapes,
                losses=losses)


def restore_params(model, saved) -> None:
    """Copy ``saved`` ({name: tensor}) back into ``model``'s parameters."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(saved[n])


def within_bf16_ulps(got, want) -> float:
    """The largest |got - want| over all parameters, in bf16 ulps of
    ``want`` (the spacing at each element's magnitude)."""
    worst = 0.0
    for n, w in want.items():
        g = got[n].float()
        w = w.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(
            torch.finfo(torch.bfloat16).tiny))) - 7)
        worst = max(worst, float(((g - w).abs() / ulp).max()))
    return worst


def dp_phase(dev, seed: int, card: str, mesh, plain_losses):
    """The explicit-collective data-parallel step (``train/dp_shard.py``)
    over the NCCL world of one, mamba2-1.3b at its published widths and
    full depth on ``train_phase``'s batch and rate: (a) two
    ``build_train_step`` steps and two ``build_dp_train_step`` steps from
    the same weights (int8 moments, no remat: the DP step has none, as the
    reference's), parameters within one bf16 ulp (bitwise expected: the
    all-reduce of one rank and the division by 1 are exact); (b)
    ``TRAIN_STEPS`` steps with ``compress_grads=True``: the last loss
    within 0.1 of ``train_phase``'s uncompressed run (``plain_losses``,
    the reference's bound, tests/test_distributed.py:99) and below ln V.
    Prints the step seconds of each run and the seconds of each
    ``allreduce_compressed`` over the whole gradient.  Returns K5's and
    its backward's launches over the DP steps."""
    from repro_torch.configs.base import ParallelismConfig
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.train import compression
    from repro_torch.train.dp_shard import build_dp_train_step
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step

    run = TRAIN_RUNS["mamba2-1.3b"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model("mamba2-1.3b", dev, seed)
    cfg = model.cfg
    batch = lm_batch_source(model, run["batch"], TRAIN_S, seed + 2)()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_params = sum(p.numel() for p in init.values())

    def opt():
        return AdamW(lr=run["lr"], state_dtype="int8")

    def steps(step, n, *state):
        secs, hist = [], []
        for _ in range(n):
            out, t = synced_seconds(lambda: step(model, *state, batch))
            state = out[1:-1]
            hist.append(float(out[-1]["loss"]))
            secs.append(t)
        return hist, secs

    o = opt()
    single_hist, single_s = steps(build_train_step(
        model, ParallelismConfig(), o), 2, o.init(model))
    single = {n: p.detach().clone() for n, p in model.named_parameters()}
    restore_params(model, init)
    o = opt()
    reset_counts()
    dp_hist, dp_s = steps(build_dp_train_step(model, o, mesh), 2,
                          o.init(model), compression.init_ef(model))
    got = {n: p.detach() for n, p in model.named_parameters()}
    same = all(torch.equal(got[n], single[n]) for n in single)
    ulps = within_bf16_ulps(got, single)
    check(ulps <= 1.0, f"data-parallel parameters differ from the "
          f"single-device step's by {ulps} bf16 ulps after 2 steps")
    del single, got
    restore_params(model, init)
    del init
    o = opt()
    reduce_s = []
    real = compression.allreduce_compressed

    def timed(grads, ef, group=None):
        out, t = synced_seconds(lambda: real(grads, ef, group))
        reduce_s.append(t)
        return out

    compression.allreduce_compressed = timed
    try:
        comp_hist, comp_s = steps(build_dp_train_step(
            model, o, mesh, compress_grads=True), TRAIN_STEPS,
            o.init(model), compression.init_ef(model))
    finally:
        compression.allreduce_compressed = real
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_dp = 2 + TRAIN_STEPS
    for name in ("ssd_scan", "ssd_scan_bwd"):
        check(counts[name] == cfg.n_layers * n_dp,
              f"{name} launched {counts[name]} times in {n_dp} "
              f"data-parallel steps, expected {cfg.n_layers * n_dp}")
    uniform = math.log(cfg.vocab_size)
    check(all(np.isfinite(comp_hist))
          and abs(comp_hist[-1] - plain_losses[-1]) < 0.1
          and comp_hist[-1] < uniform,
          f"compressed data-parallel losses {comp_hist}: the last not "
          f"within 0.1 of the uncompressed run's {plain_losses[-1]}, or "
          f"not below ln V {uniform:.4f}")
    print(f"mamba2-1.3b data-parallel step over a (1, 1) NCCL mesh "
          f"(int8 moments, no remat, {run['batch']} x {TRAIN_S} tokens): "
          f"2 steps losses {[round(x, 4) for x in dp_hist]} against "
          f"build_train_step's {[round(x, 4) for x in single_hist]}; "
          f"parameters "
          + ("equal (torch.equal)" if same else f"within {ulps:.2f} bf16 "
             f"ulps") + f"; step seconds {[round(x, 3) for x in dp_s]} "
          f"against {[round(x, 3) for x in single_s]} ({card})", flush=True)
    print(f"mamba2-1.3b compressed data-parallel step (int8 error-feedback "
          f"all-reduce of {n_params:,} gradient elements): {TRAIN_STEPS} "
          f"steps losses {[round(x, 4) for x in comp_hist]} against the "
          f"uncompressed run's {[round(x, 4) for x in plain_losses]} (last "
          f"within 0.1; ln V {uniform:.4f}); step seconds "
          f"{[round(x, 3) for x in comp_s]}; allreduce_compressed seconds "
          f"{[round(x, 3) for x in reduce_s]}; K5 launches "
          f"{counts['ssd_scan']}, its backward {counts['ssd_scan_bwd']} over "
          f"{n_dp} data-parallel steps; peak memory {peak / 1e9:.2f} GB "
          f"({card})", flush=True)
    del model, o, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts["ssd_scan"], counts["ssd_scan_bwd"]


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

    def counting(top_e, n_experts, capacity, e_start=0):
        slot, src = plan(top_e, n_experts, capacity, e_start)
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


def moe_phase(dev, seed: int, card: str, mesh):
    """deepseek-moe-16b: (a) serving at published widths and full depth,
    with one expert-parallel prefill over ``mesh`` (``ep_part``), (b)
    ``train_phase`` at published widths and ``MOE_TRAIN_LAYERS`` layers.
    Returns (K4's launches in one prefill, in the expert-parallel
    prefill, and K4 backward's in the training run)."""
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
    ep_launches = ep_part(model, tokens, logits_pf, warm, mesh, card)
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
    bwd = train_phase(dev, seed, card, arch)["flash_attention_bwd"]
    return launches, ep_launches, bwd


def ep_part(model, tokens, want, secs: float, mesh, card: str) -> int:
    """The expert-parallel moe over the NCCL world of one: the experts'
    weights placed by deepseek-moe-16b's prefill rules
    (``distribute_model(..., experts_only=True)``, the data-parallel
    step's expert-parallel program: ``Shard(0)`` on ``model``, all 64
    experts on this rank from offset 0), one ``Model.prefill`` of the
    same tokens under them, K4 once per layer, logits equal to the local
    prefill's ``want``.  The model's parameters are put back after.
    Returns K4's launches in the prefill."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import (distribute_model,
                                                  local_block, use_rules)
    from repro_torch.models.params import ParamDef, ParamTree
    cfg = model.cfg
    rules = mesh_rules(cfg, mesh)
    check(rules.ep_axis == "model", f"deepseek-moe-16b prefill rules give "
          f"ep_axis {rules.ep_axis}")
    whole = [(tree, name, tree[name]) for tree in model.modules()
             if isinstance(tree, ParamTree)
             for name, d in tree.defs.items() if isinstance(d, ParamDef)]
    distribute_model(model, rules, experts_only=True)
    placed = [n for n, p in model.named_parameters()
              if isinstance(p, DTensor)]
    check(len(placed) == 3 * cfg.n_layers,
          f"{len(placed)} expert weights placed, expected "
          f"{3 * cfg.n_layers}")
    local = local_block(tokens, rules, "batch", None)
    try:
        reset_counts()
        with use_rules(rules):
            (got, _), ep_first = synced_seconds(lambda: model.prefill(
                {"tokens": local}, model.init_cache(*local.shape[:1],
                                                    ATTN_S_MAX)))
        launches = read_counts()["flash_attention"]
        with use_rules(rules):
            _, ep_secs = synced_seconds(lambda: model.prefill(
                {"tokens": local}, model.init_cache(*local.shape[:1],
                                                    ATTN_S_MAX)))
    finally:
        for tree, name, p in whole:
            setattr(tree, name, p)
        model.experts_only = False
    check(launches == cfg.n_layers, f"K4 launched {launches} times in the "
          f"expert-parallel prefill, expected {cfg.n_layers}")
    check(torch.equal(got, want), "expert-parallel prefill logits differ "
          "from the local prefill's")
    print(f"deepseek-moe-16b expert-parallel prefill over a (1, 1) NCCL "
          f"mesh ({len(placed)} expert weights as DTensor Shard(0) on "
          f"model, {cfg.moe.n_experts} local experts from offset 0): "
          f"{ATTN_B} x {ATTN_S} tokens in {ep_first:.3f} s (first call), "
          f"{ep_secs:.3f} s (second) against the local prefill's "
          f"{secs:.3f} s (second call), K4 launches {launches} in the "
          f"first; "
          f"logits equal the local prefill's (torch.equal) ({card})",
          flush=True)
    ranges_check(model, card)
    return launches


def ranges_check(model, card: str) -> None:
    """The expert-parallel ranks' dispatch on the card, which a world of
    one never takes past offset 0: the first moe layer at full width
    routes 4 x 1024 tokens (random, bf16) at its capacity factor, and the
    outputs of ``_dispatch_local`` over 2 and 4 expert ranges (offsets
    ``r * E / n``) summed, as the all-reduce sums the ranks', against
    the dispatch over all 64 experts: relative RMS within 2**-6 (the
    ranges' partial sums are added in another order in bf16)."""
    from repro_torch.models import moe as moe_mod
    cfg = model.cfg
    e = cfg.moe
    p = next(b["moe"] for b in model.blocks if "moe" in b)
    gen = torch.Generator(device="cuda").manual_seed(8)
    T = ATTN_B * ATTN_S
    x2d = torch.randn(T, cfg.d_model, generator=gen, device="cuda").to(
        p["router"].dtype)
    parts = []
    with torch.no_grad():
        top_e, top_g, _ = moe_mod._route(x2d, p["router"], e.top_k)
        cap = moe_mod._capacity(T, e.top_k, e.n_experts, e.capacity_factor)
        want = moe_mod._dispatch_local(x2d, top_e, top_g, cap, p["we_gate"],
                                       p["we_up"], p["we_out"]).float()
        for n in (2, 4):
            k = e.n_experts // n
            got = sum(moe_mod._dispatch_local(
                x2d, top_e, top_g, cap,
                *(p[w][lo:lo + k] for w in ("we_gate", "we_up", "we_out")),
                e_start=lo) for lo in range(0, e.n_experts, k)).float()
            rel = float((got - want).norm() / want.norm())
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and rel <= 2.0 ** -6,
                  f"deepseek-moe-16b dispatch over {n} expert ranges summed "
                  f"differs from the dispatch over all experts: relative "
                  f"RMS {rel}, max abs {err}")
            parts.append(f"{n} ranges: relative RMS {rel:.3e}, max abs "
                         f"{err:.3e}")
    print(f"deepseek-moe-16b dispatch over expert ranges (offsets > 0, as "
          f"ranks 1..n-1 of the expert-parallel path take them) summed "
          f"against the dispatch over all {e.n_experts} experts, {T} tokens, "
          f"capacity {cap}: " + "; ".join(parts)
          + f" (tolerance relative RMS 2**-6) ({card})", flush=True)


def hybrid_phase(dev, seed: int, card: str):
    """zamba2-1.2b at its published widths and full depth (random bf16
    weights from ``--seed``, 1.17 B parameters): (a) ``Model.prefill`` of
    1 x ``HYB_PREFILL_S`` tokens: K4 once per site of the shared block
    (window 4096), K5 once per layer, logits equal to forward's and
    finite, the cache untouched (the reference's ssm and hybrid prefill
    returns forward's logits and the cache it was given); the device
    split of one prefill; (b) token-by-token decode from zero state
    against forward on ``HYB_B`` x ``HYB_PREFIX`` tokens: bf16 reported
    (as mamba2's), float32 checked, with the ring buffers cast to
    float32 (the reference's attention cache is bf16, so its float32
    decode raises TypeError, and so does the port's); the ``Server``
    defaults between the two; (c) ``train_phase``.  Returns the
    prefill's launch counts and the training run's."""
    model = build_model("zamba2-1.2b", dev, seed)
    cfg = model.cfg
    sites = cfg.n_layers // cfg.hybrid_attn_every
    rng = np.random.default_rng(seed + 3)
    S = HYB_PREFILL_S
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(dev)
    cache = model.init_cache(1, S)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits_pf, new_cache), secs = synced_seconds(
        lambda: model.prefill({"tokens": tokens}, cache))
    counts = read_counts()
    check(counts["flash_attention"] == sites
          and counts["ssd_scan"] == cfg.n_layers,
          f"one prefill launched K4 {counts['flash_attention']} times "
          f"(expected {sites}) and K5 {counts['ssd_scan']} (expected "
          f"{cfg.n_layers})")
    check(new_cache is cache and not any(bool(t.any())
                                         for t in cache.values()),
          "the hybrid prefill changed the cache it was given")
    print(f"zamba2-1.2b prefill: 1 x {S} tokens in {secs:.3f} s = "
          f"{S / secs:.1f} tok/s, K4 launches {counts['flash_attention']} "
          f"(window {cfg.attn_window}), K5 launches {counts['ssd_scan']}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({card})", flush=True)
    (full, _), secs = synced_seconds(lambda: model({"tokens": tokens}))
    check(torch.equal(logits_pf, full), "zamba2-1.2b prefill logits differ "
          "from forward's")
    check(bool(torch.isfinite(full).all()), "forward logits are not finite")
    print(f"zamba2-1.2b forward: {secs:.3f} s; prefill logits equal "
          f"forward's (torch.equal), finite", flush=True)
    del full, logits_pf, cache, new_cache
    torch.cuda.empty_cache()
    device_split(lambda: model.prefill({"tokens": tokens},
                                       model.init_cache(1, S)),
                 "zamba2-1.2b prefill")
    del tokens
    torch.cuda.empty_cache()
    prefix = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (HYB_B, HYB_PREFIX))).to(dev)
    rel, err, agree = ssm_trajectory(model, prefix)
    print(f"zamba2-1.2b bf16 decode trajectory over {HYB_PREFIX} tokens vs "
          f"forward: relative RMS {rel:.5f}, max abs {err:.4f}, argmax "
          f"agreement {agree:.3f} (reported, not checked)", flush=True)
    serve_phase(model, seed, card)
    model.float()
    rel, err, agree = ssm_trajectory(model, prefix, torch.float32)
    # as mamba2's float32 trajectory: 1e-4 and the reference's argmax
    # criterion
    check(rel <= 1e-4 and agree >= 0.9,
          f"zamba2-1.2b float32 decode trajectory differs from forward: "
          f"relative RMS {rel}, argmax agreement {agree}")
    print(f"zamba2-1.2b float32 decode trajectory over {HYB_PREFIX} tokens "
          f"(ring buffers cast to float32) vs forward: relative RMS "
          f"{rel:.2e} (tolerance 1e-4), max abs {err:.2e}, argmax agreement "
          f"{agree:.3f}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, train_phase(dev, seed, card, "zamba2-1.2b")


def vlm_encdec_phase(dev, seed: int, card: str, arch: str):
    """internvl2-2b or seamless-m4t-large-v2 at its published widths and
    full depth (random bf16 weights from ``--seed``): (a)
    ``Model.prefill`` of ``ATTN_B`` x ``ATTN_S`` positions from
    ``launch.train.lm_batch_source`` (internvl2: 256 patch embeddings and
    768 tokens; seamless: 1024 tokens over ``encdec_src_len(1024)`` = 128
    frames) into a cache of ``ATTN_S_MAX``: K4 once per attention (24;
    seamless 72: 24 encoder, 24 self, 24 cross), logits equal to
    forward's and finite, seamless's cross keys and values *replacing*
    the cache's 136 rows with prefill's 128, as the reference's; the
    device split of one prefill; decode at index ``ATTN_S`` (seamless
    reading prefill's cross rows) against forward on the extended
    sequence within ``depth_tolerance`` of the decoder's depth, with the
    argmax check of qwen3-8b's phase; (b) the ``Server`` defaults
    (seamless's decodes against the zero cross cache of ``init_cache``,
    as the reference's ``Server``: reported); (c) ``train_phase``.
    Returns, by the suffix of K4's rows (internvl2's one shape,
    seamless's three: ``seamless_shapes``), K4's launches at that shape
    in one prefill and its backward's in the training run."""
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.models.transformer import encdec_src_len

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(arch, dev, seed)
    cfg = model.cfg
    cross = cfg.family in ("encdec", "audio")
    batch = lm_batch_source(model, ATTN_B, ATTN_S, seed + 4)()
    del batch["labels"]
    if cross:
        what = (f"{ATTN_B} x {ATTN_S} tokens over "
                f"{batch['src_embeds'].shape[1]} frames")
        expect = 2 * cfg.n_layers + cfg.n_encoder_layers
    else:
        P = cfg.frontend_tokens
        what = (f"{ATTN_B} x {ATTN_S} positions ({P} patches + "
                f"{ATTN_S - P} tokens)")
        expect = cfg.n_layers
    cache = model.init_cache(ATTN_B, ATTN_S_MAX)
    reset_counts()
    with k4_shapes() as shapes:
        (logits_pf, new_cache), secs = synced_seconds(
            lambda: model.prefill(batch, cache))
    launches = read_counts()["flash_attention"]
    check(launches == expect, f"K4 launched {launches} times in one {arch} "
          f"prefill, expected {expect}")
    if cross:
        # each of the three shapes once per layer
        by_row = {suffix: shapes[("flash_attention", *shape)]
                  for suffix, shape in seamless_shapes().items()}
        check(set(by_row.values()) == {cfg.n_layers},
              f"K4's launches in one {arch} prefill by shape {dict(shapes)},"
              f" expected {cfg.n_layers} at each of {seamless_shapes()}")
    else:
        by_row = {"_internvl2": launches}
    _, warm = synced_seconds(lambda: model.prefill(
        batch, model.init_cache(ATTN_B, ATTN_S_MAX)))
    print(f"{arch} prefill: {what} in {secs:.3f} s (first call), "
          f"{warm:.3f} s = {ATTN_B * ATTN_S / warm:.1f} positions/s "
          f"(second), K4 launches {launches} ("
          + ", ".join(f"{suffix[1:]} {n}" for suffix, n in by_row.items())
          + f"), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})",
          flush=True)
    if cross:
        rows = (cache["ck"].shape[2], new_cache["ck"].shape[2])
        check(rows == (encdec_src_len(ATTN_S_MAX), encdec_src_len(ATTN_S))
              and new_cache["cv"].shape == new_cache["ck"].shape,
              f"{arch} prefill's cross cache has {rows[1]} rows (the "
              f"cache's {rows[0]}), expected {encdec_src_len(ATTN_S)}")
        print(f"{arch} prefill: the cross keys and values replace the "
              f"cache's {rows[0]} rows (encdec_src_len({ATTN_S_MAX})) with "
              f"{rows[1]} (encdec_src_len({ATTN_S})), as the reference's",
              flush=True)
    (full, _), secs = synced_seconds(lambda: model(batch))
    check(torch.equal(logits_pf, full), f"{arch} prefill logits differ from "
          f"forward's")
    check(bool(torch.isfinite(full).all()), f"{arch} forward logits are not "
          f"finite")
    print(f"{arch} forward: {secs:.3f} s; prefill logits equal forward's "
          f"(torch.equal), finite", flush=True)
    del full, logits_pf
    torch.cuda.empty_cache()
    device_split(lambda: model.prefill(batch, model.init_cache(
        ATTN_B, ATTN_S_MAX)), f"{arch} prefill")
    rng = np.random.default_rng(seed + 5)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ATTN_B, 1))
                           ).to(dev)
    dec, _ = model.decode_step(new_cache, nxt, ATTN_S)
    ext, _ = model(dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1)))
    tol = depth_tolerance(cfg.n_layers)
    rel, err, agree, exact = compare_logits(dec[:, 0], ext[:, -1])
    check(rel <= tol and agree == 1.0,
          f"{arch} decode at index {ATTN_S} differs from forward: relative "
          f"RMS {rel} (tolerance {tol}), argmax agreement {agree} (near "
          f"ties of {NEAR_TIE_ULPS} bf16 ulps included)")
    reads = " (prefill's cross rows)" if cross else ""
    print(f"{arch} decode at index {ATTN_S} vs forward on {ATTN_S + 1} "
          f"positions{reads}: "
          f"relative RMS {rel:.5f} (tolerance {tol:.5f}), max abs {err:.4f}, "
          f"argmax agreement {agree:.2f} with near ties of {NEAR_TIE_ULPS} "
          f"ulps, {exact:.2f} exact", flush=True)
    del cache, new_cache, dec, ext, batch
    torch.cuda.empty_cache()
    serve_phase(model, seed, card)
    if cross:
        print(f"{arch} serving: the Server prefills through the decode step "
              f"and decodes against init_cache's zero cross keys and values "
              f"(the encoder never runs), as the reference's Server "
              f"(reported, not checked against forward)", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(dev, seed, card, arch)
    if cross:
        shapes = seamless_shapes(TRAIN_S)
        bwd = {suffix: train["by_shape"][("flash_attention_bwd", *shape)]
               for suffix, shape in shapes.items()}
        fwd = {suffix: train["by_shape"][("flash_attention", *shape)]
               for suffix, shape in shapes.items()}
        check(set(bwd.values()) == {cfg.n_layers * TRAIN_STEPS}
              and set(fwd.values()) == {2 * cfg.n_layers * TRAIN_STEPS},
              f"{arch} training: K4 by shape {fwd}, its backward {bwd}, "
              f"expected {2 * cfg.n_layers} and {cfg.n_layers} per step at "
              f"each of {shapes}")
    else:
        bwd = {"_internvl2": train["flash_attention_bwd"]}
    return {suffix: (by_row[suffix], bwd[suffix]) for suffix in by_row}


def mesh_world(card: str):
    """One NCCL process group of world size 1 on a file store under the
    build directory, and the (1, 1) ``("data", "model")`` mesh over it
    (``launch.mesh.make_debug_mesh``): the mesh layer's collectives run
    through NCCL on the card.  Returns (mesh, store file)."""
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    store = ROOT / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    init_world(f"file://{store}", 0, 1)
    mesh = make_debug_mesh()
    import torch.distributed as dist
    check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
          f"mesh world: backend {dist.get_backend()}, mesh {mesh}")
    # NCCL sets up a communicator at a group's first collective: one
    # all-reduce on each axis's group here keeps that out of the timings
    one = torch.ones(1, device="cuda")
    _, first = synced_seconds(lambda: [
        dist.all_reduce(one, group=mesh.get_group(a))
        for a in mesh.mesh_dim_names])
    check(float(one) == 1.0, f"an all-reduce of 1 over one rank gave "
          f"{float(one)}")
    print(f"mesh: NCCL world of 1 (torch.distributed backend "
          f"{dist.get_backend()}), DeviceMesh {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}; the first all-reduce on each axis's "
          f"group (communicator set-up) {first:.3f} s ({card})", flush=True)
    return mesh, store


#: the pipeline phase: microbatches, and the stages of the schedule run
#: by hand in one process
PP_MICROBATCHES, PP_STAGES = 4, 4


def pp_phase(model, seed: int, card: str) -> int:
    """qwen3-8b's blocks through ``pipeline_forward`` on a ``("pipe",)``
    mesh of one rank over the NCCL world: ``ATTN_B`` x ``ATTN_S`` embedded
    tokens in ``PP_MICROBATCHES`` microbatches, bitwise equal to
    ``run_decoder`` on each microbatch in turn, K4 (M + S - 1) x L/S
    times; the schedule over ``PP_STAGES`` stages run in one process
    (``pipeline_forward_local``, the same tick) likewise; the collectives
    recorded (``hlo_collectives.record``) and the four-stage schedule's
    accounted on the H100 profile.  Returns K4's launches in the
    pipeline."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.pp import (pipeline_forward,
                                            pipeline_forward_local)
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import analysis, hlo_collectives
    cfg, dev = model.cfg, model.device
    M, S, L = PP_MICROBATCHES, PP_STAGES, cfg.n_layers
    rng = np.random.default_rng(seed + 27)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ATTN_B, ATTN_S))).to(dev)
    positions = torch.arange(ATTN_S, device=dev)
    with torch.no_grad():
        x = tfm._embed_inputs(model, cfg, {"tokens": tokens})

    def block(lp, h):
        return tfm._attn_block(lp, h, cfg, positions, causal=True)[0]

    def per_microbatch():
        with torch.no_grad():
            return torch.cat([tfm.run_decoder(model, xm, cfg, positions)[0]
                              for xm in x.chunk(M)])

    pipe = init_device_mesh(dev.type, (1,), mesh_dim_names=("pipe",))
    # the pipe group's communicator is set up at its first collective:
    # here, out of the timings
    torch.distributed.all_reduce(torch.ones(1, device=dev),
                                 group=pipe.get_group("pipe"))
    want, ref_secs = synced_seconds(per_microbatch)
    reset_counts()
    out, secs = synced_seconds(lambda: pipeline_forward(
        block, model.blocks, x, pipe, microbatches=M))
    launches = read_counts()["flash_attention"]
    check(launches == M * L, f"K4 launched {launches} times in the "
          f"pipeline, expected (M + S - 1) x L/S = {M * L}")
    check(torch.equal(out, want), "the pipeline's hidden states differ "
          "from run_decoder's on each microbatch")
    with torch.no_grad():
        whole, whole_secs = synced_seconds(lambda: tfm.run_decoder(
            model, x, cfg, positions)[0])
    err = float((out.float() - whole.float()).abs().max())
    print(f"qwen3-8b pipeline_forward, 1 stage x {L} blocks, {M} "
          f"microbatches of 1 x {ATTN_S}: {secs:.4f} s against "
          f"run_decoder per microbatch {ref_secs:.4f} s (bitwise equal, "
          f"torch.equal) and on the whole batch {whole_secs:.4f} s (max abs "
          f"difference {err:.6g}, other cuBLAS shapes); K4 launches "
          f"{launches} ({card})", flush=True)
    del whole
    with hlo_collectives.record() as rec:
        again = pipeline_forward(block, model.blocks, x, pipe, microbatches=M)
    check(torch.equal(again, want), "the recorded pipeline run differs")
    st = rec.analyze()
    print(f"recorded collectives of the world-of-one pipeline: "
          f"{[dataclasses.astuple(r) for r in rec.records]} -> "
          f"{st.summary()}", flush=True)
    check(dict(st.per_kind_count) == {"all-reduce": 1},
          f"the world-of-one pipeline issued {dict(st.per_kind_count)}")
    del again

    reset_counts()
    four, four_secs = synced_seconds(lambda: pipeline_forward_local(
        block, model.blocks, x, S, microbatches=M))
    n4 = read_counts()["flash_attention"]
    check(n4 == (M + S - 1) * S * (L // S), f"K4 launched {n4} times in the "
          f"{S}-stage schedule, expected {(M + S - 1) * S * (L // S)}")
    check(torch.equal(four, want), f"the {S}-stage schedule's hidden states "
          f"differ from run_decoder's on each microbatch")
    mb_bytes = x[:ATTN_B // M].numel() * x.element_size()
    recs = [hlo_collectives.Record("collective-permute", mb_bytes, S)] \
        * (M + S - 1) + [hlo_collectives.Record(
            "all-reduce", x.numel() * x.element_size(), S)]
    st = hlo_collectives.analyze(recs)
    t_coll = st.total_wire_bytes / analysis.H100.link_bytes_per_s
    print(f"{S}-stage schedule by hand ({S} x {L // S} blocks, {M + S - 1} "
          f"ticks): {four_secs:.4f} s, bitwise equal to run_decoder per "
          f"microbatch, K4 launches {n4}; per rank on {S} ranks: "
          f"{M + S - 1} hand-offs of {ATTN_B // M} x {ATTN_S} x "
          f"{cfg.d_model} bf16 and one all-reduce of the {ATTN_B} x "
          f"{ATTN_S} x {cfg.d_model} output over {S}: {st.summary()}, "
          f"collective term {t_coll * 1e3:.4f} ms at "
          f"{analysis.H100.link_bytes_per_s / 1e9:.0f} GB/s "
          f"({analysis.H100.name} profile)", flush=True)
    shape = ShapeConfig("pipeline_prefill", ATTN_S, ATTN_B, "prefill")
    flops = analysis.model_flops(cfg, shape)
    print(f"analysis.model_flops of a {ATTN_B} x {ATTN_S} prefill: "
          f"{flops:.6g} (the whole model, embedding and head included, "
          f"which the pipeline does not run); over the pipeline's "
          f"{secs:.4f} s: {flops / secs / 1e12:.2f} TFLOP/s, "
          f"{100 * flops / secs / analysis.H100.peak_bf16_flops:.1f}% of "
          f"the {analysis.H100.peak_bf16_flops / 1e12:.0f} TFLOP/s bf16 "
          f"peak ({card})", flush=True)
    return launches


def elastic_phase(model, tokens, logits_pf, card: str) -> None:
    """``reshard`` qwen3-8b's parameters by ``partition_specs`` under its
    prefill rules onto ``make_mesh(1)``: no demotion, every local block
    bitwise its source, and a prefill of ``dense_phase``'s tokens from a
    model loaded with the local blocks gives ``dense_phase``'s logits
    bitwise (K4 once per layer)."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.configs.base import PREFILL_32K
    from repro_torch.configs.registry import default_parallelism
    from repro_torch.distributed.elastic import make_mesh, reshard
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build
    from repro_torch.models.params import load_tree, partition_specs
    cfg = model.cfg
    rules = make_rules(cfg, PREFILL_32K, default_parallelism(cfg,
                                                             PREFILL_32K))
    specs = partition_specs(tfm.param_defs(cfg), rules)
    mesh = make_mesh(1, device=model.device.type)
    (tree, plan), secs = synced_seconds(lambda: reshard(model, specs, mesh))
    check(plan.demotions == [], f"reshard onto {tuple(mesh.shape)} demoted "
          f"{plan.demotions}")
    fresh = build(cfg)
    load_tree(fresh, tree)
    pairs = list(zip(fresh.parameters(), model.parameters()))
    check(all(torch.equal(a, b) for a, b in pairs),
          "a resharded local block differs from its source")
    leaves = _leaves(tree)
    check(all(isinstance(p, DTensor) and p.device_mesh is mesh
              for p in leaves), "reshard gave a leaf off the new mesh")
    sharded = sum(any(isinstance(q, Shard) for q in p.placements)
                  for p in leaves)
    reset_counts()
    (logits, _), psecs = synced_seconds(lambda: fresh.prefill(
        {"tokens": tokens}, fresh.init_cache(ATTN_B, ATTN_S_MAX)))
    launches = read_counts()["flash_attention"]
    check(launches == cfg.n_layers, f"K4 launched {launches} times in the "
          f"resharded prefill, expected {cfg.n_layers}")
    check(torch.equal(logits, logits_pf), "the resharded prefill's logits "
          "differ from dense_phase's")
    print(f"qwen3-8b reshard onto make_mesh(1) {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}: {plan.summary()}, {len(leaves)} leaves "
          f"({sharded} with a Shard placement) in {secs:.3f} s; every local "
          f"block equal to its source; prefill from the local blocks "
          f"{psecs:.3f} s, logits equal to dense_phase's (torch.equal), K4 "
          f"launches {launches} ({card})", flush=True)


#: the dry-run phase's cells, as ShapeConfig fields: qwen3-8b's prefill of
#: dense_phase's shape and one data-parallel step of mamba2-1.3b at
#: train_phase's
DRY_PREFILL = ("prefill", ATTN_S, ATTN_B, "prefill")
DRY_TRAIN = ("train", SSM_S, SSM_TRAIN_B, "train")
#: the traced peak memory against the allocator's, relative
DRY_PEAK_TOL = 0.05
#: the production sweep's processes at once (one ``launch.dryrun`` per
#: arch, each with one intra-op thread: with torch's default of one per
#: core the multi mesh's sweep took 120.7 s on an H100's 8-core host,
#: with one 82.8 s; nothing else runs then), and its meshes: the
#: multi-pod one only, since over both the sweep took 190 s of the
#: script's 1,200; ``python -m repro_torch.launch.dryrun --arch all
#: --shape all --mesh single,multi`` traces both
SWEEP_PROCS = 8
SWEEP_MESHES = ("multi",)

_DRY_CHILD = """
import dataclasses, json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import registry
from repro_torch.configs.base import ParallelismConfig, ShapeConfig
from repro_torch.launch.dryrun import lower_cell
over = json.loads(sys.argv[3])
if over["n_layers"]:
    full = registry.get
    registry.get = lambda arch: dataclasses.replace(
        full(arch), n_layers=over["n_layers"])
parallel = over["parallel"] and ParallelismConfig(**over["parallel"])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
rec = lower_cell(sys.argv[1], ShapeConfig(*json.loads(sys.argv[2])),
                 multi_pod=False, mesh=mesh, parallel=parallel)
dist.destroy_process_group()
print(json.dumps(rec))
"""


#: the dry-run children started by ``traced_cell``; ``main`` kills any
#: still running when it ends
_CHILDREN = []


def traced_cell(arch: str, shape, parallel=None, n_layers=None):
    """``launch.dryrun.lower_cell`` of ``arch`` at ``shape`` on a fake
    world of one, a (1, 1) ``("data", "model")`` mesh, on CUDA (fake
    tensors: nothing runs), in a process of its own (a fake world and
    this run's NCCL world cannot both be the default group); under
    ``parallel`` (a ``ParallelismConfig``; the arch's default when None)
    and at ``n_layers`` (full depth when None).  Starts the process and
    returns a function that waits for it and gives its record, so that
    the caller runs the card meanwhile; the function's ``cell`` names
    what it traces, for :func:`dry_check`."""
    from repro_torch.configs import registry
    if n_layers == registry.get(arch).n_layers:
        n_layers = None
    over = {"parallel": parallel and dataclasses.asdict(parallel),
            "n_layers": n_layers}
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRY_CHILD, arch, json.dumps(list(shape)),
         json.dumps(over)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    _CHILDREN.append(proc)

    def record() -> dict:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        check(proc.returncode == 0, f"the trace of {arch} {shape} failed:\n"
              f"{err[-4000:]}")
        return json.loads(out.strip().splitlines()[-1])
    record.proc = proc
    record.cell = (arch, tuple(shape), parallel, n_layers)
    return record


def dry_check(model, shape_fields, mesh, card: str, kernels,
              parallel=None, pending=None) -> dict:
    """One dry-run cell held against the real run: the child traces
    ``model``'s arch at ``shape_fields`` (:func:`traced_cell`) while here
    the same step (``launch.dryrun.cell_step``) runs on ``model`` under the
    same rules on ``mesh`` (the NCCL world of one) inside the same
    ``Trace``.  FLOPs, bytes accessed and the collectives per kind (count,
    wire bytes) must be equal, each of ``kernels``' op calls in the trace
    equal to its wrapper's launches, and the peak within
    ``DRY_PEAK_TOL``, both as the arguments' bytes plus the most the step
    had allocated beyond them at once: on the card
    ``max_memory_allocated()`` after ``reset_peak_memory_stats()`` less
    ``memory_allocated()`` before the step, its arguments made.
    ``parallel`` is the cell's layout (the arch's default when None);
    ``model``'s depth is the trace's.  ``pending`` is the cell's child if
    the caller started it earlier (:func:`traced_cell`, the same
    arguments), so that it traced while the card ran the caller's
    earlier work.  Returns the launches."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  make_rules, use_rules)
    from repro_torch.launch import dryrun
    cfg, dev = model.cfg, model.device
    shape = ShapeConfig(*shape_fields)
    t0 = time.perf_counter()
    # the child traces while the card runs the step below
    if pending is None:
        pending = traced_cell(cfg.name, shape_fields, parallel,
                              cfg.n_layers)
    depth = registry.get(cfg.name).n_layers
    cell = (cfg.name, tuple(shape_fields), parallel,
            None if cfg.n_layers == depth else cfg.n_layers)
    try:
        check(pending.cell == cell, f"dry-run child traces {pending.cell}, "
              f"the run is {cell}")
        parallel = parallel or registry.default_parallelism(cfg, shape)
        rules = make_rules(cfg, shape, parallel, tp_size=1, dp_size=1,
                           mesh=mesh)
        distribute_model(model, rules)
        for _ in range(2):        # a warm-up run, then the one timed bare
            args, run, _ = dryrun.cell_step(model, shape, parallel, rules,
                                            dev)
            with use_rules(rules):
                out, secs = synced_seconds(run)
            del args, run, out
        args, run, note = dryrun.cell_step(model, shape, parallel, rules,
                                           dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with use_rules(rules), dryrun.Trace(args) as tr:
            out = run()
        torch.cuda.synchronize()
        new_peak = torch.cuda.max_memory_allocated() - before
        launches = read_counts()
        real = tr.result(out)
        del args, run, out
    except BaseException:
        pending.proc.kill()
        pending.proc.communicate()
        raise
    rec = pending()
    child_s = time.perf_counter() - t0
    traced = rec["trace"]
    name = (f"{cfg.name} {note} {shape.global_batch} x {shape.seq_len} "
            f"({traced['layout']} layout)")
    check(traced["flops"] == real["flops"], f"{name}: traced FLOPs "
          f"{traced['flops']} against {real['flops']} run")
    check(traced["bytes"] == real["bytes"], f"{name}: traced bytes "
          f"{traced['bytes']} against {real['bytes']} run")
    check(rec["collective_counts"] == real["collective_counts"]
          and rec["collectives"] == real["collectives"],
          f"{name}: traced collectives {rec['collective_counts']} "
          f"{rec['collectives']} against {real['collective_counts']} "
          f"{real['collectives']} run")
    for k in kernels:
        check(traced["kernel_calls"].get(k) == launches[k] > 0,
              f"{name}: {k} op calls in the trace "
              f"{traced['kernel_calls'].get(k)}, launches {launches[k]}")
    mem = rec["memory_analysis"]
    peak = mem["peak_memory_in_bytes"]
    card_peak = real["memory"]["argument_size_in_bytes"] + new_peak
    check(mem["argument_size_in_bytes"] ==
          real["memory"]["argument_size_in_bytes"],
          f"{name}: traced arguments {mem['argument_size_in_bytes']} B "
          f"against {real['memory']['argument_size_in_bytes']} B")
    check(abs(peak - card_peak) <= DRY_PEAK_TOL * card_peak,
          f"{name}: traced peak {peak} B against {card_peak} B on the card")
    args_b = mem["argument_size_in_bytes"]
    print(f"dry-run {name}: traced in {rec['lower_s']:.2f} s (child "
          f"{child_s:.1f} s); FLOPs {real['flops']:.6g}, bytes accessed "
          f"{real['bytes']:.6g}, collectives {real['collective_counts']} "
          f"{real['collectives']} equal to the run's; kernel calls "
          f"{traced['kernel_calls']} equal to the launches; peak traced "
          f"{peak / 1e9:.3f} GB against {card_peak / 1e9:.3f} GB on the "
          f"card (arguments {args_b / 1e9:.3f} GB; beyond them "
          f"{(peak - args_b) / 1e9:.3f} traced, {new_peak / 1e9:.3f} "
          f"allocated); the record's terms on the {H100.name} profile: "
          f"compute {rec['t_compute'] * 1e3:.3f} ms, memory "
          f"{rec['t_memory'] * 1e3:.3f} ms, collective "
          f"{rec['t_collective'] * 1e3:.3f} ms, bottleneck "
          f"{rec['bottleneck']}, beside {secs:.4f} s measured ({card})",
          flush=True)
    return launches


def dry_train_parallel():
    """(b)'s layout: tensor parallelism off, the replicated program
    (``build_dp_train_step``); the cell's default rules place the SSD
    heads and run the layout, which ``ssm_layout_phase`` checks."""
    from repro_torch.configs.base import ParallelismConfig
    return ParallelismConfig(tp=False)


def dryrun_phase(model, mesh, card: str):
    """(a) of the dry-run against the run: qwen3-8b's ``DRY_PREFILL`` on
    ``model`` by :func:`dry_check` (K4 36 times).  Starts (b)'s child
    first, so that both trace at once.  Returns K4's launches and (b)'s
    child."""
    pending = traced_cell("mamba2-1.3b", DRY_TRAIN, dry_train_parallel())
    return dry_check(model, DRY_PREFILL, mesh, card,
                     ("flash_attention",))["flash_attention"], pending


def dryrun_train_phase(dev, mesh, seed: int, card: str, pending):
    """(b) one data-parallel step of mamba2-1.3b at ``DRY_TRAIN`` by
    :func:`dry_check` (K5 and its backward 48 times each) under
    ``dry_train_parallel``, its child ``pending`` started by
    :func:`dryrun_phase`.  Returns K5's and its backward's launches."""
    model = build_model("mamba2-1.3b", dev, seed)
    b = dry_check(model, DRY_TRAIN, mesh, card, ("ssd_scan", "ssd_scan_bwd"),
                  dry_train_parallel(), pending)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return b["ssd_scan"], b["ssd_scan_bwd"]


#: the reference's layout at one NCCL rank: qwen3-8b at its published
#: widths cut to ``LAYOUT_LAYERS`` of its 36 layers (two full models'
#: runs in turn, each with float32 microbatch accumulators, int8 moments
#: and a microbatch's bf16 gradients live at once, ~83 GB at full depth;
#: 8 rather than 24 since the ssm layout phase joined the script, whose
#: whole run at 24 took 1,160 s of its 1,200), under FSDP and TP with 2
#: microbatches and block remat, int8 moments as ``train_phase``'s
LAYOUT_LAYERS = 8
LAYOUT_STEPS = 2
LAYOUT_TRAIN = ("train", TRAIN_S, TRAIN_B, "train")
LAYOUT_PREFILL = ("prefill", ATTN_S, ATTN_B, "prefill")
#: decode steps after each layout run's prefill, and the decode cell (its
#: cache holds the prefill and the decoded tokens)
LAYOUT_DECODE = 8
LAYOUT_DECODE_CELL = ("decode", ATTN_S + LAYOUT_DECODE, ATTN_B, "decode")
#: the decode rules' model axis: the production mesh's 16, whose split of
#: the kv heads decides the cache's layout (qwen3-8b's 8 do not divide
#: it: its sequence goes to ``model``, the flash-decoding combine runs,
#: with one block at one rank)
DECODE_TP = 16
#: the moe layout run: deepseek-moe-16b at ``MOE_TRAIN_LAYERS`` layers,
#: one step, a prefill and this many decode steps
MOE_LAYOUT_DECODE = 4
MOE_DECODE_CELL = ("decode", ATTN_S + MOE_LAYOUT_DECODE, ATTN_B, "decode")
#: parameters kept whole for the comparison (besides every tensor's digest)
LAYOUT_WHOLE = ("blocks.0.attn.wq", "blocks.0.attn.q_norm",
                f"blocks.{LAYOUT_LAYERS - 1}.mlp.wo", "final_norm")


def layout_parallel():
    from repro_torch.configs.base import ParallelismConfig
    return ParallelismConfig(fsdp=True, tp=True, microbatches=2,
                             remat="block", opt_state_dtype="int8")


def digest(t: torch.Tensor) -> int:
    """An exact digest of a tensor: the sum of its elements' bit
    patterns as integers (a DTensor's local block's)."""
    from repro_torch.train.optimizer import local_tensor
    t = local_tensor(t).detach()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return int(t.contiguous().view(ints[t.element_size()]).to(
        torch.int64).sum())


def state_digests(model, state) -> dict:
    """Digests of every parameter and every moment (an int8 moment's
    codes and scales)."""
    out = {n: digest(p) for n, p in model.named_parameters()}
    for part, moments in (("m", state.m), ("v", state.v)):
        for path, st in moments.items():
            for i, t in enumerate(st if isinstance(st, tuple) else (st,)):
                out[f"{part}:{path}:{i}"] = digest(t)
    return out


def layout_run(dev, seed: int, mesh, sharded: bool) -> dict:
    """``LAYOUT_STEPS`` steps of ``build_train_step`` on qwen3-8b at
    ``LAYOUT_LAYERS`` layers, then a prefill of ``LAYOUT_PREFILL``: under
    the cells' rules on ``mesh`` with the model placed by its specs
    (``sharded``), or with no rules.  Returns per step the loss, gradient
    norm, seconds and every tensor's digest, the ``LAYOUT_WHOLE``
    parameters after the steps, the prefill's logits and cache on the
    host, and K4's and its backward's launches in the steps and in the
    prefill."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  make_rules, use_rules)
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.train.optimizer import AdamW, local_tensor
    from repro_torch.train.step import build_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    par = layout_parallel()
    model = build_model("qwen3-8b", dev, seed, LAYOUT_LAYERS)
    cfg = model.cfg
    rules = make_rules(cfg, ShapeConfig(*LAYOUT_TRAIN), par, tp_size=1,
                       dp_size=1, mesh=mesh)
    prules = make_rules(cfg, ShapeConfig(*LAYOUT_PREFILL), par, tp_size=1,
                        dp_size=1, mesh=mesh)
    if sharded:
        distribute_model(model, rules)
    ctx = (lambda r: use_rules(r)) if sharded else \
        (lambda r: contextlib.nullcontext())
    batch = lm_batch_source(model, TRAIN_B, TRAIN_S, seed + 2)()
    opt = AdamW(lr=TRAIN_LR, state_dtype=par.opt_state_dtype)
    state = opt.init(model)
    step = build_train_step(model, par, opt)
    reset_counts()
    steps = []
    for _ in range(LAYOUT_STEPS):
        with ctx(rules):
            (model, state, m), secs = synced_seconds(
                lambda: step(model, state, batch))
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "seconds": secs,
                      "digests": state_digests(model, state)})
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    whole = {n: local_tensor(p).detach().cpu()
             for n, p in model.named_parameters() if n in LAYOUT_WHOLE}
    drules = make_rules(cfg, ShapeConfig(*LAYOUT_DECODE_CELL), par,
                        tp_size=DECODE_TP, dp_size=1, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab_size, (ATTN_B, ATTN_S),
                           generator=gen, device=dev)
    served = prefill_decode(model, prules, drules, mesh, tokens,
                            LAYOUT_DECODE, seed, sharded)
    # one more step, traced: where the step's time goes (nothing is
    # compared after it)
    with ctx(rules):
        device_split(lambda: step(model, state, batch),
                     f"qwen3-8b {'sharded' if sharded else 'unsharded'} "
                     f"step ({LAYOUT_LAYERS} layers)")
    del state, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    out = {"steps": steps, "whole": whole, "peak": peak,
           "train_counts": train_counts, "model": model, **served}
    return out


def prefill_decode(model, prules, drules, mesh, tokens, n_decode: int,
                   seed: int, sharded: bool) -> dict:
    """``Model.prefill`` of ``tokens`` into a cache of ``S + n_decode``
    positions, then ``n_decode`` decode steps of tokens drawn from
    ``seed``: under ``prules``, then ``drules`` with the cache carried
    from the prefill's spec to the decode's by ``sharding.relayout`` (the
    re-lay step, not part of the reference's program), or with no rules.
    Returns the prefill's logits and cache on the host, per decode step
    the logits and every layer's new key and value on the host, the
    final cache's digests, the seconds and the kernel launches of the
    prefill and of the decode steps."""
    from repro_torch.distributed.sharding import relayout, use_rules
    from repro_torch.models.params import partition_specs
    cfg, dev = model.cfg, tokens.device
    B, S = tokens.shape
    ctx = (lambda r: use_rules(r)) if sharded else \
        (lambda r: contextlib.nullcontext())
    cache = model.init_cache(B, S + n_decode)
    reset_counts()
    with ctx(prules):
        (logits, cache), psecs = synced_seconds(
            lambda: model.prefill({"tokens": tokens}, cache))
    # copies: decode then writes into the cache in place
    out = {"logits": logits.to("cpu", copy=True),
           "cache": {k: c.to("cpu", copy=True) for k, c in cache.items()},
           "prefill_s": psecs, "prefill_counts": read_counts()}
    del logits
    if sharded:
        cdefs = model.cache_defs(B, S + n_decode)
        src = partition_specs(cdefs, prules.mapping)
        dst = partition_specs(cdefs, drules.mapping)
        cache = {k: relayout(c, mesh, src[k], dst[k])
                 for k, c in cache.items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    steps, secs = [], []
    reset_counts()
    for i in range(n_decode):
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device=dev)
        with ctx(drules):
            (lg, cache), t = synced_seconds(
                lambda: model.decode_step(cache, tok, S + i))
        steps.append({"logits": lg[:, 0].float().cpu(),
                      "k": cache["k"][:, :, S + i].to("cpu", copy=True),
                      "v": cache["v"][:, :, S + i].to("cpu", copy=True)})
        secs.append(t)
    out.update(decode=steps, decode_s=secs, decode_counts=read_counts(),
               final={k: digest(c) for k, c in cache.items()})
    del cache
    return out


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def compare_decode(got: dict, want: dict, n_layers: int, label: str) -> str:
    """The decode steps of two :func:`prefill_decode` runs: bitwise (every
    step's logits and new keys and values, the final cache's digests), or
    else each step's logits within ``depth_tolerance(n_layers)`` relative
    RMS with every row's argmax agreeing (near ties included,
    ``compare_logits``) and its new keys and values within the same
    relative RMS.  Returns which held, for the phase's line; fails the
    run when neither did."""
    pairs = list(zip(got["decode"], want["decode"], strict=True))
    if all(torch.equal(g[x], w[x]) for g, w in pairs
           for x in ("logits", "k", "v")) and got["final"] == want["final"]:
        return f"**bitwise** ({len(pairs)} steps' logits, new keys and " \
               f"values, the final cache's digests)"
    tol = depth_tolerance(n_layers)
    worst = {"logits": 0.0, "kv": 0.0, "abs": 0.0}
    for i, (g, w) in enumerate(pairs):
        rel, err, agree, exact = compare_logits(g["logits"], w["logits"])
        kv = max(rel_rms(g[x], w[x]) for x in ("k", "v"))
        check(rel <= tol and kv <= tol and agree == 1.0,
              f"{label} decode step {i}: logits relative RMS {rel} "
              f"(tolerance {tol}), argmax agreement {agree}, new keys and "
              f"values relative RMS {kv}")
        worst = {"logits": max(worst["logits"], rel),
                 "kv": max(worst["kv"], kv), "abs": max(worst["abs"], err)}
    return (f"within tolerance, not bitwise: logits relative RMS at most "
            f"{worst['logits']:.3e}, max abs {worst['abs']:.4f}, new keys "
            f"and values {worst['kv']:.3e} (tolerance "
            f"depth_tolerance({n_layers}) = {tol:.4f}), argmax agreement "
            f"1.0 with near ties at every step")


def layout_phase(dev, seed: int, card: str, mesh):
    """The reference's sharded program at one NCCL rank, on ``mesh`` =
    ``make_mesh(1)`` ((1, 1) ``("data", "model")``): qwen3-8b at its
    published widths and ``LAYOUT_LAYERS`` layers under ``make_rules``
    with FSDP, TP, 2 microbatches and block remat, the model placed by
    ``distribute_model`` (every parameter a DTensor of its spec), trained
    ``LAYOUT_STEPS`` steps of 2 x 1024 through ``build_train_step``, then
    a 4 x 1024 prefill; then the same from the same seed with no rules.
    After every step every parameter and moment's digest (the sum of its
    bit patterns), the loss and the gradient norm must be equal, and the
    ``LAYOUT_WHOLE`` parameters bitwise: at one rank the sharded path runs
    the same ops as the local one (the vocab-parallel CE takes
    ``torch.logsumexp``'s steps and autograd's backward of it, AdamW sums
    the squared gradients in the same order).  The prefill's logits and
    cache equal bitwise.  Then ``LAYOUT_DECODE`` decode steps on each
    path: the sharded one under the decode_32k cell's production mapping
    (``DECODE_TP`` = 16: the cache's sequence on ``model``, the kv heads
    replicated, so the flash-decoding combine runs, with one block), the
    prefill's cache carried to its spec by ``sharding.relayout``; every
    step's logits and new keys and values held against the plain
    decode's (``compare_decode``: bitwise, or within
    ``depth_tolerance``, printed).  K4 launches 4 x L times a step (2
    microbatches, remat) and its backward 2 x L, L in the prefill and
    none in decode, on both paths.  Then the train cell's and the decode
    cell's dry-run against the run (``dry_check``, under the same layout
    and depth; their children start first and trace while the card runs
    the steps).  Returns K4's and its backward's launches on the sharded
    path (the steps and the prefill), and the train dry-run check's."""
    children = [traced_cell("qwen3-8b", shape, layout_parallel(),
                            LAYOUT_LAYERS)
                for shape in (LAYOUT_TRAIN, LAYOUT_DECODE_CELL)]
    runs = {}
    for how in ("sharded", "plain"):
        runs[how] = layout_run(dev, seed, mesh, how == "sharded")
        if how == "sharded":
            model = runs[how].pop("model")
            del model
        else:
            model = runs[how].pop("model")
    got, want = runs["sharded"], runs["plain"]
    L = LAYOUT_LAYERS
    expect = {"flash_attention": 4 * L * LAYOUT_STEPS,
              "flash_attention_bwd": 2 * L * LAYOUT_STEPS}
    for run in (got, want):
        for k, n in expect.items():
            check(run["train_counts"][k] == n, f"layout: {k} launched "
                  f"{run['train_counts'][k]} times in {LAYOUT_STEPS} steps, "
                  f"expected {n}")
        check(run["prefill_counts"]["flash_attention"] == L,
              f"layout: K4 launched {run['prefill_counts']['flash_attention']}"
              f" times in the prefill, expected {L}")
        check(run["decode_counts"]["flash_attention"] == 0,
              f"layout: K4 launched {run['decode_counts']['flash_attention']}"
              f" times in decode, expected none")
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        check(np.isfinite(g["loss"]) and g["loss"] == w["loss"]
              and g["grad_norm"] == w["grad_norm"],
              f"layout step {i + 1}: loss {g['loss']} / {w['loss']}, grad "
              f"norm {g['grad_norm']} / {w['grad_norm']} (sharded / plain)")
        differ = [k for k in w["digests"]
                  if g["digests"][k] != w["digests"][k]]
        check(g["digests"].keys() == w["digests"].keys() and not differ,
              f"layout step {i + 1}: {len(differ)} of {len(w['digests'])} "
              f"tensors differ from the plain step's: {differ[:6]}")
    for n, t in want["whole"].items():
        check(torch.equal(got["whole"][n], t), f"layout: {n} after the "
              f"steps differs from the plain run's")
    check(torch.equal(got["logits"], want["logits"])
          and all(torch.equal(got["cache"][k], c)
                  for k, c in want["cache"].items()),
          "layout: the sharded prefill's logits or cache differ from the "
          "plain prefill's")
    decoded = compare_decode(got, want, L, "layout qwen3-8b")
    n_tensors = len(want["steps"][0]["digests"])
    losses = [round(s["loss"], 4) for s in got["steps"]]
    print(f"reference layout, qwen3-8b ({L} of 36 layers, published widths; "
          f"FSDP + TP, 2 microbatches, block remat, int8 moments) at one "
          f"NCCL rank: {LAYOUT_STEPS} steps of {TRAIN_B} x {TRAIN_S} "
          f"through build_train_step, losses {losses}, grad norms "
          f"{[round(s['grad_norm'], 4) for s in got['steps']]}: **bitwise** "
          f"equal to the unsharded steps (all {n_tensors} parameter and "
          f"moment digests after each step, the loss, the gradient norm, "
          f"{len(LAYOUT_WHOLE)} whole parameters; the vocab-parallel CE "
          f"included); step seconds sharded "
          f"{[round(s['seconds'], 3) for s in got['steps']]} against "
          f"{[round(s['seconds'], 3) for s in want['steps']]} unsharded; "
          f"peak {got['peak'] / 1e9:.2f} GB against {want['peak'] / 1e9:.2f}; "
          f"prefill {ATTN_B} x {ATTN_S} logits and cache bitwise, "
          f"{got['prefill_s']:.4f} s against {want['prefill_s']:.4f} s; K4 "
          f"launches {got['train_counts']['flash_attention']} and its "
          f"backward {got['train_counts']['flash_attention_bwd']} "
          f"(expected {expect['flash_attention']} and "
          f"{expect['flash_attention_bwd']}), K4 in the prefill "
          f"{got['prefill_counts']['flash_attention']} (expected {L}) "
          f"({card})", flush=True)
    print(f"reference layout, qwen3-8b decode: {LAYOUT_DECODE} steps after "
          f"the prefill under the decode_32k cell's rules (tp_size "
          f"{DECODE_TP}: kv_seq on model, the combine over one block; the "
          f"cache re-laid from the prefill's spec by sharding.relayout) "
          f"against the plain decode: {decoded}; seconds a step sharded "
          f"{[round(x, 4) for x in got['decode_s']]} against "
          f"{[round(x, 4) for x in want['decode_s']]}; K4 launches "
          f"{got['decode_counts']['flash_attention']} (expected 0) "
          f"({card})", flush=True)
    launches = (got["train_counts"]["flash_attention"]
                + got["prefill_counts"]["flash_attention"],
                got["train_counts"]["flash_attention_bwd"])
    del runs, got, want
    gc.collect()
    torch.cuda.empty_cache()
    dry = dry_check(model, LAYOUT_TRAIN, mesh, card,
                    ("flash_attention", "flash_attention_bwd"),
                    layout_parallel(), children[0])
    dry_check(model, LAYOUT_DECODE_CELL, mesh, card, (), layout_parallel(),
              children[1])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches + (dry["flash_attention"], dry["flash_attention_bwd"])


def moe_layout_parallel():
    from repro_torch.configs.base import ParallelismConfig
    return ParallelismConfig(ep=True, tp=True, remat="block",
                             opt_state_dtype="int8")


def moe_layout_run(dev, seed: int, mesh, sharded: bool) -> dict:
    """deepseek-moe-16b at ``MOE_TRAIN_LAYERS`` layers: one step of
    ``build_train_step`` (expert and tensor parallel, block remat, int8
    moments), then a prefill of ``LAYOUT_PREFILL`` and
    ``MOE_LAYOUT_DECODE`` decode steps (``prefill_decode``): under the
    cells' rules on ``mesh`` with the model placed by its specs
    (``sharded``), or with no rules.  Returns the loss, gradient norm,
    seconds and every tensor's digest after the step, the step's kernel
    launches and peak memory, and ``prefill_decode``'s results."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (distribute_model,
                                                  make_rules, use_rules)
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    par = moe_layout_parallel()
    model = build_model("deepseek-moe-16b", dev, seed, MOE_TRAIN_LAYERS)
    cfg = model.cfg
    rules, prules, drules = (
        make_rules(cfg, ShapeConfig(*shape), par, tp_size=tp, dp_size=1,
                   mesh=mesh)
        for shape, tp in ((LAYOUT_TRAIN, 1), (LAYOUT_PREFILL, 1),
                          (MOE_DECODE_CELL, DECODE_TP)))
    if sharded:
        distribute_model(model, rules)
    ctx = use_rules(rules) if sharded else contextlib.nullcontext()
    batch = lm_batch_source(model, TRAIN_B, TRAIN_S, seed + 2)()
    opt = AdamW(lr=TRAIN_LR, state_dtype=par.opt_state_dtype)
    state = opt.init(model)
    step = build_train_step(model, par, opt)
    reset_counts()
    with ctx:
        (model, state, m), secs = synced_seconds(
            lambda: step(model, state, batch))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "seconds": secs, "digests": state_digests(model, state),
           "train_counts": read_counts(),
           "peak": torch.cuda.max_memory_allocated()}
    del state, opt, step, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab_size, (ATTN_B, ATTN_S),
                           generator=gen, device=dev)
    out.update(prefill_decode(model, prules, drules, mesh, tokens,
                              MOE_LAYOUT_DECODE, seed, sharded))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_layout_phase(dev, seed: int, card: str, mesh):
    """The moe family under the reference's layout at one NCCL rank:
    deepseek-moe-16b at ``MOE_TRAIN_LAYERS`` layers placed by
    ``distribute_model`` under ``make_rules`` with expert and tensor
    parallelism (the attention, the shared experts and the vocab over
    ``model`` beside the experts; the router read whole), one step of 2 x
    1024 through ``build_train_step`` (block remat, int8 moments; the
    dispatch's backward adds without atomics, ``moe._GatherRows``, so
    the step is repeatable with no global switch), a 4 x 1024 prefill and ``MOE_LAYOUT_DECODE`` decode steps under the
    decode_32k cell's mapping (its 16 kv heads divide the production
    axis: the heads split, no combine); then the same from the same seed
    with no rules (two copies with moments do not fit at once).  Every
    parameter's and moment's digest, the loss and the gradient norm
    after the step, the prefill's logits and cache must be equal, the
    decode steps bitwise or within tolerance (``compare_decode``,
    printed); K4 2 x L and its backward L times in the step, L in the
    prefill, none in decode, on both paths.  Returns K4's launches on
    the sharded path (the step and the prefill) and its backward's."""
    got = moe_layout_run(dev, seed, mesh, True)
    want = moe_layout_run(dev, seed, mesh, False)
    L = MOE_TRAIN_LAYERS
    expect = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    for run in (got, want):
        for k, n in expect.items():
            check(run["train_counts"][k] == n, f"moe layout: {k} launched "
                  f"{run['train_counts'][k]} times in the step, expected {n}")
        check(run["prefill_counts"]["flash_attention"] == L
              and run["decode_counts"]["flash_attention"] == 0,
              f"moe layout: K4 launched "
              f"{run['prefill_counts']['flash_attention']} times in the "
              f"prefill (expected {L}) and "
              f"{run['decode_counts']['flash_attention']} in decode "
              f"(expected 0)")
    check(np.isfinite(got["loss"]) and got["loss"] == want["loss"]
          and got["grad_norm"] == want["grad_norm"],
          f"moe layout step: loss {got['loss']} / {want['loss']}, grad norm "
          f"{got['grad_norm']} / {want['grad_norm']} (sharded / plain)")
    differ = [k for k in want["digests"]
              if got["digests"].get(k) != want["digests"][k]]
    check(got["digests"].keys() == want["digests"].keys() and not differ,
          f"moe layout step: {len(differ)} of {len(want['digests'])} "
          f"tensors differ from the plain step's: {differ[:6]}")
    check(torch.equal(got["logits"], want["logits"])
          and all(torch.equal(got["cache"][k], c)
                  for k, c in want["cache"].items()),
          "moe layout: the sharded prefill's logits or cache differ from "
          "the plain prefill's")
    decoded = compare_decode(got, want, L, "moe layout deepseek-moe-16b")
    print(f"reference layout, deepseek-moe-16b ({L} of 28 layers, published "
          f"widths; EP and TP on model, router read whole, block remat, "
          f"int8 moments) at one NCCL rank: 1 step of {TRAIN_B} x {TRAIN_S} "
          f"through build_train_step, loss {got['loss']:.4f}, grad norm "
          f"{got['grad_norm']:.4f}: **bitwise** equal to the unsharded step "
          f"(all {len(want['digests'])} parameter and moment digests, the "
          f"loss, the gradient norm); step {got['seconds']:.3f} s against "
          f"{want['seconds']:.3f} s (first steps), peak "
          f"{got['peak'] / 1e9:.2f} GB against {want['peak'] / 1e9:.2f}; "
          f"prefill {ATTN_B} x {ATTN_S} logits and cache bitwise, "
          f"{got['prefill_s']:.4f} s against {want['prefill_s']:.4f} s; "
          f"{MOE_LAYOUT_DECODE} decode steps under the decode_32k rules "
          f"(tp_size {DECODE_TP}: kv heads on model, no combine): "
          f"{decoded}, seconds a step {[round(x, 4) for x in got['decode_s']]}"
          f" against {[round(x, 4) for x in want['decode_s']]}; K4 launches "
          f"{got['train_counts']['flash_attention']} in the step (expected "
          f"{2 * L}), its backward {got['train_counts']['flash_attention_bwd']}"
          f" (expected {L}), K4 {got['prefill_counts']['flash_attention']} in "
          f"the prefill (expected {L}), "
          f"{got['decode_counts']['flash_attention']} in decode (expected 0) "
          f"({card})", flush=True)
    return (got["train_counts"]["flash_attention"]
            + got["prefill_counts"]["flash_attention"],
            got["train_counts"]["flash_attention_bwd"])


#: the ssm and hybrid families on the reference's layout at one NCCL rank,
#: under the production cells' mappings: train multi (2 pods x 16 data x
#: 16 model: the 256-sequence batch does not divide 512 ranks, so tensor
#: parallelism), prefill_32k, decode_32k and long_500k (16 x 16).  The
#: SSD heads (64 in both archs) and zamba2's attention heads and kv heads
#: (32 each) split over ``model``; long_500k puts zamba2's ring slots on
#: ``data`` (batch 1), so the combine runs over one block
SSM_LAYOUT_STEPS = 2
SSM_LAYOUT_DECODE = 8
#: zamba2-1.2b's decode after its prefill: a cache of HYB_RING positions
#: (the ring's W = min(s_max, 4096) slots), HYB_RING_DECODE steps from
#: position 0, past W so that the ring wraps; its prefill of one row of
#: HYB_LAYOUT_PREFILL tokens (past the 4,096-token window)
HYB_RING, HYB_RING_DECODE = 8, 12
HYB_LAYOUT_PREFILL = 8_192
#: the dry-run cells held against the run on the layout, one a family:
#: mamba2-1.3b's decode step and zamba2-1.2b's prefill of one row (their
#: default rules at one rank place the SSD heads on ``model``)
SSM_DRY_CELLS = {"mamba2-1.3b": (("decode", SSM_LAYOUT_DECODE, SSM_B,
                                  "decode"), ()),
                 "zamba2-1.2b": (("prefill", HYB_LAYOUT_PREFILL, 1,
                                  "prefill"), ("ssd_scan",
                                               "flash_attention"))}


def pod_mesh():
    """A (1, 1, 1) ``("pod", "data", "model")`` mesh on the NCCL world
    of one: the multi-pod cells' rules name the ``pod`` axis.  One
    all-reduce on each axis's group and on the batch axes' flattened one
    sets their communicators up outside the timed steps."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import group_of
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    one = torch.ones(1, device="cuda")
    for group in [mesh.get_group(a) for a in mesh.mesh_dim_names] + [
            group_of(mesh, ("pod", "data"))]:
        dist.all_reduce(one, group=group)
    return mesh


def production_rules(cfg, mesh) -> dict:
    """The production cells' rules by shape name, each under its default
    layout: train_4k on the multi-pod mesh, the others on one pod."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.distributed.sharding import make_rules
    out = {}
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape = SHAPES_BY_NAME[name]
        out[name] = make_rules(cfg, shape, registry.default_parallelism(
            cfg, shape), multi_pod=name == "train_4k", tp_size=DECODE_TP,
            dp_size=16, mesh=mesh)
    return out


def ssm_layout_parallel(cfg):
    """The train multi cell's layout (its default, which ``make_rules``
    turns into tensor parallelism on 512 ranks), with block remat for
    zamba2-1.2b: its 2 x 4096 tokens at 38 layers without remat ran out
    of the card's 80 GB (mamba2-1.3b's 4 x 1024 peak at 57 GB)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES_BY_NAME
    par = registry.default_parallelism(cfg, SHAPES_BY_NAME["train_4k"])
    return par.replace(remat="block") if cfg.family == "hybrid" else par


def ssm_decode_run(model, ctx, B: int, s_max: int, n: int, seed: int):
    """``n`` decode steps of ``B`` rows from a zero cache of ``s_max``
    positions, each under ``ctx()``: per step the logits on the host and
    the seconds, the final cache on the host, and the launches."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    cache = model.init_cache(B, s_max)
    logits, secs = [], []
    reset_counts()
    for i in range(n):
        tok = torch.randint(0, model.cfg.vocab_size, (B, 1), generator=gen,
                            device=model.device)
        with ctx():
            (lg, cache), t = synced_seconds(
                lambda: model.decode_step(cache, tok, i))
        logits.append(lg[:, 0].float().cpu())
        secs.append(t)
    return {"logits": logits, "seconds": secs, "counts": read_counts(),
            "cache": {k: c.to("cpu", copy=True) for k, c in cache.items()}}


def ssm_layout_run(dev, seed: int, mesh, arch: str, sharded: bool) -> dict:
    """``arch`` at its published widths and full depth:
    ``SSM_LAYOUT_STEPS`` steps of ``build_train_step`` under the train
    multi cell's rules and layout (mamba2-1.3b ``SSM_TRAIN_B`` x
    ``TRAIN_S``, zamba2-1.2b ``HYB_TRAIN_B`` x ``HYB_TRAIN_S``), then
    zamba2's prefill of ``HYB_LAYOUT_PREFILL`` tokens under the
    prefill_32k rules, then decode from a zero cache under the
    decode_32k rules (mamba2 ``SSM_LAYOUT_DECODE`` steps of ``SSM_B``
    rows; zamba2 ``HYB_RING_DECODE`` steps of ``HYB_B`` rows on a ring
    of ``HYB_RING``) and, for zamba2, under the long_500k rules (one
    row): with the model placed by the train rules (``sharded``), or
    with no rules.  Returns per step the loss, gradient norm, seconds
    and every tensor's digest, the steps' launches and peak memory, the
    prefill's logits' digest, seconds and launches, and each decode
    run's results (:func:`ssm_decode_run`)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.distributed.sharding import distribute_model, use_rules
    from repro_torch.launch.train import lm_batch_source
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.step import build_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(arch, dev, seed)
    cfg = model.cfg
    rules = production_rules(cfg, mesh)
    moved = [n for n, r in rules.items() if r.mapping["ssm_inner"]]
    check(moved == (["train_4k", "decode_32k", "long_500k"]
                    if cfg.family == "ssm" else list(rules)),
          f"{arch}: the rules place the SSD heads in {moved}")
    if sharded:
        distribute_model(model, rules["train_4k"])

    def ctx(name):
        return use_rules(rules[name]) if sharded else \
            contextlib.nullcontext()

    par = ssm_layout_parallel(cfg)
    B, S = (SSM_TRAIN_B, TRAIN_S) if cfg.family == "ssm" else \
        (HYB_TRAIN_B, HYB_TRAIN_S)
    batch = lm_batch_source(model, B, S, seed + 2)()
    opt = AdamW(lr=TRAIN_LR, state_dtype=par.opt_state_dtype)
    state = opt.init(model)
    step = build_train_step(model, par, opt)
    reset_counts()
    steps = []
    for _ in range(SSM_LAYOUT_STEPS):
        with ctx("train_4k"):
            (model, state, m), secs = synced_seconds(
                lambda: step(model, state, batch))
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "seconds": secs,
                      "digests": state_digests(model, state)})
    out = {"steps": steps, "train_counts": read_counts(),
           "peak": torch.cuda.max_memory_allocated(), "model": model}
    del state, opt, step, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family == "hybrid":
        gen = torch.Generator(device=dev).manual_seed(seed + 3)
        tokens = torch.randint(0, cfg.vocab_size, (1, HYB_LAYOUT_PREFILL),
                               generator=gen, device=dev)
        cache = model.init_cache(1, HYB_LAYOUT_PREFILL)
        reset_counts()
        with ctx("prefill_32k"):
            (logits, _), psecs = synced_seconds(
                lambda: model.prefill({"tokens": tokens}, cache))
        out.update(prefill=logits.to("cpu", copy=True), prefill_s=psecs,
                   prefill_counts=read_counts())
        del logits, cache, tokens
        out["decode"] = ssm_decode_run(
            model, lambda: ctx("decode_32k"), HYB_B, HYB_RING,
            HYB_RING_DECODE, seed + 4)
        out["long"] = ssm_decode_run(model, lambda: ctx("long_500k"), 1,
                                     HYB_RING, HYB_RING_DECODE, seed + 5)
    else:
        out["decode"] = ssm_decode_run(
            model, lambda: ctx("decode_32k"), SSM_B, SSM_LAYOUT_DECODE,
            SSM_LAYOUT_DECODE, seed + 4)
    return out


def decode_held(got: dict, want: dict, n_layers: int, label: str,
                bitwise: bool) -> str:
    """Two :func:`ssm_decode_run` results: every step's logits and the
    final cache bitwise, or (``bitwise`` false) each step's logits within
    ``depth_tolerance(n_layers)`` relative RMS with every row's argmax
    agreeing (near ties included) and each final cache tensor within
    the same relative RMS.  Returns the phase line's words."""
    same = all(torch.equal(g, w) for g, w in zip(got["logits"],
                                                  want["logits"],
                                                  strict=True)) and all(
        torch.equal(got["cache"][k], c) for k, c in want["cache"].items())
    if same:
        return f"**bitwise** ({len(want['logits'])} steps' logits, the " \
               f"final {', '.join(want['cache'])})"
    check(not bitwise, f"{label}: the sharded decode differs from the "
          f"plain decode")
    tol = depth_tolerance(n_layers)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        rel, err, agree, exact = compare_logits(g, w)
        check(rel <= tol and agree == 1.0, f"{label} decode step {i}: "
              f"logits relative RMS {rel} (tolerance {tol}), argmax "
              f"agreement {agree}")
        worst = max(worst, rel)
    cache = {k: rel_rms(got["cache"][k], c) for k, c in want["cache"].items()}
    check(all(r <= tol for r in cache.values()),
          f"{label}: the final cache's relative RMS {cache} (tolerance {tol})")
    return (f"within tolerance, not bitwise: logits relative RMS at most "
            f"{worst:.3e}, final cache " + ", ".join(
                f"{k} {r:.3e}" for k, r in cache.items())
            + f" (tolerance depth_tolerance({n_layers}) = {tol:.4f}), "
            f"argmax agreement 1.0")


def ssm_layout_phase(dev, seed: int, card: str, mesh):
    """The ssm and hybrid families under the reference's layout at one
    NCCL rank: mamba2-1.3b and zamba2-1.2b at their published widths and
    full depth, each placed by ``distribute_model`` under the train
    multi cell's production rules (``production_rules``: the SSD heads,
    zamba2's shared attention and MLP and the vocab over ``model``;
    ``make_rules(..., multi_pod=True, tp_size=16, dp_size=16)`` on a
    ``pod_mesh``) and run by ``ssm_layout_run``, then the same from the
    same seed with no rules (two copies with moments do not fit at
    once).  Every parameter's and moment's digest, the loss and the
    gradient norm after each step, zamba2's prefill logits, and the
    decode_32k decode's logits and final state (``h``, ``conv``, the
    ring's ``ak``/``av``) must be bitwise; zamba2's long_500k decode
    (its ring's slots on ``data``: the flash-decoding combine over one
    block) within ``depth_tolerance``.  K5, its backward and K4 launch
    as often on both paths (K5 and its backward once per layer a step,
    K5 twice under zamba2's remat, ``ssm_layout_parallel``; zamba2's
    shared block K4 and its backward once per site;
    the prefill K5 once per layer and K4 once per site; none in decode).
    Then ``SSM_DRY_CELLS``' dry-run against the run (``dry_check``, on a
    fresh model of each arch; their children start first and trace while
    the card runs the layouts).  Returns the sharded path's launches by
    name: each arch's steps, zamba2's prefill and the dry checks'."""
    children = {arch: traced_cell(arch, shape)
                for arch, (shape, _) in SSM_DRY_CELLS.items()}
    pmesh = pod_mesh()
    launches = {}
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        got = ssm_layout_run(dev, seed, pmesh, arch, True)
        cfg = got.pop("model").cfg
        gc.collect()
        torch.cuda.empty_cache()
        want = ssm_layout_run(dev, seed, pmesh, arch, False)
        want.pop("model")
        L = cfg.n_layers
        sites = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        # remat runs each ssm layer's forward again; the shared block,
        # outside the checkpoint, once
        fwd = 2 if ssm_layout_parallel(cfg).remat != "none" else 1
        expect = {"ssd_scan": fwd * L * SSM_LAYOUT_STEPS,
                  "ssd_scan_bwd": L * SSM_LAYOUT_STEPS,
                  "flash_attention": sites * SSM_LAYOUT_STEPS,
                  "flash_attention_bwd": sites * SSM_LAYOUT_STEPS}
        for run in (got, want):
            for k, n in expect.items():
                check(run["train_counts"][k] == n, f"{arch} layout: {k} "
                      f"launched {run['train_counts'][k]} times in "
                      f"{SSM_LAYOUT_STEPS} steps, expected {n}")
            for dec in ("decode", "long"):
                if dec in run:
                    check(not any(run[dec]["counts"].values()),
                          f"{arch} layout: kernels launched in decode: "
                          f"{run[dec]['counts']}")
        for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            check(np.isfinite(g["loss"]) and g["loss"] == w["loss"]
                  and g["grad_norm"] == w["grad_norm"],
                  f"{arch} layout step {i + 1}: loss {g['loss']} / "
                  f"{w['loss']}, grad norm {g['grad_norm']} / "
                  f"{w['grad_norm']} (sharded / plain)")
            differ = [k for k in w["digests"]
                      if g["digests"].get(k) != w["digests"][k]]
            check(g["digests"].keys() == w["digests"].keys() and not differ,
                  f"{arch} layout step {i + 1}: {len(differ)} of "
                  f"{len(w['digests'])} tensors differ from the plain "
                  f"step's: {differ[:6]}")
        decoded = decode_held(got["decode"], want["decode"], L,
                              f"{arch} layout decode_32k", True)
        n_tensors = len(want["steps"][0]["digests"])
        words = (f"reference layout, {arch} ({L} layers, published widths; "
                 f"the train multi cell's rules: SSD heads"
                 f"{', shared attention and MLP' if sites else ''} and vocab "
                 f"over model) at one NCCL rank: {SSM_LAYOUT_STEPS} steps "
                 f"through build_train_step, losses "
                 f"{[round(x['loss'], 4) for x in got['steps']]}, grad "
                 f"norms {[round(x['grad_norm'], 4) for x in got['steps']]}: "
                 f"**bitwise** equal to the unsharded steps (all {n_tensors} "
                 f"parameter and moment digests, the loss, the gradient "
                 f"norm); step seconds sharded "
                 f"{[round(x['seconds'], 3) for x in got['steps']]} against "
                 f"{[round(x['seconds'], 3) for x in want['steps']]}; peak "
                 f"{got['peak'] / 1e9:.2f} GB against "
                 f"{want['peak'] / 1e9:.2f}; launches K5 "
                 f"{got['train_counts']['ssd_scan']}, its backward "
                 f"{got['train_counts']['ssd_scan_bwd']}, K4 "
                 f"{got['train_counts']['flash_attention']}, its backward "
                 f"{got['train_counts']['flash_attention_bwd']} on both "
                 f"paths (expected {expect}); decode_32k "
                 f"{len(want['decode']['logits'])} steps: {decoded}, seconds "
                 f"a step {[round(x, 4) for x in got['decode']['seconds']]} "
                 f"against {[round(x, 4) for x in want['decode']['seconds']]}")
        launches[arch] = got["train_counts"]
        if sites:
            pre = {"ssd_scan": L, "flash_attention": sites}
            for run in (got, want):
                for k, n in pre.items():
                    check(run["prefill_counts"][k] == n, f"{arch} layout: "
                          f"{k} launched {run['prefill_counts'][k]} times "
                          f"in the prefill, expected {n}")
            check(bool(torch.isfinite(want["prefill"].float()).all())
                  and torch.equal(got["prefill"], want["prefill"]),
                  f"{arch} layout: the sharded prefill's logits differ from "
                  f"the plain prefill's, or are not finite")
            long = decode_held(got["long"], want["long"], L,
                               f"{arch} layout long_500k", False)
            words += (f"; prefill 1 x {HYB_LAYOUT_PREFILL} under the "
                      f"prefill_32k rules, logits **bitwise**, "
                      f"{got['prefill_s']:.4f} s against "
                      f"{want['prefill_s']:.4f} s, K5 "
                      f"{got['prefill_counts']['ssd_scan']} and K4 "
                      f"{got['prefill_counts']['flash_attention']} on both; "
                      f"the ring of {HYB_RING} slots wraps at step "
                      f"{HYB_RING + 1} of {HYB_RING_DECODE}; long_500k "
                      f"(ring slots on data, the combine over one block) 1 "
                      f"row: {long}, seconds a step "
                      f"{[round(x, 4) for x in got['long']['seconds']]} "
                      f"against {[round(x, 4) for x in want['long']['seconds']]}")
            launches["prefill"] = got["prefill_counts"]
        print(words + f" ({card})", flush=True)
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(arch, dev, seed)
        dry_shape, kernels = SSM_DRY_CELLS[arch]
        launches[f"dry {arch}"] = dry_check(model, dry_shape, mesh, card,
                                            kernels, pending=children[arch])
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def sweep_phase(card: str) -> None:
    """(c) the production sweep, after the last timed phase (it needs no
    card, and beside a timed phase it would load the host):
    ``launch.dryrun`` over every assigned arch x shape on the
    ``SWEEP_MESHES``, one process per arch, ``SWEEP_PROCS`` at a time, the
    largest models (the slowest traces) first, each writing its records
    under ``build/dryrun/``.  Prints each cell's bottleneck and trace
    seconds and the ok, failed and skipped counts; a failed cell, or an
    applicable cell without a record, fails the run."""
    import collections
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import registry
    from repro_torch.configs.base import ALL_SHAPES, shape_applicable
    from repro_torch.models.model import build
    from repro_torch.models.params import param_count
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    archs = sorted(registry.ASSIGNED_ARCHS,
                   key=lambda a: -param_count(build(registry.get(a)).defs))

    def sweep(arch: str) -> dict:
        path = out / f"{arch}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "all", "--mesh", ",".join(SWEEP_MESHES),
             "--out", str(path), "--force"], cwd=str(ROOT),
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     OMP_NUM_THREADS="1"))
        check(proc.returncode == 0, f"the sweep of {arch} exited "
              f"{proc.returncode}:\n{proc.stdout[-2000:]}"
              f"{proc.stderr[-2000:]}")
        return json.loads(path.read_text())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SWEEP_PROCS) as pool:
        records = {k: r for part in pool.map(sweep, archs)
                   for k, r in part.items()}
    secs = time.perf_counter() - t0
    cells = [(a, s, m) for a in registry.ASSIGNED_ARCHS for s in ALL_SHAPES
             for m in SWEEP_MESHES]
    applicable = [f"{a}|{s.name}|{m}" for a, s, m in cells
                  if shape_applicable(registry.get(a), s)[0]]
    errors = {k: r["error"] for k, r in records.items() if "error" in r}
    ok = [k for k in applicable if k in records and "error" not in
          records[k] and "skipped" not in records[k]]
    for key in sorted(ok):
        r = records[key]
        peak = r["memory_analysis"]["peak_memory_in_bytes"]
        analytic = r["analytic_bytes_per_device"]["total"]
        print(f"dry-run cell {key}: bottleneck {r['bottleneck']}, traced in "
              f"{r['lower_s']:.1f} s, peak {peak / 1e9:.1f} GB (analytic "
              f"{analytic / 1e9:.1f} GB)", flush=True)
    print(f"dry-run sweep, {' and '.join(SWEEP_MESHES)} mesh: {len(ok)} ok, "
          f"{len(errors)} failed, {len(cells) - len(applicable)} skipped, "
          f"{secs:.1f} s in {SWEEP_PROCS} processes ({card})", flush=True)
    check(not errors, f"dry-run cells failed: {errors}")
    check(len(ok) == len(applicable), f"dry-run cells without a record: "
          f"{sorted(set(applicable) - set(ok))}")
    # every cell's peak against 80 GB; the dense and moe families' cells
    # run the reference's sharded layout, whose held bytes must be the
    # analytic ones
    fit = sum(records[k]["memory_analysis"]["peak_memory_in_bytes"] <= 80e9
              for k in ok)
    moved = [k for k in sorted(ok) if sweep_sharded(k)]
    for key in sorted(ok):
        if key not in moved:
            check(records[key]["trace"]["layout"] == "replicated",
                  f"dry-run {key}: layout {records[key]['trace']['layout']}")
    for key in moved:
        r = records[key]
        peak = r["memory_analysis"]["peak_memory_in_bytes"]
        check(r["trace"]["layout"] == "sharded",
              f"dry-run {key}: layout {r['trace']['layout']}")
        check(r["trace"]["held_bytes"] == r["analytic_bytes_per_device"],
              f"dry-run {key}: held bytes {r['trace']['held_bytes']} "
              f"against analytic {r['analytic_bytes_per_device']}")
        print(f"dry-run sharded cell {key} (microbatches "
              f"{r['parallelism']['microbatches']}, remat "
              f"{r['parallelism']['remat']}, moments "
              f"{r['parallelism']['opt_state_dtype']}): peak per rank "
              f"{peak / 1e9:.1f} GB, held "
              f"{r['trace']['held_bytes']['total'] / 1e9:.2f} GB", flush=True)
    families = collections.Counter(registry.get(k.split("|")[0]).family
                                   for k in moved)
    print(f"dry-run: {fit} of {len(ok)} cells fit 80 GB a rank; {len(moved)} "
          f"cells run the sharded layout ({dict(families)} by family), each "
          f"holding its analytic bytes ({card})", flush=True)


def sweep_sharded(key: str) -> bool:
    """Whether the sweep's cell ``arch|shape|mesh`` runs the reference's
    layout under its production rules (``launch.dryrun.sharded_cell``):
    every dense and moe cell, the ssm and hybrid cells whose rules place
    the SSD heads."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.dryrun import sharded_cell
    arch, name, mesh = key.split("|")
    cfg, shape = registry.get(arch), SHAPES_BY_NAME[name]
    rules = make_rules(cfg, shape, registry.default_parallelism(cfg, shape),
                       multi_pod=mesh == "multi")
    return sharded_cell(cfg, rules)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree if isinstance(tree, list) else tree.values()
    return [t for v in items for t in _leaves(v)]


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
    try:
        return smoke(args.seed)
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def smoke(seed: int) -> int:
    """Every phase in turn, then the kernel line, the card and the
    contract's last line."""
    from repro_torch.kernels.device import build_all, resolve_device
    dev = resolve_device(None)
    torch.manual_seed(seed)

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
    rows = phase("loader kernels", kernel_phase, dev, seed)
    counts, unsharded = phase("loader main path, augmented",
                              main_path_augmented, dev, N_AUGMENTED,
                              seed, card)
    rows["decode_augment"]["launches"] = counts["decode_augment"]
    counts = phase("loader main path, decoded hits", main_path_decoded, dev,
                   N_DECODED, seed, card)
    rows["decode"]["launches"] = counts["decode"]
    rows["augment"]["launches"] = counts["augment"]
    phase("ods step, ImageNet-1k scale", ods_phase, dev, seed, card)
    phase("multi-job workload, shared cache", workload_phase, dev,
          seed, card)
    counts = phase("sharded data plane", sharded_phase, dev, seed,
                   card, unsharded)
    rows["decode_augment"]["launches"] += counts["decode_augment"]
    rows["augment"]["launches"] += counts["augment"]
    rows.update(phase("model kernels", model_kernel_phase, dev, seed))
    rows["flash_attention"]["launches"], model, tokens, logits = phase(
        "serving, qwen3-8b", dense_phase, dev, seed, card)
    mesh, store = phase("mesh: an NCCL world of one", mesh_world, card)
    rows["flash_attention"]["launches_pp"] = phase(
        "pipeline, qwen3-8b", pp_phase, model, seed, card)
    phase("elastic resharding, qwen3-8b", elastic_phase, model, tokens,
          logits, card)
    rows["flash_attention"]["launches_dry"], dry_train = phase(
        "dry-run against the run, qwen3-8b prefill", dryrun_phase, model,
        mesh, card)
    del model, tokens, logits
    gc.collect()
    torch.cuda.empty_cache()
    rows["ssd_scan"]["launches_dry"], rows["ssd_scan_bwd"]["launches_dry"] \
        = phase("dry-run against the run, mamba2-1.3b step",
                dryrun_train_phase, dev, mesh, seed, card, dry_train)
    (rows["flash_attention"]["launches_layout"],
     rows["flash_attention_bwd"]["launches_layout"],
     rows["flash_attention"]["launches_dry_layout"],
     rows["flash_attention_bwd"]["launches_dry_layout"]) = phase(
        "reference layout (FSDP + TP), qwen3-8b", layout_phase, dev,
        seed, card, mesh)
    rows["ssd_scan"]["launches"], sp_launches = phase(
        "serving, mamba2-1.3b", ssm_phase, dev, seed, card, mesh)
    rows["ssd_scan"]["launches_sp"] = sp_launches
    rows["flash_attention_bwd"]["launches"] = phase(
        "training, qwen3-8b", train_phase, dev, seed,
        card)["flash_attention_bwd"]
    train = phase("training, mamba2-1.3b", train_phase, dev, seed,
                  card, "mamba2-1.3b")
    rows["ssd_scan_bwd"]["launches"] = train["ssd_scan_bwd"]
    fwd, bwd = phase("data-parallel training, mamba2-1.3b", dp_phase, dev,
                     seed, card, mesh, train["losses"])
    rows["ssd_scan"]["launches_dp"] = fwd
    rows["ssd_scan_bwd"]["launches_dp"] = bwd
    counts = phase("training, vit-huge", vit_phase, dev, seed, card)
    rows["flash_attention_vit"]["launches"] = counts["flash_attention"]
    rows["flash_attention_bwd_vit"]["launches"] = \
        counts["flash_attention_bwd"]
    rows["decode_augment"]["launches"] += counts["decode_augment"]
    rows["flash_attention_moe"]["launches"], ep_launches, \
        rows["flash_attention_bwd_moe"]["launches"] = phase(
            "serving and training, deepseek-moe-16b", moe_phase, dev,
            seed, card, mesh)
    rows["flash_attention_moe"]["launches_ep"] = ep_launches
    (rows["flash_attention_moe"]["launches_layout"],
     rows["flash_attention_bwd_moe"]["launches_layout"]) = phase(
        "reference layout (EP + TP), deepseek-moe-16b", moe_layout_phase,
        dev, seed, card, mesh)
    lay = phase("reference layout (TP of the SSD heads), mamba2-1.3b and "
                "zamba2-1.2b", ssm_layout_phase, dev, seed, card, mesh)
    for kernel in ("ssd_scan", "ssd_scan_bwd"):
        rows[kernel]["launches_layout"] = lay["mamba2-1.3b"][kernel]
        # the train multi rank's shape: at one rank the path's K5 runs
        # every head, the row times a rank's 4
        rows[f"{kernel}_tp"]["launches"] = lay["mamba2-1.3b"][kernel]
    for kernel in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                   "ssd_scan_bwd"):
        rows[f"{kernel}_zamba2_train"]["launches_layout"] = \
            lay["zamba2-1.2b"][kernel]
    for kernel in ("flash_attention", "ssd_scan"):
        rows[f"{kernel}_zamba2"]["launches_layout"] = lay["prefill"][kernel]
        rows[f"{kernel}_zamba2"]["launches_dry_layout"] = \
            lay["dry zamba2-1.2b"][kernel]
    counts, train = phase("serving and training, zamba2-1.2b", hybrid_phase,
                          dev, seed, card)
    rows["flash_attention_zamba2"]["launches"] = counts["flash_attention"]
    rows["ssd_scan_zamba2"]["launches"] = counts["ssd_scan"]
    for kernel in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                   "ssd_scan_bwd"):
        rows[f"{kernel}_zamba2_train"]["launches"] = train[kernel]
    for arch in ("internvl2-2b", "seamless-m4t-large-v2"):
        for suffix, (fwd, bwd) in phase(
                f"serving and training, {arch}", vlm_encdec_phase, dev,
                seed, card, arch).items():
            rows["flash_attention" + suffix]["launches"] = fwd
            rows["flash_attention_bwd" + suffix]["launches"] = bwd

    phase(f"dry-run sweep, {' and '.join(SWEEP_MESHES)} mesh", sweep_phase,
          card)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name in ("decode_augment_bf16", "augment_bf16"):
        r = rows.pop(name)
        print(f"variant {name} (not on the main path): {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
              flush=True)
    # launches on the mesh layer's paths (sequence-, data-, expert-
    # parallel, pipeline, the reference's FSDP + TP and EP + TP layouts)
    # and in the dry-run's real runs, beside the row's own main-path count
    keys += ("launches_sp", "launches_dp", "launches_ep", "launches_pp",
             "launches_dry", "launches_layout", "launches_dry_layout")
    kernels = [{k: rows[name][k] for k in keys if k in rows[name]}
               for name in ("decode_augment", "augment", "decode",
                            "flash_attention", "flash_attention_bwd",
                            "ssd_scan", "ssd_scan_bwd", "ssd_scan_tp",
                            "ssd_scan_bwd_tp", "flash_attention_vit",
                            "flash_attention_bwd_vit", "flash_attention_moe",
                            "flash_attention_bwd_moe", "flash_attention_zamba2",
                            "flash_attention_zamba2_train",
                            "flash_attention_bwd_zamba2_train",
                            "ssd_scan_zamba2", "ssd_scan_zamba2_train",
                            "ssd_scan_bwd_zamba2_train",
                            "flash_attention_internvl2",
                            "flash_attention_bwd_internvl2",
                            "flash_attention_seamless_enc",
                            "flash_attention_bwd_seamless_enc",
                            "flash_attention_seamless_self",
                            "flash_attention_bwd_seamless_self",
                            "flash_attention_seamless_cross",
                            "flash_attention_bwd_seamless_cross")]
    import torch.distributed as dist
    dist.destroy_process_group()
    store.unlink(missing_ok=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
