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
   followed by K2, and timed with CUDA events beside its bound;
3. main path, augmented: ``SenecaServer.for_dataset(imagenet_like(n))``
   at n = ``N_AUGMENTED`` with an HBM tier sized for every augmented
   sample, the device executor at batch 256 for two epochs: every id
   once per epoch, rows equal to a CPU recomputation, zero h2d bytes in
   the all-HBM epoch, K1 launched;
4. main path, decoded hits: at n = ``N_DECODED`` every decoded form
   pre-warmed into the HBM tier through K3, one epoch through K2 with
   no cache or h2d bytes;
5. the kernel JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

Any failed check raises and the script exits non-zero without a result
line; so does a machine without CUDA, or a directory without the repo.
"""
from __future__ import annotations

import argparse
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


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` launches, each
    between its own pair of CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes: int, flops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        max_abs_err=max_abs_err(imgs, plain3), ms=time_ms(run_k3, 30),
        plain_ms=time_ms(lambda: decode_k.decode_plain(b_t, m_t, H, W), 5,
                         warmup=1),
        nbytes=BATCH * H * W * 3 + 12 * BATCH, flops=0)
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
            nbytes=n_out * size + scalar_bytes, flops=3 * n_out)
        rows["augment" + tag] = dict(
            name="augment" + tag, route="cuda",
            source="src/repro_torch/csrc/augment.cu",
            replaces="src/repro/kernels/augment/kernel.py:61",
            max_abs_err=max_abs_err(k2, plain2),
            ms=time_ms(lambda: run_k2(dtype), 30),
            plain_ms=time_ms(lambda: augment_k.augment_plain(
                imgs, t_t, l_t, f_t, ch, cw, dtype), 5, warmup=1),
            # the crop windows are what the function must read
            nbytes=n_out + n_out * size + 12 * BATCH, flops=3 * n_out)
        del k1, k2, plain1, plain2
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = bound(row.pop("nbytes"),
                                                 row.pop("flops"))
        row["library_ms"] = None       # no single PyTorch call computes it
        print(f"kernel {row['name']}: bitwise equal to plain "
              f"(max_abs_err {row['max_abs_err']}), {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
              f" ms by {row['bound_by']}, "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound",
              flush=True)
    return rows


def reset_counts():
    from repro_torch.kernels.augment import kernel as augment_k
    from repro_torch.kernels.decode import kernel as decode_k
    decode_k.decode.launches = 0
    decode_k.decode_augment.launches = 0
    augment_k.augment.launches = 0


def read_counts():
    from repro_torch.kernels.augment import kernel as augment_k
    from repro_torch.kernels.decode import kernel as decode_k
    return {"decode": decode_k.decode.launches,
            "decode_augment": decode_k.decode_augment.launches,
            "augment": augment_k.augment.launches}


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
            ids, secs, picks = run_epoch(pipe, sess, ds, dev, n // BATCH, rng)
            check(sorted(ids) == list(range(n)),
                  f"epoch {epoch + 1} did not serve every id once")
            check_rows(ds, picks, epoch_seeds=True)
            h2d = tel.channel_total_bytes("h2d") - h2d_before
            results.append((n / secs, h2d))
            print(f"main path augmented, epoch {epoch + 1}: {n} samples in "
                  f"{secs:.3f} s = {n / secs:.1f} samples/s, h2d bytes "
                  f"{h2d} ({card})", flush=True)
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
    try:
        reset_counts()
        for lo in range(0, n, BATCH):
            chunk = list(range(lo, min(lo + BATCH, n)))
            rows = decode_batch([ds.encoded(s) for s in chunk], chunk,
                                seed=ds.seed, image_hw=ds.image_hw,
                                device=dev, as_device=True)
            entries = [(s, rows[i].clone(), ds.decoded_bytes())
                       for i, s in enumerate(chunk)]
            check(bool(sess.admit_batch("decoded", entries).all()),
                  "a decoded row was not admitted into the HBM tier")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
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
    t0 = time.perf_counter()
    build_all()
    print(f"build: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = kernel_phase(dev, args.seed)
    counts = main_path_augmented(dev, N_AUGMENTED, args.seed, card)
    rows["decode_augment"]["launches"] = counts["decode_augment"]
    counts = main_path_decoded(dev, N_DECODED, args.seed, card)
    rows["decode"]["launches"] = counts["decode"]
    rows["augment"]["launches"] = counts["augment"]

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name in ("decode_augment_bf16", "augment_bf16"):
        r = rows.pop(name)
        print(f"variant {name} (not on the main path): {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
              flush=True)
    kernels = [{k: rows[name][k] for k in keys}
               for name in ("decode_augment", "augment", "decode")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
