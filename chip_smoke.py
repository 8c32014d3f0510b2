#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparsebev_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each phase
prints its wall time):
  1. environment: the card, its power limit, torch's CUDA version, nvcc,
     triton;
  2. build every CUDA kernel of the port from ``sparsebev_tpu_torch/csrc``
     (one nvcc per source, all started together): the y-fold pack, the
     pair-mode pack, the sampling forward, the one-hot level sampler (two
     entries: all levels in one launch, and one level), the mixing core (two
     entries) and the tap-fold epilogue; for the sampling forward, the
     one-hot sampler and the mixing core, what ``ptxas -v`` reports per
     kernel (registers, shared memory, stack frame, spills);
  3. the first three kernels at the shapes of each streaming path that runs
     them against their plain PyTorch versions on the same inputs (bit for
     bit; the sampling op in fp32 within 1e-5 of the output scale), timed
     with CUDA events beside their bounds and, where one PyTorch call
     computes the same function, beside that call. At vov99 the sampling op
     is checked in both of its accumulation orders (with and without a
     group-split level);
  4. streaming inference at full width with seeded random weights, one new
     frame per sample of a synthetic 6-camera stream, for each path:
     ``configs/r50_nuimg_704x256.py`` (12 samples, T=8, 704x256) and
     ``configs/vov99_dd3d_1600x640_trainval_future.py`` (10 samples, T=15,
     1600x640, pair level 0). The kernel launch counts are reset just
     before each path's run and read just after it; the outputs must be
     finite and match a second run of the same stream that uses the plain
     versions. One more sample of each stream records the inputs of the
     next phase: an ``AdaptiveMixing`` call's operands (a forward hook),
     and at r50 one sampling call's points and the sample's T frames of
     FPN maps;
  5. the hybrid sampling path (``set_sampling_impl("hybrid")``,
     ``pack_mlvl_feats`` and slice-major ``msmv_sampling``) at r50 full
     width on those maps and points, with bf16 and fp32 features: bit for
     bit against the same call through the plain versions and within a
     stated tolerance of the "xla" y-fold path, timed beside it and beside
     the same call with the one-hot levels taken one at a time (as the path
     ran before the fused kernel), each with its count of device launches;
     the fused one-hot kernel against its plain version with a bf16 and an
     fp32 accumulator, with and without a y-fold prefix, and the per-level
     kernel at each level, all bit for bit and timed beside their bounds;
     the sampling forward once more on
     the recorded r50 points and ring (bit for bit against its plain
     version, timed beside the bound of those inputs and the share of
     windows that the points of one (query, slice) have in common); then
     the op-level entry points of the other kernels on the recorded
     inputs: ``mixing_core`` and ``mixing_core_batched`` at r50 and vov99
     (bf16 and fp32, each with its achieved bytes/s and share of its
     bound), ``tap_fold_epilogue`` on windows gathered from the r50 ring.
     Each phase's launch counts are reset just before its run and read
     just after;
  6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Needs one CUDA card (it uses ``cuda:0`` alone); imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_SAMPLES = 4
# the streaming paths: config, samples, the kernels each path must launch,
# and the shapes its kernels see (sampling: level shapes, pair/y-fold mode
# and group-split flags per level, frames T, queries Q)
PATHS = (
    dict(name="r50", config="configs/r50_nuimg_704x256.py", samples=12,
         kernels=("pack", "sampling"), hybrid_source=True,
         levels=[(64, 176), (32, 88), (16, 44), (8, 22)],
         yfold=(True,) * 4, gsplit=(False,) * 4, t=8, q=900),
    dict(name="vov99", config="configs/vov99_dd3d_1600x640_trainval_future.py",
         samples=10, kernels=("pack", "pack_pair", "sampling"),
         levels=[(160, 400), (80, 200), (40, 100), (20, 50), (10, 25)],
         yfold=(False, True, True, True, True),
         gsplit=(False, False, False, True, False), t=15, q=1600),
)
# sources whose ptxas report is printed per kernel
PTXAS_REPORTS = ("msmv_sample", "msmv_onehot", "mixing")
# the plain versions issue up to ~100 small launches per call: keep the
# card busy long enough (~20 ms) that all of them are queued before it idles
PLAIN_BUSY_CYCLES = 40_000_000
# peak device-memory rate, fp32 (non-tensor-core) rate and dense bf16
# tensor-core rate by card (NVIDIA data sheets); H100 SXM is the default
_PEAKS = (("H200", 4.8e12, 67e12, 989e12),
          ("H100 NVL", 3.9e12, 60e12, 835e12),
          ("H100 PCIe", 2.0e12, 51e12, 756e12),
          ("H100", 3.35e12, 67e12, 989e12))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for key, *rates in _PEAKS:
        if key.lower() in name.lower():
            return rates
    return _PEAKS[-1][1:]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _template_args(mangled: str) -> str:
    """Readable form of the template arguments these kernels use, from
    their Itanium mangling: ``f``, ``<n><name>``, ``Li<n>E``, ``Lb<0|1>E``."""
    out, rest = [], mangled
    while rest:
        m = re.match(r"f|Li(\d+)E|Lb([01])E|(\d+)", rest)
        if not m:
            return mangled
        rest = rest[m.end():]
        if m.group(0) == "f":
            out.append("float")
        elif m.group(1):
            out.append(m.group(1))
        elif m.group(2):
            out.append("true" if m.group(2) == "1" else "false")
        else:
            n = int(m.group(3))
            out.append(rest[:n])
            rest = rest[n:]
    return ", ".join(out)


def ptxas_report(text: str):
    """Per kernel of one source's ``nvcc -Xptxas -v`` output: the template
    arguments of its entry (from the mangled name), registers, bytes of
    static shared memory, stack frame and spill stores / loads."""
    rows, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            # _ZN..<len>kernel_nameI<template args>EEv<parameters>
            k = re.search(r"\d+([a-z_]+kernel)I(.+?)EEv", name)
            plain = re.search(r"\d+([a-z_]+kernel)E", name)  # no template
            entry = dict(kernel=f"{k.group(1)}<{_template_args(k.group(2))}>"
                         if k else plain.group(1) if plain else name,
                         regs=0, smem=0, stack=0, spill_stores=0,
                         spill_loads=0)
            rows.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry["stack"], entry["spill_stores"], entry["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(sm.group(1)) if sm else 0
    return rows


def time_ms(torch, fn, reps: int, flush, busy_cycles=2_000_000) -> float:
    """Median device time of one call of ``fn``: the L2 is flushed and the
    card kept busy (``busy_cycles`` of spinning, ~1 ms per 2M cycles)
    before each timed call, so the host's enqueue time does not count."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(busy_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phase 3 --

def _bit_equal(torch, got, want):
    if got.dtype == torch.bfloat16:
        return torch.equal(got.view(torch.int16), want.view(torch.int16))
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def check_pack(torch, dev, flush, bw, path):
    """The y-fold pack at every y-fold level of one frame of ``path``."""
    from sparsebev_tpu_torch.ops.msmv_pack import pack_level, pack_level_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    levels = [hw for hw, yf in zip(path["levels"], path["yfold"]) if yf]
    m, c, g = 6, 256, 4
    ms = plain_ms = 0.0
    nbytes = 0
    err = 0.0
    for h, w in levels:
        feat = torch.randn((m, h, w, c), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        got = pack_level(feat, g)
        want = pack_level_plain(feat, g)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            fail(f"pack kernel differs from its plain version at {h}x{w}")
        err = max(err, (got.float() - want.float()).abs().max().item())
        ms += time_ms(torch, lambda: pack_level(feat, g), 30, flush)
        plain_ms += time_ms(torch, lambda: pack_level_plain(feat, g), 20,
                            flush, PLAIN_BUSY_CYCLES)
        nbytes += (feat.numel() + got.numel()) * 2
    bound_ms = nbytes / bw * 1e3
    log(f"pack [{path['name']}]: bit-equal to plain at all {len(levels)} "
        f"y-fold levels; one frame {ms:.4f} ms (plain {plain_ms:.4f} ms), "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB moved)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def check_pack_pair(torch, dev, flush, bw, path):
    """The pair-mode pack at ``path``'s pair levels (vov99: level 0)."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.ops.msmv_pack import (pack_level_pair,
                                                   pack_level_pair_plain)
    gen = torch.Generator(device=dev).manual_seed(3)
    levels = [hw for hw, yf in zip(path["levels"], path["yfold"]) if not yf]
    m, c, g = 6, 256, 4
    ms = plain_ms = library_ms = 0.0
    nbytes = 0
    for h, w in levels:
        feat = torch.randn((m, h, w, c), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        got = pack_level_pair(feat, g)
        want = pack_level_pair_plain(feat, g)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            fail(f"pair pack kernel differs from its plain version at "
                 f"{h}x{w}")

        def library():
            return F.pad(feat.view(m, h, w, g, c // g).permute(0, 1, 3, 2, 4),
                         (0, 0, 0, 1))

        if not _bit_equal(torch, got, library()):
            fail("pair pack kernel differs from the F.pad library call")
        ms += time_ms(torch, lambda: pack_level_pair(feat, g), 30, flush)
        plain_ms += time_ms(torch, lambda: pack_level_pair_plain(feat, g),
                            20, flush)
        library_ms += time_ms(torch, library, 20, flush)
        nbytes += (feat.numel() + got.numel()) * 2
    bound_ms = nbytes / bw * 1e3
    log(f"pack_pair [{path['name']}]: bit-equal to plain and to the F.pad "
        f"call at {levels}; one frame {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"F.pad {library_ms:.4f} ms), bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB moved)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=library_ms)


def _needed_bytes(torch, packed, loc, sw):
    """Bytes the sampling forward must move for THESE inputs: every table
    piece of C channels (a y-fold half-row or a pair row at one column) that
    carries a nonzero tap weight, read once, plus the inputs and the output.
    Also returns the fp32 operations of the fold."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        _separable_slot_weights, _view_index)
    q, s, p, _ = loc.shape
    k = q * s * p
    c = packed.channels
    itemsize = packed.tables[0].element_size()
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = _view_index(loc[..., 2].reshape(k), packed.num_views)
    slices = packed.slice_map.to(torch.int64)
    batch_row = slices.repeat_interleave(p).repeat(q)
    lw = sw.reshape(k, -1)
    table_bytes = 0
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = _separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        col = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
        if packed.yfold[lvl]:          # key: half-row of one column
            rows = [(col * 2, wya), (col * 2 + 1, wyb)]
            step = 2
        else:                          # key: pair row of one column
            col1 = packed.row_index(batch_row, view,
                                    torch.clamp(ry + 1, max=h - 1), h) \
                * (w + 1) + sx
            rows = [(col, wya), (col1, wyb)]
            step = 1
        keys = []
        for slot, wx in ((0, wxa), (1, wxb)):
            for base, wy in rows:
                live = (wx != 0) & (wy * lw[:, lvl] != 0)
                keys.append((base + slot * step)[live])
        table_bytes += torch.unique(torch.cat(keys)).numel() * c * itemsize
    io_bytes = (loc.numel() + sw.numel()) * 4 + slices.numel() * 4 \
        + k * c * itemsize
    flops = k * len(packed.level_shapes) * c * 12
    return table_bytes + io_bytes, flops


def _window_sharing(torch, packed, loc):
    """Share of (point, level) windows that another point of the same
    (query, slice) also reads: the P points of one (query, slice) sit in
    one warp of the sampling kernel, so these are the reads that can hit in
    L1 (or merge) instead of going to L2 or device memory."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        _separable_slot_weights, _view_index)
    q, s, p, _ = loc.shape
    k = q * s * p
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = _view_index(loc[..., 2].reshape(k), packed.num_views)
    shared = 0
    for h, w in packed.level_shapes:
        sx, ry, _, _ = _separable_slot_weights(x * (w - 1), y * (h - 1), h, w)
        # within one (query, slice) the frame and group are the same
        key = ((view * h + ry) * (w + 1) + sx).reshape(q * s, p)
        key = key.sort(dim=1).values
        shared += int((key[:, 1:] == key[:, :-1]).sum())
    return shared / (k * len(packed.level_shapes))


def _time_sampling(torch, flush, bw, fp32_rate, packed, loc, sw, label):
    """Time the sampling forward and its plain version on these inputs
    beside their bound; logs one line that starts ``sampling [<label>``."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (msmv_sampling,
                                                       msmv_sampling_plain)
    ms = time_ms(torch, lambda: msmv_sampling(packed, loc, sw), 30, flush)
    plain_ms = time_ms(torch, lambda: msmv_sampling_plain(packed, loc, sw),
                       20, flush, PLAIN_BUSY_CYCLES)
    nbytes, flops = _needed_bytes(torch, packed, loc, sw)
    bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / fp32_rate else "operations"
    windows = loc[..., 0].numel() * len(packed.level_shapes) * 4 \
        * packed.channels * packed.tables[0].element_size()
    log(f"sampling [{label}: {ms:.4f} ms (plain {plain_ms:.4f} ms), bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB needed by "
        f"these inputs; {windows / 1e6:.1f} MB of windows if none were "
        f"shared; {100 * _window_sharing(torch, packed, loc):.1f}% of the "
        "windows are shared within a (query, slice))")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_sampling(torch, dev, flush, bw, fp32_rate, path):
    """The sampling forward at ``path``'s shapes on a 16-slot ring, bf16
    and fp32, in the path's accumulation order and (with a group-split
    level) in the unsplit order too."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        PackedFeatures, msmv_sampling, msmv_sampling_plain)
    gen = torch.Generator(device=dev).manual_seed(2)
    levels, yfold, gsplit = path["levels"], path["yfold"], path["gsplit"]
    slots, n, g, cg, t, q, p = 16, 6, 4, 64, path["t"], path["q"], 4
    s = t * g
    loc = torch.stack([
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.randint(0, n, (q, s, p), generator=gen, device=dev) / (n - 1),
    ], -1).contiguous()
    sw = torch.softmax(torch.randn((q, s, p, len(levels)), generator=gen,
                                   device=dev), -1).contiguous()
    # the decoder's (g, t) slice order over ring slots of frames t = 0..T-1
    slot_of_t = (torch.arange(20, 20 - t, -1, device=dev) % slots)
    slice_map = (slot_of_t[None, :] * g
                 + torch.arange(g, device=dev)[:, None]).reshape(s)
    orders = [gsplit] + ([(False,) * len(levels)] if any(gsplit) else [])
    result = {}
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tables = [torch.randn((slots * n * h * g, w + 1, (2 if yf else 1) * cg),
                              generator=gen, device=dev, dtype=dtype)
                  for (h, w), yf in zip(levels, yfold)]
        by_order = []
        for order in orders:
            packed = PackedFeatures(tables, s, n, levels, cg, num_groups=g,
                                    slice_map=slice_map, yfold=yfold,
                                    gsplit=order)
            got = msmv_sampling(packed, loc, sw)
            by_order.append(got)
            want = msmv_sampling_plain(packed, loc, sw)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs().max().item()
            err = max(err, d)
            scale = max(1.0, want.float().abs().max().item())
            exact = _bit_equal(torch, got, want)
            name = "group-major" if any(order) else "unsplit"
            log(f"sampling [{path['name']}] {str(dtype)[6:]} {name} order: "
                f"max|kernel - plain| = {d:.3g}, bit-equal: {exact}")
            # bf16 must give the plain version's bits; fp32 may differ by
            # fp32 rounding of the same sums
            if dtype == torch.bfloat16 and not exact \
                    or not d <= 1e-5 * scale:
                fail(f"sampling kernel differs from its plain version "
                     f"({path['name']}, {dtype}, {name} order)")
        if len(by_order) == 2:
            # how far the pair levels' two accumulation orders drift apart
            d = (by_order[0].float() - by_order[1].float()).abs()
            log(f"sampling [{path['name']}] {str(dtype)[6:]}: the two orders "
                f"differ in {int((d > 0).sum())} of {d.numel()} outputs, "
                f"max {d.max().item():.4g} (output scale "
                f"{by_order[0].float().abs().max().item():.4g})")
        del by_order
        if dtype == torch.bfloat16:
            packed = PackedFeatures(tables, s, n, levels, cg, num_groups=g,
                                    slice_map=slice_map, yfold=yfold,
                                    gsplit=gsplit)
            result = _time_sampling(torch, flush, bw, fp32_rate, packed,
                                    loc, sw, f"{path['name']}] bf16")
        del tables, packed, got, want
        torch.cuda.empty_cache()
    result["max_abs_err"] = err
    return result


def check_sampling_recorded(torch, flush, bw, fp32_rate, cap, name):
    """The sampling forward on one decoder layer's recorded points and the
    stream's ring: bit for bit against the plain version, timed beside the
    bound of these inputs."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (msmv_sampling,
                                                       msmv_sampling_plain)
    packed, loc, sw = cap["sampling"]
    got = msmv_sampling(packed, loc, sw)
    want = msmv_sampling_plain(packed, loc, sw)
    torch.cuda.synchronize()
    if not _bit_equal(torch, got, want):
        fail(f"sampling kernel differs from its plain version on the "
             f"recorded {name} points")
    del got, want
    result = _time_sampling(
        torch, flush, bw, fp32_rate, packed, loc, sw,
        f"{name} recorded points] {str(packed.tables[0].dtype)[6:]}, "
        "bit-equal to plain")
    return dict(result, max_abs_err=0.0)


# ------------------------------------------------------------- phase 4 --

def make_cameras(rng, image_h, image_w, n=6):
    """Six outward-facing pinhole cameras near the origin (lidar2img)."""
    import numpy as np
    mats = []
    for i in range(n):
        yaw = 2 * np.pi * i / n + rng.uniform(-0.1, 0.1)
        cy, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[-sy, cy, 0.0], [0.0, 0.0, -1.0], [cy, sy, 0.0]])
        t = rng.uniform(-0.5, 0.5, 3)
        rt = np.eye(4)
        rt[:3, :3] = r_wc
        rt[:3, 3] = -r_wc @ t
        k = np.eye(4)
        f = image_w * 0.8
        k[0, 0], k[1, 1] = f, f
        k[0, 2], k[1, 2] = image_w / 2, image_h / 2
        mats.append((k @ rt).astype(np.float32))
    return np.stack(mats)


def make_stream(num_samples, num_frames, image_h, image_w, seed=0):
    """Synthetic 6-camera stream: sample i holds frames i, i-1, ... (the
    first frame repeated at the start, as the loader pads history); only the
    newest frame's pixels are passed, older ones must be cached."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cams = make_cameras(np.random.RandomState(seed), image_h, image_w)
    frames = rng.integers(0, 256, (num_samples, 1, 6, image_h, image_w, 3),
                          dtype=np.uint8)
    l2i = np.tile(cams[None], (1, num_frames, 1, 1)).reshape(
        1, num_frames * 6, 4, 4)
    td = (np.arange(num_frames, dtype=np.float32) * 0.5)[None]
    samples = []
    for i in range(num_samples):
        ids = [max(i - j, 0) for j in range(num_frames)]
        names = [f"/data/sweeps/CAM_{v}/frame{j:04d}.jpg" for j in ids
                 for v in range(6)]
        samples.append((frames[i], l2i, td, names))
    return samples


def run_stream(torch, det, samples, prefetch=True):
    """Drive ``det.infer`` over the stream; returns per-sample ms and the
    raw predictions."""
    times, preds = [], []
    for i, s in enumerate(samples):
        if prefetch and i + 1 < len(samples):
            det.prefetch_upload(samples[i + 1][0], samples[i + 1][3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.infer(*s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        preds.append({k: v[-1].float().clone() for k, v in out.items()})
    return times, preds


def _dev_us(e):
    """Device time of a profiler row, under either name torch gives it."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def device_ops(torch, fn):
    """Device operations (kernels, copies, memsets) that one call of ``fn``
    puts on the card, counted from a torch.profiler trace of a second
    call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if _dev_us(e) > 0 and str(e.device_type).endswith("CUDA"))


def breakdown(torch, det, samples, frame_label):
    """Where a streaming sample's time goes: the frame pass and the head
    timed apart (host clock, synchronized), and a torch.profiler trace of
    a few samples (device busy time, kernel launches, top kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_packed

    m, t = det.model, det.num_frames
    frame = torch.from_numpy(samples[0][0]).to(det.device)
    image_h, image_w = frame.shape[2], frame.shape[3]
    l2i = torch.as_tensor(samples[0][1], device=det.device)
    td = torch.as_tensor(samples[0][2], device=det.device)
    slots = torch.arange(t, device=det.device)

    def frame_pass():
        m.forward_frame_packed(frame)

    def head_pass():
        m.forward_head(ring_packed(det.ring, slots, t, det._meta), l2i, td,
                       image_h, image_w)

    split = {}
    with torch.inference_mode():
        for name, fn in ((f"frame pass ({frame_label})", frame_pass),
                         ("head (6 decoder layers, 6 sampling calls)",
                          head_pass)):
            reps = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            split[name] = statistics.median(reps[1:])
    log("breakdown: " + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + " (median of 5, host clock)")

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in samples:
            det.infer(*s)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(samples)

    events = [e for e in prof.key_averages() if _dev_us(e) > 0]
    # device-side rows are the kernels and copies themselves; host-side rows
    # are the aten ops that launched them (the ctypes kernels have none)
    device = [e for e in events if str(e.device_type).endswith("CUDA")]
    if not device:
        log("breakdown: the profiler recorded no device time")
        return
    n = len(samples)
    busy = sum(_dev_us(e) for e in device) / 1e3 / n
    launches = sum(e.count for e in device) / n
    log(f"breakdown: {n} new-frame samples under torch.profiler: wall "
        f"{wall:.3f} ms/sample, device busy {busy:.3f} ms/sample "
        f"({100 * busy / wall:.1f}%; idle {100 * (1 - busy / wall):.1f}%), "
        f"{launches:.0f} device ops/sample")
    host = [e for e in events if e not in device]
    top = sorted(host, key=_dev_us, reverse=True)[:10] + \
        [e for e in device if "msmv" in e.key]
    for e in top:
        log(f"breakdown: {_dev_us(e) / 1e3 / n:8.4f} ms/sample "
            f"{e.count / n:6.1f} calls/sample  {e.key[:70]}")


@contextlib.contextmanager
def plain_versions():
    """Route the CUDA branch of the pack, sampling and one-hot wrappers to
    their plain PyTorch versions (on the card) for the duration."""
    from sparsebev_tpu_torch.ops import msmv_onehot, msmv_pack, msmv_sampling
    saved = (msmv_pack._pack_level_cuda, msmv_pack._pack_level_pair_cuda,
             msmv_sampling._msmv_sampling_cuda, msmv_onehot._onehot_cuda,
             msmv_onehot._onehot_levels_cuda)
    msmv_pack._pack_level_cuda = msmv_pack.pack_level_plain
    msmv_pack._pack_level_pair_cuda = msmv_pack.pack_level_pair_plain
    msmv_sampling._msmv_sampling_cuda = msmv_sampling.msmv_sampling_plain
    msmv_onehot._onehot_cuda = msmv_onehot.onehot_sample_level_plain
    msmv_onehot._onehot_levels_cuda = msmv_onehot.onehot_sample_levels_plain
    try:
        yield
    finally:
        (msmv_pack._pack_level_cuda, msmv_pack._pack_level_pair_cuda,
         msmv_sampling._msmv_sampling_cuda, msmv_onehot._onehot_cuda,
         msmv_onehot._onehot_levels_cuda) = saved


def capture_inputs(torch, det, model, stream, path):
    """Inputs of phase 5, from one more sample of ``path``'s stream (the
    last one streamed, its frames already in the ring): the operands
    ``(x, m, s)`` of its first ``AdaptiveMixing`` call, recorded by a
    forward hook as the layer computes them; for the hybrid source path
    also its first sampling call (the ring view, query-major locations and
    weights) and its T frames of FPN maps (``[T, N, H, W, C]`` per level,
    the frame pass run again on those frames' pixels)."""
    from sparsebev_tpu_torch.models.decoder import AdaptiveMixing
    from sparsebev_tpu_torch.ops import projection

    mixer = next(mod for mod in model.modules()
                 if isinstance(mod, AdaptiveMixing))
    cap = {}

    def hook(mod, inputs, _out):
        if "mixing" in cap:
            return
        x, query = inputs
        b, q, g, p, c = x.shape
        params = mod.parameter_generator(query).reshape(
            b * q, g, mod.m_params + mod.s_params)
        cap["mixing"] = (
            x.reshape(b * q, g, p, c).to(query.dtype).contiguous(),
            params[..., :mod.m_params].reshape(b * q, g, c, c).contiguous(),
            params[..., mod.m_params:].reshape(
                b * q, g, mod.out_points, mod.in_points).contiguous())

    sampling = projection.msmv_sampling

    def record(packed, loc, sw, *a, **k):
        cap.setdefault("sampling", (packed, loc.clone(), sw.clone()))
        return sampling(packed, loc, sw, *a, **k)

    source = path.get("hybrid_source", False)
    handle = mixer.register_forward_hook(hook)
    if source:
        projection.msmv_sampling = record
    try:
        det.infer(*stream[-1])
    finally:
        handle.remove()
        projection.msmv_sampling = sampling
    if not source:
        return cap
    last = len(stream) - 1
    with torch.inference_mode():
        frames = [model.extract_feat(model.preprocess(torch.from_numpy(
            stream[max(last - j, 0)][0]).to(det.device)))
            for j in range(det.num_frames)]
    cap["fpn"] = [torch.stack([f[lvl][0] for f in frames])
                  for lvl in range(len(frames[0]))]
    return cap


def streaming_phase(torch, dev, path):
    """Stream ``path``'s config at full width; returns the launch count of
    every kernel in this run, the median ms/sample and the inputs that
    :func:`capture_inputs` recorded."""
    from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import msmv_pack, msmv_sampling, projection

    config = os.path.join(HERE, path["config"])
    if not os.path.isfile(config):
        fail(f"missing {config}")
    cfg = Config.fromfile(config)
    head = cfg.model["pts_bbox_head"]
    t = head["num_frames"]
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    num_samples = path["samples"]
    name = path["name"]
    # device memory that earlier phases still hold (the inputs recorded for
    # phase 5): the path's peak is counted above it
    held = torch.cuda.memory_allocated(dev)
    model = build_detector(cfg, device=dev, seed=0)
    coder = build_coder(cfg)
    stream = make_stream(num_samples + PROFILE_SAMPLES, t, image_h, image_w)
    samples = stream[:num_samples]
    backbone = cfg.model["img_backbone"]
    label = (f"{backbone.get('spec_name', backbone['type'])} "
             f"{backbone.get('depth', '')}".strip())
    log(f"streaming [{name}]: {config} ({label}, Q={head['num_query']}, "
        f"T={t}, {image_w}x{image_h}, {head['num_levels']} levels, "
        f"{head['num_layers']} layers, {cfg.model['compute_dtype']}), "
        f"{num_samples} samples")

    counters = dict(pack=msmv_pack.pack_level,
                    pack_pair=msmv_pack.pack_level_pair,
                    sampling=msmv_sampling.msmv_sampling)
    det = StreamingDetector(model, num_frames=t, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        for c in counters.values():
            c.launches = 0
        times, preds = run_stream(torch, det, samples)
        launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) - held
    log(f"streaming [{name}]: kernel launches "
        + " ".join(f"{k}={v}" for k, v in launches.items()))
    for k in path["kernels"]:
        if launches[k] <= 0:
            fail(f"kernel {k} of the {name} path was never launched")
    for i, pr in enumerate(preds):
        if not all(bool(torch.isfinite(v).all()) for v in pr.values()):
            fail(f"non-finite predictions at sample {i}")
    cls, box = preds[-1]["all_cls_scores"], preds[-1]["all_bbox_preds"]
    if tuple(cls.shape) != (1, head["num_query"], head["num_classes"]) \
            or tuple(box.shape) != (1, head["num_query"], 10):
        fail(f"unexpected output shapes {tuple(cls.shape)} {tuple(box.shape)}")
    with torch.inference_mode():
        dec = coder.decode({"all_cls_scores": cls[None],
                            "all_bbox_preds": box[None]})
    if not bool(torch.isfinite(dec["bboxes"]).all()):
        fail("non-finite decoded boxes")
    steady = times[1:]
    ms = statistics.median(steady)
    log(f"streaming [{name}]: per-sample ms "
        + " ".join(f"{x:.2f}" for x in times))
    log(f"streaming [{name}]: median {ms:.3f} ms/sample over samples "
        f"1..{len(times) - 1} ({1e3 / ms:.2f} FPS); sample 0 "
        f"{times[0]:.1f} ms; peak memory {peak / 2**30:.2f} GiB (above "
        f"{held / 2**30:.2f} GiB held by earlier phases); "
        f"{int(dec['mask'].sum())} of {dec['mask'].numel()} decoded boxes "
        "pass the score threshold")
    modes = "".join("y" if yf else "p" for yf in model.pts_bbox_head
                    .table_yfold)
    breakdown(torch, det, stream[num_samples:],
              f"normalize, {label}, FPN, packs {modes}")
    captured = capture_inputs(torch, det, model, stream, path)
    del det
    torch.cuda.empty_cache()

    # the same stream with the plain versions of the kernels on the card
    project = projection.project_points_qmajor
    valid = []

    def project_and_count(*a, **k):
        loc, v = project(*a, **k)
        valid.append(v.mean().item())
        return loc, v

    projection.project_points_qmajor = project_and_count
    try:
        with plain_versions():
            plain_det = StreamingDetector(model, num_frames=t, device=dev)
            _, plain_preds = run_stream(torch, plain_det, samples,
                                        prefetch=False)
            del plain_det
    finally:
        projection.project_points_qmajor = project
    log(f"streaming [{name}]: share of sampling points that land in a view: "
        f"{statistics.mean(valid):.3f}")
    if statistics.mean(valid) < 0.2:
        fail("too few sampling points land in a camera view")
    # tolerance: bf16 through 6 decoder layers; the kernels are expected to
    # give the plain versions' bits, and an ulp-level difference in a
    # sampled feature would stay well inside 5% of the output scale
    worst = 0.0
    exact = True
    for key in ("all_cls_scores", "all_bbox_preds"):
        for a, b in zip(preds, plain_preds):
            d = (a[key] - b[key]).abs().max().item()
            tol = 5e-2 * max(1.0, b[key].abs().max().item())
            worst = max(worst, d / tol)
            exact = exact and torch.equal(a[key], b[key])
            if not d <= tol:
                fail(f"kernel run differs from the plain run in {key}: "
                     f"{d:.4g} > {tol:.4g}")
        d_last = (preds[-1][key] - plain_preds[-1][key]).abs().max().item()
        log(f"streaming [{name}]: kernel vs plain run, last sample {key}: "
            f"max abs diff {d_last:.4g}")
    log(f"streaming [{name}]: kernel vs plain within tolerance over all "
        f"samples (worst {worst:.3g} of the tolerance; bit-equal: {exact})")
    del model, preds, plain_preds
    torch.cuda.empty_cache()
    return launches, ms, captured


# ------------------------------------------------------------- phase 5 --

# hybrid vs "xla" path on the same inputs: the one-hot levels take bf16
# tables (for fp32 features, a rounding of every tap), bf16 y and x weights
# and round each column's weighted taps to bf16 (JAX msmv_pallas.py
# :119-125, :81), where the y-fold path keeps fp32 (bf16 features: bf16
# x weights only); with a bf16 accumulator each level's sum rounds too. A
# few bf16 roundings of values up to the output scale, hence 2^-5 of it.
HYBRID_VS_XLA_TOL = 2.0 ** -5
# tap fold vs the sampling op on the same points: the epilogue takes the x
# weights in fp32 and sums the levels in fp32 with one rounding at the end;
# the bf16 op rounds the x weights to bf16 and each level's sum into a bf16
# accumulator: again a few bf16 roundings (2^-5 of the output scale). In
# fp32 only the order of the fp32 sums differs (1e-5 of the scale).
TAP_FOLD_VS_SAMPLING_TOL = {"bfloat16": 2.0 ** -5, "float32": 1e-5}
# mixing kernels vs plain: fp32 sums in another order. fp32: 1e-5 of the
# output scale. bf16: h1 and the output are rounded to bf16, so an fp32
# difference across a rounding boundary flips one bf16 ulp (2^-7 of the
# value at most) of h1, which the second product and LN carry on, or of the
# output: 2^-7 of each value plus 2^-8 of the output scale.
MIXING_TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -8)}


def _slice_feats(fpn, groups):
    """Per-level FPN maps ``[T, N, H, W, G*Cg]`` -> ``[G*T, N, H, W, Cg]``:
    slice ``g*T + t`` is group g of frame t, the slice order of the
    decoder's locations (``project_points_qmajor``)."""
    out = []
    for f in fpn:
        t, n, h, w, c = f.shape
        out.append(f.reshape(t, n, h, w, groups, c // groups)
                   .permute(4, 0, 1, 2, 3, 5)
                   .reshape(groups * t, n, h, w, c // groups).contiguous())
    return out


def _hybrid_sampling_per_level(packed, loc, sw):
    """The hybrid sampling call with the one-hot levels taken one at a time,
    as the path ran before the fused kernel: per level the point arguments,
    the casts and the add as eager PyTorch ops around one launch of the
    per-level kernel. Same bits as the path; the yardstick for the fused
    kernel's time and launch count."""
    from sparsebev_tpu_torch.ops import msmv_onehot as oh
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    s, q, p, _ = loc.shape
    k, c = s * q * p, packed.channels
    n_yf = sum(1 for t in packed.tables if t is not None)
    prefix = ms.PackedFeatures(packed.tables[:n_yf], s, packed.num_views,
                               packed.level_shapes[:n_yf], c)
    out = ms.msmv_sampling(prefix, loc.transpose(0, 1).contiguous(),
                           sw[..., :n_yf].transpose(0, 1).contiguous())
    out = out.transpose(0, 1).reshape(k, c)
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = oh._view_index(loc[..., 2].reshape(k), packed.num_views)
    for lvl in range(n_yf, len(packed.level_shapes)):
        h, w = packed.level_shapes[lvl]
        args = oh._onehot_level_weights(
            x, y, view, sw[..., lvl].reshape(k).float(), h, w)
        res = oh.onehot_sample_level(
            packed.mxu_tables[lvl],
            *[a.reshape(s, q * p).contiguous() for a in args], w=w, c=c)
        out = out + res.reshape(k, c).to(out.dtype)
    return out.reshape(s, q, p, c)


def hybrid_phase(torch, flush, bw, cap):
    """The hybrid path at r50 full width: ``set_sampling_impl("hybrid")``,
    ``pack_mlvl_feats`` and slice-major ``msmv_sampling`` on the recorded
    FPN maps (split into G groups) and one decoder layer's points, with bf16
    and fp32 features. Returns the launch counts of the path's runs and of
    the per-level kernel's own run, and the numbers of the fused and the
    per-level one-hot kernels."""
    from sparsebev_tpu_torch.ops import msmv_onehot, msmv_pack
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    _, loc_q, sw_q = cap["sampling"]
    loc = loc_q.transpose(0, 1).contiguous()           # [S, Q, P, 3]
    sw = sw_q.transpose(0, 1).contiguous()             # [S, Q, P, L]
    s, q, p, _ = loc.shape
    t = cap["fpn"][0].shape[0]
    feats = _slice_feats(cap["fpn"], s // t)
    counters = dict(pack=msmv_pack.pack_level, sampling=ms.msmv_sampling,
                    onehot_fused=msmv_onehot.onehot_sample_levels)
    launches = dict.fromkeys(counters, 0)

    def run(fs, impl):
        ms.set_sampling_impl(impl)
        return ms.msmv_sampling(ms.pack_mlvl_feats(fs), loc, sw, qmajor=False)

    try:
        for dtype in (torch.bfloat16, torch.float32):
            fs = [f.to(dtype) for f in feats]
            dname = str(dtype)[6:]
            for c in counters.values():
                c.launches = 0
            got = run(fs, "hybrid")
            torch.cuda.synchronize()
            for k, c in counters.items():
                launches[k] += c.launches
            packed = ms.pack_mlvl_feats(fs)
            mxu = [lvl for lvl, m in enumerate(packed.mxu_tables)
                   if m is not None]
            acc = torch.float32 if packed.tables[0] is None else dtype
            if tuple(got.shape) != (s, q, p, feats[0].shape[-1]) \
                    or got.dtype != acc or mxu != [1, 2, 3]:
                fail(f"hybrid path: output {tuple(got.shape)} {got.dtype}, "
                     f"one-hot levels {mxu}")
            if not bool(torch.isfinite(got).all()):
                fail("hybrid path: non-finite output")
            with plain_versions():
                plain = run(fs, "hybrid")
            xla = run(fs, "xla")
            per_level = _hybrid_sampling_per_level(packed, loc, sw)
            torch.cuda.synchronize()
            if not _bit_equal(torch, got, plain):
                d = (got.float() - plain.float()).abs().max().item()
                fail(f"hybrid path ({dname}) differs from its plain run "
                     f"(max {d:.4g})")
            if not _bit_equal(torch, got, per_level):
                fail(f"hybrid path ({dname}) differs from the same call "
                     "with the one-hot levels taken one at a time")
            d = (got.float() - xla.float()).abs().max().item()
            scale = xla.float().abs().max().item()
            log(f"hybrid [r50] {dname} features: one-hot levels {mxu}, "
                f"y-fold levels {[lvl for lvl in range(len(packed.tables)) if lvl not in mxu]}; "
                f"bit-equal to the plain run and to the per-level route; "
                f"max|hybrid - xla| = {d:.4g} "
                f"(output scale {scale:.4g}, tolerance "
                f"{HYBRID_VS_XLA_TOL * scale:.4g}); mean "
                f"{(got.float() - xla.float()).abs().mean().item():.3g}")
            if not d <= HYBRID_VS_XLA_TOL * scale:
                fail(f"hybrid path ({dname}) is too far from the xla path")
            ms.set_sampling_impl("xla")
            packed_x = ms.pack_mlvl_feats(fs)

            def hybrid_sampling():
                return ms.msmv_sampling(packed, loc, sw, qmajor=False)

            def xla_sampling():
                return ms.msmv_sampling(packed_x, loc, sw, qmajor=False)

            def per_level_sampling():
                return _hybrid_sampling_per_level(packed, loc, sw)

            busy = PLAIN_BUSY_CYCLES      # each of these makes many launches
            times = dict(
                hybrid=time_ms(torch, lambda: run(fs, "hybrid"), 20, flush,
                               busy),
                xla=time_ms(torch, lambda: run(fs, "xla"), 20, flush, busy),
                hybrid_sampling=time_ms(torch, hybrid_sampling, 20, flush,
                                        busy),
                per_level_sampling=time_ms(torch, per_level_sampling, 20,
                                           flush, busy),
                xla_sampling=time_ms(torch, xla_sampling, 20, flush, busy))
            ops = dict(hybrid=device_ops(torch, hybrid_sampling),
                       per_level=device_ops(torch, per_level_sampling),
                       xla=device_ops(torch, xla_sampling))
            log(f"hybrid [r50] {dname} features: pack + sampling "
                f"{times['hybrid']:.4f} ms (xla path {times['xla']:.4f} ms); "
                f"sampling alone {times['hybrid_sampling']:.4f} ms in "
                f"{ops['hybrid']} device launches (one-hot levels one at a "
                f"time, as before the fused kernel: "
                f"{times['per_level_sampling']:.4f} ms in {ops['per_level']} "
                f"launches; xla {times['xla_sampling']:.4f} ms in "
                f"{ops['xla']})")
            if not ops["hybrid"] < ops["per_level"]:
                fail("the fused one-hot kernel saved no device launch")
            del got, plain, xla, per_level, packed_x
        onehot_launches, onehot, fused = check_onehot(torch, flush, bw,
                                                      packed, loc, sw)
    finally:
        ms.set_sampling_impl("xla")
    log("hybrid [r50]: kernel launches "
        + " ".join(f"{k}={v}" for k, v in launches.items()))
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} of the hybrid path was never launched")
    return launches, onehot_launches, onehot, fused


def _touched_bytes(torch, si, args, nh, w, c):
    """Bytes of the table runs (C bf16 values) that these points' taps touch
    with a nonzero weight, each run counted once."""
    rows0, rows1, wy0, wy1, x0, wx0, wx1 = [a.reshape(-1) for a in args]
    keys = []
    for rows, wy in ((rows0, wy0), (rows1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            live = (wy != 0) & (wx != 0)
            keys.append(((si * nh + rows.long()) * w + x0.long() + dx)[live])
    return torch.unique(torch.cat(keys)).numel() * c * 2


def check_onehot(torch, flush, bw, packed, loc, sw):
    """The two one-hot kernels on the hybrid pack's MXU levels and one
    decoder layer's points, bit for bit against their plain versions, timed.

    Per level: the per-level entry once (counted), then the kernel against
    its plain version. Its bound counts the table runs these points touch
    with a nonzero weight, read once, 28 bytes of per-point arguments and
    the fp32 output. The fused kernel: every level in one launch onto a bf16
    and an fp32 accumulator that holds the y-fold level's result, and onto
    zeros (no prefix). Its bound counts the same table runs, the locations
    and scale weights once, and the accumulator read once and written
    once."""
    from sparsebev_tpu_torch.ops import msmv_onehot as oh
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    s, q, p, _ = loc.shape
    k, c, n = s * q * p, packed.channels, packed.num_views
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = oh._view_index(loc[..., 2].reshape(k), n)
    si = torch.arange(s, device=loc.device).repeat_interleave(q * p)
    mxu = [lvl for lvl, t in enumerate(packed.mxu_tables) if t is not None]
    tables = [packed.mxu_tables[lvl] for lvl in mxu]
    shapes = [packed.level_shapes[lvl] for lvl in mxu]
    level = dict(ms=0.0, plain_ms=0.0, nbytes=0)
    touched_all = 0
    level_args = [[a.reshape(s, q * p).contiguous()
                   for a in oh._onehot_level_weights(
                       x, y, view, sw[..., lvl].reshape(k).float(), h, w)]
                  for lvl, (h, w) in zip(mxu, shapes)]
    oh.onehot_sample_level.launches = 0
    gots = [oh.onehot_sample_level(table, *args, w=w, c=c)
            for table, args, (_, w) in zip(tables, level_args, shapes)]
    torch.cuda.synchronize()
    launches = oh.onehot_sample_level.launches
    for lvl, table, (h, w), args, got in zip(mxu, tables, shapes, level_args,
                                             gots):
        want = oh.onehot_sample_level_plain(table, *args, w=w, c=c)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            d = (got - want).abs().max().item()
            fail(f"one-hot kernel differs from its plain version at level "
                 f"{lvl} ({h}x{w}, max {d:.4g})")
        kern = time_ms(torch, lambda: oh.onehot_sample_level(
            table, *args, w=w, c=c), 30, flush)
        plain = time_ms(torch, lambda: oh.onehot_sample_level_plain(
            table, *args, w=w, c=c), 20, flush, PLAIN_BUSY_CYCLES)
        touched = _touched_bytes(torch, si, args, table.shape[1], w, c)
        lvl_bytes = touched + k * (28 + 4 * c)
        log(f"onehot [r50 levels] level {lvl} ({h}x{w}, "
            f"{table.numel() * 2 / 1e6:.1f} MB table): bit-equal to plain; "
            f"{kern:.4f} ms (plain {plain:.4f} ms), bound "
            f"{lvl_bytes / bw * 1e3:.4f} ms ({touched / 1e6:.1f} MB of the "
            f"table touched, {lvl_bytes / 1e6:.1f} MB in all)")
        level["ms"] += kern
        level["plain_ms"] += plain
        level["nbytes"] += lvl_bytes
        touched_all += touched
    del gots, got, want, level_args, args
    if launches != len(mxu):
        fail(f"one-hot per-level kernel: {launches} launches for "
             f"{len(mxu)} levels")
    log(f"onehot [r50 levels]: {len(mxu)} levels {level['ms']:.4f} ms (plain "
        f"{level['plain_ms']:.4f} ms), bound "
        f"{level['nbytes'] / bw * 1e3:.4f} ms ({level['nbytes'] / 1e6:.1f} "
        f"MB): {100 * level['nbytes'] / bw * 1e3 / level['ms']:.1f}% of the "
        f"bound; launches in its run: {launches}")

    # the fused kernel: accumulators that hold the y-fold level's result
    n_yf = mxu[0]
    prefix = ms.PackedFeatures(packed.tables[:n_yf], s, n,
                               packed.level_shapes[:n_yf], c)
    pre = ms.msmv_sampling(prefix, loc.transpose(0, 1).contiguous(),
                           sw[..., :n_yf].transpose(0, 1).contiguous())
    pre = pre.transpose(0, 1).reshape(k, c).float()
    fused = {}
    for acc_dtype in (torch.bfloat16, torch.float32):
        aname = str(acc_dtype)[6:]
        for label, base in (("y-fold prefix", pre.to(acc_dtype)),
                            ("no prefix", torch.zeros_like(
                                pre, dtype=acc_dtype))):
            got = oh.onehot_sample_levels(tables, shapes, mxu, loc, sw,
                                          base.clone(), n, c)
            want = oh.onehot_sample_levels_plain(tables, shapes, mxu, loc, sw,
                                                 base.clone(), n, c)
            torch.cuda.synchronize()
            if not _bit_equal(torch, got, want):
                d = (got.float() - want.float()).abs().max().item()
                fail(f"fused one-hot kernel differs from its plain version "
                     f"({aname} accumulator, {label}, max {d:.4g})")
            del got, want
        base = pre.to(acc_dtype)
        kern = time_ms(torch, lambda: oh.onehot_sample_levels(
            tables, shapes, mxu, loc, sw, base, n, c), 30, flush)
        base = pre.to(acc_dtype)
        plain = time_ms(torch, lambda: oh.onehot_sample_levels_plain(
            tables, shapes, mxu, loc, sw, base, n, c), 20, flush,
            PLAIN_BUSY_CYCLES)
        nbytes = touched_all + loc.numel() * 4 \
            + sw.numel() * sw.element_size() + 2 * k * c * base.element_size()
        bound_ms = nbytes / bw * 1e3
        log(f"onehot_fused [hybrid] {aname} accumulator: bit-equal to plain "
            f"with a y-fold prefix and without; {len(mxu)} levels in one "
            f"launch {kern:.4f} ms (plain {plain:.4f} ms; the per-level "
            f"kernel's {len(mxu)} launches {level['ms']:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({touched_all / 1e6:.1f} MB of the tables "
            f"touched, {nbytes / 1e6:.1f} MB in all): "
            f"{nbytes / kern / 1e6:.0f} GB/s, {100 * bound_ms / kern:.1f}% "
            "of the bound")
        if acc_dtype == torch.bfloat16:
            fused = dict(max_abs_err=0.0, ms=kern, plain_ms=plain,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=None, per_level_ms=level["ms"])
        else:
            fused.update(fp32_acc_ms=kern, fp32_acc_bound_ms=bound_ms)
    return ({"onehot": launches},
            dict(max_abs_err=0.0, ms=level["ms"], plain_ms=level["plain_ms"],
                 bound_ms=level["nbytes"] / bw * 1e3, bound_by="bytes",
                 library_ms=None), fused)


def _gather_windows(torch, packed, loc, sw):
    """The y-fold windows ``[K, 2, 2C]`` of every level at these query-major
    points and their weights ``[K, 4]`` = (wxa, wxb, wya*lw, wyb*lw)."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    q, s, p, _ = loc.shape
    k, c = q * s * p, packed.channels
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = ms._view_index(loc[..., 2].reshape(k), packed.num_views)
    batch_row = packed.slice_map.to(torch.int64).repeat_interleave(p) \
        .repeat(q)
    lw = sw.reshape(k, -1)
    gathered, weights = [], []
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = ms._separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        flat = packed.tables[lvl].reshape(-1, 2 * c)
        col = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
        gathered.append(torch.stack([flat[col], flat[col + 1]], 1))
        weights.append(torch.stack([wxa, wxb, wya * lw[:, lvl],
                                    wyb * lw[:, lvl]], 1).contiguous())
    return gathered, weights


def check_tap_fold(torch, flush, bw, fp32_rate, cap):
    """``tap_fold_epilogue`` on the windows of the r50 ring at one decoder
    layer's points (K = Q*T*G*P, L = 4): its entry point once (counted),
    bf16 and fp32 windows bit for bit against the plain version, and
    within a stated tolerance of the sampling op on the same points."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    from sparsebev_tpu_torch.ops.msmv_epilogue import (
        tap_fold_epilogue, tap_fold_epilogue_plain)
    packed, loc, sw = cap["sampling"]
    if not all(packed.yfold):
        fail("tap fold: the r50 ring should hold y-fold levels only")
    c = packed.channels
    gathered, weights = _gather_windows(torch, packed, loc, sw)
    k = weights[0].shape[0]
    tap_fold_epilogue.launches = 0
    first = tap_fold_epilogue(gathered, weights, c, torch.bfloat16)
    torch.cuda.synchronize()
    launches = tap_fold_epilogue.launches
    if launches <= 0 or not bool(torch.isfinite(first).all()):
        fail("tap fold: the kernel was not launched or gave non-finite values")
    fp32_packed = ms.PackedFeatures(
        [t.float() for t in packed.tables], packed.batch, packed.num_views,
        packed.level_shapes, c, num_groups=packed.num_groups,
        slice_map=packed.slice_map, yfold=packed.yfold)
    err = 0.0
    for dtype, pk in ((torch.bfloat16, packed), (torch.float32, fp32_packed)):
        dname = str(dtype)[6:]
        gs = [g.to(dtype) for g in gathered]
        got = tap_fold_epilogue(gs, weights, c, dtype)
        want = tap_fold_epilogue_plain(gs, weights, c, dtype)
        ref = ms.msmv_sampling(pk, loc, sw).reshape(k, c)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            fail(f"tap fold kernel ({dname}) differs from its plain version")
        d = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = TAP_FOLD_VS_SAMPLING_TOL[dname] * scale
        log(f"tap_fold [r50] {dname} windows: bit-equal to plain; "
            f"max|fold - sampling op| = {d:.4g} (output scale {scale:.4g}, "
            f"tolerance {tol:.4g})")
        if not d <= tol:
            fail(f"tap fold ({dname}) is too far from the sampling op")
        err = max(err, d)
        del gs, got, want, ref
    ms_k = time_ms(torch, lambda: tap_fold_epilogue(
        gathered, weights, c, torch.bfloat16), 30, flush)
    plain_ms = time_ms(torch, lambda: tap_fold_epilogue_plain(
        gathered, weights, c, torch.bfloat16), 20, flush, PLAIN_BUSY_CYCLES)
    nbytes = sum(g.numel() * 2 + w.numel() * 4
                 for g, w in zip(gathered, weights)) + k * c * 2
    flops = k * len(gathered) * 10 * c + k * c
    bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / fp32_rate else "operations"
    log(f"tap_fold [r50] bf16: K={k}, {len(gathered)} levels: {ms_k:.4f} ms "
        f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.1f} MB); launches in its run: {launches}")
    return {"tap_fold": launches}, dict(
        max_abs_err=err, ms=ms_k, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)


def check_mixing(torch, flush, bw, fp32_rate, bf16_rate, name, xms):
    """``mixing_core`` (two-pass) and ``mixing_core_batched`` (one-pass) on
    one ``AdaptiveMixing`` call's operands of the ``name`` stream, as
    recorded (bf16) and in fp32: each entry point once (counted), then
    against the plain version within ``MIXING_TOL``, timed beside the
    decoder's own chain (two ``torch.matmul`` and two ``_ln2d``)."""
    from sparsebev_tpu_torch.models.decoder import _ln2d
    from sparsebev_tpu_torch.ops import mixing
    torch.backends.cuda.matmul.allow_tf32 = False
    x, m, s = xms
    n, g, p, c = x.shape
    o = s.shape[2]
    entries = dict(mixing=(mixing.mixing_core, "twopass"),
                   mixing_batched=(mixing.mixing_core_batched, "onepass"))
    launches = dict.fromkeys(entries, 0)
    err = dict.fromkeys(entries, 0.0)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        xd, md, sd = (t.to(dtype).contiguous() for t in (x, m, s))
        for fn, _ in entries.values():
            fn.launches = 0
        outs = {key: fn(xd, md, sd) for key, (fn, _) in entries.items()}
        torch.cuda.synchronize()
        for key, (fn, _) in entries.items():
            launches[key] += fn.launches
        rtol, atol = MIXING_TOL[dname]
        for key, (fn, stats) in entries.items():
            got = outs[key]
            want = mixing.mixing_core_plain(xd, md, sd, stats=stats)
            torch.cuda.synchronize()
            if got.dtype != dtype or tuple(got.shape) != (n, g, o, c) \
                    or not bool(torch.isfinite(got).all()):
                fail(f"{key} [{name}]: output {tuple(got.shape)} {got.dtype}")
            diff = (got.float() - want.float()).abs()
            scale = max(1.0, want.float().abs().max().item())
            bad = diff > rtol * want.float().abs() + atol * scale
            log(f"{key} [{name}] {dname}: max|kernel - plain| = "
                f"{diff.max().item():.4g} (output scale {scale:.4g}), "
                f"{int((diff > 0).sum())} of {diff.numel()} differ, "
                f"{int(bad.sum())} beyond the tolerance")
            if bool(bad.any()):
                fail(f"{key} kernel [{name}, {dname}] differs from its plain "
                     "version beyond the tolerance")
            err[key] = max(err[key], diff.max().item())

        def chain():
            h = torch.matmul(xd, md)
            h = torch.relu(_ln2d(h)).to(dtype)
            return torch.relu(_ln2d(torch.matmul(sd, h))).to(dtype)

        items = n * g
        nbytes = (xd.numel() + md.numel() + sd.numel() + items * o * c) \
            * xd.element_size()
        flops = 2 * items * (p * c * c + o * p * c)
        rate = bf16_rate if dtype == torch.bfloat16 else fp32_rate
        bound_ms = max(nbytes / bw, flops / rate) * 1e3
        bound_by = "bytes" if nbytes / bw >= flops / rate else "operations"
        chain_ms = time_ms(torch, chain, 20, flush, PLAIN_BUSY_CYCLES)
        for key, (fn, stats) in entries.items():
            kern = time_ms(torch, lambda: fn(xd, md, sd), 30, flush)
            plain = time_ms(torch, lambda: mixing.mixing_core_plain(
                xd, md, sd, stats=stats), 20, flush, PLAIN_BUSY_CYCLES)
            rate_gbs = nbytes / kern / 1e6
            share = bound_ms / kern
            log(f"{key} [{name}] {dname} "
                f"({mixing.mixing_route(dtype, p, c, o)} kernel): {items} "
                f"items (BQ={n}, G={g}, P={p}, C={c}, O={o}) "
                f"{kern:.4f} ms (plain {plain:.4f} ms; the decoder's chain "
                f"{chain_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP): "
                f"{rate_gbs:.0f} GB/s achieved, {100 * share:.1f}% of the "
                "bound")
            if dtype == torch.bfloat16:
                result[key] = dict(ms=kern, plain_ms=plain, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=None,
                                   chain_ms=chain_ms, gbytes_per_s=rate_gbs,
                                   bound_share=share)
            else:
                result[key].update(fp32_ms=kern, fp32_bound_ms=bound_ms,
                                   fp32_gbytes_per_s=rate_gbs,
                                   fp32_bound_share=share)
        del xd, md, sd, outs
    for key, v in launches.items():
        if v <= 0:
            fail(f"kernel {key} was never launched in its run [{name}]")
        result[key]["max_abs_err"] = err[key]
    return launches, result


KERNELS = dict(
    pack=dict(name="msmv_pack_level", route="cuda",
              source="sparsebev_tpu_torch/csrc/msmv_pack.cu",
              replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:63"),
    pack_pair=dict(name="msmv_pack_pair_level", route="cuda",
                   source="sparsebev_tpu_torch/csrc/msmv_pack_pair.cu",
                   replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:154"),
    sampling=dict(name="msmv_sample_forward", route="cuda",
                  source="sparsebev_tpu_torch/csrc/msmv_sample.cu",
                  replaces="sparsebev_tpu/ops/msmv_sampling.py:1011"),
    onehot=dict(name="msmv_onehot_sample_level", route="cuda",
                source="sparsebev_tpu_torch/csrc/msmv_onehot.cu",
                replaces="sparsebev_tpu/ops/msmv_pallas.py:89"),
    onehot_fused=dict(name="msmv_onehot_sample_levels", route="cuda",
                      source="sparsebev_tpu_torch/csrc/msmv_onehot.cu",
                      replaces="sparsebev_tpu/ops/msmv_pallas.py:89"),
    mixing=dict(name="mixing_core_twopass", route="cuda",
                source="sparsebev_tpu_torch/csrc/mixing.cu",
                replaces="sparsebev_tpu/ops/mixing_pallas.py:74"),
    mixing_batched=dict(name="mixing_core_onepass", route="cuda",
                        source="sparsebev_tpu_torch/csrc/mixing.cu",
                        replaces="sparsebev_tpu/ops/mixing_pallas.py:160"),
    tap_fold=dict(name="tap_fold_epilogue", route="cuda",
                  source="sparsebev_tpu_torch/csrc/tap_fold.cu",
                  replaces="sparsebev_tpu/ops/msmv_epilogue_pallas.py:73"),
)
_CHECKS = dict(pack=check_pack, pack_pair=check_pack_pair,
               sampling=check_sampling)


def kernels_line(measured, launches):
    """The ``{"kernels": [...]}`` object: per kernel its launches summed
    over the runs that drive it (streaming paths, the hybrid path, the
    op-level runs; per run under ``launches_by_path``), and its numbers.
    The headline numbers are those of the first path that measured the
    kernel (r50 where it runs there); every path's are under ``by_path``.
    The mixing rows add ``chain_ms``, the decoder's own chain on the same
    inputs (a yardstick, not a library call), the achieved ``gbytes_per_s``
    and ``bound_share`` (bound over time), and the same for fp32 inputs
    under ``fp32_*``. The fused one-hot row adds ``per_level_ms``, the
    per-level kernel's launches for the same levels, and its time and bound
    with an fp32 accumulator under ``fp32_acc_*``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for k, info in KERNELS.items():
        by_path = measured[k]
        head = by_path[next(iter(by_path))]
        extra = {key: v for key, v in head.items()
                 if key not in keys and key != "max_abs_err"}
        rows.append(dict(
            info,
            launches=sum(run.get(k, 0) for run in launches.values()),
            max_abs_err=max(m["max_abs_err"] for m in by_path.values()),
            **{key: head[key] for key in keys}, **extra,
            launches_by_path={p: run[k] for p, run in launches.items()
                              if k in run},
            by_path={p: {key: v for key, v in m.items()
                         if key != "max_abs_err"}
                     for p, m in by_path.items()}))
    return {"kernels": rows}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    sys.path.insert(0, HERE)
    try:
        import sparsebev_tpu_torch  # noqa: F401
        from sparsebev_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the sparsebev_tpu_torch package is not beside this script "
             f"({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    try:
        import triton  # noqa: F401
        triton_ok = f"yes ({triton.__version__})"
    except Exception as e:  # noqa: BLE001 - report whatever import raised
        triton_ok = f"no ({type(e).__name__})"
    try:
        nvcc = build.find_nvcc()
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        nvcc_msg = f"{nvcc} ({ver.splitlines()[-1] if ver else '?'})"
    except RuntimeError as e:
        fail(str(e))
    visible = torch.cuda.device_count()
    log(f"env: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvcc {nvcc_msg}; import triton: {triton_ok}")
    log(f"env: {visible} card(s) visible; this run uses cuda:0 alone")
    bw, fp32_rate, bf16_rate = peaks(name)
    log(f"env: bound rates for {name}: {bw / 1e12:.2f} TB/s, "
        f"{fp32_rate / 1e12:.0f} TFLOP/s fp32, {bf16_rate / 1e12:.0f} "
        "TFLOP/s bf16 tensor cores")

    t0 = time.perf_counter()
    sources = ["msmv_pack", "msmv_pack_pair", "msmv_sample", "msmv_onehot",
               "mixing", "tap_fold"]
    try:
        logs = build.build_all(sources)
    except RuntimeError as e:
        fail(str(e))
    log(f"build: nvcc {' '.join(build.NVCC_FLAGS)}: {len(sources)} kernels "
        f"built in {time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        if src in PTXAS_REPORTS:
            for r in ptxas_report(text):
                log(f"ptxas[{src}]: {r['kernel']}: {r['regs']} registers, "
                    f"{r['smem']} bytes static shared memory, {r['stack']} "
                    f"bytes stack frame, spills {r['spill_stores']} / "
                    f"{r['spill_loads']} bytes (stores / loads)")
            continue
        for line in text.splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                log(f"build[{src}]: {line.strip()}")

    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    measured = {k: {} for k in KERNELS}
    for path in PATHS:
        for k in path["kernels"]:
            args = (fp32_rate,) if k == "sampling" else ()
            measured[k][path["name"]] = _CHECKS[k](torch, dev, flush, bw,
                                                   *args, path)
    del flush
    torch.cuda.empty_cache()
    log(f"phase: kernel checks took {time.perf_counter() - t0:.1f} s")

    launches, captured = {}, {}
    for path in PATHS:
        t0 = time.perf_counter()
        launches[path["name"]], _, captured[path["name"]] = streaming_phase(
            torch, dev, path)
        log(f"phase: streaming [{path['name']}] took "
            f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    source = next(p["name"] for p in PATHS if p.get("hybrid_source"))
    with torch.inference_mode():
        (launches["hybrid"], launches[f"onehot {source} levels"],
         measured["onehot"][f"{source} levels"],
         measured["onehot_fused"]["hybrid"]) = hybrid_phase(
             torch, flush, bw, captured[source])
    log(f"phase: hybrid path took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        measured["sampling"][f"{source} recorded"] = check_sampling_recorded(
            torch, flush, bw, fp32_rate, captured[source], source)
        for path in PATHS:
            pname = path["name"]
            launches[f"mixing {pname}"], res = check_mixing(
                torch, flush, bw, fp32_rate, bf16_rate, pname,
                captured[pname].pop("mixing"))
            for key, m in res.items():
                measured[key][pname] = m
        launches[f"tap_fold {source}"], measured["tap_fold"][source] = \
            check_tap_fold(torch, flush, bw, fp32_rate, captured[source])
    del flush, captured
    torch.cuda.empty_cache()
    log(f"phase: recorded-points sampling, mixing and tap fold checks took "
        f"{time.perf_counter() - t0:.1f} s")

    log(json.dumps(kernels_line(measured, launches)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
