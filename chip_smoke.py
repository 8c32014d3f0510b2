#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparsebev_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each phase
prints its wall time):
  1. environment: the card, its power limit, torch's CUDA version, nvcc,
     triton;
  2. build every CUDA kernel of the two streaming paths from
     ``sparsebev_tpu_torch/csrc`` (one nvcc per source, all started
     together): the y-fold pack, the pair-mode pack and the sampling
     forward;
  3. each kernel at the shapes of each path that runs it against its plain
     PyTorch version on the same inputs (bit for bit; the sampling op in
     fp32 within 1e-5 of the output scale), timed with CUDA events beside
     its bound and, where one PyTorch call computes the same function,
     beside that call. At vov99 the sampling op is checked in both of its
     accumulation orders (with and without a group-split level);
  4. streaming inference at full width with seeded random weights, one new
     frame per sample of a synthetic 6-camera stream, for each path:
     ``configs/r50_nuimg_704x256.py`` (12 samples, T=8, 704x256) and
     ``configs/vov99_dd3d_1600x640_trainval_future.py`` (10 samples, T=15,
     1600x640, pair level 0). The kernel launch counts are reset just
     before each path's run and read just after it; the outputs must be
     finite and match a second run of the same stream that uses the plain
     versions;
  5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Needs one CUDA card (it uses ``cuda:0`` alone); imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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
         kernels=("pack", "sampling"),
         levels=[(64, 176), (32, 88), (16, 44), (8, 22)],
         yfold=(True,) * 4, gsplit=(False,) * 4, t=8, q=900),
    dict(name="vov99", config="configs/vov99_dd3d_1600x640_trainval_future.py",
         samples=10, kernels=("pack", "pack_pair", "sampling"),
         levels=[(160, 400), (80, 200), (40, 100), (20, 50), (10, 25)],
         yfold=(False, True, True, True, True),
         gsplit=(False, False, False, True, False), t=15, q=1600),
)
# the plain versions issue up to ~100 small launches per call: keep the
# card busy long enough (~20 ms) that all of them are queued before it idles
PLAIN_BUSY_CYCLES = 40_000_000
# peak device-memory rate and fp32 (non-tensor-core) rate by card
# (NVIDIA data sheets, dense); the H100 SXM figures are the default
_PEAKS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
          ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for key, bw, fp32 in _PEAKS:
        if key.lower() in name.lower():
            return bw, fp32
    return _PEAKS[-1][1:]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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
            ms = time_ms(torch, lambda: msmv_sampling(packed, loc, sw), 30,
                         flush)
            plain_ms = time_ms(
                torch, lambda: msmv_sampling_plain(packed, loc, sw), 20,
                flush, PLAIN_BUSY_CYCLES)
            nbytes, flops = _needed_bytes(torch, packed, loc, sw)
            bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
            bound_by = "bytes" if nbytes / bw >= flops / fp32_rate \
                else "operations"
            log(f"sampling [{path['name']}] bf16: {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB needed by these inputs; "
                f"{q * s * p * len(levels) * 4 * cg * 2 / 1e6:.1f} MB of "
                "windows if none were shared)")
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
        del tables, packed, got, want
        torch.cuda.empty_cache()
    result["max_abs_err"] = err
    return result


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

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    # device-side rows are the kernels and copies themselves; host-side rows
    # are the aten ops that launched them (the ctypes kernels have none)
    device = [e for e in events if str(e.device_type).endswith("CUDA")]
    if not device:
        log("breakdown: the profiler recorded no device time")
        return
    n = len(samples)
    busy = sum(dev_us(e) for e in device) / 1e3 / n
    launches = sum(e.count for e in device) / n
    log(f"breakdown: {n} new-frame samples under torch.profiler: wall "
        f"{wall:.3f} ms/sample, device busy {busy:.3f} ms/sample "
        f"({100 * busy / wall:.1f}%; idle {100 * (1 - busy / wall):.1f}%), "
        f"{launches:.0f} device ops/sample")
    host = [e for e in events if e not in device]
    top = sorted(host, key=dev_us, reverse=True)[:10] + \
        [e for e in device if "msmv" in e.key]
    for e in top:
        log(f"breakdown: {dev_us(e) / 1e3 / n:8.4f} ms/sample "
            f"{e.count / n:6.1f} calls/sample  {e.key[:70]}")


def streaming_phase(torch, dev, path):
    """Stream ``path``'s config at full width; returns the launch count of
    every kernel in this run and the median ms/sample."""
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
    peak = torch.cuda.max_memory_allocated(dev)
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
        f"{times[0]:.1f} ms; peak memory {peak / 2**30:.2f} GiB; "
        f"{int(dec['mask'].sum())} of {dec['mask'].numel()} decoded boxes "
        "pass the score threshold")
    modes = "".join("y" if yf else "p" for yf in model.pts_bbox_head
                    .table_yfold)
    breakdown(torch, det, stream[num_samples:],
              f"normalize, {label}, FPN, packs {modes}")
    del det
    torch.cuda.empty_cache()

    # the same stream with the plain versions of the kernels on the card
    saved = (msmv_pack._pack_level_cuda, msmv_pack._pack_level_pair_cuda,
             msmv_sampling._msmv_sampling_cuda,
             projection.project_points_qmajor)
    valid = []

    def project_and_count(*a, **k):
        loc, v = saved[3](*a, **k)
        valid.append(v.mean().item())
        return loc, v

    msmv_pack._pack_level_cuda = msmv_pack.pack_level_plain
    msmv_pack._pack_level_pair_cuda = msmv_pack.pack_level_pair_plain
    msmv_sampling._msmv_sampling_cuda = msmv_sampling.msmv_sampling_plain
    projection.project_points_qmajor = project_and_count
    try:
        plain_det = StreamingDetector(model, num_frames=t, device=dev)
        _, plain_preds = run_stream(torch, plain_det, samples, prefetch=False)
        del plain_det
    finally:
        (msmv_pack._pack_level_cuda, msmv_pack._pack_level_pair_cuda,
         msmv_sampling._msmv_sampling_cuda,
         projection.project_points_qmajor) = saved
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
    return launches, ms


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
)
_CHECKS = dict(pack=check_pack, pack_pair=check_pack_pair,
               sampling=check_sampling)


def kernels_line(measured, launches):
    """The ``{"kernels": [...]}`` object: per kernel its launches summed
    over the paths (and per path), and its numbers. The headline numbers
    are those of the first path that runs the kernel (r50 for the kernels
    of the first slice); every path's are under ``by_path``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for k, info in KERNELS.items():
        by_path = measured[k]
        head = by_path[next(iter(by_path))]
        rows.append(dict(
            info,
            launches=sum(launches[p][k] for p in launches),
            max_abs_err=max(m["max_abs_err"] for m in by_path.values()),
            **{key: head[key] for key in keys},
            launches_by_path={p: launches[p][k] for p in launches},
            by_path={p: {key: m[key] for key in keys}
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
    bw, fp32_rate = peaks(name)
    log(f"env: bound rates for {name}: {bw / 1e12:.2f} TB/s, "
        f"{fp32_rate / 1e12:.0f} TFLOP/s fp32")

    t0 = time.perf_counter()
    sources = ["msmv_pack", "msmv_pack_pair", "msmv_sample"]
    try:
        logs = build.build_all(sources)
    except RuntimeError as e:
        fail(str(e))
    log(f"build: nvcc {' '.join(build.NVCC_FLAGS)}: {len(sources)} kernels "
        f"built in {time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
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

    launches = {}
    for path in PATHS:
        t0 = time.perf_counter()
        launches[path["name"]], _ = streaming_phase(torch, dev, path)
        log(f"phase: streaming [{path['name']}] took "
            f"{time.perf_counter() - t0:.1f} s")

    log(json.dumps(kernels_line(measured, launches)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
