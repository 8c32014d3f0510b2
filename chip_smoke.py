#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparsebev_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card, its power limit, torch's CUDA version, nvcc,
     triton;
  2. build every CUDA kernel of the streaming path from ``sparsebev_tpu_torch/
     csrc`` (one nvcc per source, all started together);
  3. each kernel at the flagship r50 shapes against its plain PyTorch
     version on the same inputs (pack: bit for bit; sampling: within the
     stated tolerance), timed with CUDA events, beside its bound;
  4. streaming inference of ``configs/r50_nuimg_704x256.py`` at full width
     with seeded random weights: 12 samples of a synthetic 6-camera stream,
     one new frame per sample over the T=8 window. The kernel launch counts
     are reset just before this run and read just after it; the outputs must
     be finite and match a second run that uses the plain versions;
  5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "r50_nuimg_704x256.py")
NUM_SAMPLES = 12
PROFILE_SAMPLES = 4
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

def check_pack(torch, dev, flush, bw):
    from sparsebev_tpu_torch.ops.msmv_pack import pack_level, pack_level_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    levels = [(64, 176), (32, 88), (16, 44), (8, 22)]
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
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            fail(f"pack kernel differs from its plain version at {h}x{w}")
        err = max(err, (got.float() - want.float()).abs().max().item())
        ms += time_ms(torch, lambda: pack_level(feat, g), 30, flush)
        plain_ms += time_ms(torch, lambda: pack_level_plain(feat, g), 20,
                            flush, PLAIN_BUSY_CYCLES)
        nbytes += (feat.numel() + got.numel()) * 2
    bound_ms = nbytes / bw * 1e3
    log(f"pack: bit-equal to plain at all 4 levels; one frame {ms:.4f} ms "
        f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB moved)")
    return dict(name="msmv_pack_level", route="cuda",
                source="sparsebev_tpu_torch/csrc/msmv_pack.cu",
                replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def _needed_bytes(torch, packed, loc, sw):
    """Bytes the sampling forward must move for THESE inputs: every table
    half-row that carries a nonzero tap weight, read once, plus the inputs
    and the output. Also returns the fp32 operations of the fold."""
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
        keys = []
        for slot, wx in ((0, wxa), (1, wxb)):
            for half, wy in ((0, wya), (1, wyb)):
                live = (wx != 0) & (wy * lw[:, lvl] != 0)
                keys.append(((col + slot) * 2 + half)[live])
        table_bytes += torch.unique(torch.cat(keys)).numel() * c * itemsize
    io_bytes = (loc.numel() + sw.numel()) * 4 + slices.numel() * 4 \
        + k * c * itemsize
    flops = k * len(packed.level_shapes) * c * 12
    return table_bytes + io_bytes, flops


def check_sampling(torch, dev, flush, bw, fp32_rate):
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        PackedFeatures, msmv_sampling, msmv_sampling_plain)
    gen = torch.Generator(device=dev).manual_seed(2)
    levels = [(64, 176), (32, 88), (16, 44), (8, 22)]
    slots, n, g, cg, t, q, p = 16, 6, 4, 64, 8, 900, 4
    s = t * g
    loc = torch.stack([
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.randint(0, n, (q, s, p), generator=gen, device=dev) / (n - 1),
    ], -1).contiguous()
    sw = torch.softmax(torch.randn((q, s, p, len(levels)), generator=gen,
                                   device=dev), -1).contiguous()
    # the decoder's (g, t) slice order over ring slots of frames t = 0..7
    slot_of_t = (torch.arange(20, 20 - t, -1, device=dev) % slots)
    slice_map = (slot_of_t[None, :] * g
                 + torch.arange(g, device=dev)[:, None]).reshape(s)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        tables = [torch.randn((slots * n * h * g, w + 1, 2 * cg),
                              generator=gen, device=dev, dtype=dtype)
                  for h, w in levels]
        packed = PackedFeatures(tables, s, n, levels, cg, num_groups=g,
                                slice_map=slice_map)
        got = msmv_sampling(packed, loc, sw)
        want = msmv_sampling_plain(packed, loc, sw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        # bf16: output rounded to bf16 once per level, so a differently
        # rounded fp32 partial sum can move it by a few bf16 ulps
        tol = (4 * 2 ** -8 if dtype == torch.bfloat16 else 1e-5) * scale
        exact = torch.equal(got, want)
        log(f"sampling {str(dtype)[6:]}: max|kernel - plain| = {err:.3g} "
            f"(tolerance {tol:.3g}, bit-equal: {exact})")
        if not err <= tol:
            fail(f"sampling kernel differs from its plain version ({dtype})")
        if dtype == torch.bfloat16:
            ms = time_ms(torch, lambda: msmv_sampling(packed, loc, sw), 30,
                         flush)
            plain_ms = time_ms(
                torch, lambda: msmv_sampling_plain(packed, loc, sw), 20,
                flush, PLAIN_BUSY_CYCLES)
            nbytes, flops = _needed_bytes(torch, packed, loc, sw)
            bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
            bound_by = "bytes" if nbytes / bw >= flops / fp32_rate \
                else "operations"
            log(f"sampling bf16: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
                f"bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB needed by these inputs; "
                f"{q * s * p * len(levels) * 4 * cg * 2 / 1e6:.1f} MB of "
                "windows if none were shared)")
            result = dict(
                name="msmv_sample_forward", route="cuda",
                source="sparsebev_tpu_torch/csrc/msmv_sample.cu",
                replaces="sparsebev_tpu/ops/msmv_sampling.py:1011",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
        del tables, packed, got, want
        torch.cuda.empty_cache()
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


def breakdown(torch, det, samples):
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
        for name, fn in (("frame pass (normalize, R50, FPN, 4 packs)",
                          frame_pass),
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


def streaming_phase(torch, dev):
    from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import msmv_pack, msmv_sampling, projection

    cfg = Config.fromfile(CONFIG)
    head = cfg.model["pts_bbox_head"]
    t = head["num_frames"]
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    model = build_detector(cfg, device=dev, seed=0)
    coder = build_coder(cfg)
    stream = make_stream(NUM_SAMPLES + PROFILE_SAMPLES, t, image_h, image_w)
    samples = stream[:NUM_SAMPLES]
    log(f"streaming: {CONFIG} (Q={head['num_query']}, T={t}, "
        f"{image_w}x{image_h}, {head['num_layers']} layers, "
        f"{cfg.model['compute_dtype']}), {NUM_SAMPLES} samples")

    counters = (msmv_pack.pack_level, msmv_sampling.msmv_sampling)
    det = StreamingDetector(model, num_frames=t, device=dev)
    with torch.inference_mode():
        for c in counters:
            c.launches = 0
        times, preds = run_stream(torch, det, samples)
        launches = [c.launches for c in counters]
    log(f"streaming: kernel launches pack={launches[0]} "
        f"sampling={launches[1]}")
    if min(launches) <= 0:
        fail("a kernel of the streaming path was never launched")
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
    log("streaming: per-sample ms " + " ".join(f"{x:.2f}" for x in times))
    log(f"streaming: median {ms:.3f} ms/sample over samples 1..{len(times) - 1}"
        f" ({1e3 / ms:.2f} FPS); sample 0 {times[0]:.1f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{int(dec['mask'].sum())} of {dec['mask'].numel()} decoded boxes "
        "pass the score threshold")
    breakdown(torch, det, stream[NUM_SAMPLES:])
    del det
    torch.cuda.empty_cache()

    # the same stream with the plain versions of both kernels on the card
    saved = (msmv_pack._pack_level_cuda, msmv_sampling._msmv_sampling_cuda,
             projection.project_points_qmajor)
    valid = []

    def project_and_count(*a, **k):
        loc, v = saved[2](*a, **k)
        valid.append(v.mean().item())
        return loc, v

    msmv_pack._pack_level_cuda = msmv_pack.pack_level_plain
    msmv_sampling._msmv_sampling_cuda = msmv_sampling.msmv_sampling_plain
    projection.project_points_qmajor = project_and_count
    try:
        plain_det = StreamingDetector(model, num_frames=t, device=dev)
        _, plain_preds = run_stream(torch, plain_det, samples, prefetch=False)
    finally:
        (msmv_pack._pack_level_cuda, msmv_sampling._msmv_sampling_cuda,
         projection.project_points_qmajor) = saved
    log(f"streaming: share of sampling points that land in a view: "
        f"{statistics.mean(valid):.3f}")
    if statistics.mean(valid) < 0.2:
        fail("too few sampling points land in a camera view")
    # tolerance: bf16 through 6 decoder layers; the kernels are expected to
    # give the plain versions' bits, and an ulp-level difference in a
    # sampled feature would stay well inside 5% of the output scale
    worst = 0.0
    for key in ("all_cls_scores", "all_bbox_preds"):
        for a, b in zip(preds, plain_preds):
            d = (a[key] - b[key]).abs().max().item()
            tol = 5e-2 * max(1.0, b[key].abs().max().item())
            worst = max(worst, d / tol)
            if not d <= tol:
                fail(f"kernel run differs from the plain run in {key}: "
                     f"{d:.4g} > {tol:.4g}")
        d_last = (preds[-1][key] - plain_preds[-1][key]).abs().max().item()
        log(f"streaming: kernel vs plain run, last sample {key}: "
            f"max abs diff {d_last:.4g}")
    log(f"streaming: kernel vs plain within tolerance over all samples "
        f"(worst {worst:.3g} of the tolerance)")
    return launches, ms


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
    if not os.path.isfile(CONFIG):
        fail(f"missing {CONFIG}")
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
    log(f"env: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvcc {nvcc_msg}; import triton: {triton_ok}; "
        f"devices {torch.cuda.device_count()}")
    bw, fp32_rate = peaks(name)
    log(f"env: bound rates for {name}: {bw / 1e12:.2f} TB/s, "
        f"{fp32_rate / 1e12:.0f} TFLOP/s fp32")

    t0 = time.perf_counter()
    try:
        logs = build.build_all(["msmv_pack", "msmv_sample"])
    except RuntimeError as e:
        fail(str(e))
    log(f"build: nvcc {' '.join(build.NVCC_FLAGS)}: both kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                log(f"build[{src}]: {line.strip()}")

    torch.backends.cudnn.benchmark = False
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    kernels = [check_pack(torch, dev, flush, bw),
               check_sampling(torch, dev, flush, bw, fp32_rate)]
    del flush
    torch.cuda.empty_cache()

    launches, _ = streaming_phase(torch, dev)
    for k, n in zip(kernels, launches):
        k["launches"] = n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in keys}
                                for k in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
