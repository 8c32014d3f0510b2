"""The ``stream`` driver: one vehicle's online detector in a closed loop.

Set-up builds the port's detector with seeded weights, a
``StreamingDetector`` with the config's coder, and the traffic's frame
pool, then runs the first samples (the ring's fill: a frame pass each, and
every shape the window uses). The window takes samples until ``--seconds``
have passed: each sample's latency runs from handing ``infer`` its frame
(a host float32 array, uploaded inside) to the decoded boxes on the host.
Afterwards, with the port freed, the reference recomputes a seeded sample
of the window's samples from their frames (T frame passes and the head
each) and the decoded boxes are compared.
"""

from __future__ import annotations

import copy
import gc
import time

import numpy as np

from . import check, flops, trace, traffic
from .common import log, percentile
from .weights import build_on_device


def _decoded(out) -> dict:
    return {k: v[0].cpu().numpy() for k, v in out.items()}


def _port(ctx, cfg: dict):
    from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import SparseBEV, _model_kwargs
    torch = ctx.torch
    model = build_on_device(torch, lambda: SparseBEV(**_model_kwargs(cfg)),
                            ctx.seed, ctx.device)
    head = cfg["model"]["pts_bbox_head"]
    return StreamingDetector(model, num_frames=head["num_frames"],
                             coder=build_coder(cfg), device=ctx.device)


def _install_spans(det, spans, patches):
    """CUDA-event spans around the frame pass (the backbone, FPN and pack,
    then the ring write) and the head (the ring view, the head and the
    coder), and profiler annotations for the idle gaps."""
    import sparsebev_tpu_torch.inference as inference
    from torch.profiler import record_function

    def frame_pass(orig):
        def wrapped(img):
            spans.begin("frame_pass")
            with record_function("bench.frame_pass"):
                return orig(img)
        return wrapped

    def ring_update(orig):
        def wrapped(*args):
            out = orig(*args)
            spans.end("frame_pass")
            return out
        return wrapped

    def ring_packed(orig):
        def wrapped(*args):
            spans.begin("head")
            return orig(*args)
        return wrapped

    def decode(orig):
        def wrapped(preds):
            with record_function("bench.decode"):
                out = orig(preds)
            spans.end("head")
            return out
        return wrapped

    trace.patch_attr(patches, det.model, "forward_frame_packed", frame_pass)
    trace.patch_attr(patches, inference, "ring_update", ring_update)
    trace.patch_attr(patches, inference, "ring_packed", ring_packed)
    trace.patch_attr(patches, det.coder, "decode", decode)
    trace.annotate(patches, det.model, "forward_head", "bench.head")
    trace.annotate(patches, det, "infer", "bench.infer")


def _reference(ctx, cfg: dict, stream, picks):
    """The reference's decoded boxes of samples ``picks``."""
    import reference.models.detector as rdet
    from reference.bbox.nms_free_coder import build_coder
    from reference.ops.msmv_sampling import ring_init, ring_packed, ring_update
    torch = ctx.torch
    dev = ctx.device
    model = build_on_device(torch, lambda: rdet.build_detector(cfg),
                            ctx.seed, dev)
    coder = build_coder(cfg)
    head = model.pts_bbox_head
    t = head.num_frames
    h, w = stream.image_hw
    out = {}
    with torch.inference_mode():
        for i in picks:
            ring = meta = None
            for k, j in enumerate(traffic.window_frames(i, t)):
                fp = model.forward_frame_packed(
                    torch.from_numpy(stream.pixels(j)).to(dev))
                if ring is None:
                    meta = fp.meta(gsplit=head.table_gsplit)
                    ring = ring_init(fp, t)
                ring_update(ring, fp, k)
                del fp
            _, l2i, td, _ = stream.sample(i)
            preds = model.forward_head(
                ring_packed(ring, torch.arange(t, device=dev), t, meta),
                torch.from_numpy(l2i).to(dev), torch.from_numpy(td).to(dev),
                h, w)
            out[i] = _decoded(coder.decode(preds))
            del ring, preds
    return out


def run(ctx) -> dict:
    torch = ctx.torch
    params = ctx.params
    cfg = copy.deepcopy(ctx.cfg)
    if ctx.control == "fp8l0":
        # the port's own lower-precision path: an e4m3 level-0 ring
        head = cfg["model"]["pts_bbox_head"]
        head["table_fp8"] = [True] + [False] * (head["num_levels"] - 1)
    elif ctx.control is not None:
        raise ValueError(f"the stream driver has no control {ctx.control!r}")
    det = _port(ctx, cfg)
    t = det.num_frames
    warmup = t + params["extra_warmup_samples"]
    max_samples = (warmup + 1 + int(ctx.seconds
                                    * params["max_samples_per_s"])
                   + params["profile_samples"])
    stream = traffic.Stream(torch, ctx.device, cfg, params, ctx.seed,
                            max_samples)
    for i in range(warmup):
        _decoded(det.infer(*stream.sample(i)))
    ctx.sync()

    spans, patches = None, []
    if ctx.trace:
        spans = trace.EventSpans(torch)
        _install_spans(det, spans, patches)
    ctx.setup_done()

    lat, dispatch, outputs = [], [], {}
    i = warmup
    t_win = time.perf_counter()
    while i < max_samples - params["profile_samples"]:
        args = stream.sample(i)
        t0 = time.perf_counter()
        out = det.infer(*args)
        t1 = time.perf_counter()
        outputs[i] = _decoded(out)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        dispatch.append(t1 - t0)
        i += 1
        if t2 - t_win >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_win
    done = len(lat)
    peak = ctx.read_peak()

    layer = {}
    if ctx.trace:
        frame_ms = spans.total_ms("frame_pass")
        head_ms = spans.total_ms("head")
        layer.update(
            dispatch_ms=1e3 * sum(dispatch) / done,
            frame_pass_ms=None if frame_ms is None
            else frame_ms / spans.count("frame_pass"),
            head_ms=None if head_ms is None else head_ms / spans.count("head"))
        calls = trace.KernelCalls(trace.kernel_counters())
        calls.install()
        try:
            calls.active = True
            with trace.profiled(torch) as prof:
                for _ in range(params["profile_samples"]):
                    _decoded(det.infer(*stream.sample(i)))
                    i += 1
            calls.active = False
        finally:
            calls.remove()
            trace.unpatch(patches)
        layer["profile"] = trace.summarize(prof.trace, prof.wall_s)
        layer["kernel_bounds"] = calls.bounds(ctx.peaks)
        del calls
    log(f"stream: {done} samples in {window_s:.3f} s "
        f"({1e3 * window_s / done:.3f} ms a sample)")

    del det, out
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    window_ids = sorted(outputs)
    rng = np.random.default_rng([ctx.seed, 3])
    picks = sorted(int(x) for x in rng.choice(
        window_ids, size=min(params["check_samples"], len(window_ids)),
        replace=False))
    t_ref = time.perf_counter()
    ref = _reference(ctx, ctx.cfg, stream, picks)
    log(f"reference: {len(picks)} samples in "
        f"{time.perf_counter() - t_ref:.3f} s")
    numbers = check.worst([check.stream_gaps(outputs[i], ref[i])
                           for i in picks])

    if ctx.trace:
        layer["model_flops"] = flops.stream_sample_flops(torch, ctx.cfg)
    return dict(
        attempted=done, failed=0, numbers=numbers, peak=peak,
        e2e={"stream_ms": 1e3 * window_s / done,
             "stream_p95_ms": 1e3 * percentile(lat, 95.0)},
        window_s=window_s, units=done, layer=layer)
