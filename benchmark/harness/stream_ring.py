"""The ``stream_ring`` driver: the ``stream`` driver's closed loop, checked
through the program's ring.

Set-up, the window and the profiled sub-window are the ``stream`` driver's:
the port's detector with seeded weights behind a ``StreamingDetector``, the
ring's fill, then samples until ``--seconds`` have passed, each timed from
handing ``infer`` its frame (a host float32 array, uploaded inside) to the
decoded boxes on the host. A traced run also switches the port's tracer
(``sparsebev_tpu_torch/utils/tracing.py``) on for the window and the
sub-window (``harness/spans.py``): the window's span sums feed the
per-layer metrics that read program spans.

The check reads what the streaming path left behind. After the window
(and the sub-window) one more sample runs through the same detector, with
a forward hook keeping its trunk's output; it is the last sample whose
boxes the run keeps. A configuration whose frame pass is not bit-equal to
its plain version (the EVA02 attention sums in another order) leaves rings
that differ from the reference's by rounding, which the seeded head
amplifies past any tolerance (PERF.md, fault 1); so the frame pass and the
head are held apart:

- frame pass: the reference recomputes the newest ``check_samples`` frames
  of that sample (backbone, pyramid, packs) and each frame's tables are
  compared with the program's ring rows of that frame, level by level
  (:func:`ring_gaps`); and the newest frame's trunk output (fp32, before the
  bf16 pyramid and ring, whose roundings bury a precision change of the
  trunk) with the reference's (``trunk_gap``);
- head: the reference head, with its plain sampling, runs over the
  program's ring for each sample whose frames the ring still holds (the
  last two), and its decoded boxes are compared with the boxes the run
  kept (``check.stream_gaps``).

``--control attn_bf16`` rounds q, k and v through bf16 before the port's
attention (patched in this process only): a precision below the fp32 the
configuration states for its trunk, which the frame-pass check must fail.
"""

from __future__ import annotations

import gc
import os
import time

from . import check, flops, spans as program, trace, traffic
from .common import log, percentile
from .stream import _decoded, _install_spans, _port
from .weights import build_on_device

_COUNTERS = ("global_calls", "window_calls", "window_tokens",
             "window_real_tokens")


def _attention_counts():
    """The port's attention counters (None where the port has none)."""
    from sparsebev_tpu_torch.ops import eva_attention as ea
    fn = ea.eva_attention
    if not all(hasattr(fn, c) for c in _COUNTERS):
        return None
    return {c: getattr(fn, c) for c in _COUNTERS}


def _attn_bf16(torch, patches) -> None:
    """The control: q, k and v rounded through bf16 before the attention
    of the port's EVA02 blocks."""
    import sparsebev_tpu_torch.models.eva02 as eva

    def make(orig):
        def rounded(q, k, v, *args, **kwargs):
            q, k, v = (t.to(torch.bfloat16).to(t.dtype) for t in (q, k, v))
            return orig(q, k, v, *args, **kwargs)
        return rounded

    trace.patch_attr(patches, eva, "eva_attention", make)


def _gap(prog, ref) -> float:
    """The largest |difference| over the largest |reference|."""
    return float((prog.float() - ref.float()).abs().max()) \
        / max(float(ref.float().abs().max()), 1e-30)


def _rms_gap(prog, ref) -> float:
    """The root-mean-square difference over the reference's."""
    return float((prog.float() - ref.float()).square().mean().sqrt()) \
        / max(float(ref.float().square().mean().sqrt()), 1e-30)


def ring_gaps(prog_levels, ref_levels) -> dict:
    """The program's ring rows of some frames against the reference's
    tables of the same frames, one pair of tensors a level: the worst
    level's :func:`_gap` (``ring_gap``) and :func:`_rms_gap`
    (``ring_rms_gap``)."""
    pairs = list(zip(prog_levels, ref_levels))
    return {"ring_gap": max(_gap(a, b) for a, b in pairs),
            "ring_rms_gap": max(_rms_gap(a, b) for a, b in pairs)}


def _keep_trunk_output(model, kept: list):
    """A forward hook on the EVA02 trunk (``img_backbone.net``) that
    appends its output to ``kept``; the caller removes it."""
    return model.img_backbone.net.register_forward_hook(
        lambda m, args, out: kept.append(out))


def _frame_keys(i: int, t: int):
    names = traffic.frame_names(i, t)
    return [os.path.abspath(names[k * traffic.NUM_VIEWS]) for k in range(t)]


def _reference_check(ctx, cfg: dict, stream, ring, slot_of_key, last: int,
                     outputs, trunk) -> dict:
    """The frame-pass and head checks (module docstring) of the run's last
    sample ``last``, with the program's ``ring``, its slots by frame key
    and the newest frame's trunk output ``trunk``."""
    import reference.models.detector as rdet
    from reference.bbox.nms_free_coder import build_coder
    from reference.ops.msmv_sampling import ring_packed
    _register_reference()
    torch = ctx.torch
    dev = ctx.device
    model = build_on_device(torch, lambda: rdet.build_detector(cfg),
                            ctx.seed, dev)
    head = model.pts_bbox_head
    t = head.num_frames
    h, w = stream.image_hw
    frames = traffic.window_frames(last, t)
    keys = _frame_keys(last, t)
    prog, ref, meta, kept = [], [], None, []
    hook = _keep_trunk_output(model, kept)
    with torch.inference_mode():
        for k in range(min(ctx.params["check_samples"], t)):
            fp = model.forward_frame_packed(
                torch.from_numpy(stream.pixels(frames[k])).to(dev))
            hook.remove()       # the newest frame's (k = 0) only
            if meta is None:
                meta = fp.meta(gsplit=head.table_gsplit)
            slot = slot_of_key[keys[k]]
            for lvl, table in enumerate(fp.tables):
                rows = table.shape[0]
                if lvl == len(prog):
                    prog.append([])
                    ref.append([])
                prog[lvl].append(ring[lvl][slot * rows:(slot + 1) * rows])
                ref[lvl].append(table)
            del fp
        numbers = ring_gaps([torch.cat(x) for x in prog],
                            [torch.cat(x) for x in ref])
        numbers["trunk_gap"] = _gap(trunk, kept[0])
        del prog, ref, kept
        coder = build_coder(cfg)
        gaps = []
        for i in (last - 1, last):
            keys = _frame_keys(i, t)
            if i not in outputs or not all(k in slot_of_key for k in keys):
                continue
            _, l2i, td, _ = stream.sample(i)
            slots = torch.tensor([slot_of_key[k] for k in keys], device=dev)
            preds = model.forward_head(
                ring_packed(ring, slots, t, meta),
                torch.from_numpy(l2i).to(dev), torch.from_numpy(td).to(dev),
                h, w)
            gaps.append(check.stream_gaps(outputs[i],
                                          _decoded(coder.decode(preds))))
            del preds
    numbers.update(check.worst(gaps))
    log(f"check: the ring's {min(ctx.params['check_samples'], t)} newest "
        f"frames of sample {last} and the head of {len(gaps)} sample(s)")
    return numbers


def _register_reference() -> None:
    """The reference's EVA02 backbone registers itself on import."""
    import reference.models.eva02  # noqa: F401


def run(ctx) -> dict:
    torch = ctx.torch
    params = ctx.params
    control_patches = []
    if ctx.control == "attn_bf16":
        _attn_bf16(torch, control_patches)
    elif ctx.control is not None:
        raise ValueError(f"the stream_ring driver has no control "
                         f"{ctx.control!r}")
    try:
        return _run(ctx, torch, params)
    finally:
        trace.unpatch(control_patches)


def _run(ctx, torch, params) -> dict:
    det = _port(ctx, ctx.cfg)
    t = det.num_frames
    warmup = t + params["extra_warmup_samples"]
    # the ring's fill, the window, the sub-window and the checked sample
    max_samples = (warmup + 1 + int(ctx.seconds
                                    * params["max_samples_per_s"])
                   + params["profile_samples"] + 1)
    stream = traffic.Stream(torch, ctx.device, ctx.cfg, params, ctx.seed,
                            max_samples)
    for i in range(warmup):
        _decoded(det.infer(*stream.sample(i)))
    ctx.sync()

    spans, patches = None, []
    if ctx.trace:
        spans = trace.EventSpans(torch)
        _install_spans(det, spans, patches)
        program.enable()
    ctx.setup_done()

    counts0 = _attention_counts()
    lat, outputs = [], {}
    i = warmup
    t_win = time.perf_counter()
    try:
        while i < max_samples - params["profile_samples"] - 1:
            args = stream.sample(i)
            t0 = time.perf_counter()
            outputs[i] = _decoded(det.infer(*args))
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            i += 1
            if t2 - t_win >= ctx.seconds:
                break
        window_s = time.perf_counter() - t_win
        done = len(lat)
        counts1 = _attention_counts()
        if counts0 is not None and counts1 is not None:
            log("eva_attention a sample: " + ", ".join(
                f"{c} {(counts1[c] - counts0[c]) / done:g}"
                for c in _COUNTERS))

        layer = {}
        if ctx.trace:
            layer["program_spans"] = program.collect()
            program.log_table(layer["program_spans"], "sample",
                              "stream.infer", 1e3 * window_s / done)
            for name in ("frame_pass", "head"):
                ms = spans.total_ms(name)
                if ms is not None:
                    log(f"stream: {name} {ms / spans.count(name):.3f} "
                        "device ms a sample")
            calls = trace.KernelCalls(trace.kernel_counters())
            calls.install()
            try:
                calls.active = True
                with trace.profiled(torch) as prof:
                    for _ in range(params["profile_samples"]):
                        outputs[i] = _decoded(det.infer(*stream.sample(i)))
                        i += 1
                calls.active = False
            finally:
                calls.remove()
            layer["profile"] = trace.summarize(prof.trace, prof.wall_s)
            layer["kernel_bounds"] = calls.bounds(ctx.peaks)
            layer["span_idle"] = program.idle_under(prof.trace, prof.wall_s)
            program.log_idle(layer["span_idle"], "sample", "stream.infer")
            del calls, prof
    finally:
        if ctx.trace:
            program.disable()
        trace.unpatch(patches)
    peak = ctx.read_peak()
    log(f"stream: {done} samples in {window_s:.3f} s "
        f"({1e3 * window_s / done:.3f} ms a sample)")

    # the checked sample, its trunk's output kept
    kept = []
    hook = _keep_trunk_output(det.model, kept)
    outputs[i] = _decoded(det.infer(*stream.sample(i)))
    hook.remove()
    # keep the ring and its slots; free the port's model and graphs
    ring, slot_of_key = det.ring, dict(det.slot_of_key)
    del det
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = _reference_check(ctx, ctx.cfg, stream, ring, slot_of_key, i,
                               outputs, kept[0])
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")

    if ctx.trace:
        _register_reference()
        layer["model_flops"] = flops.stream_sample_flops(torch, ctx.cfg)
    return dict(
        attempted=done, failed=0, numbers=numbers, peak=peak,
        e2e={"stream_ms": 1e3 * window_s / done,
             "stream_p95_ms": 1e3 * percentile(lat, 95.0)},
        window_s=window_s, units=done, layer=layer)
