"""fp8-L0 ring drift proxy of the port (counterpart of the repository's
``tools/fp8_drift.py``).

    python -m sparsebev_tpu_torch.tools.fp8_drift --config CONFIG \\
        [--samples 4] [--seed 0] [--device cuda|cpu]

The same synthetic frames stream through two rings one after the other (so
one ring is alive at a time): the config's own ring, and a ring with every
level y-fold and level 0 stored in e4m3 (``table_fp8``). Both detectors
carry the same seeded weights (``models/detector.py::random_init_``). The
report is one JSON line with the JAX tool's keys: the relative error of
level 0's features rounded to e4m3 (weights-independent), and the decoded
boxes' drift between the two streams (center, size, yaw, score, velocity:
mean, 99th percentile and maximum). Random weights refine queries
chaotically, so the box drift overstates what a trained model would see.
CUDA unless ``--device cpu``. ``main(argv)`` returns the report.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="fp8-L0 ring drift proxy "
                                            "(PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--samples", type=int, default=4,
                   help="streamed samples (the ring fills with quantized "
                        "history as the stream advances)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain PyTorch "
                        "versions)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..bbox.nms_free_coder import build_coder
    from ..config import Config
    from ..inference import StreamingDetector
    from ..models.detector import build_detector
    from ..ops.msmv_sampling import E4M3, E4M3_MAX
    from ..utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    head = cfg.model["pts_bbox_head"]
    num_frames = head["num_frames"]
    num_levels = head.get("num_levels", 4)
    fh, fw = cfg.ida_aug_conf["final_dim"]

    rng = np.random.RandomState(args.seed)
    frame0 = rng.uniform(0, 255, (1, 6, fh, fw, 3)).astype(np.float32)
    l2i = rng.randn(1, num_frames * 6, 4, 4).astype(np.float32)
    td = np.linspace(0, 0.5 * (num_frames - 1), num_frames,
                     dtype=np.float32)[None]

    model = build_detector(cfg, device=dev, seed=args.seed)
    cfg8 = Config.fromfile(args.config)
    cfg8.merge_from_dict({
        "model.pts_bbox_head.table_yfold": [True] * num_levels,
        "model.pts_bbox_head.table_fp8": [True] + [False] * (num_levels - 1)})
    model8 = build_detector(cfg8, device=dev)
    model8.load_state_dict(model.state_dict())

    def stream(m, c):
        det = StreamingDetector(m, num_frames=num_frames, coder=c,
                                device=dev)
        srng = np.random.RandomState(args.seed + 1)
        outs = []
        for i in range(args.samples):
            # fresh pixels a sample; the window repeats them, and history
            # (keyed by name) comes from the ring, as the loader pads it
            frame = srng.uniform(0, 255, (1, 6, fh, fw, 3)).astype(np.float32)
            window = np.tile(frame, (1, num_frames, 1, 1, 1))
            names = [f"frame_{max(i - k, 0)}_{v}" for k in range(num_frames)
                     for v in range(6)]
            dec = det.infer(window, l2i, td, names)
            outs.append({k: v.float().cpu().numpy() for k, v in dec.items()})
        del det
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return outs

    outs_ref = stream(model, build_coder(cfg))
    outs_fp8 = stream(model8, build_coder(cfg8))

    drift = {"d_center_m": [], "d_size_m": [], "d_yaw_rad": [],
             "d_score": [], "d_vel_ms": []}
    for a, b in zip(outs_ref, outs_fp8):
        ba, bb = a["bboxes"], b["bboxes"]
        drift["d_center_m"].append(np.abs(ba[..., :3] - bb[..., :3]))
        drift["d_size_m"].append(np.abs(ba[..., 3:6] - bb[..., 3:6]))
        dyaw = np.abs(ba[..., 6] - bb[..., 6])
        drift["d_yaw_rad"].append(np.minimum(dyaw, 2 * np.pi - dyaw))
        if ba.shape[-1] > 7:
            drift["d_vel_ms"].append(np.abs(ba[..., 7:9] - bb[..., 7:9]))
        drift["d_score"].append(np.abs(a["scores"] - b["scores"]))

    # weights-independent: level 0's features rounded to e4m3
    with torch.inference_mode():
        fp = model.forward_frame_packed(torch.from_numpy(frame0).to(dev))
    l0 = fp.tables[0].float().reshape(-1)
    q = l0.clamp(-E4M3_MAX, E4M3_MAX).to(E4M3).float()
    denom = max(float(l0.abs().mean()), 1e-12)
    report = {"metric": "fp8l0_drift", "config": os.path.basename(args.config),
              "samples": args.samples,
              "l0_feature_rel_err_mean": round(
                  float((q - l0).abs().mean()) / denom, 5),
              "l0_feature_rel_err_max": round(
                  float((q - l0).abs().max()) / denom, 5)}
    for k, vs in drift.items():
        if not vs:
            continue
        v = np.concatenate([x.reshape(-1) for x in vs])
        report[k + "_mean"] = round(float(v.mean()), 5)
        report[k + "_p99"] = round(float(np.percentile(v, 99)), 5)
        report[k + "_max"] = round(float(v.max()), 5)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
