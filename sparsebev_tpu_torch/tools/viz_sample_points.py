"""Visualize the decoder's adaptive sampling points over frames x views (the
port's counterpart of the repository's ``tools/viz_sample_points.py``, the
reference's viz_sample_points.py:82-147).

    python -m sparsebev_tpu_torch.tools.viz_sample_points --config CONFIG \\
        [--weights CKPT] [--sample 0] [--stage 5] \\
        [--out-dir outputs/viz_points] [--override ...] [--device cuda|cpu]

One val sample runs the full forward with ``DUMP`` enabled
(``utils/dump.py``); the stage's camera-space points, valid masks and class
scores are read back from the dumps, and the points of the query with the
highest score are scattered on each camera image of each frame
(``sample_points_stage<k>.png`` in the dump directory). Without
``--weights`` the model is seeded (``models/detector.py::random_init_``).
matplotlib (Agg backend) is imported when the tool runs. CUDA unless
``--device cpu``. ``main(argv)`` returns the PNG's path.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--sample", type=int, default=0)
    parser.add_argument("--stage", type=int, default=5)
    parser.add_argument("--out-dir", default="outputs/viz_points")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--override", nargs="+", default=None)
    return parser.parse_args(argv)


def load_sample(cfg, index: int, device):
    """Val sample ``index`` of ``cfg`` collated as a batch of one: the host
    batch and its ``img``, ``lidar2img``, ``time_diff`` on ``device``."""
    import torch

    from ..builder import build_dataset
    from ..data.loader import collate_batch

    dataset = build_dataset(cfg.data["val"])
    batch = collate_batch([dataset[index]], max_gt=cfg.get("max_gt", 64))
    return batch, [torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                   for k in ("img", "lidar2img", "time_diff")]


def load_model(cfg, weights, device):
    """The detector of ``cfg`` on ``device``: seeded, or ``weights`` (a
    checkpoint of the training loop or a reference ``.pth``)."""
    from ..models.detector import build_detector
    from ..utils.checkpoint_io import load_weights

    model = build_detector(cfg, device=device, seed=0)
    if weights:
        load_weights(model, weights,
                     revise_keys=cfg.get("revise_keys") or [])
    return model


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ..utils.device import resolve_device
    from ..utils.dump import DUMP
    from .train import load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.override)
    batch, (img, l2i, td) = load_sample(cfg, args.sample, device)
    model = load_model(cfg, args.weights, device)

    out_dir = DUMP.enable(args.out_dir)
    try:
        with torch.inference_mode():
            model(img, l2i, td, train=False)
    finally:
        DUMP.enabled = False
    print(f"dumps written to {out_dir}")

    # camera-space points: [B, T, Q, GP, 3]; valid: [B, T, Q, GP]
    loc = DUMP.load("sample_points_cam", args.stage)
    valid = DUMP.load("sample_points_cam_valid_mask", args.stage)
    scores = DUMP.load("cls_score", args.stage)  # [B, Q, num_classes]
    q_best = int(scores[0].max(-1).argmax())

    t = loc.shape[1]
    n = 6
    imgs = np.asarray(batch["img"]).reshape(1, t, n, *batch["img"].shape[2:])
    fig, axes = plt.subplots(t, n, figsize=(3 * n, 2 * t), squeeze=False)
    h, w = imgs.shape[3], imgs.shape[4]
    for ti in range(t):
        for vi in range(n):
            ax = axes[ti][vi]
            ax.imshow(imgs[0, ti, vi][..., ::-1].astype(np.uint8))
            pts = loc[0, ti, q_best]        # [GP, 3]
            msk = valid[0, ti, q_best] > 0.5
            view_idx = np.round(pts[:, 2] * (n - 1)).astype(int)
            sel = msk & (view_idx == vi)
            ax.scatter(pts[sel, 0] * w, pts[sel, 1] * h, s=12, c="red")
            ax.set_xticks([])
            ax.set_yticks([])
            if ti == 0:
                ax.set_title(f"view {vi}", fontsize=8)
    fig.suptitle(f"stage {args.stage}, query {q_best} sampling points")
    out_png = os.path.join(out_dir, f"sample_points_stage{args.stage}.png")
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {out_png}")
    return out_png


if __name__ == "__main__":
    main()
