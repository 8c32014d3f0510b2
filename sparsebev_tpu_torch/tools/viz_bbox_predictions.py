"""Render predicted 3D boxes on the 6 camera views and a BEV plot (the
port's counterpart of the repository's ``tools/viz_bbox_predictions.py``,
the reference's viz_bbox_predictions.py:38-147 without nuscenes-devkit:
box corners projected through each view's lidar2img).

    python -m sparsebev_tpu_torch.tools.viz_bbox_predictions \\
        --config CONFIG [--weights CKPT] [--sample 0] [--score-thresh 0.3] \\
        [--out-dir outputs/viz_bbox] [--override ...] [--device cuda|cpu]

Writes ``cams_<sample>.png`` (the boxes above the threshold on the six
views of the current frame) and ``bev_<sample>.png`` (the boxes from
above, the ground truth outlined where the split carries it). Without
``--weights`` the model is seeded. matplotlib (Agg backend) is imported
when the tool runs. CUDA unless ``--device cpu``. ``main(argv)`` returns
the two PNG paths.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

# box corner topology: 4 bottom, 4 top, verticals
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]

CLASS_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red",
                "tab:purple", "tab:brown", "tab:pink", "tab:gray",
                "tab:olive", "tab:cyan"]


def box_corners(box):
    """[x, y, z(gravity), w, l, h, yaw, ...] -> [8, 3] corners."""
    x, y, z, w, l, h, yaw = box[:7]
    dx, dy, dz = w / 2, l / 2, h / 2
    corners = np.array([
        [dx, dy, -dz], [dx, -dy, -dz], [-dx, -dy, -dz], [-dx, dy, -dz],
        [dx, dy, dz], [dx, -dy, dz], [-dx, -dy, dz], [-dx, dy, dz]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot_t = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    return corners @ rot_t + np.array([x, y, z])


def draw_box_on_view(ax, box, l2i, img_hw, color):
    """The box's edges projected through ``l2i`` [4, 4] onto ``ax``; edges
    with a corner behind the camera are skipped."""
    corners = box_corners(box)
    homo = np.concatenate([corners, np.ones((8, 1))], -1) @ l2i.T  # [8, 4]
    z = homo[:, 2]
    if (z < 0.1).all():
        return
    uv = homo[:, :2] / np.maximum(z[:, None], 0.1)
    for a, b in _EDGES:
        if z[a] < 0.1 or z[b] < 0.1:
            continue
        ax.plot([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]],
                color=color, linewidth=0.8)


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--sample", type=int, default=0)
    parser.add_argument("--score-thresh", type=float, default=0.3)
    parser.add_argument("--out-dir", default="outputs/viz_bbox")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--override", nargs="+", default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ..bbox.nms_free_coder import build_coder
    from ..evaluation.loop import decoded_to_host
    from ..utils.device import resolve_device
    from .train import load_config
    from .viz_sample_points import load_model, load_sample

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.override)
    batch, (img, l2i, td) = load_sample(cfg, args.sample, device)
    model = load_model(cfg, args.weights, device)
    coder = build_coder(cfg)
    l2i_all = np.asarray(batch["lidar2img"])[0]

    with torch.inference_mode():
        dec = decoded_to_host(coder.decode(model(img, l2i, td, train=False)))
    boxes = dec["bboxes"][0]
    scores = dec["scores"][0]
    labels = dec["labels"][0]
    keep = dec["mask"][0] & (scores > args.score_thresh)
    print(f"{keep.sum()} boxes above {args.score_thresh}")

    os.makedirs(args.out_dir, exist_ok=True)
    imgs = np.asarray(batch["img"])[0]  # [T*6, H, W, 3]
    h, w = imgs.shape[1:3]
    fig, axes = plt.subplots(2, 3, figsize=(15, 6))
    order = [2, 0, 1, 4, 3, 5]  # FL, F, FR / BL, B, BR visual layout
    for plot_i, view_i in enumerate(order):
        ax = axes[plot_i // 3][plot_i % 3]
        ax.imshow(imgs[view_i][..., ::-1].astype(np.uint8))
        for b, l in zip(boxes[keep], labels[keep]):
            draw_box_on_view(ax, b, l2i_all[view_i], (h, w),
                             CLASS_COLORS[int(l) % 10])
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
        ax.set_xticks([])
        ax.set_yticks([])
    out_png = os.path.join(args.out_dir, f"cams_{args.sample}.png")
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)

    # BEV plot: predictions + (if available) ground truth
    fig2, ax = plt.subplots(figsize=(8, 8))
    for b, l in zip(boxes[keep], labels[keep]):
        cs = box_corners(b)[:4, :2]
        ax.fill(cs[:, 0], cs[:, 1], alpha=0.4,
                color=CLASS_COLORS[int(l) % 10])
    if "gt_boxes" in batch:
        for g, m in zip(batch["gt_boxes"][0], batch["gt_mask"][0]):
            if not m:
                continue
            cs = box_corners(g)[:4, :2]
            ax.plot(np.append(cs[:, 0], cs[0, 0]),
                    np.append(cs[:, 1], cs[0, 1]), "k-", linewidth=0.6)
    ax.set_xlim(-55, 55)
    ax.set_ylim(-55, 55)
    ax.set_aspect("equal")
    ax.set_title("BEV: predictions (filled) vs GT (outline)")
    out_bev = os.path.join(args.out_dir, f"bev_{args.sample}.png")
    fig2.savefig(out_bev, dpi=120, bbox_inches="tight")
    plt.close(fig2)
    print(f"saved {out_png} and {out_bev}")
    return out_png, out_bev


if __name__ == "__main__":
    main()
