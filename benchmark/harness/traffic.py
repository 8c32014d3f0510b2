"""The one generator of the benchmark's traffic: every mix is a data file
under ``benchmark/traffic/`` whose parameters this module reads.

Geometry: six outward-facing cameras on a ring (the rig of the port's
``data/synthetic.py::_ring_camera``, copied), carried by a vehicle that
drives at a seeded speed with a seeded, slowly varying yaw rate. Frame
``j`` is taken at ``j * frame_interval_s``; a sample that ends at frame
``i`` sees frames ``i, i-1, ..., i-T+1`` (repeating frame 0 before the
stream's start, as the loader pads history) through
``lidar2img = K @ inv(cam2ego) @ inv(ego_j) @ ego_i``, with ``time_diff``
the seconds from frame j to frame i. So the sampling points land in the
images as they do on nuScenes, and the velocity warp moves them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

NUM_VIEWS = 6


def ring_camera(i: int, image_hw: Tuple[int, int]):
    """Camera ``i`` of six on a ring: ``(cam2ego [4, 4], intrinsic [4, 4])``
    (copied from ``sparsebev_tpu_torch/data/synthetic.py::_ring_camera``)."""
    h, w = image_hw
    yaw = 2 * np.pi * i / 6
    cy, sy = np.cos(yaw), np.sin(yaw)
    r_cam2ego = np.stack([
        np.array([-sy, cy, 0.0]),   # x
        np.array([0.0, 0.0, -1.0]),  # y
        np.array([cy, sy, 0.0]),    # z
    ], axis=1)
    cam2ego = np.eye(4)
    cam2ego[:3, :3] = r_cam2ego
    cam2ego[:3, 3] = np.array([cy, sy, 1.5])
    k = np.eye(4)
    k[0, 0] = k[1, 1] = w * 0.8
    k[0, 2], k[1, 2] = w / 2, h / 2
    return cam2ego, k


def rig(image_hw) -> np.ndarray:
    """``img <- ego`` of the six cameras: ``[6, 4, 4]``."""
    return np.stack([k @ np.linalg.inv(c2e)
                     for c2e, k in (ring_camera(v, image_hw)
                                    for v in range(NUM_VIEWS))])


def ego_poses(rng, n: int, params: dict) -> np.ndarray:
    """``ego -> world`` of frames 0..n-1: ``[n, 4, 4]``."""
    dt = params["frame_interval_s"]
    speed = rng.uniform(*params["speed_mps"])
    amp = rng.uniform(*params["yaw_rate_rps"])
    period = params["yaw_period_s"]
    phase = rng.uniform(0, 2 * math.pi)
    t = np.arange(n) * dt
    yaw = amp * period / (2 * math.pi) * np.sin(2 * math.pi * t / period
                                                + phase)
    step = np.stack([np.cos(yaw), np.sin(yaw)], -1) * speed * dt
    xy = np.concatenate([np.zeros((1, 2)), np.cumsum(step[:-1], 0)])
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 0] = np.cos(yaw)
    poses[:, 0, 1] = -np.sin(yaw)
    poses[:, 1, 0] = np.sin(yaw)
    poses[:, 1, 1] = np.cos(yaw)
    poses[:, :2, 3] = xy
    return poses


def window_frames(i: int, num_frames: int) -> List[int]:
    """The frames a sample ending at frame ``i`` sees, newest first."""
    return [max(i - k, 0) for k in range(num_frames)]


def window_geometry(cams, poses, i: int, num_frames: int, dt: float):
    """``lidar2img [1, T*6, 4, 4]`` and ``time_diff [1, T]`` (float32) of
    the sample ending at frame ``i``."""
    frames = window_frames(i, num_frames)
    inv = np.linalg.inv(poses[frames])                   # [T, 4, 4]
    rel = inv @ poses[i]                                 # ego_i -> ego_j
    l2i = cams[None] @ rel[:, None]                      # [T, 6, 4, 4]
    td = (i - np.asarray(frames, np.float64)) * dt
    return (l2i.reshape(1, num_frames * NUM_VIEWS, 4, 4).astype(np.float32),
            td[None].astype(np.float32))


def frame_names(i: int, num_frames: int) -> List[str]:
    """Per-view names of the sample's frames: each frame is a new ring key
    (the streaming detector keys a frame by its first view's name)."""
    return [f"/stream/frame{j:07d}/CAM{v}"
            for j in window_frames(i, num_frames) for v in range(NUM_VIEWS)]


def device_images(torch, gen, device, shape, dtype):
    """Raw BGR pixels in [0, 255], drawn on the card: uint8 or float32."""
    if dtype == "uint8":
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8)
    return torch.rand(shape, generator=gen, device=device) * 255.0


class Stream:
    """One vehicle's closed-loop stream: sample ``i`` brings the pixels of
    frame ``i`` (a host array from a seeded pool of ``pool_frames``) and
    sees the T-1 frames before it through the ring."""

    def __init__(self, torch, device, cfg: dict, params: dict, seed: int,
                 max_samples: int):
        head = cfg["model"]["pts_bbox_head"]
        self.num_frames = head["num_frames"]
        self.image_hw = tuple(cfg["ida_aug_conf"]["final_dim"])
        self.dt = params["frame_interval_s"]
        rng = np.random.default_rng([seed, 1])
        self.cams = rig(self.image_hw)
        self.poses = ego_poses(rng, max_samples, params)
        self.max_samples = max_samples
        gen = torch.Generator(device=device).manual_seed(
            (seed * 2 + 1) % (1 << 63))
        h, w = self.image_hw
        self.pool = [
            device_images(torch, gen, device, (1, NUM_VIEWS, h, w, 3),
                          params["pixels"]).cpu().numpy()
            for _ in range(params["pool_frames"])]

    def pixels(self, j: int) -> np.ndarray:
        return self.pool[j % len(self.pool)]

    def sample(self, i: int):
        """``infer``'s arguments for the sample ending at frame ``i``."""
        l2i, td = window_geometry(self.cams, self.poses, i, self.num_frames,
                                  self.dt)
        return self.pixels(i), l2i, td, frame_names(i, self.num_frames)


def gt_boxes(rng, cfg: dict, count: int):
    """``count`` seeded boxes inside the point-cloud range, padded to
    ``max_gt``: ``(boxes [1, M, 9], labels [1, M] int32, mask [1, M])``."""
    head = cfg["model"]["pts_bbox_head"]
    pc = head["pc_range"]
    m = cfg["max_gt"]
    boxes = np.concatenate([
        rng.uniform(pc[0] * 0.9, pc[3] * 0.9, (1, m, 1)),
        rng.uniform(pc[1] * 0.9, pc[4] * 0.9, (1, m, 1)),
        rng.uniform(pc[2] * 0.6, pc[5] * 0.6, (1, m, 1)),
        rng.uniform(0.5, 5.0, (1, m, 3)),
        rng.uniform(-np.pi, np.pi, (1, m, 1)),
        rng.uniform(-3.0, 3.0, (1, m, 2))], -1).astype(np.float32)
    mask = np.zeros((1, m), bool)
    mask[:, :count] = True
    boxes[~mask] = 0.0
    labels = rng.integers(0, head["num_classes"], (1, m)).astype(np.int32)
    return boxes, labels, mask


def train_pool(torch, device, cfg: dict, params: dict,
               seed: int) -> List[Dict[str, np.ndarray]]:
    """``pool_batches`` seeded host batches of ``batch`` samples, each with
    all T frames of six views, the cameras along a drive and ``gt_boxes``
    boxes: the numpy arrays a loader yields."""
    head = cfg["model"]["pts_bbox_head"]
    t = head["num_frames"]
    image_hw = tuple(cfg["ida_aug_conf"]["final_dim"])
    dt = params["frame_interval_s"]
    rng = np.random.default_rng([seed, 2])
    gen = torch.Generator(device=device).manual_seed(
        (seed * 2 + 1) % (1 << 63))
    cams = rig(image_hw)
    h, w = image_hw
    out = []
    for _ in range(params["pool_batches"]):
        b = params["batch"]
        poses = ego_poses(rng, t, params)
        geo = [window_geometry(cams, poses, t - 1, t, dt) for _ in range(b)]
        boxes = [gt_boxes(rng, cfg, params["gt_boxes"]) for _ in range(b)]
        out.append(dict(
            img=device_images(torch, gen, device, (b, t * NUM_VIEWS, h, w, 3),
                              params["pixels"]).cpu().numpy(),
            lidar2img=np.concatenate([g[0] for g in geo]),
            time_diff=np.concatenate([g[1] for g in geo]),
            gt_boxes=np.concatenate([x[0] for x in boxes]),
            gt_labels=np.concatenate([x[1] for x in boxes]),
            gt_mask=np.concatenate([x[2] for x in boxes])))
    return out
