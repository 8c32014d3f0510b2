"""Synthetic nuScenes-format mini dataset: random images + known geometry,
for pipeline/shape/integration tests without the real data (the port's
copy of ``sparsebev_tpu/data/synthetic.py``: with the same seed it writes
the same infos and the same JPEG bytes). Produces the same ``*_sweep.pkl``
info schema the real ``tools/gen_sweep_info.py`` emits.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

CAM_TYPES = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
]
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
           "motorcycle", "bicycle", "pedestrian", "traffic_cone")


def _ring_camera(i: int, image_hw: Tuple[int, int], rng) -> Dict:
    h, w = image_hw
    yaw = 2 * np.pi * i / 6
    cy, sy = np.cos(yaw), np.sin(yaw)
    # camera axes in the ego/world frame: z forward, x right, y down
    r_cam2world = np.stack([
        np.array([-sy, cy, 0.0]),   # x
        np.array([0.0, 0.0, -1.0]),  # y
        np.array([cy, sy, 0.0]),    # z
    ], axis=1)
    t = np.array([cy, sy, 1.5]) * 1.0
    intrinsic = np.array([[w * 0.8, 0, w / 2],
                          [0, w * 0.8, h / 2],
                          [0, 0, 1.0]])
    return dict(rotation=r_cam2world, translation=t, intrinsic=intrinsic)


def _write_jpeg(path: str, hw: Tuple[int, int], rng) -> None:
    from PIL import Image
    h, w = hw
    arr = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path, quality=70)


def make_synthetic_dataset(root: str,
                           num_samples: int = 4,
                           sweeps_between: int = 2,
                           image_hw: Tuple[int, int] = (64, 128),
                           max_objects: int = 6,
                           seed: int = 0) -> str:
    """Writes JPEGs + an infos pkl under ``root``; returns the pkl path."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    cams_geom = [_ring_camera(i, image_hw, rng) for i in range(6)]

    def cam_entry(sample_i, frame_tag, ts, ego_xy):
        cams = {}
        for ci, name in enumerate(CAM_TYPES):
            g = cams_geom[ci]
            path = os.path.join(root, "imgs", f"{frame_tag}_{name}.jpg")
            if not os.path.exists(path):
                _write_jpeg(path, image_hw, rng)
            s2l_r = g["rotation"]                 # sensor->lidar (~ego)
            s2l_t = g["translation"]
            s2g_r = g["rotation"]                 # global ~= ego (identity pose + xy shift)
            s2g_t = g["translation"] + np.array([ego_xy[0], ego_xy[1], 0.0])
            cams[name] = dict(
                data_path=path,
                timestamp=ts * 1e6,
                cam_intrinsic=g["intrinsic"],
                sensor2lidar_rotation=s2l_r,
                sensor2lidar_translation=s2l_t,
                sensor2global_rotation=s2g_r,
                sensor2global_translation=s2g_t,
            )
        return cams

    infos: List[Dict] = []
    for i in range(num_samples):
        ts = i * 0.5
        ego_xy = (i * 2.0, 0.0)
        # scene-start keyframes carry NO sweeps, like gen_sweep_info (the
        # reference only adds sweeps when sample['prev'] != '',
        # gen_sweep_info.py:67) — load_online's cache-hit invariant
        # depends on this shape
        sweeps = []
        if i > 0:
            for k in range(sweeps_between):
                sts = ts - 0.5 * (k + 1) / (sweeps_between + 1)
                sweeps.append(cam_entry(i, f"s{i}_{k}", sts,
                                        (ego_xy[0] - (k + 1) * 0.5, 0.0)))
        n_obj = rng.randint(1, max_objects + 1)
        gt_boxes = np.concatenate([
            rng.uniform(-30, 30, (n_obj, 2)),
            rng.uniform(-2, 0, (n_obj, 1)),      # z bottom
            rng.uniform(0.5, 4.0, (n_obj, 3)),   # w l h
            rng.uniform(-np.pi, np.pi, (n_obj, 1)),
        ], -1).astype(np.float32)
        infos.append(dict(
            token=f"sample_{i}",
            timestamp=ts * 1e6,
            cams=cam_entry(i, f"k{i}", ts, ego_xy),
            sweeps=sweeps,
            ego2global_translation=np.array([ego_xy[0], ego_xy[1], 0.0]),
            ego2global_rotation=np.eye(3),
            lidar2ego_translation=np.zeros(3),
            lidar2ego_rotation=np.eye(3),
            gt_boxes=gt_boxes,
            gt_names=np.asarray([CLASSES[rng.randint(0, len(CLASSES))]
                                 for _ in range(n_obj)]),
            gt_velocity=rng.uniform(-2, 2, (n_obj, 2)).astype(np.float32),
            valid_flag=np.ones(n_obj, bool),
            num_lidar_pts=np.full(n_obj, 10),
        ))

    ann_file = os.path.join(root, "synthetic_infos_sweep.pkl")
    with open(ann_file, "wb") as f:
        pickle.dump(dict(infos=infos, metadata=dict(version="synthetic")), f)
    return ann_file
