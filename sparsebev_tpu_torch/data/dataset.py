"""nuScenes multi-sweep dataset (host-side, numpy).

Re-provides CustomNuScenesDataset + the mmdet3d base pieces it leans on
(reference loaders/nuscenes_dataset.py; the port's copy of
``sparsebev_tpu/data/dataset.py``): loads ``*_sweep.pkl`` infos
(produced by tools/gen_sweep_info.py), walks neighbouring keyframes to
collect up to +-60 sweep entries, and composes per-camera ``lidar2img``
from pose/intrinsics. Returns plain dicts consumed by the pipeline steps in
``pipelines.py``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .box3d import Boxes3D, quaternion_to_rotation_matrix

DEFAULT_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone")


class NuScenesSweepDataset:
    """Reads mmdet3d-style info pkls augmented with sweeps
    (tools/gen_sweep_info.py; reference gen_sweep_info.py:18-112)."""

    def __init__(self,
                 ann_file: str,
                 pipeline: Optional[Sequence] = None,
                 data_root: str = "",
                 classes: Sequence[str] = DEFAULT_CLASSES,
                 test_mode: bool = False,
                 use_valid_flag: bool = False,
                 with_velocity: bool = True,
                 modality: Optional[Dict] = None,
                 box_type_3d: str = "LiDAR",
                 infos: Optional[List[Dict]] = None):
        self.data_root = data_root
        self.classes = list(classes)
        self.test_mode = test_mode
        self.use_valid_flag = use_valid_flag
        self.with_velocity = with_velocity
        self.modality = modality or dict(use_camera=True)
        self.pipeline = list(pipeline or [])

        if infos is not None:
            self.data_infos = infos
        else:
            # ann_file may be a list (e.g. train+val "trainval" configs,
            # reference configs/vov99...py:95-98)
            files = ann_file if isinstance(ann_file, (list, tuple)) else [ann_file]
            infos = []
            for f in files:
                with open(f, "rb") as fh:
                    data = pickle.load(fh)
                infos.extend(data["infos"] if isinstance(data, dict) else data)
            self.data_infos = sorted(infos, key=lambda e: e["timestamp"])

        # instantiate pipeline steps from configs
        from ..registry import PIPELINES, build
        self.pipeline_fns = [
            build(dict(p), PIPELINES) if isinstance(p, dict) else p
            for p in self.pipeline
        ]

    def __len__(self):
        return len(self.data_infos)

    # -- sweeps ------------------------------------------------------------
    def collect_sweeps(self, index: int, into_past: int = 60,
                       into_future: int = 60):
        """Walk intermediate sweeps + neighbouring keyframes until enough
        history/future entries are collected (nuscenes_dataset.py:11-32)."""
        all_prev: List[Dict] = []
        curr = index
        while len(all_prev) < into_past:
            sweeps = self.data_infos[curr].get("sweeps", [])
            if len(sweeps) == 0:
                break
            all_prev.extend(sweeps)
            if curr - 1 >= 0:
                all_prev.append(self.data_infos[curr - 1]["cams"])
            curr -= 1
            if curr < 0:
                break

        all_next: List[Dict] = []
        curr = index + 1
        while len(all_next) < into_future:
            if curr >= len(self.data_infos):
                break
            sweeps = self.data_infos[curr].get("sweeps", [])
            all_next.extend(sweeps[::-1])
            all_next.append(self.data_infos[curr]["cams"])
            curr += 1

        return all_prev, all_next

    # -- per-sample record --------------------------------------------------
    def get_data_info(self, index: int) -> Dict[str, Any]:
        info = self.data_infos[index]

        e2g_r = np.asarray(info["ego2global_rotation"], dtype=np.float64)
        l2e_r = np.asarray(info["lidar2ego_rotation"], dtype=np.float64)
        if e2g_r.ndim == 1:  # quaternion in the pkl
            e2g_r = quaternion_to_rotation_matrix(e2g_r)
        if l2e_r.ndim == 1:
            l2e_r = quaternion_to_rotation_matrix(l2e_r)

        sweeps_prev, sweeps_next = self.collect_sweeps(index)
        l2e_t = np.asarray(info["lidar2ego_translation"], np.float64)
        # ego_frame: affine [3,4] mapping lidar-frame points to ego-relative
        # GLOBAL coords (p_global - ego_translation = e2g_r @ (l2e_r p + t)).
        # The devkit's class-range filter measures ||.||_xy of exactly this
        # (nuscenes eval loaders: box.ego_dist from the ego pose, not the
        # lidar origin) — consumed by evaluation/metrics.py.
        ego_frame = (e2g_r @ np.concatenate(
            [l2e_r, l2e_t[:, None]], axis=1)).astype(np.float32)
        input_dict = dict(
            sample_idx=info["token"],
            sweeps={"prev": sweeps_prev, "next": sweeps_next},
            timestamp=info["timestamp"] / 1e6,
            ego2global_translation=np.asarray(info["ego2global_translation"]),
            ego2global_rotation=e2g_r,
            lidar2ego_translation=np.asarray(info["lidar2ego_translation"]),
            lidar2ego_rotation=l2e_r,
            ego_frame=ego_frame,
        )

        if self.modality.get("use_camera", True):
            img_paths, img_timestamps, lidar2imgs = [], [], []
            for _, cam in info["cams"].items():
                path = cam["data_path"]
                if self.data_root and not os.path.isabs(path):
                    path = os.path.join(self.data_root, path)
                img_paths.append(path)
                img_timestamps.append(cam["timestamp"] / 1e6)
                # keyframe lidar2img from sensor2lidar pose + intrinsics
                # (nuscenes_dataset.py:60-76)
                s2l_r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
                s2l_t = np.asarray(cam["sensor2lidar_translation"], np.float64)
                lidar2cam_r = np.linalg.inv(s2l_r)
                lidar2cam_t = s2l_t @ lidar2cam_r.T
                rt = np.eye(4)
                rt[:3, :3] = lidar2cam_r.T
                rt[3, :3] = -lidar2cam_t
                intrinsic = np.asarray(cam["cam_intrinsic"], np.float64)
                viewpad = np.eye(4)
                viewpad[:3, :3] = intrinsic
                lidar2imgs.append((viewpad @ rt.T).astype(np.float32))
            input_dict.update(
                img_filename=img_paths,
                img_timestamp=img_timestamps,
                lidar2img=lidar2imgs,
            )

        if not self.test_mode:
            input_dict["ann_info"] = self.get_ann_info(index)
        return input_dict

    def get_ann_info(self, index: int) -> Dict[str, Any]:
        """gt boxes (bottom-center, with velocity) + integer labels; filters
        by valid_flag/num_lidar_pts like mmdet3d NuScenesDataset."""
        info = self.data_infos[index]
        if self.use_valid_flag and "valid_flag" in info:
            keep = np.asarray(info["valid_flag"], bool)
        elif "num_lidar_pts" in info:
            keep = np.asarray(info["num_lidar_pts"]) > 0
        else:
            keep = np.ones(len(info["gt_boxes"]), bool)

        boxes = np.asarray(info["gt_boxes"], np.float32)[keep]
        names = np.asarray(info["gt_names"])[keep]
        # devkit eval loads GT with num_pts = num_lidar_pts + num_radar_pts
        # and filter_eval_boxes drops num_pts == 0; plumb the counts through
        # so the evaluator can apply the same rule (evaluation/metrics.py).
        if "num_lidar_pts" in info:
            num_pts = np.asarray(info["num_lidar_pts"], np.int64)
            if "num_radar_pts" in info:
                num_pts = num_pts + np.asarray(info["num_radar_pts"], np.int64)
            num_pts = num_pts[keep]
        else:
            num_pts = None
        if self.with_velocity:
            vel = np.asarray(info.get("gt_velocity",
                                      np.zeros((len(boxes), 2))), np.float32)
            if "gt_velocity" in info:
                vel = np.asarray(info["gt_velocity"], np.float32)[keep]
            vel = np.nan_to_num(vel)
            boxes = np.concatenate([boxes, vel], axis=-1)

        labels = np.asarray(
            [self.classes.index(n) if n in self.classes else -1 for n in names],
            np.int64)
        valid = labels >= 0
        out = dict(
            gt_bboxes_3d=Boxes3D(boxes[valid], box_dim=boxes.shape[-1]),
            gt_labels_3d=labels[valid],
            gt_names=names[valid],
        )
        if num_pts is not None:
            out["gt_num_pts"] = num_pts[valid]
        return out

    # -- pipeline -----------------------------------------------------------
    def prepare_sample(self, index: int) -> Dict[str, Any]:
        results = self.get_data_info(index)
        results["img"] = []
        results.setdefault("img_timestamp", [])
        results.setdefault("filename", list(results.get("img_filename", [])))
        if "ann_info" in results:
            results["gt_bboxes_3d"] = results["ann_info"]["gt_bboxes_3d"]
            results["gt_labels_3d"] = results["ann_info"]["gt_labels_3d"]
            if "gt_num_pts" in results["ann_info"]:
                results["gt_num_pts"] = results["ann_info"]["gt_num_pts"]
        for fn in self.pipeline_fns:
            results = fn(results)
            if results is None:
                return None
        return results

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.prepare_sample(index)


DATASETS.register_module(name="CustomNuScenesDataset",
                         module=NuScenesSweepDataset)
DATASETS.register_module(name="NuScenesSweepDataset",
                         module=NuScenesSweepDataset)
