"""nuScenes submission formatting: decoded predictions -> the devkit's
results JSON schema (what mmdet3d's ``format_results`` produces for the
leaderboard; reference val.py relies on dataset.evaluate / format_results).
The port's copy of ``sparsebev_tpu/evaluation/results.py``."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

# mmdet3d NuScenesDataset.DefaultAttribute (what _format_bbox falls back to
# when the velocity heuristic doesn't override it)
DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked", "bicycle": "cycle.without_rider",
    "barrier": "", "traffic_cone": "",
}
_MOVING_VEHICLES = {"car", "construction_vehicle", "bus", "truck", "trailer"}
_CYCLES = {"bicycle", "motorcycle"}


def velocity_attribute(name: str, vx: float, vy: float,
                       vel_thresh: float = 0.2) -> str:
    """mmdet3d's velocity->attribute heuristic (_format_bbox): what the
    reference writes into the submission JSON that devkit NDS scores."""
    speed = float(np.hypot(vx, vy))
    if speed > vel_thresh:
        if name in _MOVING_VEHICLES:
            return "vehicle.moving"
        if name in _CYCLES:
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTES.get(name, "")
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTES.get(name, "")


def _yaw_to_quaternion(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def format_nusc_submission(results_per_sample: Dict[str, Dict],
                           classes: Sequence[str],
                           out_path: Optional[str] = None,
                           vel_thresh: float = 0.2) -> Dict:
    """results_per_sample: token -> dict(bboxes [K,9] world gravity-centered,
    scores [K], labels [K], mask [K]). Attribute assignment follows mmdet3d's
    velocity heuristic."""
    submission = {
        "meta": {
            "use_camera": True, "use_lidar": False, "use_radar": False,
            "use_map": False, "use_external": True,
        },
        "results": {},
    }
    for token, res in results_per_sample.items():
        entries = []
        boxes = np.asarray(res["bboxes"])
        scores = np.asarray(res["scores"])
        labels = np.asarray(res["labels"])
        mask = np.asarray(res.get("mask", np.ones(len(boxes), bool)))
        for b, s, l, m in zip(boxes, scores, labels, mask):
            if not m:
                continue
            name = classes[int(l)]
            vx, vy = (float(b[7]), float(b[8])) if len(b) > 8 else (0.0, 0.0)
            attr = velocity_attribute(name, vx, vy, vel_thresh)
            entries.append({
                "sample_token": token,
                "translation": [float(x) for x in b[:3]],
                "size": [float(x) for x in b[3:6]],
                "rotation": _yaw_to_quaternion(float(b[6])),
                "velocity": [float(x) for x in b[7:9]] if len(b) > 8 else [0, 0],
                "detection_name": name,
                "detection_score": float(s),
                "attribute_name": attr,
            })
        submission["results"][token] = entries

    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(submission, f)
    return submission
