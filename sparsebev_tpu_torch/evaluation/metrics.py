"""Self-contained nuScenes detection metrics (NDS / mAP / mATE / mASE / mAOE /
mAVE / mAAE); the port's copy of ``sparsebev_tpu/evaluation/metrics.py``.

The reference delegates to nuscenes-devkit via mmdet3d's
``NuScenesDataset.evaluate`` (reference val.py:19-47); the devkit is
not installable in this environment, so this module re-implements the
devkit's detection algorithm LITERALLY (nuscenes/eval/detection/algo.py
``accumulate``/``calc_ap``/``calc_tp`` and evaluate.py's aggregation,
config ``detection_cvpr_2019``):

- class-range filtering of GT and predictions (center distance; car 50 m,
  barrier/traffic_cone 30 m, ...), max 500 boxes/sample enforced;
- per class, per center-distance threshold d in {0.5, 1, 2, 4} m: greedy
  match predictions in global score order against unmatched GT;
- precision/confidence interpolated onto a 101-point recall grid; TP-error
  curves are cumulative means interpolated on the CONFIDENCE axis;
- calc_ap: precision[11:] minus 0.1, clipped, mean / 0.9 (no monotone
  envelope — the devkit does not apply one);
- calc_tp: mean of the error curve on [11 : max_recall_ind], where
  max_recall_ind is the last grid point with nonzero confidence; 1.0 when
  the range is empty;
- TP metrics at d = 2 m; devkit skip rules (traffic_cone: no orientation /
  velocity / attribute; barrier: no velocity / attribute, orientation
  modulo pi);
- attribute errors use the mmdet3d velocity->attribute heuristic for
  predictions (results.velocity_attribute — identical to what the
  reference's submission JSON carries). GT attributes are taken from
  ``gt_attrs`` when the dataset provides them; otherwise they are
  approximated by the same heuristic on GT velocities (documented
  approximation — real nuScenes GT carries annotated attributes);
- NDS = (5*mAP + sum_tp max(0, 1 - min(1, mTP))) / 10.

Devkit filter parity: class-range distances are measured from the EGO POSE
via the per-sample ``ego_frame`` affine (lidar -> ego-relative global
coords; devkit ``box.ego_dist``), and GT with ``num_pts == 0``
(num_lidar_pts + num_radar_pts, plumbed from the info pkls) are dropped
exactly like ``filter_eval_boxes``. Remaining documented micro-deltas:
(a) the devkit's bike-rack filter (drops bicycles/motorcycles inside
bike-rack map records) needs the nuScenes DB and cannot be reproduced from
info pkls; (b) GT with 0 lidar but >0 radar points are absent from our
eval set when the dataset's training filter already removed them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .results import velocity_attribute

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
NELEM = 101  # recall samples
MAX_BOXES_PER_SAMPLE = 500

DEFAULT_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone")

# devkit detection_cvpr_2019 class_range (meters from ego)
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# devkit evaluate.py skip rules
_SKIP = {
    "traffic_cone": {"attr_err", "vel_err", "orient_err"},
    "barrier": {"attr_err", "vel_err"},
}


def _angle_diff(a, b, period):
    d = (a - b) % period
    return np.minimum(d, period - d)


def _aligned_iou3d(dims_a, dims_b):
    """IoU of two axis-aligned, center-aligned boxes given (w, l, h)
    (devkit scale_iou)."""
    inter = np.prod(np.minimum(dims_a, dims_b), axis=-1)
    union = np.prod(dims_a, axis=-1) + np.prod(dims_b, axis=-1) - inter
    return inter / np.maximum(union, 1e-9)


def _cummean(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x) / (np.arange(len(x)) + 1)


class _MetricData:
    """devkit DetectionMetricData: 101-point curves."""

    def __init__(self, precision, confidence, errors):
        self.precision = precision      # [101]
        self.confidence = confidence    # [101]
        self.errors = errors            # metric -> [101]

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls):
        return cls(np.zeros(NELEM), np.zeros(NELEM),
                   {k: np.ones(NELEM) for k in TP_METRICS})


def calc_ap(md: _MetricData, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    """devkit algo.py calc_ap (note the [round(100*min_recall)+1:] slice)."""
    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: _MetricData, metric_name: str,
            min_recall: float = MIN_RECALL) -> float:
    """devkit algo.py calc_tp."""
    first_ind = round(100 * min_recall) + 1
    last_ind = md.max_recall_ind
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md.errors[metric_name][first_ind:last_ind + 1]))


class NuScenesDetectionEvaluator:
    """Accumulates per-sample predictions + GT, computes the metric table.

    Boxes are lidar/world gravity-centered ``[x, y, z, w, l, h, yaw, vx,
    vy]``. Class-range filtering measures center distance from the ego pose
    when ``ego_frame`` is given (devkit semantics), else from the frame
    origin (see module docstring)."""

    def __init__(self, classes: Sequence[str] = DEFAULT_CLASSES,
                 filter_by_range: bool = True):
        self.classes = list(classes)
        self.filter_by_range = filter_by_range
        self.reset()

    def reset(self):
        self._preds = defaultdict(list)  # class -> [(token, score, box, attr)]
        self._gt_count = defaultdict(int)
        self._gt = {}                    # (token, class) -> (boxes, attrs)
        self._num_samples = 0

    def _in_range(self, cname: str, boxes: np.ndarray,
                  ego_frame: Optional[np.ndarray] = None) -> np.ndarray:
        if not self.filter_by_range or len(boxes) == 0:
            return np.ones(len(boxes), bool)
        r = CLASS_RANGE.get(cname, np.inf)
        centers = boxes[:, :3]
        if ego_frame is not None:
            # devkit ego_dist: ||box_global_xy - ego_pose_xy|| — ego_frame
            # is the [3,4] lidar -> ego-relative-global affine
            A = np.asarray(ego_frame, np.float64)
            centers = centers @ A[:, :3].T + A[:, 3]
        return np.linalg.norm(centers[:, :2], axis=1) <= r

    def add_sample(self,
                   pred_boxes: np.ndarray, pred_scores: np.ndarray,
                   pred_labels: np.ndarray,
                   gt_boxes: np.ndarray, gt_labels: np.ndarray,
                   pred_mask: Optional[np.ndarray] = None,
                   sample_token: Optional[str] = None,
                   pred_attrs: Optional[Sequence[str]] = None,
                   gt_attrs: Optional[Sequence[str]] = None,
                   ego_frame: Optional[np.ndarray] = None,
                   gt_num_pts: Optional[np.ndarray] = None) -> None:
        token = sample_token or f"sample_{self._num_samples}"
        self._num_samples += 1
        pred_boxes = np.asarray(pred_boxes)
        gt_boxes = np.asarray(gt_boxes)
        if gt_num_pts is not None:
            # devkit filter_eval_boxes: drop GT with zero lidar+radar points
            # (-1 marks "count unknown" — keep those)
            keep = np.asarray(gt_num_pts) != 0
            gt_boxes = gt_boxes[keep]
            gt_labels = np.asarray(gt_labels)[keep]
            if gt_attrs is not None:
                gt_attrs = [a for a, k in zip(gt_attrs, keep) if k]
        if pred_mask is None:
            pred_mask = np.ones(len(pred_boxes), bool)
        assert int(np.sum(pred_mask)) <= MAX_BOXES_PER_SAMPLE, (
            f"devkit caps submissions at {MAX_BOXES_PER_SAMPLE} boxes/sample "
            f"(got {int(np.sum(pred_mask))})")

        def _attr(source_attrs, i, cname, box):
            if source_attrs is not None:
                return source_attrs[i]
            vx, vy = (float(box[7]), float(box[8])) if box.shape[-1] > 8 \
                else (0.0, 0.0)
            return velocity_attribute(cname, vx, vy)

        for ci, cname in enumerate(self.classes):
            gsel = np.flatnonzero(np.asarray(gt_labels) == ci)
            gboxes = gt_boxes[gsel]
            keep = self._in_range(cname, gboxes, ego_frame)
            gattrs = [_attr(gt_attrs, i, cname, gt_boxes[i]) for i in gsel]
            self._gt[(token, cname)] = (
                gboxes[keep], [a for a, k in zip(gattrs, keep) if k])
            self._gt_count[cname] += int(keep.sum())

            psel = np.flatnonzero((np.asarray(pred_labels) == ci) & pred_mask)
            if len(psel) == 0:
                continue
            pboxes = pred_boxes[psel]
            keep_p = self._in_range(cname, pboxes, ego_frame)
            for j, i in enumerate(psel):
                if not keep_p[j]:
                    continue
                self._preds[cname].append(
                    (token, float(np.asarray(pred_scores)[i]), pred_boxes[i],
                     _attr(pred_attrs, i, cname, pred_boxes[i])))

    # -- devkit algo.py::accumulate -----------------------------------------
    # _accumulate_all computes all four thresholds in one pass sharing the
    # per-(token, class) pairwise distance / TP-error matrices (the greedy
    # match only ever consumes D[j] rows and per-pair error values, and
    # tokens are independent — the devkit's global score loop interleaves
    # tokens but their free-GT masks never interact). _accumulate_naive is
    # the literal devkit loop, kept as the semantics oracle
    # (tests/test_evaluation.py asserts curve equality); the shared-matrix
    # path made full-split evaluation ~8x faster (the naive path re-ran
    # norms/IoUs per threshold inside a per-prediction Python loop).
    def _accumulate_all(self, cname: str
                        ) -> Dict[float, Optional[_MetricData]]:
        npos = self._gt_count[cname]
        if npos == 0:
            return {th: None for th in DIST_THRESHOLDS}
        preds = sorted(self._preds[cname], key=lambda r: -r[1])
        n = len(preds)
        if n == 0:
            return {th: _MetricData.no_predictions()
                    for th in DIST_THRESHOLDS}

        period = np.pi if cname == "barrier" else 2 * np.pi
        conf = np.asarray([p[1] for p in preds], np.float64)

        # group prediction indices by token (global sort is stable, so
        # within-token order == the naive loop's visitation order)
        groups: Dict[str, List[int]] = {}
        for j, (token, _, _, _) in enumerate(preds):
            groups.setdefault(token, []).append(j)

        # per-token precompute, shared by every threshold
        tok_data = []
        for token, idxs in groups.items():
            gts, gattrs = self._gt.get((token, cname), (np.zeros((0, 9)), []))
            ng = len(gts)
            if ng == 0:
                tok_data.append((idxs, None))
                continue
            pbox = np.stack([preds[j][2] for j in idxs])
            D = np.linalg.norm(pbox[:, None, :2] - gts[None, :, :2], axis=-1)
            errs = {
                "trans_err": D,
                "scale_err": 1.0 - _aligned_iou3d(pbox[:, None, 3:6],
                                                  gts[None, :, 3:6]),
                "orient_err": _angle_diff(pbox[:, None, 6], gts[None, :, 6],
                                          period),
                "vel_err": (np.linalg.norm(
                    pbox[:, None, 7:9] - gts[None, :, 7:9], axis=-1)
                    if pbox.shape[-1] > 8 and gts.shape[-1] > 8
                    else np.zeros_like(D)),
                "attr_err": np.asarray(
                    [[float(preds[j][3] != ga) for ga in gattrs]
                     for j in idxs]),
            }
            # predictions whose nearest GT is beyond every threshold can
            # never match at any mask state — skip them in the greedy loop
            rowmin = D.min(axis=1)
            tok_data.append((idxs, (D, errs, rowmin, ng)))

        out = {}
        for dist_th in DIST_THRESHOLDS:
            tp = np.zeros(n, np.float64)
            match_err = {k: np.zeros(n) for k in TP_METRICS}
            for idxs, data in tok_data:
                if data is None:
                    continue
                D, errs, rowmin, ng = data
                free = np.ones(ng, bool)
                for r, j in enumerate(idxs):
                    if rowmin[r] >= dist_th or not free.any():
                        continue
                    d = np.where(free, D[r], np.inf)
                    gi = int(np.argmin(d))
                    if d[gi] < dist_th:
                        free[gi] = False
                        tp[j] = 1.0
                        for k in TP_METRICS:
                            match_err[k][j] = errs[k][r, gi]

            if not tp.any():
                out[dist_th] = _MetricData.no_predictions()
                continue
            m = tp.astype(bool)
            out[dist_th] = self._finalize(
                tp, 1.0 - tp, conf, npos,
                {k: match_err[k][m] for k in TP_METRICS}, conf[m])
        return out

    @staticmethod
    def _finalize(tp, fp, conf, npos, match, match_conf) -> _MetricData:
        """Shared curve construction (devkit accumulate tail)."""
        tp = np.cumsum(tp).astype(np.float64)
        fp = np.cumsum(fp).astype(np.float64)
        prec = tp / (fp + tp)
        rec = tp / float(npos)

        rec_interp = np.linspace(0, 1, NELEM)
        prec_i = np.interp(rec_interp, rec, prec, right=0)
        conf_i = np.interp(rec_interp, rec, conf, right=0)

        errors = {}
        mc = np.asarray(match_conf)[::-1]  # ascending confidence
        for key in TP_METRICS:
            tmp = _cummean(np.asarray(match[key], np.float64))[::-1]
            errors[key] = np.interp(conf_i[::-1], mc, tmp)[::-1]
        return _MetricData(prec_i, conf_i, errors)

    def _accumulate_naive(self, cname: str,
                          dist_th: float) -> Optional[_MetricData]:
        npos = self._gt_count[cname]
        if npos == 0:
            return None
        preds = sorted(self._preds[cname], key=lambda r: -r[1])
        if len(preds) == 0:
            return _MetricData.no_predictions()

        period = np.pi if cname == "barrier" else 2 * np.pi
        tp, fp, conf = [], [], []
        match = {k: [] for k in TP_METRICS}
        match_conf = []
        free = {}  # token -> bool mask of unmatched gts

        for token, score, box, attr in preds:
            gts, gattrs = self._gt.get((token, cname), (np.zeros((0, 9)), []))
            if token not in free:
                free[token] = np.ones(len(gts), bool)
            mask = free[token]
            best = None
            if mask.any():
                d = np.linalg.norm(gts[:, :2] - box[:2], axis=1)
                d = np.where(mask, d, np.inf)
                gi = int(np.argmin(d))
                if d[gi] < dist_th:
                    best = gi
            if best is None:
                tp.append(0)
                fp.append(1)
                conf.append(score)
                continue
            free[token][best] = False
            tp.append(1)
            fp.append(0)
            conf.append(score)
            g = gts[best]
            match["trans_err"].append(float(np.linalg.norm(box[:2] - g[:2])))
            match["scale_err"].append(
                1.0 - float(_aligned_iou3d(box[3:6], g[3:6])))
            match["orient_err"].append(
                float(_angle_diff(box[6], g[6], period)))
            if box.shape[-1] > 8 and g.shape[-1] > 8:
                match["vel_err"].append(
                    float(np.linalg.norm(box[7:9] - g[7:9])))
            else:
                match["vel_err"].append(0.0)
            match["attr_err"].append(float(attr != gattrs[best]))
            match_conf.append(score)

        if len(match["trans_err"]) == 0:
            return _MetricData.no_predictions()
        return self._finalize(np.asarray(tp), np.asarray(fp),
                              np.asarray(conf), npos, match,
                              np.asarray(match_conf))

    def evaluate(self) -> Dict[str, float]:
        per_class_ap: Dict[str, float] = {}
        tp_names = {"trans_err": "mATE", "scale_err": "mASE",
                    "orient_err": "mAOE", "vel_err": "mAVE",
                    "attr_err": "mAAE"}
        tp_vals: Dict[str, List[float]] = {k: [] for k in tp_names}

        for cname in self.classes:
            mds = self._accumulate_all(cname)
            aps = [0.0 if mds[d] is None else calc_ap(mds[d])
                   for d in DIST_THRESHOLDS]
            per_class_ap[cname] = float(np.mean(aps))
            md_tp = mds[TP_THRESHOLD]
            if md_tp is None:
                continue
            for key in tp_names:
                if key in _SKIP.get(cname, ()):
                    continue
                tp_vals[key].append(calc_tp(md_tp, key))

        mean_ap = float(np.mean(list(per_class_ap.values())))
        out = {"mAP": mean_ap}
        tp_scores = []
        for key, name in tp_names.items():
            v = float(np.mean(tp_vals[key])) if tp_vals[key] else 1.0
            out[name] = v
            tp_scores.append(max(0.0, 1.0 - min(1.0, v)))
        out["NDS"] = float((5 * mean_ap + sum(tp_scores)) / 10.0)
        for cname, ap in per_class_ap.items():
            out[f"AP_{cname}"] = ap
        return out
