"""NMS-free top-k box decoding (counterpart of
``sparsebev_tpu/bbox/nms_free_coder.py``): always ``max_num`` boxes per
sample plus a validity mask (score threshold and post-center range)."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..ops.box_ops import denormalize_bbox
from ..utils.version import VERSION


class NMSFreeCoder:
    def __init__(self, pc_range: Sequence[float],
                 voxel_size: Optional[Sequence[float]] = None,
                 post_center_range: Optional[Sequence[float]] = None,
                 max_num: int = 100,
                 score_threshold: Optional[float] = None,
                 num_classes: int = 10):
        self.pc_range = pc_range
        self.voxel_size = voxel_size
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.num_classes = num_classes

    def decode_single(self, cls_scores: torch.Tensor,
                      bbox_preds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """cls_scores [Q, C] logits; bbox_preds [Q, 10] normalized layout.
        Returns bboxes [max_num, 9] (world layout), scores, labels and a
        validity ``mask``."""
        scores = torch.sigmoid(cls_scores.float()).reshape(-1)
        k = min(self.max_num, scores.shape[0])
        top_scores, idx = torch.topk(scores, k)
        labels = idx % self.num_classes
        bbox_index = torch.div(idx, self.num_classes, rounding_mode="floor")
        boxes = denormalize_bbox(bbox_preds[bbox_index])
        if VERSION.name == "v0.17.1":
            # old checkpoints store dims as (l, w) and yaw flipped
            boxes = torch.cat([
                boxes[:, :3], boxes[:, 4:5], boxes[:, 3:4], boxes[:, 5:6],
                -boxes[:, 6:7] - math.pi / 2, boxes[:, 7:]], dim=-1)
        mask = torch.ones_like(top_scores, dtype=torch.bool)
        if self.score_threshold is not None:
            mask &= top_scores > self.score_threshold
        if self.post_center_range is not None:
            limit = torch.tensor(self.post_center_range, dtype=boxes.dtype,
                                 device=boxes.device)
            mask &= (boxes[:, :3] >= limit[:3]).all(-1)
            mask &= (boxes[:, :3] <= limit[3:]).all(-1)
        return {"bboxes": boxes, "scores": top_scores, "labels": labels,
                "mask": mask}

    def decode(self, preds_dicts: Dict[str, torch.Tensor]):
        """Decode the LAST decoder layer for every sample in the batch."""
        cls = preds_dicts["all_cls_scores"][-1]   # [B, Q, C]
        box = preds_dicts["all_bbox_preds"][-1]   # [B, Q, 10]
        outs = [self.decode_single(c, b) for c, b in zip(cls, box)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def build_coder(cfg) -> Optional[NMSFreeCoder]:
    """The coder of a config's ``model.pts_bbox_head.bbox_coder`` (or None)."""
    model_cfg = cfg["model"] if "model" in cfg else cfg
    coder_cfg = model_cfg["pts_bbox_head"].get("bbox_coder")
    if coder_cfg is None:
        return None
    coder_cfg = dict(coder_cfg)
    if coder_cfg.pop("type", "NMSFreeCoder") != "NMSFreeCoder":
        raise NotImplementedError(coder_cfg)
    return NMSFreeCoder(**coder_cfg)
