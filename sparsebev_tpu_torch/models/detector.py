"""SparseBEV detector (counterpart of ``sparsebev_tpu/models/detector.py``):
on-device augmentation (training) -> normalize -> pad -> ResNet or VoVNet ->
FPN -> head. Two ways in: the full forward over all T frames
(:meth:`SparseBEV.forward`, training and offline evaluation; the head packs
the pyramids once for its decoder layers), and the streaming unit of work,
the grouped pack of one frame (y-fold or pair rows per level, the head's
``table_yfold``) with the head over the packed ring.

Images keep the JAX package's channel-last layout ``[B, T*N, H, W, 3]`` (raw
BGR) at the public functions; the backbone runs in channels_last memory, so
its NCHW outputs are NHWC-contiguous views and the pack reads them directly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msmv_sampling import pack_mlvl_feats_grouped
from .augment import (draw_grid_mask, draw_photometric, grid_mask,
                      photometric_distortion)
from ..utils.device import resolve_device
from .fpn import FPN
from .head import SparseBEVHead
from .resnet import ResNet
from .vovnet import VoVNet

_BACKBONES = {"ResNet": ResNet, "VoVNet": VoVNet}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# head-config keys that parametrize training / decoding, not the module
_HEAD_AUX_KEYS = ("bbox_coder", "code_weights", "query_denoising",
                  "query_denoising_groups", "sync_cls_avg_factor",
                  "loss_cls", "loss_bbox", "loss_iou", "positional_encoding")
_TRANSFORMER_KEYS = ("num_frames", "num_points", "num_layers", "num_levels",
                     "code_size", "pc_range")


def pad_multiple(imgs: torch.Tensor, size_divisor: int = 32) -> torch.Tensor:
    """Zero-pad H/W (bottom/right) of ``[..., H, W, 3]`` to a multiple of
    ``size_divisor``."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    pad_h = (size_divisor - h % size_divisor) % size_divisor
    pad_w = (size_divisor - w % size_divisor) % size_divisor
    if pad_h == 0 and pad_w == 0:
        return imgs
    return F.pad(imgs, (0, 0, 0, pad_w, 0, pad_h))


class SparseBEV(nn.Module):
    """Top-level detector (keys ``img_backbone.*``, ``img_neck.*``,
    ``pts_bbox_head.*``)."""

    def __init__(self, img_backbone: Dict[str, Any],
                 pts_bbox_head: Dict[str, Any],
                 img_neck: Optional[Dict[str, Any]] = None,
                 data_aug: Optional[Dict[str, Any]] = None,
                 stop_prev_grad: int = 0, use_grid_mask: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        bb = dict(img_backbone)
        bb_type = bb.pop("type", "ResNet")
        if bb_type not in _BACKBONES:
            raise NotImplementedError(
                f"backbone {bb_type} is not ported yet (ROADMAP Queue 1 "
                "item 13)")
        self.img_backbone = _BACKBONES[bb_type](**bb)
        self.img_neck = None
        if img_neck is not None:
            nk = dict(img_neck)
            if nk.pop("type", "FPN") != "FPN":
                raise NotImplementedError(f"neck {img_neck['type']}")
            self.img_neck = FPN(**nk)
        hd = dict(pts_bbox_head)
        hd.pop("type", None)
        self.pts_bbox_head = SparseBEVHead(compute_dtype=compute_dtype, **hd)
        self.data_aug = dict(data_aug or {})
        self.compute_dtype = compute_dtype
        self.stop_prev_grad = stop_prev_grad
        self.use_grid_mask = use_grid_mask
        # the training augmentations draw from this generator (on the
        # images' device) unless the caller passes the draws; None: the
        # device's global generator
        self.aug_generator: Optional[torch.Generator] = None

    def preprocess(self, img: torch.Tensor, train: bool = False,
                   aug_draws: Optional[dict] = None) -> torch.Tensor:
        """Colour augmentation (``train`` with ``img_color_aug``), BGR ->
        RGB, normalize, pad to the size divisor. img: ``[B, TN, H, W, 3]``
        uint8 or float, raw BGR in [0, 255]. ``aug_draws["photometric"]``
        replaces the generator's draws."""
        img = img.float()
        if train and self.data_aug.get("img_color_aug", False):
            b, tn, h, w, _ = img.shape
            draws = (aug_draws or {}).get("photometric")
            if draws is None:
                draws = draw_photometric(self.aug_generator, b * tn,
                                         img.device)
            img = photometric_distortion(img.reshape(b * tn, h, w, 3),
                                         draws).reshape(b, tn, h, w, 3)
        norm = self.data_aug.get("img_norm_cfg")
        if norm is not None:
            mean = torch.tensor(norm["mean"], dtype=img.dtype,
                                device=img.device)
            std = torch.tensor(norm["std"], dtype=img.dtype,
                               device=img.device)
            if norm.get("to_rgb", False):
                img = img.flip(-1)
            img = (img - mean) / std
        pad = self.data_aug.get("img_pad_cfg")
        if pad is not None:
            img = pad_multiple(img, pad["size_divisor"])
        return img

    def extract_img_feat(self, img: torch.Tensor, train: bool = False,
                         aug_draws: Optional[dict] = None):
        """GridMask (training) -> backbone -> neck on folded images
        ``[M, H, W, 3]``; returns NHWC pyramids ``[M, H', W', C]`` in the
        compute dtype."""
        if self.use_grid_mask and train:
            draws = (aug_draws or {}).get("grid_mask")
            if draws is None:
                draws = draw_grid_mask(self.aug_generator, img.shape[1],
                                       img.device)
            img = grid_mask(img, draws)
        x = img.to(self.compute_dtype).permute(0, 3, 1, 2)  # NCHW view
        feats = self.img_backbone(x)
        if self.img_neck is not None:
            feats = self.img_neck(feats)
        return [f.permute(0, 2, 3, 1).contiguous() for f in feats]

    def extract_feat(self, img: torch.Tensor, train: bool = False,
                     aug_draws: Optional[dict] = None):
        """img: ``[B, TN, H, W, 3]`` preprocessed -> list of
        ``[B, TN, H', W', C]`` pyramids in the compute dtype. In training
        with ``stop_prev_grad = k > 0`` only the first k frames' features
        carry gradients (the rest run in a second, detached pass; each pass
        draws its own GridMask, as in the JAX package, unless the draws are
        passed in)."""
        b, tn, h, w, _ = img.shape
        if train and self.stop_prev_grad > 0:
            k = self.stop_prev_grad * 6
            feats_grad = self.extract_img_feat(
                img[:, :k].reshape(-1, h, w, 3), train, aug_draws)
            with torch.no_grad():
                feats_nograd = self.extract_img_feat(
                    img[:, k:].reshape(-1, h, w, 3), train, aug_draws)
            return [torch.cat([fg.reshape(b, k, *fg.shape[1:]),
                               fn.reshape(b, tn - k, *fn.shape[1:])], dim=1)
                    for fg, fn in zip(feats_grad, feats_nograd)]
        feats = self.extract_img_feat(img.reshape(b * tn, h, w, 3), train,
                                      aug_draws)
        return [f.reshape(b, tn, *f.shape[1:]) for f in feats]

    def forward(self, img: torch.Tensor, lidar2img: torch.Tensor,
                time_diff: torch.Tensor, dn_inputs: Optional[dict] = None,
                train: bool = False, aug_draws: Optional[dict] = None):
        """Full forward. img: ``[B, T*6, H, W, 3]`` raw BGR; lidar2img
        ``[B, T*6, 4, 4]``; time_diff ``[B, T]``. ``train`` turns on the
        augmentations, dropout and the per-layer classification;
        ``aug_draws`` (``photometric``, ``grid_mask``) replaces the draws of
        ``aug_generator``. Returns the head's prediction dict."""
        img = self.preprocess(img, train, aug_draws)
        image_h, image_w = img.shape[2], img.shape[3]
        feats = self.extract_feat(img, train, aug_draws)
        return self.pts_bbox_head(feats, lidar2img, time_diff, image_h,
                                  image_w, dn_inputs=dn_inputs,
                                  deterministic=not train)

    def forward_frame_packed(self, img: torch.Tensor):
        """Extract ONE frame's pyramid and pack it into grouped sampling
        tables, y-fold or pair rows per level (the head's ``table_yfold``).
        img: ``[B, N, H, W, 3]`` raw BGR."""
        feats = self.extract_feat(self.preprocess(img))
        head = self.pts_bbox_head
        return pack_mlvl_feats_grouped(feats, head.num_views, head.num_groups,
                                       yfold=head.table_yfold)

    def forward_head(self, packed, lidar2img, time_diff, image_h: int,
                     image_w: int):
        return self.pts_bbox_head(packed, lidar2img, time_diff, image_h,
                                  image_w)


def _model_kwargs(cfg) -> Dict[str, Any]:
    """The detector's constructor arguments from a config (or its ``model``
    dict), in the JAX package's schema."""
    model_cfg = dict(cfg["model"] if "model" in cfg else cfg)
    if model_cfg.pop("type") != "SparseBEV":
        raise ValueError("not a SparseBEV config")
    head_cfg = dict(model_cfg.pop("pts_bbox_head"))
    transformer = dict(head_cfg.pop("transformer", {}))
    for k in _TRANSFORMER_KEYS:
        if k in transformer:
            head_cfg.setdefault(k, transformer[k])
    for k in _HEAD_AUX_KEYS:
        head_cfg.pop(k, None)
    for k in ("train_cfg", "test_cfg", "pretrained"):
        model_cfg.pop(k, None)
    model_cfg["pts_bbox_head"] = head_cfg
    dt = model_cfg.pop("compute_dtype", "bfloat16")
    model_cfg["compute_dtype"] = _DTYPES[dt] if isinstance(dt, str) else dt
    return model_cfg


def build_detector(cfg, device=None, seed: Optional[int] = None) -> SparseBEV:
    """Build the detector from a config on ``device`` (CUDA unless the
    caller passes ``device="cpu"``), in eval mode. ``seed`` fills every
    weight with seeded random values (see :func:`random_init_`). (Training
    does not switch modes: dropout and augmentation follow the forward's
    ``train`` argument, the batch norms are frozen.)"""
    dev = resolve_device(device)
    model = SparseBEV(**_model_kwargs(cfg))
    if seed is not None:
        random_init_(model, seed)
    return model.to(dev).eval()


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer with seeded random values from an
    explicit ``torch.Generator``: variance-preserving conv / linear weights,
    BN statistics near the identity, LN affine near (1, 0), the reference
    query-box grid. For runs that need non-trivial weights without a
    checkpoint."""
    gen = torch.Generator().manual_seed(seed)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("init_query_bbox.weight"):
            continue
        if leaf == "running_mean":
            normal(t, 0.1)
        elif leaf == "running_var":
            uniform(t, 0.8, 1.2)
        elif t.dim() >= 2:                       # conv / linear / embedding
            fan_in = t[0].numel() if "label_enc" not in name else 1
            normal(t, 1.0 / math.sqrt(fan_in))
        elif leaf == "weight":                   # BN / LN scale
            uniform(t, 0.8, 1.2)
        else:                                    # biases
            normal(t, 0.1)
    for m in model.modules():
        if isinstance(m, SparseBEVHead):
            m.reset_query_bbox(gen)
    return model
