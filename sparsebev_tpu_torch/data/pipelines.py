"""Host-side data pipeline steps (numpy/PIL; the port's copy of
``sparsebev_tpu/data/pipelines.py``, registered in the port's own
``PIPELINES``).

Re-provides the reference's pipeline surface:
- sweep loaders: reference loaders/pipelines/loading.py
- image transforms: reference loaders/pipelines/transforms.py
- the mm*-provided steps the configs name (LoadMultiViewImageFromFiles,
  LoadAnnotations3D, Object{Range,Name}Filter, DefaultFormatBundle3D,
  Collect3D, MultiScaleFlipAug3D — SURVEY.md section 2.5).

Images stay raw BGR float32 on host; normalization/photometric aug run on
device in the detector (mirroring the reference's GPU-side aug,
models/sparsebev.py:72-95). CPU variants are provided for config parity.
Every random draw comes from :func:`random_state`: numpy's global RNG, in
the JAX package's call order, so under the same ``np.random.seed`` a sample
equals the JAX package's bit for bit; or, where the loader runs samples on
more than one thread, the sample's own stream (:func:`sample_stream`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Sequence

import numpy as np

from ..ops.geometry import compose_lidar2img
from ..registry import PIPELINES
from .box3d import Boxes3D

_LOCAL = threading.local()


def random_state() -> np.random.RandomState:
    """The stream this thread's pipeline steps draw from: the sample's own
    inside :func:`sample_stream`, numpy's global one (``np.random.seed``)
    otherwise."""
    rng = getattr(_LOCAL, "rng", None)
    return np.random.mtrand._rand if rng is None else rng


@contextlib.contextmanager
def sample_stream(seed: int):
    """Draw this thread's pipeline steps from ``RandomState(seed)`` for the
    duration (a loader thread, one sample)."""
    _LOCAL.rng = np.random.RandomState(seed)
    try:
        yield
    finally:
        _LOCAL.rng = None


CAM_TYPES = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
]


class LazyJPEG:
    """Deferred-decode marker: when the native loader is available, the
    decode is FUSED with RandomTransformImage's resize+crop+flip in C++
    (csrc/fastloader.cpp sbtpu_load_batch — the host counterpart of the
    reference's turbojpeg path, loaders/pipelines/loading.py:48-51), so raw
    1600x900 pixels never materialize in Python."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path


def _materialize(img):
    return _imread_bgr(img.path) if isinstance(img, LazyJPEG) else img


def _imread_bgr(path: str) -> np.ndarray:
    # native libjpeg decoder when built (make -C csrc); PIL fallback —
    # both sit on libjpeg, so pixels agree bit-for-bit
    if path.lower().endswith((".jpg", ".jpeg")):
        from . import fastloader
        out = fastloader.decode(path)
        if out is not None:
            return out
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr[..., ::-1].copy()  # BGR like mmcv.imread


@PIPELINES.register_module()
class LoadMultiViewImageFromFiles:
    """Decode the 6 keyframe JPEGs (mm*-provided in the reference).

    ``lazy="auto"``: defer JPEG decode to a downstream fused
    RandomTransformImage when the native loader is built (decode still
    happens here otherwise). Steps between the loaders and the transform
    only touch annotations, never pixels."""

    def __init__(self, to_float32: bool = False, color_type: str = "color",
                 lazy: str = "auto"):
        self.to_float32 = to_float32
        self.lazy = lazy

    def _use_lazy(self, paths) -> bool:
        if self.lazy in (False, "never"):
            return False
        if self.to_float32:
            # the flag promises float32 pixels to downstream host steps;
            # the fused path keeps uint8 until device normalization
            return False
        from . import fastloader
        return (fastloader.available()
                and all(p.lower().endswith((".jpg", ".jpeg"))
                        for p in paths))

    def __call__(self, results):
        paths = results["img_filename"]
        if self._use_lazy(paths):
            results["img"] = [LazyJPEG(p) for p in paths]
            results["_lazy_images"] = True
            results["filename"] = list(paths)
            return results
        imgs = [_imread_bgr(p) for p in paths]
        if self.to_float32:
            imgs = [im.astype(np.float32) for im in imgs]
        results["img"] = imgs
        results["filename"] = list(results["img_filename"])
        results["ori_shape"] = [im.shape for im in imgs]
        results["img_shape"] = [im.shape for im in imgs]
        results["pad_shape"] = [im.shape for im in imgs]
        return results


class _SweepLoaderBase:
    TRAIN_INTERVAL = (4, 8)
    TEST_INTERVAL = 6

    def _append_sweep(self, results, sweep, load_images=True):
        for sensor in CAM_TYPES:
            cam = sweep[sensor]
            if load_images:
                results["img"].append(
                    LazyJPEG(cam["data_path"])
                    if results.get("_lazy_images")
                    else _imread_bgr(cam["data_path"]))
            results["img_timestamp"].append(cam["timestamp"] / 1e6)
            results["filename"].append(os.path.relpath(cam["data_path"])
                                       if os.path.isabs(cam["data_path"])
                                       else cam["data_path"])
            results["lidar2img"].append(compose_lidar2img(
                results["ego2global_translation"],
                results["ego2global_rotation"],
                results["lidar2ego_translation"],
                results["lidar2ego_rotation"],
                cam["sensor2global_translation"],
                cam["sensor2global_rotation"],
                cam["cam_intrinsic"],
            ))

    def _repeat_keyframe(self, results, n, load_images=True):
        for _ in range(n):
            for j in range(len(CAM_TYPES)):
                if load_images:
                    results["img"].append(results["img"][j])
                results["img_timestamp"].append(results["img_timestamp"][j])
                results["filename"].append(results["filename"][j])
                results["lidar2img"].append(np.copy(results["lidar2img"][j]))

    @staticmethod
    def _pick(sweeps, choices, results, append_fn):
        for idx in sorted(choices):
            sweep_idx = min(idx, len(sweeps) - 1)
            sweep = sweeps[sweep_idx]
            if len(sweep.keys()) < len(CAM_TYPES):
                sweep = sweeps[sweep_idx - 1]
            append_fn(sweep)


@PIPELINES.register_module()
class LoadMultiViewImageFromMultiSweeps(_SweepLoaderBase):
    """Append ``sweeps_num`` past frames: random interval 4-8 (train), fixed 6
    (test); ``load_online`` skips decoding history JPEGs for streaming FPS
    runs (loading.py:35-154)."""

    def __init__(self, sweeps_num: int = 5, color_type: str = "color",
                 test_mode: bool = False, load_online: bool = False,
                 world_size: int = 1):
        self.sweeps_num = sweeps_num
        self.test_mode = test_mode
        self.load_online = load_online and test_mode and world_size == 1

    def __call__(self, results):
        if self.sweeps_num == 0:
            return results
        load_images = not self.load_online
        prev = results["sweeps"]["prev"]
        if len(prev) == 0:
            self._repeat_keyframe(results, self.sweeps_num, load_images)
            return results

        if self.test_mode:
            interval = self.TEST_INTERVAL
            choices = [(k + 1) * interval - 1 for k in range(self.sweeps_num)]
        elif len(prev) <= self.sweeps_num:
            pad = self.sweeps_num - len(prev)
            choices = list(range(len(prev))) + [len(prev) - 1] * pad
        else:
            max_int = min(len(prev) // self.sweeps_num, self.TRAIN_INTERVAL[1])
            min_int = min(max_int, self.TRAIN_INTERVAL[0])
            interval = random_state().randint(min_int, max_int + 1)
            choices = [(k + 1) * interval - 1 for k in range(self.sweeps_num)]

        self._pick(prev, choices, results,
                   lambda s: self._append_sweep(results, s, load_images))
        return results


@PIPELINES.register_module()
class LoadMultiViewImageFromMultiSweepsFuture(_SweepLoaderBase):
    """Past then future sweeps, shared random interval (loading.py:157-257)."""

    def __init__(self, prev_sweeps_num: int = 5, next_sweeps_num: int = 5,
                 color_type: str = "color", test_mode: bool = False):
        assert prev_sweeps_num == next_sweeps_num
        self.prev_sweeps_num = prev_sweeps_num
        self.next_sweeps_num = next_sweeps_num
        self.test_mode = test_mode

    def _interval(self):
        if self.test_mode:
            return self.TEST_INTERVAL
        return random_state().randint(self.TRAIN_INTERVAL[0],
                                      self.TRAIN_INTERVAL[1] + 1)

    def __call__(self, results):
        if self.prev_sweeps_num == 0 and self.next_sweeps_num == 0:
            return results
        interval = self._interval()
        for key, num in (("prev", self.prev_sweeps_num),
                         ("next", self.next_sweeps_num)):
            sweeps = results["sweeps"][key]
            if len(sweeps) == 0:
                self._repeat_keyframe(results, num)
            else:
                choices = [(k + 1) * interval - 1 for k in range(num)]
                self._pick(sweeps, choices, results,
                           lambda s: self._append_sweep(results, s))
        return results


@PIPELINES.register_module()
class LoadMultiViewImageFromMultiSweepsFutureInterleave(_SweepLoaderBase):
    """prev/next interleaved: curr, prev1, next1, prev2, next2, ...
    (loading.py:264-392)."""

    def __init__(self, prev_sweeps_num: int = 5, next_sweeps_num: int = 5,
                 color_type: str = "color", test_mode: bool = False):
        assert prev_sweeps_num == next_sweeps_num
        self.prev_sweeps_num = prev_sweeps_num
        self.next_sweeps_num = next_sweeps_num
        self.test_mode = test_mode

    def __call__(self, results):
        if self.prev_sweeps_num == 0 and self.next_sweeps_num == 0:
            return results
        interval = (self.TEST_INTERVAL if self.test_mode else
                    random_state().randint(self.TRAIN_INTERVAL[0],
                                           self.TRAIN_INTERVAL[1] + 1))

        halves = []
        for key, num in (("prev", self.prev_sweeps_num),
                         ("next", self.next_sweeps_num)):
            part = dict(img=[], img_timestamp=[], filename=[], lidar2img=[])
            sweeps = results["sweeps"][key]
            if len(sweeps) == 0:
                for _ in range(num):
                    for j in range(len(CAM_TYPES)):
                        part["img"].append(results["img"][j])
                        part["img_timestamp"].append(results["img_timestamp"][j])
                        part["filename"].append(results["filename"][j])
                        part["lidar2img"].append(np.copy(results["lidar2img"][j]))
            else:
                choices = [(k + 1) * interval - 1 for k in range(num)]
                tmp = dict(results, img=part["img"],
                           img_timestamp=part["img_timestamp"],
                           filename=part["filename"],
                           lidar2img=part["lidar2img"])
                self._pick(sweeps, choices, tmp,
                           lambda s: self._append_sweep(tmp, s))
            halves.append(part)

        prev_h, next_h = halves
        for i in range(len(prev_h["img"]) // 6):
            for part in (prev_h, next_h):
                for j in range(6):
                    k = i * 6 + j
                    results["img"].append(part["img"][k])
                    results["img_timestamp"].append(part["img_timestamp"][k])
                    results["filename"].append(part["filename"][k])
                    results["lidar2img"].append(part["lidar2img"][k])
        return results


@PIPELINES.register_module()
class LoadAnnotations3D:
    """Annotations are attached by the dataset (config-parity passthrough)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class ObjectRangeFilter:
    def __init__(self, point_cloud_range: Sequence[float]):
        self.pc_range = list(point_cloud_range)

    def __call__(self, results):
        boxes: Boxes3D = results["gt_bboxes_3d"]
        keep = boxes.in_range_bev(self.pc_range)
        results["gt_bboxes_3d"] = boxes[keep]
        results["gt_labels_3d"] = np.asarray(results["gt_labels_3d"])[keep]
        if "gt_num_pts" in results:
            results["gt_num_pts"] = np.asarray(results["gt_num_pts"])[keep]
        return results


@PIPELINES.register_module()
class ObjectNameFilter:
    def __init__(self, classes: Sequence[str]):
        self.classes = list(classes)

    def __call__(self, results):
        labels = np.asarray(results["gt_labels_3d"])
        keep = (labels >= 0) & (labels < len(self.classes))
        results["gt_bboxes_3d"] = results["gt_bboxes_3d"][keep]
        results["gt_labels_3d"] = labels[keep]
        if "gt_num_pts" in results:
            results["gt_num_pts"] = np.asarray(results["gt_num_pts"])[keep]
        return results


@PIPELINES.register_module()
class RandomTransformImage:
    """BEVStereo-style image-data augmentation: ONE random resize/crop/flip/
    rotate shared by all views, folded into every lidar2img
    (transforms.py:218-341)."""

    def __init__(self, ida_aug_conf: Dict[str, Any], training: bool = True):
        self.conf = ida_aug_conf
        self.training = training

    def sample_augmentation(self):
        h, w = self.conf["H"], self.conf["W"]
        fh, fw = self.conf["final_dim"]
        if self.training:
            rng = random_state()
            resize = rng.uniform(*self.conf["resize_lim"])
            dims = (int(w * resize), int(h * resize))
            nw, nh = dims
            crop_h = int((1 - rng.uniform(*self.conf["bot_pct_lim"])) * nh) - fh
            crop_w = int(rng.uniform(0, max(0, nw - fw)))
            crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
            flip = bool(self.conf["rand_flip"] and rng.choice([0, 1]))
            rotate = rng.uniform(*self.conf["rot_lim"])
        else:
            resize = max(fh / h, fw / w)
            dims = (int(w * resize), int(h * resize))
            nw, nh = dims
            crop_h = int((1 - np.mean(self.conf["bot_pct_lim"])) * nh) - fh
            crop_w = int(max(0, nw - fw) / 2)
            crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
            flip, rotate = False, 0.0
        return resize, dims, crop, flip, rotate

    @staticmethod
    def ida_matrix(resize, crop, flip, rotate):
        """4x4 pixel homography of the image op (transforms.py:270-311)."""
        ida_rot = np.eye(2)
        ida_tran = np.zeros(2)

        ida_rot *= resize
        ida_tran -= np.asarray(crop[:2], dtype=np.float64)
        if flip:
            a = np.array([[-1.0, 0.0], [0.0, 1.0]])
            bb = np.array([crop[2] - crop[0], 0.0])
            ida_rot = a @ ida_rot
            ida_tran = a @ ida_tran + bb
        theta = rotate / 180 * np.pi
        a = np.array([[np.cos(theta), np.sin(theta)],
                      [-np.sin(theta), np.cos(theta)]])
        bb = np.array([crop[2] - crop[0], crop[3] - crop[1]]) / 2
        bb = a @ (-bb) + bb
        ida_rot = a @ ida_rot
        ida_tran = a @ ida_tran + bb

        ida_mat = np.eye(4)
        ida_mat[:2, :2] = ida_rot
        ida_mat[:2, 2] = ida_tran
        return ida_mat.astype(np.float32)

    @classmethod
    def img_transform(cls, img, resize, resize_dims, crop, flip, rotate):
        """PIL image op + matching 4x4 pixel homography (transforms.py:270-311)."""
        from PIL import Image
        img = img.resize(resize_dims)
        img = img.crop(crop)
        if flip:
            img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
        img = img.rotate(rotate)
        return img, cls.ida_matrix(resize, crop, flip, rotate)

    def _fused_transform(self, results, params):
        """Decode+resize+crop+flip the whole T*6 batch in the native loader
        (csrc/fastloader.cpp) — only when every image is a LazyJPEG, there is
        no rotation, and the crop is in-bounds (PIL zero-pads out-of-bounds
        crops; in-bounds always holds for the nuScenes ida_aug_conf ranges).
        Returns True when the batch was handled."""
        resize, resize_dims, crop, flip, rotate = params
        imgs = results["img"]
        if not imgs or not all(isinstance(im, LazyJPEG) for im in imgs):
            return False
        if rotate != 0:
            return False
        nw, nh = resize_dims
        x0, y0, x1, y1 = crop
        if x0 < 0 or y0 < 0 or x1 > nw or y1 > nh:
            return False
        from . import fastloader
        batch = fastloader.load_batch(
            [im.path for im in imgs], resize_dims,
            (x0, y0, x1 - x0, y1 - y0), flip)
        if batch is None:
            return False
        results["img"] = list(batch)
        return True

    def __call__(self, results):
        from PIL import Image
        params = self.sample_augmentation()
        ida_mat = None
        if self._fused_transform(results, params):
            resize, _, crop, flip, rotate = params
            ida_mat = self.ida_matrix(resize, crop, flip, rotate)
        else:
            for i in range(len(results["img"])):
                img = Image.fromarray(
                    np.uint8(_materialize(results["img"][i])))
                img, ida_mat = self.img_transform(img, *params)
                results["img"][i] = np.array(img).astype(np.uint8)
        results.pop("_lazy_images", None)
        if ida_mat is not None:
            for i in range(len(results["lidar2img"])):
                results["lidar2img"][i] = ida_mat @ results["lidar2img"][i]
        results["ori_shape"] = [im.shape for im in results["img"]]
        results["img_shape"] = [im.shape for im in results["img"]]
        results["pad_shape"] = [im.shape for im in results["img"]]
        return results


@PIPELINES.register_module()
class GlobalRotScaleTransImage:
    """BEV-space rotate/scale of the scene: boxes transformed forward, the
    inverse folded into every lidar2img (transforms.py:344-394)."""

    def __init__(self, rot_range=(-0.3925, 0.3925),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0, 0, 0)):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range

    def __call__(self, results):
        angle = random_state().uniform(*self.rot_range)
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0, 0], [s, c, 0, 0],
                        [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
        rot_inv = np.linalg.inv(rot)
        results["lidar2img"] = [
            (np.asarray(m, np.float64) @ rot_inv).astype(np.float32)
            for m in results["lidar2img"]]
        results["gt_bboxes_3d"].rotate(angle)

        scale = random_state().uniform(*self.scale_ratio_range)
        sc_inv = np.diag([1 / scale, 1 / scale, 1 / scale, 1.0])
        results["lidar2img"] = [
            (np.asarray(m, np.float64) @ sc_inv).astype(np.float32)
            for m in results["lidar2img"]]
        results["gt_bboxes_3d"].scale(scale)
        return results


@PIPELINES.register_module()
class NormalizeMultiviewImage:
    """CPU-side normalize (the configs normally do this on device)."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        out = []
        for img in results["img"]:
            img = img.astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            out.append((img - self.mean) / self.std)
        results["img"] = out
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class PadMultiViewImage:
    def __init__(self, size=None, size_divisor=None, pad_val=0):
        assert (size is None) != (size_divisor is None)
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        padded = []
        for img in results["img"]:
            if self.size_divisor is not None:
                ph = int(np.ceil(img.shape[0] / self.size_divisor)) * self.size_divisor
                pw = int(np.ceil(img.shape[1] / self.size_divisor)) * self.size_divisor
            else:
                ph, pw = self.size
            padded.append(np.pad(
                img, ((0, ph - img.shape[0]), (0, pw - img.shape[1]), (0, 0)),
                constant_values=self.pad_val))
        results["ori_shape"] = [im.shape for im in results["img"]]
        results["img"] = padded
        results["img_shape"] = [im.shape for im in padded]
        results["pad_shape"] = [im.shape for im in padded]
        return results


@PIPELINES.register_module()
class PhotoMetricDistortionMultiViewImage:
    """CPU photometric aug (transforms.py:116-215); the configs use the
    on-device variant instead (models/augment.py).

    The pixel math is ``models/augment.py::photometric_distortion`` on CPU
    tensors. Its draws come from a ``torch.Generator`` seeded with one
    ``np.random.randint`` (where the JAX step seeds its threefry key), so
    the numpy call order stays the JAX package's; the draws themselves
    differ from JAX's, whose random streams torch cannot reproduce."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def draw(self, n: int, seed: int):
        """The draws of ``n`` images from a generator seeded with ``seed``."""
        import torch
        from ..models.augment import draw_photometric
        return draw_photometric(
            torch.Generator().manual_seed(seed), n, "cpu",
            brightness_delta=self.brightness_delta,
            contrast_range=self.contrast_range,
            saturation_range=self.saturation_range,
            hue_delta=self.hue_delta)

    def apply(self, results, draws):
        """The pixel math on ``results["img"]`` with the given draws."""
        import torch
        from ..models.augment import photometric_distortion
        # LazyJPEG markers (fused-loader path) must be decoded before any
        # host pixel math
        imgs = np.stack([_materialize(im).astype(np.float32)
                         for im in results["img"]])
        out = photometric_distortion(torch.from_numpy(imgs), draws).numpy()
        results["img"] = list(out)
        return results

    def __call__(self, results):
        seed = random_state().randint(0, 2 ** 31 - 1)
        return self.apply(results, self.draw(len(results["img"]), seed))


@PIPELINES.register_module()
class DefaultFormatBundle3D:
    """Stack per-view images to one array (mm* formatting parity)."""

    def __init__(self, class_names=None, with_label=True):
        self.with_label = with_label

    def __call__(self, results):
        # images keep their native dtype (uint8 after RandomTransformImage):
        # the detector casts on DEVICE, so the host->device transfer moves
        # 4x fewer bytes than a float32 stack (the reference normalizes on
        # GPU for the same reason, models/sparsebev.py:72-95)
        results["img"] = np.stack(
            [_materialize(im) for im in results["img"]])  # [TN, H, W, 3]
        results["lidar2img"] = np.stack(
            [np.asarray(m, np.float32) for m in results["lidar2img"]])
        results["img_timestamp"] = np.asarray(results["img_timestamp"],
                                              np.float64)
        return results


@PIPELINES.register_module()
class Collect3D:
    """Reduce the result dict to model inputs + metas (mm* parity)."""

    def __init__(self, keys, meta_keys=("filename", "ori_shape", "img_shape",
                                        "pad_shape", "lidar2img",
                                        "img_timestamp")):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys)

    def __call__(self, results):
        out = {}
        metas = {}
        for k in self.meta_keys:
            if k in results:
                metas[k] = results[k]
        metas["sample_idx"] = results.get("sample_idx")
        out["img_metas"] = metas
        for k in self.keys:
            if k in results:
                out[k] = results[k]
        # always surface what the train step / evaluator need
        for k in ("img", "lidar2img", "img_timestamp", "ego_frame",
                  "gt_num_pts"):
            if k in results and k not in out:
                out[k] = results[k]
        return out


@PIPELINES.register_module()
class MultiScaleFlipAug3D:
    """Config-parity wrapper: no TTA, just run the inner transforms."""

    def __init__(self, transforms, img_scale=None, pts_scale_ratio=1,
                 flip=False):
        from ..registry import PIPELINES as P, build
        self.transforms = [build(dict(t), P) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
        return results
