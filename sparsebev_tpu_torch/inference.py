"""Streaming (online) inference with a device-side table ring (counterpart of
``sparsebev_tpu/inference.py::StreamingDetector``).

Per sample, only frames whose key (the absolute path of the frame's first
view) is not cached go through the backbone; they are packed into grouped
sampling tables (y-fold or pair rows per level, ``table_yfold``) and
written into a slot of a fixed ring of device buffers, one a level, of the
dtype :func:`ring_table_dtypes` gives (e4m3 for the head's ``table_fp8``
levels). The ring carries the head's ``table_gsplit`` flags, which pick the
pair levels' accumulation order as the JAX package's group-split ring does.
The decoder reads the ring through a [T]-slot indirection (``ring_packed``),
so history frames are never copied or re-packed. Slots are handed out FIFO
(evict at ``cache_size`` frames) and a frame of the sample being assembled
is never evicted.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from .ops.msmv_sampling import E4M3, ring_init, ring_packed, ring_update
from .utils.device import resolve_device


def ring_table_dtypes(model, frame_packed):
    """Per-level ring-table dtypes (``sparsebev_tpu/inference.py::
    ring_table_dtypes`` :55): e4m3 for a level marked in the head's
    ``table_fp8`` (a bool or one flag a level), the packed frame's own dtype
    otherwise. Streaming only: training and offline evaluation sample exact
    tables."""
    base = frame_packed.tables[0].dtype
    return tuple(E4M3 if s else base for s in model.pts_bbox_head.table_fp8)


class StreamingDetector:
    def __init__(self, model, num_frames: int, coder=None,
                 cache_size: int = 16, num_views: int = 6, device=None):
        """``model``: a ``SparseBEV``; it is moved to ``device`` (CUDA unless
        the caller passes ``device="cpu"``) and put in eval mode."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_frames = num_frames
        self.num_views = num_views
        self.coder = coder
        self.cache_size = max(cache_size, num_frames)
        # key -> ring slot, insertion-ordered (FIFO evict)
        self.slot_of_key: "OrderedDict[str, int]" = OrderedDict()
        # key -> (device tensor, event) from prefetch_upload
        self._pending: dict = {}
        self.ring = None    # per-level table ring (device buffers)
        # frames that ran the backbone / were found in the ring
        self.frames_run = 0
        self.frames_reused = 0
        self._meta = None   # single-frame PackedFeatures geometry
        self._upload_stream = None

    def _slot_for_new_frame(self, protected) -> int:
        used = set(self.slot_of_key.values())
        if len(used) < self.cache_size:
            return min(s for s in range(self.cache_size) if s not in used)
        # FIFO evict, but never a frame of the sample being assembled
        for victim in self.slot_of_key:
            if victim not in protected:
                return self.slot_of_key.pop(victim)
        raise RuntimeError("ring cache smaller than the frame window")

    def _ensure_frame(self, key: str, frame_imgs_fn, protected) -> int:
        """frame_imgs_fn: () -> [1, N, H, W, 3] device tensor (lazy, so a
        cache hit uploads nothing). Returns the frame's ring slot."""
        if key in self.slot_of_key:
            self.frames_reused += 1
            return self.slot_of_key[key]
        self.frames_run += 1
        fp = self.model.forward_frame_packed(frame_imgs_fn())
        if self.ring is None:
            self._meta = fp.meta(
                gsplit=self.model.pts_bbox_head.table_gsplit)
            self.ring = ring_init(fp, self.cache_size,
                                  ring_table_dtypes(self.model, fp))
        slot = self._slot_for_new_frame(protected)
        ring_update(self.ring, fp, slot)
        self.slot_of_key[key] = slot
        return slot

    def _keys(self, filenames, t):
        n = self.num_views
        return [os.path.abspath(filenames[i * n]) if filenames
                else f"frame_{i}" for i in range(t)]

    @torch.inference_mode()
    def infer(self, img: np.ndarray, lidar2img: np.ndarray,
              time_diff: np.ndarray, filenames: List[str]):
        """img: ``[1, F*N, H, W, 3]`` (host array); filenames: per-view file
        names (frame i is keyed by its first view's absolute path). History
        frames without pixels (F < T) must already be cached. Returns the
        coder's decoded boxes, or the raw predictions without a coder."""
        n = self.num_views
        frames_with_pixels = img.shape[1] // n
        t = len(filenames) // n if filenames else frames_with_pixels
        h, w = img.shape[2], img.shape[3]
        keys = self._keys(filenames, t)
        protected = set(keys)

        def upload(i):
            def fn():
                pend = self._pending.pop(keys[i], None)
                if pend is not None:
                    return self._consume(pend)
                if i >= frames_with_pixels:
                    raise RuntimeError(
                        f"history frame {i} ({keys[i]}) is not cached and "
                        "its pixels were not given")
                return torch.from_numpy(np.ascontiguousarray(
                    img[:, i * n:(i + 1) * n])).to(self.device)
            return fn

        slots = [self._ensure_frame(keys[i], upload(i), protected)
                 for i in range(t)]
        packed = ring_packed(self.ring,
                             torch.tensor(slots, device=self.device),
                             t, self._meta)
        preds = self.model.forward_head(
            packed, torch.as_tensor(np.asarray(lidar2img), device=self.device),
            torch.as_tensor(np.asarray(time_diff), device=self.device), h, w)
        if self.coder is not None:
            return self.coder.decode(preds)
        return preds

    def prefetch_upload(self, img: np.ndarray, filenames: List[str]):
        """Start the host-to-device copy of a sample's uncached frames NOW
        (call with sample i+1's pixels before sample i's ``infer``): on CUDA
        the pixels go through pinned memory as a ``non_blocking`` copy on a
        side stream, so the transfer overlaps the running forward; the
        later ``infer`` waits for the copy's event and consumes it."""
        n = self.num_views
        for i in range(img.shape[1] // n):
            key = (os.path.abspath(filenames[i * n]) if filenames
                   else f"frame_{i}")
            if key in self.slot_of_key or key in self._pending:
                continue
            host = torch.from_numpy(np.ascontiguousarray(
                img[:, i * n:(i + 1) * n]))
            if self.device.type != "cuda":
                self._pending[key] = (host.to(self.device), None)
                continue
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream(self.device)
            host = host.pin_memory()
            with torch.cuda.stream(self._upload_stream):
                dev = host.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._upload_stream)
            # the pinned buffer must outlive the copy: keep it with the entry
            self._pending[key] = (dev, event, host)

    def _consume(self, pend):
        dev, event = pend[0], pend[1]
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            dev.record_stream(stream)
        return dev
