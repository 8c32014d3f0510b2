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

Chunk-split rings (the head's ``table_split``, :func:`ring_table_splits`)
keep a split level as separate chunk buffers of ``T / split`` slots each.
As in JAX, split mode holds exactly ``T`` slots (``cache_size =
num_frames``) and makes every sample's slot list a bijection onto them: a
frame that fills two positions of the window (the loader repeats the
keyframe at a sequence start) gets its rows copied into a free slot
(:meth:`StreamingDetector._dedupe_slots`, ``ring_copy_slot``), so the slot
lists are the JAX detector's, slot for slot.

``query_group`` (the JAX detector's ``mesh``): the head runs query-sharded
over the group's ranks (``parallel/query_parallel.py``); each rank holds
the whole ring and runs the backbone, and every rank returns all the
predictions.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from .ops.msmv_sampling import (E4M3, ring_copy_slot, ring_init, ring_packed,
                                ring_update)
from .utils import tracing
from .utils.device import resolve_device


def ring_table_dtypes(model, frame_packed):
    """Per-level ring-table dtypes (``sparsebev_tpu/inference.py::
    ring_table_dtypes`` :55): e4m3 for a level marked in the head's
    ``table_fp8`` (a bool or one flag a level), the packed frame's own dtype
    otherwise. Streaming only: training and offline evaluation sample exact
    tables."""
    base = frame_packed.tables[0].dtype
    return tuple(E4M3 if s else base for s in model.pts_bbox_head.table_fp8)


def ring_table_splits(model, frame_packed, num_frames: int):
    """Per-level chunk counts of the streaming ring
    (``sparsebev_tpu/inference.py::ring_table_splits`` :85): the head's
    ``table_split``, one int a level (1: unsplit). A split must divide the
    frame window (``ValueError`` otherwise, as in JAX)."""
    spec = model.pts_bbox_head.table_split
    if len(spec) != len(frame_packed.level_shapes):
        raise ValueError(f"table_split={spec} does not have one entry per "
                         "level")
    for sp in spec:
        if sp > 1 and num_frames % sp:
            raise ValueError(
                f"table_split={spec} must divide num_frames={num_frames}")
    return spec


def make_ring_bench(model, frame, lidar2img, time_diff, num_frames: int,
                    image_h: int, image_w: int, query_group=None):
    """The streaming benchmark harness (``sparsebev_tpu/inference.py::
    make_ring_bench`` :184, which JAX's ``bench.py`` and
    ``tools/timing.py`` share), with JAX's slot arithmetic: every ring slot
    is prefilled with the packed pyramid of ``frame`` (``[1, N, H, W, 3]``
    on the model's device), and sample ``i`` packs ``frame + i * 1e-3`` into
    slot ``i mod T`` and runs the head over slots ``(i - arange(T)) mod T``
    (``ring_packed``, then ``forward_head``; ``query_group`` shards the
    head's queries, whose predictions it gathers, as JAX's ``mesh`` with
    ``constrain_preds``). The model's weights take the place of JAX's
    ``variables``.

    Returns ``(loop_for, ring)``: ``loop_for(iters)`` gives ``loop_fn(ring,
    frame) -> (ring, acc)``, which runs ``iters`` samples eagerly under
    ``torch.inference_mode()`` and sums each one's last-layer class scores
    in fp32 into the 0-d device tensor ``acc`` (read it back once,
    ``float(acc)``, as the sync). The ring is updated in place and returned
    (JAX donates it: a vov99 or r101 ring of 5-10 GB is never copied)."""
    with torch.inference_mode():
        fp0 = model.forward_frame_packed(frame)
        meta = fp0.meta(gsplit=model.pts_bbox_head.table_gsplit)
        ring = ring_init(fp0, num_frames, ring_table_dtypes(model, fp0),
                         ring_table_splits(model, fp0, num_frames))
        for slot in range(num_frames):   # iteration 0 sees a full window
            ring_update(ring, fp0, slot)
        del fp0
    back = torch.arange(num_frames, device=frame.device)

    def loop_for(iters: int):
        @torch.inference_mode()
        def loop_fn(ring, frame):
            acc = torch.zeros((), dtype=torch.float32, device=frame.device)
            for i in range(iters):
                # i * 1e-3 in fp32, as JAX's traced loop index makes it
                fp = model.forward_frame_packed(
                    frame + float(np.float32(i) * np.float32(1e-3)))
                ring_update(ring, fp, i % num_frames)
                packed = ring_packed(ring,
                                     torch.remainder(i - back, num_frames),
                                     num_frames, meta)
                preds = model.forward_head(packed, lidar2img, time_diff,
                                           image_h, image_w,
                                           query_group=query_group)
                acc = acc + preds["all_cls_scores"][-1].float().sum()
            return ring, acc
        return loop_fn

    return loop_for, ring


class StreamingDetector:
    def __init__(self, model, num_frames: int, coder=None,
                 cache_size: int = 16, num_views: int = 6, device=None,
                 query_group=None):
        """``model``: a ``SparseBEV``; it is moved to ``device`` (CUDA unless
        the caller passes ``device="cpu"``) and put in eval mode.
        ``query_group``: a process group over which the head runs
        query-sharded (None: unsharded; the JAX detector's ``mesh``)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_frames = num_frames
        self.num_views = num_views
        self.coder = coder
        self.cache_size = max(cache_size, num_frames)
        self.query_group = query_group
        self._split_mode = any(s > 1 for s in model.pts_bbox_head.table_split)
        if self._split_mode:
            # the split gather's chunk partition needs every ring slot to
            # belong to the current sample (JAX :254-261)
            self.cache_size = num_frames
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
        self.last_slots = None  # the ring slots of the last sample's frames

    def _slot_for_new_frame(self, protected) -> int:
        used = set(self.slot_of_key.values())
        if len(used) < self.cache_size:
            return min(s for s in range(self.cache_size) if s not in used)
        # FIFO evict, but never a frame of the sample being assembled
        for victim in self.slot_of_key:
            if victim not in protected:
                return self.slot_of_key.pop(victim)
        raise RuntimeError("ring cache smaller than the frame window")

    def _dedupe_slots(self, slots, protected):
        """Make the sample's [T] slot list a bijection onto ring slots (JAX
        ``_dedupe_slots`` :312-344): each repeated slot after its first
        occurrence gets its frame's rows copied into the lowest free slot,
        or into the slot of the oldest cached frame outside the window,
        which is evicted. Alias slots are not cached, so later frames may
        take them."""
        seen, out = set(), []
        used = set(self.slot_of_key.values())
        free = [s for s in range(self.cache_size) if s not in used]
        for s in slots:
            if s not in seen:
                seen.add(s)
                out.append(s)
                continue
            if free:
                dst = free.pop(0)
            else:
                for victim in self.slot_of_key:
                    if victim not in protected:
                        dst = self.slot_of_key.pop(victim)
                        break
                else:
                    raise RuntimeError(
                        "ring cache smaller than the frame window")
            ring_copy_slot(self.ring, self._meta, s, dst)
            seen.add(dst)
            out.append(dst)
        return out

    def _ensure_frame(self, key: str, frame_imgs_fn, protected) -> int:
        """frame_imgs_fn: () -> [1, N, H, W, 3] device tensor (lazy, so a
        cache hit uploads nothing). Returns the frame's ring slot."""
        if key in self.slot_of_key:
            self.frames_reused += 1
            return self.slot_of_key[key]
        self.frames_run += 1
        imgs = frame_imgs_fn()
        with tracing.span("stream.frame_pass"):
            fp = self.model.forward_frame_packed(imgs)
            del imgs    # the pixels are dead once the frame pass has them
            if self.ring is None:
                self._meta = fp.meta(
                    gsplit=self.model.pts_bbox_head.table_gsplit)
                self.ring = ring_init(fp, self.cache_size,
                                      ring_table_dtypes(self.model, fp),
                                      ring_table_splits(self.model, fp,
                                                        self.cache_size))
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
        with tracing.span("stream.infer"):
            n = self.num_views
            frames_with_pixels = img.shape[1] // n
            t = len(filenames) // n if filenames else frames_with_pixels
            h, w = img.shape[2], img.shape[3]
            keys = self._keys(filenames, t)
            protected = set(keys)

            def upload(i):
                def fn():
                    with tracing.span("stream.upload"):
                        pend = self._pending.pop(keys[i], None)
                        if pend is not None:
                            return self._consume(pend)
                        if i >= frames_with_pixels:
                            raise RuntimeError(
                                f"history frame {i} ({keys[i]}) is not cached "
                                "and its pixels were not given")
                        return torch.from_numpy(np.ascontiguousarray(
                            img[:, i * n:(i + 1) * n])).to(self.device)
                return fn

            slots = [self._ensure_frame(keys[i], upload(i), protected)
                     for i in range(t)]
            if self._split_mode and len(set(slots)) < t:
                slots = self._dedupe_slots(slots, protected)
            self.last_slots = slots
            with tracing.span("stream.head"):
                packed = ring_packed(self.ring,
                                     torch.tensor(slots, device=self.device),
                                     t, self._meta)
                preds = self.model.forward_head(
                    packed,
                    torch.as_tensor(np.asarray(lidar2img), device=self.device),
                    torch.as_tensor(np.asarray(time_diff), device=self.device),
                    h, w, query_group=self.query_group)
            if self.coder is not None:
                with tracing.span("stream.decode"):
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
