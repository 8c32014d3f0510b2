"""Multi-scale multi-view bilinear sampling over y-fold tables.

Counterpart of ``sparsebev_tpu/ops/msmv_sampling.py``, main-path subset:
``PackedFeatures`` and its (b, t, n, h, g) row order, the grouped y-fold
pack, the streaming table ring, ``table_acc_dtype``, the separable slot
weights, the readable oracle ``msmv_sampling_reference`` and the production
op ``msmv_sampling``.

``msmv_sampling`` holds the second CUDA kernel of the port
(``csrc/msmv_sample.cu``): it replaces the JAX package's XLA window gather
plus tap fold (``_yfold_forward`` :1011, ``_fold_window_taps`` :893,
``_gmajor_forward`` :910) with one kernel that computes the point geometry,
reads each point's (2 columns x 2C) window per level, weights and sums it.
:func:`msmv_sampling_plain` is its plain PyTorch version and follows the JAX
order of operations (see ``table_acc_dtype``).

Semantics (as in the JAX module): locations are ``[Q, S, P, 3]`` with x, y in
[0, 1] (pixel = loc * (size - 1)) and the view normalized by 1 / (N - 1)
(view = clip(round(v * (N - 1)))); scale weights ``[Q, S, P, L]``; output
``[Q, S, P, C]`` = sum_l w_l * bilinear(level l) with zero padding per tap.

Not in this slice: plain-row (pair-mode) tables (``table_yfold=False``),
chunk-split rings (``table_split > 1``), fp8 rings (``table_fp8``) — configs
that ask for them are refused by ``models/head.py::check_table_options`` —
and the hybrid one-hot sampler (``set_sampling_impl``). Group-split flags
(``table_gsplit``, ``table_gsplit_pack``) are layout options: the JAX
package's group-split forward is bitwise equal to the unsplit one, so the
port keeps one table per level.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..kernels import build
from .msmv_pack import pack_level


def set_sampling_impl(name: str) -> None:
    """Only the y-fold path exists in the port (the JAX default, "xla")."""
    if name == "hybrid":
        raise NotImplementedError(
            "the hybrid one-hot sampler (sparsebev_tpu/ops/msmv_pallas.py) is "
            "not ported yet (ROADMAP Queue 2 item 7)")
    if name != "xla":
        raise ValueError(f"unknown sampling impl {name!r}")


class PackedFeatures:
    """Per-level y-fold row tables ``[rows, W_l + 1, 2C]``.

    Row ``y`` of each image holds ``feat[y] ‖ feat[y+1]`` on the channel axis
    (``feat[H]`` reads as zeros) plus one zero guard column, so one
    (2 columns x 2C) window holds all four bilinear taps of a point.

    Rows are ordered (b, t, n, h, g): a slice index ``s`` in [0, batch) is
    ``(bt = s // G, g = s % G)``. ``slice_map`` (optional int ``[batch]``)
    maps logical slices to physical ones (the streaming ring holds frames in
    slot order); it is applied per slice, before any per-point work.
    ``tables`` may hold ``None`` entries in a geometry-only copy (:meth:`meta`).
    """

    def __init__(self, tables, batch: int, num_views: int, level_shapes,
                 channels: int, num_groups: int = 1,
                 slice_map: Optional[torch.Tensor] = None):
        self.tables = tuple(tables)
        self.batch = batch
        self.num_views = num_views
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        self.channels = channels
        self.num_groups = num_groups
        self.slice_map = slice_map

    def row_index(self, slice_idx, view, row_y, height):
        """Flat table row for (slice, view, y-row) under the row order above."""
        g = self.num_groups
        if g == 1:
            return (slice_idx * self.num_views + view) * height + row_y
        bt = slice_idx // g
        gi = slice_idx % g
        return ((bt * self.num_views + view) * height + row_y) * g + gi

    def meta(self) -> "PackedFeatures":
        """Geometry-only copy (no table buffers)."""
        return PackedFeatures((None,) * len(self.tables), self.batch,
                              self.num_views, self.level_shapes,
                              self.channels, self.num_groups)


def pack_mlvl_feats_grouped(mlvl_feats: Sequence[torch.Tensor],
                            num_views: int,
                            num_groups: int) -> PackedFeatures:
    """Pack per-frame pyramids ``[B, T*N, H, W, C]`` into grouped y-fold
    tables ``[B*T*N*H*G, W+1, 2Cg]`` (row order (b, t, n, h, g)), one
    :func:`~.msmv_pack.pack_level` call per level. (Group-split configs
    pack the same single table; see the module docstring.)"""
    n, g = num_views, num_groups
    b, tn = mlvl_feats[0].shape[0], mlvl_feats[0].shape[1]
    t = tn // n
    c = mlvl_feats[0].shape[-1]
    cg = c // g
    tables, shapes = [], []
    for feat in mlvl_feats:
        h, w = feat.shape[2], feat.shape[3]
        t2 = pack_level(feat.reshape(b * t * n, h, w, c), g)
        tables.append(t2.reshape(b * t * n * h * g, w + 1, 2 * cg))
        shapes.append((h, w))
    return PackedFeatures(tables, b * t * g, n, shapes, cg, num_groups=g)


def ring_init(frame_packed: PackedFeatures, num_slots: int):
    """Allocate an all-zero table ring with ``num_slots`` frame slots: a
    per-level tuple of ``[num_slots*N*H*G, W+1, 2Cg]`` tensors of the
    single-frame ``frame_packed`` tables' dtype and device."""
    t0 = frame_packed.tables[0]
    rows = frame_packed.num_views * frame_packed.num_groups
    ch = 2 * frame_packed.channels
    return tuple(torch.zeros((num_slots * rows * h, w + 1, ch),
                             dtype=t0.dtype, device=t0.device)
                 for h, w in frame_packed.level_shapes)


def ring_update(ring_tables, frame_packed: PackedFeatures, slot: int):
    """Write one frame's tables into ring slot ``slot``, IN PLACE (the JAX
    version returns an updated copy; the in-place copy saves the ring's
    memory twice over). Returns ``ring_tables``."""
    if frame_packed.batch != frame_packed.num_groups:
        raise ValueError("ring_update expects single-frame, B=1 packed tables")
    for ring, frame in zip(ring_tables, frame_packed.tables):
        rows = frame.shape[0]
        if ring.shape[0] % rows:
            raise ValueError("frame tables do not tile the ring")
        ring[slot * rows:(slot + 1) * rows].copy_(frame)
    return ring_tables


def ring_packed(ring_tables, slots_of_t: torch.Tensor, num_frames: int,
                frame_packed_meta: PackedFeatures) -> PackedFeatures:
    """View a table ring as PackedFeatures for the decoder.

    ``slots_of_t``: int ``[T]`` — the ring slot of each logical frame
    (0 = newest), carried as ``slice_map [T*G]``."""
    g = frame_packed_meta.num_groups
    slots_of_t = slots_of_t.to(torch.int64)
    groups = torch.arange(g, dtype=torch.int64, device=slots_of_t.device)
    slice_map = (slots_of_t[:, None] * g + groups[None]).reshape(
        num_frames * g)
    return PackedFeatures(ring_tables, num_frames * g,
                          frame_packed_meta.num_views,
                          frame_packed_meta.level_shapes,
                          frame_packed_meta.channels, num_groups=g,
                          slice_map=slice_map)


def table_acc_dtype(packed: PackedFeatures) -> torch.dtype:
    """Output/accumulator dtype of the sampling op: the table dtype for
    bf16/fp32 tables (each level's tap contraction still reduces in fp32),
    fp32 otherwise."""
    t0 = packed.tables[0]
    dt = t0.dtype if t0 is not None else torch.float32
    return dt if dt in (torch.bfloat16, torch.float32) else torch.float32


def _bilinear_taps(x_pix, y_pix, h, w):
    """Corner indices + weights with the out-of-bounds taps masked to 0."""
    x0 = torch.floor(x_pix)
    y0 = torch.floor(y_pix)
    lx = x_pix - x0
    ly = y_pix - y0
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    ix1 = ix0 + 1
    iy1 = iy0 + 1

    def inb(ix, iy):
        return ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1))

    w00 = (1.0 - ly) * (1.0 - lx) * inb(ix0, iy0)
    w01 = (1.0 - ly) * lx * inb(ix1, iy0)
    w10 = ly * (1.0 - lx) * inb(ix0, iy1)
    w11 = ly * lx * inb(ix1, iy1)
    return (ix0, iy0, ix1, iy1), (w00, w01, w10, w11)


def _clamp_pixels(pix, size):
    # pixels beyond [-2, size+1] have every tap masked; clamping them keeps
    # the integer conversion in range and changes no weight
    return pix.clamp(-2.0, float(size + 1))


def _separable_slot_weights(x_pix, y_pix, h, w):
    """Slot indices + separable weights for the y-fold window read.

    The window is rows ``ry`` (carrying y-taps ``ry`` and ``ry+1`` on the
    channel halves) x columns ``[sx, sx+1]``. When the true ``ix0``/``iy0``
    is -1 the window shifts right/down by one, so the x1/y1 weight moves to
    the window's FIRST slot (the x0/y0 weight is already masked there).
    Returns ``(sx, ry, (wxa, wxb), (wya, wyb))`` with border masks folded in.
    """
    x_pix = _clamp_pixels(x_pix, w)
    y_pix = _clamp_pixels(y_pix, h)
    x0 = torch.floor(x_pix)
    y0 = torch.floor(y_pix)
    lx = x_pix - x0
    ly = y_pix - y0
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)

    inx0 = (ix0 >= 0) & (ix0 <= w - 1)
    inx1 = (ix0 + 1 >= 0) & (ix0 + 1 <= w - 1)
    iny0 = (iy0 >= 0) & (iy0 <= h - 1)
    iny1 = (iy0 + 1 >= 0) & (iy0 + 1 <= h - 1)

    wx0 = (1.0 - lx) * inx0
    wx1 = lx * inx1
    wy0 = (1.0 - ly) * iny0
    wy1 = ly * iny1

    sh_x = ix0 < 0
    sx = ix0.clamp(0, w - 1)  # x1 then lands in the zero guard column
    wxa = torch.where(sh_x, wx1, wx0)
    wxb = torch.where(sh_x, torch.zeros_like(wx1), wx1)

    sh_y = iy0 < 0
    ry = iy0.clamp(0, h - 1)  # row H-1's second half is already zeros
    wya = torch.where(sh_y, wy1, wy0)
    wyb = torch.where(sh_y, torch.zeros_like(wy1), wy1)
    return sx, ry, (wxa, wxb), (wya, wyb)


def _view_index(v, n):
    return torch.round(v * (n - 1)).clamp(0, n - 1).to(torch.int64)


def msmv_sampling_reference(mlvl_feats: Sequence[torch.Tensor],
                            sampling_locations: torch.Tensor,
                            scale_weights: torch.Tensor) -> torch.Tensor:
    """Readable per-level oracle over raw pyramids ``[B, N, H, W, C]``;
    locations ``[B, Q, P, 3]``, weights ``[B, Q, P, L]`` -> fp32
    ``[B, Q, P, C]``."""
    assert scale_weights.shape[-1] == len(mlvl_feats)
    b, q, p, _ = sampling_locations.shape
    n = mlvl_feats[0].shape[1]
    c = mlvl_feats[0].shape[-1]
    x = sampling_locations[..., 0]
    y = sampling_locations[..., 1]
    view = _view_index(sampling_locations[..., 2], n)
    out = torch.zeros((b, q, p, c), dtype=torch.float32,
                      device=sampling_locations.device)
    bi = torch.arange(b, device=x.device)[:, None, None]
    for lvl, feat in enumerate(mlvl_feats):
        h, w = feat.shape[2], feat.shape[3]
        (ix0, iy0, ix1, iy1), (w00, w01, w10, w11) = _bilinear_taps(
            _clamp_pixels(x * (w - 1), w), _clamp_pixels(y * (h - 1), h),
            h, w)
        ix0c, ix1c = ix0.clamp(0, w - 1), ix1.clamp(0, w - 1)
        iy0c, iy1c = iy0.clamp(0, h - 1), iy1.clamp(0, h - 1)
        tap = (feat[bi, view, iy0c, ix0c] * w00[..., None]
               + feat[bi, view, iy0c, ix1c] * w01[..., None]
               + feat[bi, view, iy1c, ix0c] * w10[..., None]
               + feat[bi, view, iy1c, ix1c] * w11[..., None])
        out = out + tap.float() * scale_weights[..., lvl:lvl + 1].float()
    return out


def _fold_window_taps(g0, g1, fxa, fxb, fya, fyb, c):
    """y-fold window contraction: the window's two columns ``g0``/``g1``
    ``[K, 2C]`` -> ``[K, C]``. The x fold runs as products in the table
    dtype with fp32 adds; the y/level weights fold in fp32."""
    xa = fxa[:, None].to(g0.dtype)
    xb = fxb[:, None].to(g0.dtype)
    return (((g0[:, :c] * xa).float() + (g1[:, :c] * xb).float()) * fya
            + ((g0[:, c:] * xa).float() + (g1[:, c:] * xb).float()) * fyb)


def _check_geometry(packed, loc, sw):
    if not isinstance(packed, PackedFeatures):
        raise TypeError("msmv_sampling takes PackedFeatures "
                        "(pack_mlvl_feats_grouped / ring_packed)")
    q, s, p, three = loc.shape
    if three != 3 or s != packed.batch:
        raise ValueError(f"locations {tuple(loc.shape)} do not match "
                         f"{packed.batch} packed slices")
    if tuple(sw.shape) != (q, s, p, len(packed.level_shapes)):
        raise ValueError(f"scale weights {tuple(sw.shape)} do not match "
                         f"locations {tuple(loc.shape)} and "
                         f"{len(packed.level_shapes)} levels")


def msmv_sampling_plain(packed: PackedFeatures,
                        sampling_locations: torch.Tensor,
                        scale_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sampling forward (query-major): the
    JAX ``_yfold_forward`` with its order of operations."""
    _check_geometry(packed, sampling_locations, scale_weights)
    q, s, p, _ = sampling_locations.shape
    n, c = packed.num_views, packed.channels
    num_levels = len(packed.level_shapes)
    k = q * s * p
    dev = sampling_locations.device
    x = sampling_locations[..., 0].reshape(k)
    y = sampling_locations[..., 1].reshape(k)
    view = _view_index(sampling_locations[..., 2].reshape(k), n)
    slices = (torch.arange(s, device=dev) if packed.slice_map is None
              else packed.slice_map.to(device=dev, dtype=torch.int64))
    batch_row = slices.repeat_interleave(p).repeat(q)          # (q, s, p)
    lw_levels = scale_weights.reshape(k, num_levels).t().float()
    acc_dtype = table_acc_dtype(packed)
    out = torch.zeros((k, c), dtype=acc_dtype, device=dev)
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = _separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        lw = lw_levels[lvl]
        row = packed.row_index(batch_row, view, ry, h)
        flat = packed.tables[lvl].reshape(-1, 2 * c)
        col = row * (w + 1) + sx
        lvl_out = _fold_window_taps(flat[col], flat[col + 1], wxa, wxb,
                                    (wya * lw)[:, None], (wyb * lw)[:, None],
                                    c)
        out = out + lvl_out.to(acc_dtype)
    return out.reshape(q, s, p, c)


def msmv_sampling(packed: PackedFeatures,
                  sampling_locations: torch.Tensor,
                  scale_weights: torch.Tensor) -> torch.Tensor:
    """Production sampling op, query-major (the JAX ``qmajor=True``
    layout): locations ``[Q, S, P, 3]``, weights ``[Q, S, P, L]`` ->
    ``[Q, S, P, C]`` in ``table_acc_dtype``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if sampling_locations.device.type == "cpu":
        return msmv_sampling_plain(packed, sampling_locations, scale_weights)
    return _msmv_sampling_cuda(packed, sampling_locations, scale_weights)


msmv_sampling.launches = 0  # kernel launches (counted in _msmv_sampling_cuda)

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("msmv_sample")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmv_sample_forward.argtypes = [
            vp, vp, vp, ci, vp, vp, vp, vp, ctypes.c_longlong,
            ci, ci, ci, ci, ci, ci, vp]
        lib.msmv_sample_forward.restype = ci
        _SIGNATURE_SET = True
    return lib


def _msmv_sampling_cuda(packed, loc, sw):
    _check_geometry(packed, loc, sw)
    dev = loc.device
    if not loc.is_cuda:
        raise ValueError(f"msmv_sampling: no kernel for device {dev}")
    for name, t in (("locations", loc), ("scale weights", sw)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"msmv_sampling: {name} must be contiguous fp32 "
                             f"on {dev}")
    dtype = packed.tables[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"msmv_sampling: no kernel for {dtype} tables")
    for t in packed.tables:
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError("msmv_sampling: tables must be contiguous, of "
                             f"one dtype, on {dev}")
    q, s, p, _ = loc.shape
    c = packed.channels
    slice_map = (torch.arange(s, device=dev) if packed.slice_map is None
                 else packed.slice_map)
    slice_map = slice_map.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((q, s, p, c), dtype=dtype, device=dev)
    num_levels = len(packed.level_shapes)
    tables = (ctypes.c_void_p * num_levels)(
        *[t.data_ptr() for t in packed.tables])
    heights = (ctypes.c_int * num_levels)(*[h for h, _ in packed.level_shapes])
    widths = (ctypes.c_int * num_levels)(*[w for _, w in packed.level_shapes])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msmv_sample_forward(
            tables, heights, widths, num_levels, loc.data_ptr(),
            sw.data_ptr(), slice_map.data_ptr(), out.data_ptr(), q * s * p,
            s, p, packed.num_views, packed.num_groups, c,
            int(dtype == torch.bfloat16), stream)
    build.check(lib, "msmv_sample", rc)
    msmv_sampling.launches += 1
    return out
