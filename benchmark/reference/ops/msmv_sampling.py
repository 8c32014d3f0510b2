"""Plain multi-scale multi-view sampling over y-fold and pair-mode tables.

A frozen copy of the plain path of ``sparsebev_tpu_torch/ops/msmv_sampling.py``
(commit 6b78e2d): the packed-table geometry, the grouped pack, the
streaming ring and the window forward with its order of operations. The
seeded head amplifies one-ulp input changes far past any tolerance, so the
reference keeps the port's order of floating-point operations where a
comparison is exact; nothing here launches a kernel.

Semantics: locations ``[Q, S, P, 3]`` with x, y in [0, 1] (pixel = loc *
(size - 1)) and the view normalized by 1 / (N - 1); scale weights
``[Q, S, P, L]``; output ``[Q, S, P, C]`` = sum_l w_l * bilinear(level l)
with zero padding per tap. A y-fold level's row ``y`` holds ``feat[y] ‖
feat[y+1]`` (one window read a point); a pair level's row holds ``feat[y]``
(two row reads a point). Group-split flags pick the pair levels'
accumulation order. An e4m3 level (a ``table_fp8`` ring) reads as bf16.

Training: :class:`_Sampling` pairs the window forward with the VJP of the
all-fp32 half-row primal (:func:`halfrow_plain`), taken by autograd.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .msmv_pack import pack_level, pack_level_pair

E4M3 = torch.float8_e4m3fn
E4M3_MAX = float(torch.finfo(E4M3).max)


def _per_level(spec, n):
    if isinstance(spec, (bool, int)):
        return (bool(spec),) * n
    spec = tuple(bool(v) for v in spec)
    if len(spec) != n:
        raise ValueError(f"{len(spec)} flags for {n} levels")
    return spec


def clamp_pixels(pix, size):
    """Pixels beyond [-2, size+1] have every tap masked; clamping keeps the
    integer conversion in range and changes no weight."""
    return pix.clamp(-2.0, float(size + 1))


def view_index(v, n):
    return torch.round(v * (n - 1)).clamp(0, n - 1).to(torch.int64)


class PackedFeatures:
    """Per-level row tables: y-fold ``[rows, W_l + 1, 2C]`` or pair
    ``[rows, W_l + 1, C]``, rows ordered (b, t, n, h, g); ``slice_map`` maps
    logical slices to physical ones (the ring's slots)."""

    def __init__(self, tables, batch: int, num_views: int, level_shapes,
                 channels: int, num_groups: int = 1,
                 slice_map: Optional[torch.Tensor] = None, yfold=True,
                 gsplit=False):
        self.tables = tuple(tables)
        self.batch = batch
        self.num_views = num_views
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        self.channels = channels
        self.num_groups = num_groups
        self.slice_map = slice_map
        n = len(self.level_shapes)
        self.yfold = _per_level(yfold, n)
        self.gsplit = _per_level(gsplit, n)

    def row_index(self, slice_idx, view, row_y, height):
        g = self.num_groups
        if g == 1:
            return (slice_idx * self.num_views + view) * height + row_y
        bt = slice_idx // g
        gi = slice_idx % g
        return ((bt * self.num_views + view) * height + row_y) * g + gi

    def row_width(self, level: int) -> int:
        return (2 if self.yfold[level] else 1) * self.channels

    def replace(self, **changes) -> "PackedFeatures":
        args = dict(tables=self.tables, batch=self.batch,
                    num_views=self.num_views, level_shapes=self.level_shapes,
                    channels=self.channels, num_groups=self.num_groups,
                    slice_map=self.slice_map, yfold=self.yfold,
                    gsplit=self.gsplit)
        args.update(changes)
        return PackedFeatures(**args)

    def meta(self, gsplit=None) -> "PackedFeatures":
        return PackedFeatures((None,) * len(self.tables), self.batch,
                              self.num_views, self.level_shapes,
                              self.channels, self.num_groups,
                              yfold=self.yfold,
                              gsplit=self.gsplit if gsplit is None else gsplit)


def pack_mlvl_feats_grouped(mlvl_feats: Sequence[torch.Tensor],
                            num_views: int, num_groups: int,
                            yfold=True, gsplit=False,
                            table_round=None) -> PackedFeatures:
    """Pack pyramids ``[B, T*N, H, W, C]`` into grouped tables. Differentiable
    (plain tensor ops). ``table_round``: a dtype the tables are rounded
    through in the forward (the lower-precision control; gradients pass
    straight through)."""
    n, g = num_views, num_groups
    b, tn = mlvl_feats[0].shape[0], mlvl_feats[0].shape[1]
    t = tn // n
    c = mlvl_feats[0].shape[-1]
    yfold = _per_level(yfold, len(mlvl_feats))
    tables, shapes = [], []
    for feat, yf in zip(mlvl_feats, yfold):
        h, w = feat.shape[2], feat.shape[3]
        pack = pack_level if yf else pack_level_pair
        t2 = pack(feat.reshape(b * t * n, h, w, c), g)
        t2 = t2.reshape(b * t * n * h * g, w + 1, t2.shape[-1])
        if table_round is not None:
            t2 = t2 + (t2.to(table_round).to(t2.dtype) - t2).detach()
        tables.append(t2)
        shapes.append((h, w))
    return PackedFeatures(tables, b * t * g, n, shapes, c // g, num_groups=g,
                          yfold=yfold, gsplit=gsplit)


def ring_init(frame_packed: PackedFeatures, num_slots: int, dtypes=None):
    """An all-zero ring of ``num_slots`` frame slots, one tensor a level."""
    t0 = frame_packed.tables[0]
    n = len(frame_packed.level_shapes)
    if dtypes is None or isinstance(dtypes, torch.dtype):
        dtypes = (dtypes or t0.dtype,) * n
    rows = frame_packed.num_views * frame_packed.num_groups
    return tuple(
        torch.zeros((num_slots * rows * h, w + 1, frame_packed.row_width(lvl)),
                    dtype=dt, device=t0.device)
        for lvl, ((h, w), dt) in enumerate(zip(frame_packed.level_shapes,
                                               dtypes)))


def ring_update(ring_tables, frame_packed: PackedFeatures, slot: int):
    """Write one frame's tables into ring slot ``slot`` in place; an e4m3
    level gets the values clipped to +-448 in fp32, then cast."""
    for ring, frame in zip(ring_tables, frame_packed.tables):
        rows = frame.shape[0]
        if ring.dtype == E4M3 and frame.dtype != E4M3:
            frame = frame.float().clamp_(-E4M3_MAX, E4M3_MAX)
        ring[slot * rows:(slot + 1) * rows].copy_(frame)
    return ring_tables


def ring_packed(ring_tables, slots_of_t: torch.Tensor, num_frames: int,
                meta: PackedFeatures) -> PackedFeatures:
    """The ring as PackedFeatures; ``slots_of_t [T]`` is each logical frame's
    slot (0 = newest)."""
    g = meta.num_groups
    slots_of_t = slots_of_t.to(torch.int64)
    groups = torch.arange(g, dtype=torch.int64, device=slots_of_t.device)
    slice_map = (slots_of_t[:, None] * g + groups[None]).reshape(
        num_frames * g)
    return PackedFeatures(ring_tables, num_frames * g, meta.num_views,
                          meta.level_shapes, meta.channels, num_groups=g,
                          slice_map=slice_map, yfold=meta.yfold,
                          gsplit=meta.gsplit)


def table_acc_dtype(packed: PackedFeatures) -> torch.dtype:
    dt = packed.tables[0].dtype
    return dt if dt in (torch.bfloat16, torch.float32) else torch.float32


def _separable_slot_weights(x_pix, y_pix, h, w):
    """Slot indices + separable weights of the y-fold window read, border
    masks folded in: ``(sx, ry, (wxa, wxb), (wya, wyb))``."""
    x_pix = clamp_pixels(x_pix, w)
    y_pix = clamp_pixels(y_pix, h)
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
    sx = ix0.clamp(0, w - 1)
    wxa = torch.where(sh_x, wx1, wx0)
    wxb = torch.where(sh_x, torch.zeros_like(wx1), wx1)

    sh_y = iy0 < 0
    ry = iy0.clamp(0, h - 1)
    wya = torch.where(sh_y, wy1, wy0)
    wyb = torch.where(sh_y, torch.zeros_like(wy1), wy1)
    return sx, ry, (wxa, wxb), (wya, wyb)


def _gather(flat, col):
    if flat.dtype == E4M3:
        return flat.view(torch.uint8)[col].view(E4M3)
    return flat[col]


def _fold_window_taps(g0, g1, fxa, fxb, fya, fyb, c):
    if g0.dtype == E4M3:
        g0, g1 = g0.to(torch.bfloat16), g1.to(torch.bfloat16)
    xa = fxa[:, None].to(g0.dtype).float()
    xb = fxb[:, None].to(g0.dtype).float()
    g0, g1 = g0.float(), g1.float()
    return ((g0[:, :c] * xa + g1[:, :c] * xb) * fya
            + (g0[:, c:] * xa + g1[:, c:] * xb) * fyb)


def _pair_level_taps(flat, col0, col1, wxa, wxb, wya, wyb, lw):
    wdt = torch.bfloat16 if flat.dtype == E4M3 else flat.dtype
    taps = []
    for col, wy in ((col0, wya), (col1, wyb)):
        wyl = wy * lw
        w0 = (wxa * wyl)[:, None].to(wdt).float()
        w1 = (wxb * wyl)[:, None].to(wdt).float()
        taps.append(_gather(flat, col).float() * w0
                    + _gather(flat, col + 1).float() * w1)
    return taps


def _point_rows(packed, loc):
    q, s, p, _ = loc.shape
    k = q * s * p
    dev = loc.device
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = view_index(loc[..., 2].reshape(k), packed.num_views)
    slices = (torch.arange(s, device=dev) if packed.slice_map is None
              else packed.slice_map.to(device=dev, dtype=torch.int64))
    batch_row = slices.repeat_interleave(p).repeat(q)          # (q, s, p)
    return k, x, y, view, batch_row


def sampling_plain(packed: PackedFeatures, loc: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """The window forward (query-major) in the port's order of operations."""
    q, s, p, _ = loc.shape
    c = packed.channels
    num_levels = len(packed.level_shapes)
    k, x, y, view, batch_row = _point_rows(packed, loc)
    lw_levels = sw.reshape(k, num_levels).t().float()
    acc_dtype = table_acc_dtype(packed)
    gmajor = any(packed.gsplit)
    out = torch.zeros((k, c), dtype=acc_dtype, device=loc.device)
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = _separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        lw = lw_levels[lvl]
        flat = packed.tables[lvl].reshape(-1, packed.row_width(lvl))
        if packed.yfold[lvl]:
            col = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
            lvl_out = _fold_window_taps(_gather(flat, col),
                                        _gather(flat, col + 1), wxa, wxb,
                                        (wya * lw)[:, None],
                                        (wyb * lw)[:, None], c)
            out = out + lvl_out.to(acc_dtype)
            continue
        col0 = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
        col1 = packed.row_index(batch_row, view,
                                torch.clamp(ry + 1, max=h - 1), h) \
            * (w + 1) + sx
        taps = _pair_level_taps(flat, col0, col1, wxa, wxb, wya, wyb, lw)
        if gmajor:
            out = out + (taps[0] + taps[1]).to(acc_dtype)
        else:
            for tap in taps:
                out = out + tap.to(acc_dtype)
    return out.reshape(q, s, p, c)


def halfrow_plain(packed: PackedFeatures, loc: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """The all-fp32 half-row primal whose VJP is the op's backward."""
    q, s, p, _ = loc.shape
    c = packed.channels
    num_levels = len(packed.level_shapes)
    k, x, y, view, batch_row = _point_rows(packed, loc)
    ct = torch.float32
    lw_levels = sw.reshape(k, num_levels).t().to(ct)
    out = torch.zeros((k, c), dtype=ct, device=loc.device)
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = _separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        lw = lw_levels[lvl]
        flat = packed.tables[lvl].reshape(-1, packed.row_width(lvl))
        if packed.yfold[lvl]:
            row = packed.row_index(batch_row, view, ry, h) * (w + 1)
            wy = torch.stack([wya, wyb], -1).to(ct)
            for slot, wx in ((0, wxa), (1, wxb)):
                g2 = flat[row + sx + slot].to(ct).reshape(k, 2, c)
                out = out + (g2 * wy[..., None]).sum(1) * (wx * lw)[:, None]
            continue
        for row_y, wy in ((ry, wya), (torch.clamp(ry + 1, max=h - 1), wyb)):
            row = packed.row_index(batch_row, view, row_y, h) * (w + 1)
            for slot, wx in ((0, wxa), (1, wxb)):
                g1 = flat[row + sx + slot].to(ct)
                out = out + g1 * (wx * wy * lw)[:, None]
    return out.reshape(q, s, p, c).to(table_acc_dtype(packed))


class _Sampling(torch.autograd.Function):
    """Forward: the window forward. Backward: autograd of the half-row
    primal over the tables in their own dtype."""

    @staticmethod
    def forward(ctx, packed, loc, sw, *tables):
        ctx.geometry = packed.replace(tables=(None,) * len(tables))
        ctx.save_for_backward(loc, sw, *tables)
        return sampling_plain(packed, loc, sw)

    @staticmethod
    def backward(ctx, grad_out):
        loc, sw, *tables = ctx.saved_tensors
        want = list(ctx.needs_input_grad[3:])
        leaves_t = [t.detach().requires_grad_(need)
                    for t, need in zip(tables, want)]
        loc_l = loc.detach().requires_grad_()
        sw_l = sw.detach().requires_grad_()
        with torch.enable_grad():
            out = halfrow_plain(ctx.geometry.replace(tables=leaves_t), loc_l,
                                sw_l)
            leaves = [loc_l, sw_l] + [t for t, need in zip(leaves_t, want)
                                      if need]
            grads = list(torch.autograd.grad(out, leaves,
                                             grad_out.to(out.dtype)))
        d_loc, d_sw = grads[0], grads[1]
        rest = iter(grads[2:])
        d_tables = [next(rest) if need else None for need in want]
        return (None, d_loc, d_sw, *d_tables)


def msmv_sampling(packed: PackedFeatures, loc: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """Query-major sampling ``[Q, S, P, 3]`` -> ``[Q, S, P, C]``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (loc, sw, *packed.tables)):
        return _Sampling.apply(packed, loc, sw, *packed.tables)
    return sampling_plain(packed, loc, sw)
